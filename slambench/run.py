"""The benchmark of mageslam_tpu_torch on one NVIDIA H100.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints progress on standard error and, as the
last line of standard output, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), `device`, with --trace 1 `breakdown`, and last `check`, the
numbers compared with the plain reference beside their limits, which also
end standard error. Exits non-zero, printing no result, where torch sees no
card or fewer than the cell asks for, and where the process has loaded JAX
or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# any library build cache at a fixed path inside the checkout (the port's own
# kernels build into mageslam_tpu_torch/_build/); few threads
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".slambench_cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".slambench_cache", "torch_extensions")
os.environ["OMP_NUM_THREADS"] = "2"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "mageslam_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from slambench import harness

    bench = harness.benchmark()
    cell = harness.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slambench: {args.workload} needs {cell['chips']} CUDA device(s), torch sees {n}",
              file=sys.stderr)
        return 3
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                           T_START)
    bad = forbidden_modules()
    if bad:
        print(f"slambench: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    print(f"slambench: {json.dumps(out['extra'])}", file=sys.stderr)
    for name, c in out["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**out["result"], "check": out["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
