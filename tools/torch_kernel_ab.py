"""Time two checkouts' local_best and state_digest kernels in turns, on one GPU.

    python tools/torch_kernel_ab.py A_DIR B_DIR [--launches 1000] [--out FILE]

A_DIR and B_DIR each hold a checkout of this repo, for example the parent
commit unpacked by `git archive` into a git-ignored directory, and `.`.
Four processes run one after another, A, B, B, A; each imports the
`mageslam_tpu_torch` of its own checkout (building that checkout's kernels
there), makes the same inputs from a seed and times both wrappers at
chip_smoke.py's shapes: µs a launch from CUDA events around the replay of
one CUDA graph of --launches back-to-back calls, the median of 5 replays (as
chip_smoke.py's `graph_us`). Each process also hashes its outputs, and the
two checkouts must agree on every shape (exit 1 where they do not). Prints
the card's name and power limit and one JSON object, also written to --out.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

LOCAL_BEST_ROWS = (32, 1024, 2048, 4096, 8192)   # chip_smoke.py: the floor and P / d
TARGETS = 512
DIGEST_BANKS = ((1, 0), (2048, 48), (8192, 256), (65536, 256))
GATES = (12.0, 45)


def graph_us(fn, launches: int, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) * 1e3 / launches)
    return statistics.median(times)


def worker(checkout: str, launches: int) -> dict:
    """One turn: this checkout's wrappers at every shape (µs a launch and a
    hash of the outputs)."""
    sys.path.insert(0, os.path.abspath(checkout))
    import numpy as np
    import torch

    from mageslam_tpu_torch.ops import digest, local_best

    if not local_best.__file__.startswith(os.path.abspath(checkout)):
        raise RuntimeError(f"imported {local_best.__file__}, not {checkout}'s package")
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(13)
    q = rng.randint(0, 2**32, (max(LOCAL_BEST_ROWS), 8), dtype=np.uint64).astype(np.uint32)
    q_xy = rng.uniform(0, 300, (len(q), 2)).astype(np.float32)
    # each target a noisy copy of one of the first 1,024 rows, near its position
    src = rng.randint(0, 1024, TARGETS)
    flips = (rng.rand(TARGETS, 8, 32) < 0.08).astype(np.uint32) << np.arange(32, dtype=np.uint32)
    t = q[src] ^ np.bitwise_or.reduce(flips, axis=2)
    t_xy = q_xy[src] + rng.uniform(-8, 8, (TARGETS, 2)).astype(np.float32)
    q_all = [torch.from_numpy(q.view(np.int32)).to(dev), torch.from_numpy(q_xy).to(dev),
             torch.from_numpy(rng.rand(len(q)) > 0.1).to(dev)]
    targets = [torch.from_numpy(t.view(np.int32)).to(dev), torch.from_numpy(t_xy).to(dev),
               torch.ones(TARGETS, dtype=torch.bool, device=dev)]
    out = {"checkout": checkout, "us": {}, "hash": {}}
    for p in LOCAL_BEST_ROWS:
        args = [a[:p] for a in q_all] + targets
        got = torch.stack(local_best.local_best(*args, *GATES)).cpu().numpy()
        out["hash"][f"local_best {p}x{TARGETS}"] = hashlib.sha256(got.tobytes()).hexdigest()
        out["us"][f"local_best {p}x{TARGETS}"] = graph_us(
            lambda: local_best.local_best(*args, *GATES), launches)
    for P, K in DIGEST_BANKS:
        args = [torch.from_numpy(rng.randn(P, 3).astype(np.float32)).to(dev),
                torch.from_numpy(rng.randn(K, 3).astype(np.float32)).to(dev),
                torch.from_numpy(rng.rand(P) < 0.7).to(dev),
                torch.from_numpy(rng.rand(K) < 0.7).to(dev),
                torch.tensor([3], dtype=torch.int32, device=dev)]
        out["hash"][f"state_digest {P}x{K}"] = str(float(digest.state_digest(*args)[0]))
        out["us"][f"state_digest {P}x{K}"] = graph_us(lambda: digest.state_digest(*args),
                                                     launches)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--launches", type=int, default=1000)
    ap.add_argument("--out")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.launches)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    turns = []
    for checkout in (args.a, args.b, args.b, args.a):
        root = os.path.abspath(checkout)
        run = subprocess.run([sys.executable, os.path.abspath(__file__), args.a, args.b,
                              "--launches", str(args.launches), "--worker", root],
                             capture_output=True, text=True, cwd=root)
        if run.returncode != 0:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        turns.append(json.loads(run.stdout.strip().splitlines()[-1]))
        for shape, us in turns[-1]["us"].items():
            print(f"[{len(turns)}: {checkout}] {shape}: {us:.3f} us a launch", flush=True)
    differ = sorted(k for k in turns[0]["hash"] if turns[0]["hash"][k] != turns[1]["hash"][k])
    result = {"card": card, "launches": args.launches, "order": [t["checkout"] for t in turns],
              "us": {k: [t["us"][k] for t in turns] for k in turns[0]["us"]},
              "outputs_differ": differ}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
