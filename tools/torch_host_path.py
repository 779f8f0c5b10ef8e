"""Where the host time of one `hamming_matrix` call goes, on one GPU.

    python tools/torch_host_path.py [--n 1024] [--m 512] [--calls 5000]

Times on the host clock, in microseconds a call (best of 5 runs of
`--calls` calls each), every piece of the wrapper's launch path
(mageslam_tpu_torch/ops/hamming.py) alone, in the form the wrapper had
before and in the form it has now:
  - the checks: two `_check` calls, or one tuple comparison;
  - the launch device's check: `torch.cuda.current_device()`, or
    `torch._C._cuda_getDevice()`;
  - the stream: `torch.cuda.current_stream(device).cuda_stream`, or
    `torch._C._cuda_getCurrentRawStream(index)`;
  - the output: `torch.empty`, or `new_empty` of the first operand;
  - the ctypes call that launches the kernel;
then the whole of both forms and `torch._int_mm` of the ±1 bits, each on the
host clock and with CUDA events (ms a call, back to back). Prints one JSON
object. Requires a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, __file__.rsplit("/tools/", 1)[0])

from mageslam_tpu_torch.ops import _build, hamming  # noqa: E402


def host_us(fn, calls: int, runs: int = 5) -> float:
    """Best of `runs` of the mean host time of `calls` calls, in us."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return best


def event_ms(fn, calls: int) -> float:
    for _ in range(100):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--calls", type=int, default=5000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_host_path: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    rng = np.random.RandomState(0)
    a, b = (torch.from_numpy(rng.randint(0, 2**32, (r, 8), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(device)
            for r in (args.n, args.m))
    n, m = args.n, args.m
    lib = _build.library()
    out = torch.empty((n, m), dtype=torch.int32, device=device)
    spec = (torch.int32, torch.int32, (8,), (8,), True, True, device)

    def two_checks():
        hamming._check(a, "desc_a", device)
        hamming._check(b, "desc_b", device)

    def tuple_check():
        return (a.dtype, b.dtype, a.shape[1:], b.shape[1:], a.is_contiguous(),
                b.is_contiguous(), b.device) != spec

    def launch():
        return lib.mageslam_hamming_matrix(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, m,
                                           torch._C._cuda_getCurrentRawStream(0))

    def before():
        """The wrapper's launch path as it was (PR 1)."""
        if a.device.type == "cpu" and b.device.type == "cpu":
            return None
        dev = a.device
        hamming._check(a, "desc_a", dev)
        hamming._check(b, "desc_b", dev)
        if dev.index != torch.cuda.current_device() or (n + 31) // 32 > 65535:
            raise ValueError
        o = torch.empty((n, m), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if lib.mageslam_hamming_matrix(a.data_ptr(), b.data_ptr(), o.data_ptr(), n, m,
                                       stream) != 0:
            raise RuntimeError
        return o

    a_pm, b_pm_t = hamming.pm_bits(a), hamming.pm_bits(b).t()
    pieces = {
        "two _check calls": two_checks,
        "one tuple comparison": tuple_check,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.cuda.current_stream(device).cuda_stream":
            lambda: torch.cuda.current_stream(device).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(0)": lambda: torch._C._cuda_getCurrentRawStream(0),
        "torch.empty((n, m), int32)": lambda: torch.empty((n, m), dtype=torch.int32,
                                                          device=device),
        "a.new_empty((n, m))": lambda: a.new_empty((n, m)),
        "torch._C._cuda_getDevice()": torch._C._cuda_getDevice,
        "ctypes launch (raw stream)": launch,
    }
    whole = {
        "wrapper before": before,
        "wrapper now": lambda: hamming.hamming_matrix(a, b),
        "torch._int_mm": lambda: torch._int_mm(a_pm, b_pm_t),
    }
    if not torch.equal(before(), hamming.hamming_matrix(a, b)):
        raise AssertionError("the two wrapper forms disagree")
    saved = hamming.LAUNCHES
    result = {"card": card, "shape": [n, m], "calls": args.calls,
              "host_us": {k: host_us(f, args.calls) for k, f in {**pieces, **whole}.items()}}
    # back to back, in turns: before, now, now, before (ms a call, CUDA events)
    order = ("wrapper before", "wrapper now", "torch._int_mm", "torch._int_mm",
             "wrapper now", "wrapper before")
    ms: dict[str, list[float]] = {}
    for k in order:
        ms.setdefault(k, []).append(event_ms(whole[k], args.calls))
    result["event_ms"] = ms
    hamming.LAUNCHES = saved            # measurement launches are not a path's
    for k, v in result["host_us"].items():
        print(f"[host] {k}: {v:.3f} us a call", flush=True)
    for k, v in ms.items():
        print(f"[events] {k}: " + " / ".join(f"{x:.5f}" for x in v) + " ms a call", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
