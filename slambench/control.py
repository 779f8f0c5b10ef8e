"""The control of `correct`, on the card: runs of one cell over several seeds,
each printing the compared numbers of the program and of the control (the
reference computed in TF32, put in the program's place on the same captured
calls) beside the limits, and `match_mismatch.planted`, the program's
matcher answers with one answer a call altered. The benchmark's own runs do
not run it.

    python3 slambench/control.py --workload <cell> --seeds 1,2,3 --seconds 10

One process a seed (each pays its set-up); one JSON line a seed, then a
summary: the largest program reading and the least control reading of each
number.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def one(workload: str, seed: int, seconds: float) -> dict:
    from slambench import harness

    out = harness.run_cell(harness.benchmark(), workload, seed, seconds, False, T_START,
                           control=True)
    return {"seed": seed, "correct": out["result"]["correct"],
            "program": {k: v["value"] for k, v in out["check"].items()},
            "control": out["control"], "extra": out["extra"]}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.one:
        print(json.dumps(one(a.workload, int(a.seeds), a.seconds)), flush=True)
        return 0
    rows = []
    for seed in a.seeds.split(","):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--workload", a.workload,
                            "--seeds", seed, "--seconds", str(a.seconds), "--one"],
                           capture_output=True, text=True, cwd=ROOT)
        if r.returncode:
            print(f"seed {seed}: rc {r.returncode}\n{r.stderr[-2000:]}", file=sys.stderr)
            continue
        rows.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    names = sorted({k for r in rows for k in list(r["program"]) + list(r["control"])})
    summary = {n: {"program_max": max((r["program"][n] for r in rows
                                       if r["program"].get(n) is not None), default=None),
                   "control_min": min((r["control"][n] for r in rows
                                       if r["control"].get(n) is not None), default=None)}
               for n in names}
    print(json.dumps({"workload": a.workload, "seeds": len(rows), "summary": summary}))
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main())
