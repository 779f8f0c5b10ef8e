"""Replays a pytest-xdist `--dist loadfile` run from its junit XML: which
worker ran which file, when each worker went idle, and which files form the
run's tail.

xdist's loadfile scheduler (3.x) takes the files in collection order,
reorders them by test count (most tests first, ties in collection order),
gives each worker one file, then hands the next file to a worker each time
one of its tests ends with two or fewer of its tests still pending. A file
with few long tests therefore comes last and can queue behind another
worker's unfinished file. This tool replays that rule on the per-test times
of a junit file, with the collection order of the tree it runs in, and
prints the replayed wall, each worker's files, and the same replay with the
test times scattered (a lognormal factor per test), since the order in which
tests end decides where the last files land.

    python tools/tier1_schedule.py run.xml [-n 6] [--noise 0.15 --trials 400]
        [--without PREFIX]   # drop files whose name starts with PREFIX

The collection order comes from `pytest --collect-only -q` over tests/ (the
suite's conftest reorders some files first). Set-up outside tests
(starting the workers, collecting) is not in the junit times.
"""

from __future__ import annotations

import argparse
import collections
import heapq
import os
import random
import statistics
import subprocess
import sys
import xml.etree.ElementTree as ET

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def junit_times(path: str) -> dict[str, list[float]]:
    """{file stem: [test seconds, in report order]} from a junit XML."""
    files: dict[str, list[float]] = collections.OrderedDict()
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname").split(".")
        stem = parts[1] if parts[0] == "tests" else parts[0]
        files.setdefault(stem, []).append(float(case.get("time")))
    return files


def collection_order() -> list[str]:
    """File stems in the order pytest collects tests/ here."""
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "--collect-only", "-q", "-m", "not slow",
         "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}).stdout
    order: list[str] = []
    for line in out.splitlines():
        if "::" in line:
            stem = os.path.basename(line.split("::")[0])[:-3]
            if stem not in order:
                order.append(stem)
    return order


def replay(files: dict, order: list[str], workers: int, scatter=None):
    """(wall, [(end, [files]) per worker]) of the loadfile rule."""
    queue = collections.deque(sorted([f for f in order if f in files],
                                     key=lambda f: -len(files[f])))
    pending = [collections.deque() for _ in range(workers)]
    owned: list[list[str]] = [[] for _ in range(workers)]

    def give(w: int) -> None:
        name = queue.popleft()
        owned[w].append(name)
        pending[w].extend(t * (scatter() if scatter else 1.0) for t in files[name])

    for w in range(min(workers, len(queue))):
        give(w)
    for w in range(workers):
        if queue and len(pending[w]) <= 2:
            give(w)
    events = [(pending[w][0], w) for w in range(workers) if pending[w]]
    heapq.heapify(events)
    ends = [0.0] * workers
    while events:
        now, w = heapq.heappop(events)
        pending[w].popleft()
        if queue and len(pending[w]) <= 2:
            give(w)
        if pending[w]:
            heapq.heappush(events, (now + pending[w][0], w))
        else:
            ends[w] = now
    return max(ends), list(zip(ends, owned))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("junit")
    ap.add_argument("-n", type=int, default=6, help="xdist workers")
    ap.add_argument("--noise", type=float, default=0.15, help="sigma of the log scatter")
    ap.add_argument("--trials", type=int, default=400)
    ap.add_argument("--without", default=None, help="drop files with this name prefix")
    args = ap.parse_args()

    files = junit_times(args.junit)
    if args.without:
        files = {k: v for k, v in files.items() if not k.startswith(args.without)}
    order = collection_order()
    order += [f for f in files if f not in order]
    total = sum(map(sum, files.values()))
    wall, workers = replay(files, order, args.n)
    print(f"{len(files)} files, {sum(map(len, files.values()))} tests, {total:.1f} s in all "
          f"({total / args.n:.1f} s a worker if perfectly spread)")
    print(f"replayed wall {wall:.1f} s (junit times as recorded)")
    for end, names in sorted(workers, reverse=True):
        tail = ", ".join(f"{n} ({sum(files[n]):.0f} s)" for n in names[-3:])
        print(f"  worker ends {end:7.1f} s after {len(names)} files; last: {tail}")
    rng = random.Random(0)
    walls = sorted(replay(files, order, args.n, lambda: rng.lognormvariate(0, args.noise))[0]
                   for _ in range(args.trials))
    print(f"scattered x{args.trials} (sigma {args.noise}): mean {statistics.mean(walls):.1f}, "
          f"median {walls[len(walls) // 2]:.1f}, p90 {walls[int(0.9 * len(walls))]:.1f} s")


if __name__ == "__main__":
    main()
