"""Replay a Tier-1 run's measured test seconds through pytest-xdist's
``--dist loadfile`` scheduler, to see what a change to the test files'
layout does to the run's wall time before spending a run on it.

xdist 3.8 queues the files by their number of tests, most first
(``--loadscope-reorder``, on by default; ties keep collection order), gives
each worker one file, and hands a worker the next file once it has at most
two tests left. The replay runs each worker's tests back to back at the
junit's seconds and reports when the last one ends (collection and start-up
are not counted: the junit's ``time`` is about 20 s above it).

    python -m tests.xdist_replay run.xml                  # the run as it was
    python -m tests.xdist_replay run.xml --split 2 --over 60   # every port file above 60 s in two
"""

from __future__ import annotations

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET
from typing import Dict, List


def load(path: str) -> "collections.OrderedDict[str, List[float]]":
    """{test file: [seconds of each test in the junit's order]}."""
    files: "collections.OrderedDict[str, List[float]]" = collections.OrderedDict()
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname").split(".")
        files.setdefault(f"{parts[0]}/{parts[1]}.py", []).append(float(case.get("time")))
    return files


def replay(files: Dict[str, List[float]], workers: int = 6) -> List[float]:
    """Each worker's end time, in seconds."""
    queue = collections.deque(sorted(sorted(files), key=lambda f: -len(files[f])))
    pending = [collections.deque() for _ in range(workers)]

    def assign(i: int) -> None:
        pending[i].extend(files[queue.popleft()])

    for i in range(workers):
        if queue:
            assign(i)
    for i in range(workers):
        if queue and len(pending[i]) <= 2:
            assign(i)
    ends, heap = [0.0] * workers, [(0.0, i) for i in range(workers)]
    while heap:
        t, i = heapq.heappop(heap)
        if not pending[i]:
            ends[i] = t
            continue
        t += pending[i].popleft()
        if queue and len(pending[i]) <= 2:
            assign(i)
        heapq.heappush(heap, (t, i))
    return ends


def split(files: Dict[str, List[float]], parts: int, over: float) -> Dict[str, List[float]]:
    """Every port file (``test_torch_*``) above ``over`` seconds cut into
    ``parts`` files of consecutive tests and about equal seconds."""
    out: Dict[str, List[float]] = {}
    for name, times in files.items():
        if "test_torch_" not in name or sum(times) <= over:
            out[name] = times
            continue
        total, acc, cuts = sum(times), 0.0, [0]
        for i, t in enumerate(times):
            acc += t
            if len(cuts) < parts and acc >= total * len(cuts) / parts:
                cuts.append(i + 1)
        cuts.append(len(times))
        for j in range(len(cuts) - 1):
            out[name[:-3] + (f"_part{j + 1}" if j else "") + ".py"] = times[cuts[j]:cuts[j + 1]]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("junit")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--split", type=int, default=1, help="cut each port file above --over seconds into this many")
    ap.add_argument("--over", type=float, default=60.0)
    args = ap.parse_args()
    files = load(args.junit)
    total = sum(map(sum, files.values()))
    ends = replay(split(files, args.split, args.over) if args.split > 1 else files, args.workers)
    print(f"test seconds {total:.1f}, even split {total / args.workers:.1f}, replayed wall {max(ends):.1f} "
          f"(workers end at {', '.join(f'{e:.0f}' for e in ends)})")


if __name__ == "__main__":
    main()
