"""The program's own phase spans in a traced slice.

The program marks its phases with `record_function("fspt.<phase>")`
(fspt.step, fspt.shade, fspt.traverse, ...), on the profiler's clock.
Profiling.Summary keeps every host event on the benchmark span's thread
(`Summary.host`, (name, start s, end s)); the spans are those whose name
starts with PREFIX.  A span's self time is its duration minus the union of
the intervals of the PREFIX spans nested directly in it.  Only the name
prefix ties this file to the program: it imports none of it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from fsptbench.profiling import union

PREFIX = "fspt."

Span = Tuple[str, float, float]


def spans(summary) -> List[Span]:
    """The program's spans of the slice, by start (an enclosing span before
    the spans it holds)."""
    return sorted((e for e in summary.host if e[0].startswith(PREFIX)),
                  key=lambda e: (e[1], -e[2]))


def self_times(found: List[Span]) -> List[float]:
    """Each span's self time (seconds), in the order of `found` (as spans()
    gives them)."""
    # spans of one thread nest: a span that starts inside another ends in
    # it too, so its end is clipped to the enclosing one's (the trace's
    # rounding may put it a few ns past)
    children: List[List[Tuple[float, float]]] = [[] for _ in found]
    stack: List[int] = []
    for i, (_, a, b) in enumerate(found):
        while stack and not found[stack[-1]][1] <= a < found[stack[-1]][2]:
            stack.pop()
        if stack:
            children[stack[-1]].append((a, min(b, found[stack[-1]][2])))
        stack.append(i)
    return [(b - a) - sum(y - x for x, y in union(kids))
            for (_, a, b), kids in zip(found, children)]


def total_s(summary, name: str, own: bool = True) -> Optional[float]:
    """The summed self time (own) or whole duration of the spans named
    `name` in the slice, in seconds; None where it holds none."""
    found = spans(summary)
    times = self_times(found) if own else [b - a for _, a, b in found]
    hits = [t for (n, _, _), t in zip(found, times) if n == name]
    return sum(hits) if hits else None


def ms_per(run, name: str, unit: str, own: bool = True) -> Optional[float]:
    """total_s of `name` in the run's traced slice, in ms over the slice's
    `unit` (a key of run.slice_work: "samples", "steps"); None without a
    slice, a unit or such a span."""
    if run.slice is None or not run.slice_work.get(unit):
        return None
    t = total_s(run.slice, name, own)
    return None if t is None else t * 1e3 / run.slice_work[unit]
