"""The benchmark's frozen arithmetic: the card's published memory rate,
the least bytes a traversal of the cell's rays needs, and the statistics
the end-to-end and per-layer metrics take.  Kept with the benchmark so that a
change to the program cannot move it.
"""

from __future__ import annotations

import math
from typing import Sequence

# NVIDIA H100 SXM (80 GB HBM3) data sheet, dense, at its 700 W limit
H100_BYTES_PER_S = 3.35e12

# a ray read once (origin, direction, limit: 7 f32) and its hit written
# once (t, slot, u, v, visits: 5 words)
RAY_BYTES = 7 * 4
HIT_BYTES = 5 * 4


def traversal_bytes(rays: float, steps: int, table_bytes: int) -> float:
    """The least bytes the traversal of `rays` rays over `steps` steps
    moves: every ray read once and its hit written once, and the packed
    node and leaf tables read once a step.  No traversal kernel that reads
    its rays from memory and writes its hits there moves less."""
    return rays * (RAY_BYTES + HIT_BYTES) + steps * table_bytes


def roofline_pct(least_bytes: float, kernel_s: float):
    """The share of the card's memory roofline a kernel that took
    kernel_s seconds reached, in %; None where it never ran."""
    if kernel_s <= 0:
        return None
    return least_bytes / H100_BYTES_PER_S / kernel_s * 100.0


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile (q in (0, 100])."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def median(values: Sequence[float]) -> float:
    s = sorted(values)
    m = len(s) // 2
    return s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])


def idle_pct(busy_s: float, window_s: float):
    if window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / window_s)



def slice_idle_pct(run):
    """One minus the union of the device's kernel, memcpy and memset
    intervals over the traced slice's span, in %; None without a slice."""
    s = run.slice
    if s is None or not s.busy:
        return None
    return idle_pct(s.busy_s, s.window_s)
