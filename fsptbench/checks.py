"""The numbers that decide `correct`: what the timed path produced against
the plain reference (fsptbench/reference), each held to a limit of the
cell's fsptbench/checks/<cell>.json.

Radiance (a progressive step's summed samples, (n, 3) per lane): a lane
mismatches where a channel differs by more than 1e-3 of the reference's
largest channel there plus 1e-4 of the reference's mean.  Paths that
rounding sends another way (a grazing hit, a lobe draw at its threshold,
a roulette draw at the cut) mismatch; the rest agree to a few parts in a
million.  An 8-bit frame: a channel mismatches where it differs by more
than 2 levels.
"""

from __future__ import annotations

import numpy as np

RTOL = 1e-3
ATOL_OF_MEAN = 1e-4
LEVELS = 2


def radiance_numbers(prog: np.ndarray, ref: np.ndarray) -> dict:
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    if prog.shape != ref.shape or not np.isfinite(prog).all():
        return {"mismatch_share": 1.0, "rel_l1": float("inf")}
    err = np.abs(prog - ref)
    tol = RTOL * np.abs(ref).max(axis=1) + ATOL_OF_MEAN * np.abs(ref).mean()
    return {"mismatch_share": float((err.max(axis=1) > tol).mean()),
            "rel_l1": float(err.sum() / max(np.abs(ref).sum(), 1e-30))}


def frame_numbers(prog: np.ndarray, ref: np.ndarray) -> dict:
    prog = np.asarray(prog, np.int64)
    ref = np.asarray(ref, np.int64)
    if prog.shape != ref.shape:
        return {"mismatch_share": 1.0, "rel_l1": float("inf")}
    err = np.abs(prog - ref)
    return {"mismatch_share": float((err > LEVELS).mean()),
            "rel_l1": float(err.sum() / max(ref.sum(), 1))}


def worst(readings: list) -> dict:
    """Each number's worst reading over the items compared."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit", "ok"}} for every limited number; a number
    without a reading fails."""
    out = {}
    for name, lim in limits["numbers"].items():
        v = numbers.get(name)
        ok = v is not None and np.isfinite(v) and v <= lim["limit"]
        out[name] = {"value": v, "limit": lim["limit"], "ok": bool(ok)}
    return out
