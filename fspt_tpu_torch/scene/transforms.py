"""Vectorized host-side 3-vector transforms (NumPy).

Replaces the reference's scalar Vec3 helpers (reference vector.js:1-119) with
array ops over (N, 3) vertex batches.  Note: the reference's `Vec3.sqrt` has a
copy-paste bug (uses v[1] twice, vector.js:32) — deliberately not reproduced.
"""

from __future__ import annotations

import numpy as np


def normalize(v: np.ndarray, axis: int = -1, eps: float = 0.0) -> np.ndarray:
    n = np.linalg.norm(v, axis=axis, keepdims=True)
    if eps:
        n = np.maximum(n, eps)
    return v / n


def rotate_arbitrary(verts: np.ndarray, axis, angle: float) -> np.ndarray:
    """Rodrigues rotation of (N, 3) points about `axis` by `angle` radians
    (reference vector.js:90-102 builds the same 3x3)."""
    verts = np.asarray(verts, dtype=np.float64)
    u = normalize(np.asarray(axis, dtype=np.float64))
    c, s = np.cos(angle), np.sin(angle)
    x, y, z = u
    m = np.array([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
    ])
    return verts @ m.T


def apply_prop_transforms(verts: np.ndarray, rotations, scale, translate,
                          world_transforms=None, rotation_only: bool = False):
    """Apply per-prop model transforms (rotate -> scale -> translate) then the
    scene-level worldTransforms list (reference obj_loader.js:24-38).

    `rotations` is a list of {"axis": [x,y,z], "angle": a} dicts.
    With rotation_only=True only rotations are applied (used for normals,
    reference obj_loader.js:25,146-148).
    """
    out = np.asarray(verts, dtype=np.float64)
    for r in rotations or []:
        out = rotate_arbitrary(out, r["axis"], r["angle"])
    if not rotation_only:
        out = out * float(scale) + np.asarray(translate, dtype=np.float64)
    for t in world_transforms or []:
        if t.get("rotate"):
            for r in t["rotate"]:
                out = rotate_arbitrary(out, r["axis"], r["angle"])
        elif t.get("translate") is not None and not rotation_only:
            out = out + np.asarray(t["translate"], dtype=np.float64)
    return out
