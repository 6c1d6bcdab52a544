"""Fast binned-SAH BVH build for large scenes.

Preferred path: the native C++ builder (fspt_tpu/native/bvh_builder.cpp,
milliseconds at 100k triangles).  Fallback when no compiler is available: a
NumPy binned-SAH with the same split rule (seconds, still ~10x faster than
the full-sweep oracle in scene/bvh.py because each node touches its range a
constant number of times instead of 6 prefix sweeps).

Both produce the exact BVHArrays schema of scene/bvh.py (DFS preorder,
leaf_size-padded slots), so everything downstream — ops/packing.pack_bvh,
the Pallas kernel, the jnp reference traversal — is builder-agnostic.
Reference semantics being approximated: bvh.js:168-197 full-sweep SAH.
"""

from __future__ import annotations

import ctypes

import numpy as np

from fspt_tpu_torch.scene.bvh import BVHArrays

_BINS = 16


def build_bvh_fast(tri_min: np.ndarray, tri_max: np.ndarray,
                   leaf_size: int = 8) -> BVHArrays:
    """Binned-SAH build from per-triangle AABBs; native when possible."""
    from fspt_tpu_torch import native
    lib = native.load()
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    n = len(tri_min)
    if n == 0:
        raise ValueError("empty scene")
    if lib is None:
        return _build_numpy(tri_min, tri_max, leaf_size)

    max_nodes = 2 * n
    left = np.empty(max_nodes, np.int32)
    right = np.empty(max_nodes, np.int32)
    tri_offset = np.empty(max_nodes, np.int32)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    slot_tri = np.empty(max(n, leaf_size) * leaf_size, np.int64)
    counts = np.zeros(3, np.int64)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.fspt_build_bvh(
        p(tri_min, ctypes.c_float), p(tri_max, ctypes.c_float),
        ctypes.c_int64(n), ctypes.c_int32(leaf_size),
        p(left, ctypes.c_int32), p(right, ctypes.c_int32),
        p(tri_offset, ctypes.c_int32),
        p(node_min, ctypes.c_float), p(node_max, ctypes.c_float),
        p(slot_tri, ctypes.c_int64), p(counts, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"native BVH build failed (rc={rc})")
    m, s, depth = int(counts[0]), int(counts[1]), int(counts[2])
    return BVHArrays(
        left=left[:m].copy(), right=right[:m].copy(),
        tri_offset=tri_offset[:m].copy(),
        node_min=node_min[:m].copy(), node_max=node_max[:m].copy(),
        slot_tri=slot_tri[:s].copy(), depth=depth, leaf_size=leaf_size)


def _build_numpy(tri_min: np.ndarray, tri_max: np.ndarray,
                 leaf_size: int) -> BVHArrays:
    """NumPy binned SAH mirroring bvh_builder.cpp's split rule."""
    n = len(tri_min)
    cent = 0.5 * (tri_min + tri_max)

    lefts, rights, offs = [], [], []
    mins, maxs = [], []
    slot_tri = []
    max_depth = 0

    # (ids, depth, parent, side) with right pushed first => left-first DFS
    stack = [(np.arange(n), 0, -1, 0)]
    while stack:
        ids, depth, parent, side = stack.pop()
        node_id = len(lefts)
        if parent >= 0:
            (lefts if side == 0 else rights)[parent] = node_id
        max_depth = max(max_depth, depth)
        count = len(ids)
        bmin = tri_min[ids].min(axis=0)
        bmax = tri_max[ids].max(axis=0)
        mins.append(bmin)
        maxs.append(bmax)

        if count <= leaf_size:
            lefts.append(0)
            rights.append(0)
            offs.append(len(slot_tri))
            slot_tri.extend(int(t) for t in ids)
            slot_tri.extend([-1] * (leaf_size - count))
            continue

        c = cent[ids]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        extent = cmax - cmin
        best = (np.inf, -1, -1)     # cost, axis, bin
        for axis in range(3):
            if extent[axis] <= 0:
                continue
            b = np.clip((c[:, axis] - cmin[axis]) * (_BINS / extent[axis]),
                        0, _BINS - 1).astype(np.int32)
            # per-bin AABB + count via minimum/maximum.at
            bin_min = np.full((_BINS, 3), np.inf)
            bin_max = np.full((_BINS, 3), -np.inf)
            np.minimum.at(bin_min, b, tri_min[ids])
            np.maximum.at(bin_max, b, tri_max[ids])
            bin_n = np.bincount(b, minlength=_BINS)

            def half_area(lo, hi):
                d = np.maximum(hi - lo, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            pref_a = half_area(np.minimum.accumulate(bin_min, 0),
                               np.maximum.accumulate(bin_max, 0))
            suff_a = half_area(np.minimum.accumulate(bin_min[::-1], 0),
                               np.maximum.accumulate(bin_max[::-1], 0))[::-1]
            nl = np.cumsum(bin_n)
            nr = count - nl
            with np.errstate(invalid="ignore"):
                cost = pref_a[:-1] * nl[:-1] + suff_a[1:] * nr[:-1]
            cost = np.where((nl[:-1] == 0) | (nr[:-1] == 0), np.inf, cost)
            j = int(np.argmin(cost))
            if cost[j] < best[0]:
                best = (float(cost[j]), axis, j)

        if best[1] < 0:
            mid = count // 2
            left_ids, right_ids = ids[:mid], ids[mid:]
        else:
            axis, jbin = best[1], best[2]
            b = np.clip((c[:, axis] - cmin[axis]) * (_BINS / extent[axis]),
                        0, _BINS - 1).astype(np.int32)
            mask = b <= jbin
            left_ids, right_ids = ids[mask], ids[~mask]
            if len(left_ids) == 0 or len(right_ids) == 0:
                mid = count // 2
                left_ids, right_ids = ids[:mid], ids[mid:]

        lefts.append(-1)
        rights.append(-1)
        offs.append(-1)
        stack.append((right_ids, depth + 1, node_id, 1))
        stack.append((left_ids, depth + 1, node_id, 0))

    return BVHArrays(
        left=np.asarray(lefts, np.int32), right=np.asarray(rights, np.int32),
        tri_offset=np.asarray(offs, np.int32),
        node_min=np.asarray(mins, np.float32),
        node_max=np.asarray(maxs, np.float32),
        slot_tri=np.asarray(slot_tri, np.int64),
        depth=max_depth, leaf_size=leaf_size)
