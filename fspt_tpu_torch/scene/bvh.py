"""Binary SAH BVH builder (host side, NumPy).

Semantics-parity with reference bvh.js:5-198:
  * triangle centroids pre-sorted once per axis (bvh.js:13-16,78-90)
  * each node evaluates a full-sweep SAH over all 3 axes using prefix/suffix
    AABB surface-area sweeps; cost = 1 + (saF/saP)*(i+1) + (saB/saP)*(n-1-i)
    (bvh.js:168-197); first-best wins on ties (strict <), axes in order x,y,z
  * sorted-order-preserving partition (bvh.js:52-76)
  * leaf when count <= leaf_size (default 4, reference main.js:45)
  * DFS-preorder serialization: node = [left, right, tri_offset | min | max]
    (reference main.js:360-392); leaf triangles are re-ordered contiguously.

TPU-specific departure: every leaf's triangle run is padded to exactly
`leaf_size` slots with degenerate (never-hit) triangles so the device-side
leaf test is a fixed-size vector op with no per-leaf count gather.  The
unpadded JS layout (processLeaf always reads LEAF_SIZE tris, overrunning into
the next leaf, reference tracer.fs:355-364) is not reproduced.

This full-sweep builder is the semantics oracle; large scenes use the fast
binned-SAH builder in scene/fastbvh.py (NumPy vectorized, with an optional
C++ core) which produces the same array schema.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class BVHArrays:
    """Flattened BVH in DFS preorder."""

    left: np.ndarray        # (M,) int32 — child node index or 0 for leaves
    right: np.ndarray       # (M,) int32
    tri_offset: np.ndarray  # (M,) int32 — padded-slot offset, -1 for internal
    node_min: np.ndarray    # (M, 3) float32
    node_max: np.ndarray    # (M, 3) float32
    # per padded slot, index into the original triangle array, -1 = padding
    slot_tri: np.ndarray    # (S,) int64
    depth: int
    leaf_size: int

    @property
    def num_nodes(self) -> int:
        return len(self.left)


def _surface_area_sweep(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    """Prefix surface areas of growing AABB unions over (n, 3) min/max."""
    cmin = np.minimum.accumulate(bmin, axis=0)
    cmax = np.maximum.accumulate(bmax, axis=0)
    d = cmax - cmin
    return 2.0 * (d[:, 0] * d[:, 1] + d[:, 0] * d[:, 2] + d[:, 1] * d[:, 2])


def build_bvh(tri_min: np.ndarray, tri_max: np.ndarray,
              leaf_size: int = 4) -> BVHArrays:
    """Build from per-triangle AABBs (N, 3) min / (N, 3) max."""
    n = len(tri_min)
    if n == 0:
        raise ValueError("empty scene")
    tri_min = np.asarray(tri_min, dtype=np.float64)
    tri_max = np.asarray(tri_max, dtype=np.float64)
    centroids = 0.5 * (tri_min + tri_max)

    # one stable sort per axis (bvh.js:13-16)
    order = [np.argsort(centroids[:, ax], kind="stable") for ax in range(3)]

    lefts: List[int] = []
    rights: List[int] = []
    tri_offsets: List[int] = []
    mins: List[np.ndarray] = []
    maxs: List[np.ndarray] = []
    slot_tri: List[int] = []
    max_depth = 0

    # DFS preorder with an explicit stack; each item carries the three sorted
    # index arrays, its depth, and the parent field to patch afterwards.
    # patch slot: (node_index, "left"/"right") — we process left child first.
    stack: List = [(order, 0, None, None)]
    while stack:
        idx3, depth, parent, side = stack.pop()
        node_id = len(lefts)
        if parent is not None:
            if side == 0:
                lefts[parent] = node_id
            else:
                rights[parent] = node_id
        max_depth = max(max_depth, depth)

        ids = idx3[0]
        count = len(ids)
        bmin = tri_min[ids].min(axis=0)
        bmax = tri_max[ids].max(axis=0)
        mins.append(bmin)
        maxs.append(bmax)

        if count <= leaf_size:
            lefts.append(0)
            rights.append(0)
            tri_offsets.append(len(slot_tri))
            slot_tri.extend(int(t) for t in ids)
            slot_tri.extend([-1] * (leaf_size - count))
            continue

        # full-sweep SAH over the 3 axes (bvh.js:168-197)
        parent_sa = _node_surface_area(bmin, bmax)
        best_cost = np.inf
        best_axis = 0
        best_split = 1
        for axis in range(3):
            a_ids = idx3[axis]
            sa_front = _surface_area_sweep(tri_min[a_ids], tri_max[a_ids])
            sa_back = _surface_area_sweep(tri_min[a_ids[::-1]],
                                          tri_max[a_ids[::-1]])
            i = np.arange(count)
            cost = (1.0 + (sa_front / parent_sa) * (i + 1)
                    + (sa_back[::-1] / parent_sa) * (count - 1 - i))
            j = int(np.argmin(cost))  # first minimum, matching strict <
            if cost[j] < best_cost:
                best_cost = cost[j]
                best_axis = axis
                best_split = j + 1

        # order-preserving partition (bvh.js:52-76)
        split_ids = idx3[best_axis]
        left_set = np.zeros(n, dtype=bool)
        left_set[split_ids[:best_split]] = True
        left3: List[Optional[np.ndarray]] = [None, None, None]
        right3: List[Optional[np.ndarray]] = [None, None, None]
        left3[best_axis] = split_ids[:best_split]
        right3[best_axis] = split_ids[best_split:]
        for axis in range(3):
            if axis == best_axis:
                continue
            mask = left_set[idx3[axis]]
            left3[axis] = idx3[axis][mask]
            right3[axis] = idx3[axis][~mask]

        lefts.append(-1)   # patched by children
        rights.append(-1)
        tri_offsets.append(-1)
        # push right first so left is processed first (DFS preorder)
        stack.append((right3, depth + 1, node_id, 1))
        stack.append((left3, depth + 1, node_id, 0))

    return BVHArrays(
        left=np.asarray(lefts, dtype=np.int32),
        right=np.asarray(rights, dtype=np.int32),
        tri_offset=np.asarray(tri_offsets, dtype=np.int32),
        node_min=np.asarray(mins, dtype=np.float32),
        node_max=np.asarray(maxs, dtype=np.float32),
        slot_tri=np.asarray(slot_tri, dtype=np.int64),
        depth=max_depth,
        leaf_size=leaf_size,
    )


def _node_surface_area(bmin: np.ndarray, bmax: np.ndarray) -> float:
    d = bmax - bmin
    return float(2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2]))


def triangle_aabbs(verts: np.ndarray):
    """(T, 3, 3) verts -> ((T, 3) min, (T, 3) max)."""
    return verts.min(axis=1), verts.max(axis=1)
