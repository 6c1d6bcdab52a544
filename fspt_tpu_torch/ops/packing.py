"""Pack the host-built BVH into the lane-dense VMEM tables the Pallas
packet-traversal kernel (ops/traverse.py) consumes.

The binary SAH tree (scene/bvh.py, semantics of reference bvh.js) is
collapsed into a **wide BVH** (8- or 16-ary) at pack time: a traversal
visit then tests all child AABBs in one VPU pass instead of two, which
cuts visited-node count for the same vector cost per test and shrinks
the shared packet stack.  Wide children are ordered along the parent's
principal axis so the kernel can push near-to-far with one scalar sign
check (no per-visit sorting).

Width choice: the per-visit cost of the walk kernel (ops/traverse3.py) is
dominated by the SERIAL dynamic row fetch, not the vector tests, so wider
nodes are nearly free pruning — 16-wide packs 16 children into the SAME
one-row fetch (113 of 128 lanes used vs 57 for 8-wide), drops a tree
level, and measured ~35%% fewer walk-visits on the bunny bench.  8-wide
remains for the v1 packet kernel (ops/traverse.py), which extracts node
fields to scalars and would pay 2x for 16.

Layout (width w = 8 or 16; lane offsets scale with w):

* ``nodes``: (W, 128) float32 — ONE wide node per row:
      lanes [0*w:1*w]  child min.x (children 0..w-1)
      lanes [1*w:2*w]  child min.y      [2*w:3*w] child min.z
      lanes [3*w:4*w]  child max.x      [4*w:5*w] child max.y
      lanes [5*w:6*w]  child max.z
      lanes [6*w:7*w]  child links      [7*w] sort axis (0/1/2)
  Links are exact small floats: ``link >= 0`` is a wide-node ordinal,
  ``link < 0`` is ``-(leaf_ordinal + 1)``.  Empty child slots carry link
  ``EMPTY_LINK`` (-1e9) which the kernel masks out of the descent vote —
  the slab test alone cannot reject them, because with per-axis min/max
  reordering an "inverted" box behaves like one spanning [-BIG, +BIG].
* ``leaves``: (L, 128) float32 — one leaf per row, ``leaf_size`` triangles
  at lanes 9*k .. 9*k+9 as [v0, e1, e2].  Padding slots are all-zero
  (degenerate => det == 0 => never hit, same convention as SceneArrays).
  A leaf's global slot base is ``leaf_ordinal * leaf_size`` — identical to
  the SceneArrays padded-slot indexing, so hits from the packet kernel and
  the jnp reference traversal are interchangeable.

The reference's analog of this file is main.js:360-392 (flattening the BVH
into padded float textures for texelFetch); here the flattening targets VMEM
rows fetched with dynamic row slices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


BIG = np.float32(3.0e38)      # empty-child box coords (masked via link)
EMPTY_LINK = np.float32(-1.0e9)   # empty-child link sentinel (kernel masks)
WIDTH = 8                     # default wide-BVH branching factor


class PackedBVH(NamedTuple):
    nodes: np.ndarray      # (W, 128) f32 — one wide node per row
    leaves: np.ndarray     # (L, 128) f32
    depth: int             # wide-tree depth (root = 0); sizes the kernel
    #                        traversal stack: max ptr <= width * (depth + 2)
    width: int = WIDTH     # branching factor (8 or 16)
    # (W, width) i32: the BINARY node id each wide child slot was collapsed
    # from (-1 = empty slot).  Consumed by the on-device AABB refit
    # (scene/refit.py) to rewrite child boxes in place after animation
    # transforms without a host rebuild.
    wide_child_bin: np.ndarray = None


def _collapse8(left, right, is_leaf, node_min, node_max, width=WIDTH):
    """Collapse a binary tree into `width`-ary nodes.

    Greedy: starting from (left, right), repeatedly expand the internal
    child with the largest surface area until the node has `width` children
    or only leaves remain.  Returns (children_of, axis_of) where
    children_of[w] is the list of binary ids forming wide node w, sorted
    by centroid along axis_of[w] (the parent's principal axis), and
    wide_ord maps binary id -> wide ordinal for internal children."""
    d = node_max - node_min
    area = 2.0 * (d[:, 0] * d[:, 1] + d[:, 0] * d[:, 2] + d[:, 1] * d[:, 2])
    center = node_min + node_max            # 2x centroid, order-equivalent

    order = [0]
    wide_ord = {0: 0}
    depth_of = [0]
    children_of = []
    axis_of = []
    qi = 0
    while qi < len(order):
        b = order[qi]
        dep = depth_of[qi]
        qi += 1
        kids = [int(left[b]), int(right[b])]
        while len(kids) < width:
            best, best_a = -1, -1.0
            for i, k in enumerate(kids):
                if not is_leaf[k] and area[k] > best_a:
                    best_a, best = float(area[k]), i
            if best < 0:
                break
            k = kids.pop(best)
            kids.extend([int(left[k]), int(right[k])])
        axis = int(np.argmax(node_max[b] - node_min[b]))
        kids.sort(key=lambda k: float(center[k, axis]))
        for k in kids:
            if not is_leaf[k]:
                wide_ord[k] = len(order)
                order.append(k)
                depth_of.append(dep + 1)
        children_of.append(kids)
        axis_of.append(axis)
    return children_of, axis_of, wide_ord, max(depth_of)


def pack_bvh(node_left, node_right, node_tri, node_min, node_max,
             tri_v0, tri_e1, tri_e2, leaf_size: int,
             width: int = WIDTH) -> PackedBVH:
    """Convert the SceneArrays-style binary BVH (per-node bbox, DFS
    preorder, tri_offset >= 0 marking leaves) into `width`-wide packed
    tables."""
    if leaf_size * 9 > 128:
        raise ValueError(f"leaf_size {leaf_size} needs {leaf_size * 9} lanes")
    if 7 * width + 1 > 128:
        raise ValueError(f"width {width} needs {7 * width + 1} lanes")
    if len(tri_v0) >= 1 << 24:
        # sorted_intersect (core/integrator.py) rides hit slots through f32
        # sort/scatter rows, exact only below 2^24 — fail loudly at build
        # time instead of silently corrupting hits (round-2 ADVICE item 1)
        raise ValueError(
            f"{len(tri_v0)} padded triangle slots >= 2^24: slot indices "
            "would lose precision in the f32 hit-permutation path; "
            "partition the scene or raise leaf_size")
    node_left = np.asarray(node_left)
    node_right = np.asarray(node_right)
    node_tri = np.asarray(node_tri)
    node_min = np.asarray(node_min, np.float32)
    node_max = np.asarray(node_max, np.float32)
    is_leaf = node_tri >= 0

    # leaf ordinal: tri_offset / leaf_size (offsets are leaf_size-aligned)
    leaf_ord = np.where(is_leaf, node_tri // leaf_size, -1)
    n_leaves = int(is_leaf.sum())

    wd = width
    if is_leaf[0]:
        # single-leaf scene: one wide root with one leaf child
        rows = np.zeros((1, 128), np.float32)
        rows[0, 0:3 * wd] = BIG              # empty child minima
        rows[0, 3 * wd:6 * wd] = -BIG        # empty child maxima
        rows[0, 6 * wd:7 * wd] = EMPTY_LINK
        depth = 0
        rows[0, 0 * wd] = node_min[0, 0]
        rows[0, 1 * wd] = node_min[0, 1]
        rows[0, 2 * wd] = node_min[0, 2]
        rows[0, 3 * wd] = node_max[0, 0]
        rows[0, 4 * wd] = node_max[0, 1]
        rows[0, 5 * wd] = node_max[0, 2]
        rows[0, 6 * wd] = -1.0               # leaf 0
        nodes_flat = rows
        wcb = np.full((1, wd), -1, np.int32)
        wcb[0, 0] = 0
    else:
        children_of, axis_of, wide_ord, depth = _collapse8(
            node_left, node_right, is_leaf, node_min, node_max, width=wd)
        w = len(children_of)
        rows = np.zeros((w, 128), np.float32)
        rows[:, 0:3 * wd] = BIG              # empty child minima
        rows[:, 3 * wd:6 * wd] = -BIG        # empty child maxima
        rows[:, 6 * wd:7 * wd] = EMPTY_LINK
        wcb = np.full((w, wd), -1, np.int32)
        for wi, kids in enumerate(children_of):
            for c, k in enumerate(kids):
                rows[wi, 0 * wd + c] = node_min[k, 0]
                rows[wi, 1 * wd + c] = node_min[k, 1]
                rows[wi, 2 * wd + c] = node_min[k, 2]
                rows[wi, 3 * wd + c] = node_max[k, 0]
                rows[wi, 4 * wd + c] = node_max[k, 1]
                rows[wi, 5 * wd + c] = node_max[k, 2]
                rows[wi, 6 * wd + c] = (-(leaf_ord[k] + 1.0) if is_leaf[k]
                                        else float(wide_ord[k]))
                wcb[wi, c] = k
            rows[wi, 7 * wd] = float(axis_of[wi])
        nodes_flat = rows

    # leaves: slot order is already leaf-contiguous
    s = len(tri_v0)
    tri9 = np.concatenate(
        [np.asarray(tri_v0, np.float32), np.asarray(tri_e1, np.float32),
         np.asarray(tri_e2, np.float32)], axis=1)          # (S, 9)
    assert s == n_leaves * leaf_size, (s, n_leaves, leaf_size)
    leaves = np.zeros((max(n_leaves, 1), 128), np.float32)
    leaves[:n_leaves, : leaf_size * 9] = tri9.reshape(n_leaves,
                                                      leaf_size * 9)
    return PackedBVH(nodes=nodes_flat, leaves=leaves, depth=depth,
                     width=wd, wide_child_bin=wcb)
