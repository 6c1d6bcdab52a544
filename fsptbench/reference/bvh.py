"""The plain reference's ray casting: a binary BVH of median splits built
on the host, and a per-ray stack walk written as tensor code.

The nearest hit a walk returns is a property of the triangles alone: any
correct tree gives it, up to rounding and coplanar ties, so this tree
shares nothing with the program's wide tree, its packing or its visit
order.  The triangle test is Moller-Trumbore with the upstream tracer's
epsilons (tracer.fs:300-315): |det| >= 1e-6, barycentrics inside, and
1e-6 < t < the ray's current best.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

LEAF = 4
EPS = 1.0e-6


@dataclasses.dataclass
class Tree:
    lo: torch.Tensor        # (M, 3) node box
    hi: torch.Tensor
    left: torch.Tensor      # (M,) int64 child, or -1 at a leaf
    right: torch.Tensor
    first: torch.Tensor     # (M,) int64 first entry of a leaf in `tris`
    count: torch.Tensor     # (M,) int64 triangles of a leaf (0 inside)
    tris: torch.Tensor      # (T,) int64 triangle ids in leaf order
    depth: int


def build(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, device) -> Tree:
    """Median split on the longest axis of the centroids' box, level by
    level, until a node holds at most LEAF triangles."""
    tri = np.stack([v0, v0 + e1, v0 + e2], axis=1).astype(np.float64)
    tmin, tmax = tri.min(axis=1), tri.max(axis=1)
    cen = 0.5 * (tmin + tmax)
    order = np.arange(len(v0))
    lo, hi, left, right, first, count = [], [], [], [], [], []
    # (node id, start, end) of the nodes still to split
    level = [(0, 0, len(v0))]
    lo.append(None), hi.append(None), left.append(-1), right.append(-1)
    first.append(0), count.append(0)
    depth = 0
    while level:
        nxt = []
        for node, s, e in level:
            idx = order[s:e]
            lo[node] = tmin[idx].min(axis=0)
            hi[node] = tmax[idx].max(axis=0)
            if e - s <= LEAF:
                first[node], count[node] = s, e - s
                continue
            c = cen[idx]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            order[s:e] = idx[np.argsort(c[:, axis], kind="stable")]
            mid = (s + e) // 2
            for a, b in ((s, mid), (mid, e)):
                nxt.append((len(lo), a, b))
                lo.append(None), hi.append(None), left.append(-1)
                right.append(-1), first.append(0), count.append(0)
            left[node], right[node] = nxt[-2][0], nxt[-1][0]
        level = nxt
        depth += 1
    # widened by a part in 10^5 so that rounding never loses a hit on a
    # box face (a flat floor has a box of no thickness)
    lo, hi = np.asarray(lo), np.asarray(hi)
    pad = 1e-5 * np.maximum(1.0, np.maximum(np.abs(lo), np.abs(hi)))
    lo, hi = lo - pad, hi + pad
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    i64 = lambda a: torch.tensor(np.asarray(a, np.int64), device=device)
    return Tree(lo=f32(lo), hi=f32(hi), left=i64(left), right=i64(right),
                first=i64(first), count=i64(count), tris=i64(order),
                depth=depth)


def _slab(o, inv, lo, hi):
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    return tmin, (tmax >= tmin) & (tmax > 0.0)


def _mt(o, d, v0, e1, e2):
    """Moller-Trumbore of rays (R, 3) against triangles (R, 3):
    (t, u, v, ok)."""
    p = torch.linalg.cross(d, e2, dim=-1)
    det = (e1 * p).sum(-1)
    inv = 1.0 / torch.where(det.abs() < EPS, torch.ones_like(det), det)
    tv = o - v0
    u = (tv * p).sum(-1) * inv
    q = torch.linalg.cross(tv, e1, dim=-1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    ok = ((det.abs() >= EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > EPS))
    return t, u, v, ok


def cast(tree: Tree, v0, e1, e2, origin, direction, tmax):
    """Nearest hits of rays (R, 3), (R, 3) with limits (R,): (t, tri, u,
    v), tri -1 and t = tmax on a miss."""
    dev = origin.device
    r = origin.shape[0]
    best_t = tmax.clone()
    best_i = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(r, device=dev)
    best_v = torch.zeros(r, device=dev)
    if r == 0:
        return best_t, best_i, best_u, best_v
    safe = torch.where(direction.abs() < 1e-20,
                       torch.full_like(direction, 1e-20), direction)
    inv = 1.0 / safe
    stack = torch.zeros((r, 2 * tree.depth + 4), dtype=torch.int64,
                        device=dev)
    ptr = torch.zeros(r, dtype=torch.int64, device=dev)
    root_t, root_ok = _slab(origin, inv, tree.lo[0], tree.hi[0])
    ptr[root_ok & (root_t < best_t)] = 1
    live = torch.nonzero(ptr > 0).squeeze(1)
    while live.numel():
        ptr[live] -= 1
        node = stack[live, ptr[live]]
        leaf = tree.count[node] > 0
        # inner nodes: push the wanted children, the nearer one on top
        g, nd = live[~leaf], node[~leaf]
        if g.numel():
            o, iv, bt = origin[g], inv[g], best_t[g]
            ch = torch.stack([tree.left[nd], tree.right[nd]], dim=1)
            t0, ok0 = _slab(o, iv, tree.lo[ch[:, 0]], tree.hi[ch[:, 0]])
            t1, ok1 = _slab(o, iv, tree.lo[ch[:, 1]], tree.hi[ch[:, 1]])
            ok0 = ok0 & (t0 < bt)
            ok1 = ok1 & (t1 < bt)
            near_first = t0 <= t1
            far = torch.where(near_first, ch[:, 1], ch[:, 0])
            near = torch.where(near_first, ch[:, 0], ch[:, 1])
            far_ok = torch.where(near_first, ok1, ok0)
            near_ok = torch.where(near_first, ok0, ok1)
            p = ptr[g]
            stack[g, p] = far
            p = p + far_ok.long()
            stack[g, p] = near
            ptr[g] = p + near_ok.long()
        # leaves: test their triangles
        g, nd = live[leaf], node[leaf]
        if g.numel():
            o, d = origin[g], direction[g]
            bt, bi = best_t[g], best_i[g]
            bu, bv = best_u[g], best_v[g]
            n, f = tree.count[nd], tree.first[nd]
            for j in range(LEAF):
                has = j < n
                tri = tree.tris[torch.where(has, f + j, f)]
                t, u, v, ok = _mt(o, d, v0[tri], e1[tri], e2[tri])
                ok = ok & has & (t < bt)
                bt = torch.where(ok, t, bt)
                bi = torch.where(ok, tri, bi)
                bu = torch.where(ok, u, bu)
                bv = torch.where(ok, v, bv)
            best_t[g], best_i[g], best_u[g], best_v[g] = bt, bi, bu, bv
        live = live[ptr[live] > 0]
    return best_t, best_i, best_u, best_v
