"""Ray-geometry intersection primitives over ray batches (port of
fspt_tpu.core.geometry).

Parity targets: reference tracer.fs rayTriangleIntersect (:300-315,
Moller-Trumbore with epsilon-degenerate rejection), rayBoxIntersect
(:317-326, slab test returning tMin or MAX_T), barycentricWeights
(:339-353).

Shapes are those of the JAX version: points and vectors are (..., 3)
tensors that broadcast against each other, misses are encoded as `max_t`,
and every division is guarded so padding and degenerate triangles give
finite values.  Plain torch, no kernel (the JAX versions are plain jnp).
"""

from __future__ import annotations

import torch

MAX_T = 1.0e5          # reference tracer.fs:10
EPSILON = 1.0e-6       # reference tracer.fs:11


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def intersect_tri(origin, direction, v0, e1, e2,
                  eps: float = EPSILON, max_t: float = MAX_T):
    """Moller-Trumbore.  origin/direction: (..., 3); v0/e1/e2: (..., 3)
    broadcastable against them.  Returns t (...,) with `max_t` for misses:
    |det| < eps, the barycentric bounds and t <= eps reject."""
    p = cross(direction, e2)
    det = dot(e1, p)
    valid = torch.abs(det) >= eps
    inv_det = torch.reciprocal(torch.where(valid, det, torch.ones_like(det)))
    tvec = origin - v0
    u = dot(tvec, p) * inv_det
    q = cross(tvec, e1)
    v = dot(direction, q) * inv_det
    t = dot(e2, q) * inv_det
    hit = (valid & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > eps))
    return torch.where(hit, t, torch.full_like(t, max_t))


def intersect_aabb(origin, inv_dir, bmin, bmax, max_t: float = MAX_T):
    """Slab test.  Returns the entry distance tMin, or `max_t` when missed
    (hit iff tMax >= tMin and tMax > 0)."""
    t1 = (bmin - origin) * inv_dir
    t2 = (bmax - origin) * inv_dir
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = (tmax >= tmin) & (tmax > 0.0)
    return torch.where(hit, tmin, torch.full_like(tmin, max_t))


def barycentric_weights(p, v0, e1, e2):
    """(u, v, w) weights of point p in triangle (v0, v0+e1, v0+e2): (..., 3)
    where u weights v0, v weights v1 and w weights v2."""
    v2 = p - v0
    d00 = dot(e1, e1)
    d01 = dot(e1, e2)
    d11 = dot(e2, e2)
    d20 = dot(v2, e1)
    d21 = dot(v2, e2)
    denom = d00 * d11 - d01 * d01
    inv = torch.reciprocal(torch.where(torch.abs(denom) > 1e-20, denom,
                                       torch.ones_like(denom)))
    v = (d11 * d20 - d01 * d21) * inv
    w = (d00 * d21 - d01 * d20) * inv
    u = 1.0 - v - w
    return torch.stack([u, v, w], dim=-1)


def brute_force_intersect(origin, direction, tri_v0, tri_e1, tri_e2,
                          max_t: float = MAX_T, chunk: int = 512):
    """O(N_rays * N_tris) oracle intersector: nearest (t, slot), slot -1 on
    a miss.  Chunked over triangles so memory stays O(N_rays * chunk);
    ties keep the lowest slot, as the JAX version's argmin does."""
    n_tris = tri_v0.shape[0]
    shape = origin.shape[:-1]
    best_t = torch.full(shape, max_t, dtype=torch.float32,
                        device=origin.device)
    best_i = torch.full(shape, -1, dtype=torch.int32, device=origin.device)
    for s0 in range(0, n_tris, chunk):
        t = intersect_tri(origin[..., None, :], direction[..., None, :],
                          tri_v0[s0:s0 + chunk], tri_e1[s0:s0 + chunk],
                          tri_e2[s0:s0 + chunk], max_t=max_t)
        tv, ti = torch.min(t, dim=-1)
        better = tv < best_t
        best_i = torch.where(better, (s0 + ti).to(torch.int32), best_i)
        best_t = torch.where(better, tv, best_t)
    best_i = torch.where(best_t >= max_t, -1, best_i)
    return best_t, best_i
