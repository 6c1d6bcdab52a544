"""Per-ray binary-BVH traversal (port of fspt_tpu.core.traversal): the
reference's per-thread stack walk (tracer.fs:366-404 intersectScene), used
by Renderer.autofocus.

Each ray carries its current node, a stack of `stack_depth` entries and its
best hit.  Per step a live ray tests a leaf's `leaf_size` triangles, then
descends to its near child and pushes the far one, descends to its only
wanted child, or pops.  Children are skipped unless closer than the best
hit, as in the reference.  The JAX version is a lax.while_loop over every
ray in lockstep; here a torch loop steps only the live rays, which gives the
same per-ray results (rays do not interact).  A push past `stack_depth`
raises, where the JAX version clamps it into the last slot.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fspt_tpu_torch.core.geometry import (MAX_T, brute_force_intersect,
                                          intersect_aabb, intersect_tri)


class Hit(NamedTuple):
    t: torch.Tensor       # (N,) f32 — max_t on a miss
    slot: torch.Tensor    # (N,) i32 — padded-slot index, -1 on a miss
    visits: torch.Tensor  # (N,) i32 — traversal steps


def intersect_scene(scene, origin, direction, leaf_size: int = 4,
                    stack_depth: int = 64, max_t: float = MAX_T) -> Hit:
    """Nearest-hit traversal.  origin/direction: (N, 3).  scene: the
    tensors of SceneArrays (node_left/right/tri/min/max, tri_v0/e1/e2)."""
    n = origin.shape[0]
    dev = origin.device
    inv_dir = torch.reciprocal(torch.where(
        torch.abs(direction) < 1e-20,
        torch.where(direction < 0, torch.full_like(direction, -1e-20),
                    torch.full_like(direction, 1e-20)), direction))
    idx = torch.zeros(n, dtype=torch.int64, device=dev)      # -1 = done
    stack = torch.full((n, stack_depth), -1, dtype=torch.int64, device=dev)
    ptr = torch.ones(n, dtype=torch.int64, device=dev)       # [0] sentinel
    best_t = torch.full((n,), max_t, dtype=torch.float32, device=dev)
    best_slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    visits = torch.zeros(n, dtype=torch.int32, device=dev)
    lanes = torch.arange(leaf_size, device=dev)

    live = torch.arange(n, device=dev)
    while live.numel():
        gi = idx[live]
        visits[live] += 1
        tri = scene.node_tri[gi].long()
        is_leaf = tri >= 0

        # ---- leaf: test its leaf_size triangle slots --------------------
        r = live[is_leaf]
        if r.numel():
            slots = tri[is_leaf][:, None] + lanes[None, :]
            t_leaf = intersect_tri(origin[r][:, None, :],
                                   direction[r][:, None, :],
                                   scene.tri_v0[slots], scene.tri_e1[slots],
                                   scene.tri_e2[slots], max_t=max_t)
            tv, k = torch.min(t_leaf, dim=-1)
            better = tv < best_t[r]
            best_t[r] = torch.where(better, tv, best_t[r])
            best_slot[r] = torch.where(
                better, (tri[is_leaf] + k).to(torch.int32), best_slot[r])

        # ---- internal: descend near, defer far, or pop ------------------
        new_idx = torch.empty_like(gi)
        pop = is_leaf.clone()
        r = live[~is_leaf]
        if r.numel():
            g = gi[~is_leaf]
            left = scene.node_left[g].long()
            right = scene.node_right[g].long()
            o, inv = origin[r], inv_dir[r]
            lh = intersect_aabb(o, inv, scene.node_min[left],
                                scene.node_max[left], max_t=max_t)
            rh = intersect_aabb(o, inv, scene.node_min[right],
                                scene.node_max[right], max_t=max_t)
            bt = best_t[r]
            lgo, rgo = lh < bt, rh < bt
            both = lgo & rgo
            one = lgo ^ rgo
            near = torch.where(lh > rh, right, left)
            far = torch.where(lh > rh, left, right)
            b = r[both]
            if b.numel():
                if int(ptr[b].max()) >= stack_depth:
                    raise RuntimeError(
                        f"intersect_scene: stack overflow (stack_depth="
                        f"{stack_depth})")
                stack[b, ptr[b]] = far[both]
                ptr[b] += 1
            new_idx[~is_leaf] = torch.where(
                both, near, torch.where(one, torch.where(lgo, left, right),
                                        torch.zeros_like(near)))
            pop[~is_leaf] = ~(both | one)
        p = live[pop]
        ptr[p] -= 1
        new_idx[pop] = stack[p, ptr[p]]
        idx[live] = new_idx
        live = live[idx[live] >= 0]

    slot = torch.where(best_t >= max_t, -1, best_slot)
    return Hit(t=best_t, slot=slot, visits=visits)


def intersect_scene_brute(scene, origin, direction,
                          max_t: float = MAX_T) -> Hit:
    """Oracle path used by tests and cfg.intersector='brute'."""
    t, slot = brute_force_intersect(origin, direction, scene.tri_v0,
                                    scene.tri_e1, scene.tri_e2, max_t=max_t)
    return Hit(t=t, slot=slot, visits=torch.zeros_like(slot))


def occluded(scene, origin, direction, leaf_size: int = 4,
             stack_depth: int = 64, max_t: float = MAX_T):
    """Shadow-ray predicate: True if anything is hit (full nearest-hit
    traversal, as the reference does for shadows, tracer.fs:501)."""
    hit = intersect_scene(scene, origin, direction, leaf_size=leaf_size,
                          stack_depth=stack_depth, max_t=max_t)
    return hit.slot >= 0
