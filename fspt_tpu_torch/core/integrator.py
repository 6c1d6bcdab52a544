"""The path-tracing integrator: port of fspt_tpu.core.integrator (the
wavefront estimator of reference shader/tracer.fs:436-518).

The estimator is the JAX version's, function for function and expression
for expression: the same sampling strategies, MIS, compaction, state sort,
cross-sample wavefront batching, area-light NEE and BVH heatmap, driven by
the same counter-based RNG streams (core/rng.py), so on the same scene, rays
and keys the two agree up to float32 rounding.  What changes is idiom:

  * `lax.scan` over bounce iterations becomes a Python loop, and the
    per-iteration stats are stacked at the end;
  * `jax.tree.map` over path states becomes explicit concatenation;
  * `lax.sort((key, arange))` becomes a stable `torch.sort` (equal, since
    the lane ids break ties in index order);
  * `sg` (jax.lax.stop_gradient) becomes `.detach()` at the same 34
    values, each marked with the JAX line it mirrors: the traversal's
    inputs and outputs, lobe choices, env-bin and light picks, sort keys
    and compaction's RR keys carry no gradient, and everything else is
    differentiable w.r.t. materials, atlas, env map and camera, as in the
    JAX version (parallel/dist.py make_train_step takes the gradient);
  * traversal goes through the port's ops — "split" to ops/traverse4, "walk"
    to ops/traverse3, "packet" to ops/traverse — each a CUDA kernel for
    tensors on a card and its plain version on the CPU; "brute" is the
    O(N*T) oracle of core/geometry.

The TPU's VMEM table budget does not apply on the card (the tables stay in
device memory), so unlike the JAX version "split" never falls back to the
walk kernel's HBM mode and the heatmap always runs in lane-count mode.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import brdf
from fspt_tpu_torch.core import rng
from fspt_tpu_torch.core import vec
from fspt_tpu_torch.core.env import (env_radiance, env_radiance_rows,
                                     env_radiance_rows_nearest,
                                     pack_env_rows, sample_env_bins,
                                     sample_env_bins_radiance)
from fspt_tpu_torch.core.geometry import brute_force_intersect
from fspt_tpu_torch.core.rng import stream_uniforms
from fspt_tpu_torch.core.vec import V3, dot, normalize, where
from fspt_tpu_torch.ops.traverse import (PacketHit, count_launch,
                                         packet_traverse)
from fspt_tpu_torch.ops.traverse3 import packet_traverse3
from fspt_tpu_torch.ops.traverse4 import packet_traverse4
from fspt_tpu_torch.trace import span

INTERSECTORS = ("split", "walk", "packet", "brute")
MODES = ("render", "bvh_heatmap")


def check_config(cfg: RenderConfig):
    """Raise for an intersector or mode name that fspt_tpu does not define
    (the JAX version routes an unknown intersector to "packet" and an
    unknown mode to "render" without a word)."""
    if cfg.intersector not in INTERSECTORS:
        raise ValueError(f"unknown intersector {cfg.intersector!r}; one of "
                         f"{INTERSECTORS}")
    if cfg.mode not in MODES:
        raise ValueError(f"unknown mode {cfg.mode!r}; one of {MODES}")


def _contig(v: V3) -> V3:
    return V3(*(p.contiguous() for p in v))


def _sg(v: V3) -> V3:
    """stop_gradient of a V3."""
    return V3(*(p.detach() for p in v))


def intersect(scene, cfg: RenderConfig, meta, origin: V3, direction: V3,
              tmax=None, any_hit: bool = False) -> PacketHit:
    """Nearest-hit (or any-hit) traversal by cfg.intersector.

    "split" gets 2*width entries of stack slack over the tree's bound, as in
    the JAX version; "walk" and "packet" get none, as there.  The port's
    kernels raise instead of dropping a push past the stack.  `visits` is
    per ray under "split" and per group (128 rays for "walk", 1024 for
    "packet") otherwise; 0 under "brute".

    Not differentiable by design: the hit is a discrete event, so the
    inputs go in detached and shading re-derives the differentiable
    quantities.  One `fspt.traverse` span a launch (fspt_tpu_torch/trace.py).
    """
    with span("traverse"):
        check_config(cfg)
        if cfg.intersector == "brute":
            return _intersect_brute(scene, cfg, origin, direction, tmax=tmax)
        width = meta.bvh_width
        depth = max(cfg.stack_depth, meta.pk_stack_depth)
        # JAX :88-89, :103-104
        args = (scene.pk_nodes, scene.pk_leaves, _contig(_sg(origin)),
                _contig(_sg(direction)),
                tmax.detach().contiguous() if tmax is not None else None)
        kw = dict(leaf_size=meta.leaf_size, any_hit=any_hit)
        if cfg.intersector == "split":
            return packet_traverse4(*args, stack_depth=depth + 2 * width,
                                    tree_width=width, **kw)
        if cfg.intersector == "walk":
            return packet_traverse3(*args, stack_depth=depth, tree_width=width,
                                    **kw)
        if width != 8:
            raise ValueError(
                "the v1 'packet' intersector reads the 8-wide BVH layout; "
                f"this scene was packed {width}-wide — rebuild the scene "
                "with bvh_width=8 or use intersector='walk'")
        return packet_traverse(*args, stack_depth=depth, **kw)


def _morton21(x, y, z):
    """21-bit Morton code from three [0,1) floats (7 bits/axis)."""
    def q(a):
        return torch.clamp((a * 128.0).to(torch.int32), 0, 127)
    qx, qy, qz = q(x), q(y), q(z)
    code = torch.zeros_like(qx)
    for b in range(7):
        code = (code
                | (((qx >> b) & 1) << (3 * b + 2))
                | (((qy >> b) & 1) << (3 * b + 1))
                | (((qz >> b) & 1) << (3 * b)))
    return code


def _scene_box(scene):
    wmin = scene.node_min[0]
    extent = torch.clamp(scene.node_max[0] - wmin, min=1e-6)
    return wmin, extent


def sorted_intersect(scene, cfg: RenderConfig, meta, origin: V3,
                     direction: V3, active, tmax=None,
                     any_hit: bool = False) -> PacketHit:
    """Traversal with coherence sorting of the launch: rays sorted by
    (origin Morton code << 3 | direction octant), inactive lanes last, hits
    un-permuted afterwards.  With cfg.sort_state the path state is already
    in Morton order (_sort_state), so launches go out unsorted.  A sorted
    launch is one `fspt.raysort` span, the key to the un-permute, with its
    `fspt.traverse` inside."""
    if (cfg.intersector not in ("packet", "walk", "split")
            or not cfg.sort_rays or cfg.sort_state):
        return intersect(scene, cfg, meta, origin, direction, tmax=tmax,
                         any_hit=any_hit)
    with span("raysort"):
        n = origin.x.shape[0]
        octant = ((direction.x < 0).to(torch.int32) * 4
                  + (direction.y < 0).to(torch.int32) * 2
                  + (direction.z < 0).to(torch.int32))
        wmin, extent = _scene_box(scene)
        morton = _morton21((origin.x - wmin[0]) / extent[0],
                           (origin.y - wmin[1]) / extent[1],
                           (origin.z - wmin[2]) / extent[2])
        key = torch.where(active, (morton << 3) | octant,
                          torch.full_like(morton, 1 << 30))
        if tmax is None:
            tmax = torch.full((n,), cfg.max_t, dtype=torch.float32,
                              device=origin.x.device)
        perm = torch.sort(key.detach(), stable=True).indices    # JAX :168
        rays = torch.stack([origin.x, origin.y, origin.z, direction.x,
                            direction.y, direction.z, tmax],
                           dim=-1).detach()[perm]                # JAX :169
        hit = intersect(scene, cfg, meta,
                        V3(rays[:, 0], rays[:, 1], rays[:, 2]),
                        V3(rays[:, 3], rays[:, 4], rays[:, 5]),
                        tmax=rays[:, 6], any_hit=any_hit)
        # slot/visits ride the f32 rows exactly (values < 2^24)
        packed = torch.stack([hit.t, hit.slot.to(torch.float32), hit.u,
                              hit.v, hit.visits.to(torch.float32)], dim=-1)
        out = torch.zeros_like(packed)
        out[perm] = packed
        return PacketHit(t=out[:, 0], slot=out[:, 1].to(torch.int32),
                         u=out[:, 2], v=out[:, 3],
                         visits=out[:, 4].to(torch.int32))


def _intersect_brute(scene, cfg, origin: V3, direction: V3,
                     tmax=None) -> PacketHit:
    """O(N*T) oracle path (cfg.intersector='brute', tests only).  Its t, u
    and v are torch expressions of the rays, so the rays go in detached
    like the kernels' and the hit carries no gradient."""
    o = vec.to_array(origin).detach()                            # JAX :188
    d = vec.to_array(direction).detach()                         # JAX :189
    t, slot = brute_force_intersect(o, d, scene.tri_v0, scene.tri_e1,
                                    scene.tri_e2, max_t=cfg.max_t)
    if tmax is not None:
        # honor the per-ray clip like the traversal kernels (hits require
        # t < tmax), so light-NEE shadow rays do not self-block on the
        # light they sample
        tmax = tmax.detach()                                     # JAX :197
        hit_ok = t < tmax
        slot = torch.where(hit_ok, slot, -1)
        t = torch.where(hit_ok, t, tmax)
    gi = torch.clamp(slot, min=0).long()
    v0 = scene.tri_v0[gi]
    e1 = scene.tri_e1[gi]
    e2 = scene.tri_e2[gi]
    p = o + d * t[:, None]
    # barycentrics of the hit (u weights corner1, v weights corner2)
    v2 = p - v0
    d00 = torch.sum(e1 * e1, -1)
    d01 = torch.sum(e1 * e2, -1)
    d11 = torch.sum(e2 * e2, -1)
    d20 = torch.sum(v2 * e1, -1)
    d21 = torch.sum(v2 * e2, -1)
    den = d00 * d11 - d01 * d01
    inv = torch.reciprocal(torch.where(torch.abs(den) > 1e-20, den,
                                       torch.ones_like(den)))
    u = (d11 * d20 - d01 * d21) * inv
    v = (d00 * d21 - d01 * d20) * inv
    return PacketHit(t=t, slot=slot, u=u, v=v, visits=torch.zeros_like(slot))


def atlas_fetch_rgb(meta, layer, u, v, rows) -> V3:
    """Bilinear RGB fetch from the (L*R*R, 3) atlas row table with REPEAT
    wrap; v=0 maps to the image bottom row.  layer: (N,) int."""
    r = meta.atlas_res
    x = u * r - 0.5
    y = (1.0 - v) * r - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = torch.remainder(x0f.to(torch.int32), r)
    x1 = torch.remainder(x0 + 1, r)
    y0 = torch.remainder(y0f.to(torch.int32), r)
    y1 = torch.remainder(y0 + 1, r)
    base = layer * (r * r)
    i00 = base + y0 * r + x0
    i10 = base + y0 * r + x1
    i01 = base + y1 * r + x0
    i11 = base + y1 * r + x1
    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    out = (rows[i00] * w00[:, None] + rows[i10] * w10[:, None]
           + rows[i01] * w01[:, None] + rows[i11] * w11[:, None])
    return V3(out[:, 0], out[:, 1], out[:, 2])


class TexTables(NamedTuple):
    """Loop-invariant texture tables (_packed_tables).

      mat_tex: (U*R*R, 24) — the four material maps of each combined
          material plus the x-neighbour texel's (a bilinear fetch of all
          four maps is 2 row gathers); None above the memory guard, when
          the per-map atlas_rows path is used instead.
      env6: (H*W, 6) — x-neighbour-packed environment map; None makes
          shading filter the flat env planes instead (env_radiance).
      bins4: (B, 4) — env importance bins as rows.
      atlas_rows: (L*R*R, 3) — per-map fallback table; None with mat_tex,
          so that tables built ahead hold only what the trace reads.
      light_cdf, light_area: the area lights' CDF and total area
          (light_tables), with cfg.use_light_nee; else None.
    """

    mat_tex: Optional[torch.Tensor]
    env6: Optional[torch.Tensor]
    bins4: torch.Tensor
    atlas_rows: Optional[torch.Tensor]
    light_cdf: Optional[torch.Tensor] = None
    light_area: Optional[torch.Tensor] = None


# Packed-material-table memory guard: combined (U, R, R, 24) f32 texels.
_MAT_TEX_BUDGET_BYTES = 2 * 1024 ** 3


def _packed_tables(scene, cfg: RenderConfig, meta) -> TexTables:
    """The texture tables of the scene tensors.  They are differentiable
    functions of the atlas and env parameters, so a trace that may be
    differentiated builds them itself (scene_tables), and its graph reaches
    the caller's leaves: the train step's gradient needs that.  A caller
    that asks no gradient may build them ahead, once for as long as the
    scene tensors hold their values, and hand them to the trace
    (trace_paths' `tables`): runtime/renderer.py StepGraph does, once a
    capture or scene refresh."""
    atlas_rows = torch.stack([scene.atlas_r, scene.atlas_g, scene.atlas_b],
                             dim=-1)
    r = meta.atlas_res
    n_mat = scene.mat_layers.shape[0]
    mat_tex = None
    if cfg.packed_textures and n_mat * r * r * 24 * 4 <= _MAT_TEX_BUDGET_BYTES:
        layers = atlas_rows.reshape(meta.atlas_layers, r, r, 3)
        combo = torch.cat(
            [layers[scene.mat_layers[:, k].long()] for k in range(4)], dim=-1)
        nxt = torch.roll(combo, -1, dims=2)        # x-neighbor, REPEAT wrap
        mat_tex = torch.cat([combo, nxt], dim=-1).reshape(n_mat * r * r, 24)
    env6 = pack_env_rows(scene.env_rgb, (meta.env_h, meta.env_w))
    bins4 = torch.stack([scene.bin_x0, scene.bin_y0, scene.bin_x1,
                         scene.bin_y1], dim=-1)
    lights = light_tables(scene) if cfg.use_light_nee else (None, None)
    return TexTables(mat_tex=mat_tex, env6=env6, bins4=bins4,
                     atlas_rows=atlas_rows if mat_tex is None else None,
                     light_cdf=lights[0],
                     light_area=lights[1])


class SceneTables(NamedTuple):
    """What a trace reads of the scene besides its tree and its raw
    tensors: the texture tables and the (S, 43) attribute table."""

    tex: TexTables
    attr: torch.Tensor


def scene_tables(scene, cfg: RenderConfig, meta) -> SceneTables:
    """The scene's tables, built from its tensors.  Every build counts one
    in `scene_tables.launches` (while a CUDA graph is captured, in
    `.captured`: ops/traverse.py count_launch)."""
    with span("tables"):
        count_launch(scene_tables, scene.pk_nodes.device)
        return SceneTables(_packed_tables(scene, cfg, meta),
                           _attr_table(scene))


scene_tables.launches = 0
scene_tables.captured = 0


def light_tables(scene):
    """The area lights' CDF (float32) and total area (0-d float32), their
    areas summed in float64.  The scene compiler's light_cdf is a float32
    running sum: over thousands of light triangles it drifts by up to a few
    1e-6, which moves ~1e-3 of the light picks."""
    rows = lambda v: torch.stack([v.x, v.y, v.z], dim=-1).double()
    area = 0.5 * torch.linalg.norm(torch.linalg.cross(
        rows(scene.light_e1), rows(scene.light_e2)), dim=-1)
    total = area.sum()
    cdf = torch.cumsum(area, 0) / torch.clamp(total, min=1e-20)
    return cdf.float(), total.float()


def atlas_fetch_all(mat_tex, meta, map_c, u, v):
    """Bilinear fetch of all four material maps from the packed
    (U*R*R, 24) table: 2 row gathers.  Returns (diffuse, emissive,
    normal_rgb, mr)."""
    r = meta.atlas_res
    x = u * r - 0.5
    y = (1.0 - v) * r - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx = (x - x0f)[:, None]
    fy = (y - y0f)[:, None]
    x0 = torch.remainder(x0f.to(torch.int32), r)
    y0 = torch.remainder(y0f.to(torch.int32), r)
    y1 = torch.remainder(y0 + 1, r)
    base = map_c * (r * r)
    r0 = mat_tex[base + y0 * r + x0]
    r1 = mat_tex[base + y1 * r + x0]
    top = r0[:, 0:12] * (1 - fx) + r0[:, 12:24] * fx
    bot = r1[:, 0:12] * (1 - fx) + r1[:, 12:24] * fx
    out = top * (1 - fy) + bot * fy
    c3 = lambda i: V3(out[:, i], out[:, i + 1], out[:, i + 2])
    return c3(0), c3(3), c3(6), c3(9)


class PathState(NamedTuple):
    origin: V3                    # (W,) planes
    direction: V3
    t: torch.Tensor               # (W,) current-hit distance
    slot: torch.Tensor            # (W,) i32 current-hit slot (-1 miss)
    bu: torch.Tensor              # (W,) hit barycentric (corner 1)
    bv: torch.Tensor              # (W,) hit barycentric (corner 2)
    throughput: V3
    color: V3                     # radiance gathered along the path so far
    bounces_used: torch.Tensor    # (W,) i32
    active: torch.Tensor          # (W,) bool
    prev_pdf: torch.Tensor        # (W,) pdf of the ray that made this hit
    lidx: torch.Tensor            # (W,) i32 framebuffer lane
    gid: torch.Tensor             # (W,) i32 global RNG lane id


class TraceStats(NamedTuple):
    """Per-sample counts.  rays counts active lanes only (primary + live
    scatter/shadow segments).  visits sums the scatter launch's `visits`
    over its lanes, whose meaning is the intersector's: the ray's own node
    and leaf fetches under "split" (ops/traverse4), the group's shared visit
    count under "walk" and "packet" (ops/traverse3, ops/traverse; as on the
    TPU), 0 under "brute".  shadow counts env and light shadow lanes
    together; light, the light ones alone, is None without
    cfg.use_light_nee.  refracted is counted only where the trace is asked
    to (trace_paths' count_refracted), else None: neither adds an
    operation to a trace that does not count it."""

    rays: torch.Tensor        # () f32
    active: torch.Tensor      # (max_iters,) f32 live scatter lanes per it
    shadow: torch.Tensor      # (max_iters,) f32 live shadow lanes per it
    visits: torch.Tensor      # (max_iters,) f32 summed visits of scatter lanes
    rr_lanes: torch.Tensor    # () f32 active lanes dropped by compaction
    light: Optional[torch.Tensor] = None      # (max_iters,) f32 light lanes
    refracted: Optional[torch.Tensor] = None  # (max_iters,) f32 lanes that
    #                                           took the refraction branch


# RNG stream id base for compaction survivor selection (streams 1..max_iters
# are the shading streams)
_RR_STREAM = 64

# float state planes moved by one row gather (_take)
_F_FIELDS = ("origin", "direction", "t", "bu", "bv", "throughput", "color",
             "prev_pdf")


def _take(state: PathState, idx) -> PathState:
    """Rows `idx` of every state plane: one (W, 16) float row gather and one
    (W, 5) int row gather, as the JAX version stacks them."""
    f = []
    for name in _F_FIELDS:
        a = getattr(state, name)
        f.extend(a if isinstance(a, V3) else [a])
    frows = torch.stack(f, dim=-1)[idx]
    irows = torch.stack([state.slot, state.bounces_used,
                         state.active.to(torch.int32), state.lidx,
                         state.gid], dim=-1)[idx]
    return PathState(
        origin=V3(frows[:, 0], frows[:, 1], frows[:, 2]),
        direction=V3(frows[:, 3], frows[:, 4], frows[:, 5]),
        t=frows[:, 6], bu=frows[:, 7], bv=frows[:, 8],
        throughput=V3(frows[:, 9], frows[:, 10], frows[:, 11]),
        color=V3(frows[:, 12], frows[:, 13], frows[:, 14]),
        prev_pdf=frows[:, 15],
        slot=irows[:, 0], bounces_used=irows[:, 1], active=irows[:, 2] > 0,
        lidx=irows[:, 3], gid=irows[:, 4])


def _cat_states(states) -> PathState:
    out = {}
    for name in PathState._fields:
        parts = [getattr(s, name) for s in states]
        out[name] = (vec.cat(parts) if isinstance(parts[0], V3)
                     else torch.cat(parts))
    return PathState(**out)


def _compact(state: PathState, key, it: int, w_out: int,
             key_rows=None, lanes_per_key: int = 0,
             stream_base: int = _RR_STREAM):
    """Shrink the path state to `w_out` lanes, unbiasedly: the survivors
    are a uniform random min(A, w_out)-subset of the A active lanes
    (smallest per-lane RNG key wins), reweighted by A / w_out when
    A > w_out (Russian roulette).  When A <= w_out every active lane
    survives with weight 1 and the estimator is unchanged lane for lane.
    Dropped lanes come back as (lidx, color) rows for the caller's single
    end-of-trace deposit."""
    with span("compact"):
        w_in = state.lidx.shape[0]
        active = state.active
        n_active = active.to(torch.int32).sum()
        u = stream_uniforms(key, stream_base + it, (1, w_in),
                            lane_offset=state.gid, key_rows=key_rows,
                            lanes_per_key=lanes_per_key)[0]
        # JAX :416
        skey = torch.where(active, u.detach(), torch.full_like(u, 2.0))
        perm = torch.sort(skey, stable=True).indices
        new = _take(state, perm[:w_out])
        sel_drop = perm[w_out:]
        drop_lidx = state.lidx[sel_drop]
        drop_color = vec.to_array(state.color)[sel_drop]
        scale = torch.where(n_active > w_out,
                            n_active.to(torch.float32) / float(w_out),
                            torch.ones((), device=u.device))
        rr_dropped = torch.clamp(n_active - w_out, min=0).to(torch.float32)
        new = new._replace(throughput=new.throughput * scale)
        return new, (drop_lidx, drop_color), rr_dropped


def _sort_state(scene, state: PathState) -> PathState:
    """Reorder the whole path state into Morton order of the current hit
    points (inactive lanes last), so every traversal launch of the
    iteration goes out coherent and its hits come back aligned.
    Estimator-neutral: RNG is keyed by gid and deposits by lidx."""
    with span("sort"):
        hit_p = state.origin + state.direction * state.t
        wmin, extent = _scene_box(scene)
        morton = _morton21((hit_p.x - wmin[0]) / extent[0],
                           (hit_p.y - wmin[1]) / extent[1],
                           (hit_p.z - wmin[2]) / extent[2])
        key = torch.where(state.active, morton,
                          torch.full_like(morton, 1 << 30))
        return _take(state, torch.sort(key.detach(),            # JAX :478
                                       stable=True).indices)


def _compact_groups(cfg: RenderConfig, n: int):
    """Run-length-encode the compaction schedule into (width, n_iters)
    groups; widths are rounded up to a multiple of 1024."""
    sched = cfg.compact_schedule
    groups = []
    prev_w = n
    for it in range(cfg.max_iters):
        div = sched[min(it, len(sched) - 1)]
        w = min(prev_w, math.ceil(n / div / 1024) * 1024, n)
        if groups and w == groups[-1][0]:
            groups[-1][1] += 1
        else:
            groups.append([w, 1])
        prev_w = w
    return groups


def _check_streams(cfg: RenderConfig):
    check_config(cfg)
    if cfg.max_iters >= _RR_STREAM:
        raise ValueError(
            f"max_iters={cfg.max_iters} collides with the compaction RNG "
            f"stream base {_RR_STREAM}; lower bounces/extra_refraction_iters")


def _primary_state(scene, cfg, meta, tex, origin, direction, lidx, gid):
    env_hw = (meta.env_h, meta.env_w)
    n = origin.x.shape[0]
    primary = intersect(scene, cfg, meta, origin, direction)
    miss = primary.slot < 0
    zero = vec.splat(0.0, like=origin.x)
    color = where(miss, env_radiance_rows(tex.env6, env_hw, direction,
                                          scene.env_theta), zero)
    return PathState(
        origin=origin, direction=direction, t=primary.t, slot=primary.slot,
        bu=primary.u, bv=primary.v,
        throughput=vec.splat(1.0, like=origin.x), color=color,
        bounces_used=torch.zeros(n, dtype=torch.int32,
                                 device=origin.x.device),
        active=~miss,
        prev_pdf=torch.full((n,), 1.0e16, dtype=torch.float32,
                            device=origin.x.device),
        lidx=lidx, gid=gid)


def _bounce(scene, cfg, meta, attr, tex, state, it, key, key_rows=None,
            lanes_per_key=0, count_refracted=False):
    """One bounce iteration: optional state sort, the iteration's
    uniforms, shading and the traversal launch."""
    if cfg.sort_state:
        state = _sort_state(scene, state)
    w = state.lidx.shape[0]
    with span("uniforms"):
        u = stream_uniforms(key, 1 + it, (11, w), lane_offset=state.gid,
                            key_rows=key_rows, lanes_per_key=lanes_per_key)
    with span("shade"):
        return _shade_and_scatter(scene, cfg, meta, state, u,
                                  (meta.env_h, meta.env_w), attr, tex,
                                  count_refracted=count_refracted)


def trace_stats(n: int, per_it, rr_lanes) -> TraceStats:
    """TraceStats of a trace of n rays from its iterations' counts (each
    _shade_and_scatter's second result); a count an iteration leaves None
    stays None."""
    c = [None if p[0] is None else torch.stack(p) for p in zip(*per_it)]
    return TraceStats(rays=float(n) + c[0].sum() + c[1].sum(), active=c[0],
                      shadow=c[1], visits=c[2], rr_lanes=rr_lanes,
                      light=c[3], refracted=c[4])


def _clip(x, lo: float, hi: float):
    """jnp.clip as the JAX version computes it, minimum(maximum(x, lo), hi):
    the same values as torch.clamp, and at a tie (a lane whose radiance
    is exactly 0) the same half gradient, where torch.clamp passes all."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _deposit(drops, state, n):
    """One scatter writes every framebuffer lane exactly once: the dropped
    rows of every compaction plus the final survivors.  As the indices are
    unique, the write's backward is a gather of the output's gradient."""
    all_idx = torch.cat([d[0] for d in drops] + [state.lidx]).long()
    all_col = torch.cat([d[1] for d in drops] + [vec.to_array(state.color)])
    acc = torch.zeros((n, 3), dtype=torch.float32, device=all_col.device)
    acc[all_idx] = all_col
    return acc


def trace_paths(scene, cfg: RenderConfig, meta, origin: V3, direction: V3,
                key, lane_offset=0, return_stats: bool = False,
                count_refracted: bool = False,
                tables: Optional[SceneTables] = None):
    """Path-trace one sample for every input ray.  Returns V3 (N,) radiance
    (or (radiance, TraceStats) when return_stats; TraceStats.refracted
    counted with count_refracted).  key: host key data or its (2,) int64
    device row (core/rng.py).  lane_offset: global lane id of ray 0, or an
    (N,) tensor of explicit ids.  tables: scene_tables of `scene`, built
    ahead by a caller that asks no gradient of them (_packed_tables); None
    builds them inside the trace."""
    _check_streams(cfg)
    n = origin.x.shape[0]
    dev = origin.x.device
    if torch.is_tensor(lane_offset):
        gid0 = lane_offset.to(torch.int32)
    else:
        gid0 = int(lane_offset) + torch.arange(n, dtype=torch.int32,
                                               device=dev)
    tex, attr = scene_tables(scene, cfg, meta) if tables is None else tables
    state = _primary_state(scene, cfg, meta, tex, origin, direction,
                           torch.arange(n, dtype=torch.int32, device=dev),
                           gid0)

    rr_lanes = torch.zeros((), dtype=torch.float32, device=dev)
    per_it = []
    if not cfg.compact:
        for it in range(cfg.max_iters):
            state, p = _bounce(scene, cfg, meta, attr, tex, state, it, key,
                               count_refracted=count_refracted)
            per_it.append(p)
        if cfg.sort_state:
            # state lanes are in Morton order; map colors back to rays
            out = _deposit([], state, n)
            c = V3(out[:, 0], out[:, 1], out[:, 2])
        else:
            c = state.color
    else:
        drops = []
        it0 = 0
        for w, count in _compact_groups(cfg, n):
            if w < state.lidx.shape[0]:
                state, drop, dropped = _compact(state, key, it0, w)
                drops.append(drop)
                rr_lanes = rr_lanes + dropped
            for it in range(it0, it0 + count):
                state, p = _bounce(scene, cfg, meta, attr, tex, state, it,
                                   key, count_refracted=count_refracted)
                per_it.append(p)
            it0 += count
        acc = _deposit(drops, state, n)
        c = V3(acc[:, 0], acc[:, 1], acc[:, 2])

    radiance = V3(*(_clip(p, 0.0, cfg.radiance_clamp) for p in c))
    if not return_stats:
        return radiance
    return radiance, trace_stats(n, per_it, rr_lanes)


def _merged_groups(cfg: RenderConfig, n_per: int, n_tot: int):
    """Split the schedule into per-sample groups (phase A, widths above
    cfg.wavefront_merge_width) and merged groups realigned to the combined
    lane count (phase B)."""
    groups = _compact_groups(cfg, n_per)
    merged = _compact_groups(cfg, n_tot)
    split = len(groups)
    for gi, (w, _) in enumerate(groups):
        if w <= cfg.wavefront_merge_width:
            split = gi
            break
    groups_a = groups[:split]
    its_a = sum(c for _, c in groups_a)
    groups_b = []
    itx = 0
    for w, count in merged:
        take = max(0, min(count, itx + count - its_a))
        if take and itx + count > its_a:
            groups_b.append([w, take])
        itx += count
    return groups_a, its_a, groups_b


def trace_paths_batched(scene, cfg: RenderConfig, meta, origin: V3,
                        direction: V3, batch_key, n_per: int,
                        return_stats: bool = False,
                        tables: Optional[SceneTables] = None):
    """Cross-sample wavefront batch: K = n_total / n_per samples traced so
    their compacted tails share launches.

    Phase A runs the iterations whose per-sample width exceeds
    cfg.wavefront_merge_width per sample, exactly like K sequential
    trace_paths calls (sample k keyed fold_in(batch_key, k)).  The K
    compacted states then concatenate into one state for the remaining
    iterations, whose uniforms are keyed by (key_rows[lane // n_per],
    lane % n_per) — bit-identical to the unbatched streams, so the batch
    reproduces K sequential trace_paths calls whenever RR does not fire.

    batch_key: host key data, or the (K, 2) int64 device table of the
    samples' keys (row k the key data of fold_in(batch_key, k)), which a
    captured sample step reads.  tables: as trace_paths takes them.

    Returns the SUM over the K samples of their (clamped) radiance as V3
    (n_per,) planes (and TraceStats when return_stats)."""
    n_tot = origin.x.shape[0]
    k_samples = n_tot // n_per
    if k_samples * n_per != n_tot:
        raise ValueError(f"{n_tot} rays are not a whole number of "
                         f"{n_per}-ray samples")
    _check_streams(cfg)
    dev = origin.x.device
    if torch.is_tensor(batch_key):
        key_rows = batch_key
    else:
        key_rows = rng.key_rows_tensor(
            rng.key_rows_for(batch_key, k_samples), dev)
    tex, attr = scene_tables(scene, cfg, meta) if tables is None else tables
    groups_a, its_a, groups_b = _merged_groups(cfg, n_per, n_tot)

    states, per_a, rr, drops = [], [], [], []
    for k in range(k_samples):
        lanes = slice(k * n_per, (k + 1) * n_per)
        o = V3(origin.x[lanes], origin.y[lanes], origin.z[lanes])
        d = V3(direction.x[lanes], direction.y[lanes], direction.z[lanes])
        skey = key_rows[k]
        local = torch.arange(n_per, dtype=torch.int32, device=dev)
        state = _primary_state(scene, cfg, meta, tex, o, d,
                               k * n_per + local, local)
        per_k = []
        it0 = 0
        for w, count in groups_a:
            if w < state.lidx.shape[0]:
                state, drop, dropped = _compact(state, skey, it0, w)
                drops.append(drop)
                rr.append(dropped)
            for it in range(it0, it0 + count):
                state, p = _bounce(scene, cfg, meta, attr, tex, state, it,
                                   skey)
                per_k.append(p)
            it0 += count
        per_a.append(per_k)
        # shrink to the merged phase's per-sample share before stacking,
        # with the sample's own key; stream base _RR_STREAM + max_iters
        # keeps this draw independent of a second compaction at the same
        # iteration in the merged phase (see the JAX version)
        if groups_b:
            w_b = -(-groups_b[0][0] // k_samples)
            if w_b < state.lidx.shape[0]:
                state, drop, dropped = _compact(
                    state, skey, it0, w_b,
                    stream_base=_RR_STREAM + cfg.max_iters)
                drops.append(drop)
                rr.append(dropped)
        # globalize gid for the merged phase's key_rows lookup
        states.append(state._replace(gid=k * n_per + state.gid))

    rr_lanes = (torch.stack(rr).sum() if rr
                else torch.zeros((), dtype=torch.float32, device=dev))
    # phase-A stats summed over the batch, per iteration
    per_it = [tuple(None if p[0] is None else sum(p)
                    for p in zip(*(per_a[k][i] for k in range(k_samples))))
              for i in range(its_a)]

    state = _cat_states(states)
    it0 = its_a
    for w, count in groups_b:
        if w < state.lidx.shape[0]:
            state, drop, dropped = _compact(state, batch_key, it0, w,
                                            key_rows=key_rows,
                                            lanes_per_key=n_per)
            drops.append(drop)
            rr_lanes = rr_lanes + dropped
        for it in range(it0, it0 + count):
            state, p = _bounce(scene, cfg, meta, attr, tex, state, it,
                               batch_key, key_rows=key_rows,
                               lanes_per_key=n_per)
            per_it.append(p)
        it0 += count
    acc = _deposit(drops, state, n_tot)

    # per-sample radiance clamp, then sum over the batch
    c = _clip(acc.reshape(k_samples, n_per, 3), 0.0, cfg.radiance_clamp)
    total = c.sum(dim=0)
    radiance = V3(total[:, 0], total[:, 1], total[:, 2])
    if not return_stats:
        return radiance
    return radiance, trace_stats(n_tot, per_it, rr_lanes)


def traversal_launches(cfg: RenderConfig, n_per: int, k_samples: int) -> int:
    """Traversal launches that tracing k_samples samples of n_per rays makes
    (one sample step at k_samples = cfg.batch_spp): one primary launch per
    sample plus, per bounce iteration, one scatter+shadow launch (two with
    cfg.split_shadow) — per sample, except that trace_paths_batched shares
    the launches of its merged phase.  The heatmap traces primaries only."""
    if cfg.mode == "bvh_heatmap":
        return k_samples
    per_it = 2 if cfg.split_shadow else 1
    if not (cfg.wavefront_batch and cfg.compact and k_samples > 1):
        return k_samples * (1 + per_it * cfg.max_iters)
    _, its_a, groups_b = _merged_groups(cfg, n_per, n_per * k_samples)
    return (k_samples * (1 + per_it * its_a)
            + per_it * sum(c for _, c in groups_b))


def _corner_lerp(c0: V3, c1: V3, c2: V3, w0, u, v) -> V3:
    return c0 * w0 + c1 * u + c2 * v


def _attr_table(scene):
    """The (S, 43) per-slot shading-attribute row table, fetched with one
    row gather per bounce."""
    return torch.stack([
        scene.nrm0.x, scene.nrm0.y, scene.nrm0.z,
        scene.nrm1.x, scene.nrm1.y, scene.nrm1.z,
        scene.nrm2.x, scene.nrm2.y, scene.nrm2.z,
        scene.tan0.x, scene.tan0.y, scene.tan0.z,
        scene.tan1.x, scene.tan1.y, scene.tan1.z,
        scene.tan2.x, scene.tan2.y, scene.tan2.z,
        scene.btn0.x, scene.btn0.y, scene.btn0.z,
        scene.btn1.x, scene.btn1.y, scene.btn1.z,
        scene.btn2.x, scene.btn2.y, scene.btn2.z,
        scene.uv0u, scene.uv0v, scene.uv1u, scene.uv1v,
        scene.uv2u, scene.uv2v,
        scene.emit.x, scene.emit.y, scene.emit.z,
        scene.ior, scene.dielectric,
        # atlas layer ids as f32 (exact below 2^24 layers)
        scene.map_d.to(torch.float32), scene.map_e.to(torch.float32),
        scene.map_n.to(torch.float32), scene.map_mr.to(torch.float32),
        scene.map_c.to(torch.float32),
    ], dim=-1)


def _shade_and_scatter(scene, cfg: RenderConfig, meta, s: PathState, u,
                       env_hw, attr, tex: TexTables, trace_fn=None,
                       count_refracted: bool = False):
    """One shading+scatter iteration (tracer.fs:447-518): hit attributes,
    atlas fetches, emissive add, lobe choice, env NEE (and area-light NEE
    with cfg.use_light_nee) with MIS, and the traversal: ONE nearest-hit
    launch of the scatter and shadow rays together, or, with
    cfg.split_shadow, a nearest-hit launch of the scatter rays and an
    any-hit launch of the shadow rays.

    trace_fn(o, d, active, tmax, any_hit=False) -> PacketHit (measurement
    only, as in the JAX version: scripts/r5common.py captures the bounce-0
    launch with it) replaces the sorted_intersect launches; production
    callers leave it None.

    Returns the next state and the iteration's counts: live scatter lanes,
    shadow lanes, the scatter lanes' visits, light shadow lanes (None
    without light NEE) and, with count_refracted, the lanes that took the
    refraction branch (else None)."""
    if trace_fn is None:
        def trace_fn(o, d, a, tmax, any_hit=False):
            return sorted_intersect(scene, cfg, meta, o, d, a, tmax,
                                    any_hit=any_hit)
    active = s.active & (s.slot >= 0)
    slot = torch.clamp(s.slot, min=0).detach()                  # JAX :870

    def env_rad(d):
        if tex.env6 is not None:
            return env_radiance_rows(tex.env6, env_hw, d, scene.env_theta)
        return env_radiance(scene.env_rgb, env_hw, d, scene.env_theta)

    # ---- gather hit attributes: ONE (N, 43) row gather -----------------
    row = attr[slot]

    def col3(i):
        return V3(row[:, i], row[:, i + 1], row[:, i + 2])

    emitt = col3(33)
    ior = row[:, 36]
    dielectric = row[:, 37]
    bu, bv = s.bu.detach(), s.bv.detach()                       # JAX :886
    w0 = 1.0 - bu - bv
    tex_u = row[:, 27] * w0 + row[:, 29] * bu + row[:, 31] * bv
    tex_v = row[:, 28] * w0 + row[:, 30] * bu + row[:, 32] * bv
    bary_n = _corner_lerp(col3(0), col3(3), col3(6), w0, bu, bv)
    bary_t = _corner_lerp(col3(9), col3(12), col3(15), w0, bu, bv)
    bary_bt = _corner_lerp(col3(18), col3(21), col3(24), w0, bu, bv)

    # ---- atlas fetches (tracer.fs:453-456) -----------------------------
    with span("atlas"):
        if tex.mat_tex is not None:
            map_c = row[:, 42].detach().to(torch.int32)         # JAX :896
            tex_diffuse, tex_emissive, tn, mr = atlas_fetch_all(
                tex.mat_tex, meta, map_c, tex_u, tex_v)
        else:
            ar = tex.atlas_rows
            fetch = lambda col: atlas_fetch_rgb(                # JAX :900-903
                meta, row[:, col].detach().to(torch.int32), tex_u, tex_v,
                ar)
            tex_diffuse, tex_emissive = fetch(38), fetch(39)
            mr, tn = fetch(41), fetch(40)
    metallic, roughness = mr.x, mr.y * mr.y              # tracer.fs:457
    tex_normal = V3((tn.x - 0.5) * 2.0, (tn.y - 0.5) * 2.0, tn.z)

    # ---- shading frame (tracer.fs:332-337,459-463) --------------------
    macro_n = normalize(bary_t * tex_normal.x + bary_bt * tex_normal.y
                        + bary_n * tex_normal.z)
    inside = dot(-s.direction, bary_n) < 0.0
    n1 = torch.where(inside, ior, 1.0)
    n2 = torch.where(inside, 1.0, ior)
    macro_n = where(inside, -macro_n, macro_n)
    hit_p = s.origin + s.direction * s.t
    offset_out = hit_p + macro_n * (cfg.epsilon * 2.0)

    # ---- emissive (tracer.fs:467) -------------------------------------
    zero = vec.splat(0.0, like=u[0])
    if cfg.use_light_nee:
        # weight the light-sampled (constant-emittance) term against the
        # bsdf pdf that produced this hit: standard emitter-hit MIS
        cos_l = torch.abs(dot(bary_n, -s.direction))
        p_light_hit = (s.t * s.t) / torch.clamp(
            cos_l * tex.light_area, min=1e-12)
        w_hit, _ = brdf.mis_weights(s.prev_pdf, p_light_hit)
        emit_add = (s.throughput * tex_emissive * tex_diffuse
                    * cfg.emissive_scale + s.throughput * emitt * w_hit)
    else:
        emit_add = (s.throughput * tex_emissive * tex_diffuse
                    * cfg.emissive_scale + s.throughput * emitt)
    color = s.color + where(active, emit_add, zero)

    incident = -s.direction

    # ---- samples -------------------------------------------------------
    micro_n = brdf.sample_microfacet(macro_n, roughness, u[0].detach(),
                                     u[1].detach())              # JAX :941
    if cfg.nee_env_nearest and tex.env6 is not None:
        env_dir, env_pdf, nee_rad = sample_env_bins_radiance(
            tex.bins4, tex.env6, scene.n_bins, env_hw, scene.env_theta,
            u[2].detach(), u[3].detach(), u[4].detach())         # JAX :948
    else:
        env_dir, env_pdf = sample_env_bins(
            tex.bins4, scene.n_bins, env_hw, scene.env_theta,
            u[2].detach(), u[3].detach(), u[4].detach())         # JAX :952
        nee_rad = None
    env_dir = _sg(env_dir)                                       # JAX :954
    cos_env = dot(macro_n, env_dir)

    fresnel = brdf.schlick(incident, micro_n, n1, n2)
    p_specular = fresnel * (1.0 - metallic) + metallic   # mix(f, 1, metallic)
    specular = p_specular.detach() > u[5]                        # JAX :959
    refractive = ~specular & (dielectric >= 0.0)

    # specular branch
    spec_dir = brdf.reflect(-incident, micro_n)
    spec_pdf = brdf.gtr2_pdf(incident, macro_n, roughness, spec_dir)
    spec_bsdf = (brdf.eval_specular(incident, macro_n, tex_diffuse, metallic,
                                    roughness, spec_dir)
                 * (torch.clamp(dot(macro_n, spec_dir), 0.0, 1.0)
                    / torch.clamp(spec_pdf.detach(),     # JAX :969
                                  min=1e-12)))
    spec_env = (brdf.eval_specular(incident, macro_n, tex_diffuse, metallic,
                                   roughness, env_dir)
                * (torch.clamp(cos_env, 0.0, 1.0) / env_pdf))

    # refraction branch
    refr_dir = brdf.refract(s.direction, micro_n, n1 / n2)
    # diffuse branch
    diff_dir = brdf.sample_lambert(macro_n, u[6].detach(),
                                   u[7].detach())                # JAX :977
    diff_pdf = brdf.lambert_pdf(macro_n, diff_dir)
    diff_bsdf = (brdf.eval_lambert(tex_diffuse)
                 * (torch.clamp(dot(macro_n, diff_dir), 0.0, 1.0)
                    / torch.clamp(diff_pdf.detach(),     # JAX :981
                                  min=1e-12)))
    diff_env = (brdf.eval_lambert(tex_diffuse)
                * (torch.clamp(cos_env, 0.0, 1.0) / env_pdf))

    new_dir = where(specular, spec_dir, where(refractive, refr_dir, diff_dir))
    new_dir = _sg(normalize(new_dir))                            # JAX :986
    bsdf_pdf = torch.where(specular, spec_pdf,
                           torch.where(refractive, 1.0, diff_pdf))
    one = vec.splat(1.0, like=u[0])
    bsdf_throughput = where(specular, spec_bsdf,
                            where(refractive, one, diff_bsdf))
    env_throughput = where(specular, spec_env,
                           where(refractive, zero, diff_env))
    offset_in = hit_p - macro_n * (cfg.epsilon * 2.0)
    new_origin = where(refractive, offset_in, offset_out)

    # Beer's-law-ish absorption when exiting a medium (tracer.fs:497)
    beer = V3(*(torch.clamp(1.0 - (1.0 - c) * s.t * dielectric, min=0.0)
                for c in (tex_diffuse.x, tex_diffuse.y, tex_diffuse.z)))
    bsdf_throughput = where(inside, beer, bsdf_throughput)

    w_env, w_bsdf = brdf.mis_weights(env_pdf,
                                     bsdf_pdf.detach())          # JAX :1003

    # ---- traversal: unwanted lanes are parked above the scene ----------
    park = vec.splat(1.0e9, like=u[0])
    up = V3(torch.zeros_like(u[0]), torch.ones_like(u[0]),
            torch.zeros_like(u[0]))
    scat_o = where(active, new_origin, park)
    scat_d = where(active, new_dir, up)
    scat_tmax = torch.full_like(u[0], cfg.max_t)

    shadow_wanted = active & (dielectric < 0.0) & (cos_env > 0.0)
    shad_o = where(shadow_wanted, offset_out, park)
    shad_d = where(shadow_wanted, env_dir, up)
    shadow_tmax = torch.where(shadow_wanted, scat_tmax, 0.0)

    seg_o = [scat_o, shad_o]
    seg_d = [scat_d, shad_d]
    seg_t = [scat_tmax, shadow_tmax]
    seg_a = [active, shadow_wanted]

    if cfg.use_light_nee:
        with span("light"):
            last = tex.light_cdf.shape[0] - 1
            li = torch.clamp(torch.searchsorted(tex.light_cdf,
                                                u[8].detach()),  # JAX :1030
                             0, last)
            lv0 = vec.gather(scene.light_v0, li)
            le1 = vec.gather(scene.light_e1, li)
            le2 = vec.gather(scene.light_e2, li)
            su = torch.sqrt(u[9].detach())                       # JAX :1035
            u10 = u[10].detach()                                 # JAX :1036
            p_l = lv0 + le1 * (1.0 - su) + le2 * (u10 * su)
            to_l = p_l - offset_out
            dist2 = dot(to_l, to_l)
            dist = torch.sqrt(dist2)
            wi = to_l * torch.reciprocal(torch.clamp(dist, min=1e-12))
            ln = normalize(vec.cross(le1, le2))
            cos_li = torch.abs(dot(ln, -wi))
            pdf_l = dist2 / torch.clamp(cos_li * tex.light_area, min=1e-12)
            cos_s = dot(macro_n, wi)
            light_wanted = (active & (dielectric < 0.0) & (cos_s > 0.0)
                            & (scene.n_light_tris > 0))
            seg_o.append(where(light_wanted, offset_out, park))
            seg_d.append(where(light_wanted, wi, up))
            seg_t.append(torch.where(light_wanted, dist * (1.0 - 1e-3), 0.0))
            seg_a.append(light_wanted)

    n = active.shape[0]
    if cfg.split_shadow:
        nxt = trace_fn(seg_o[0], seg_d[0], seg_a[0], seg_t[0])
        occ = trace_fn(vec.cat(seg_o[1:]), vec.cat(seg_d[1:]),
                       torch.cat(seg_a[1:]), torch.cat(seg_t[1:]),
                       any_hit=True)
        seg_slot = lambda i: occ.slot[(i - 1) * n:i * n]
    else:
        hits = trace_fn(vec.cat(seg_o), vec.cat(seg_d), torch.cat(seg_a),
                        torch.cat(seg_t))
        nxt = PacketHit(*(a[:n] for a in hits))
        seg_slot = lambda i: hits.slot[i * n:(i + 1) * n]
    shadow_open = seg_slot(1) < 0

    # ---- NEE env contribution (tracer.fs:499-505) ----------------------
    nee_L = nee_rad if nee_rad is not None else env_rad(env_dir)
    nee = (s.throughput * env_throughput * nee_L * w_env)
    color = color + where(shadow_wanted & shadow_open, nee, zero)

    # ---- NEE area-light contribution (working version of the
    # reference's dead lightTex path; MIS vs the sampled lobe) -----------
    if cfg.use_light_nee:
        with span("light"):
            spec_li = (brdf.eval_specular(incident, macro_n, tex_diffuse,
                                          metallic, roughness, wi)
                       * (torch.clamp(cos_s, 0.0, 1.0) / pdf_l))
            diff_li = (brdf.eval_lambert(tex_diffuse)
                       * (torch.clamp(cos_s, 0.0, 1.0) / pdf_l))
            light_tp = where(specular, spec_li,
                             where(refractive, zero, diff_li))
            le = vec.gather(scene.emit, scene.light_slot[li].long())
            l_open = seg_slot(2) < 0
            w_l, _ = brdf.mis_weights(pdf_l, bsdf_pdf.detach())  # JAX :1101
            l_nee = s.throughput * light_tp * le * w_l
            color = color + where(light_wanted & l_open, l_nee, zero)

    throughput = where(active, s.throughput * bsdf_throughput, s.throughput)

    # ---- scatter-ray env hit (tracer.fs:509-512) -----------------------
    scat_miss = active & (nxt.slot < 0)
    if cfg.escape_env_nearest and tex.env6 is not None:
        esc_L = env_radiance_rows_nearest(tex.env6, env_hw, new_dir,
                                          scene.env_theta)
    else:
        esc_L = env_rad(new_dir)
    esc = throughput * esc_L * w_bsdf
    color = color + where(scat_miss, esc, zero)

    # ---- bookkeeping ----------------------------------------------------
    bounces_used = s.bounces_used + (active & ~refractive).to(torch.int32)
    still_active = active & ~scat_miss & (bounces_used < cfg.bounces)

    f32 = torch.float32
    n_shadow = shadow_wanted.to(f32).sum()
    n_light = n_refracted = None
    if cfg.use_light_nee:
        n_light = light_wanted.to(f32).sum()
        n_shadow = n_shadow + n_light
    if count_refracted:
        n_refracted = (active & refractive).to(f32).sum()
    per_it = (active.to(f32).sum(), n_shadow, nxt.visits.to(f32).sum(),
              n_light, n_refracted)

    return PathState(
        origin=where(active, new_origin, s.origin),
        direction=where(active, new_dir, s.direction),
        t=torch.where(active, nxt.t, s.t),
        slot=torch.where(active, nxt.slot, s.slot),
        bu=torch.where(active, nxt.u, s.bu),
        bv=torch.where(active, nxt.v, s.bv),
        throughput=throughput,
        color=color,
        bounces_used=bounces_used,
        active=still_active,
        prev_pdf=torch.where(active & ~refractive, bsdf_pdf.detach(),
                             s.prev_pdf),                        # JAX :1138
        lidx=s.lidx, gid=s.gid,
    ), per_it


def trace_heatmap(scene, cfg: RenderConfig, meta, origin: V3,
                  direction: V3) -> V3:
    """BVH traversal-cost heatmap (reference mode=test, bvh_test.fs:224-232):
    a node-visit count scaled by heatmap_scale, as grayscale.

    With the walk intersectors ("walk", "split") the v3 kernel runs in
    lane-count mode: each pixel reports the number of BVH nodes its own ray
    wants (root included), the reference's per-pixel semantics.  The JAX
    version does so only when the tables fit the TPU's VMEM; the port always
    does (no such budget on the card).  "packet" and "brute" keep their
    group-constant (or zero) counts, as in the JAX version."""
    if cfg.intersector in ("walk", "split"):
        with span("traverse"):
            hit = packet_traverse3(                             # JAX :1160
                scene.pk_nodes, scene.pk_leaves, _contig(_sg(origin)),
                _contig(_sg(direction)), leaf_size=meta.leaf_size,
                stack_depth=max(cfg.stack_depth, meta.pk_stack_depth),
                tree_width=meta.bvh_width, lane_counts=True)
    else:
        hit = intersect(scene, cfg, meta, origin, direction)
    v = hit.visits.to(torch.float32) * cfg.heatmap_scale
    return V3(v, v, v)
