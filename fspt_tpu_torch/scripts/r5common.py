"""Shared round-5 study helpers (port of scripts/r5common.py): the real
bounce-0 launch capture and timing."""

from __future__ import annotations

import time

import torch

from fspt_tpu_torch.core import rng
from fspt_tpu_torch.core.camera import generate_rays
from fspt_tpu_torch.core.env import env_radiance_rows
from fspt_tpu_torch.core.integrator import (PathState, _attr_table, _compact,
                                            _compact_groups, _morton21,
                                            _packed_tables,
                                            _shade_and_scatter, intersect,
                                            sorted_intersect)
from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.runtime.layout import tile_order
from fspt_tpu_torch.runtime.renderer import CameraState


def _first_tensor(out):
    if torch.is_tensor(out):
        return out
    for x in out:
        t = _first_tensor(x)
        if t is not None:
            return t
    return None


def drain(out):
    """Wait for `out` (a tensor or a nest of them) to be computed: a
    synchronise of its device."""
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return out


def timed(fn, *args, reps=10):
    """Mean wall seconds of fn(*args) over `reps` calls, after one warm-up
    call; the clock stops after a synchronise."""
    drain(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    drain(out)
    return (time.perf_counter() - t0) / reps


def bounce0_inputs(scene, arrays, meta, cfg, size=512):
    """The arguments of the first `_shade_and_scatter` of a size x size
    sample (sample_key(key(0), 0), camera rays of stream 0, the primary
    hit, the env colour of misses, the first compaction): (state, u,
    env_hw, attr, tex)."""
    dev = arrays.pk_nodes.device
    cam = CameraState.from_config(scene.camera, dev)
    n = size * size
    env_hw = (meta.env_h, meta.env_w)
    pixel_idx = torch.from_numpy(tile_order(size, size)).to(dev)
    key = rng.sample_key(rng.key(0), 0)
    cam_u = rng.stream_uniforms(key, 0, (4, n), device=dev)
    origin, direction = generate_rays(
        cam.position, cam.direction, cam.fov_scale, cam.focal_depth,
        cam.aperture, (size, size), cam_u, pixel_idx=pixel_idx)
    primary = intersect(arrays, cfg, meta, origin, direction)
    tex = _packed_tables(arrays, cfg, meta)
    attr = _attr_table(arrays)
    miss = primary.slot < 0
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    color = V3(*(torch.where(miss, c, zero) for c in env_radiance_rows(
        tex.env6, env_hw, direction, arrays.env_theta)))
    state = PathState(
        origin=origin, direction=direction, t=primary.t, slot=primary.slot,
        bu=primary.u, bv=primary.v,
        throughput=V3(zero + 1, zero + 1, zero + 1), color=color,
        bounces_used=torch.zeros(n, dtype=torch.int32, device=dev),
        active=~miss,
        prev_pdf=torch.full((n,), 1.0e16, dtype=torch.float32, device=dev),
        lidx=torch.arange(n, dtype=torch.int32, device=dev),
        gid=torch.arange(n, dtype=torch.int32, device=dev))
    w0 = _compact_groups(cfg, n)[0][0]
    if w0 < n:
        state, _, _ = _compact(state, key, 0, w0)
    u = rng.stream_uniforms(key, 1, (11, w0), lane_offset=state.gid)
    return state, u, env_hw, attr, tex


def capture_bounce0(scene, arrays, meta, cfg, size=512):
    """Real bounce-0 launch rays (scatter+shadow, post-compaction), sorted
    by the production coherence key — the exact input the traversal sees.
    Returns (origin V3, direction V3, tmax, active), all on `arrays`'
    device."""
    rec = []

    def fn(o, d, a, tmax, any_hit=False):
        rec.append((o, d, a, tmax))
        return sorted_intersect(arrays, cfg, meta, o, d, a, tmax,
                                any_hit=any_hit)

    _shade_and_scatter(arrays, cfg, meta,
                       *bounce0_inputs(scene, arrays, meta, cfg, size),
                       trace_fn=fn)
    o, d, a, tmax = rec[0]
    # production pre-sort (morton of origin | octant)
    octant = ((d.x < 0).to(torch.int32) * 4
              + (d.y < 0).to(torch.int32) * 2
              + (d.z < 0).to(torch.int32))
    wmin = arrays.node_min[0]
    ext = torch.clamp(arrays.node_max[0] - wmin, min=1e-6)
    morton = _morton21((o.x - wmin[0]) / ext[0], (o.y - wmin[1]) / ext[1],
                       (o.z - wmin[2]) / ext[2])
    ikey = torch.where(a, (morton << 3) | octant,
                       torch.full_like(morton, 1 << 30))
    perm = torch.sort(ikey, stable=True).indices
    so = V3(*(x[perm].contiguous() for x in o))
    sd = V3(*(x[perm].contiguous() for x in d))
    return drain((so, sd, tmax[perm].contiguous(), a[perm].contiguous()))
