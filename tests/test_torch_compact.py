"""Active-lane compaction, cross-sample batching, state sort and the
texture-table options of the port's integrator, each held to the port
itself (tests/test_compact.py on fspt_tpu_torch; the JAX-against-port
comparison of the batch is tests/test_torch_integrator.py).

Contracts, as in the original:
1. a non-shrinking schedule is exact against the uncompacted estimator;
2. a shrinking schedule above the live-lane count is sample-exact, and the
   state really is re-bucketed;
3. a schedule tight enough to force Russian roulette is unbiased (the
   multi-sample mean matches the uncompacted one) and finite;
4. batched samples, state sort, nearest-texel env lookups and packed
   material tables agree with their plain counterparts (exactly, or in
   the mean where the estimator differs).

Sizes are the original's (64x64 on the subdivision-1 textured scene, where
~2,383 lanes survive the primary hit and ~803 bounce 0).  The port runs
intersector="split", traverse4's plain version on the CPU (the original
ran the default "walk" in Pallas interpret mode); TraceStats.rr_lanes shows
each test's regime really held.  Tolerances are the original's, but for
a few measured values of test_packed_textures_parity (see there).
"""

import dataclasses

import numpy as np
import torch

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import rng, vec
from fspt_tpu_torch.core.camera import generate_rays
from fspt_tpu_torch.core.integrator import (_compact_groups, _merged_groups,
                                            trace_paths, trace_paths_batched)
from fspt_tpu_torch.runtime.renderer import Renderer
from fspt_tpu_torch.testing import make_test_scene

torch.set_num_threads(1)

SIZE = 64
N = SIZE * SIZE


def _scene(**kw):
    scene = make_test_scene(subdivisions=1, textured=True, **kw)
    return scene, scene.to_torch("cpu"), scene.meta


def _cfg(**kw):
    return RenderConfig(**{**dict(width=SIZE, height=SIZE, bounces=3,
                                  intersector="split"), **kw})


def _rays_for(scene, key):
    cam = scene.camera
    cam_u = rng.stream_uniforms(key, 0, (4, N))
    return generate_rays(torch.tensor(cam.position),
                         torch.tensor(cam.direction), cam.fov_scale,
                         cam.focal_depth, cam.aperture, (SIZE, SIZE), cam_u)


def _rays(scene, s_idx):
    key = rng.sample_key(rng.key(0), s_idx)
    return (*_rays_for(scene, key), key)


def _img(r):
    return np.stack([r.x.numpy(), r.y.numpy(), r.z.numpy()])


@torch.no_grad()
def test_compact_noshrink_exact():
    scene, arrays, meta = _scene()
    o, d, key = _rays(scene, 0)
    cfg0 = _cfg(compact=False)
    cfg1 = dataclasses.replace(cfg0, compact=True,
                               compact_schedule=(1, 1, 1))
    assert _compact_groups(cfg1, N) == [[N, cfg1.max_iters]]  # pure no-op
    a0 = _img(trace_paths(arrays, cfg0, meta, o, d, key))
    a1 = _img(trace_paths(arrays, cfg1, meta, o, d, key))
    np.testing.assert_allclose(a0, a1, atol=1e-6)


@torch.no_grad()
def test_compact_underbudget_exact():
    scene, arrays, meta = _scene()
    o, d, key = _rays(scene, 1)
    cfg0 = _cfg(compact=False)
    # a real 4x shrink after bounce 0 (4096 -> 1024 lanes) that the ~803
    # live lanes fit: RR never fires, so the estimator agrees lane for lane
    cfg1 = dataclasses.replace(cfg0, compact=True, compact_schedule=(1, 4))
    groups = _compact_groups(cfg1, N)
    assert groups == [[N, 1], [1024, cfg1.max_iters - 1]], groups
    a0 = _img(trace_paths(arrays, cfg0, meta, o, d, key))
    r1, st = trace_paths(arrays, cfg1, meta, o, d, key, return_stats=True)
    a1 = _img(r1)
    assert float(st.rr_lanes) == 0.0          # the no-RR regime really held
    assert np.isfinite(a1).all()
    np.testing.assert_allclose(a0, a1, atol=1e-5)


@torch.no_grad()
def test_compact_rr_unbiased():
    scene, arrays, meta = _scene()
    cfg0 = _cfg(compact=False)
    # 1024 lanes from the pre-bounce-0 compaction on, against ~2,383
    # primary hits: RR on every sample
    cfg1 = dataclasses.replace(cfg0, compact=True, compact_schedule=(4,))
    assert _compact_groups(cfg1, N) == [[1024, cfg1.max_iters]]
    m0 = np.zeros(3)
    m1 = np.zeros(3)
    rr_total = 0.0
    S = 24
    for s in range(S):
        o, d, key = _rays(scene, s)
        a0 = _img(trace_paths(arrays, cfg0, meta, o, d, key))
        r1, st = trace_paths(arrays, cfg1, meta, o, d, key,
                             return_stats=True)
        a1 = _img(r1)
        rr_total += float(st.rr_lanes)
        assert np.isfinite(a1).all()
        m0 += a0.mean(axis=1)
        m1 += a1.mean(axis=1)
    assert rr_total > 0, "schedule never forced RR — test is vacuous"
    np.testing.assert_allclose(m1 / S, m0 / S, rtol=0.05)


@torch.no_grad()
def test_wavefront_batch_renderer_rr_finite():
    """Renderer with the batched path under an RR-forcing schedule:
    finite radiance, per-sample accounting, and a mean consistent with
    the unbatched renderer's."""
    cfg_a = RenderConfig(width=32, height=32, bounces=3, batch_spp=4,
                         compact=True, compact_schedule=(4,),
                         wavefront_batch=True, intersector="split")
    cfg_b = dataclasses.replace(cfg_a, wavefront_batch=False)
    scene = make_test_scene(subdivisions=1, textured=True)
    ra = Renderer(scene, cfg_a, device="cpu").step(4)
    rb = Renderer(scene, cfg_b, device="cpu").step(4)
    assert float(ra.count) == 16.0
    ia, ib = ra.hdr_image(), rb.hdr_image()
    assert np.isfinite(ia).all()
    np.testing.assert_allclose(ia.mean(), ib.mean(), rtol=0.1)


@torch.no_grad()
def test_wavefront_batch_nonpow2_boundary():
    """batch_spp that does not divide the first merged width: the
    per-sample shrink before the merge is followed by a second compaction
    at the same iteration in the merged phase; the shrink draws from
    stream base _RR_STREAM + max_iters so the two selections stay
    independent.  Pins the regime, then checks the estimator stays finite
    and consistent with K unbatched samples."""
    scene, arrays, meta = _scene()
    K = 6
    cfg = _cfg(compact=True, compact_schedule=(1, 24), wavefront_batch=True,
               batch_spp=K, wavefront_merge_width=1024)
    _, _, groups_b = _merged_groups(cfg, N, K * N)
    w_b = -(-groups_b[0][0] // K)
    assert K * w_b > groups_b[0][0], (
        "config no longer triggers the double-compact boundary; "
        f"K={K} w_b={w_b} first merged width={groups_b[0][0]}")
    base = rng.sample_key(rng.key(0), 11)
    per = []
    seq = np.zeros((3, N))
    single = dataclasses.replace(cfg, wavefront_batch=False, batch_spp=1)
    for k in range(K):
        kk = rng.fold_in(base, k)
        o, d = _rays_for(scene, kk)
        per.append((o, d))
        seq += _img(trace_paths(arrays, single, meta, o, d, kk))
    r, st = trace_paths_batched(arrays, cfg, meta,
                                vec.cat([o for o, _ in per]),
                                vec.cat([d for _, d in per]), base, n_per=N,
                                return_stats=True)
    img = _img(r)
    assert float(st.rr_lanes) > 0, "boundary never forced RR — vacuous"
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(), seq.mean(), rtol=0.08)


@torch.no_grad()
def test_sort_state_exact():
    """Permuting the path state into Morton order each iteration
    reproduces the launch-sorted estimator exactly (RNG keyed by gid,
    deposits by lidx), with and without compaction.  Without the state sort
    the "split" launches are sorted and un-permuted."""
    scene, arrays, meta = _scene()
    o, d, key = _rays(scene, 3)
    cfg0 = _cfg()
    for extra in ({}, {"compact": True, "compact_schedule": (1, 4)}):
        c_a = dataclasses.replace(cfg0, sort_state=False, **extra)
        c_b = dataclasses.replace(cfg0, sort_state=True, **extra)
        a_a = _img(trace_paths(arrays, c_a, meta, o, d, key))
        a_b = _img(trace_paths(arrays, c_b, meta, o, d, key))
        np.testing.assert_allclose(a_a, a_b, atol=2e-5)


@torch.no_grad()
def test_nearest_env_statistical_parity():
    """nee_env_nearest + escape_env_nearest swap bilinear env filtering for
    the nearest texel on NEE and escape lookups: a different but equally
    consistent estimator, so the multi-sample means agree within the
    filtering difference of the smooth sky."""
    scene, arrays, meta = _scene(env="sky")
    cfg_a = _cfg()
    cfg_b = dataclasses.replace(cfg_a, nee_env_nearest=True,
                                escape_env_nearest=True)
    m_a = np.zeros(3)
    m_b = np.zeros(3)
    for s in range(4):
        o, d, key = _rays(scene, s)
        a = _img(trace_paths(arrays, cfg_a, meta, o, d, key))
        b = _img(trace_paths(arrays, cfg_b, meta, o, d, key))
        assert np.isfinite(b).all()
        m_a += a.mean(axis=1)
        m_b += b.mean(axis=1)
    np.testing.assert_allclose(m_b, m_a, rtol=0.02)


@torch.no_grad()
def test_packed_textures_parity(monkeypatch):
    """The packed material table (2 row gathers) and the per-map fetches
    are the same bilinear math in another float association (the packed
    rows fold the x-lerp before the y-lerp).

    The original holds the two IMAGES to atol 1e-4 on every value, and so
    does this test, but for at most 16 of the 12,288 values: on the port 11
    of them (4 pixels) miss it (JAX under "brute" misses it too, on 3):
    1-ulp differences of a texel move a path whose scatter ray re-hits its
    surface at t ~ 4e-6 (2.5e-3 on a lane of 0.039), or a lane of radiance
    146 by 2.6e-4 (ROADMAP queue C).  Each of those is held within 3e-3
    of 1 + |value| (the worst reads 2.4e-3), the channel means within
    1e-5 (they read 4.8e-7), and the reference's atol 1e-4 holds the two
    fetches of every shading point of the render.
    """
    import fspt_tpu_torch.core.integrator as integ
    scene, arrays, meta = _scene()
    o, d, key = _rays(scene, 2)
    cfg_a = _cfg(packed_textures=True)
    cfg_b = dataclasses.replace(cfg_a, packed_textures=False)
    points = []
    real = integ.atlas_fetch_all

    def record(*args):
        points.append(args)
        return real(*args)

    monkeypatch.setattr(integ, "atlas_fetch_all", record)
    a_a = _img(trace_paths(arrays, cfg_a, meta, o, d, key))
    a_b = _img(trace_paths(arrays, cfg_b, meta, o, d, key))
    assert len(points) == cfg_a.max_iters
    rows = integ._packed_tables(arrays, cfg_b, meta).atlas_rows
    for mat_tex, _, map_c, u, v in points:
        layers = arrays.mat_layers[map_c.long()]
        for k, packed in enumerate(real(mat_tex, meta, map_c, u, v)):
            per_map = integ.atlas_fetch_rgb(meta, layers[:, k], u, v, rows)
            for p, q in zip(packed, per_map):
                np.testing.assert_allclose(p.numpy(), q.numpy(), atol=1e-4)
    diff = np.abs(a_a - a_b)
    miss = diff > 1e-4
    assert miss.sum() <= 16, f"{miss.sum()} values over atol 1e-4"
    np.testing.assert_array_less(diff[miss] / (1.0 + np.abs(a_b[miss])), 3e-3)
    np.testing.assert_allclose(a_a.mean(axis=1), a_b.mean(axis=1), rtol=0,
                               atol=1e-5)
