"""The port's integrator (fspt_tpu_torch.core.integrator) against the JAX
package's, on the same scene, rays and RNG keys.

Tolerance: `_assert_close` of tests/test_oracle.py — sample-exact up to
float32 rounding, where a tiny fraction of lanes may fall on the other
side of a branch (lobe select, hit epsilon) and diverge: 99.5% of values
within 2e-3 relative, image means within 5e-3.

The JAX side runs intersector="walk" (Pallas traverse3 in interpret mode):
"split" (traverse4) costs about a minute of interpret-mode tracing per
launch width, and walk finds the same hits (tests/test_fastbvh.py
test_split_kernel_hit_parity).  The port runs "split", the slice's path.

The batched case runs under the no-RR schedule (1, 4) of
tests/test_compact.py at 64x64 on the subdivision-1 textured scene: RR
would make the survivors depend on the sort's tie order, which is exact
on neither side.

The port's own contract for the scene's tables (no JAX call): a trace
given them built ahead (scene_tables, as the graphed step passes them)
equals one that builds them itself, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fspt_tpu.config import RenderConfig as JCfg
from fspt_tpu.core import integrator as jint
from fspt_tpu.core.camera import generate_rays as jrays
from fspt_tpu.core.rng import sample_key as jsample_key
from fspt_tpu.core.rng import stream_uniforms as jstream
from fspt_tpu.core.vec import V3 as JV3
from fspt_tpu.testing import make_test_scene
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import integrator as tint
from fspt_tpu_torch.core import rng as trng
from fspt_tpu_torch.core import vec
from fspt_tpu_torch.core.camera import generate_rays as trays
from fspt_tpu_torch.runtime.renderer import _leaves
from fspt_tpu_torch.scene.schema import scene_to_torch
from fspt_tpu_torch.testing import make_test_scene as make_torch_scene

torch.set_num_threads(1)

SIZE = 64
N = SIZE * SIZE
K = 4
BASE = dict(width=SIZE, height=SIZE, bounces=3)
PROD = dict(compact=True, compact_schedule=(1, 4), sort_state=True,
            nee_env_nearest=True, escape_env_nearest=True,
            wavefront_batch=True, batch_spp=K, wavefront_merge_width=1024)


def _assert_close(ours, ref, frac=0.995, tol=2e-3):
    d = np.abs(ours - ref) / (1.0 + np.abs(ref))
    good = np.mean(d < tol)
    assert good >= frac, f"only {good:.4f} of values within {tol}"
    assert abs(ours.mean() - ref.mean()) < 5e-3


@pytest.fixture(scope="module")
def scene():
    s = make_test_scene(subdivisions=1, textured=True)
    return s, scene_to_torch(s.arrays, "cpu")


def _img(r):
    return np.stack([np.asarray(r.x), np.asarray(r.y), np.asarray(r.z)])


def _rays(scene, jkey, tkey):
    cam = scene.camera
    ju = jstream(jkey, 0, (4, N))
    jo, jd = jrays(jnp.asarray(cam.position), jnp.asarray(cam.direction),
                   cam.fov_scale, cam.focal_depth, cam.aperture,
                   (SIZE, SIZE), ju)
    tu = trng.stream_uniforms(tkey, 0, (4, N))
    to, td = trays(torch.tensor(cam.position), torch.tensor(cam.direction),
                   cam.fov_scale, cam.focal_depth, cam.aperture,
                   (SIZE, SIZE), tu)
    return (jo, jd), (to, td)


def test_trace_paths_matches_jax(scene):
    s, arrays = scene
    jkey = jsample_key(jax.random.key(0), 1)
    tkey = trng.sample_key(trng.key(0), 1)
    (jo, jd), (to, td) = _rays(s, jkey, tkey)
    ref, jst = jint.trace_paths(s.device_arrays(),
                                JCfg(**BASE, intersector="walk"), s.meta,
                                jo, jd, jkey, return_stats=True)
    ours, tst = tint.trace_paths(arrays,
                                 RenderConfig(**BASE, intersector="split"),
                                 s.meta, to, td, tkey, return_stats=True)
    _assert_close(_img(ours), _img(ref))
    np.testing.assert_allclose(tst.active.numpy(), np.asarray(jst.active),
                               rtol=5e-3)
    assert float(tst.rr_lanes) == 0.0


def test_trace_paths_batched_matches_jax(scene):
    s, arrays = scene
    jbase = jsample_key(jax.random.key(0), 7)
    tbase = trng.sample_key(trng.key(0), 7)
    jo, jd, to, td = [], [], [], []
    for k in range(K):
        (a, b), (c, d) = _rays(s, jax.random.fold_in(jbase, k),
                               trng.fold_in(tbase, k))
        jo.append(a), jd.append(b), to.append(c), td.append(d)
    jcat = lambda vs: JV3(*(jnp.concatenate([getattr(v, f) for v in vs])
                            for f in "xyz"))
    ref, jst = jint.trace_paths_batched(
        s.device_arrays(), JCfg(**BASE, **PROD, intersector="walk"), s.meta,
        jcat(jo), jcat(jd), jbase, n_per=N, return_stats=True)
    cfg = RenderConfig(**BASE, **PROD, intersector="split")
    ours, tst = tint.trace_paths_batched(
        arrays, cfg, s.meta, vec.cat(to), vec.cat(td), tbase, n_per=N,
        return_stats=True)
    assert float(jst.rr_lanes) == 0.0 and float(tst.rr_lanes) == 0.0
    _assert_close(_img(ours), _img(ref))
    np.testing.assert_allclose(tst.active.numpy(), np.asarray(jst.active),
                               rtol=5e-3)
    # the port's own wavefront contract: the batch reproduces K sequential
    # per-sample traces (no RR fired)
    seq = sum(_img(tint.trace_paths(
        arrays, dataclasses.replace(cfg, wavefront_batch=False, batch_spp=1),
        s.meta, to[k], td[k], trng.fold_in(tbase, k))) for k in range(K))
    np.testing.assert_allclose(_img(ours), seq, atol=2e-5)


def test_traversal_launch_count(scene, monkeypatch):
    """traversal_launches (which chip_smoke.py asserts the kernel's launch
    count against) equals the traversal calls trace_paths_batched makes."""
    s, arrays = scene
    calls = []
    real = tint.packet_traverse4

    def counting(*a, **kw):
        calls.append(a[2].x.shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(tint, "packet_traverse4", counting)
    cfg = RenderConfig(width=32, height=32, bounces=3, intersector="split",
                       **dict(PROD, compact_schedule=(1.3, 4, 16)))
    n = 32 * 32
    u = trng.stream_uniforms(trng.key(3), 0, (4, n))
    o, d = trays(torch.tensor(s.camera.position),
                 torch.tensor(s.camera.direction), 0.5, 1e6, 0.0, (32, 32), u)
    tint.trace_paths_batched(arrays, cfg, s.meta, vec.cat([o] * K),
                             vec.cat([d] * K), trng.key(3), n_per=n)
    assert len(calls) == tint.traversal_launches(cfg, n, K)


@pytest.mark.parametrize("kw", [dict(intersector="bvh8"),
                                dict(mode="nee"),
                                dict(bounces=60, extra_refraction_iters=4),
                                dict(intersector="packet", bvh_width=16)])
def test_off_slice_configs_raise(scene, kw):
    """Configurations the port refuses: an intersector or mode fspt_tpu
    does not define, an iteration count that collides with the compaction
    RNG streams, and the 8-wide v1 packet kernel on a 16-wide scene (the
    JAX version's message).  Every configuration fspt_tpu defines is
    ported (tests/test_torch_paths.py)."""
    s, arrays = scene
    kw = dict(kw)
    meta = dataclasses.replace(s.meta, bvh_width=kw.pop("bvh_width", 8))
    u = trng.stream_uniforms(trng.key(0), 0, (4, 64))
    o, d = trays(torch.tensor(s.camera.position),
                 torch.tensor(s.camera.direction), 0.5, 1e6, 0.0, (8, 8), u)
    with pytest.raises(ValueError, match="intersector|mode|max_iters|wide"):
        tint.trace_paths(arrays, RenderConfig(width=8, height=8, **kw),
                         meta, o, d, trng.key(0))


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("nee", [False, True])
def test_prebuilt_tables_bit_equal(nee, packed):
    """trace_paths and trace_paths_batched given the scene's tables built
    ahead equal the same traces building them inside, bit for bit, in
    radiance and every count, with light NEE on and off and with the
    packed and the per-map atlas path; given them, they build nothing."""
    s = make_torch_scene(subdivisions=1, textured=True, emissive_sphere=True)
    arrays = s.to_torch("cpu")
    cfg = RenderConfig(width=32, height=32, bounces=3, intersector="split",
                       use_light_nee=nee, packed_textures=packed,
                       **dict(PROD, batch_spp=2))
    n = 32 * 32
    key = trng.sample_key(trng.key(5), 3)
    rays = [trays(torch.tensor(s.camera.position),
                  torch.tensor(s.camera.direction), 0.5, 1e6, 0.0, (32, 32),
                  trng.stream_uniforms(trng.fold_in(key, k), 0, (4, n)))
            for k in range(2)]
    origin = vec.cat([o for o, _ in rays])
    direction = vec.cat([d for _, d in rays])

    def traces(**kw):
        return (tint.trace_paths(arrays, cfg, s.meta, *rays[0],
                                 trng.fold_in(key, 0), return_stats=True,
                                 **kw),
                tint.trace_paths_batched(arrays, cfg, s.meta, origin,
                                         direction, key, n_per=n,
                                         return_stats=True, **kw))

    tables = tint.scene_tables(arrays, cfg, s.meta)
    assert (tables.tex.mat_tex is None) != packed
    builds = tint.scene_tables.launches
    got = traces(tables=tables)
    assert tint.scene_tables.launches == builds
    want = traces()
    assert tint.scene_tables.launches == builds + 2
    for g, w in zip(_leaves(got), _leaves(want)):
        assert (g is None) == (w is None)
        assert g is None or torch.equal(g, w)
    light = got[1][1].light
    assert (light is not None and float(light.sum()) > 0) == nee
