"""The port's elementwise device modules (camera, env, brdf, tonemap)
against the JAX package's, on the same numpy inputs made from a seed.

Tolerance rtol 1e-5 / atol 1e-6: both sides evaluate each expression in
float32 with the same operand order, so what remains is the ulps of
transcendental functions (sin, cos, atan2, asin, sqrt, pow) and what they
propagate.  Nearest-texel lookups round a float to an index, so a value an
ulp from a texel boundary may pick the neighbour: indices must agree on
>= 99.9% of lanes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fspt_tpu.core import brdf as jbrdf
from fspt_tpu.core import camera as jcam
from fspt_tpu.core import env as jenv
from fspt_tpu.core import tonemap as jtone
from fspt_tpu.core.vec import V3 as JV3
from fspt_tpu.testing import make_test_scene
from fspt_tpu_torch.core import brdf as tbrdf
from fspt_tpu_torch.core import camera as tcam
from fspt_tpu_torch.core import env as tenv
from fspt_tpu_torch.core import tonemap as ttone
from fspt_tpu_torch.core.vec import V3 as TV3
from fspt_tpu_torch.runtime.layout import tile_order

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N = 4096


def _close(ours, ref):
    if isinstance(ref, tuple):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _close(a, b)
        return
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _j(a):
    return JV3(*(jnp.asarray(x) for x in a)) if a.ndim == 2 else jnp.asarray(a)


def _t(a):
    return (TV3(*(torch.from_numpy(x.copy()) for x in a)) if a.ndim == 2
            else torch.from_numpy(a.copy()))


def _unit(rng, n=N):
    d = rng.normal(size=(3, n)).astype(np.float32)
    return (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)


@pytest.fixture
def r():
    return np.random.default_rng(1234)


@pytest.mark.parametrize("lens", ["pinhole", "thin_lens"])
def test_generate_rays(r, lens):
    w, h = 48, 32
    u = r.uniform(size=(4, w * h)).astype(np.float32)
    pix = tile_order(w, h)
    pos = np.array([0.1, 0.4, 2.2], np.float32)
    dirn = np.array([0.0, -0.18, -0.98], np.float32)
    fd, ap = (1e6, 0.0) if lens == "pinhole" else (2.0, 0.08)
    jo, jd = jcam.generate_rays(jnp.asarray(pos), jnp.asarray(dirn),
                                jnp.float32(0.5), jnp.float32(fd),
                                jnp.float32(ap), (w, h), jnp.asarray(u),
                                pixel_idx=jnp.asarray(pix))
    to, td = tcam.generate_rays(torch.from_numpy(pos), torch.from_numpy(dirn),
                                0.5, fd, ap, (w, h), torch.from_numpy(u),
                                pixel_idx=torch.from_numpy(pix))
    _close(to, jo)
    _close(td, jd)


@pytest.fixture(scope="module")
def sky():
    s = make_test_scene(subdivisions=1, env="sky")
    a = s.arrays
    hw = (s.meta.env_h, s.meta.env_w)
    bins = np.stack([a.bin_x0, a.bin_y0, a.bin_x1, a.bin_y1], -1)
    return a, hw, bins


def test_env_uv_and_rows(r, sky):
    a, hw, _ = sky
    d = _unit(r)
    theta = np.float32(0.37)
    _close(tenv.env_uv(_t(d), torch.tensor(theta)),
           jenv.env_uv(_j(d), jnp.float32(theta)))
    j6 = jenv.pack_env_rows(JV3(*map(jnp.asarray, a.env_rgb)), hw)
    t6 = tenv.pack_env_rows(TV3(*map(torch.from_numpy, a.env_rgb)), hw)
    np.testing.assert_array_equal(t6.numpy(), np.asarray(j6))
    _close(tenv.env_radiance_rows(t6, hw, _t(d), torch.tensor(theta)),
           jenv.env_radiance_rows(j6, hw, _j(d), jnp.float32(theta)))


def test_env_nearest(r, sky):
    a, hw, _ = sky
    d = _unit(r)
    theta = np.float32(1.66)
    j6 = jenv.pack_env_rows(JV3(*map(jnp.asarray, a.env_rgb)), hw)
    t6 = tenv.pack_env_rows(TV3(*map(torch.from_numpy, a.env_rgb)), hw)
    jr = jenv.env_radiance_rows_nearest(j6, hw, _j(d), jnp.float32(theta))
    tr = tenv.env_radiance_rows_nearest(t6, hw, _t(d), torch.tensor(theta))
    same = np.ones(N, bool)
    for x, y in zip(tr, jr):
        same &= np.asarray(x) == np.asarray(y)
    assert same.mean() >= 0.999, same.mean()


def test_env_bilinear_wrap_x(r, sky):
    """REPEAT in u (coordinates outside [0, 1) included), CLAMP_TO_EDGE in
    v, GL LINEAR, from the flat planes."""
    a, hw, _ = sky
    u = r.uniform(-0.5, 1.5, N).astype(np.float32)
    v = r.uniform(-0.2, 1.2, N).astype(np.float32)
    _close(tenv.bilinear_wrap_x(TV3(*map(torch.from_numpy, a.env_rgb)), hw,
                                _t(u), _t(v)),
           jenv.bilinear_wrap_x(JV3(*map(jnp.asarray, a.env_rgb)), hw,
                                _j(u), _j(v)))


def test_env_radiance(r, sky):
    """The flat-plane lookup against the JAX one, and against the packed
    table's (the same bilinear math in another association)."""
    a, hw, _ = sky
    d = _unit(r)
    theta = np.float32(0.37)
    planes = TV3(*map(torch.from_numpy, a.env_rgb))
    ours = tenv.env_radiance(planes, hw, _t(d), torch.tensor(theta))
    _close(ours, jenv.env_radiance(JV3(*map(jnp.asarray, a.env_rgb)), hw,
                                   _j(d), jnp.float32(theta)))
    _close(ours, tenv.env_radiance_rows(tenv.pack_env_rows(planes, hw), hw,
                                        _t(d), torch.tensor(theta)))


def test_env_fallback_without_table(monkeypatch):
    """With no packed env table (tex.env6 None) shading filters the flat
    env planes, as the JAX version's fallback does: the image equals the
    one made with the table up to that association (env radiance enters
    no branch).  The nearest-texel options need the table, so they fall
    back to the bilinear lookup too."""
    import dataclasses

    from fspt_tpu_torch.config import RenderConfig
    from fspt_tpu_torch.core import integrator, rng
    from fspt_tpu_torch.testing import make_test_scene as tscene
    scene = tscene(subdivisions=1, textured=True)
    arrays = scene.to_torch("cpu")
    cfg = RenderConfig(width=16, height=16, bounces=3, intersector="brute",
                       nee_env_nearest=True, escape_env_nearest=True)
    key = rng.sample_key(rng.key(3), 0)
    o, d = tcam.generate_rays(
        torch.tensor(scene.camera.position),
        torch.tensor(scene.camera.direction), scene.camera.fov_scale,
        1e6, 0.0, (16, 16), rng.stream_uniforms(key, 0, (4, 256)))
    bilinear = dataclasses.replace(cfg, nee_env_nearest=False,
                                   escape_env_nearest=False)
    with torch.no_grad():
        ref = integrator.trace_paths(arrays, bilinear, scene.meta, o, d, key)
        shade = integrator._shade_and_scatter
        monkeypatch.setattr(
            integrator, "_shade_and_scatter",
            lambda *a, **kw: shade(*a[:-1], a[-1]._replace(env6=None),
                                   **kw))
        ours = integrator.trace_paths(arrays, cfg, scene.meta, o, d, key)
    _close(tuple(ours), tuple(ref))


@pytest.mark.parametrize("fused", [False, True])
def test_sample_env_bins(r, sky, fused):
    a, hw, bins = sky
    u1, u2, u3 = r.uniform(size=(3, N)).astype(np.float32)
    theta = np.float32(0.5)
    jb, tb = jnp.asarray(bins), torch.from_numpy(bins)
    jn, tn = jnp.int32(a.n_bins), torch.tensor(np.int32(a.n_bins))
    if fused:
        j6 = jenv.pack_env_rows(JV3(*map(jnp.asarray, a.env_rgb)), hw)
        t6 = tenv.pack_env_rows(TV3(*map(torch.from_numpy, a.env_rgb)), hw)
        jo = jenv.sample_env_bins_radiance(jb, j6, jn, hw, jnp.float32(theta),
                                           *map(jnp.asarray, (u1, u2, u3)))
        to = tenv.sample_env_bins_radiance(
            tb, t6, tn, hw, torch.tensor(theta),
            *map(torch.from_numpy, (u1, u2, u3)))
    else:
        jo = jenv.sample_env_bins(jb, jn, hw, jnp.float32(theta),
                                  *map(jnp.asarray, (u1, u2, u3)))
        to = tenv.sample_env_bins(tb, tn, hw, torch.tensor(theta),
                                  *map(torch.from_numpy, (u1, u2, u3)))
    _close(to, jo)


def _brdf_inputs(r):
    n = _unit(r)
    inc = _unit(r)
    inc = np.where((n * inc).sum(0) < 0, -inc, inc).astype(np.float32)
    return dict(
        n=n, inc=inc, d=_unit(r),
        diffuse=r.uniform(size=(3, N)).astype(np.float32),
        metallic=r.uniform(size=N).astype(np.float32),
        rough=r.uniform(0.05, 1.0, size=N).astype(np.float32),
        u1=r.uniform(size=N).astype(np.float32),
        u2=r.uniform(size=N).astype(np.float32),
        n1=np.where(r.uniform(size=N) < 0.5, 1.0, 1.5).astype(np.float32),
        pa=r.uniform(0.0, 3.0, size=N).astype(np.float32),
        pb=r.uniform(0.0, 3.0, size=N).astype(np.float32))


BRDF_CASES = {
    "onb": lambda m, x: m.onb(x["n"]),
    "gtr2": lambda m, x: m.gtr2(x["u1"], x["rough"]),
    # front-facing ndv: for ndv < 0 the denominator cancels and amplifies
    # a 1-ulp difference without bound
    "smith_g": lambda m, x: m.smith_g(x["u1"], x["rough"]),
    "gtr2_pdf": lambda m, x: m.gtr2_pdf(x["inc"], x["n"], x["rough"], x["d"]),
    "lambert_pdf": lambda m, x: m.lambert_pdf(x["n"], x["d"]),
    "schlick": lambda m, x: m.schlick(x["inc"], x["n"], x["n1"],
                                      2.5 - x["n1"]),
    "sample_microfacet": lambda m, x: m.sample_microfacet(
        x["n"], x["rough"], x["u1"], x["u2"]),
    "sample_lambert": lambda m, x: m.sample_lambert(x["n"], x["u1"], x["u2"]),
    "eval_specular": lambda m, x: m.eval_specular(
        x["inc"], x["n"], x["diffuse"], x["metallic"], x["rough"], x["d"]),
    "eval_lambert": lambda m, x: m.eval_lambert(x["diffuse"]),
    "mis_weights": lambda m, x: m.mis_weights(x["pa"], x["pb"]),
    "reflect": lambda m, x: m.reflect(-x["inc"], x["n"]),
    "refract": lambda m, x: m.refract(-x["inc"], x["n"], x["n1"] / 1.3),
}


@pytest.mark.parametrize("name", sorted(BRDF_CASES))
def test_brdf(r, name):
    x = _brdf_inputs(r)
    ref = BRDF_CASES[name](jbrdf, {k: _j(v) for k, v in x.items()})
    ours = BRDF_CASES[name](tbrdf, {k: _t(v) for k, v in x.items()})
    _close(ours, ref)


@pytest.mark.parametrize("denoise", [False, True])
def test_postprocess(r, denoise):
    img = (r.gamma(0.6, 1.0, size=(3, 24, 32))
           * (r.uniform(size=(1, 24, 32)) < 0.97) * 3.0).astype(np.float32)
    kw = dict(exposure=1.4, saturation=1.2, denoise=denoise, max_sigma=2.0,
              gamma=2.2)
    _close(ttone.postprocess(torch.from_numpy(img), **kw),
           jtone.postprocess(jnp.asarray(img), **kw))
