"""The port held to the pure-NumPy transcription of the reference
megakernel (tests/test_oracle.py on fspt_tpu_torch).

1. Sample-exact agreement of the port's integrator ("brute") with
   tests/reference_oracle.py on identical rays and uniform streams, with
   test_oracle.py's bounds: 99.5% of values within 2e-3 relative, image
   means within 5e-3.
2. White furnace: the rendered mean of a diffuse floor under a constant
   environment against a NumPy quadrature of the same estimator.
3. The env radiance-bin pdf of the port's sampler integrates to 1 over the
   sphere; E[1/pdf] of its draws is the sphere's area; the fused draw
   gives the sampled texel's radiance.
4. Chi-square fits of the port's GGX half-vector and cosine-hemisphere
   samplers to their analytic pdfs, and the GTR2 solid-angle pdf's
   Jacobian relation.

The oracle is NumPy and the port is torch: no JAX here.  Thresholds are
the reference's.  Uniforms for 3-4 are numpy draws from the seeds the
reference's jax.random draws used.
"""

import numpy as np
import pytest
import torch

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import brdf, rng
from fspt_tpu_torch.core.camera import generate_rays
from fspt_tpu_torch.core.env import (pack_env_rows, sample_env_bins,
                                     sample_env_bins_radiance)
from fspt_tpu_torch.core.integrator import trace_paths
from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.scene.schema import load_scene_dict
from fspt_tpu_torch.testing import DictAssetLoader, make_test_scene, quad_obj

from reference_oracle import mis_weights as np_mis
from reference_oracle import oracle_trace, sample_env

torch.set_num_threads(1)


def _np3(v):
    return np.stack([v.x.numpy(), v.y.numpy(), v.z.numpy()], -1)


def _camera_rays(cam, key, size):
    cam_u = rng.stream_uniforms(key, 0, (4, size * size))
    return generate_rays(torch.tensor(cam.position),
                         torch.tensor(cam.direction), cam.fov_scale,
                         cam.focal_depth, cam.aperture, (size, size), cam_u)


def _render_pair(scene, cfg, n_samples=2, size=24):
    """The port and the oracle on identical rays and uniforms."""
    arrays = scene.to_torch("cpu")
    meta = scene.meta
    n = size * size
    pairs = []
    for s_idx in range(n_samples):
        key = rng.sample_key(rng.key(0), s_idx)
        origin, direction = _camera_rays(scene.camera, key, size)
        ours = _np3(trace_paths(arrays, cfg, meta, origin, direction, key))
        u_iters = [rng.stream_uniforms(key, 1 + it, (11, n)).numpy()
                   for it in range(cfg.max_iters)]
        ref = oracle_trace(scene.arrays, meta, cfg, _np3(origin),
                           _np3(direction), u_iters)
        pairs.append((ours, ref))
    return pairs


def _assert_close(ours, ref, frac=0.995, tol=2e-3):
    """Sample-exact up to float32 rounding; a tiny fraction of lanes may
    fall on the other side of a branch (lobe select, hit epsilon)."""
    d = np.abs(ours - ref) / (1.0 + np.abs(ref))
    good = np.mean(d < tol)
    assert good >= frac, f"only {good:.4f} of values within {tol}"
    assert abs(ours.mean() - ref.mean()) < 5e-3


@pytest.mark.parametrize("variant", ["diffuse", "metal", "dielectric"])
def test_integrator_matches_reference_oracle(variant):
    kw = dict(subdivisions=1, textured=True, roughness=0.4)
    cfg_kw = dict(width=24, height=24, bounces=3, extra_refraction_iters=0,
                  batch_spp=1, intersector="brute")
    if variant == "metal":
        kw["metallic"] = 0.8
        kw["roughness"] = 0.2
    if variant == "dielectric":
        kw["dielectric"] = 0.2
        kw["ior"] = 1.5
        cfg_kw["extra_refraction_iters"] = 2
    scene = make_test_scene(**kw)
    cfg = RenderConfig(**cfg_kw)
    with torch.no_grad():
        for ours, ref in _render_pair(scene, cfg):
            _assert_close(ours, ref)


def _furnace_scene(albedo=0.6):
    """A big diffuse floor under a constant environment; ior=1.0 keeps the
    Schlick lobe-select probability ~1e-5."""
    loader = DictAssetLoader(texts={"floor.obj": quad_obj()})
    scene = {
        "environment": [[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]],
        "cameraPos": [0.0, 1.2, 0.0],
        "cameraDir": [0.0, -1.0, 0.001],
        "fovScale": 0.3,
        "atlasRes": 8,
        "props": [{
            "path": "floor.obj", "scale": 40.0,
            "translate": [0.0, 0.0, 0.0],
            "diffuse": [albedo, albedo, albedo],
            "metallicRoughness": [0.0, 0.5, 0.0],
            "ior": 1.0,
            "normals": "flat",
        }],
    }
    return load_scene_dict(scene, loader, leaf_size=8, name="furnace")


def test_furnace_semi_analytic():
    """Constant env L=1, one diffuse bounce off a floor: the rendered mean
    matches an independent NumPy quadrature of the reference estimator
    (its MIS weights each use the other strategy's pdf, tracer.fs:499, so
    the expected value is not albedo * L; see tests/test_oracle.py)."""
    albedo = 0.6
    scene = _furnace_scene(albedo)
    arrays = scene.to_torch("cpu")
    cfg = RenderConfig(width=16, height=16, bounces=1,
                       extra_refraction_iters=0, intersector="brute")
    n_samples = 256
    total = np.zeros(3)
    with torch.no_grad():
        for s_idx in range(n_samples):
            key = rng.sample_key(rng.key(1), s_idx)
            origin, direction = _camera_rays(scene.camera, key, 16)
            out = trace_paths(arrays, cfg, scene.meta, origin, direction, key)
            total += [float(out.x.mean()), float(out.y.mean()),
                      float(out.z.mean())]
    mean = total / n_samples

    # --- quadrature of the same estimator (floor normal = +y, L = 1) ----
    a = scene.arrays
    hw = (scene.meta.env_h, scene.meta.env_w)
    r = np.random.default_rng(9)
    m = 2_000_000
    e_dir, p_e = sample_env(
        (a.bin_x0, a.bin_y0, a.bin_x1, a.bin_y1), a.n_bins, hw,
        float(a.env_theta), r.random(m).astype(np.float32),
        r.random(m).astype(np.float32), r.random(m).astype(np.float32))
    cos_e = e_dir[:, 1]
    cos_b = np.sqrt(r.random(m))            # cosine-hemisphere about +y
    p_b = cos_b / np.pi
    w_env, w_bsdf = np_mis(p_e, p_b.astype(np.float32))
    nee = np.where(cos_e > 0,
                   w_env * (albedo / np.pi) * np.clip(cos_e, 0, 1) / p_e, 0.0)
    esc = w_bsdf * albedo                   # acc after diffuse bounce = rho
    expected = nee.mean() + esc.mean()
    assert np.all(np.abs(mean - expected) < 0.025), (mean, expected)


def _sky():
    scene = make_test_scene(subdivisions=1, env="sky")
    a = scene.to_torch("cpu")
    bins4 = torch.stack([a.bin_x0, a.bin_y0, a.bin_x1, a.bin_y1], dim=-1)
    return scene, a, bins4, (scene.meta.env_h, scene.meta.env_w)


def _uniforms(seed, rows, m):
    u = np.random.default_rng(seed).random((rows, m), dtype=np.float32)
    return torch.from_numpy(u)


def test_env_bin_pdf_integrates_to_one():
    """Quadrature over every env texel: the port's sampler pdf at each
    pixel centre (drawn through its owning bin) times the pixel's solid
    angle sums to 1 (tracer.fs:431-432 against the bin partition)."""
    scene, a, bins4, (h, w) = _sky()
    nb = int(a.n_bins)
    x0, y0, x1, y1 = (np.asarray(p[:nb]) for p in
                      (a.bin_x0, a.bin_y0, a.bin_x1, a.bin_y1))
    # bins must partition the image exactly
    assert np.isclose(((x1 - x0) * (y1 - y0)).sum(), w * h)
    px = np.arange(w) + 0.5
    py = np.arange(h) + 0.5
    PX, PY = np.meshgrid(px, py)
    owner = np.full((h, w), -1)
    for i in range(nb):
        inside = ((PX >= x0[i]) & (PX < x1[i]) & (PY >= y0[i]) & (PY < y1[i]))
        owner[inside] = i
    assert np.all(owner >= 0)
    o = owner.reshape(-1)
    u1 = (o + 0.5) / nb
    u2 = (PX.reshape(-1) - x0[o]) / (x1[o] - x0[o])
    u3 = (PY.reshape(-1) - y0[o]) / (y1[o] - y0[o])
    f = lambda x: torch.from_numpy(x.astype(np.float32))
    _, pdf = sample_env_bins(bins4, a.n_bins, (h, w), a.env_theta, f(u1),
                             f(u2), f(u3))
    sin_phi = np.sin((PY.reshape(-1) / h) * np.pi)     # phi = v * pi
    d_omega = (2 * np.pi / w) * (np.pi / h) * sin_phi
    assert np.isclose((pdf.numpy().astype(np.float64) * d_omega).sum(), 1.0,
                      atol=1e-3)


def test_env_bin_sample_pdf_consistency():
    """MC: E[1/pdf(X)] over the port's bin-sampled directions == 4*pi."""
    scene, a, bins4, hw = _sky()
    u = _uniforms(3, 3, 200_000)
    _, pdf = sample_env_bins(bins4, a.n_bins, hw, a.env_theta, u[0], u[1],
                             u[2])
    est = float(torch.mean(1.0 / pdf.double()))
    assert abs(est - 4 * np.pi) / (4 * np.pi) < 0.02, est


def test_env_bin_sample_radiance_fused():
    """sample_env_bins_radiance draws bit-identical directions and pdfs to
    sample_env_bins and returns exactly the radiance of the texel that
    contains the sampled image point."""
    scene, a, bins4, (h, w) = _sky()
    env6 = pack_env_rows(a.env_rgb, (h, w))
    u1, u2, u3 = _uniforms(5, 3, 4096)
    d0, p0 = sample_env_bins(bins4, a.n_bins, (h, w), a.env_theta, u1, u2,
                             u3)
    d1, p1, rad = sample_env_bins_radiance(bins4, env6, a.n_bins, (h, w),
                                           a.env_theta, u1, u2, u3)
    for c0, c1 in zip((d0.x, d0.y, d0.z, p0), (d1.x, d1.y, d1.z, p1)):
        assert torch.equal(c0, c1)
    nb = int(a.n_bins)
    idx = np.clip((nb * u1.numpy()).astype(np.int32), 0, nb - 1)
    b = bins4.numpy()[idx]
    px = (b[:, 2] - b[:, 0]) * u2.numpy() + b[:, 0]
    py = (b[:, 3] - b[:, 1]) * u3.numpy() + b[:, 1]
    flat = (np.clip(py.astype(np.int32), 0, h - 1) * w
            + np.mod(px.astype(np.int32), w))
    np.testing.assert_allclose(rad.x.numpy(), a.env_rgb.x.numpy()[flat],
                               rtol=1e-6)
    np.testing.assert_allclose(rad.z.numpy(), a.env_rgb.z.numpy()[flat],
                               rtol=1e-6)


def _chi2_stat(counts, probs):
    n = counts.sum()
    expected = probs * n
    mask = expected > 5
    return (np.sum((counts[mask] - expected[mask]) ** 2 / expected[mask]),
            mask.sum())


def _up(m):
    z = torch.zeros(m)
    return V3(z, z, torch.ones(m))


def test_ggx_sampling_chi2():
    """GGX half-vector cos-theta marginal: pdf(ct) = 2*pi * D(ct)*ct with
    D = gtr2 (tracer.fs:215-219,264); chi-square over 40 bins."""
    rough = 0.45
    m = 400_000
    u = _uniforms(5, 2, m)
    hv = brdf.sample_microfacet(_up(m), torch.full((m,), rough), u[0], u[1])
    ct = hv.z.numpy()
    a = max(0.001, rough)
    bins = np.linspace(0.0, 1.0, 41)
    counts, _ = np.histogram(ct, bins)

    def cdf(c):   # integral of 2pi*gtr2(t)*t dt from 0..c = a2 c2/(c2(a2-1)+1)
        a2 = a * a
        return (a2 * c * c) / (c * c * (a2 - 1.0) + 1.0)
    stat, dof = _chi2_stat(counts, np.diff(cdf(bins)))
    # dof ~ 39; 99.9th percentile of chi2(39) ~= 72.1
    assert stat < 75.0, stat


def test_cosine_hemisphere_chi2():
    """cosineSampleHemisphere (tracer.fs:205-213): pdf(ct) = 2*ct."""
    m = 400_000
    u = _uniforms(6, 2, m)
    d = brdf.sample_lambert(_up(m), u[0], u[1])
    bins = np.linspace(0.0, 1.0, 41)
    counts, _ = np.histogram(d.z.numpy(), bins)
    stat, dof = _chi2_stat(counts, np.diff(bins ** 2))     # cdf = ct^2
    assert stat < 75.0, stat


def test_gtr2_pdf_normalizes():
    """The solid-angle pdf gtr2Pdf (tracer.fs:227-233) of reflected
    directions is finite, positive and obeys the Jacobian relation
    pdf_out = pdf_h / (4 |out . h|)."""
    rough = 0.35
    m = 400_000
    u = _uniforms(7, 2, m)
    n = _up(m)
    inc = V3(torch.full((m,), 0.4), torch.zeros(m),
             torch.full((m,), float(np.sqrt(1 - 0.16))))
    hv = brdf.sample_microfacet(n, torch.full((m,), rough), u[0], u[1])
    out = brdf.reflect(-inc, hv)
    pdf = brdf.gtr2_pdf(inc, n, torch.full((m,), rough), out).numpy()
    a = max(0.001, rough)
    ct = brdf.dot(hv, n)
    pdf_h = (brdf.gtr2(torch.abs(ct), a) * torch.abs(ct)).numpy()
    odh = torch.abs(brdf.dot(out, hv)).numpy()
    rel = np.abs(pdf - pdf_h / (4 * odh)) / np.maximum(pdf, 1e-6)
    assert np.all(np.isfinite(pdf)) and np.all(pdf > 0)
    assert np.quantile(rel, 0.99) < 1e-3
