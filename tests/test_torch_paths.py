"""The port's default path end to end: intersector="walk" (the config
default), light NEE, split shadow, the BVH heatmap, autofocus, preview and
the CLI, against the JAX package.

Integrator: the port and fspt_tpu trace the same scene, rays and RNG keys,
lane by lane; tolerance is `_assert_close` of tests/test_oracle.py (99.5%
of values within 2e-3 relative, image means within 5e-3: float32 rounding
may put a few lanes on the other side of a branch).  The JAX side runs its
Pallas kernels in interpret mode; "brute" is plain jnp on both sides.

Renderer: the five 32x32 goldens of tests/test_goldens.py, rendered with
that file's default configuration (so intersector="walk", and the heatmap
in lane-count mode), within its 5% bound.  The rest are ports of
tests/test_render.py and tests/test_tools.py.
"""

import json
import os
from argparse import Namespace

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
from fspt_tpu.testing import make_test_scene as jax_scene
from fspt_tpu_torch.config import PostConfig, RenderConfig
from fspt_tpu_torch.core import integrator as tint
from fspt_tpu_torch.core import rng as trng
from fspt_tpu_torch.core.camera import generate_rays as trays
from fspt_tpu_torch.runtime.layout import tile_order
from fspt_tpu_torch.runtime.renderer import Renderer
from fspt_tpu_torch.scene.schema import scene_to_torch
from fspt_tpu_torch.testing import icosphere_obj, make_test_scene

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
SIZE = 32
N = SIZE * SIZE


def _assert_close(ours, ref, frac=0.995, tol=2e-3):
    d = np.abs(ours - ref) / (1.0 + np.abs(ref))
    good = np.mean(d < tol)
    assert good >= frac, f"only {good:.4f} of values within {tol}"
    assert abs(ours.mean() - ref.mean()) < 5e-3


def _img(r):
    return np.stack([np.asarray(r.x), np.asarray(r.y), np.asarray(r.z)])


# ---- the integrator against fspt_tpu -------------------------------------

INTEGRATOR = {
    # name -> (scene kwargs, config kwargs)
    "walk": (dict(subdivisions=1, textured=True), dict(intersector="walk")),
    "light_nee": (dict(subdivisions=1, env="gradient", emissive_sphere=True),
                  dict(intersector="brute", use_light_nee=True)),
    "split_shadow": (dict(subdivisions=1, textured=True),
                     dict(intersector="walk", split_shadow=True, bounces=2)),
}


@pytest.mark.parametrize("name", sorted(INTEGRATOR))
def test_trace_paths_matches_jax(name):
    scene_kw, cfg_kw = INTEGRATOR[name]
    s = jax_scene(**scene_kw)
    arrays = scene_to_torch(s.arrays, "cpu")
    base = dict(dict(width=SIZE, height=SIZE, bounces=3), **cfg_kw)
    jkey = jsample_key(jax.random.key(0), 1)
    tkey = trng.sample_key(trng.key(0), 1)
    cam = s.camera
    jo, jd = jrays(jnp.asarray(cam.position), jnp.asarray(cam.direction),
                   cam.fov_scale, cam.focal_depth, cam.aperture,
                   (SIZE, SIZE), jstream(jkey, 0, (4, N)))
    to, td = trays(torch.tensor(cam.position), torch.tensor(cam.direction),
                   cam.fov_scale, cam.focal_depth, cam.aperture,
                   (SIZE, SIZE), trng.stream_uniforms(tkey, 0, (4, N)))
    ref, jst = jint.trace_paths(s.device_arrays(), JCfg(**base), s.meta,
                                jo, jd, jkey, return_stats=True)
    ours, tst = tint.trace_paths(arrays, RenderConfig(**base), s.meta, to,
                                 td, tkey, return_stats=True)
    _assert_close(_img(ours), _img(ref))
    for f in ("active", "shadow"):
        np.testing.assert_allclose(getattr(tst, f).numpy(),
                                   np.asarray(getattr(jst, f)), rtol=5e-3,
                                   atol=1.0)
    if cfg_kw["intersector"] == "walk":
        # per-group visits (the walk's shared fetch count), as on the TPU
        np.testing.assert_allclose(tst.visits.numpy(),
                                   np.asarray(jst.visits), rtol=0.02)


def test_walk_launch_count(monkeypatch):
    """traversal_launches (which chip_smoke.py asserts the walk kernel's
    launch count against) equals the walk launches of a sample step, for
    the CLI's --no-compact configuration and for the heatmap."""
    s = make_test_scene(subdivisions=1)
    calls = []
    real = tint.packet_traverse3

    def counting(*a, **kw):
        calls.append(a[2].x.shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(tint, "packet_traverse3", counting)
    for kw in (dict(batch_spp=2), dict(batch_spp=2, split_shadow=True),
               dict(mode="bvh_heatmap")):
        cfg = RenderConfig(width=16, height=16, bounces=2,
                           extra_refraction_iters=0, **kw)
        calls.clear()
        Renderer(s, cfg, device="cpu").step()
        assert len(calls) == tint.traversal_launches(cfg, 256,
                                                     cfg.batch_spp), kw


# ---- the renderer against the stored goldens, default config -------------

def _cfg(**kw):
    base = dict(width=32, height=32, bounces=3, extra_refraction_iters=2,
                batch_spp=4, seed=7)
    base.update(kw)
    return RenderConfig(**base)


CASES = {
    # name -> (scene kwargs, config kwargs, post, samples)
    # (tests/test_goldens.py CASES)
    "heatmap": (dict(subdivisions=3), dict(mode="bvh_heatmap", batch_spp=1),
                None, 1),
    "bunny_class": (dict(subdivisions=3), dict(), None, 8),
    "textured": (dict(subdivisions=2, textured=True), dict(), None, 8),
    "dielectric": (dict(subdivisions=2, dielectric=0.4, ior=1.5),
                   dict(), None, 8),
    "dof_post": (dict(subdivisions=2),
                 dict(), PostConfig(exposure=1.4, saturation=1.2,
                                    denoise=True), 8),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_default_config(name):
    scene_kw, cfg_kw, post, samples = CASES[name]
    cfg = _cfg(**cfg_kw)
    assert cfg.intersector == "walk"
    r = Renderer(make_test_scene(**scene_kw), cfg, post=post, device="cpu")
    if name == "dof_post":
        r.camera = r.camera._replace(aperture=torch.tensor(0.08),
                                     focal_depth=torch.tensor(2.0))
    r.step(samples // r.cfg.batch_spp or 1)
    img = r.image() if name == "dof_post" else r.hdr_image()
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    assert golden.shape == img.shape
    err = np.abs(img - golden) / np.maximum(np.abs(golden), 1e-2)
    assert err.max() < 0.05, f"golden {name} deviates: max rel {err.max()}"


# ---- ports of tests/test_render.py ---------------------------------------

@pytest.fixture(scope="module")
def small_scene():
    return make_test_scene(subdivisions=2)


def _small_cfg(**kw):
    base = dict(width=32, height=24, bounces=2, extra_refraction_iters=1,
                batch_spp=1)
    base.update(kw)
    return RenderConfig(**base)


def test_heatmap_mode(small_scene):
    r = Renderer(small_scene, _small_cfg(mode="bvh_heatmap"), device="cpu")
    r.step()
    hdr = r.hdr_image()
    assert (hdr >= 0).all() and hdr.max() > 0
    np.testing.assert_array_equal(hdr[..., 0], hdr[..., 1])    # grayscale
    # per-PIXEL counts: they vary within a 128-lane walk (walk s covers
    # lanes [s*128, (s+1)*128) of the tile-ordered framebuffer)
    flat = hdr[..., 0].reshape(-1)
    lanes = flat[tile_order(r.cfg.width, r.cfg.height)]
    walks = lanes[: (len(lanes) // 128) * 128].reshape(-1, 128)
    assert (walks.std(axis=1) > 0).mean() > 0.5
    # every ray counts at least the root visit
    assert (flat * (1.0 / r.cfg.heatmap_scale)).min() >= 0.999
    s = r.stats
    assert s["lane_rays_upper_bound"] == s["samples"] * 32 * 24
    assert s["rays"] == 32 * 24


def test_brute_vs_packet_integrator_agree(small_scene):
    a = Renderer(small_scene, _small_cfg(seed=3, intersector="packet"),
                 device="cpu").step().hdr_image()
    b = Renderer(small_scene, _small_cfg(seed=3, intersector="brute"),
                 device="cpu").step().hdr_image()
    assert np.isclose(a, b, rtol=1e-3, atol=1e-4).mean() > 0.995


def test_autofocus_sets_focal_depth(small_scene):
    r = Renderer(small_scene, _small_cfg(), device="cpu")
    t = r.autofocus()
    # camera at (0,.4,2.2) looking at a sphere of radius .5 at the origin
    assert 1.0 < t < 3.0
    assert abs(float(r.camera.focal_depth) - t) < 1e-6


def test_autofocus_pixel_matches_jax(small_scene):
    from fspt_tpu.runtime.renderer import Renderer as JRenderer
    ref = JRenderer(jax_scene(subdivisions=2), _small_cfg())
    ours = Renderer(small_scene, _small_cfg(), device="cpu")
    for px, py in ((16, 12), (3, 20)):
        np.testing.assert_allclose(ours.autofocus(px, py),
                                   ref.autofocus(px, py), rtol=1e-5)


def test_preview_leaves_accumulation_alone(small_scene):
    r = Renderer(small_scene, _small_cfg(), device="cpu").step()
    accum = r.accum.clone()
    img = r.preview(scale=0.5)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert torch.equal(r.accum, accum) and float(r.count) == 1.0


def _dark_emissive_scene():
    scene = make_test_scene(subdivisions=1, env="gradient",
                            emissive_sphere=True)
    # black env: the light is the only source
    for plane in scene.arrays.env_rgb:
        plane[:] = 0.0
    return scene


def test_emissive_scene_lights_up():
    r = Renderer(_dark_emissive_scene(), _small_cfg(seed=1), device="cpu")
    r.step(2)
    assert r.hdr_image().max() > 0.0


def test_light_nee_unbiased_vs_bsdf_sampling():
    """Area-light NEE with MIS converges to the BSDF-sampling image."""
    scene = _dark_emissive_scene()
    means = {}
    for nee in (False, True):
        cfg = _small_cfg(width=16, height=16, seed=2, intersector="brute",
                         use_light_nee=nee, batch_spp=4)
        r = Renderer(scene, cfg, device="cpu")
        r.step(16)
        means[nee] = float(r.hdr_image().mean())
        segs = 3 if nee else 2
        assert r.stats["lane_rays_upper_bound"] == (
            64 * 256 * (1 + segs * cfg.max_iters))
    assert means[True] > 0
    assert abs(means[True] - means[False]) / means[False] < 0.15


# ---- the CLI (ports of tests/test_tools.py:145-188) ----------------------

@pytest.fixture
def scene_file(tmp_path):
    path = tmp_path / "s.json"
    (tmp_path / "mesh.obj").write_text(icosphere_obj(0))
    path.write_text(json.dumps({
        "environment": [[0.2, 0.2, 0.2], [0.8, 0.8, 0.8]],
        "props": [{"path": "mesh.obj", "diffuse": [1, 0, 0]}],
    }))
    return str(path)


def _args(scene_file, **kw):
    base = dict(scene=scene_file, res="32", bounces=2, batch_spp=1,
                mode="render", seed=0, denoise=False, exposure=None,
                no_compact=False, samples=2, autofocus=False,
                checkpoint=None, stats=False)
    base.update(kw)
    return Namespace(**base)


def test_cli_production_config(scene_file):
    from fspt_tpu_torch.__main__ import _build
    args = _args(scene_file)
    _, r = _build(args, device="cpu")
    assert r.cfg.intersector == "split"
    assert r.cfg.compact and r.cfg.sort_state
    assert r.cfg.nee_env_nearest and r.cfg.escape_env_nearest
    args.no_compact = True
    _, r = _build(args, device="cpu")
    assert r.cfg.intersector == "walk"
    assert not (r.cfg.compact or r.cfg.sort_state
                or r.cfg.nee_env_nearest or r.cfg.escape_env_nearest)


def test_cli_info(scene_file, capsys):
    from fspt_tpu_torch.__main__ import main
    assert main(["info", scene_file]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["triangles"] == 20
    assert info["bvh_depth"] >= 1


@pytest.mark.parametrize("no_compact", [True, False])
def test_cli_render_writes_png(scene_file, tmp_path, capsys, no_compact):
    from fspt_tpu_torch.__main__ import cmd_render, main
    from fspt_tpu_torch.io.image import read_png
    out = str(tmp_path / "out.png")
    args = _args(scene_file, out=out, no_compact=no_compact, autofocus=True,
                 mode="bvh_heatmap" if no_compact else "render")
    assert cmd_render(args, device="cpu") == 0
    img = read_png(out)
    assert img.shape == (32, 32, 3) and img.max() > 0
    # diff of the image with itself: zero error, exit code 0
    assert main(["diff", out, out, "--max-rmse", "0"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["rmse"] == 0
