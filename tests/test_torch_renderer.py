"""The port's Renderer (fspt_tpu_torch.runtime.renderer) against the JAX
package's stored goldens (tests/goldens/), with intersector="split".

Bounds are those of tests/test_goldens.py: the 32x32 goldens within 5%
relative (cross-backend float drift, not estimator drift), and the
production path of the 128^2 statistical golden (compaction with an
RR-forcing tail schedule, wavefront batching, state sort) within the image
mean to 2% and every 16x16-block mean to 15%.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from fspt_tpu_torch.config import PostConfig, RenderConfig
from fspt_tpu_torch.ops.traverse3 import packet_traverse3
from fspt_tpu_torch.ops.traverse4 import packet_traverse4
from fspt_tpu_torch.runtime.renderer import Renderer
from fspt_tpu_torch.testing import make_test_scene

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _cfg(**kw):
    base = dict(width=32, height=32, bounces=3, extra_refraction_iters=2,
                batch_spp=4, seed=7, intersector="split")
    base.update(kw)
    return RenderConfig(**base)


CASES = {
    # name -> (scene kwargs, post, samples)  (tests/test_goldens.py CASES)
    "bunny_class": (dict(subdivisions=3), None, 8),
    "textured": (dict(subdivisions=2, textured=True), None, 8),
    "dielectric": (dict(subdivisions=2, dielectric=0.4, ior=1.5), None, 8),
    "dof_post": (dict(subdivisions=2),
                 PostConfig(exposure=1.4, saturation=1.2, denoise=True), 8),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden(name):
    scene_kw, post, samples = CASES[name]
    r = Renderer(make_test_scene(**scene_kw), _cfg(), post=post,
                 device="cpu")
    if name == "dof_post":
        r.camera = r.camera._replace(aperture=torch.tensor(0.08),
                                     focal_depth=torch.tensor(2.0))
    r.step(samples // r.cfg.batch_spp)
    img = r.image() if name == "dof_post" else r.hdr_image()
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    assert golden.shape == img.shape
    err = np.abs(img - golden) / np.maximum(np.abs(golden), 1e-2)
    assert err.max() < 0.05, f"golden {name} deviates: max rel {err.max()}"


def test_statistical_golden_128_production():
    scene = make_test_scene(subdivisions=2, textured=True)
    cfg = RenderConfig(width=128, height=128, bounces=4,
                       extra_refraction_iters=2, batch_spp=4, seed=7,
                       intersector="split", compact=True,
                       compact_schedule=(1.3, 16), wavefront_batch=True,
                       sort_state=True)
    r = Renderer(scene, cfg, device="cpu").step(4)        # 16 spp
    prod = r.hdr_image()
    assert np.isfinite(prod).all()
    golden = np.load(os.path.join(GOLDEN_DIR, "statistical_128.npy"))
    g_mean = golden.mean()
    assert abs(prod.mean() - g_mean) / g_mean < 0.02, (prod.mean(), g_mean)
    blocks_g = golden.reshape(8, 16, 8, 16, 3).mean(axis=(1, 3, 4))
    blocks_p = prod.reshape(8, 16, 8, 16, 3).mean(axis=(1, 3, 4))
    rel = np.abs(blocks_p - blocks_g) / np.maximum(blocks_g, 1e-2)
    assert rel.max() < 0.15, f"block drift {rel.max():.3f}"
    assert r.stats["rays"] > 0 and float(r.count) == 16.0


def test_checkpoint_resume_bit_identical(tmp_path):
    scene = make_test_scene(subdivisions=1, textured=True)
    cfg = _cfg(batch_spp=2, compact=True, compact_schedule=(1.3, 4),
               wavefront_batch=True, sort_state=True)
    straight = Renderer(scene, cfg, device="cpu").step(2)
    first = Renderer(scene, cfg, device="cpu").step(1)
    path = str(tmp_path / "ckpt.npz")
    first.save_checkpoint(path)
    resumed = Renderer(scene, cfg, device="cpu").load_checkpoint(path).step(1)
    assert resumed.sample_idx == straight.sample_idx == 2
    assert torch.equal(resumed.accum, straight.accum)
    assert torch.equal(resumed.count, straight.count)
    with pytest.raises(ValueError, match="seed"):
        Renderer(scene, dataclasses.replace(cfg, seed=8),
                 device="cpu").load_checkpoint(path)


def _deterministic_cfg(**kw):
    # tests/test_render.py test_render_deterministic's configuration
    return RenderConfig(width=32, height=24, bounces=2,
                        extra_refraction_iters=1, batch_spp=1, seed=5, **kw)


def test_render_deterministic():
    """Two renders of one seed are bit-equal (tests/test_render.py)."""
    scene = make_test_scene(subdivisions=2)
    cfg = _deterministic_cfg()
    a = Renderer(scene, cfg, device="cpu").step(2).hdr_image()
    b = Renderer(scene, cfg, device="cpu").step(2).hdr_image()
    np.testing.assert_array_equal(a, b)


def test_cpu_render_launches_no_kernel():
    """The CPU path runs the traversal's plain version; only a kernel
    launch on a card counts."""
    before = packet_traverse4.launches
    r = Renderer(make_test_scene(subdivisions=1), _cfg(batch_spp=1),
                 device="cpu").step()
    assert np.isfinite(r.hdr_image()).all()
    m = r.step_metrics()
    assert len(m["scatter_occupancy"]) == r.cfg.max_iters
    assert packet_traverse4.launches == before


def test_cuda_device_required():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(make_test_scene(subdivisions=1), _cfg())


@pytest.mark.cuda
def test_cuda_render_matches_cpu():
    """On a card the same render through the CUDA kernel: every launch
    counted, and the image equal to the CPU path's up to the float drift
    of the non-traversal ops."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = make_test_scene(subdivisions=2, textured=True)
    cfg = _cfg(compact=True, compact_schedule=(1.3, 4), wavefront_batch=True,
               sort_state=True, nee_env_nearest=True,
               escape_env_nearest=True)
    before = packet_traverse4.launches
    gpu = Renderer(scene, cfg, device="cuda").step(2)
    assert packet_traverse4.launches > before
    cpu = Renderer(scene, cfg, device="cpu").step(2)
    a, b = gpu.hdr_image(), cpu.hdr_image()
    err = np.abs(a - b) / (1.0 + np.abs(b))
    assert np.mean(err < 2e-3) >= 0.995


@pytest.mark.cuda
@pytest.mark.parametrize("intersector", ["walk", "split"])
def test_cuda_render_deterministic(intersector):
    """Two renders of one seed on the card are bit-equal, through the
    kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = make_test_scene(subdivisions=2)
    cfg = _deterministic_cfg(intersector=intersector)
    kernel = packet_traverse4 if intersector == "split" else packet_traverse3
    before = kernel.launches
    a = Renderer(scene, cfg, device="cuda").step(2).hdr_image()
    b = Renderer(scene, cfg, device="cuda").step(2).hdr_image()
    assert kernel.launches > before
    np.testing.assert_array_equal(a, b)
