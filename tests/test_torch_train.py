"""The port's train step (fspt_tpu_torch.parallel.dist.make_train_step)
against the JAX package's on a one-device CPU mesh.

Shapes are those the JAX package's entry contract gives its train step
(__graft_entry__.py: 16x1 pixels, 2 bounces, 1 extra refraction
iteration, 1 spp), under intersector="brute" (plain XLA, no Pallas).  The
same scene arrays, parameters (carried over with params_to_torch), target
and key go into both steps.  Bounds: the loss within 1e-4 relative, and
for every parameter field whose reference gradient is nonzero a cosine of
at least 0.999 between the two gradients, and a zero gradient where the
reference's is zero; pixel_order equal as integers.
The JAX step is run once, in a module fixture; JAX is imported only there.

On a card (marked `cuda`): the gradients of one 64x64 "split" step with
the traverse4 kernel against the same step with its plain version, rtol
1e-5 (the backward's scatter-adds are not ordered on the card).
"""

import numpy as np
import pytest
import torch

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import integrator, rng
from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.ops.traverse4 import (packet_traverse4,
                                          packet_traverse4_reference)
from fspt_tpu_torch.parallel.dist import (PARAM_FIELDS, _deal_chunks,
                                          make_train_step, params_to_torch,
                                          split_params)
from fspt_tpu_torch.runtime.renderer import CameraState
from fspt_tpu_torch.scene.schema import scene_to_torch
from fspt_tpu_torch.testing import make_test_scene

torch.set_num_threads(1)

CFG = dict(width=16, height=1, bounces=2, extra_refraction_iters=1,
           batch_spp=1, intersector="brute")
SEED, STEP = 0, 3
# the main path's options (chip_smoke.py phase 16) at the size where the
# (1, 4) schedule shrinks 4,096 lanes to 1,024 after bounce 0 and the ~800
# live ones fit, so no RR fires (RR survivors would hang on the sort's tie
# order, which is exact on neither side: tests/test_torch_integrator.py)
MAIN_CFG = dict(width=64, height=64, bounces=3, batch_spp=1,
                intersector="brute", compact=True, compact_schedule=(1, 4),
                sort_state=True, nee_env_nearest=True,
                escape_env_nearest=True)
MAIN_SCENE = dict(subdivisions=1, textured=True)


def _target(n):
    return np.random.default_rng(5).uniform(0.0, 1.0, (3, n)).astype(
        np.float32)


def _jax_step(cfg_kw, scene_kw):
    """The JAX step's (scene, loss, grads, cam_grads, pixel_order)."""
    import jax
    import jax.numpy as jnp

    from fspt_tpu.config import RenderConfig as JCfg
    from fspt_tpu.parallel import dist as jdist
    from fspt_tpu.runtime.renderer import CameraState as JCam
    from fspt_tpu.testing import make_test_scene as jscene

    scene = jscene(**scene_kw)
    cfg = JCfg(**cfg_kw)
    arrays = scene.device_arrays()
    cam = JCam.from_config(scene.camera)
    step = jdist.make_train_step(jdist.make_mesh(1), cfg, scene.meta)
    params = jdist.split_params(arrays)
    cam_params = {"position": cam.position, "direction": cam.direction}
    target = jnp.asarray(_target(cfg.width * cfg.height))
    loss, grads, cam_grads = step(params, cam_params, arrays, cam, target,
                                  jax.random.key(SEED), STEP)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return (scene, float(loss), to_np(grads), to_np(cam_grads),
            np.asarray(step.pixel_order))


@pytest.fixture(scope="module")
def reference():
    return _jax_step(CFG, dict(subdivisions=1))


@pytest.fixture(scope="module")
def reference_main():
    return _jax_step(MAIN_CFG, MAIN_SCENE)


def _port_step(scene, cfg_kw=CFG):
    cfg = RenderConfig(**cfg_kw)
    arrays = scene_to_torch(scene.arrays, "cpu")
    params = params_to_torch(
        {f: np.asarray(v) for f, v in split_params(scene.arrays).items()},
        "cpu")
    cam = CameraState.from_config(scene.camera, "cpu")
    cam_params = params_to_torch({"position": scene.camera.position,
                                  "direction": scene.camera.direction},
                                 "cpu")
    step = make_train_step(cfg, scene.meta, device="cpu")
    target = torch.from_numpy(_target(cfg.width * cfg.height))
    return step, step(params, cam_params, arrays, cam, target,
                      rng.key(SEED), STEP)


def _flat(g):
    return np.concatenate([np.asarray(p, np.float64).reshape(-1) for p in
                           (g if isinstance(g, tuple) else (g,))])


def _cosine(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _check_step(reference, cfg_kw):
    """Loss within 1e-4 relative; per field, cosine >= 0.999 where the
    reference's gradient is nonzero and an exact zero where it is zero.
    Returns the number of fields held to the cosine."""
    scene, jloss, jgrads, jcam, _ = reference
    _, (loss, grads, cam_grads) = _port_step(scene, cfg_kw)
    assert abs(float(loss) - jloss) <= 1e-4 * abs(jloss), (float(loss), jloss)
    held = 0
    for name, g_ref, g in ([(f, jgrads[f], grads[f]) for f in PARAM_FIELDS]
                           + [(f, jcam[f], cam_grads[f])
                              for f in ("position", "direction")]):
        ref = _flat(g_ref)
        ours = _flat(tuple(p.numpy() for p in g) if isinstance(g, V3)
                     else g.numpy())
        assert ours.shape == ref.shape, name
        assert np.isfinite(ours).all(), name
        if not np.any(ref):
            # a gradient the reference does not take (through a hit
            # distance, a lobe choice) is a fault, not noise
            assert not np.any(ours), name
            continue
        held += 1
        assert _cosine(ours, ref) >= 0.999, (name, _cosine(ours, ref))
    return held


def test_train_step_matches_jax(reference):
    # the step must reach materials, the env map and the camera
    held = _check_step(reference, CFG)
    assert held >= 4, held


def test_train_step_main_path_matches_jax(reference_main):
    """The options the card trains with (chip_smoke.py phase 16): nearest
    env texels for NEE and escapes, a shrinking compaction and the state
    sort, each with detach sites of its own (the fused env draw, the sort
    keys)."""
    held = _check_step(reference_main, MAIN_CFG)
    assert held >= 4, held


def test_train_pixel_order_matches_jax(reference):
    scene, _, _, _, jorder = reference
    step, _ = _port_step(scene)
    assert step.pixel_order.dtype == np.int32
    np.testing.assert_array_equal(step.pixel_order, jorder)


@pytest.mark.parametrize("n,n_dev", [(16, 1), (4096, 1), (4096, 4),
                                     (65536, 4)])
def test_deal_chunks_matches_jax(n, n_dev):
    """The lane dealing is copied, not imported: equal to the JAX one."""
    from fspt_tpu.parallel.dist import _deal_chunks as jdeal
    np.testing.assert_array_equal(_deal_chunks(n, n_dev), jdeal(n, n_dev))


def test_params_to_torch_leaves():
    """V3 fields as V3 of leaves (from planes or from one (3, S) array);
    every leaf float32 and requiring grad; the step refuses a parameter
    that does not."""
    scene = make_test_scene(subdivisions=1)
    p = split_params(scene.arrays)
    stacked = {f: (np.stack(list(v)) if isinstance(v, tuple) else v)
               for f, v in p.items()}
    for src in (p, stacked):
        t = params_to_torch(src, "cpu")
        assert isinstance(t["emit"], V3) and isinstance(t["env_rgb"], V3)
        for f in PARAM_FIELDS:
            for leaf in (t[f] if isinstance(t[f], V3) else (t[f],)):
                assert leaf.dtype == torch.float32 and leaf.requires_grad
                assert leaf.is_leaf
        np.testing.assert_array_equal(t["env_rgb"].y.detach().numpy(),
                                      scene.arrays.env_rgb.y)
    step = make_train_step(RenderConfig(**CFG), scene.meta, device="cpu")
    t["ior"] = t["ior"].detach()
    cam = CameraState.from_config(scene.camera, "cpu")
    with pytest.raises(ValueError, match="requires grad"):
        step(t, params_to_torch({"position": scene.camera.position,
                                 "direction": scene.camera.direction}, "cpu"),
             scene.to_torch("cpu"), cam, torch.zeros(3, 16), rng.key(0), 0)


@pytest.mark.cuda
def test_cuda_train_step_kernel_matches_plain(monkeypatch):
    """One 64x64 "split" step on the card through the traverse4 kernel,
    and again with the integrator's traversal swapped for the plain
    version: equal loss and gradients (rtol 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = make_test_scene(subdivisions=2, textured=True)
    cfg = RenderConfig(width=64, height=64, bounces=3, intersector="split",
                       compact=True, compact_schedule=(1.3, 4),
                       sort_state=True, nee_env_nearest=True,
                       escape_env_nearest=True)
    arrays = scene.to_torch("cuda")
    cam = CameraState.from_config(scene.camera, "cuda")
    step = make_train_step(cfg, scene.meta)
    target = torch.full((3, 64 * 64), 0.25, device="cuda")

    def run():
        params = params_to_torch(
            {f: np.asarray(v) for f, v in split_params(scene.arrays).items()},
            "cuda")
        cp = params_to_torch({"position": scene.camera.position,
                              "direction": scene.camera.direction}, "cuda")
        return step(params, cp, arrays, cam, target, rng.key(1), 0)

    before = packet_traverse4.launches
    loss_k, g_k, c_k = run()
    assert packet_traverse4.launches > before
    monkeypatch.setattr(integrator, "packet_traverse4",
                        packet_traverse4_reference)
    loss_p, g_p, c_p = run()
    assert packet_traverse4.launches > before
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0.0)
    for a, b in ([(g_k[f], g_p[f]) for f in PARAM_FIELDS]
                 + [(c_k[f], c_p[f]) for f in c_k]):
        for x, y in zip(a if isinstance(a, V3) else (a,),
                        b if isinstance(b, V3) else (b,)):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-9)
