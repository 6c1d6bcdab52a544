"""The port's distribution layer (fspt_tpu_torch.parallel.dist) on the CPU:
meshes of shards held by one process, against the port's single-device
renderer and train step and against the JAX package's sharded steps on
its virtual 8-device CPU mesh (tests/conftest.py).

Bounds: per pixel rtol 1e-5, atol 1e-6 (tests/test_parallel.py:67); the
train step as tests/test_torch_train.py `_check_step` holds it (the loss
within 1e-4 relative, per field a cosine of at least 0.999 where JAX's
gradient is nonzero and an exact zero where it is zero).  The JAX steps
run under intersector="brute" (plain XLA, no Pallas interpret call), once,
in a module fixture; JAX is imported only there.
"""

import numpy as np
import pytest
import torch

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import rng
from fspt_tpu_torch.core.camera import generate_rays
from fspt_tpu_torch.core.integrator import trace_paths
from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.parallel.dist import (PARAM_FIELDS, _deal_chunks,
                                          gather_accum, make_mesh,
                                          make_sharded_sample_step,
                                          make_train_step, params_to_torch,
                                          shard_accum, split_params)
from fspt_tpu_torch.runtime.layout import tile_order
from fspt_tpu_torch.runtime.renderer import CameraState, Renderer
from fspt_tpu_torch.scene.schema import scene_to_torch
from fspt_tpu_torch.testing import make_test_scene

torch.set_num_threads(1)

RENDER = dict(width=16, height=16, bounces=2, extra_refraction_iters=1,
              batch_spp=1, seed=0)
TRAIN = dict(width=16, height=8, bounces=2, extra_refraction_iters=1,
             batch_spp=1, intersector="brute")
SAMPLES, SEED, STEP = 2, 0, 3


def _target(n):
    return np.random.default_rng(5).uniform(0.0, 1.0, (3, n)).astype(
        np.float32)


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(subdivisions=2)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's 8-shard sample step (SAMPLES steps, "brute") and
    its train steps on meshes of 2 and 8, on the JAX package's scene."""
    import jax
    import jax.numpy as jnp

    from fspt_tpu.config import RenderConfig as JCfg
    from fspt_tpu.parallel import dist as jdist
    from fspt_tpu.runtime.renderer import CameraState as JCam
    from fspt_tpu.testing import make_test_scene as jscene

    scene = jscene(subdivisions=2)
    arrays = scene.device_arrays()
    cam = JCam.from_config(scene.camera)
    cfg = JCfg(**RENDER, intersector="brute")
    mesh = jdist.make_mesh(8)
    step = jdist.make_sharded_sample_step(mesh, cfg, scene.meta)
    n = cfg.width * cfg.height
    accum = jdist.shard_accum(jnp.zeros((3, n), jnp.float32), mesh)
    count = jnp.zeros(())
    for i in range(SAMPLES):
        accum, count, shard_rays = step(arrays, cam, accum, count,
                                        jax.random.key(SEED), i)
    out = {"scene": scene, "accum": np.asarray(accum),
           "count": float(count), "shard_rays": np.asarray(shard_rays),
           "pixel_order": np.asarray(step.pixel_order)}
    tcfg = JCfg(**TRAIN)
    params = jdist.split_params(arrays)
    cam_params = {"position": cam.position, "direction": cam.direction}
    to_np = lambda t: jax.tree.map(np.asarray, t)
    for k in (2, 8):
        mesh = jdist.make_mesh(k)
        train = jdist.make_train_step(mesh, tcfg, scene.meta)
        target = jdist.shard_accum(
            jnp.asarray(_target(tcfg.width * tcfg.height)), mesh)
        loss, grads, cam_grads = train(params, cam_params, arrays, cam,
                                       target, jax.random.key(SEED), STEP)
        out[k] = (float(loss), to_np(grads), to_np(cam_grads))
    return out


def _inputs(scene):
    """The port's scene arrays, camera, parameter leaves and camera leaves
    on the CPU (fresh leaves each call)."""
    params = params_to_torch(
        {f: np.asarray(v) for f, v in split_params(scene.arrays).items()},
        "cpu")
    cam_params = params_to_torch({"position": scene.camera.position,
                                  "direction": scene.camera.direction}, "cpu")
    return (params, cam_params, scene_to_torch(scene.arrays, "cpu"),
            CameraState.from_config(scene.camera, "cpu"))


def _sharded(scene, cfg, mesh, samples):
    """`samples` steps of the port's sharded step -> (global accum in
    dealt order, count, last shard_rays, step)."""
    dev = mesh.device
    step = make_sharded_sample_step(mesh, cfg, scene.meta)
    arrays = scene_to_torch(scene.arrays, dev)
    cam = CameraState.from_config(scene.camera, dev)
    n = cfg.width * cfg.height
    accum = shard_accum(torch.zeros((3, n)), mesh)
    count = torch.zeros((), device=dev)
    for i in range(samples):
        accum, count, shard_rays = step(arrays, cam, accum, count,
                                        rng.key(cfg.seed), i)
    return (gather_accum(accum, mesh).cpu().numpy(), float(count),
            shard_rays.cpu(), step)


def _grad_fields(grads, cam_grads):
    """(name, flat float64 numpy) for every parameter and camera field."""
    out = []
    for name, g in list(grads.items()) + list(cam_grads.items()):
        parts = g if isinstance(g, tuple) else (g,)
        out.append((name, np.concatenate([
            np.asarray(p.detach().numpy() if torch.is_tensor(p) else p,
                       np.float64).reshape(-1) for p in parts])))
    return out


def test_mesh_holds_its_shards():
    mesh = make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.shards == tuple(range(8))
    assert mesh.group is None and mesh.axis_name == "rays"
    assert mesh.device == torch.device("cpu")
    assert make_mesh(device="cpu").size == 1


@pytest.mark.parametrize("size,k", [(16, 1), (16, 2), (16, 8), (64, 4)])
def test_pixel_order_matches_jax(size, k):
    """pixel_order equal to JAX's as integers (JAX builds it in numpy; the
    jitted step is never called, so nothing compiles)."""
    from fspt_tpu.config import RenderConfig as JCfg
    from fspt_tpu.parallel import dist as jdist
    cfg = dict(width=size, height=size)
    jstep = jdist.make_sharded_sample_step(jdist.make_mesh(k), JCfg(**cfg),
                                           None)
    step = make_sharded_sample_step(make_mesh(k, device="cpu"),
                                    RenderConfig(**cfg), None)
    assert step.pixel_order.dtype == np.int32
    np.testing.assert_array_equal(step.pixel_order,
                                  np.asarray(jstep.pixel_order))
    assert step.columns == slice(0, size * size)


@pytest.mark.parametrize("sort_state", [False, True])
def test_sharded_render_matches_single_device_per_pixel(scene, sort_state):
    """tests/test_parallel.py:31-67 on the port: the 8-shard step in one
    process under the default "walk" (the plain version on the CPU) draws
    the per-pixel RNG streams the single-device renderer draws, so the two
    images are equal per pixel; sort_state permutes lanes within a shard
    and must not change that."""
    cfg = RenderConfig(**RENDER, sort_state=sort_state)
    n_samples = 4
    accum, count, shard_rays, step = _sharded(
        scene, cfg, make_mesh(8, device="cpu"), n_samples)
    sharded = accum / count
    assert np.isfinite(sharded).all()
    assert shard_rays.shape == (8,) and float(shard_rays.min()) > 0

    r = Renderer(scene, cfg, device="cpu").step(n_samples)
    single = r.accum.numpy() / n_samples
    img_sharded = np.zeros_like(sharded)
    img_sharded[:, step.pixel_order] = sharded
    img_single = np.zeros_like(single)
    img_single[:, r.pixel_idx.numpy()] = single
    np.testing.assert_allclose(img_sharded, img_single, rtol=1e-5, atol=1e-6)


def test_sharded_step_matches_jax(reference):
    """The port's 8-shard step against JAX's on make_mesh(8), "brute", on
    the same scene arrays and key (both in the same dealt order): the
    per-shard ray counts equal, and each value within rtol 1e-5, atol 1e-6
    but for at most 2 of the 768, which are held to rtol 5e-5.  Those two
    are the two integrators' own arithmetic, not the sharding: the
    packages' single-device renderers differ by as much there (one pixel at
    1.2e-5 relative; ROADMAP queue C), and the port's sharded image equals
    its single-device renderer's bit for bit."""
    scene = reference["scene"]
    cfg = RenderConfig(**RENDER, intersector="brute")
    accum, count, shard_rays, step = _sharded(
        scene, cfg, make_mesh(8, device="cpu"), SAMPLES)
    np.testing.assert_array_equal(step.pixel_order, reference["pixel_order"])
    assert count == reference["count"] == SAMPLES
    np.testing.assert_array_equal(shard_rays.numpy(), reference["shard_rays"])
    ref = reference["accum"]
    off = ~np.isclose(accum, ref, rtol=1e-5, atol=1e-6)
    assert off.sum() <= 2, off.sum()
    np.testing.assert_allclose(accum[off], ref[off], rtol=5e-5, atol=1e-6)

    r = Renderer(make_test_scene(subdivisions=2), cfg,
                 device="cpu").step(SAMPLES)
    single = np.zeros_like(accum)
    single[:, r.pixel_idx.numpy()] = r.accum.numpy()
    np.testing.assert_array_equal(accum, single[:, step.pixel_order])


def test_train_step_produces_finite_pmean_grads(scene):
    """tests/test_parallel.py:70-86 on the port: an 8-shard train step
    under the default "walk" gives a finite loss and finite gradients, not
    all zero."""
    cfg = RenderConfig(width=16, height=8, bounces=1,
                       extra_refraction_iters=0, batch_spp=1, seed=0)
    mesh = make_mesh(8, device="cpu")
    params, cam_params, arrays, cam = _inputs(scene)
    train = make_train_step(cfg, scene.meta, mesh=mesh)
    target = shard_accum(torch.full((3, 128), 0.25), mesh)
    loss, grads, cam_grads = train(params, cam_params, arrays, cam, target,
                                   rng.key(1), 0)
    assert np.isfinite(float(loss))
    flat = [g for _, g in _grad_fields(grads, cam_grads)]
    assert all(np.isfinite(g).all() for g in flat)
    assert sum(float(np.abs(g).sum()) for g in flat) > 0.0


@pytest.mark.parametrize("k", [2, 8])
def test_mesh_train_step_matches_jax(reference, k):
    """The port's k-shard train step (a mean of shard means) against JAX's
    make_train_step(make_mesh(k)), "brute", same target and key."""
    scene = reference["scene"]
    jloss, jgrads, jcam = reference[k]
    cfg = RenderConfig(**TRAIN)
    mesh = make_mesh(k, device="cpu")
    params, cam_params, arrays, cam = _inputs(scene)
    train = make_train_step(cfg, scene.meta, mesh=mesh)
    target = shard_accum(_target(cfg.width * cfg.height), mesh)
    loss, grads, cam_grads = train(params, cam_params, arrays, cam, target,
                                   rng.key(SEED), STEP)
    assert abs(float(loss) - jloss) <= 1e-4 * abs(jloss), (float(loss), jloss)
    ref = dict(_grad_fields({f: jgrads[f] for f in PARAM_FIELDS}, jcam))
    held = 0
    for name, ours in _grad_fields(grads, cam_grads):
        assert ours.shape == ref[name].shape, name
        assert np.isfinite(ours).all(), name
        if not np.any(ref[name]):
            assert not np.any(ours), name
            continue
        held += 1
        cos = float(ours @ ref[name] / (np.linalg.norm(ours)
                                        * np.linalg.norm(ref[name])))
        assert cos >= 0.999, (name, cos)
    assert held >= 4, held


def _one_device_step(cfg, meta, params, cam_params, scene, cam, target,
                     base_key, step_idx):
    """The one-device train step as it stood before meshes: every lane on
    one device in tile order, autograd.grad of the mean squared error."""
    n = cfg.width * cfg.height
    lane_ids = torch.from_numpy(_deal_chunks(n, 1))
    pixel_idx = torch.from_numpy(
        np.asarray(tile_order(cfg.width, cfg.height), np.int32)[
            _deal_chunks(n, 1)])
    key = rng.sample_key(base_key, step_idx)
    sc = scene._replace(**params)
    c = cam._replace(**cam_params)
    leaves = [p for v in list(params.values()) + list(cam_params.values())
              for p in (v if isinstance(v, V3) else (v,))]
    with torch.enable_grad():
        cam_u = rng.stream_uniforms(key, 0, (4, n), lane_offset=lane_ids)
        o, d = generate_rays(c.position, c.direction, c.fov_scale,
                             c.focal_depth, c.aperture,
                             (cfg.width, cfg.height), cam_u,
                             pixel_idx=pixel_idx)
        r = trace_paths(sc, cfg, meta, o, d, key, lane_offset=lane_ids)
        loss = torch.mean((torch.stack([r.x, r.y, r.z]) - target) ** 2)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("one_shard_mesh", [False, True])
def test_unsharded_train_step_unchanged(scene, one_shard_mesh):
    """mesh=None and a one-shard mesh each give the one-device step's loss
    and gradients, torch.equal."""
    cfg = RenderConfig(**TRAIN)
    params, cam_params, arrays, cam = _inputs(scene)
    target = torch.from_numpy(_target(cfg.width * cfg.height))
    ref_loss, ref_grads = _one_device_step(cfg, scene.meta, params,
                                           cam_params, arrays, cam, target,
                                           rng.key(SEED), STEP)
    if one_shard_mesh:
        mesh = make_mesh(1, device="cpu")
        train = make_train_step(cfg, scene.meta, mesh=mesh)
        target = shard_accum(target, mesh)
    else:
        train = make_train_step(cfg, scene.meta, device="cpu")
    loss, grads, cam_grads = train(params, cam_params, arrays, cam, target,
                                   rng.key(SEED), STEP)
    assert torch.equal(loss, ref_loss)
    ours = [p for v in list(grads.values()) + list(cam_grads.values())
            for p in (v if isinstance(v, V3) else (v,))]
    assert len(ours) == len(ref_grads)
    assert all(torch.equal(a, b) for a, b in zip(ours, ref_grads))


def test_mesh_defaults_to_cuda_and_checks_sizes(scene, monkeypatch):
    """make_mesh defaults to the card and raises without one; a pixel count
    the mesh does not divide raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(2)
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_sample_step(make_mesh(3, device="cpu"),
                                 RenderConfig(width=16, height=16), None)


@pytest.mark.cuda
def test_cuda_sharded_split_step_matches_renderer(scene):
    """On the card: an 8-shard "split" step with the main path's options
    (traverse4) equal per pixel, bit for bit, to Renderer.step, with 8 x
    traversal_launches of a shard's lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fspt_tpu_torch.core.integrator import traversal_launches
    from fspt_tpu_torch.ops.traverse4 import packet_traverse4
    cfg = RenderConfig(width=64, height=64, bounces=3, batch_spp=2,
                       intersector="split", compact=True, sort_state=True,
                       nee_env_nearest=True, escape_env_nearest=True)
    before = packet_traverse4.launches
    accum, count, shard_rays, step = _sharded(scene, cfg, make_mesh(8), 1)
    assert packet_traverse4.launches - before == 8 * traversal_launches(
        cfg, 64 * 64 // 8, 2)
    r = Renderer(scene, cfg, device="cuda").step()
    single = np.zeros_like(accum)
    single[:, r.pixel_idx.cpu().numpy()] = r.accum.cpu().numpy()
    np.testing.assert_array_equal(accum, single[:, step.pixel_order])
    assert float(shard_rays.sum()) == r.stats["rays"]
