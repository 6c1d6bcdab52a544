"""Gradients of the port's render path (tests/test_grad_fd.py on
fspt_tpu_torch).

The integrator detaches discrete events (hit selection, lobe choice,
env-bin and light picks) where the JAX version stop_gradients them, and
differentiates the continuous factors.  For parameters whose influence is
purely continuous, torch.autograd.grad must agree with a central finite
difference of the SAME estimator at the SAME RNG streams.  Each check is
the directional derivative along one seeded random direction (the numpy
draws of the JAX test, so the same directions), with the reference's h and
rel_tol unchanged.

For the env map, the atlas, the emittance and the camera direction the
port's gradient is also held to jax.grad of the JAX integrator on the same
numpy inputs (intersector="brute": plain XLA, no Pallas): directional
derivatives along 4 seeded directions within 2e-3 relative, and the cosine
of the two gradients >= 0.999.  The JAX gradients are computed once, in a
module fixture; JAX is imported only there.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import rng
from fspt_tpu_torch.core.camera import generate_rays
from fspt_tpu_torch.core.integrator import atlas_fetch_rgb, trace_paths
from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.testing import make_test_scene

torch.set_num_threads(1)

SIZE = 12
N = SIZE * SIZE
SCENE_KW = dict(subdivisions=1, textured=True, metallic=0.3, roughness=0.5)
ALL_MISS_POS = (0.0, 0.3, 2.2)
ALL_MISS_DIR = (0.3, 0.5, -0.8)


def _cfg(**kw):
    return RenderConfig(width=SIZE, height=SIZE, bounces=kw.pop("bounces", 2),
                        extra_refraction_iters=0, intersector="brute", **kw)


def _cam_rays(cam, key):
    cam_u = rng.stream_uniforms(key, 0, (4, N))
    return generate_rays(torch.tensor(cam.position),
                         torch.tensor(cam.direction), cam.fov_scale,
                         cam.focal_depth, cam.aperture, (SIZE, SIZE), cam_u)


@pytest.fixture(scope="module")
def setup():
    scene = make_test_scene(**SCENE_KW)
    arrays = scene.to_torch("cpu")
    key = rng.sample_key(rng.key(11), 0)
    origin, direction = _cam_rays(scene.camera, key)
    return scene, arrays, _cfg(), origin, direction, key


def _loss(arrays, cfg, meta, origin, direction, key):
    r = trace_paths(arrays, cfg, meta, origin, direction, key)
    return (r.x.mean() + r.y.mean() + r.z.mean()) / 3.0


def _grad(f, x0):
    """torch.autograd.grad of f at x0 (a tuple of tensors)."""
    leaves = [x.detach().clone().requires_grad_(True) for x in x0]
    return torch.autograd.grad(f(leaves), leaves)


def _directions(x0, seed):
    """The JAX test's direction: one standard-normal draw per leaf, in
    leaf order, from default_rng(seed)."""
    r = np.random.default_rng(seed)
    return [torch.as_tensor(np.asarray(r.standard_normal(tuple(a.shape)),
                                       np.float32)) for a in x0]


def _check_directional(f, x0, seed, h, rel_tol, abs_floor=1e-7, v_mask=None):
    """grad(f)(x0) . v  vs  (f(x0 + h v) - f(x0 - h v)) / 2h."""
    g = _grad(f, x0)
    v = _directions(x0, seed)
    if v_mask is not None:
        v = [a * v_mask for a in v]
    ad = sum(float(torch.dot(gi.reshape(-1), vi.reshape(-1)))
             for gi, vi in zip(g, v))
    with torch.no_grad():
        fp = float(f([a + h * b for a, b in zip(x0, v)]))
        fm = float(f([a - h * b for a, b in zip(x0, v)]))
    fd = (fp - fm) / (2.0 * h)
    denom = max(abs(fd), abs(ad), abs_floor)
    assert abs(ad - fd) / denom < rel_tol, (ad, fd)
    assert abs(ad) > abs_floor, "gradient is numerically zero — vacuous test"


def _env_fn(arrays, cfg, meta, origin, direction, key):
    return lambda p: _loss(arrays._replace(env_rgb=V3(*p)), cfg, meta,
                           origin, direction, key)


def _atlas_fn(arrays, cfg, meta, origin, direction, key):
    return lambda p: _loss(arrays._replace(atlas_r=p[0], atlas_g=p[1],
                                           atlas_b=p[2]),
                           cfg, meta, origin, direction, key)


def _emit_fn(arrays, cfg, meta, origin, direction, key):
    return lambda p: _loss(arrays._replace(emit=V3(*p)), cfg, meta, origin,
                           direction, key)


def _atlas_mask(arrays, meta):
    """Zero over the metallicRoughness and normal-map layers: both move the
    detached lobe-select threshold (see test_fd_atlas)."""
    r = meta.atlas_res
    mask = np.ones(arrays.atlas_r.shape[0], np.float32)
    lobe_moving = np.concatenate([np.asarray(arrays.map_mr),
                                  np.asarray(arrays.map_n)])
    for layer in np.unique(lobe_moving):
        mask[layer * r * r:(layer + 1) * r * r] = 0.0
    return torch.from_numpy(mask)


def test_fd_env_map(setup):
    scene, arrays, cfg, origin, direction, key = setup
    f = _env_fn(arrays, cfg, scene.meta, origin, direction, key)
    _check_directional(f, tuple(arrays.env_rgb), seed=1, h=5e-3,
                       rel_tol=2e-2)


def test_fd_env_map_nearest_fusion(setup):
    """Gradients also flow through the nearest-texel env path
    (nee_env_nearest / escape_env_nearest, the production configuration):
    the loss is piecewise linear in the texels there."""
    scene, arrays, cfg, origin, direction, key = setup
    cfgn = dataclasses.replace(cfg, nee_env_nearest=True,
                               escape_env_nearest=True)
    f = _env_fn(arrays, cfgn, scene.meta, origin, direction, key)
    _check_directional(f, tuple(arrays.env_rgb), seed=2, h=5e-3,
                       rel_tol=2e-2)


def test_fd_atlas(setup):
    """Atlas texels, excluding the metallicRoughness and normal-map layers
    (they move the detached lobe choice, so FD measures flips AD ignores);
    operating point shifted +0.1 so no excursion crosses the clip at 0."""
    scene, arrays, cfg, origin, direction, key = setup
    f = _atlas_fn(arrays, cfg, scene.meta, origin, direction, key)
    x0 = (arrays.atlas_r + 0.1, arrays.atlas_g + 0.1, arrays.atlas_b + 0.1)
    _check_directional(f, x0, seed=2, h=2e-3, rel_tol=4e-2,
                       v_mask=_atlas_mask(arrays, scene.meta))


def test_fd_atlas_fetch_vjp(setup):
    """atlas_fetch_rgb alone, every layer kind, coordinates outside [0, 1)
    for the REPEAT wrap: exactly linear in the texels, so AD and FD agree
    to float32 rounding."""
    scene, arrays, cfg, origin, direction, key = setup
    meta = scene.meta
    r = np.random.default_rng(7)
    m = 257
    n_layers = arrays.atlas_r.shape[0] // (meta.atlas_res ** 2)
    layer = torch.from_numpy(r.integers(0, n_layers, m).astype(np.int32))
    u = torch.from_numpy(r.uniform(-0.5, 1.5, m).astype(np.float32))
    v = torch.from_numpy(r.uniform(-0.5, 1.5, m).astype(np.float32))
    w = torch.from_numpy(r.standard_normal((3, m)).astype(np.float32))

    def f(planes):
        out = atlas_fetch_rgb(meta, layer, u, v, torch.stack(planes, -1))
        return torch.mean(w[0] * out.x + w[1] * out.y + w[2] * out.z)

    x0 = (arrays.atlas_r, arrays.atlas_g, arrays.atlas_b)
    _check_directional(f, x0, seed=9, h=1e-2, rel_tol=1e-3)


def _emit_x0(arrays):
    # positive operating point: at emit=0 the clip at 0 sits on the point
    base = torch.full_like(arrays.emit.x, 0.2)
    return (base, base, base)


def test_fd_emittance(setup):
    scene, arrays, cfg, origin, direction, key = setup
    f = _emit_fn(arrays, cfg, scene.meta, origin, direction, key)
    # radiance is exactly linear in constant emittance -> tight tolerance
    _check_directional(f, _emit_x0(arrays), seed=3, h=5e-3, rel_tol=1e-2)


def _all_miss(env, seed, **cfg_kw):
    scene = make_test_scene(subdivisions=1, env=env)
    key = rng.sample_key(rng.key(seed), 0)
    return (scene, scene.to_torch("cpu"), _cfg(bounces=1, **cfg_kw), key,
            rng.stream_uniforms(key, 0, (4, N)))


def _cam_dir_fn(arrays, cfg, meta, key, cam_u):
    pos = torch.tensor(ALL_MISS_POS)

    def f(p):
        origin, direction = generate_rays(pos, p[0], 0.2, 1e6, 0.0,
                                          (SIZE, SIZE), cam_u)
        return _loss(arrays, cfg, meta, origin, direction, key)
    return f


def test_fd_camera_direction_all_miss():
    """Camera direction on an all-miss scene: radiance = env(dir(cam)) is
    smooth; the view points away from the procedural sun disk."""
    scene, arrays, cfg, key, cam_u = _all_miss("sky", 12)
    f = _cam_dir_fn(arrays, cfg, scene.meta, key, cam_u)
    _check_directional(f, (torch.tensor(ALL_MISS_DIR),), seed=4, h=5e-4,
                       rel_tol=3e-2)


def test_fd_camera_lens_all_miss():
    """Aperture and focal depth on an all-miss scene under the smooth
    gradient env: the thin-lens offset moves ray directions smoothly."""
    scene, arrays, cfg, key, cam_u = _all_miss("gradient", 13)
    pos = torch.tensor(ALL_MISS_POS)
    view_dir = torch.tensor(ALL_MISS_DIR)

    def f(lens):
        aperture, focal_depth = lens
        origin, direction = generate_rays(pos, view_dir, 0.2, focal_depth,
                                          aperture, (SIZE, SIZE), cam_u)
        return _loss(arrays, cfg, scene.meta, origin, direction, key)

    x0 = (torch.tensor(0.3), torch.tensor(2.0))
    _check_directional(f, x0, seed=5, h=5e-3, rel_tol=3e-2)


def test_fd_camera_position_light_nee():
    """Camera position: it cancels out of ray directions and t is detached,
    so the gradient flows through the light-NEE geometry (hit_p moves with
    the camera).  The probe moves the camera parallel to the flat,
    untextured floor (v_mask zeroes y), so FD sees no change of t."""
    scene = make_test_scene(subdivisions=1, env="gradient", textured=False,
                            emissive_sphere=True)
    arrays = scene.to_torch("cpu")
    cfg = _cfg(bounces=1, use_light_nee=True)
    key = rng.sample_key(rng.key(14), 0)
    cam_u = rng.stream_uniforms(key, 0, (4, N))
    view_dir = torch.tensor((0.0, -0.8, -0.6))

    def f(p):
        origin, direction = generate_rays(p[0], view_dir, 0.3, 1e6, 0.0,
                                          (SIZE, SIZE), cam_u)
        return _loss(arrays, cfg, scene.meta, origin, direction, key)

    _check_directional(f, (torch.tensor((0.9, 0.9, 2.0)),), seed=6, h=2e-3,
                       rel_tol=4e-2, v_mask=torch.tensor((1.0, 0.0, 1.0)))


def test_camera_f32_keeps_the_graph():
    """generate_rays takes a float32 tensor on the rays' device as it is
    (core/camera.py _f32), so a camera leaf stays in the graph."""
    from fspt_tpu_torch.core.camera import _f32
    for value in (torch.tensor((0.3, 0.5, -0.8)), torch.tensor(2.0)):
        leaf = value.requires_grad_(True)
        assert _f32(leaf, leaf.device) is leaf


@pytest.mark.parametrize("sort_state", [True, False])
def test_fd_env_map_main_path(sort_state):
    """The env-map check on the main path's configuration at 64x64:
    "split" (the plain version), compaction that really shrinks (4,096 ->
    1,024 lanes after bounce 0), nearest env lookups, and either the state
    sort or the launch sort with its un-permuting write, so the gradient
    crosses _take's row gathers, sorted_intersect's write of detached hits
    and _deposit's single write of every lane."""
    size = 64
    scene = make_test_scene(subdivisions=1, textured=True)
    arrays = scene.to_torch("cpu")
    cfg = RenderConfig(width=size, height=size, bounces=3,
                       intersector="split", compact=True,
                       compact_schedule=(1, 4), sort_state=sort_state,
                       nee_env_nearest=True, escape_env_nearest=True)
    key = rng.sample_key(rng.key(11), 0)
    cam = scene.camera
    origin, direction = generate_rays(
        torch.tensor(cam.position), torch.tensor(cam.direction),
        cam.fov_scale, cam.focal_depth, cam.aperture, (size, size),
        rng.stream_uniforms(key, 0, (4, size * size)))
    f = _env_fn(arrays, cfg, scene.meta, origin, direction, key)
    _check_directional(f, tuple(arrays.env_rgb), seed=1, h=5e-3,
                       rel_tol=2e-2)


def test_light_nee_mis_matches_bsdf_only():
    """Unbiasedness of the emitter-hit MIS: with area-light NEE on, the
    multi-sample mean converges to the pure BSDF-sampling image."""
    scene = make_test_scene(subdivisions=1, env="gradient", textured=False,
                            emissive_sphere=True)
    arrays = scene.to_torch("cpu")
    size = 16
    cfg0 = RenderConfig(width=size, height=size, bounces=2,
                        extra_refraction_iters=0, use_light_nee=False,
                        intersector="brute")
    cfg1 = dataclasses.replace(cfg0, use_light_nee=True)
    cam = scene.camera
    m0 = np.zeros(3)
    m1 = np.zeros(3)
    S = 96
    with torch.no_grad():
        for s in range(S):
            key = rng.sample_key(rng.key(21), s)
            cam_u = rng.stream_uniforms(key, 0, (4, size * size))
            origin, direction = generate_rays(
                torch.tensor(cam.position), torch.tensor(cam.direction),
                cam.fov_scale, cam.focal_depth, cam.aperture, (size, size),
                cam_u)
            for cfg, m in ((cfg0, m0), (cfg1, m1)):
                r = trace_paths(arrays, cfg, scene.meta, origin, direction,
                                key)
                m += np.array([float(r.x.mean()), float(r.y.mean()),
                               float(r.z.mean())])
    m0 /= S
    m1 /= S
    assert (m1 > 0).all()
    np.testing.assert_allclose(m1, m0, rtol=0.06)


# ---- the port's gradients against jax.grad of the JAX integrator --------

JAX_CASES = ("env", "atlas", "emit", "camera_dir")
_SCENE_FIELDS = ("env", "atlas", "emit")


def _scene_fn(arrays, cfg, meta, origin, direction, key):
    """The loss of the FD tests' scene as a function of env, atlas and
    emit planes at once (9 leaves)."""
    def f(p):
        a = arrays._replace(env_rgb=V3(*p[0:3]), atlas_r=p[3], atlas_g=p[4],
                            atlas_b=p[5], emit=V3(*p[6:9]))
        return _loss(a, cfg, meta, origin, direction, key)
    return f


@pytest.fixture(scope="module")
def jax_grads():
    """jax.grad of the reference's loss, and the numpy inputs it was taken
    at: one gradient w.r.t. env, atlas and emit together (the atlas at
    +0.1 and the emittance at 0.2, the FD tests' points; one compile
    instead of three), and the all-miss camera direction."""
    import jax
    import jax.numpy as jnp

    from fspt_tpu.config import RenderConfig as JCfg
    from fspt_tpu.core.camera import generate_rays as jrays
    from fspt_tpu.core.integrator import trace_paths as jtrace
    from fspt_tpu.core.rng import sample_key, stream_uniforms
    from fspt_tpu.core.vec import V3 as JV3
    from fspt_tpu.testing import make_test_scene as jscene

    def jloss(arrays, cfg, meta, o, d, key):
        r = jtrace(arrays, cfg, meta, o, d, key)
        return (jnp.mean(r.x) + jnp.mean(r.y) + jnp.mean(r.z)) / 3.0

    jcfg = lambda b: JCfg(width=SIZE, height=SIZE, bounces=b,
                          extra_refraction_iters=0, intersector="brute")
    s = jscene(**SCENE_KW)
    a = s.device_arrays()
    key = sample_key(jax.random.key(11), 0)
    cam = s.camera
    o, d = jrays(jnp.asarray(cam.position), jnp.asarray(cam.direction),
                 cam.fov_scale, cam.focal_depth, cam.aperture, (SIZE, SIZE),
                 stream_uniforms(key, 0, (4, N)))

    def scene_loss(p):
        arr = a._replace(env_rgb=JV3(*p[0:3]), atlas_r=p[3], atlas_g=p[4],
                         atlas_b=p[5], emit=JV3(*p[6:9]))
        return jloss(arr, jcfg(2), s.meta, o, d, key)

    base = jnp.full_like(a.emit.x, 0.2)
    x_scene = (a.env_rgb.x, a.env_rgb.y, a.env_rgb.z, a.atlas_r + 0.1,
               a.atlas_g + 0.1, a.atlas_b + 0.1, base, base, base)
    sm = jscene(subdivisions=1, env="sky")
    am = sm.device_arrays()
    kmiss = sample_key(jax.random.key(12), 0)
    u_miss = stream_uniforms(kmiss, 0, (4, N))

    def cam_dir(p):
        om, dm = jrays(jnp.asarray(ALL_MISS_POS, jnp.float32), p[0], 0.2,
                       1e6, 0.0, (SIZE, SIZE), u_miss)
        return jloss(am, jcfg(1), sm.meta, om, dm, kmiss)

    out = {}
    for name, f, x0 in (("scene", scene_loss, x_scene),
                        ("camera_dir", cam_dir,
                         (jnp.asarray(ALL_MISS_DIR, jnp.float32),))):
        g = jax.jit(jax.grad(f))(x0)
        out[name] = ([np.asarray(x) for x in x0], [np.asarray(x) for x in g])
    return out


@pytest.mark.parametrize("case", JAX_CASES)
def test_grad_matches_jax(jax_grads, case):
    if case == "camera_dir":
        x0_np, g_jax = jax_grads[case]
        scene, arrays, cfg, key, cam_u = _all_miss("sky", 12)
        f = _cam_dir_fn(arrays, cfg, scene.meta, key, cam_u)
        part = slice(0, 1)
    else:
        x0_np, g_jax = jax_grads["scene"]
        scene = make_test_scene(**SCENE_KW)
        arrays = scene.to_torch("cpu")
        key = rng.sample_key(rng.key(11), 0)
        origin, direction = _cam_rays(scene.camera, key)
        f = _scene_fn(arrays, _cfg(), scene.meta, origin, direction, key)
        k = _SCENE_FIELDS.index(case)
        part = slice(3 * k, 3 * k + 3)
    x0 = tuple(torch.from_numpy(np.array(x)) for x in x0_np)
    g = np.concatenate([x.numpy().reshape(-1)
                        for x in _grad(f, x0)[part]]).astype(np.float64)
    gj = np.concatenate([x.reshape(-1)
                         for x in g_jax[part]]).astype(np.float64)
    cos = g @ gj / (np.linalg.norm(g) * np.linalg.norm(gj))
    assert cos >= 0.999, cos
    r = np.random.default_rng(100)
    for _ in range(4):
        v = r.standard_normal(g.shape)
        a, b = g @ v, gj @ v
        assert abs(a - b) / max(abs(a), abs(b), 1e-12) < 2e-3, (a, b)
