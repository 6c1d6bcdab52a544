"""The port's on-device BVH refit (fspt_tpu_torch.scene.refit) and
render_animation's refit path, on the CPU.

The first five tests are tests/test_refit.py's, on the port with the
reference's bounds: the port's refit against the port's own host rebuild.
The rest hold `refit_arrays` to the JAX package's jitted `refit_arrays` on
the same base scene and the same delta affines (geometry, boxes and packed
tables within atol 1e-6, the light CDF and area within rtol 1e-6: XLA's CPU
backend fuses multiply-adds, the port does not; integer fields and the
carried-over columns equal), its boxes to exactly the min/max of its own
vertices, its base tables to stay untouched, and the `normalize` fallback
of `render_animation` to render by rebuild.
"""

import jax
import numpy as np
import pytest
import torch

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.runtime.renderer import Renderer
from fspt_tpu_torch.scene.refit import (build_refit_aux, delta_affines,
                                        prop_affine, refit_arrays)
from fspt_tpu_torch.scene.schema import (SceneArrays, _prop_defaults,
                                         load_scene_dict, merge_scene_props)
from fspt_tpu_torch.testing import DictAssetLoader, icosphere_obj, quad_obj

torch.set_num_threads(1)


def _loader():
    return DictAssetLoader(
        texts={"sphere.obj": icosphere_obj(1), "floor.obj": quad_obj()})


def _scene_dict(translate, angle=0.0, scale=0.4, emittance=None):
    sd = {
        "environment": [[0.2, 0.2, 0.3], [0.8, 0.9, 1.0]],
        "cameraPos": [0.0, 0.4, 2.2],
        "cameraDir": [0.0, -0.18, -0.98],
        "samples": 8,
        "props": [
            {"path": "floor.obj", "scale": 6.0, "translate": [0, -0.5, 0],
             "diffuse": [0.6, 0.6, 0.6],
             "metallicRoughness": [0.0, 0.6, 0.0], "normals": "flat"},
        ],
        "animated_props": [
            {"path": "sphere.obj", "scale": scale, "translate": translate,
             "rotate": [{"axis": [0, 1, 0], "angle": angle}],
             "diffuse": [0.9, 0.4, 0.3],
             "metallicRoughness": [0.0, 0.3, 0.0], "normals": "smooth"},
        ],
    }
    if emittance is not None:
        sd["animated_props"][0]["emittance"] = emittance
    return sd


def _deltas(base_sd, frame_sd):
    return delta_affines(
        [_prop_defaults(p) for p in merge_scene_props(base_sd)],
        [_prop_defaults(p) for p in merge_scene_props(frame_sd)])


def _identity(scene):
    P = scene.build["n_props"]
    return (np.tile(np.eye(3, dtype=np.float32), (P, 1, 1)),
            np.zeros((P, 3), np.float32))


def _planes(a):
    """A SceneArrays field as one numpy array (V3 fields stacked)."""
    if isinstance(a, tuple):
        return np.stack([np.asarray(x) for x in a])
    return np.asarray(a)


# ---- tests/test_refit.py, on the port -------------------------------------

def test_prop_affine_matches_pipeline():
    """The probed affine must reproduce apply_prop_transforms on points."""
    from fspt_tpu_torch.scene.transforms import apply_prop_transforms
    prop = {"rotate": [{"axis": [0.3, 1.0, 0.2], "angle": 0.7}],
            "scale": 1.7, "translate": [0.2, -0.4, 1.0]}
    A = prop_affine(prop)
    pts = np.random.default_rng(0).normal(size=(50, 3))
    want = apply_prop_transforms(pts, prop["rotate"], prop["scale"],
                                 prop["translate"])
    got = pts @ A[:, :3].T + A[:, 3]
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_refit_identity_reproduces_tables():
    scene = load_scene_dict(_scene_dict([0.0, 0.0, 0.0]), _loader())
    aux = build_refit_aux(scene)
    mats, trans = _identity(scene)
    a = scene.to_torch("cpu")
    out = refit_arrays(a, scene.meta, aux, mats, trans)
    np.testing.assert_array_equal(out.pk_leaves.numpy(), a.pk_leaves.numpy())
    np.testing.assert_allclose(out.pk_nodes.numpy(), a.pk_nodes.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(out.node_min.numpy(), a.node_min.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(out.node_max.numpy(), a.node_max.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(out.nrm0.x.numpy(), a.nrm0.x.numpy(),
                               atol=1e-6)


def test_refit_matches_rebuild_render():
    """Move + spin the animated prop: refit from the base frame must
    render the same image as a full host rebuild of the moved frame."""
    base_sd = _scene_dict([0.0, 0.0, 0.0])
    moved_sd = _scene_dict([0.35, 0.15, -0.2], angle=0.8)
    loader = _loader()
    base = load_scene_dict(base_sd, loader)
    moved = load_scene_dict(moved_sd, loader)

    aux = build_refit_aux(base)
    mats, trans = _deltas(base_sd, moved_sd)
    refit = refit_arrays(base.to_torch("cpu"), base.meta, aux, mats, trans)

    cfg = RenderConfig(width=16, height=16, bounces=2,
                       extra_refraction_iters=0, batch_spp=1, seed=3)
    rb = Renderer(moved, cfg, device="cpu").step(2)
    rr = Renderer(base, cfg, device="cpu")
    rr.arrays = refit
    rr.step(2)
    img_rebuild = rb.hdr_image()
    img_refit = rr.hdr_image()
    assert np.isfinite(img_refit).all()
    # the bounds of tests/test_refit.py: the same estimator up to traversal
    # fp association at silhouette edges
    diff = np.abs(img_refit - img_rebuild)
    assert diff.mean() < 1e-4, diff.mean()
    assert np.quantile(diff, 0.98) < 5e-3
    assert diff.max() < 0.05


def test_refit_rejects_normalized_scenes():
    sd = _scene_dict([0.0, 0.0, 0.0])
    sd["normalize"] = 1.0
    scene = load_scene_dict(sd, _loader())
    with pytest.raises(ValueError, match="normalize"):
        build_refit_aux(scene)


def _keyframed_scene_dict():
    sd = _scene_dict([0.0, 0.0, 0.0])
    sd["animated_props"][0]["keyframes"] = [
        {"frame": 0, "translate": [0.0, 0.0, 0.0]},
        {"frame": 2, "translate": [0.4, 0.2, 0.0],
         "rotate": [{"axis": [0, 1, 0], "angle": 1.0}]},
    ]
    return sd


def _anim_cfg():
    return RenderConfig(width=16, height=16, bounces=2,
                        extra_refraction_iters=0, batch_spp=1, seed=5)


def test_render_animation_refit_matches_rebuild(tmp_path):
    from fspt_tpu_torch.io.image import read_png
    from fspt_tpu_torch.runtime.animation import render_animation
    sd = _keyframed_scene_dict()
    a = render_animation(sd, _loader(), str(tmp_path / "rebuild"),
                         range(2), config=_anim_cfg(), samples=2,
                         device="cpu")
    b = render_animation(sd, _loader(), str(tmp_path / "refit"),
                         range(2), config=_anim_cfg(), samples=2,
                         refit=True, device="cpu")
    for pa, pb in zip(a, b):
        ia = read_png(pa)
        ib = read_png(pb)
        # 8-bit PNGs of the same estimator: at most quantization + the
        # occasional fp-edge sample flip
        assert np.mean(np.abs(ia - ib)) < 2.0 / 255.0
        assert np.quantile(np.abs(ia - ib), 0.99) <= 4.0 / 255.0


# ---- the port's refit against the JAX package's ---------------------------

MOTIONS = {
    "identity": dict(translate=[0.0, 0.0, 0.0]),
    "move_spin_scale": dict(translate=[0.35, 0.15, -0.2], angle=0.8,
                            scale=0.55),
}
EMIT = [3.0, 2.5, 2.0]


@pytest.fixture(scope="module")
def jax_pair():
    """The emissive base scene compiled by both host compilers, and the JAX
    package's jitted refit over it."""
    from fspt_tpu import testing as jax_testing
    from fspt_tpu.scene import refit as jax_refit
    from fspt_tpu.scene.schema import load_scene_dict as jax_load
    base_sd = _scene_dict([0.0, 0.0, 0.0], emittance=EMIT)
    port = load_scene_dict(base_sd, _loader())
    ref = jax_load(base_sd, jax_testing.DictAssetLoader(
        texts={"sphere.obj": icosphere_obj(1), "floor.obj": quad_obj()}))
    jaux = jax_refit.build_refit_aux(ref)
    jarrays = ref.device_arrays()
    jit_refit = jax.jit(lambda m, t: jax_refit.refit_arrays(
        jarrays, ref.meta, jaux, m, t))
    return base_sd, port, jit_refit


@pytest.mark.parametrize("motion", sorted(MOTIONS))
def test_refit_matches_jax(jax_pair, motion):
    base_sd, scene, jit_refit = jax_pair
    assert int(scene.arrays.n_light_tris) > 0
    mats, trans = _deltas(base_sd, _scene_dict(**MOTIONS[motion],
                                               emittance=EMIT))
    out = refit_arrays(scene.to_torch("cpu"), scene.meta,
                       build_refit_aux(scene), mats, trans)
    ref = jit_refit(mats, trans)
    w, ls = scene.meta.bvh_width, scene.leaf_size
    for field in SceneArrays._fields:
        got, want = _planes(getattr(out, field)), _planes(getattr(ref, field))
        assert got.dtype == want.dtype and got.shape == want.shape, field
        if not np.issubdtype(got.dtype, np.floating):
            np.testing.assert_array_equal(got, want, err_msg=field)
        elif field in ("light_cdf", "light_area"):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                       err_msg=field)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=field)
    # the columns refit carries over: links and sort axis, leaf padding
    np.testing.assert_array_equal(out.pk_nodes[:, 6 * w:].numpy(),
                                  np.asarray(ref.pk_nodes)[:, 6 * w:])
    np.testing.assert_array_equal(out.pk_leaves[:, ls * 9:].numpy(),
                                  np.asarray(ref.pk_leaves)[:, ls * 9:])


def test_refit_boxes_are_exact():
    """On its own output, a leaf's box is exactly the min/max of its slots'
    vertices, a parent's exactly the min/max of its children's, and the
    packed child boxes exactly those of the binary nodes they collapse."""
    base_sd = _scene_dict([0.0, 0.0, 0.0])
    scene = load_scene_dict(base_sd, _loader())
    aux = build_refit_aux(scene)
    out = refit_arrays(scene.to_torch("cpu"), scene.meta, aux,
                       *_deltas(base_sd, _scene_dict(**MOTIONS[
                           "move_spin_scale"])))
    v0, e1, e2 = out.tri_v0, out.tri_e1, out.tri_e2
    corners = torch.stack([v0, v0 + e1, v0 + e2], 1)          # (S, 3, 3)
    valid = torch.from_numpy(aux.slot_valid)
    big = 3.0e38
    lo = torch.where(valid[:, None, None], corners, big).amin(1)
    hi = torch.where(valid[:, None, None], corners, -big).amax(1)
    L, ls = len(aux.leaf_ord), aux.leaf_size
    lo, hi = lo.reshape(L, ls, 3).amin(1), hi.reshape(L, ls, 3).amax(1)
    leaf_ids = torch.from_numpy(aux.leaf_ids).long()
    ordn = torch.from_numpy(aux.leaf_ord).long()
    assert torch.equal(out.node_min[leaf_ids], lo[ordn])
    assert torch.equal(out.node_max[leaf_ids], hi[ordn])
    internal = torch.from_numpy(np.concatenate(aux.levels)).long()
    left = out.node_left.long()[internal]
    right = out.node_right.long()[internal]
    assert torch.equal(out.node_min[internal],
                       torch.minimum(out.node_min[left], out.node_min[right]))
    assert torch.equal(out.node_max[internal],
                       torch.maximum(out.node_max[left], out.node_max[right]))
    w = aux.width
    wcb = torch.from_numpy(aux.wide_child_bin).long()
    ok = wcb >= 0
    for k in range(3):
        assert torch.equal(out.pk_nodes[:, k * w:(k + 1) * w][ok],
                           out.node_min[wcb[ok], k])
        assert torch.equal(out.pk_nodes[:, (3 + k) * w:(4 + k) * w][ok],
                           out.node_max[wcb[ok], k])


def test_refit_leaves_base_intact():
    """Refit, refit again with other matrices, then identity: the base
    tables are never written, and identity gives them back."""
    base_sd = _scene_dict([0.0, 0.0, 0.0])
    scene = load_scene_dict(base_sd, _loader())
    aux = build_refit_aux(scene)
    a = scene.to_torch("cpu")
    before = {f: _planes(getattr(a, f)).copy() for f in SceneArrays._fields}
    for motion in (dict(translate=[0.3, 0.0, 0.1], angle=0.5),
                   dict(translate=[-0.2, 0.1, 0.0], angle=-1.2, scale=0.6)):
        moved = refit_arrays(a, scene.meta, aux,
                             *_deltas(base_sd, _scene_dict(**motion)))
        assert not torch.equal(moved.pk_leaves, a.pk_leaves)
    for f in SceneArrays._fields:
        assert before[f].tobytes() == _planes(getattr(a, f)).tobytes(), f
    out = refit_arrays(a, scene.meta, aux, *_identity(scene))
    np.testing.assert_array_equal(out.pk_leaves.numpy(), before["pk_leaves"])
    np.testing.assert_allclose(out.pk_nodes.numpy(), before["pk_nodes"],
                               atol=1e-5)
    np.testing.assert_allclose(out.node_min.numpy(), before["node_min"],
                               atol=1e-5)
    np.testing.assert_allclose(out.node_max.numpy(), before["node_max"],
                               atol=1e-5)


def test_render_animation_normalize_renders_by_rebuild(tmp_path,
                                                      monkeypatch):
    """A `normalize` scene cannot be refit (its frames recenter and rescale
    from their own bounds): render_animation(refit=True) falls back to the
    per-frame rebuild, as the reference does, and gives its frames."""
    from fspt_tpu_torch.scene import refit as refit_mod
    from fspt_tpu_torch.runtime.animation import render_animation

    def no_refit(*a, **k):
        raise AssertionError("refit_arrays called on a normalize scene")

    monkeypatch.setattr(refit_mod, "refit_arrays", no_refit)
    sd = dict(_keyframed_scene_dict(), normalize=1.0)
    a = render_animation(sd, _loader(), str(tmp_path / "rebuild"),
                         range(2), config=_anim_cfg(), samples=1,
                         device="cpu")
    b = render_animation(sd, _loader(), str(tmp_path / "refit"),
                         range(2), config=_anim_cfg(), samples=1,
                         refit=True, device="cpu")
    for pa, pb in zip(a, b):
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read()
