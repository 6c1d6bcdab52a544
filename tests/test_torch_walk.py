"""The port's group-walk traversal (fspt_tpu_torch.ops.traverse3 and
ops.traverse), its geometry primitives and its per-ray BVH walk
(core/geometry, core/traversal) against the JAX package.

On the CPU the group walks run their plain PyTorch version; against the
JAX package's Pallas kernels (interpret mode) they must find the same hits
— equal slots, t/u/v within rtol 1e-5 / atol 1e-6 (the same float32
operations in the same order; XLA may round a product-sum otherwise) — and
the same `visits`, which are per group (128 rays for v3, 1024 for v1).
The one known divergence is the group's majority direction sign: the port
sums a group's directions in a fixed pairwise-halving order, XLA in its
own, so a group whose sum lies within rounding of 0 may walk its nodes in
another order.  The tests compute each group's sums in float64 and compare
`visits` only for groups whose smallest |sum| is at least 1e-3, and assert
that fewer than 2% of groups are set aside that way.

The JAX kernels take ~2-13 s each in interpret mode, so their results are
computed once per module.  On a machine with a card, the CUDA kernels must
match the plain versions bit for bit (marked `cuda`; skipped here); that
machine has no JAX, so JAX is imported only inside the tests that use it,
and the card runs this file as
    python -m pytest --noconftest -m cuda tests/test_torch_walk.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fspt_tpu_torch.core import geometry as geo
from fspt_tpu_torch.core.traversal import (intersect_scene,
                                           intersect_scene_brute, occluded)
from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.ops import packing
from fspt_tpu_torch.ops.traverse import (packet_traverse,
                                         packet_traverse_reference)
from fspt_tpu_torch.ops.traverse3 import (packet_traverse3,
                                          packet_traverse3_reference)
from fspt_tpu_torch.scene.bvh import triangle_aabbs
from fspt_tpu_torch.scene.fastbvh import build_bvh_fast
from fspt_tpu_torch.scene.schema import scene_to_torch

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
N = 1024
GROUPS = {"walk": 128, "packet": 1024}
PORT = {"walk": packet_traverse3, "packet": packet_traverse}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def setup():
    """400 random triangles packed 8- and 16-wide, 1024 random rays and a
    per-ray tmax (tests/test_fastbvh.py's kernel parity setup): even rays
    keep MAX_T, odd rays are clipped to 0.05-1.5."""
    rng = np.random.default_rng(42)
    centers = rng.uniform(-1, 1, size=(400, 1, 3))
    verts = (centers + rng.normal(size=(400, 3, 3)) * 0.05).astype(np.float32)
    tmin, tmax = triangle_aabbs(verts)
    bvh = build_bvh_fast(tmin, tmax, leaf_size=8)
    gather = np.where(bvh.slot_tri < 0, 0, bvh.slot_tri)
    v = verts[gather]
    v[bvh.slot_tri < 0] = 0.0
    pks = {w: packing.pack_bvh(bvh.left, bvh.right, bvh.tri_offset,
                               bvh.node_min, bvh.node_max, v[:, 0],
                               v[:, 1] - v[:, 0], v[:, 2] - v[:, 0],
                               leaf_size=8, width=w)
           for w in (8, 16)}
    o = rng.uniform(-2, 2, size=(3, N)).astype(np.float32)
    d = rng.normal(size=(3, N)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    tm = rng.uniform(0.05, 1.5, size=N).astype(np.float32)
    tm[::2] = 1.0e5
    return pks, o, d, tm


def _stack(pk, width):
    return width * (pk.depth + 2)


@pytest.fixture(scope="module")
def pallas(setup):
    """JAX kernel results by (impl, width, any_hit, lane_counts), computed
    on first use."""
    pks, o, d, tm = setup
    cache = {}

    def get(impl, width=8, any_hit=False, lane_counts=False):
        key = (impl, width, any_hit, lane_counts)
        if key not in cache:
            import jax.numpy as jnp
            from fspt_tpu.core.vec import V3 as JV3
            from fspt_tpu.ops.traverse import packet_traverse as j1
            from fspt_tpu.ops.traverse3 import packet_traverse3 as j3
            pk = pks[width]
            kw = dict(leaf_size=8, stack_depth=_stack(pk, width),
                      any_hit=any_hit, interpret=True)
            if impl == "walk":
                kw.update(tree_width=width, lane_counts=lane_counts)
            hit = (j3 if impl == "walk" else j1)(
                jnp.asarray(pk.nodes), jnp.asarray(pk.leaves),
                JV3(*map(jnp.asarray, o)), JV3(*map(jnp.asarray, d)),
                jnp.asarray(tm), **kw)
            cache[key] = [np.asarray(x) for x in hit]
        return cache[key]
    return get


def _port(setup, impl, width=8, device="cpu", reference=False, **kw):
    pks, o, d, tm = setup
    pk = pks[width]
    if impl == "walk":
        fn = packet_traverse3_reference if reference else packet_traverse3
        kw["tree_width"] = width
    else:
        fn = packet_traverse_reference if reference else packet_traverse
    t = lambda a: _t(a).to(device)
    return fn(t(pk.nodes), t(pk.leaves), V3(*map(t, o)), V3(*map(t, d)),
              t(tm), leaf_size=8, stack_depth=_stack(pk, width), **kw)


def _steady_groups(d, group):
    """Groups whose direction sums (float64) are all at least 1e-3 away
    from 0, as a per-lane mask; fewer than 2% of groups may fall short."""
    sums = np.abs(d.astype(np.float64).reshape(3, -1, group).sum(axis=2))
    steady = sums.min(axis=0) >= 1e-3
    assert steady.mean() > 0.98, steady.mean()
    return np.repeat(steady, group)


def _assert_hits(ours, ref, lanes=slice(None)):
    np.testing.assert_array_equal(ours.slot.cpu().numpy()[lanes],
                                  ref[1][lanes])
    for i, f in ((0, "t"), (2, "u"), (3, "v")):
        np.testing.assert_allclose(getattr(ours, f).cpu().numpy()[lanes],
                                   ref[i][lanes], **TOL)


@pytest.mark.parametrize("impl", ["walk", "packet"])
@pytest.mark.parametrize("clip", ["max_t", "per_ray_tmax"])
def test_nearest_hit_matches_pallas_kernel(setup, pallas, impl, clip):
    lanes = slice(0, None, 2) if clip == "max_t" else slice(1, None, 2)
    ours = _port(setup, impl)
    ref = pallas(impl)
    assert (ours.slot[lanes] >= 0).sum() > 5       # the rays do hit things
    _assert_hits(ours, ref, lanes)


@pytest.mark.parametrize("impl", ["walk", "packet"])
def test_visits_per_group_match_pallas_kernel(setup, pallas, impl):
    group = GROUPS[impl]
    ours = _port(setup, impl).visits.numpy()
    ref = pallas(impl)[4]
    steady = _steady_groups(setup[2], group)
    np.testing.assert_array_equal(ours[steady], ref[steady])
    # one count per group, shared by its rays
    assert (ours.reshape(-1, group) == ours[::group, None]).all()
    assert ours.min() >= 1


@pytest.mark.parametrize("impl", ["walk", "packet"])
def test_any_hit_matches_pallas_kernel(setup, pallas, impl):
    ours = _port(setup, impl, any_hit=True)
    ref = pallas(impl, any_hit=True)
    np.testing.assert_array_equal(ours.slot.numpy() >= 0, ref[1] >= 0)
    steady = _steady_groups(setup[2], GROUPS[impl])
    np.testing.assert_array_equal(ours.visits.numpy()[steady],
                                  ref[4][steady])
    near = _port(setup, impl)
    np.testing.assert_array_equal(ours.slot.numpy() >= 0,
                                  near.slot.numpy() >= 0)
    assert (ours.visits <= near.visits).all()


def test_lane_counts_match_pallas_kernel(setup, pallas):
    ours = _port(setup, "walk", lane_counts=True)
    ref = pallas("walk", lane_counts=True)
    _assert_hits(ours, ref)
    steady = _steady_groups(setup[2], GROUPS["walk"])
    np.testing.assert_array_equal(ours.visits.numpy()[steady],
                                  ref[4][steady])
    # per-lane counts vary within a group; every ray counts the root
    counts = ours.visits.numpy().reshape(-1, GROUPS["walk"])
    assert (counts.std(axis=1) > 0).mean() > 0.5
    assert counts.min() >= 1


def test_width16_matches_pallas_kernel(setup, pallas):
    ours = _port(setup, "walk", width=16)
    ref = pallas("walk", width=16)
    _assert_hits(ours, ref)
    steady = _steady_groups(setup[2], GROUPS["walk"])
    np.testing.assert_array_equal(ours.visits.numpy()[steady],
                                  ref[4][steady])
    # the 16-wide tables find the 8-wide tables' hits
    eight = _port(setup, "walk", width=8)
    np.testing.assert_array_equal(ours.slot.numpy(), eight.slot.numpy())
    np.testing.assert_allclose(ours.t.numpy(), eight.t.numpy(), **TOL)


def test_table_hbm_changes_nothing(setup):
    a = _port(setup, "walk")
    b = _port(setup, "walk", table_hbm=True)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    with pytest.raises(ValueError, match="lane_counts"):
        _port(setup, "walk", table_hbm=True, lane_counts=True)


@pytest.mark.parametrize("impl", ["walk", "packet"])
def test_undersized_stack_raises(setup, impl):
    pks, o, d, tm = setup
    pk = pks[8]
    with pytest.raises(RuntimeError, match="stack overflow"):
        PORT[impl](_t(pk.nodes), _t(pk.leaves), V3(*map(_t, o)),
                   V3(*map(_t, d)), leaf_size=8, stack_depth=3)


@pytest.mark.parametrize("impl", ["walk", "packet"])
def test_plain_version_does_not_count_launches(setup, impl):
    before = PORT[impl].launches
    _port(setup, impl)
    assert PORT[impl].launches == before


def test_walk_rejects_other_tree_widths(setup):
    pks, o, d, _ = setup
    with pytest.raises(ValueError, match="tree_width"):
        packet_traverse3(_t(pks[8].nodes), _t(pks[8].leaves),
                         V3(*map(_t, o)), V3(*map(_t, d)), tree_width=4)


# ---- ports of tests/test_bvh.py:90-146 (brute parity, any-hit) ----------

@pytest.fixture(scope="module")
def small():
    from fspt_tpu_torch.testing import make_test_scene
    s = make_test_scene(subdivisions=2)
    return s, scene_to_torch(s.arrays, "cpu")


@pytest.mark.parametrize("impl", ["packet", "walk"])
def test_packet_traverse_matches_brute(small, impl):
    _, a = small
    rng = np.random.default_rng(11)
    n = 2048
    o = rng.uniform(-2, 2, size=(3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    hit = PORT[impl](a.pk_nodes, a.pk_leaves, V3(*map(_t, o)),
                     V3(*map(_t, d)), leaf_size=8)
    brt = intersect_scene_brute(a, _t(o.T), _t(d.T))
    np.testing.assert_array_equal(hit.slot.numpy(), brt.slot.numpy())
    hits = hit.slot.numpy() >= 0
    assert hits.sum() > 100
    np.testing.assert_allclose(hit.t.numpy()[hits], brt.t.numpy()[hits],
                               rtol=1e-5)
    # barycentrics reconstruct the hit point
    gi = np.maximum(hit.slot.numpy(), 0)
    v0, e1, e2 = (x.numpy()[gi] for x in (a.tri_v0, a.tri_e1, a.tri_e2))
    p_bary = (v0 + hit.u.numpy()[:, None] * e1
              + hit.v.numpy()[:, None] * e2)
    p_ray = o.T + d.T * hit.t.numpy()[:, None]
    assert np.abs(p_bary - p_ray)[hits].max() < 1e-3


@pytest.mark.parametrize("impl", ["packet", "walk"])
def test_packet_any_hit_matches_occlusion(small, impl):
    _, a = small
    rng = np.random.default_rng(12)
    n = 1024
    o = rng.uniform(-1, 1, size=(3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    hit = PORT[impl](a.pk_nodes, a.pk_leaves, V3(*map(_t, o)),
                     V3(*map(_t, d)), leaf_size=8, any_hit=True)
    brt = intersect_scene_brute(a, _t(o.T), _t(d.T))
    np.testing.assert_array_equal(hit.slot.numpy() >= 0,
                                  brt.slot.numpy() >= 0)
    np.testing.assert_array_equal(
        occluded(a, _t(o.T), _t(d.T), leaf_size=8).numpy(),
        brt.slot.numpy() >= 0)


# ---- core/traversal.intersect_scene against the JAX version -------------

def _scene_rays(kind):
    if kind == "random":
        rng = np.random.default_rng(7)
        o = rng.uniform(-2, 2, size=(256, 3)).astype(np.float32)
        d = rng.normal(size=(256, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return o, d
    # axis-aligned rays exercise the inv-dir guards (zero components)
    o = np.array([[0.0, 0.0, 2.0], [0.0, 2.0, 0.0], [2.0, 0.0, 0.0]],
                 np.float32)
    d = np.array([[0.0, 0.0, -1.0], [0.0, -1.0, 0.0], [-1.0, 0.0, 0.0]],
                 np.float32)
    return o, d


@pytest.mark.parametrize("kind", ["random", "axis_aligned"])
def test_intersect_scene_matches_jax(small, kind):
    import jax.numpy as jnp
    from fspt_tpu.core.traversal import intersect_scene as jax_walk
    s, a = small
    o, d = _scene_rays(kind)
    fields = ("node_left", "node_right", "node_tri", "node_min", "node_max",
              "tri_v0", "tri_e1", "tri_e2")
    arrays = SimpleNamespace(**{f: jnp.asarray(getattr(s.arrays, f))
                                for f in fields})
    ref = jax_walk(arrays, jnp.asarray(o), jnp.asarray(d), leaf_size=8)
    ours = intersect_scene(a, _t(o), _t(d), leaf_size=8)
    np.testing.assert_array_equal(ours.slot.numpy(), np.asarray(ref.slot))
    np.testing.assert_array_equal(ours.visits.numpy(),
                                  np.asarray(ref.visits))
    np.testing.assert_allclose(ours.t.numpy(), np.asarray(ref.t), **TOL)
    brt = intersect_scene_brute(a, _t(o), _t(d))
    np.testing.assert_allclose(ours.t.numpy(), brt.t.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_intersect_scene_undersized_stack_raises(small):
    _, a = small
    o, d = _scene_rays("random")
    with pytest.raises(RuntimeError, match="stack overflow"):
        intersect_scene(a, _t(o), _t(d), leaf_size=8, stack_depth=2)


# ---- ports of tests/test_geometry.py ------------------------------------

def _tri():
    return (torch.tensor([[0.0, 0.0, 0.0]]), torch.tensor([[1.0, 0.0, 0.0]]),
            torch.tensor([[0.0, 1.0, 0.0]]))


def test_tri_hit_distance():
    t = geo.intersect_tri(torch.tensor([[0.25, 0.25, 1.0]]),
                          torch.tensor([[0.0, 0.0, -1.0]]), *_tri())
    np.testing.assert_allclose(t.numpy(), [1.0], rtol=1e-6)


def test_tri_miss_outside_barycentric():
    t = geo.intersect_tri(torch.tensor([[2.0, 2.0, 1.0]]),
                          torch.tensor([[0.0, 0.0, -1.0]]), *_tri())
    assert float(t[0]) == geo.MAX_T


def test_tri_parallel_and_behind():
    parallel = geo.intersect_tri(torch.tensor([[0.0, 0.0, 1.0]]),
                                 torch.tensor([[1.0, 0.0, 0.0]]), *_tri())
    behind = geo.intersect_tri(torch.tensor([[0.25, 0.25, -1.0]]),
                               torch.tensor([[0.0, 0.0, -1.0]]), *_tri())
    assert float(parallel[0]) == geo.MAX_T and float(behind[0]) == geo.MAX_T


def test_degenerate_triangle_is_finite_miss():
    z = torch.zeros((1, 3))
    t = geo.intersect_tri(torch.tensor([[0.0, 0.0, 1.0]]),
                          torch.tensor([[0.0, 0.0, -1.0]]), z, z, z)
    assert np.isfinite(float(t[0])) and float(t[0]) == geo.MAX_T


def test_aabb_entry_distance_and_inside():
    inv = 1.0 / torch.tensor([[1e-20, 1e-20, -1.0]])
    bmin = torch.tensor([[-1.0, -1.0, -1.0]])
    bmax = torch.tensor([[1.0, 1.0, 1.0]])
    t = geo.intersect_aabb(torch.tensor([[0.0, 0.0, 2.0]]), inv, bmin, bmax)
    np.testing.assert_allclose(t.numpy(), [1.0], rtol=1e-5)
    # origin inside the box -> negative tmin, still a hit (tmax > 0)
    t2 = geo.intersect_aabb(torch.tensor([[0.0, 0.0, 0.0]]), inv, bmin,
                            bmax)
    assert float(t2[0]) < 0.0


def test_aabb_miss():
    inv = 1.0 / torch.tensor([[0.0, 0.0, -1.0]])
    t = geo.intersect_aabb(torch.tensor([[5.0, 5.0, 2.0]]), inv,
                           torch.tensor([[-1.0, -1.0, -1.0]]),
                           torch.tensor([[1.0, 1.0, 1.0]]))
    assert float(t[0]) == geo.MAX_T


def test_barycentric_weights_reconstruct_point():
    rng = np.random.default_rng(3)
    v0, e1, e2 = (rng.normal(size=(8, 3)).astype(np.float32)
                  for _ in range(3))
    u = rng.uniform(0, 1, size=(8, 1)).astype(np.float32) * 0.5
    v = rng.uniform(0, 1, size=(8, 1)).astype(np.float32) * 0.5
    p = v0 + u * e1 + v * e2
    w = geo.barycentric_weights(*map(_t, (p, v0, e1, e2))).numpy()
    np.testing.assert_allclose(w[:, 1:2], u, atol=1e-4)
    np.testing.assert_allclose(w[:, 2:3], v, atol=1e-4)
    np.testing.assert_allclose(w.sum(axis=1), np.ones(8), atol=1e-5)


def test_brute_force_nearest():
    # two parallel triangles: the nearer wins
    v0 = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 0.5]])
    e1 = torch.tensor([[1.0, 0.0, 0.0]] * 2)
    e2 = torch.tensor([[0.0, 1.0, 0.0]] * 2)
    t, idx = geo.brute_force_intersect(torch.tensor([[0.25, 0.25, 1.0]]),
                                       torch.tensor([[0.0, 0.0, -1.0]]),
                                       v0, e1, e2)
    np.testing.assert_allclose(t.numpy(), [0.5], rtol=1e-6)
    assert int(idx[0]) == 1


def test_brute_force_matches_jax(small):
    import jax.numpy as jnp
    from fspt_tpu.core.geometry import brute_force_intersect
    s, a = small
    o, d = _scene_rays("random")
    rt, rs = brute_force_intersect(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(s.arrays.tri_v0),
                                   jnp.asarray(s.arrays.tri_e1),
                                   jnp.asarray(s.arrays.tri_e2))
    t, slot = geo.brute_force_intersect(_t(o), _t(d), a.tri_v0, a.tri_e1,
                                        a.tri_e2)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(rs))
    np.testing.assert_allclose(t.numpy(), np.asarray(rt), **TOL)


# ---- the CUDA kernels against their plain versions (on a card) ----------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["walk", "walk-any", "walk-lanes",
                                  "walk-w16", "packet", "packet-any"])
def test_cuda_kernel_bit_exact_vs_plain(setup, cuda_device, case):
    from fspt_tpu_torch.ops.traverse import check_stack_overflow
    impl, _, opt = case.partition("-")
    kw = {"any": dict(any_hit=True), "lanes": dict(lane_counts=True),
          "w16": dict(width=16), "": {}}[opt]
    before = PORT[impl].launches
    ours = _port(setup, impl, device=cuda_device, **kw)
    torch.cuda.synchronize()
    check_stack_overflow(cuda_device)
    assert PORT[impl].launches == before + 1
    ref = _port(setup, impl, device=cuda_device, reference=True, **kw)
    for f in ours._fields:
        assert torch.equal(getattr(ours, f), getattr(ref, f)), f
