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


# ---- the edges a thread-to-ray mapping can break -------------------------
# Lane counts around a group (128) and a packet (1024), a launch with no
# live lane, any-hit, width 16, and a stack one entry short.  The packet
# kernel lays a packet on a thread block cluster (csrc/walk1.cu: 8 blocks of
# 128 rays), so it also gets lane counts around one packet and around eight
# (a last cluster that is one ray and 1,023 pad rays; seven blocks of pad
# rays only).  On the CPU the
# plain version is held to the per-ray walk of ops/traverse4 (a group walk
# finds the same nearest hits; its `visits` are one count per group); on a
# card the kernels are held to the plain version bit for bit.

EDGES = ["n0", "n1", "n127", "n129", "n1000", "dead", "any_hit", "width16"]
PACKET_EDGES = ["n1023", "n1025", "n8191", "n8193", "any_hit_n1025"]
EDGE_IMPLS = [(impl, case) for impl in ("walk", "packet") for case in EDGES
              if not (impl == "packet" and case == "width16")] + [
                  ("packet", case) for case in PACKET_EDGES]


def _edge_rays(setup, n):
    """The setup's rays, or for a launch of more than its 1,024 as many made
    the same way from the seed n."""
    _, o, d, tm = setup
    if n <= N:
        return o, d, tm
    rng = np.random.default_rng(n)
    o = rng.uniform(-2, 2, size=(3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    tm = rng.uniform(0.05, 1.5, size=n).astype(np.float32)
    tm[::2] = 1.0e5
    return o, d, tm


def _edge_case(setup, impl, case, device="cpu"):
    """(function, plain version, args, kwargs, n) of an edge launch."""
    pks = setup[0]
    digits = case.rpartition("n")[2]       # "n1000", "any_hit_n1025"
    n = int(digits) if digits.isdigit() else 129
    o, d, tm = _edge_rays(setup, n)
    width = 16 if case == "width16" else 8
    pk = pks[width]
    t = lambda a: _t(a).to(device)
    tmax = np.zeros(n, np.float32) if case == "dead" else tm[:n]
    args = (t(pk.nodes), t(pk.leaves), V3(*(t(x[:n]) for x in o)),
            V3(*(t(x[:n]) for x in d)), t(tmax))
    kw = dict(leaf_size=8, stack_depth=_stack(pk, width),
              any_hit=case.startswith("any_hit"))
    if impl == "walk":
        kw["tree_width"] = width
        return packet_traverse3, packet_traverse3_reference, args, kw, n
    return packet_traverse, packet_traverse_reference, args, kw, n


def _needed_depth(ref, args, kw):
    """The smallest stack_depth at which the plain version does not raise."""
    lo, hi = 1, kw["stack_depth"]
    while lo < hi:
        mid = (lo + hi) // 2
        try:
            ref(*args, **{**kw, "stack_depth": mid})
            hi = mid
        except RuntimeError:
            lo = mid + 1
    return lo


@pytest.fixture(scope="module")
def per_ray(setup):
    """The nearest hits of every ray by the per-ray walk, 8-wide."""
    from fspt_tpu_torch.ops.traverse4 import packet_traverse4_reference
    pks, o, d, tm = setup
    return packet_traverse4_reference(
        _t(pks[8].nodes), _t(pks[8].leaves), V3(*map(_t, o)),
        V3(*map(_t, d)), _t(tm), leaf_size=8, stack_depth=256)


@pytest.mark.parametrize("impl,case", EDGE_IMPLS)
def test_edge_launches_plain(setup, per_ray, impl, case):
    fn, _, args, kw, n = _edge_case(setup, impl, case)
    hit = fn(*args, **kw)
    if n > N:                      # rays of their own: their per-ray walk
        from fspt_tpu_torch.ops.traverse4 import packet_traverse4_reference
        per_ray = packet_traverse4_reference(*args, leaf_size=8,
                                             stack_depth=256)
    assert all(x.shape == (n,) for x in hit)
    assert hit.slot.dtype == torch.int32 and hit.t.dtype == torch.float32
    if n == 0:
        return
    # one visit count per group, shared by its rays
    group = GROUPS[impl]
    first = hit.visits[(torch.arange(n) // group) * group]
    assert torch.equal(hit.visits, first) and hit.visits.min() >= 1
    if case == "dead":
        assert (hit.slot == -1).all() and (hit.t == 0).all()
    elif case.startswith("any_hit"):
        assert torch.equal(hit.slot >= 0, per_ray.slot[:n] >= 0)
    else:
        assert torch.equal(hit.slot, per_ray.slot[:n])
        np.testing.assert_allclose(hit.t.numpy(), per_ray.t[:n].numpy(),
                                   **TOL)


@pytest.mark.parametrize("impl", ["walk", "packet"])
def test_stack_one_entry_short_raises_plain(setup, impl):
    fn, ref, args, kw, _ = _edge_case(setup, impl, "n1000")
    need = _needed_depth(ref, args, kw)
    assert 2 < need < kw["stack_depth"]
    fn(*args, **{**kw, "stack_depth": need})
    with pytest.raises(RuntimeError, match="stack overflow"):
        fn(*args, **{**kw, "stack_depth": need - 1})


@pytest.mark.cuda
@pytest.mark.parametrize("impl,case", EDGE_IMPLS)
def test_cuda_kernel_edge_launches_bit_exact_vs_plain(setup, cuda_device,
                                                      impl, case):
    from fspt_tpu_torch.ops.traverse import check_stack_overflow
    fn, ref_fn, args, kw, n = _edge_case(setup, impl, case, cuda_device)
    ours = fn(*args, **kw)
    torch.cuda.synchronize()
    check_stack_overflow(cuda_device)
    ref = ref_fn(*args, **kw)
    assert all(x.shape == (n,) for x in ours)
    for f in ours._fields:
        assert torch.equal(getattr(ours, f), getattr(ref, f)), f
    if impl == "walk" and n:
        lk = fn(*args, **kw, lane_counts=True)
        lp = ref_fn(*args, **kw, lane_counts=True)
        assert torch.equal(lk.visits, lp.visits)
    if impl == "packet":
        # the grid the kernel launched is the one packet_geometry names
        from fspt_tpu_torch.ops.traverse import (kernel_geometry,
                                                 packet_geometry)
        g = packet_geometry(n)
        assert kernel_geometry(n) == (g["blocks"], g["threads"])


@pytest.mark.cuda
@pytest.mark.parametrize("impl,case", [("walk", "n1000"), ("packet", "n1000"),
                                       ("packet", "n1025")])
def test_cuda_kernel_stack_one_entry_short_raises(setup, cuda_device, impl,
                                                  case):
    from fspt_tpu_torch.ops.traverse import check_stack_overflow
    fn, ref_fn, args, kw, _ = _edge_case(setup, impl, case, cuda_device)
    need = _needed_depth(ref_fn, args, kw)
    ours = fn(*args, **{**kw, "stack_depth": need})
    torch.cuda.synchronize()
    check_stack_overflow(cuda_device)           # exactly enough: no raise
    ref = ref_fn(*args, **{**kw, "stack_depth": need})
    for f in ours._fields:
        assert torch.equal(getattr(ours, f), getattr(ref, f)), f
    fn(*args, **{**kw, "stack_depth": need - 1})
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="overflowed"):
        check_stack_overflow(cuda_device)


# ---- the edge launches against the JAX package ---------------------------
# A launch whose last group is partly pad rays (n = 1000: not a multiple of
# 128 or 1024) and one with no live lane, through the JAX kernels in
# interpret mode: the pad rays enter the sign sums and the votes, so hits
# and per-group visits must agree there too.

def _steady_padded(d, n, group):
    """_steady_groups for n rays padded to whole groups with the pad rays'
    direction (0, 1, 0)."""
    pad = (-n) % group
    padded = np.concatenate(
        [d[:, :n], np.tile(np.array([[0.0], [1.0], [0.0]], np.float32),
                           (1, pad))], axis=1)
    return _steady_groups(padded, group)[:n]


@pytest.mark.parametrize("case", ["n1000", "dead"])
@pytest.mark.parametrize("impl", ["walk", "packet"])
def test_edge_launches_match_pallas_kernel(setup, impl, case):
    import jax.numpy as jnp
    from fspt_tpu.core.vec import V3 as JV3
    from fspt_tpu.ops.traverse import packet_traverse as j1
    from fspt_tpu.ops.traverse3 import packet_traverse3 as j3
    fn, _, args, kw, n = _edge_case(setup, impl, case)
    ours = fn(*args, **kw)
    nodes, leaves, o, d, tmax = args
    j = lambda x: jnp.asarray(x.numpy())
    ref = (j3 if impl == "walk" else j1)(
        j(nodes), j(leaves), JV3(*map(j, o)), JV3(*map(j, d)), j(tmax),
        interpret=True, **kw)
    ref = [np.asarray(x) for x in ref]
    assert all(x.shape == (n,) for x in ref)
    _assert_hits(ours, ref)
    steady = _steady_padded(setup[2], n, GROUPS[impl])
    np.testing.assert_array_equal(ours.visits.numpy()[steady],
                                  ref[4][steady])
    if case == "dead":
        assert (ours.slot == -1).all() and (ref[4] >= 1).all()
    else:
        assert (ours.slot >= 0).sum() > 5


# ---- the leaf tests' reciprocal over the whole range of determinants -----
# csrc/walk.cu takes 1.0f / det apart (the hardware's approximation and one
# Newton step where the exponent allows, a true division elsewhere) so that
# two triangles' reciprocals run side by side; the result must be 1.0f / det
# to the bit for every determinant.  This scene drives chosen determinants
# through the leaf path: 64 triangles in the z = 0 plane, triangle j at
# x = 4j with edges (a_j, 0, 0) and (0, b_j, 0), and rays along +z with
# direction (0, 0, s), so that ray and triangle give the determinant
# -a_j * b_j * s exactly.  Every ray aims at one triangle from z = -s, which
# it hits at t = 1, u = v = 1/4 wherever |det| >= 1e-6, so t, u and v carry
# the reciprocal out.  s sweeps 2^-22 .. 2^126 (|det| from below the 1e-6
# cut, where the divisor is the 1.0f stand-in, to 2^127.99: past the upper
# edge of the Newton window at 2^126); a_j sweeps mantissas from 1 to
# 2 - 2^-23, b_j is +-2, and every fourth triangle is 2^-40 wide, so that
# its pair partner meets a stand-in divisor beside a huge one.

RCP_MANTISSAS = (1.0, 1.0 + 2.0 ** -23, 1.25, 1.5, 1.75, 2.0 - 2.0 ** -23,
                 1.3333334, 1.9)
RCP_EXPONENTS = range(-22, 127)


def _reciprocal_scene(device="cpu"):
    """(nodes, leaves, origin, direction, target slot, s exponent) of the
    sweep: one root over eight 8-triangle leaves."""
    tri = np.arange(64)
    a = np.array([RCP_MANTISSAS[j % 8] for j in tri], np.float32)
    a[3::4] *= np.float32(2.0 ** -40)
    b = np.where(tri // 8 % 2 == 0, 2.0, -2.0).astype(np.float32)
    nodes = np.zeros((1, 128), np.float32)
    for lane, v in ((0, -1e3), (8, -4.0), (16, -1.0), (24, 1e3), (32, 4.0),
                    (40, 1.0)):
        nodes[0, lane:lane + 8] = v
    nodes[0, 48:56] = -np.arange(8) - 1              # links: leaves 0..7
    nodes[0, 56] = 2.0                               # sort axis z
    rows = np.zeros((64, 9), np.float32)             # v0, e1, e2
    rows[:, 0] = 4.0 * tri
    rows[:, 3] = a
    rows[:, 7] = b
    leaves = np.zeros((8, 128), np.float32)
    leaves[:, :72] = rows.reshape(8, 72)
    k = np.repeat(np.array(RCP_EXPONENTS), 64)
    j = np.tile(tri, len(RCP_EXPONENTS))
    s = np.exp2(k).astype(np.float32)
    zero = np.zeros_like(s)
    o = (rows[j, 0] + a[j] / 4, b[j] / 4, -s)
    t = lambda x: _t(np.asarray(x, np.float32)).to(device)
    return (t(nodes), t(leaves), V3(*map(t, o)), V3(t(zero), t(zero), t(s)),
            j, k)


@pytest.mark.parametrize("impl", ["walk", "packet"])
def test_reciprocal_sweep_plain(impl):
    nodes, leaves, o, d, j, k = _reciprocal_scene()
    hit = PORT[impl](nodes, leaves, o, d, leaf_size=8, stack_depth=16)
    a = leaves.numpy()[:, :72].reshape(64, 9)[j, 3].astype(np.float64)
    det = a * 2.0 * np.exp2(k.astype(np.float64))
    # every aimed-at triangle of more than 2^-40 is hit where the cut allows
    wide = (j % 4 != 3) & (det >= 1.1e-6)
    assert wide.sum() > 6000
    np.testing.assert_array_equal(hit.slot.numpy()[wide], j[wide])
    np.testing.assert_allclose(hit.t.numpy()[wide], 1.0, rtol=1e-6)
    # (the origin's x = 4j + a/4 rounds at up to 2^-16 beside x = 252)
    np.testing.assert_allclose(hit.u.numpy()[wide], 0.25, rtol=1e-4)
    np.testing.assert_allclose(hit.v.numpy()[wide], 0.25, rtol=1e-6)
    assert (hit.slot.numpy()[det < 0.9e-6] == -1).all()
    # determinants on both sides of the Newton window's upper edge
    assert (det[wide] >= 2.0 ** 126).sum() > 80
    assert np.isfinite(det).all() and det.max() < 2.0 ** 128


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("impl", ["walk", "packet"])
def test_cuda_kernel_reciprocal_sweep_bit_exact_vs_plain(cuda_device, impl,
                                                         any_hit):
    from fspt_tpu_torch.ops.traverse import check_stack_overflow
    nodes, leaves, o, d, j, _ = _reciprocal_scene(cuda_device)
    ref_fn = (packet_traverse3_reference if impl == "walk"
              else packet_traverse_reference)
    kw = dict(leaf_size=8, stack_depth=16, any_hit=any_hit)
    ours = PORT[impl](nodes, leaves, o, d, **kw)
    torch.cuda.synchronize()
    check_stack_overflow(cuda_device)
    ref = ref_fn(nodes, leaves, o, d, **kw)
    assert (ref.slot >= 0).sum() > 6000
    for f in ours._fields:
        assert torch.equal(getattr(ours, f), getattr(ref, f)), f


# ---- walk3's ray masks (csrc/walk.cu) -------------------------------------
# The kernel tests at each row only the rays that wanted it: every entry of
# the group's stack carries the mask of the rays whose own box test passed
# for it (the root's, every ray), and a visit runs the box tests of a node,
# or Moller-Trumbore over a leaf, for those rays alone.  That changes no
# output wherever a child's box contains every box of the child's own row:
# a ray that failed the parent's slab test fails every descendant's, since
# rounded (plane - o) * inv is monotone in the plane and the ray's best t
# only falls.  The packed tables are built and refit as min/max unions, so
# the nesting holds for them, compared exactly below.  `_mask_walk` is the
# plain version (ops/traverse3.py `group_walk_reference`, the contract)
# with the masks written out, and must equal it bit for bit; it also counts
# the (ray, row) pairs the masks leave to test, which is what the kernel's
# pair counter counts.

def _nesting(nodes, width):
    """(child boxes checked, descendant boxes outside their parent's box)
    over a node table: for every valid child that is a node row, every
    valid box of that row against the child's box in its parent's row."""
    lo = nodes[:, :3 * width].reshape(-1, 3, width)
    hi = nodes[:, 3 * width:6 * width].reshape(-1, 3, width)
    link = nodes[:, 6 * width:7 * width]
    parent, child = torch.nonzero(link >= 0, as_tuple=True)
    row = link[parent, child].long()
    sub = link[row] > -1.0e8                               # (k, width)
    inside = ((lo[row] >= lo[parent, :, child][:, :, None])
              & (hi[row] <= hi[parent, :, child][:, :, None])).all(1)
    return int(sub.sum()), int((sub & ~inside).sum())


def _mask_walk(nodes, leaves, origin, direction, tmax, *, tree_width,
               leaf_size, any_hit, stack_depth, lane_counts=False):
    """`group_walk_reference` (v3 rules, 128-ray groups) under the mask
    rule: (PacketHit, counts, child tests that pass for a ray outside its
    node's mask).  counts, as csrc/walk.cu's work tally names them
    (ops/traverse3.py TALLY): the (ray, row) pairs tested, the group
    visits, and the (ray, valid child) and (ray, real triangle) tests."""
    from fspt_tpu_torch.ops.traverse import (SENTINEL, PacketHit,
                                             real_triangles, safe_inv,
                                             valid_children)
    from fspt_tpu_torch.ops.traverse3 import _halving_sum
    group, tw = GROUPS["walk"], tree_width
    f32, i32 = torch.float32, torch.int32
    dev = nodes.device
    n = origin.x.shape[0]
    ng = -(-n // group)
    pad = ng * group - n

    def field(a, value):
        a = torch.cat([a, torch.full((pad,), value, dtype=f32, device=dev)])
        return a.reshape(ng, group)

    ox, oy, oz = (field(a, 1.0e9) for a in origin)
    dx, dy, dz = (field(a, v) for a, v in zip(direction, (0.0, 1.0, 0.0)))
    bt = field(tmax, 0.0).clone()
    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)
    sx, sy, sz = (_halving_sum(a) >= 0.0 for a in (dx, dy, dz))
    bs = torch.full((ng, group), -1, dtype=i32, device=dev)
    bu = torch.zeros((ng, group), dtype=f32, device=dev)
    bv = torch.zeros((ng, group), dtype=f32, device=dev)
    lane_vis = torch.ones((ng, group), dtype=i32, device=dev)
    steps = torch.zeros(ng, dtype=i32, device=dev)
    cur = torch.zeros(ng, dtype=torch.int64, device=dev)
    ptr = torch.ones(ng, dtype=torch.int64, device=dev)
    stack = torch.full((ng, stack_depth), SENTINEL, dtype=i32, device=dev)
    held = torch.zeros((ng, stack_depth, group), dtype=torch.bool,
                       device=dev)                 # the entries' masks
    mask = torch.ones((ng, group), dtype=torch.bool, device=dev)
    cols = torch.arange(tw, device=dev)
    counts = dict.fromkeys(("pairs", "visits", "children", "triangles"), 0)
    outside = 0
    live = torch.arange(ng, device=dev)
    while live.numel():
        steps[live] += 1
        c = cur[live]
        at_node = c >= 0
        m = mask[live].sum(1)
        counts["pairs"] += int(m.sum())
        counts["visits"] += live.numel()
        r = live[at_node]
        if r.numel():
            row = nodes[c[at_node]]
            counts["children"] += int((m[at_node]
                                       * valid_children(row, tw)).sum())
            lane = lambda k: row[:, None, k * tw:(k + 1) * tw]
            o = lambda a: a[r][:, :, None]
            t1x = (lane(0) - o(ox)) * o(ix)
            t2x = (lane(3) - o(ox)) * o(ix)
            t1y = (lane(1) - o(oy)) * o(iy)
            t2y = (lane(4) - o(oy)) * o(iy)
            t1z = (lane(2) - o(oz)) * o(iz)
            t2z = (lane(5) - o(oz)) * o(iz)
            tmin = torch.fmax(torch.fmax(torch.fmin(t1x, t2x),
                                         torch.fmin(t1y, t2y)),
                              torch.fmin(t1z, t2z))
            tmx = torch.fmin(torch.fmin(torch.fmax(t1x, t2x),
                                        torch.fmax(t1y, t2y)),
                             torch.fmax(t1z, t2z))
            links = row[:, 6 * tw:7 * tw]
            box = ((tmx >= tmin) & (tmx > 0.0) & (tmin < o(bt))
                   & (links > -1.0e8)[:, None, :])        # (Gn, group, tw)
            outside += int((box & ~o(mask)).sum())
            box &= o(mask)
            lane_vis[r] += box.sum(-1, dtype=i32)
            axis = row[:, 7 * tw]
            fwd = torch.where(axis == 0.0, sx[r],
                              torch.where(axis == 1.0, sy[r], sz[r]))
            order = torch.where(fwd[:, None], tw - 1 - cols, cols)
            kids = torch.gather(box, 2, order[:, None, :].expand_as(box))
            want = kids.any(1)
            link = torch.gather(links, 1, order).to(i32)
            k = want.sum(1)
            p0 = ptr[r]
            pos = p0[:, None] + torch.cumsum(want, 1) - 1
            top_ptr = p0 + k - 1
            if int(top_ptr.max()) > stack_depth:
                raise RuntimeError("stack overflow")
            rr, cc = torch.nonzero(want & (pos < stack_depth), as_tuple=True)
            stack[r[rr], pos[rr, cc]] = link[rr, cc]
            held[r[rr], pos[rr, cc]] = kids[rr, :, cc]
            last = torch.argmax(want * (cols + 1), 1)
            g = torch.arange(r.numel(), device=dev)
            pushed = k > 0
            cur[r] = torch.where(pushed, link[g, last],
                                 stack[r, p0 - 1]).long()
            mask[r] = torch.where(pushed[:, None], kids[g, :, last],
                                  held[r, p0 - 1])
            ptr[r] = torch.where(pushed, top_ptr, p0 - 1)
        r = live[~at_node]
        if r.numel():
            leaf = -c[~at_node] - 1
            row = leaves[leaf]
            counts["triangles"] += int((m[~at_node] * real_triangles(
                row, leaf_size)).sum())
            e = row[:, :9 * leaf_size].reshape(-1, 1, leaf_size, 9)
            e = [e[..., i] for i in range(9)]
            dxr, dyr, dzr = (a[r][:, :, None] for a in (dx, dy, dz))
            tx, ty, tz = (a[r][:, :, None] - b
                          for a, b in zip((ox, oy, oz), e[:3]))
            px = dyr * e[8] - dzr * e[7]
            py = dzr * e[6] - dxr * e[8]
            pz = dxr * e[7] - dyr * e[6]
            det = e[3] * px + e[4] * py + e[5] * pz
            inv = 1.0 / torch.where(torch.abs(det) < 1e-6,
                                    torch.ones_like(det), det)
            uu = (tx * px + ty * py + tz * pz) * inv
            qx = ty * e[5] - tz * e[4]
            qy = tz * e[3] - tx * e[5]
            qz = tx * e[4] - ty * e[3]
            ww = (dxr * qx + dyr * qy + dzr * qz) * inv
            tt = (e[6] * qx + e[7] * qy + e[8] * qz) * inv
            ok = ((torch.abs(det) >= 1e-6) & (uu >= 0.0) & (uu <= 1.0)
                  & (ww >= 0.0) & (uu + ww <= 1.0) & (tt > 1e-6)
                  & (tt < bt[r][..., None]) & mask[r][..., None])
            j = torch.argmin(torch.where(ok, tt, torch.inf), -1,
                             keepdim=True)
            hit = ok.any(-1)
            pick = lambda a: torch.gather(a, -1, j)[..., 0]
            bt[r] = torch.where(hit, pick(tt), bt[r])
            bs[r] = torch.where(hit, (leaf * leaf_size).to(i32)[:, None]
                                + j[..., 0].to(i32), bs[r])
            bu[r] = torch.where(hit, pick(uu), bu[r])
            bv[r] = torch.where(hit, pick(ww), bv[r])
            p0 = ptr[r] - 1
            cur[r] = stack[r, p0].long()
            mask[r] = held[r, p0]
            ptr[r] = p0
        if any_hit:
            done = ((bs[live] >= 0) | (bt[live] <= 0.0)).all(1)
            cur[live] = torch.where(done, SENTINEL, cur[live])
        live = live[cur[live] != SENTINEL]
    visits = (lane_vis if lane_counts
              else steps[:, None].expand(ng, group).contiguous())
    flat = lambda a: a.reshape(-1)[:n]
    hit = PacketHit(t=flat(bt), slot=flat(bs), u=flat(bu), v=flat(bv),
                    visits=flat(visits))
    return hit, counts, outside


@pytest.fixture(scope="module")
def dungeon():
    """The small dungeon of tests/test_torch_dungeon.py under the
    exact-replay configuration at 32x32: (its node and leaf tables, the
    (args, kwargs) of the first sample's sorted bounce-0 walk3 launch:
    3 x 1,024 lanes)."""
    from test_torch_dungeon_exact import NAME, _cfg
    from test_torch_dungeon import small_assets
    from fsptbench.manifest import Manifest
    from fsptbench.scenegen import Assets
    from fspt_tpu_torch import load_scene_dict
    from fspt_tpu_torch.core import integrator
    from fspt_tpu_torch.runtime.renderer import Renderer
    from fspt_tpu_torch.ops.traverse import capture_launches
    c = Manifest().config(NAME)
    scene = load_scene_dict(c["scene"], Assets(small_assets(c["assets"])),
                            name=NAME, **c["loader"])
    r = Renderer(scene, _cfg(c, 32, batch_spp=1), device="cpu")
    return r.arrays, capture_launches(integrator, "packet_traverse3",
                                      r.step)[1]


def _refit_nodes():
    """The node table of a refit frame: tests/test_torch_refit.py's scene,
    its sphere moved and spun, its tables refit from the base frame."""
    from fspt_tpu_torch.scene.refit import (build_refit_aux, delta_affines,
                                            refit_arrays)
    from fspt_tpu_torch.scene.schema import (_prop_defaults,
                                             load_scene_dict,
                                             merge_scene_props)
    from fspt_tpu_torch.testing import (DictAssetLoader, icosphere_obj,
                                        quad_obj)

    def scene_dict(translate, angle):
        return {"environment": [[0.2, 0.2, 0.3], [0.8, 0.9, 1.0]],
                "cameraPos": [0.0, 0.4, 2.2], "cameraDir": [0.0, -0.18, -0.98],
                "samples": 8,
                "props": [{"path": "floor.obj", "scale": 6.0,
                           "translate": [0, -0.5, 0]}],
                "animated_props": [{"path": "sphere.obj", "scale": 0.4,
                                    "translate": translate,
                                    "rotate": [{"axis": [0, 1, 0],
                                                "angle": angle}]}]}
    loader = DictAssetLoader(texts={"sphere.obj": icosphere_obj(3),
                                    "floor.obj": quad_obj()})
    base_sd, moved_sd = scene_dict([0, 0, 0], 0.0), scene_dict(
        [0.35, 0.15, -0.2], 0.8)
    base = load_scene_dict(base_sd, loader)
    props = lambda sd: [_prop_defaults(p) for p in merge_scene_props(sd)]
    mats, trans = delta_affines(props(base_sd), props(moved_sd))
    out = refit_arrays(base.to_torch("cpu"), base.meta,
                       build_refit_aux(base), mats, trans)
    return out.pk_nodes, base.meta.bvh_width


@pytest.mark.parametrize("tables", ["setup8", "setup16", "dungeon",
                                    "refit"])
def test_child_boxes_contain_their_rows_boxes(setup, dungeon, tables):
    """The premise of the mask rule, exactly: every box in a node row lies
    inside that node's box in its parent's row."""
    if tables.startswith("setup"):
        width = int(tables[5:])
        nodes = _t(setup[0][width].nodes)
    elif tables == "dungeon":
        nodes, width = dungeon[0].pk_nodes, 8
    else:
        nodes, width = _refit_nodes()
    checked, outside = _nesting(nodes, width)
    assert checked > 50 and outside == 0, (checked, outside)


MASK_CASES = ["w8", "w8-any", "w8-lanes", "w16", "w16-any-lanes",
              "dungeon", "dungeon-any", "dungeon-lanes"]


def _mask_case(setup, dungeon, case):
    """(args, kwargs) of a mask-rule case: the setup's rays over its 8- or
    16-wide tables, or the small dungeon's sorted bounce launch."""
    kind, *opts = case.split("-")
    if kind == "dungeon":
        args, kw = dungeon[1]
        kw = dict(kw)
    else:
        pks, o, d, tm = setup
        width = int(kind[1:])
        pk = pks[width]
        args = (_t(pk.nodes), _t(pk.leaves), V3(*map(_t, o)),
                V3(*map(_t, d)), _t(tm))
        kw = dict(leaf_size=8, stack_depth=_stack(pk, width),
                  tree_width=width)
    kw.update(any_hit="any" in opts, lane_counts="lanes" in opts)
    return args, kw


@pytest.mark.parametrize("case", MASK_CASES)
def test_mask_rule_equals_plain_version(setup, dungeon, case):
    """The mask rule's walk equals the plain version bit for bit in t,
    slot, u, v and visits (or lane counts), no ray passes a child test
    outside its node's mask, and the masks leave most pairs untested."""
    args, kw = _mask_case(setup, dungeon, case)
    ref = packet_traverse3_reference(*args, **kw)
    ours, counts, outside = _mask_walk(*args, **kw)
    for f in ref._fields:
        assert torch.equal(getattr(ours, f), getattr(ref, f)), f
    assert outside == 0
    if not kw["lane_counts"]:
        assert counts["visits"] == int(ref.visits[::GROUPS["walk"]].sum())
    assert 0 < counts["pairs"] < counts["visits"] * GROUPS["walk"]
    if case == "dungeon":
        assert (ref.slot >= 0).sum() > 500            # the rays hit walls


# ---- walk3's masks on a card ----------------------------------------------
# The kernel against the plain version bit for bit, and its work tally
# (ops/traverse3.py `work_tally`) against the mask rule's counts, on the
# cases above and on a full-size launch: the first sample's sorted bounce
# launch of the exact-replay cell (fsptbench/configs/dungeon8_exact.json,
# 512x512: 3 x 262,144 lanes over ~400,000 triangles).  A launch captured
# in a CUDA graph and replayed equals the eager one.


def _tallied(fn, *args, **kw):
    """(hit, the work tally's growth) of one kernel launch."""
    from fspt_tpu_torch.ops.traverse import check_stack_overflow
    from fspt_tpu_torch.ops.traverse3 import tally_growth
    held = []
    tally = tally_growth(lambda: held.append(fn(*args, **kw)),
                         args[0].device)
    check_stack_overflow(args[0].device)
    return held[0], tally


def _to(args, device):
    return tuple(V3(*(p.to(device) for p in a)) if isinstance(a, V3)
                 else a.to(device) for a in args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", MASK_CASES)
def test_cuda_walk3_tally_equals_mask_rule(setup, dungeon, cuda_device,
                                            case):
    args, kw = _mask_case(setup, dungeon, case)
    args = _to(args, cuda_device)
    ours, tally = _tallied(packet_traverse3, *args, **kw)
    ref = packet_traverse3_reference(*args, **kw)
    for f in ref._fields:
        assert torch.equal(getattr(ours, f), getattr(ref, f)), f
    _, counts, _ = _mask_walk(*args, **kw)
    assert tally == counts


@pytest.fixture(scope="module")
def dungeon_card():
    """The exact-replay cell's renderer on the card at full size, and the
    (args, kwargs) of its first sample's sorted bounce launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fsptbench.manifest import Manifest
    from fsptbench.run import Run
    from fspt_tpu_torch.core import integrator
    from fspt_tpu_torch.runtime.renderer import Renderer
    from fspt_tpu_torch.ops.traverse import capture_launches
    run = Run(Manifest(), "dungeon8_exact.progressive", 2_300_000_011, 1.0,
              "cuda")
    run.build()
    r = Renderer(run.scene, run.cfg, device="cuda")
    return r, capture_launches(integrator, "packet_traverse3", r.step)[1]


@pytest.mark.cuda
def test_cuda_walk3_dungeon_bounce_launch_bit_exact(dungeon_card):
    _, (args, kw) = dungeon_card
    assert args[2].x.shape == (3 * 512 * 512,)
    ours, tally = _tallied(packet_traverse3, *args, **kw)
    ref = packet_traverse3_reference(*args, **kw)
    for f in ref._fields:
        assert torch.equal(getattr(ours, f), getattr(ref, f)), f
    _, counts, outside = _mask_walk(*args, **kw)
    assert tally == counts and outside == 0
    # the masks leave a small share of the union's pairs to test
    assert counts["pairs"] < 0.2 * counts["visits"] * GROUPS["walk"]


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 16])
def test_cuda_walk3_graph_replay_equals_eager(setup, cuda_device, width):
    """A launch captured in a CUDA graph and replayed twice gives the eager
    launch's hits, and each replay adds the eager launch's work to the
    tally."""
    from fspt_tpu_torch.ops.traverse3 import work_tally
    args, kw = _mask_case(setup, None, f"w{width}")
    args = _to(args, cuda_device)
    eager, tally = _tallied(packet_traverse3, *args, **kw)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        packet_traverse3(*args, **kw)                  # warm up on the side
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        held = packet_traverse3(*args, **kw)
    for _ in range(2):
        before = work_tally(cuda_device).clone()
        for x in held:
            x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        grown = (work_tally(cuda_device) - before).tolist()
        for f in eager._fields:
            assert torch.equal(getattr(held, f), getattr(eager, f)), f
        assert grown == list(tally.values())
