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
