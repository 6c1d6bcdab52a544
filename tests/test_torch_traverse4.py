"""The port's traversal (fspt_tpu_torch.ops.traverse4) against the JAX
package's Pallas kernel and the brute-force oracle.

On the CPU `packet_traverse4` runs its plain PyTorch version, which walks
each ray in the CUDA kernel's order; it must find the TPU kernel's hits:
equal slots, and t/u/v within rtol 1e-5 / atol 1e-6 (the TPU kernel tests
the same triangles against the same best t, in another order, so hits
differ only on exact ties, which random triangles do not produce).

The JAX kernel runs in interpret mode with its burst knobs at 1 (unroll,
drain_unroll, npop, lpop): the same kernel body and contract, traced in
seconds rather than a minute.  tests/test_fastbvh.py holds the default
knobs to the same hits.

On a machine with a card, the CUDA kernel must match the plain version
bit for bit (marked `cuda`; skipped here).  That machine has no JAX, so
the JAX package is imported inside the tests that compare against it, and
the card runs this file as
    python -m pytest --noconftest -m cuda tests/test_torch_traverse4.py
"""

import numpy as np
import pytest
import torch

from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.ops import packing
from fspt_tpu_torch.ops.traverse4 import (packet_traverse4,
                                          packet_traverse4_reference)
from fspt_tpu_torch.scene.bvh import triangle_aabbs
from fspt_tpu_torch.scene.fastbvh import build_bvh_fast

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
KNOBS = dict(unroll=1, drain_unroll=1, npop=1, lpop=1)


@pytest.fixture(scope="module")
def setup():
    """400 random triangles, 1024 random rays (tests/test_fastbvh.py's
    split-kernel parity setup)."""
    rng = np.random.default_rng(42)
    centers = rng.uniform(-1, 1, size=(400, 1, 3))
    verts = (centers + rng.normal(size=(400, 3, 3)) * 0.05).astype(np.float32)
    tmin, tmax = triangle_aabbs(verts)
    bvh = build_bvh_fast(tmin, tmax, leaf_size=8)
    gather = np.where(bvh.slot_tri < 0, 0, bvh.slot_tri)
    v = verts[gather]
    v[bvh.slot_tri < 0] = 0.0
    pk = packing.pack_bvh(bvh.left, bvh.right, bvh.tri_offset,
                          bvh.node_min, bvh.node_max, v[:, 0],
                          v[:, 1] - v[:, 0], v[:, 2] - v[:, 0],
                          leaf_size=8, width=8)
    n = 1024
    o = rng.uniform(-2, 2, size=(3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    tm = rng.uniform(0.05, 1.5, size=n).astype(np.float32)
    return pk, o, d, tm


def _jax(pk, o, d, tm=None, any_hit=False):
    import jax.numpy as jnp
    from fspt_tpu.core.vec import V3 as JV3
    from fspt_tpu.ops.traverse4 import packet_traverse4 as jax_traverse4
    return jax_traverse4(
        jnp.asarray(pk.nodes), jnp.asarray(pk.leaves),
        JV3(*map(jnp.asarray, o)), JV3(*map(jnp.asarray, d)),
        None if tm is None else jnp.asarray(tm), leaf_size=8,
        stack_depth=8 * (pk.depth + 2), any_hit=any_hit, interpret=True,
        **KNOBS)


def _port(pk, o, d, tm=None, any_hit=False, device="cpu", fn=None):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    fn = fn or packet_traverse4
    return fn(t(pk.nodes), t(pk.leaves), V3(*map(t, o)), V3(*map(t, d)),
              None if tm is None else t(tm), leaf_size=8,
              stack_depth=8 * (pk.depth + 2) + 16, any_hit=any_hit)


def _assert_hits(ours, ref):
    np.testing.assert_array_equal(ours.slot.cpu().numpy(),
                                  np.asarray(ref.slot))
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(ours, f).cpu().numpy(),
                                   np.asarray(getattr(ref, f)), **TOL)


@pytest.mark.parametrize("clip", ["max_t", "per_ray_tmax"])
def test_nearest_hit_matches_pallas_kernel(setup, clip):
    pk, o, d, tm = setup
    if clip == "max_t":
        tm = np.full_like(tm, 1.0e5)
    ours = _port(pk, o, d, tm)
    ref = _jax(pk, o, d, tm)
    assert (ours.slot >= 0).sum() > 5           # the rays do hit things
    _assert_hits(ours, ref)
    assert (ours.visits >= 1).all()


def test_any_hit_occlusion_matches_pallas_kernel(setup):
    pk, o, d, tm = setup
    ours = _port(pk, o, d, tm, any_hit=True)
    ref = _jax(pk, o, d, tm, any_hit=True)
    np.testing.assert_array_equal(ours.slot.numpy() >= 0,
                                  np.asarray(ref.slot) >= 0)
    # any-hit ends the walk early: never more visits than nearest-hit
    near = _port(pk, o, d, tm)
    assert (ours.visits <= near.visits).all()


def test_matches_brute_force_on_small_scene(small_scene):
    import jax.numpy as jnp
    from fspt_tpu.core.geometry import brute_force_intersect
    a = small_scene.arrays
    rng = np.random.default_rng(7)
    n = 2048
    o = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.6          # above the floor and sphere
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bt, bslot = brute_force_intersect(jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(a.tri_v0),
                                      jnp.asarray(a.tri_e1),
                                      jnp.asarray(a.tri_e2))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    hit = packet_traverse4(t(a.pk_nodes), t(a.pk_leaves), V3(*t(o.T)),
                           V3(*t(d.T)), leaf_size=small_scene.meta.leaf_size,
                           stack_depth=small_scene.meta.pk_stack_depth + 16)
    assert (hit.slot >= 0).float().mean() > 0.5
    np.testing.assert_array_equal(hit.slot.numpy(), np.asarray(bslot))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(bt), rtol=1e-4,
                               atol=1e-5)


def test_undersized_stack_raises(setup):
    pk, o, d, _ = setup
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    with pytest.raises(RuntimeError, match="stack overflow"):
        packet_traverse4(t(pk.nodes), t(pk.leaves), V3(*map(t, o)),
                         V3(*map(t, d)), leaf_size=8, stack_depth=4)


def test_rejects_other_tree_widths(setup):
    pk, o, d, _ = setup
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    with pytest.raises(ValueError, match="8- or 16-wide"):
        packet_traverse4(t(pk.nodes), t(pk.leaves), V3(*map(t, o)),
                         V3(*map(t, d)), leaf_size=8, tree_width=4)


@pytest.fixture(scope="module")
def setup16():
    """tests/test_fastbvh.py's split-kernel setup, packed 16-wide."""
    rng = np.random.default_rng(42)
    centers = rng.uniform(-1, 1, size=(400, 1, 3))
    verts = (centers + rng.normal(size=(400, 3, 3)) * 0.05).astype(np.float32)
    bvh = build_bvh_fast(*triangle_aabbs(verts), leaf_size=8)
    gather = np.where(bvh.slot_tri < 0, 0, bvh.slot_tri)
    v = verts[gather]
    v[bvh.slot_tri < 0] = 0.0
    pk = packing.pack_bvh(bvh.left, bvh.right, bvh.tri_offset,
                          bvh.node_min, bvh.node_max, v[:, 0],
                          v[:, 1] - v[:, 0], v[:, 2] - v[:, 0],
                          leaf_size=8, width=16)
    return pk


def test_width16_plain_matches_pallas_kernel(setup, setup16):
    """The plain version at width 16 against JAX packet_traverse4(...,
    tree_width=16)."""
    import jax.numpy as jnp
    from fspt_tpu.core.vec import V3 as JV3
    from fspt_tpu.ops.traverse4 import packet_traverse4 as jax_traverse4
    _, o, d, tm = setup
    pk = setup16
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    sd = 16 * (pk.depth + 2)
    ours = packet_traverse4(t(pk.nodes), t(pk.leaves), V3(*map(t, o)),
                            V3(*map(t, d)), t(tm), leaf_size=8,
                            stack_depth=sd + 32, tree_width=16)
    ref = jax_traverse4(jnp.asarray(pk.nodes), jnp.asarray(pk.leaves),
                        JV3(*map(jnp.asarray, o)), JV3(*map(jnp.asarray, d)),
                        jnp.asarray(tm), leaf_size=8, stack_depth=sd + 32,
                        tree_width=16, interpret=True, **KNOBS)
    assert (ours.slot >= 0).sum() > 5
    _assert_hits(ours, ref)


def test_width16_split_render_matches_width8():
    """A 16-wide scene renders under "split" (as it does in fspt_tpu, whose
    integrator passes tree_width=width to packet_traverse4), and its hits
    are the 8-wide scene's (tests/test_fastbvh.py:151-188)."""
    from fspt_tpu_torch.config import RenderConfig
    from fspt_tpu_torch.core import integrator
    from fspt_tpu_torch.core.camera import generate_rays
    from fspt_tpu_torch.core.rng import key, stream_uniforms
    from fspt_tpu_torch.testing import make_test_scene
    from fspt_tpu_torch.scene.schema import scene_to_torch
    cfg = RenderConfig(width=32, height=32, intersector="split")
    hits = {}
    for width in (8, 16):
        scene = make_test_scene(subdivisions=2, bvh_width=width)
        assert scene.meta.bvh_width == width
        arrays = scene_to_torch(scene.arrays, "cpu")
        cam = scene.camera
        o, d = generate_rays(torch.tensor(cam.position),
                             torch.tensor(cam.direction), cam.fov_scale,
                             cam.focal_depth, cam.aperture, (32, 32),
                             stream_uniforms(key(0), 0, (4, 32 * 32)))
        hits[width] = integrator.intersect(arrays, cfg, scene.meta, o, d)
    assert (hits[8].slot >= 0).float().mean() > 0.3
    assert torch.equal(hits[16].slot, hits[8].slot)
    np.testing.assert_allclose(hits[16].t.numpy(), hits[8].t.numpy(),
                               rtol=1e-5)


def test_plain_version_does_not_count_launches(setup):
    pk, o, d, _ = setup
    before = packet_traverse4.launches
    _port(pk, o, d)
    assert packet_traverse4.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_cuda_kernel_bit_exact_vs_plain(setup, cuda_device, any_hit):
    from fspt_tpu_torch.ops.traverse4 import check_stack_overflow
    pk, o, d, tm = setup
    before = packet_traverse4.launches
    ours = _port(pk, o, d, tm, any_hit=any_hit, device=cuda_device)
    torch.cuda.synchronize()
    check_stack_overflow(cuda_device)
    assert packet_traverse4.launches == before + 1
    ref = _port(pk, o, d, tm, any_hit=any_hit, device=cuda_device,
                fn=packet_traverse4_reference)
    for f in ours._fields:
        assert torch.equal(getattr(ours, f), getattr(ref, f)), f


@pytest.mark.cuda
def test_cuda_kernel_width16_bit_exact_vs_plain(setup, setup16, cuda_device):
    _, o, d, tm = setup
    pk = setup16
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    args = (t(pk.nodes), t(pk.leaves), V3(*map(t, o)), V3(*map(t, d)),
            t(tm))
    kw = dict(leaf_size=8, stack_depth=16 * (pk.depth + 2) + 32,
              tree_width=16)
    ours = packet_traverse4(*args, **kw)
    ref = packet_traverse4_reference(*args, **kw)
    for f in ours._fields:
        assert torch.equal(getattr(ours, f), getattr(ref, f)), f


# ---- the edges a thread-to-ray mapping can break -------------------------
# Lane counts around the kernel's block (8 rays) and warp (4 rays) sizes, a
# launch with no live lane, any-hit, width 16, and a stack one entry short.
# On the CPU the plain version is held to what defines it (a ray's result
# does not depend on the launch it is in); on a card the kernel is held to
# the plain version bit for bit.

EDGES = ["n0", "n1", "n127", "n129", "n1000", "dead", "any_hit", "width16"]


def _edge_case(setup, setup16, case, device="cpu"):
    """(args, kwargs, n) of an edge launch on `device`."""
    pk, o, d, tm = setup
    n = {"n0": 0, "n1": 1, "n127": 127, "n129": 129, "n1000": 1000}.get(
        case, 129)
    width = 16 if case == "width16" else 8
    if width == 16:
        pk = setup16
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    tmax = np.zeros(n, np.float32) if case == "dead" else tm[:n]
    args = (t(pk.nodes), t(pk.leaves), V3(*(t(x[:n]) for x in o)),
            V3(*(t(x[:n]) for x in d)), t(tmax))
    kw = dict(leaf_size=8, stack_depth=width * (pk.depth + 2) + 2 * width,
              any_hit=case == "any_hit", tree_width=width)
    return args, kw, n


def _needed_depth(args, kw):
    """The smallest stack_depth at which the plain version does not raise."""
    lo, hi = 1, kw["stack_depth"]
    while lo < hi:
        mid = (lo + hi) // 2
        try:
            packet_traverse4_reference(*args, **{**kw, "stack_depth": mid})
            hi = mid
        except RuntimeError:
            lo = mid + 1
    return lo


@pytest.fixture(scope="module")
def full_run(setup):
    return _port(setup[0], *setup[1:])


@pytest.mark.parametrize("case", EDGES)
def test_edge_launches_plain(setup, setup16, full_run, case):
    args, kw, n = _edge_case(setup, setup16, case)
    hit = packet_traverse4(*args, **kw)
    assert all(x.shape == (n,) for x in hit)
    assert hit.slot.dtype == torch.int32 and hit.t.dtype == torch.float32
    if case == "dead":
        assert (hit.slot == -1).all() and (hit.t == 0).all()
        assert (hit.visits >= 1).all()
    elif case == "any_hit":
        assert torch.equal(hit.slot >= 0, full_run.slot[:n] >= 0)
        assert (hit.visits <= full_run.visits[:n]).all()
    elif case == "width16":
        assert torch.equal(hit.slot, full_run.slot[:n])
        np.testing.assert_allclose(hit.t.numpy(), full_run.t[:n].numpy(),
                                   **TOL)
    else:
        # a ray's walk does not depend on the launch it is in
        for f in hit._fields:
            assert torch.equal(getattr(hit, f), getattr(full_run, f)[:n]), f


def test_stack_one_entry_short_raises_plain(setup, setup16):
    args, kw, _ = _edge_case(setup, setup16, "n1000")
    need = _needed_depth(args, kw)
    assert 2 < need < kw["stack_depth"]
    packet_traverse4(*args, **{**kw, "stack_depth": need})
    with pytest.raises(RuntimeError, match="stack overflow"):
        packet_traverse4(*args, **{**kw, "stack_depth": need - 1})


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGES)
def test_cuda_kernel_edge_launches_bit_exact_vs_plain(setup, setup16,
                                                      cuda_device, case):
    from fspt_tpu_torch.ops.traverse4 import check_stack_overflow
    args, kw, n = _edge_case(setup, setup16, case, cuda_device)
    ours = packet_traverse4(*args, **kw)
    torch.cuda.synchronize()
    check_stack_overflow(cuda_device)
    ref = packet_traverse4_reference(*args, **kw)
    assert all(x.shape == (n,) for x in ours)
    for f in ours._fields:
        assert torch.equal(getattr(ours, f), getattr(ref, f)), f


@pytest.mark.cuda
def test_cuda_kernel_stack_one_entry_short_raises(setup, setup16,
                                                  cuda_device):
    from fspt_tpu_torch.ops.traverse4 import check_stack_overflow
    args, kw, _ = _edge_case(setup, setup16, "n1000", cuda_device)
    need = _needed_depth(args, kw)
    ours = packet_traverse4(*args, **{**kw, "stack_depth": need})
    torch.cuda.synchronize()
    check_stack_overflow(cuda_device)           # exactly enough: no raise
    ref = packet_traverse4_reference(*args, **{**kw, "stack_depth": need})
    for f in ours._fields:
        assert torch.equal(getattr(ours, f), getattr(ref, f)), f
    packet_traverse4(*args, **{**kw, "stack_depth": need - 1})
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="overflowed"):
        check_stack_overflow(cuda_device)


@pytest.mark.parametrize("case", ["n1000", "dead"])
def test_edge_launches_match_pallas_kernel(setup, setup16, case):
    """A launch that the JAX wrapper pads to whole walks (n = 1000) and one
    with no live lane, against the JAX kernel in interpret mode."""
    pk, o, d, tm = setup
    n = 1000
    tmax = np.zeros(n, np.float32) if case == "dead" else tm[:n]
    ours = _port(pk, o[:, :n], d[:, :n], tmax)
    ref = _jax(pk, o[:, :n], d[:, :n], tmax)
    assert all(np.asarray(x).shape == (n,) for x in ref)
    _assert_hits(ours, ref)
    if case == "dead":
        assert (ours.slot == -1).all() and (ours.t == 0).all()
    else:
        assert (ours.slot >= 0).sum() > 5
