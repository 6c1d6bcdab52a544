"""The port's v5 mixed-substep traversal (fspt_tpu_torch.scripts.
traverse5_proto) against the JAX prototype (scripts/traverse5_proto.py).

On the CPU `packet_traverse5` runs its plain PyTorch version; against the
JAX kernel in interpret mode it must find the same hits — equal slots, t/u/v
within rtol 1e-5 / atol 1e-6 (the same float32 operations in the same
order; XLA's CPU backend may fuse a product and a sum into one rounding) —
and the same per-walk `visits` on walks whose majority direction sign is
not within rounding of 0 (the port sums a walk's directions by pairwise
halving, XLA in its own order; tests/test_torch_walk.py sets walks aside the
same way).  `visits` depends on the burst schedule (the per-program vote,
`unroll`, `drain_unroll`, `npop`, `lpop`), so two parameter sets are held
against JAX.

The JAX kernel takes ~9 s per call in interpret mode at unroll=1 (~70 s at
its default unroll=4), so the tests run unroll=1, drain_unroll=1 and share
each JAX result across the module.  The JAX prototype lives under scripts/,
which the fixture puts on sys.path.  On a machine with a card the CUDA
kernel must match the plain version bit for bit (marked `cuda`; skipped
here); that machine has no JAX, and runs this file as
    python -m pytest --noconftest -m cuda tests/test_torch_walk5.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.ops import packing
from fspt_tpu_torch.scene.bvh import triangle_aabbs
from fspt_tpu_torch.scene.fastbvh import build_bvh_fast
from fspt_tpu_torch.scripts.traverse5_proto import (
    packet_traverse5, packet_traverse5_reference)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
N = 1024
WALK = 128
FAST = dict(unroll=1, drain_unroll=1)          # the JAX kernel's cheap knobs
PARAMS = {"default": dict(FAST), "n1l2": dict(FAST, npop=1, lpop=2)}
SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def setup():
    """400 random triangles packed 8- and 16-wide, 1024 random rays (one
    program of 8 walks) and a per-ray tmax: even rays keep MAX_T, odd rays
    are clipped to 0.05-1.5 (tests/test_torch_walk.py's setup)."""
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
    """JAX kernel results by (params, any_hit), computed on first use."""
    pks, o, d, tm = setup
    cache = {}

    def get(params="default", any_hit=False):
        key = (params, any_hit)
        if key not in cache:
            import jax.numpy as jnp
            from fspt_tpu.core.vec import V3 as JV3
            if SCRIPTS not in sys.path:
                sys.path.insert(0, SCRIPTS)
            from traverse5_proto import packet_traverse5 as j5
            pk = pks[8]
            hit = j5(jnp.asarray(pk.nodes), jnp.asarray(pk.leaves),
                     JV3(*map(jnp.asarray, o)), JV3(*map(jnp.asarray, d)),
                     jnp.asarray(tm), leaf_size=8,
                     stack_depth=_stack(pk, 8), any_hit=any_hit,
                     interpret=True, **PARAMS[params])
            cache[key] = [np.asarray(x) for x in hit]
        return cache[key]
    return get


def _port(setup, params="default", width=8, device="cpu", reference=False,
          **kw):
    pks, o, d, tm = setup
    pk = pks[width]
    fn = packet_traverse5_reference if reference else packet_traverse5
    t = lambda a: _t(a).to(device)
    kw = {**PARAMS[params], "stack_depth": _stack(pk, width), **kw}
    return fn(t(pk.nodes), t(pk.leaves), V3(*map(t, o)), V3(*map(t, d)),
              t(tm), leaf_size=8, tree_width=width, **kw)


def _steady_walks(d):
    """Walks whose direction sums (float64) are all at least 1e-3 away from
    0, as a per-lane mask; fewer than 2% of walks may fall short."""
    sums = np.abs(d.astype(np.float64).reshape(3, -1, WALK).sum(axis=2))
    steady = sums.min(axis=0) >= 1e-3
    assert steady.mean() > 0.98, steady.mean()
    return np.repeat(steady, WALK)


def _assert_hits(ours, ref, lanes=slice(None)):
    np.testing.assert_array_equal(ours.slot.cpu().numpy()[lanes],
                                  ref[1][lanes])
    for i, f in ((0, "t"), (2, "u"), (3, "v")):
        np.testing.assert_allclose(getattr(ours, f).cpu().numpy()[lanes],
                                   ref[i][lanes], **TOL)


@pytest.mark.parametrize("params", sorted(PARAMS))
@pytest.mark.parametrize("clip", ["max_t", "per_ray_tmax"])
def test_nearest_hit_matches_pallas_kernel(setup, pallas, params, clip):
    lanes = slice(0, None, 2) if clip == "max_t" else slice(1, None, 2)
    ours = _port(setup, params)
    assert (ours.slot[lanes] >= 0).sum() > 5       # the rays do hit things
    _assert_hits(ours, pallas(params), lanes)


@pytest.mark.parametrize("params", sorted(PARAMS))
def test_visits_per_walk_match_pallas_kernel(setup, pallas, params):
    ours = _port(setup, params).visits.numpy()
    ref = pallas(params)[4]
    steady = _steady_walks(setup[2])
    np.testing.assert_array_equal(ours[steady], ref[steady])
    # one count per 128-ray walk, shared by its rays; walks differ
    walks = ours.reshape(-1, WALK)
    assert (walks == walks[:, :1]).all()
    assert walks.min() >= 1 and len(set(walks[:, 0])) > 1


def test_any_hit_matches_pallas_kernel(setup, pallas):
    ours = _port(setup, any_hit=True)
    ref = pallas(any_hit=True)
    np.testing.assert_array_equal(ours.slot.numpy() >= 0, ref[1] >= 0)
    steady = _steady_walks(setup[2])
    np.testing.assert_array_equal(ours.visits.numpy()[steady],
                                  ref[4][steady])
    near = _port(setup)
    np.testing.assert_array_equal(ours.slot.numpy() >= 0,
                                  near.slot.numpy() >= 0)
    assert (ours.visits <= near.visits).all()


@pytest.mark.parametrize("kw", [dict(unroll=4, drain_unroll=4),
                                dict(npop=3, lpop=1), dict(qcap=16)],
                         ids=["unroll4", "n3l1", "qcap16"])
def test_schedule_knobs_keep_hits(setup, kw):
    """The schedule's knobs move `visits` (a small queue forces pure-drain
    bursts) and leave the hits."""
    a = _port(setup)
    b = _port(setup, **kw)
    np.testing.assert_array_equal(a.slot.numpy(), b.slot.numpy())
    np.testing.assert_array_equal(a.t.numpy(), b.t.numpy())
    if "qcap" in kw:
        assert not torch.equal(a.visits, b.visits)


def test_width16_finds_8wide_slots(setup):
    ours = _port(setup, width=16)
    eight = _port(setup)
    np.testing.assert_array_equal(ours.slot.numpy(), eight.slot.numpy())
    np.testing.assert_allclose(ours.t.numpy(), eight.t.numpy(), **TOL)


def test_padding_to_whole_programs(setup):
    """n not a multiple of 1024: the parked pad rays change no real ray's
    hit (they join the last program's walks and votes)."""
    pks, o, d, tm = setup
    pk = pks[8]
    n = 700
    hit = packet_traverse5(_t(pk.nodes), _t(pk.leaves),
                           V3(*(_t(a[:n]) for a in o)),
                           V3(*(_t(a[:n]) for a in d)), _t(tm[:n]),
                           leaf_size=8, stack_depth=_stack(pk, 8), **FAST)
    full = _port(setup)
    assert hit.slot.shape == (n,)
    np.testing.assert_array_equal(hit.slot.numpy(), full.slot.numpy()[:n])


def test_undersized_stack_raises(setup):
    with pytest.raises(RuntimeError, match="stack overflow"):
        _port(setup, stack_depth=3)


def test_qcap_below_burst_bound_raises(setup):
    # a mixed burst appends up to tree_width*unroll*npop leaves; with a
    # smaller queue every burst would be voted a drain of an empty queue
    with pytest.raises(ValueError, match="qcap"):
        _port(setup, qcap=8)


def test_other_walk_counts_raise(setup):
    with pytest.raises(ValueError, match="walks is fixed at 8"):
        _port(setup, walks=4)


def test_plain_version_does_not_count_launches(setup):
    before = packet_traverse5.launches
    _port(setup)
    assert packet_traverse5.launches == before


# ---- the CUDA kernel against its plain version (on a card) --------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["default", "n1l2", "any", "w16",
                                  "unroll4"])
def test_cuda_kernel_bit_exact_vs_plain(setup, cuda_device, case):
    from fspt_tpu_torch.ops.traverse import check_stack_overflow
    kw = {"any": dict(any_hit=True), "w16": dict(width=16),
          "unroll4": dict(unroll=4, drain_unroll=4)}.get(case, {})
    params = case if case in PARAMS else "default"
    before = packet_traverse5.launches
    ours = _port(setup, params, device=cuda_device, **kw)
    torch.cuda.synchronize()
    check_stack_overflow(cuda_device)
    assert packet_traverse5.launches == before + 1
    ref = _port(setup, params, device=cuda_device, reference=True, **kw)
    for f in ours._fields:
        assert torch.equal(getattr(ours, f), getattr(ref, f)), f
