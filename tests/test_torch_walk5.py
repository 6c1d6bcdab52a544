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
kernel (csrc/walk5.cu, a program a thread block cluster) must match the
plain version bit for bit, at several ray counts and at the schedule's
edges (marked `cuda`; skipped here); that machine has no JAX, and runs this
file as
    python -m pytest --noconftest -m cuda tests/test_torch_walk5.py
"""

import ctypes
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
    LANES, WALKS, packet_traverse5, packet_traverse5_reference,
    walk5_geometry)

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


def _rays(setup, n):
    """n rays: the setup's first n, or past N more drawn the same way."""
    _, o, d, tm = setup
    if n <= N:
        return o[:, :n], d[:, :n], tm[:n]
    rng = np.random.default_rng(7)
    o2 = rng.uniform(-2, 2, size=(3, n - N)).astype(np.float32)
    d2 = rng.normal(size=(3, n - N)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=0, keepdims=True)
    tm2 = rng.uniform(0.05, 1.5, size=n - N).astype(np.float32)
    tm2[::2] = 1.0e5
    return (np.concatenate([o, o2], 1), np.concatenate([d, d2], 1),
            np.concatenate([tm, tm2]))


def _inputs(setup, params="default", width=8, device="cpu", n=N, **kw):
    """The (args, kwargs) of a packet_traverse5 call on the setup."""
    pk = setup[0][width]
    o, d, tm = _rays(setup, n)
    t = lambda a: _t(a).to(device)
    kw = {**PARAMS[params], "stack_depth": _stack(pk, width), "leaf_size": 8,
          "tree_width": width, **kw}
    return (t(pk.nodes), t(pk.leaves), V3(*map(t, o)), V3(*map(t, d)),
            t(tm)), kw


def _port(setup, params="default", width=8, device="cpu", reference=False,
          **kw):
    fn = packet_traverse5_reference if reference else packet_traverse5
    args, kw = _inputs(setup, params, width, device, **kw)
    return fn(*args, **kw)


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


@pytest.mark.parametrize("n", [1, 1025])
def test_geometry_matches_plain_padding(setup, n):
    """walk5_geometry (the kernel's launch, held to the library on a card)
    against the plain version's padding: its walks' visits, tallied per walk
    over the padded programs, exceed those of the walks with a real ray by
    one root visit for each walk of pad rays alone."""
    g = walk5_geometry(n)
    assert g["programs"] == -(-n // (WALKS * LANES))
    assert g["blocks"] == g["programs"] * WALKS and g["threads"] == LANES
    assert g["pad_rays"] == g["programs"] * WALKS * LANES - n
    counts = {}
    hit = _port(setup, reference=True, n=n, counts=counts)
    tallied = int(counts["node"] + counts["leaf"]) // LANES
    assert tallied - int(hit.visits[::LANES].sum()) == g["pad_blocks"]
    assert g["pad_blocks"] == g["blocks"] - -(-n // LANES)


def test_geometry_of_empty_and_whole_launches():
    assert walk5_geometry(0) == {"programs": 0, "blocks": 0,
                                 "threads": LANES, "pad_rays": 0,
                                 "pad_blocks": 0}
    g = walk5_geometry(8 * WALKS * LANES)
    assert (g["programs"], g["pad_rays"], g["pad_blocks"]) == (8, 0, 0)
    with pytest.raises(ValueError):
        walk5_geometry(-1)


@pytest.mark.parametrize("source", ["walk5", "dense_mt"])
def test_kernel_keeps_no_arithmetic_of_its_own(source):
    """The redesigned kernels take their ray tests from csrc/walk_common.cuh
    (one source of the arithmetic that the plain versions repeat); walk5
    launches a program as a thread block cluster."""
    from fspt_tpu_torch.ops import _build
    text = open(os.path.join(_build.CSRC, f"{source}.cu")).read()
    assert '#include "walk_common.cuh"' in text
    for own in ("det =", "1e-6f", "fminf(t1x"):
        assert own not in text, own
    if source == "walk5":
        assert "cudaLaunchAttributeClusterDimension" in text


# ---- the CUDA kernel against its plain version (on a card) --------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the kernel's cases: ray counts of several clusters and a partial program;
# a queue at the burst bound (tree_width * unroll * npop = 8 * 1 * 2 at FAST),
# where every queued leaf makes the next burst a pure drain; no drain units
# in mixed substeps (lpop=0), where leaves wait until no walk is alive
CUDA_CASES = {"default": {}, "n1l2": dict(params="n1l2"),
              "any": dict(any_hit=True), "w16": dict(width=16),
              "unroll4": dict(unroll=4, drain_unroll=4), "n1": dict(n=1),
              "n1023": dict(n=1023), "n1025": dict(n=1025),
              "n8193": dict(n=8193), "qcap_bound": dict(qcap=16),
              "lpop0": dict(lpop=0)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernel_bit_exact_vs_plain(setup, cuda_device, case):
    from fspt_tpu_torch.ops.traverse import check_stack_overflow
    args, kw = _inputs(setup, device=cuda_device, **CUDA_CASES[case])
    before = packet_traverse5.launches
    ours = packet_traverse5(*args, **kw)
    torch.cuda.synchronize()
    check_stack_overflow(cuda_device)
    assert packet_traverse5.launches == before + 1
    ref = packet_traverse5_reference(*args, **kw)
    for f in ours._fields:
        assert torch.equal(getattr(ours, f), getattr(ref, f)), f


def _entry_point_error(args, kw):
    """The message of the error that `fspt_walk5` of the built library
    returns for the call (args, kw), past the wrapper's own checks; None on
    a launch it takes."""
    from fspt_tpu_torch.ops.traverse import error_flag, ray_planes
    from fspt_tpu_torch.scripts.traverse5_proto import load_walk5
    nodes, leaves, o, d, tmax = args
    tmax, planes, dev = ray_planes("walk5", nodes, leaves, o, d, tmax)
    n = o.x.shape[0]
    hit = [torch.empty(n, dtype=dt, device=dev) for dt in (
        torch.float32, torch.int32, torch.float32, torch.float32, torch.int32)]
    flag = error_flag(dev)
    lib = load_walk5()
    err = lib.fspt_walk5(
        nodes.data_ptr(), leaves.data_ptr(), nodes.shape[0], leaves.shape[0],
        *(x.data_ptr() for x in planes), n, kw["leaf_size"],
        kw["stack_depth"], kw["qcap"], kw["unroll"], kw["drain_unroll"],
        kw.get("npop", 2), kw.get("lpop", 2), kw["tree_width"],
        int(kw.get("any_hit", False)), *(x.data_ptr() for x in hit),
        flag.data_ptr(),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    torch.cuda.synchronize()
    return lib.fspt_cuda_error_string(err).decode() if err else None


@pytest.mark.cuda
def test_cuda_overflow_raises_not_hangs(setup, cuda_device):
    """A stack one entry short ends its program through the vote's abort
    bit while the other programs of the launch run on, and raises, as the
    plain version does.  A leaf queue cannot overflow: the vote drains
    before a mixed burst could pass qcap, given qcap >= tree_width * unroll
    * npop; below that every burst would drain an empty queue forever, so
    the wrapper raises and the kernel's entry point refuses the launch."""
    from fspt_tpu_torch.ops.traverse import check_stack_overflow
    args, kw = _inputs(setup, device=cuda_device, n=8193)

    def overflows(depth):
        packet_traverse5(*args, **{**kw, "stack_depth": depth})
        torch.cuda.synchronize()
        try:
            check_stack_overflow(cuda_device)
        except RuntimeError as e:
            assert "overflowed" in str(e)
            return True
        return False

    lo, hi = 1, kw["stack_depth"]
    assert not overflows(hi)
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (mid + 1, hi) if overflows(mid) else (lo, mid)
    assert lo > 2
    assert overflows(lo - 1)
    with pytest.raises(RuntimeError, match="stack overflow"):
        packet_traverse5_reference(*args, **{**kw, "stack_depth": lo - 1})
    ok = packet_traverse5_reference(*args, **{**kw, "stack_depth": lo})
    hit = packet_traverse5(*args, **{**kw, "stack_depth": lo})
    torch.cuda.synchronize()
    check_stack_overflow(cuda_device)
    assert torch.equal(hit.slot, ok.slot) and torch.equal(hit.visits,
                                                          ok.visits)
    bound = kw["tree_width"] * kw["unroll"] * 2          # npop = 2
    with pytest.raises(ValueError, match="qcap"):
        packet_traverse5(*args, **{**kw, "qcap": bound - 1})
    assert _entry_point_error(args, {**kw, "qcap": bound - 1}) == (
        "invalid argument")


@pytest.mark.cuda
def test_cuda_kernel_geometry(cuda_device):
    from fspt_tpu_torch.scripts.traverse5_proto import walk5_kernel_geometry
    for n in (0, 1, 127, 1023, 1024, 1025, 8193):
        g = walk5_geometry(n)
        assert walk5_kernel_geometry(n) == (g["blocks"], g["threads"]), n
