"""The port's round-5 study modules (fspt_tpu_torch.scripts: r5common,
perf_r5_treelet, perf_r5d) and the `trace_fn` hook of
core/integrator._shade_and_scatter, against the JAX scripts under scripts/.

On the CPU `dense_mt` and `micro` run their plain PyTorch versions, held
against the JAX kernels in interpret mode (each `pallas_call` built here
as the script's `main` builds it).  Tolerance rtol 1e-5 / atol 1e-6: the
same float32 operations in the same order, but XLA's CPU backend may fuse
a product and a sum into one rounding.  That fusion is also why the micro
is compared on a table whose empty-child boxes (packing.BIG, 3e38) are set
to +-2: Moller-Trumbore over a node row with 3e38 corners overflows to inf
and NaN, and whether a fused product-sum overflows decides a hit there.

The JAX prototypes live under scripts/, which the tests put on sys.path;
each JAX result is computed once per module.  On a machine with a card the
CUDA kernels must match the plain versions bit for bit (marked `cuda`;
skipped here); that machine has no JAX, and runs this file as
    python -m pytest --noconftest -m cuda tests/test_torch_r5.py
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import integrator
from fspt_tpu_torch.scene.bvh import triangle_aabbs
from fspt_tpu_torch.scene.fastbvh import build_bvh_fast
from fspt_tpu_torch.scripts import perf_r5_treelet, perf_r5d, r5common
from fspt_tpu_torch.testing import make_test_scene

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")
MT_VARIANTS = ("full", "leaf", "leaf2", "leaf4", "vector")
K_SMALL = 16


def _jax_script(name):
    """A module of scripts/ (they import each other by bare name)."""
    import importlib
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    return importlib.import_module(name)


@pytest.fixture(scope="module")
def scene():
    s = make_test_scene(subdivisions=2)
    return s, s.to_torch("cpu")


# ---- dense MT (perf_r5_treelet stage E) ---------------------------------

@pytest.fixture(scope="module")
def dense_inputs(scene):
    """3 tiles of normal-distributed rays (tmax MAX_T) against random
    64-triangle treelets of the test scene's leaf rows."""
    leaves = scene[0].arrays.pk_leaves
    rng = np.random.default_rng(5)
    tile_tl = rng.integers(0, leaves.shape[0] // 8, (3, 1), dtype=np.int32)
    rays = rng.normal(size=(3, 7, 8, 128)).astype(np.float32)
    rays[:, 6] = 1.0e5
    return leaves, tile_tl, rays


@pytest.fixture(scope="module")
def dense_jax(dense_inputs):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    J = _jax_script("perf_r5_treelet")
    leaves, tile_tl, rays = dense_inputs
    n_tiles = tile_tl.shape[0]
    call = pl.pallas_call(
        functools.partial(J.dense_mt_kernel, T=64),
        grid=(n_tiles,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(leaves.shape, lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, 7, 8, 128), lambda i: (i, 0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=[pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0),
                                memory_space=pltpu.VMEM)] * 2,
        out_shape=[jax.ShapeDtypeStruct((n_tiles, 8, 128), jnp.float32),
                   jax.ShapeDtypeStruct((n_tiles, 8, 128), jnp.int32)],
        scratch_shapes=[pltpu.VMEM((1, 128), jnp.float32)],
        interpret=True)
    t, slot = call(jnp.asarray(tile_tl), jnp.asarray(leaves),
                   jnp.asarray(rays))
    return np.asarray(t), np.asarray(slot)


def _dense(dense_inputs, device="cpu", reference=False, T=64):
    leaves, tile_tl, rays = dense_inputs
    fn = (perf_r5_treelet.dense_mt_reference if reference
          else perf_r5_treelet.dense_mt)
    to = lambda a: torch.from_numpy(a).to(device)
    return fn(to(tile_tl), to(leaves), to(rays), T)


def test_dense_mt_matches_pallas_kernel(dense_inputs, dense_jax):
    t, slot = _dense(dense_inputs)
    assert t.shape == slot.shape == (3, 8, 128)
    assert (slot >= 0).sum() > 20                     # the rays do hit
    np.testing.assert_array_equal(slot.numpy(), dense_jax[1])
    np.testing.assert_allclose(t.numpy(), dense_jax[0], **TOL)


def test_dense_mt_rejects_out_of_range_treelets(dense_inputs):
    leaves, tile_tl, rays = dense_inputs
    bad = tile_tl.copy()
    bad[1, 0] = leaves.shape[0] // 8              # one past the last
    with pytest.raises(ValueError, match="treelet"):
        _dense((leaves, bad, rays))
    with pytest.raises(ValueError, match="T must be"):
        _dense(dense_inputs, T=32)


def test_dense_mt_plain_version_does_not_count_launches(dense_inputs):
    before = perf_r5_treelet.dense_mt.launches
    _dense(dense_inputs)
    assert perf_r5_treelet.dense_mt.launches == before


def test_tested_slots_against_real_triangles(scene):
    """The slots the kernel tests a leaf row (up to its last triangle with
    an edge, in whole pairs) against ops/traverse.py `real_triangles`: packed
    leaf rows keep their padding at the end, so the two differ only by the
    rounding to a pair."""
    from fspt_tpu_torch.ops.traverse import real_triangles
    leaves = torch.from_numpy(scene[0].arrays.pk_leaves)
    real = real_triangles(leaves, 8)
    slots = perf_r5_treelet.tested_slots(leaves)
    assert bool((real < 8).any())                     # the rows have padding
    assert torch.equal(slots, real + real % 2)
    # per treelet of T = 64 (8 rows): what a tile tests against what it needs
    tl = slots[:leaves.shape[0] // 8 * 8].reshape(-1, 8).sum(1)
    need = real[:leaves.shape[0] // 8 * 8].reshape(-1, 8).sum(1)
    assert bool((tl >= need).all() & (tl - need <= 8).all())


def test_tested_slots_keeps_inner_empty_slots():
    rows = torch.zeros((3, 128))
    rows[1, 9 * 2 + 3] = 1.0                # slot 2 only: slots 0-3 tested
    rows[2, 9 * 7 + 8] = -0.5               # slot 7 only
    rows[2, 9 * 0 + 4] = -0.0               # (-0 is no edge)
    assert perf_r5_treelet.tested_slots(rows).tolist() == [0, 4, 8]


def test_frontier_pairs_matches_jax_script(scene):
    J = _jax_script("perf_r5_treelet")
    a = scene[0].arrays
    tmin, tmax = triangle_aabbs(np.stack(
        [a.tri_v0, a.tri_v0 + a.tri_e1, a.tri_v0 + a.tri_e2], axis=1))
    bvh = build_bvh_fast(tmin, tmax, leaf_size=16)
    rng = np.random.default_rng(9)
    n = 512
    o = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    tm = np.full(n, 1.0e5, np.float32)
    active = rng.uniform(size=n) < 0.8
    ours = perf_r5_treelet.frontier_pairs(bvh, o, d, tm, active, 16)
    ref = J.frontier_pairs(bvh, o, d, tm, active, 16)
    assert len(ours[0]) > 50
    for x, y in zip(ours, ref):
        np.testing.assert_array_equal(x, y)


# ---- the substep micro (perf_r5d) ---------------------------------------

@pytest.fixture(scope="module")
def micro_inputs(scene):
    """The test scene's node + leaf table, empty-child boxes at +-2 (see
    the module docstring), and the script's rays N(0, 1) + 0.5."""
    a = scene[0].arrays
    table = np.concatenate([a.pk_nodes, a.pk_leaves], axis=0)
    table = np.where(np.abs(table) >= 1e38, np.sign(table) * 2.0,
                     table).astype(np.float32)
    rng = np.random.default_rng(0)
    rays = (rng.normal(size=(1, 6, 8, 128)).astype(np.float32) + 0.5)
    return table, rays


@pytest.fixture(scope="module")
def micro_jax(micro_inputs):
    """JAX micro_kernel results by variant at K = K_SMALL (the module
    attribute perf_r5d.K is set while tracing), computed on first use."""
    table, rays = micro_inputs
    cache = {}

    def get(variant):
        if variant not in cache:
            import jax
            import jax.numpy as jnp
            from jax.experimental import pallas as pl
            from jax.experimental.pallas import tpu as pltpu
            J = _jax_script("perf_r5d")
            call = pl.pallas_call(
                functools.partial(J.micro_kernel, variant=variant,
                                  table_rows=table.shape[0]),
                grid=(1,),
                in_specs=[pl.BlockSpec(table.shape, lambda i: (0, 0),
                                       memory_space=pltpu.VMEM),
                          pl.BlockSpec((1, 6, 8, 128),
                                       lambda i: (i, 0, 0, 0),
                                       memory_space=pltpu.VMEM)],
                out_specs=pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0),
                                       memory_space=pltpu.VMEM),
                out_shape=jax.ShapeDtypeStruct((1, 8, 128), jnp.float32),
                scratch_shapes=[pltpu.VMEM((32, 128), jnp.float32),
                                pltpu.VMEM((8, 64), jnp.int32)],
                interpret=True)
            k = J.K
            J.K = K_SMALL
            try:
                cache[variant] = np.asarray(call(jnp.asarray(table),
                                                 jnp.asarray(rays)))
            finally:
                J.K = k
        return cache[variant]
    return get


@pytest.mark.parametrize("variant", perf_r5d.VARIANTS)
def test_micro_matches_pallas_kernel(micro_inputs, micro_jax, variant):
    table, rays = micro_inputs
    ours = perf_r5d.micro(torch.from_numpy(table), torch.from_numpy(rays),
                          variant, K_SMALL).numpy()
    assert ours.shape == (1, 8, 128)
    if variant in MT_VARIANTS:
        assert (ours < 1e9).sum() > 20                # real hits
    np.testing.assert_allclose(ours, micro_jax(variant), **TOL)


def test_micro_checks_its_arguments(micro_inputs):
    table, rays = (torch.from_numpy(x) for x in micro_inputs)
    with pytest.raises(ValueError, match="unknown variant"):
        perf_r5d.micro(table, rays, "nodes", 4)
    with pytest.raises(ValueError, match="rays must be"):
        perf_r5d.micro(table, rays[:, :5], "full", 4)
    before = perf_r5d.micro.launches
    perf_r5d.micro(table, rays, "full", 2)
    assert perf_r5d.micro.launches == before


# ---- the captured bounce-0 launch (r5common) ----------------------------

CAPTURE_SIZE = 64       # 4,096 rays: the schedule's 2.0 keeps 2,048 lanes
# the launch's origins are hit points o + d*t and its directions come out of
# the BRDF sampler (sqrt, trig, normalisation): a chain of float32 steps in
# which XLA fuses product-sums, so a few lanes differ by ~2e-5 relative
# (tests/test_torch_integrator.py holds whole paths to 5e-3)
CAPTURE_TOL = dict(rtol=1e-4, atol=1e-5)
CAPTURE_CFG = dict(width=CAPTURE_SIZE, height=CAPTURE_SIZE, bounces=2,
                   extra_refraction_iters=0, compact=True, intersector="brute",
                   compact_schedule=(2.0, 4.0))


def test_capture_bounce0_matches_jax(scene):
    from fspt_tpu.config import RenderConfig as JaxConfig
    from fspt_tpu.testing import make_test_scene as jax_test_scene
    J = _jax_script("r5common")
    js = jax_test_scene(subdivisions=2)
    ref = J.capture_bounce0(js, js.device_arrays(), js.meta,
                            JaxConfig(**CAPTURE_CFG), size=CAPTURE_SIZE)
    s, a = scene
    so, sd, stm, sa = r5common.capture_bounce0(
        s, a, s.meta, RenderConfig(**CAPTURE_CFG), size=CAPTURE_SIZE)
    assert so.x.shape == (2 * 2048,)         # scatter + shadow, compacted
    assert 100 < int(sa.sum()) < 2 * 2048
    np.testing.assert_array_equal(sa.numpy(), np.asarray(ref[3]))
    for ours, theirs in zip([*so, *sd, stm], [*ref[0], *ref[1], ref[2]]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   **CAPTURE_TOL)


# ---- the trace_fn hook of _shade_and_scatter ----------------------------

@pytest.fixture(scope="module")
def bounce0(scene):
    """The first _shade_and_scatter of a 64x64 sample under "split" without
    the launch sort, so that `intersect` hands the launch to
    packet_traverse4 as it is."""
    s, a = scene
    cfg = RenderConfig(**{**CAPTURE_CFG, "intersector": "split",
                          "sort_rays": False})
    return a, cfg, s.meta, r5common.bounce0_inputs(s, a, s.meta, cfg,
                                                    CAPTURE_SIZE)


def _tensors(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return []


def test_trace_fn_none_changes_nothing(bounce0):
    a, cfg, meta, args = bounce0
    base = integrator._shade_and_scatter(a, cfg, meta, *args)
    none = integrator._shade_and_scatter(a, cfg, meta, *args, trace_fn=None)
    same = integrator._shade_and_scatter(
        a, cfg, meta, *args,
        trace_fn=lambda o, d, act, tm, any_hit=False:
        integrator.sorted_intersect(a, cfg, meta, o, d, act, tm,
                                    any_hit=any_hit))
    flat = _tensors(base)
    assert len(flat) > 10
    for other in (none, same):
        for x, y in zip(flat, _tensors(other), strict=True):
            assert torch.equal(x, y)


def test_trace_fn_sees_the_traversal_launch(bounce0, monkeypatch):
    a, cfg, meta, args = bounce0
    seen, launched = [], []
    real = integrator.packet_traverse4

    def spy(*xs, **kw):
        launched.append(xs)
        return real(*xs, **kw)
    monkeypatch.setattr(integrator, "packet_traverse4", spy)

    def trace(o, d, act, tm, any_hit=False):
        seen.append((o, d, tm))
        return integrator.sorted_intersect(a, cfg, meta, o, d, act, tm,
                                           any_hit=any_hit)
    integrator._shade_and_scatter(a, cfg, meta, *args, trace_fn=trace)
    assert len(seen) == len(launched) == 1     # scatter + shadow, one launch
    (o, d, tm), (_, _, lo, ld, ltm) = seen[0], launched[0]
    assert o.x.shape == (2 * 2048,)
    for x, y in zip([*o, *d, tm], [*lo, *ld, ltm], strict=True):
        assert torch.equal(x, y)


# ---- the CUDA kernels against their plain versions (on a card) ----------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", perf_r5_treelet.TREELETS)
def test_cuda_dense_mt_bit_exact_vs_plain(dense_inputs, cuda_device, T):
    leaves, _, rays = dense_inputs
    tile_tl = np.array([[0], [1], [leaves.shape[0] // (T // 8) - 1]],
                       np.int32)
    before = perf_r5_treelet.dense_mt.launches
    t, slot = _dense((leaves, tile_tl, rays), cuda_device, T=T)
    torch.cuda.synchronize()
    assert perf_r5_treelet.dense_mt.launches == before + 1
    tp, sp = _dense((leaves, tile_tl, rays), cuda_device, reference=True,
                    T=T)
    assert torch.equal(t, tp) and torch.equal(slot, sp)
    assert int((slot >= 0).sum()) > 0


def _full_rows(n_rows, seed):
    """Leaf rows with 8 triangles each, around the origin."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n_rows, 128), np.float32)
    tri = rng.normal(size=(n_rows, 8, 9)).astype(np.float32)
    tri[..., 3:] *= 0.8
    rows[:, :72] = tri.reshape(n_rows, 72)
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [1, 131, 132, 133, 183])
@pytest.mark.parametrize("rows", ["padded", "full"])
@pytest.mark.parametrize("T", perf_r5_treelet.TREELETS)
def test_cuda_dense_mt_tiles_bit_exact(dense_inputs, cuda_device, T, rows,
                                       tiles):
    """Tile counts around one block an SM (132) and the study's 183, on
    leaf rows with padding slots (the test scene's) and with none."""
    leaves = dense_inputs[0] if rows == "padded" else _full_rows(64, T)
    filled = perf_r5_treelet.tested_slots(torch.from_numpy(leaves))
    assert bool((filled < 8).any()) == (rows == "padded")
    rng = np.random.default_rng(tiles + T)
    tile_tl = rng.integers(0, leaves.shape[0] // (T // 8), (tiles, 1),
                           dtype=np.int32)
    rays = rng.normal(size=(tiles, 7, 8, 128)).astype(np.float32)
    rays[:, 6] = 1.0e5
    inputs = (leaves, tile_tl, rays)
    t, slot = _dense(inputs, cuda_device, T=T)
    tp, sp = _dense(inputs, cuda_device, reference=True, T=T)
    assert torch.equal(t, tp) and torch.equal(slot, sp)
    assert int((slot >= 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("T", perf_r5_treelet.TREELETS)
def test_cuda_dense_mt_out_of_range_treelet(dense_inputs, cuda_device, T):
    """A treelet past the table or below 0 (launch_dense_mt does not check)
    reads nothing: NaN t and slot -1; the other tiles are as usual."""
    leaves, _, rays = dense_inputs
    n_tl = leaves.shape[0] // (T // 8)
    tile_tl = np.array([[0], [n_tl], [-1]], np.int32)
    to = lambda a: torch.from_numpy(a).to(cuda_device)
    t, slot = perf_r5_treelet.launch_dense_mt(to(tile_tl), to(leaves),
                                              to(rays), T)
    assert bool(t[1:].isnan().all()) and bool((slot[1:] == -1).all())
    tp, sp = _dense((leaves, tile_tl[:1], rays[:1]), cuda_device,
                    reference=True, T=T)
    assert torch.equal(t[:1], tp) and torch.equal(slot[:1], sp)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [None, 8, 9])
@pytest.mark.parametrize("k", [0, 1, 64, 257])
@pytest.mark.parametrize("variant", perf_r5d.VARIANTS)
def test_cuda_micro_bit_exact_vs_plain(scene, cuda_device, variant, k, rows):
    # the real table, 3e38 boxes included: both versions round alike; cut to
    # 8 and 9 rows the row numbers wrap at once (k = 257 is past a slice of
    # the leaf family's substeps and past the fetch variants' ring)
    table, rays = perf_r5d.make_inputs(cuda_device, scene[0])
    if rows:
        table = table[:rows].contiguous()
    before = perf_r5d.micro.launches
    out = perf_r5d.micro(table, rays, variant, k)
    torch.cuda.synchronize()
    assert perf_r5d.micro.launches == before + 1
    ref = perf_r5d.micro_reference(table, rays, variant, k)
    assert bool(((out == ref) | (out.isnan() & ref.isnan())).all())
