"""The port's RNG (fspt_tpu_torch.core.rng) against the JAX package's:
threefry key data and PCG4D uniforms must agree bit for bit on every
stream the integrator draws (camera 0, shading 1..max_iters, compaction
64+it, merge shrink 64+max_iters+it), with and without the cross-sample
key_rows path.

PCG4D on the card is one launch of csrc/pcg4d.cu (ops/pcg4d.py).  On the
CPU: PCG4D on numpy uint32, wrapping as the kernel's registers do, equals
the int64 chain on edge values; a numpy model of the kernel's whole launch
(its lane ids, key forms and row loop) equals the plain version in every
form the kernel takes; the CPU path never loads the kernel's library; the
wrapper refuses what the kernel does not take.  On a card (`cuda` marker):
the kernel against the plain version, bit for bit, in the same forms, and
its launches under graph capture and replay.  That machine has no JAX, so
the JAX package is imported inside the tests that compare against it, and
the card runs this file as
    python -m pytest --noconftest -m cuda tests/test_torch_rng.py
"""

import numpy as np
import pytest
import torch

from fspt_tpu_torch.core import rng as trng
from fspt_tpu_torch.core.integrator import _RR_STREAM
from fspt_tpu_torch.ops import _build
from fspt_tpu_torch.ops.pcg4d import pcg4d_uniforms

torch.set_num_threads(1)

MAX_ITERS = 11
STREAMS = ([0] + list(range(1, MAX_ITERS + 1))
           + [64 + it for it in (0, 3, MAX_ITERS - 1)]
           + [64 + MAX_ITERS + it for it in (0, 2)])
M32 = 0xFFFFFFFF


def _jax():
    import jax

    from fspt_tpu.core import rng as jrng
    return jax, jrng


def _kd(k):
    jax, _ = _jax()
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", [0, 7, 123456789, 2 ** 31 + 5, -3])
def test_key_bit_exact(seed):
    jax, _ = _jax()
    np.testing.assert_array_equal(trng.key(seed), _kd(jax.random.key(seed)))


@pytest.mark.parametrize("data", [0, 1, 5, 1000, 2 ** 31 + 3])
def test_fold_in_and_sample_key_bit_exact(data):
    jax, jrng = _jax()
    jk, tk = jax.random.key(7), trng.key(7)
    np.testing.assert_array_equal(trng.fold_in(tk, data),
                                  _kd(jax.random.fold_in(jk, data)))
    np.testing.assert_array_equal(trng.sample_key(tk, data),
                                  _kd(jrng.sample_key(jk, data)))


def test_key_rows_for_bit_exact():
    jax, jrng = _jax()
    jk = jrng.sample_key(jax.random.key(3), 11)
    tk = trng.sample_key(trng.key(3), 11)
    np.testing.assert_array_equal(trng.key_rows_for(tk, 8),
                                  np.asarray(jrng.key_rows_for(jk, 8)))


@pytest.mark.parametrize("stream", STREAMS)
def test_stream_uniforms_bit_exact(stream):
    import jax.numpy as jnp
    jax, jrng = _jax()
    jk = jrng.sample_key(jax.random.key(5), 2)
    tk = trng.sample_key(trng.key(5), 2)
    n = 2000
    # scalar lane offset
    a = np.asarray(jrng.stream_uniforms(jk, stream, (11, n), lane_offset=37))
    b = trng.stream_uniforms(tk, stream, (11, n), lane_offset=37).numpy()
    np.testing.assert_array_equal(a, b)
    # explicit gids + key_rows (cross-sample wavefront lanes)
    k, per = 4, 700
    gid = np.random.default_rng(stream).integers(0, k * per, n)
    gid = gid.astype(np.int32)
    a = np.asarray(jrng.stream_uniforms(
        jk, stream, (11, n), lane_offset=jnp.asarray(gid),
        key_rows=jrng.key_rows_for(jk, k), lanes_per_key=per))
    b = trng.stream_uniforms(
        tk, stream, (11, n), lane_offset=torch.from_numpy(gid),
        key_rows=trng.key_rows_tensor(trng.key_rows_for(tk, k), "cpu"),
        lanes_per_key=per).numpy()
    np.testing.assert_array_equal(a, b)
    assert b.dtype == np.float32 and (b >= 0).all() and (b < 1).all()


# ---- PCG4D on u32, as the kernel computes it --------------------------------

def _pcg4d_u32(a, b, c, d):
    """PCG4D on numpy uint32 arrays: products and sums wrap mod 2^32 as
    csrc/pcg4d.cu's registers do, with no mask."""
    mul, add = np.uint32(1664525), np.uint32(1013904223)
    a, b, c, d = (a * mul + add, b * mul + add, c * mul + add, d * mul + add)
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    a, b, c, d = a ^ (a >> 16), b ^ (b >> 16), c ^ (c >> 16), d ^ (d >> 16)
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    return a, b, c, d


def _edge_words(name):
    """Four (m,) uint32 inputs of PCG4D."""
    g = np.random.default_rng(sum(map(ord, name)))
    if name == "all_ones":
        words = [np.full(4, M32)] * 4
        words[3] = np.array([M32, M32 - 1, 0, 1])
    elif name == "ids_near_2_32":
        ids = np.array([2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1, M32 - 2, M32 - 1,
                        M32, 0, 1])
        words = [ids, np.full(8, M32), g.integers(0, 2 ** 32, 8),
                 g.integers(0, 2 ** 32, 8)]
    elif name == "stream_bases":
        # every stream the integrator draws, at the most iterations
        # _check_streams allows, with rows 0 and 255 of each
        streams = np.array(list(range(64)) + [_RR_STREAM + it for it in
                                               range(2 * 63)])
        d = np.concatenate([(streams << 8) | 0, (streams << 8) | 255])
        m = d.size
        words = [g.integers(0, 2 ** 32, m), g.integers(0, 2 ** 32, m),
                 g.integers(0, 2 ** 32, m), d]
    else:
        words = [g.integers(0, 2 ** 32, 4096) for _ in range(4)]
    return [np.asarray(w, np.uint64).astype(np.uint32) for w in words]


@pytest.mark.parametrize("name", ["all_ones", "ids_near_2_32",
                                  "stream_bases", "random"])
def test_pcg4d_on_u32_equals_int64_chain(name):
    words = _edge_words(name)
    want = trng._pcg4d(*(torch.from_numpy(w.astype(np.int64))
                         for w in words))
    got = _pcg4d_u32(*words)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w.numpy(), g.astype(np.int64))


# ---- the forms of a launch --------------------------------------------------

KEY_FORMS = ["host", "row", "table"]
ID_FORMS = ["offset", "int32", "int64"]
# (ids form, n, stream, how the ids are drawn)
EDGES = {
    "ids_at_and_above_2_31": ("int64", 1000, 5, "high"),
    "int32_ids_negative": ("int32", 1000, 5, "high"),
    "offset_wraps_2_32": ("offset", 1000, 5, "wrap"),
    "stream_rr_max_iters": ("int32", 1000, _RR_STREAM + 63 + 62, "low"),
    "n_ragged": ("int32", 257, 3, "low"),
    "n_1": ("int64", 1, 7, "high"),
    "strided_gid_column": ("column", 1000, 9, "low"),
}


def _launch_args(key_form, ids_form, rows, n, stream, draw="low",
                 device="cpu"):
    """(args, kwargs) of one stream_uniforms call: the key as host data, a
    (2,) int64 row or a key_rows table; lane ids as an offset or an int32 /
    int64 tensor (or the int32 column of a (n, 5) tensor, as the main path's
    gid).  "low" ids lie under the table's K * lanes_per_key of a wavefront
    batch (4 x 1024); "high" and "wrap" reach past 2^31 and 2^32, where the
    table holds 4 rows of 2^30 lanes, so that every 32-bit id has a row."""
    g = np.random.default_rng([rows, n, stream, len(draw),
                               KEY_FORMS.index(key_form)])
    key = trng.fold_in(trng.sample_key(trng.key(2_999_999_977), 13), 1)
    lpk = 1024 if draw == "low" else 2 ** 30
    if draw == "low":
        ids = g.integers(0, 4 * lpk, n)
    else:
        ids = np.concatenate([[2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32,
                               2 ** 32 + 5, -1, 0],
                              g.integers(-2 ** 33, 2 ** 34, n)])[:n]
    if ids_form == "offset":
        lanes = 2 ** 32 - 300 if draw == "wrap" else 129
    elif ids_form == "int32":
        lanes = torch.from_numpy(ids.astype(np.int32)).to(device)
    elif ids_form == "int64":
        lanes = torch.from_numpy(ids.astype(np.int64)).to(device)
    else:
        block = torch.from_numpy(g.integers(0, 4 * lpk, (n, 5))).to(
            device, torch.int32)
        block[:, 4] = torch.from_numpy(ids.astype(np.int32)).to(device)
        lanes = block[:, 4]
    kw = dict(lane_offset=lanes, device=device)
    if key_form == "row":
        key = torch.from_numpy(key.astype(np.int64)).to(device)
    elif key_form == "table":
        kw.update(key_rows=trng.key_rows_tensor(trng.key_rows_for(key, 4),
                                                device),
                  lanes_per_key=lpk)
    return (key, stream, (rows, n)), kw


def _kernel_model(key, stream, shape, lane_offset=0, key_rows=None,
                  lanes_per_key=0, device=None):
    """What csrc/pcg4d.cu computes, in numpy uint32, line for line."""
    rows, n = shape
    if torch.is_tensor(lane_offset):
        ids = lane_offset.cpu().numpy().astype(np.uint32)   # low 32 bits
    else:
        ids = ((lane_offset & M32) + np.arange(n, dtype=np.uint64)).astype(
            np.uint32)
    if key_rows is not None:
        table = key_rows.cpu().numpy().astype(np.uint32)
        s = ids // np.uint32(lanes_per_key)
        a, b, c = ids % np.uint32(lanes_per_key), table[s, 0], table[s, 1]
    else:
        k = key.cpu().numpy() if torch.is_tensor(key) else np.asarray(key)
        a = ids
        b, c = (np.full(n, np.asarray(x).astype(np.uint32)) for x in k)
    out = np.empty((rows, n), np.float32)
    for r in range(rows):
        d = np.full(n, ((stream << 8) & M32) | r, np.uint32)
        d = _pcg4d_u32(a, b, c, d)[3]
        out[r] = (d >> 8).astype(np.float32) * np.float32(2.0 ** -24)
    return out


@pytest.mark.parametrize("rows", [1, 4, 11])
@pytest.mark.parametrize("ids_form", ID_FORMS)
@pytest.mark.parametrize("key_form", KEY_FORMS)
def test_kernel_model_equals_plain(key_form, ids_form, rows):
    args, kw = _launch_args(key_form, ids_form, rows, 1000, 5, "high")
    want = trng.stream_uniforms(*args, **kw)
    np.testing.assert_array_equal(_kernel_model(*args, **kw), want.numpy())


@pytest.mark.parametrize("key_form", KEY_FORMS)
@pytest.mark.parametrize("edge", list(EDGES))
def test_kernel_model_equals_plain_at_edges(edge, key_form):
    ids_form, n, stream, draw = EDGES[edge]
    args, kw = _launch_args(key_form, ids_form, 11, n, stream, draw)
    want = trng.stream_uniforms(*args, **kw)
    np.testing.assert_array_equal(_kernel_model(*args, **kw), want.numpy())


def test_cpu_path_never_loads_the_kernel(monkeypatch):
    """CPU lanes take the plain version in every form: the library is never
    built or loaded, and the wrapper counts no launch."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path loaded a CUDA library")
    monkeypatch.setattr(_build, "load", refuse)
    before = pcg4d_uniforms.launches, pcg4d_uniforms.captured
    for key_form in KEY_FORMS:
        for ids_form in ID_FORMS + ["column"]:
            args, kw = _launch_args(key_form, ids_form, 4, 300, 2)
            assert trng.stream_uniforms(*args, **kw).shape == (4, 300)
    assert (pcg4d_uniforms.launches, pcg4d_uniforms.captured) == before
    assert before == (0, 0)
    assert "pcg4d" not in _build._libs


def _bad(case):
    """Arguments of pcg4d_uniforms that it must refuse (on any device)."""
    (key, stream, shape), kw = _launch_args("table", "int32", 4, 300, 2)
    ids, table = kw["lane_offset"], kw["key_rows"]
    if case == "float_ids":
        kw["lane_offset"] = ids.float()
    elif case == "int16_ids":
        kw["lane_offset"] = ids.to(torch.int16)
    elif case == "ids_2d":
        kw["lane_offset"] = ids[:, None]
    elif case == "ids_short":
        kw["lane_offset"] = ids[:-1]
    elif case == "key_rows_without_lanes_per_key":
        del kw["lanes_per_key"]
    elif case == "key_rows_int32":
        kw["key_rows"] = table.to(torch.int32)
    elif case == "key_rows_not_contiguous":
        kw["key_rows"] = table.t().contiguous().t()
    elif case == "key_row_shape":
        del kw["key_rows"], kw["lanes_per_key"]
        key = table[:2].reshape(-1)
    elif case == "key_row_uint8":
        del kw["key_rows"], kw["lanes_per_key"]
        key = table[0].to(torch.uint8)
    return (key, stream, shape), kw


BAD = {"float_ids": "int32 or int64", "int16_ids": "int32 or int64",
       "ids_2d": "lane ids must be", "ids_short": "lane ids must be",
       "key_rows_without_lanes_per_key": "lanes_per_key",
       "key_rows_int32": "must be int64",
       "key_rows_not_contiguous": "contiguous",
       "key_row_shape": "contiguous", "key_row_uint8": "must be int64"}


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, kw = _bad(case)
    with pytest.raises(ValueError, match=BAD[case]):
        pcg4d_uniforms(*args, **kw)
    assert pcg4d_uniforms.launches == 0


@pytest.mark.parametrize("ids_form", ID_FORMS + ["column"])
def test_wrapper_takes_every_id_form_then_wants_a_card(ids_form):
    """Valid arguments, the strided gid column among them, pass every check
    and are refused only for their device."""
    args, kw = _launch_args("row", ids_form, 11, 300, 2)
    with pytest.raises(ValueError, match="CUDA device"):
        pcg4d_uniforms(*args, **kw)


# ---- on a card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _kernel_vs_plain(args, kw):
    before = pcg4d_uniforms.launches
    got = trng.stream_uniforms(*args, **kw)
    want = trng.stream_uniforms_reference(*args, **kw)
    torch.cuda.synchronize()
    assert pcg4d_uniforms.launches == before + 1
    assert got.is_contiguous() and got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4, 11])
@pytest.mark.parametrize("ids_form", ID_FORMS)
@pytest.mark.parametrize("key_form", KEY_FORMS)
def test_kernel_bit_equal_to_plain_on_card(cuda_device, key_form, ids_form,
                                           rows):
    _kernel_vs_plain(*_launch_args(key_form, ids_form, rows, 1000, 5, "high",
                                   cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("key_form", KEY_FORMS)
@pytest.mark.parametrize("edge", list(EDGES))
def test_kernel_bit_equal_to_plain_at_edges_on_card(cuda_device, edge,
                                                    key_form):
    ids_form, n, stream, draw = EDGES[edge]
    _kernel_vs_plain(*_launch_args(key_form, ids_form, 11, n, stream, draw,
                                   cuda_device))


@pytest.mark.cuda
def test_kernel_main_path_shapes_on_card(cuda_device):
    """bunny8's first bounce (11, 175,104) under a device key row, the
    merged phase (11, 191,488) under key_rows and raygen (4, 262,144)."""
    g = np.random.default_rng(0)
    key = trng.fold_in(trng.key(5), 3)
    row = torch.from_numpy(key.astype(np.int64)).to(cuda_device)
    table = trng.key_rows_tensor(trng.key_rows_for(key, 8), cuda_device)
    gid = torch.from_numpy(g.integers(0, 262_144, 175_104)).to(
        cuda_device, torch.int32)
    merged = torch.from_numpy(g.integers(0, 8 * 262_144, 191_488)).to(
        cuda_device, torch.int32)
    _kernel_vs_plain((row, 1, (11, 175_104)), dict(lane_offset=gid))
    _kernel_vs_plain((key, 6, (11, 191_488)),
                     dict(lane_offset=merged, key_rows=table,
                          lanes_per_key=262_144))
    _kernel_vs_plain((row, 0, (4, 262_144)), dict(device=cuda_device))


@pytest.mark.cuda
def test_kernel_marks_lanes_past_the_key_table(cuda_device):
    """A lane whose key row lies past the table reads NaN in every row (the
    plain version refuses it); the other lanes keep their numbers."""
    args, kw = _launch_args("table", "int64", 4, 300, 2, "low", cuda_device)
    ids = kw["lane_offset"].clone()
    ids[7] = 4 * 1024 + 3
    got = trng.stream_uniforms(*args, **dict(kw, lane_offset=ids))
    want = trng.stream_uniforms_reference(*args, **kw)
    assert torch.isnan(got[:, 7]).all()
    keep = torch.arange(300, device=cuda_device) != 7
    assert torch.equal(got[:, keep], want[:, keep])


@pytest.mark.cuda
def test_graph_counts_captured_and_replayed_launches(cuda_device):
    """A capture counts its launches in `captured`, not `launches`; a
    replay draws the numbers the host rewrote into the key row; and a
    Renderer's replayed step counts, through runtime/renderer.py
    `_COUNTERS`, the launches of an eager step."""
    from fspt_tpu_torch.config import RenderConfig
    from fspt_tpu_torch.runtime.renderer import _COUNTERS, Renderer
    from fspt_tpu_torch.testing import make_test_scene
    assert pcg4d_uniforms in _COUNTERS
    row = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    gid = torch.arange(5000, dtype=torch.int32, device=cuda_device) * 3
    trng.stream_uniforms(row, 4, (11, 5000), lane_offset=gid)   # warm-up
    launches, captured = pcg4d_uniforms.launches, pcg4d_uniforms.captured
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = trng.stream_uniforms(row, 4, (11, 5000), lane_offset=gid)
    assert (pcg4d_uniforms.launches, pcg4d_uniforms.captured) == (
        launches, captured + 1)
    for seed in (1, 2):
        key = trng.fold_in(trng.key(seed), 0)
        row.copy_(torch.from_numpy(key.astype(np.int64)))
        graph.replay()
        assert torch.equal(out, trng.stream_uniforms_reference(
            key, 4, (11, 5000), lane_offset=gid))

    cfg = RenderConfig(width=64, height=64, bounces=3, batch_spp=2,
                       intersector="split", compact=True, sort_state=True,
                       nee_env_nearest=True, escape_env_nearest=True)
    r = Renderer(make_test_scene(subdivisions=2), cfg, device="cuda")
    counts = []
    for _ in range(4):              # eager, capture and replay, replays
        before = pcg4d_uniforms.launches
        r.step()
        counts.append(pcg4d_uniforms.launches - before)
    assert r.stats["graph_replays"] >= 2
    assert counts[0] > 0 and counts[-2:] == [counts[0]] * 2


@pytest.mark.cuda
def test_no_cuda_caller_runs_the_int64_chain(cuda_device, monkeypatch):
    """Renderer raygen, bounces and compactions (the wavefront batch's
    per-sample and merged phases, and the per-sample path), the sharded
    step and the train step all draw through the kernel: the plain
    version, refused for CUDA lanes, never runs, and each counts launches."""
    from fspt_tpu_torch.config import RenderConfig
    from fspt_tpu_torch.parallel.dist import (make_mesh,
                                              make_sharded_sample_step,
                                              make_train_step,
                                              params_to_torch, shard_accum,
                                              split_params)
    from fspt_tpu_torch.runtime.renderer import CameraState, Renderer
    from fspt_tpu_torch.testing import make_test_scene

    plain = trng.stream_uniforms_reference

    def cpu_only(*a, **k):
        lanes = k.get("lane_offset")
        dev = (lanes.device if torch.is_tensor(lanes)
               else torch.device(k.get("device") or "cpu"))
        assert dev.type == "cpu", "the int64 chain ran on CUDA lanes"
        return plain(*a, **k)
    monkeypatch.setattr(trng, "stream_uniforms_reference", cpu_only)
    scene = make_test_scene(subdivisions=2)
    base = dict(width=64, height=64, bounces=3, intersector="split",
                compact=True, sort_state=True, nee_env_nearest=True,
                escape_env_nearest=True)
    calls = {}

    def counted(name, fn):
        before = pcg4d_uniforms.launches
        fn()
        torch.cuda.synchronize()
        calls[name] = pcg4d_uniforms.launches - before

    for name, kw in (("batched", dict(batch_spp=2, wavefront_batch=True,
                                      wavefront_merge_width=2048)),
                     ("per_sample", dict(batch_spp=2))):
        r = Renderer(scene, RenderConfig(**base, **kw), device="cuda")
        counted(name, lambda: [r.step() for _ in range(3)])
    cfg = RenderConfig(**base, batch_spp=2)
    mesh = make_mesh(2, device="cuda")
    step = make_sharded_sample_step(mesh, cfg, scene.meta)
    arrays = scene.to_torch("cuda")
    cam = CameraState.from_config(scene.camera, "cuda")
    accum = shard_accum(torch.zeros((3, 64 * 64)), mesh)
    count = torch.zeros((), device="cuda")
    counted("sharded", lambda: step(arrays, cam, accum, count, trng.key(0),
                                    0))
    train = make_train_step(RenderConfig(**base), scene.meta)
    params = params_to_torch(
        {f: np.asarray(v) for f, v in split_params(scene.arrays).items()},
        "cuda")
    cp = params_to_torch({"position": scene.camera.position,
                          "direction": scene.camera.direction}, "cuda")
    target = torch.full((3, 64 * 64), 0.25, device="cuda")
    counted("train", lambda: train(params, cp, arrays, cam, target,
                                   trng.key(1), 0))
    assert all(v > 0 for v in calls.values()), calls
