"""Measuring launchers: the traversal kernels and their earlier designs,
called directly.

csrc/traverse4_v0.cu, csrc/walk_v0.cu, csrc/walk5_v0.cu, csrc/dense_mt_v0.cu
and csrc/micro_v0.cu are the first designs of csrc/traverse4.cu,
csrc/walk.cu, csrc/walk5.cu, csrc/dense_mt.cu and csrc/micro.cu, and
`fspt_walk1_block` of csrc/walk.cu is the packet walk as one 1,024-thread
block, what `fspt_walk1` was before csrc/walk1.cu made a packet a thread
block cluster.  They are kept buildable so that a measurement can time old
against new in one process on one card.  Nothing on a render path loads
them: the ops modules know only the current sources and entry points.  This
module builds any source through ops/_build.py and returns closures that
launch one captured call without the wrappers' checks, old and new through
the same host code, so that their times compare.  `fspt_walk3_padded` (both
walk sources) is `fspt_walk3` whose blocks ask for shared memory they never
touch, which cuts the blocks an SM can hold.  `fspt_walk5_stats` (the
current walk5 source) is `fspt_walk5` that also writes, for each block (a
walk), its program's bursts and the cycles the walk spent in each phase of
its substeps.

Used by chip_smoke.py ([versus] and [shape] lines), by
fspt_tpu_torch/scripts/perf_walk_launches.py, perf_walk5_forms.py and
perf_r5d.py, and by the card's tests.  No launch here adds to a wrapper's `launches` count.
"""

from __future__ import annotations

import ctypes
import inspect

import torch

from fspt_tpu_torch.ops import _build
from fspt_tpu_torch.ops.traverse import PacketHit, error_flag, ray_planes
from fspt_tpu_torch.ops.traverse3 import WALK_ARGTYPES
from fspt_tpu_torch.ops.traverse4 import TRAVERSE4_ARGTYPES

TRAVERSE4_SOURCES = ("traverse4_v0", "traverse4")      # first design, current
WALK_SOURCES = ("walk_v0", "walk")
WALK5_SOURCES = ("walk5_v0", "walk5")
DENSE_MT_SOURCES = ("dense_mt_v0", "dense_mt")
# ints a block of fspt_walk5_stats (kStats in csrc/walk5.cu): its program's
# bursts, drain bursts, drain bursts voted with no walk alive and leaves
# queued, and substeps (the bursts' lengths summed); the block's clock cycles
# from start to end and its substeps that had work; the cycles its warp 0
# spent in the burst vote, waiting for its rows and the other warps, in the
# box tests, at the votes' barrier, on pushes, planning the next substep, and
# in the drain units' tests
WALK5_STATS = ("bursts", "drain_bursts", "idle_drain_bursts", "substeps",
               "cycles", "worked", "vote", "wait", "box", "votes", "push",
               "plan", "mt")
WALK5_PHASES = WALK5_STATS[6:]
# the packet walk: (source, entry point) of the first design, of the
# 1,024-thread block that followed it, and of the current cluster kernel
WALK1_DESIGNS = (("walk_v0", "fspt_walk1"), ("walk", "fspt_walk1_block"),
                 ("walk1", "fspt_walk1"))
_PADDED = WALK_ARGTYPES + [ctypes.c_int]
WALK_FUNCTIONS = {
    "walk_v0": {"fspt_walk3": WALK_ARGTYPES, "fspt_walk1": WALK_ARGTYPES,
                "fspt_walk3_padded": _PADDED},
    "walk": {"fspt_walk3": WALK_ARGTYPES, "fspt_walk1_block": WALK_ARGTYPES,
             "fspt_walk3_padded": _PADDED},
    "walk1": {"fspt_walk1": WALK_ARGTYPES}}


def _outputs(n, dev):
    e = lambda dt: torch.empty(n, dtype=dt, device=dev)
    return PacketHit(t=e(torch.float32), slot=e(torch.int32),
                     u=e(torch.float32), v=e(torch.float32),
                     visits=e(torch.int32))


def _raise(lib, what, err):
    if err != 0:
        msg = lib.fspt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg}")


def traverse4_launcher(source, args, kw):
    """A closure that launches `fspt_traverse4` of csrc/<source>.cu on a
    captured packet_traverse4 call (args, kw) and returns its PacketHit."""
    lib = _build.load(source, {"fspt_traverse4": TRAVERSE4_ARGTYPES})
    nodes, leaves, ro, rd, tmax = args
    tmax, planes, dev = ray_planes(source, nodes, leaves, ro, rd, tmax)
    n = ro.x.shape[0]
    flag = error_flag(dev)
    ints = (n, kw["leaf_size"], kw["stack_depth"],
            int(kw.get("any_hit", False)), kw.get("tree_width", 8))

    def launch():
        hit = _outputs(n, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        # (the closure keeps the planes alive: tmax may have been made here)
        ptrs = [x.data_ptr() for x in (nodes, leaves, *planes)]
        with torch.cuda.device(dev):
            err = lib.fspt_traverse4(*ptrs, *ints,
                                     *(x.data_ptr() for x in hit),
                                     flag.data_ptr(), ctypes.c_void_p(stream))
        _raise(lib, source, err)
        return hit
    return launch


def walk_launcher(source, args, kw, fn_name="fspt_walk3", pad_bytes=0):
    """A closure that launches `fn_name` of csrc/<source>.cu on a captured
    group-walk call (args, kw) and returns its PacketHit; with `pad_bytes`,
    `fspt_walk3_padded`.  A source that is a build variant of another
    (csrc/walk_divide.cu) has that one's entry points."""
    lib = _build.load(source, WALK_FUNCTIONS.get(source,
                                                 WALK_FUNCTIONS["walk"]))
    nodes, leaves, ro, rd, tmax = args
    tmax, planes, dev = ray_planes(source, nodes, leaves, ro, rd, tmax)
    n = ro.x.shape[0]
    flag = error_flag(dev)
    ints = (n, kw["leaf_size"], kw["stack_depth"], kw.get("tree_width", 8),
            int(kw.get("any_hit", False)), 0)
    if pad_bytes:
        if fn_name != "fspt_walk3":
            raise ValueError("only fspt_walk3 has a padded entry point")
        fn, tail = lib.fspt_walk3_padded, (pad_bytes,)
    else:
        fn, tail = getattr(lib, fn_name), ()

    def launch():
        hit = _outputs(n, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        # (the closure keeps the planes alive: tmax may have been made here)
        head = (nodes.data_ptr(), leaves.data_ptr(), nodes.shape[0],
                leaves.shape[0], *(x.data_ptr() for x in planes))
        with torch.cuda.device(dev):
            err = fn(*head, *ints, *(x.data_ptr() for x in hit),
                     flag.data_ptr(), ctypes.c_void_p(stream), *tail)
        _raise(lib, f"{source} {fn_name}", err)
        return hit
    return launch


def micro_launcher(source, table, rays, variant, k):
    """A closure that launches `fspt_micro` of csrc/<source>.cu ("micro_v0",
    the first design, or "micro") on the inputs of perf_r5d.micro and
    returns its (1, 8, 128) output."""
    from fspt_tpu_torch.scripts.perf_r5d import (LANES, MICRO_ARGTYPES,
                                                 VARIANTS, WALKS)
    lib = _build.load(source, {"fspt_micro": MICRO_ARGTYPES})
    dev = table.device
    index = VARIANTS.index(variant)

    def launch():
        out = torch.empty((1, WALKS, LANES), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.fspt_micro(table.data_ptr(), table.shape[0],
                                 rays.data_ptr(), out.data_ptr(), index, k,
                                 ctypes.c_void_p(stream))
        _raise(lib, f"{source} {variant}", err)
        return out
    return launch


def _defaults(fn):
    """A wrapper's keyword defaults: what a captured call left out."""
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.kind == p.KEYWORD_ONLY}


def walk5_launcher(source, args, kw, stats=None):
    """A closure that launches `fspt_walk5` of csrc/<source>.cu ("walk5_v0",
    the first design, or "walk5") on a captured packet_traverse5 call
    (args, kw) and returns its PacketHit.  With `stats`, an int32 tensor of
    (blocks, len(WALK5_STATS)) (traverse5_proto.walk5_geometry), the current
    source's `fspt_walk5_stats` fills it as well."""
    from fspt_tpu_torch.scripts.traverse5_proto import (WALK5_ARGTYPES,
                                                         packet_traverse5)
    fn_name = "fspt_walk5" if stats is None else "fspt_walk5_stats"
    types = WALK5_ARGTYPES + ([] if stats is None else [ctypes.c_void_p])
    lib = _build.load(source, {fn_name: types})
    nodes, leaves, ro, rd, tmax = args
    tmax, planes, dev = ray_planes(source, nodes, leaves, ro, rd, tmax)
    n = ro.x.shape[0]
    flag = error_flag(dev)
    kw = {**_defaults(packet_traverse5), **kw}
    ints = (n, *(kw[k] for k in ("leaf_size", "stack_depth", "qcap",
                                 "unroll")),
            kw["drain_unroll"] if kw["drain_unroll"] > 0 else kw["unroll"],
            kw["npop"], kw["lpop"], kw["tree_width"], int(kw["any_hit"]))
    tail = () if stats is None else (stats.data_ptr(),)

    def launch():
        hit = _outputs(n, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (nodes.data_ptr(), leaves.data_ptr(), nodes.shape[0],
                leaves.shape[0], *(x.data_ptr() for x in planes))
        with torch.cuda.device(dev):
            err = getattr(lib, fn_name)(
                *head, *ints, *(x.data_ptr() for x in hit), flag.data_ptr(),
                ctypes.c_void_p(stream), *tail)
        _raise(lib, f"{source} {fn_name}", err)
        return hit
    return launch


def walk5_occupancy(kw, source="walk5"):
    """(clusters the card holds at once, blocks an SM) of the walk5 kernel
    of csrc/<source>.cu (the current one, or a form of it) at a
    packet_traverse5 call's sizes, from cudaOccupancyMaxActiveClusters and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    from fspt_tpu_torch.scripts.traverse5_proto import packet_traverse5
    out = ctypes.POINTER(ctypes.c_int)
    lib = _build.load(source, {"fspt_walk5_occupancy": [ctypes.c_int] * 4
                               + [out, out]})
    kw = {**_defaults(packet_traverse5), **kw}
    clusters, blocks = ctypes.c_int(), ctypes.c_int()
    _raise(lib, "walk5 occupancy", lib.fspt_walk5_occupancy(
        kw["tree_width"], int(kw["any_hit"]), kw["stack_depth"], kw["qcap"],
        ctypes.byref(clusters), ctypes.byref(blocks)))
    return clusters.value, blocks.value


def dense_mt_launcher(source, tile_tl, tris, rays, T):
    """A closure that launches `fspt_dense_mt` of csrc/<source>.cu
    ("dense_mt_v0", the first design, or "dense_mt") on dense_mt's inputs
    and returns its (t, slot)."""
    from fspt_tpu_torch.scripts.perf_r5_treelet import DENSE_MT_ARGTYPES
    lib = _build.load(source, {"fspt_dense_mt": DENSE_MT_ARGTYPES})
    dev = tris.device
    n_tiles = tile_tl.shape[0]

    def launch():
        t = torch.empty((n_tiles, 8, 128), dtype=torch.float32, device=dev)
        slot = torch.empty((n_tiles, 8, 128), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.fspt_dense_mt(tile_tl.data_ptr(), tris.data_ptr(),
                                    tris.shape[0], rays.data_ptr(),
                                    t.data_ptr(), slot.data_ptr(), n_tiles, T,
                                    ctypes.c_void_p(stream))
        _raise(lib, f"{source} T={T}", err)
        return t, slot
    return launch
