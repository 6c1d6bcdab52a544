"""Measuring launchers: the traversal kernels and their earlier designs,
called directly.

csrc/traverse4_v0.cu, csrc/walk_v0.cu and csrc/micro_v0.cu are the first
designs of csrc/traverse4.cu, csrc/walk.cu and csrc/micro.cu, and
`fspt_walk1_block` of csrc/walk.cu is the packet walk as one 1,024-thread
block, what `fspt_walk1` was before csrc/walk1.cu made a packet a thread
block cluster.  They are kept buildable so that a measurement can time old
against new in one process on one card.  Nothing on a render path loads
them: the ops modules know only the current sources and entry points.  This
module builds any source through ops/_build.py and returns closures that
launch one captured call without the wrappers' checks, old and new through
the same host code, so that their times compare.  `fspt_walk3_padded` (both
walk sources) is `fspt_walk3` whose blocks ask for shared memory they never
touch, which cuts the blocks an SM can hold.

Used by chip_smoke.py ([versus] and [shape] lines) and by
fspt_tpu_torch/scripts/perf_walk_launches.py and perf_r5d.py.  No launch
here adds to a wrapper's `launches` count.
"""

from __future__ import annotations

import ctypes

import torch

from fspt_tpu_torch.ops import _build
from fspt_tpu_torch.ops.traverse import PacketHit, error_flag, ray_planes
from fspt_tpu_torch.ops.traverse3 import WALK_ARGTYPES
from fspt_tpu_torch.ops.traverse4 import TRAVERSE4_ARGTYPES

TRAVERSE4_SOURCES = ("traverse4_v0", "traverse4")      # first design, current
WALK_SOURCES = ("walk_v0", "walk")
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
