"""Packet BVH traversal, v1: the port of fspt_tpu.ops.traverse.packet_traverse,
and what the port's three traversal ops share (PacketHit, the error flag).

Contract (that of the JAX kernel): for N rays (origin, direction, tmax) over
the 8-wide packed tables of ops/packing.py, return `PacketHit(t, slot, u, v,
visits)` — the nearest hit (t = tmax and slot = -1 on a miss), or, with
`any_hit`, some hit.  slot is `leaf * leaf_size + j`; (u, v) are the hit's
barycentrics.

How it walks.  Rays go in packets of 1024 consecutive rays (the last one
padded with parked rays: origin 1e9, direction +y, tmax 0).  All rays of a
packet walk ONE shared node sequence with one shared stack: a visit
slab-tests the node's 8 children for every ray, and pushes a child if any
ray of the packet wants it, near to far by the node's sort axis and the
packet's majority direction sign.  `visits` is the packet's count of node
and leaf visits, the same for all its rays.  Any-hit ends the walk after a
leaf visit once every ray has a hit (or tmax <= 0).

This is `ops/traverse3.py`'s group walk at group size 1024 with v1's any-hit
rule, and the plain version is shared with it.  The CUDA kernel is
`fspt_walk1` of csrc/walk1.cu: a packet is a thread block cluster of CLUSTER
blocks, each with 1024 / CLUSTER of the packet's rays and its own replica of
the stack, and the packet's vote crosses the blocks through distributed
shared memory (`packet_geometry` is the launch it makes).  Its ray tests are
csrc/walk.cu's (csrc/walk_common.cuh).  Deviations from the JAX kernel:
  * no VMEM table budget (`check_vmem_budget`): that is a limit of the
    TPU's vector memory; the CUDA kernel reads the tables from device
    memory, so the port takes tables of any size;
  * the stack is exact up to `stack_depth` live entries and a walk past it
    raises (the JAX kernel clamps the write into its last slot);
  * the majority sign sums a packet's directions in one fixed order
    (pairwise halving), where XLA's order is its own: a packet whose sum
    lies within rounding of 0 may visit its nodes in another order (same
    hits up to coplanar ties, other `visits`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from fspt_tpu_torch.core.vec import V3

MAX_T = 1.0e5                                   # reference tracer.fs:10
SENTINEL = int(np.iinfo(np.int32).min)          # stack-empty marker
ROW = 128                                       # floats per packed table row
PACKET = 1024                                   # rays per v1 packet
CLUSTER = 8            # thread blocks a packet: kCluster in csrc/walk1.cu
CONTROL_THREADS = 64                            # two control warps a block


class PacketHit(NamedTuple):
    t: torch.Tensor        # (N,) f32 hit distance (tmax on miss)
    slot: torch.Tensor     # (N,) i32 padded triangle slot (-1 on miss)
    u: torch.Tensor        # (N,) f32 barycentric weight of corner 1
    v: torch.Tensor        # (N,) f32 barycentric weight of corner 2
    visits: torch.Tensor   # (N,) i32 visit count (per ray or per group,
    #                        by op: see each module)


def safe_inv(d):
    tiny = torch.where(d < 0, torch.full_like(d, -1e-20),
                       torch.full_like(d, 1e-20))
    return 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)


def check_tables(name, nodes, leaves, leaf_size, stack_depth):
    if leaf_size * 9 > ROW:
        raise ValueError(f"leaf_size {leaf_size} needs {leaf_size * 9} "
                         "lanes of a 128-lane row")
    for what, t in (("nodes", nodes), ("leaves", leaves)):
        if t.dim() != 2 or t.shape[1] != ROW:
            raise ValueError(f"{name}: {what} must be (rows, 128), got "
                             f"{tuple(t.shape)}")
    if stack_depth < 1:
        raise ValueError(f"{name}: stack_depth must be >= 1, got "
                         f"{stack_depth}")


def ray_planes(name, nodes, leaves, origin: V3, direction: V3, tmax):
    """(tmax, the 7 ray planes, device): tmax defaults to MAX_T, and every
    tensor must lie on the tables' device."""
    n = origin.x.shape[0]
    if tmax is None:
        tmax = torch.full((n,), MAX_T, dtype=torch.float32,
                          device=origin.x.device)
    planes = (*origin, *direction, tmax)
    devices = {x.device for x in (nodes, leaves, *planes)}
    if len(devices) != 1:
        raise ValueError(f"{name} inputs span devices {devices}")
    dev = nodes.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    return tmax, planes, dev


def check_kernel_inputs(name, nodes, leaves, planes, n):
    for x in (nodes, leaves, *planes):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} takes contiguous float32 tensors")
    if any(x.shape != (n,) for x in planes):
        raise ValueError(f"{name}: ray planes and tmax must all be (N,)")


# ---- the kernels' per-device error flag -----------------------------------

_error_flags = {}


def error_flag(device) -> torch.Tensor:
    """The per-device int32 pair the traversal kernels bump: [0] counts
    walks that overflowed their stack, [1] walks stopped by the step
    backstop."""
    key = torch.device(device).index
    if key is None:
        key = torch.cuda.current_device()
    flag = _error_flags.get(key)
    if flag is None:
        flag = torch.zeros(2, dtype=torch.int32, device=f"cuda:{key}")
        _error_flags[key] = flag
    return flag


def _capturing(device) -> bool:
    """Whether `device`'s current stream captures a CUDA graph (a CPU
    device never does)."""
    if torch.device(device).type != "cuda":
        return False
    with torch.cuda.device(device):
        return torch.cuda.is_current_stream_capturing()


def count_launch(counter, device):
    """Count one launch of a traversal kernel (or of other counted device
    work: ops/pcg4d.py, core/integrator.py scene_tables) on `device`'s
    current stream: in `counter.launches`, or, while that stream captures
    a CUDA graph, in `counter.captured` (the graph's replays launch it;
    the replays add to `launches`, runtime/renderer.py StepGraph)."""
    if _capturing(device):
        counter.captured += 1
    else:
        counter.launches += 1


def count_lanes(counter, device, n: int):
    """Count the n rays handed to one call of a traversal op on `device`:
    in `counter.lanes`, or, while its stream captures a CUDA graph, in
    `counter.lanes_captured` (each replay adds them to `lanes`,
    runtime/renderer.py StepGraph).  Known on the host from the rays'
    shape, so nothing is read from the device.  Unlike `launches`, a call
    on the CPU (the plain version) counts too."""
    if _capturing(device):
        counter.lanes_captured += n
    else:
        counter.lanes += n


def check_stack_overflow(device):
    """Raise if a traversal kernel launched on `device` overflowed a stack
    or ran away since the last check.  Reads a device flag: call after a
    synchronise."""
    if torch.device(device).type != "cuda":
        return
    flag = error_flag(device)
    overflow, runaway = (int(x) for x in flag.tolist())
    if overflow or runaway:
        flag.zero_()
        raise RuntimeError(
            f"traversal: {overflow} walk(s) overflowed the traversal stack "
            f"(raise cfg.stack_depth) and {runaway} ran past the step "
            "backstop")


def capture_launches(module, name, run):
    """The (args, kwargs) of every call that `run()` makes to module.<name>
    (a kernel wrapper as the integrator calls it), which still runs: the
    launches a measurement or a test replays."""
    real = getattr(module, name)
    calls = []

    def capture(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    setattr(module, name, capture)
    try:
        run()
    finally:
        setattr(module, name, real)
    return calls


# ---- the least time a traversal launch could take on one H100 -------------

H100_BYTES_PER_S = 3.35e12     # published HBM3 rate of the SXM card
H100_F32_OPS_PER_S = 67.0e12   # published float32 rate outside tensor cores
#                                (a fused multiply-add counts as two; the
#                                kernels are built with --fmad=false, so half
#                                of it is the most they can reach)
SLAB_OPS = 20    # one child's box test: 6 sub, 6 mul, 4 min/max (a box has
#                  lo <= hi, so the sign of the ray's inverse direction names
#                  the near and the far plane of each axis), 4 compares
TRI_OPS = 55     # one Möller–Trumbore test: 46 add/sub/mul, 1 divide, 8
#                  compares and absolute values


def valid_children(rows, tree_width: int):
    """Per node row (..., 128): its children with a valid link."""
    return (rows[..., 6 * tree_width:7 * tree_width] > -1.0e8).sum(-1)


def real_triangles(rows, leaf_size: int):
    """Per leaf row (..., 128): its slots that hold a triangle (a padding
    slot is all zeros: no edge, a determinant of 0, never a hit)."""
    slots = rows[..., :9 * leaf_size].reshape(*rows.shape[:-1], leaf_size, 9)
    return (slots[..., 3:] != 0.0).any(-1).sum(-1)


def tally_visits(counts: dict, kind: str, rows, lanes: int,
                 slots: int) -> None:
    """Add to `counts` what a plain version's loop iteration visited:
    `rows` (k, 128), the table rows of k visits of `kind` ("node" with
    slots = tree_width, or "leaf" with slots = leaf_size) by `lanes` rays
    each.  "node" and "leaf" count visits, "children" and "triangles" the
    valid children and real triangles those visits tested, all once per
    lane."""
    sub, per_row = (("children", valid_children) if kind == "node"
                    else ("triangles", real_triangles))
    counts[kind] = counts.get(kind, 0) + rows.shape[0] * lanes
    counts[sub] = counts.get(sub, 0) + int(per_row(rows, slots).sum()) * lanes


def traversal_bound(lanes: int, tree_width: int, leaf_size: int,
                    table_rows: int, node_visits: int, leaf_visits: int, *,
                    child_tests: int | None = None,
                    tri_tests: int | None = None, group: int = 1,
                    in_planes: int = 7, out_planes: int = 5) -> dict:
    """The least time one H100 could take for a traversal launch: the larger
    of its bytes over the card's memory rate and its float operations over
    the card's float32 rate.

    lanes: rays of the launch; node_visits, leaf_visits: the launch's
    measured visit counts, each counted once per lane (a group walk's visit
    counts once for every lane of the group, because every lane does its
    arithmetic; `group` is the lanes that share one row fetch).
    child_tests, tri_tests: the valid children and the real triangles those
    visits tested, counted the same way (the `counts` tally of the plain
    versions); an empty child slot or a leaf's padding slot needs no
    arithmetic.  Left out, every slot counts (tree_width a node visit,
    leaf_size a leaf visit): the most the launch could need.
    Bytes: each ray plane read once (in_planes x 4 B a lane), each hit plane
    written once (out_planes x 4 B), and each table row that the visits can
    have touched read once (512 B; at most one row per fetch, at most the
    whole table).  Operations: SLAB_OPS a child test, TRI_OPS a triangle
    test.
    Returns {"bytes", "flops", "bytes_ms", "flops_ms", "bound_ms",
    "bound_by" ("bytes" or "operations")}."""
    if child_tests is None:
        child_tests = node_visits * tree_width
    if tri_tests is None:
        tri_tests = leaf_visits * leaf_size
    fetches = -(-(node_visits + leaf_visits) // group)
    nbytes = (lanes * (in_planes + out_planes) * 4
              + min(table_rows, fetches) * ROW * 4)
    flops = child_tests * SLAB_OPS + tri_tests * TRI_OPS
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    flops_ms = flops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
            "flops_ms": flops_ms, "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def packet_traverse_reference(nodes, leaves, origin: V3, direction: V3,
                              tmax=None, *, leaf_size: int = 8,
                              any_hit: bool = False, stack_depth: int = 64,
                              counts: dict | None = None) -> PacketHit:
    """Plain PyTorch version of the v1 kernel (ops/traverse3's group walk at
    1024 rays a group, v1 rules)."""
    from fspt_tpu_torch.ops.traverse3 import group_walk_reference
    return group_walk_reference(
        nodes, leaves, origin, direction, tmax, group=PACKET, tree_width=8,
        leaf_size=leaf_size, any_hit=any_hit, stack_depth=stack_depth,
        v1=True, counts=counts)


def packet_geometry(n: int) -> dict:
    """The launch csrc/walk1.cu makes for n rays, a packet a cluster of
    CLUSTER blocks: {"packets", "blocks" (the grid: whole clusters),
    "threads" (a block: its rays and the control warps), "rays_per_block",
    "pad_rays" (pad rays that fill the last packet), "pad_blocks" (blocks
    of the last cluster that hold pad rays only)}.  The kernel library
    answers the same question for its own launch (`kernel_geometry`); the
    card's tests hold the two together."""
    if n < 0:
        raise ValueError(f"packet_geometry: n must be >= 0, got {n}")
    per_block = PACKET // CLUSTER
    packets = -(-n // PACKET)
    blocks = packets * CLUSTER
    return {"packets": packets, "blocks": blocks,
            "threads": per_block + CONTROL_THREADS,
            "rays_per_block": per_block, "pad_rays": packets * PACKET - n,
            "pad_blocks": blocks - -(-n // per_block)}


def load_walk1() -> ctypes.CDLL:
    """The packet-walk kernel library (csrc/walk1.cu), built on first
    call."""
    from fspt_tpu_torch.ops import _build
    from fspt_tpu_torch.ops.traverse3 import WALK_ARGTYPES
    return _build.load("walk1", {"fspt_walk1": WALK_ARGTYPES})


def kernel_geometry(n: int) -> tuple[int, int]:
    """(blocks, threads a block) of the launch `fspt_walk1` makes for n
    rays, asked of the built library; it launches nothing."""
    from fspt_tpu_torch.ops import _build
    out = ctypes.POINTER(ctypes.c_int)
    lib = _build.load("walk1",
                      {"fspt_walk1_geometry": [ctypes.c_int, out, out]})
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    lib.fspt_walk1_geometry(n, ctypes.byref(blocks), ctypes.byref(threads))
    return blocks.value, threads.value


def packet_traverse(nodes, leaves, origin: V3, direction: V3, tmax=None, *,
                    leaf_size: int = 8, any_hit: bool = False,
                    stack_depth: int = 64) -> PacketHit:
    """v1 packet traversal over 8-wide tables; see the module docstring.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    (`fspt_walk1` of csrc/walk1.cu, a cluster launch) on the current stream
    or raise; every launch adds one to `packet_traverse.launches`, and
    every call its rays to `packet_traverse.lanes` (`count_lanes`)."""
    from fspt_tpu_torch.ops.traverse3 import launch_walk
    tmax, planes, dev = ray_planes("packet_traverse", nodes, leaves, origin,
                                   direction, tmax)
    count_lanes(packet_traverse, dev, planes[0].shape[0])
    if dev.type == "cpu":
        return packet_traverse_reference(
            nodes, leaves, origin, direction, tmax, leaf_size=leaf_size,
            any_hit=any_hit, stack_depth=stack_depth)
    return launch_walk("packet_traverse", "fspt_walk1", packet_traverse,
                       nodes, leaves, planes, leaf_size=leaf_size,
                       any_hit=any_hit, stack_depth=stack_depth,
                       tree_width=8, lane_counts=False, load=load_walk1)


packet_traverse.launches = 0
packet_traverse.captured = 0
packet_traverse.lanes = 0
packet_traverse.lanes_captured = 0
