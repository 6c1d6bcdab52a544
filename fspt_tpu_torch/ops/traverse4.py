"""BVH traversal over the packed node+leaf tables: the port of
fspt_tpu.ops.traverse4.packet_traverse4.

Contract (that of the JAX kernel): for N rays (origin, direction, tmax) over
the 8- or 16-wide tables of ops/packing.py, return `PacketHit(t, slot, u, v,
visits)` — the nearest hit (t = tmax and slot = -1 on a miss), or, with
`any_hit`, some hit (the walk ends at the first one).  slot is
`leaf * leaf_size + j`; (u, v) are the hit's barycentrics.

How it walks.  The TPU kernel advanced 8x128-ray lockstep walks with a
phase split between node bursts and leaf-drain bursts; on Hopper each ray
walks alone with its own stack, as the GLSL original did
(tracer.fs:366-404); the CUDA kernel gives a ray 8 lanes of a warp, one per
child or triangle, and the plain version a row of a tensor.  A pop visits
one entry: a node slab-tests its
children and pushes the wanted ones (nodes and leaves alike) far to near,
so the nearest is popped next; a leaf runs Möller–Trumbore over its
triangles.  Children go near to far by the node's sort axis (lane 7*width) and
*the ray's own* direction sign on it (the TPU used the walk's majority
sign).  A child is wanted iff (tmax >= tmin) & (tmax > 0) & (tmin < bt) and
its link is not the empty-slot marker (<= -1e8).  safe_inv and the MT
epsilons and comparisons are those of the TPU kernel, including the strict
`tt < bt`, so hits agree with it up to coplanar ties.

`visits` differs in meaning: it counts the ray's OWN node and leaf fetches,
where the TPU kernel reported the shared fetch count of its 128-ray walk.
Under intersector="split", TraceStats.visits and Renderer.step_metrics'
visits_per_lane therefore measure per-ray work in the port (under "walk"
and "packet" they are per group, as on the TPU: ops/traverse3).

The stack holds max(cfg.stack_depth, meta.pk_stack_depth) + 2*width
entries (core/integrator.intersect).  A push past it is never dropped
silently (the TPU kernel's one-hot write would lose it): the plain version
raises, and the kernel counts it in the per-device flag of ops/traverse.py
that `check_stack_overflow` raises on (Renderer.step calls it after its
synchronise).

The table-size budget of the TPU path (`check_vmem_budget`, 12 MiB of
VMEM) does not apply: the CUDA kernel reads the tables from device memory
through the L2, so the port's "split" takes tables of any size.

`packet_traverse4` dispatches on the rays' device: the plain version for
CPU tensors; for CUDA tensors the hand-written kernel (csrc/traverse4.cu),
or an exception.  `packet_traverse4_reference` is the plain version: a
vectorised per-ray stack walk that follows the kernel's visit order and
float32 arithmetic operation for operation, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.ops import _build
from fspt_tpu_torch.ops.traverse import (MAX_T, PacketHit,  # noqa: F401
                                         check_kernel_inputs,
                                         check_stack_overflow, check_tables,
                                         count_lanes, count_launch,
                                         error_flag, ray_planes, safe_inv,
                                         tally_visits)

WIDTHS = (8, 16)       # tree widths of ops/packing.py the kernel takes
STACK_CAP = 256        # compile-time stack capacity of the CUDA kernel


def _check_args(nodes, leaves, leaf_size, stack_depth, tree_width):
    if tree_width not in WIDTHS:
        raise ValueError(f"traverse4 takes 8- or 16-wide tables, got "
                         f"tree_width={tree_width}")
    check_tables("traverse4", nodes, leaves, leaf_size, stack_depth)


def packet_traverse4_reference(nodes, leaves, origin: V3, direction: V3,
                               tmax=None, *, leaf_size: int = 8,
                               any_hit: bool = False, stack_depth: int = 64,
                               tree_width: int = 8,
                               counts: dict | None = None) -> PacketHit:
    """Plain PyTorch version of the kernel: every ray pops one stack entry
    per loop iteration, in the kernel's order, until all stacks are empty.
    `counts`, when given, has the launch's node and leaf visits added to
    its "node" and "leaf" entries (their sum is `visits.sum()`), and the
    valid children and real triangles those visits tested to "children"
    and "triangles" (ops/traverse.py `tally_visits`)."""
    _check_args(nodes, leaves, leaf_size, stack_depth, tree_width)
    dev = nodes.device
    n = origin.x.shape[0]
    ox, oy, oz = origin
    dx, dy, dz = direction
    if tmax is None:
        tmax = torch.full((n,), MAX_T, dtype=torch.float32, device=dev)
    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)
    bt = tmax.clone()
    bs = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(n, dtype=torch.float32, device=dev)
    bv = torch.zeros(n, dtype=torch.float32, device=dev)
    vis = torch.zeros(n, dtype=torch.int32, device=dev)
    stack = torch.zeros((n, stack_depth), dtype=torch.int32, device=dev)
    ptr = torch.ones(n, dtype=torch.int64, device=dev)   # root pushed
    tw = tree_width
    cols = torch.arange(tw, device=dev)

    live = torch.arange(n, device=dev)
    while live.numel():
        p = ptr[live] - 1
        ptr[live] = p
        link = stack[live, p]
        vis[live] += 1
        is_node = link >= 0

        # ---- node visits: slab-test 8 children, push the wanted far->near
        r = live[is_node]
        if r.numel():
            row = nodes[link[is_node].long()]
            if counts is not None:
                tally_visits(counts, "node", row, 1, tw)
            oxr, oyr, ozr = ox[r, None], oy[r, None], oz[r, None]
            ixr, iyr, izr = ix[r, None], iy[r, None], iz[r, None]
            lane = lambda k: row[:, k * tw:(k + 1) * tw]
            t1x = (lane(0) - oxr) * ixr
            t2x = (lane(3) - oxr) * ixr
            t1y = (lane(1) - oyr) * iyr
            t2y = (lane(4) - oyr) * iyr
            t1z = (lane(2) - ozr) * izr
            t2z = (lane(5) - ozr) * izr
            tmin = torch.fmax(torch.fmax(torch.fmin(t1x, t2x),
                                         torch.fmin(t1y, t2y)),
                              torch.fmin(t1z, t2z))
            tmx = torch.fmin(torch.fmin(torch.fmax(t1x, t2x),
                                        torch.fmax(t1y, t2y)),
                             torch.fmax(t1z, t2z))
            links = row[:, 6 * tw:7 * tw]
            want = ((tmx >= tmin) & (tmx > 0.0) & (tmin < bt[r, None])
                    & (links > -1.0e8))
            axis = row[:, 7 * tw]
            fwd = torch.where(axis == 0.0, dx[r] >= 0.0,
                              torch.where(axis == 1.0, dy[r] >= 0.0,
                                          dz[r] >= 0.0))
            # push order: children tw-1..0 when fwd (child 0 ends on top)
            order = torch.where(fwd[:, None], tw - 1 - cols, cols)
            want = torch.gather(want, 1, order)
            links = torch.gather(links, 1, order).to(torch.int32)
            pos = ptr[r, None] + torch.cumsum(want, 1) - 1
            top = ptr[r] + want.sum(1)
            if int(top.max()) > stack_depth:
                raise RuntimeError(
                    f"traverse4: stack overflow (needs "
                    f"{int(top.max())} > stack_depth={stack_depth})")
            rr, cc = torch.nonzero(want, as_tuple=True)
            stack[r[rr], pos[rr, cc]] = links[rr, cc]
            ptr[r] = top

        # ---- leaf visits: Möller–Trumbore over the leaf's triangles -------
        r = live[~is_node]
        if r.numel():
            leaf = -link[~is_node] - 1
            row = leaves[leaf.long()]
            if counts is not None:
                tally_visits(counts, "leaf", row, 1, leaf_size)
            oxr, oyr, ozr = ox[r], oy[r], oz[r]
            dxr, dyr, dzr = dx[r], dy[r], dz[r]
            bt_r, bs_r, bu_r, bv_r = bt[r], bs[r], bu[r], bv[r]
            slot_base = leaf * leaf_size
            for j in range(leaf_size):
                c = [row[:, 9 * j + i] for i in range(9)]
                px = dyr * c[8] - dzr * c[7]
                py = dzr * c[6] - dxr * c[8]
                pz = dxr * c[7] - dyr * c[6]
                det = c[3] * px + c[4] * py + c[5] * pz
                inv = 1.0 / torch.where(torch.abs(det) < 1e-6,
                                        torch.ones_like(det), det)
                tx = oxr - c[0]
                ty = oyr - c[1]
                tz = ozr - c[2]
                uu = (tx * px + ty * py + tz * pz) * inv
                qx = ty * c[5] - tz * c[4]
                qy = tz * c[3] - tx * c[5]
                qz = tx * c[4] - ty * c[3]
                ww = (dxr * qx + dyr * qy + dzr * qz) * inv
                tt = (c[6] * qx + c[7] * qy + c[8] * qz) * inv
                ok = ((torch.abs(det) >= 1e-6)
                      & (uu >= 0.0) & (uu <= 1.0) & (ww >= 0.0)
                      & (uu + ww <= 1.0) & (tt > 1e-6) & (tt < bt_r))
                bt_r = torch.where(ok, tt, bt_r)
                bs_r = torch.where(ok, slot_base + j, bs_r)
                bu_r = torch.where(ok, uu, bu_r)
                bv_r = torch.where(ok, ww, bv_r)
            bt[r], bs[r], bu[r], bv[r] = bt_r, bs_r, bu_r, bv_r
            if any_hit:
                ptr[r] = torch.where(bs_r >= 0, 0, ptr[r])

        live = live[ptr[live] > 0]
    return PacketHit(t=bt, slot=bs, u=bu, v=bv, visits=vis)


# ---- the CUDA kernel ------------------------------------------------------

_F, _I = ctypes.c_void_p, ctypes.c_int
TRAVERSE4_ARGTYPES = (
    [_F] * 9                   # nodes, leaves, ox oy oz dx dy dz tmax
    + [_I] * 5                 # n, leaf_size, stack_depth, any_hit,
    #                            tree_width
    + [_F] * 6                 # t, slot, u, v, visits, error flag
    + [_F])                    # stream


def load_traverse4() -> ctypes.CDLL:
    """The traverse4 kernel library (csrc/traverse4.cu), built on first
    call."""
    return _build.load("traverse4", {"fspt_traverse4": TRAVERSE4_ARGTYPES})


def _launch(nodes, leaves, planes, n, leaf_size, any_hit, stack_depth,
            tree_width):
    lib = load_traverse4()
    dev = nodes.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    visits = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return PacketHit(t=t, slot=slot, u=u, v=v, visits=visits)
    flag = error_flag(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [x.data_ptr() for x in (nodes, leaves, *planes)]
    with torch.cuda.device(dev):
        err = lib.fspt_traverse4(
            *ptrs, n, leaf_size, stack_depth, int(any_hit), tree_width,
            t.data_ptr(), slot.data_ptr(), u.data_ptr(), v.data_ptr(),
            visits.data_ptr(), flag.data_ptr(), ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.fspt_cuda_error_string(err).decode()
        raise RuntimeError(f"traverse4 kernel launch failed: {msg}")
    count_launch(packet_traverse4, dev)
    return PacketHit(t=t, slot=slot, u=u, v=v, visits=visits)


def packet_traverse4(nodes, leaves, origin: V3, direction: V3, tmax=None, *,
                     leaf_size: int = 8, any_hit: bool = False,
                     stack_depth: int = 64,
                     tree_width: int = 8) -> PacketHit:
    """Nearest-hit (or any-hit) traversal; see the module docstring.

    CPU tensors take the plain version.  CUDA tensors launch the kernel on
    the current stream (asynchronously) or raise; every launch adds one to
    `packet_traverse4.launches`, and every call its rays to
    `packet_traverse4.lanes` (ops/traverse.py `count_lanes`)."""
    n = origin.x.shape[0]
    tmax, planes, dev = ray_planes("traverse4", nodes, leaves, origin,
                                   direction, tmax)
    count_lanes(packet_traverse4, dev, n)
    if dev.type == "cpu":
        return packet_traverse4_reference(
            nodes, leaves, origin, direction, tmax, leaf_size=leaf_size,
            any_hit=any_hit, stack_depth=stack_depth, tree_width=tree_width)
    _check_args(nodes, leaves, leaf_size, stack_depth, tree_width)
    if stack_depth > STACK_CAP:
        raise ValueError(f"stack_depth {stack_depth} exceeds the kernel's "
                         f"capacity {STACK_CAP}")
    check_kernel_inputs("traverse4", nodes, leaves, planes, n)
    return _launch(nodes, leaves, planes, n, leaf_size, any_hit, stack_depth,
                   tree_width)


packet_traverse4.launches = 0
packet_traverse4.captured = 0
packet_traverse4.lanes = 0
packet_traverse4.lanes_captured = 0
