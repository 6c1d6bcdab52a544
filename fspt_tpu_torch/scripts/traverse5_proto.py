"""Packet BVH traversal, v5 prototype: MIXED multi-pop substeps (port of
scripts/traverse5_proto.py).

MEASURED NO-GO on the TPU (scripts/perf_r5i.py, the captured bounce-0
launch, TPU v5e): v4 43.9 ms against v5 46.8-61.8 ms across the (npop,
lpop, unroll) sweep, hits bit-identical.  Leaves drain as fast as node
substeps produce them, so the queue is near-empty most of the time and the
lpop drain units mostly run masked, while node descent, not leaf testing,
dominates the visit mix.  Kept, like the JAX file, as a measurement study;
not part of the render path.

Contract (that of the JAX kernel): PacketHit(t, slot, u, v, visits) for N
rays over the packed tables of ops/packing.py, 8 or 16 wide; `visits` is
the count of node and leaf fetches of the ray's 128-ray walk.  The hits
equal the other traversals' up to coplanar ties.

How it walks (all of it read from the JAX kernel, and all of it changes
`visits`).  A program is `walks` x 128 rays (walks = 8); N is padded to a
multiple of it with parked rays (origin 1e9, direction +y, tmax 0).  Each
128-ray walk has its own majority direction sign, its own node stack
(stack[0] the sentinel, ptr = 1 at the root) and its own LIFO leaf queue:
  * a burst vote is taken per program, once per burst: pure drain when
    max(qlen) + tree_width*unroll*npop > qcap, or when no walk has node
    work left but leaves are queued; else mixed.  The burst runs
    `drain_unroll` (pure drain) or `unroll` (mixed) substeps of that kind;
  * a mixed substep takes, in order: lpop drain selections from the ENTRY
    queue (`taken = min(qlen, lpop)`); npop node units (`cur` plus
    pre-pops, each needing ptr >= 2 and a live walk); each unit's child
    wants against the ENTRY best t (a child is wanted when any lane's slab
    test passes and its link is valid); pushes and leaf appends unit
    npop-1 down to 0, children in the sign order, appends starting at
    qlen - taken; only then the drain units' Möller–Trumbore, which updates
    best t; visits += node units + taken;
  * a pure drain substep runs npop+lpop drain units;
  * any-hit ends a walk after a substep once all its lanes have a hit or
    tmax <= 0;
  * a program ends when no walk has work (a node or queued leaves) with
    visits below max_steps = 8 * (table rows + 64).

`packet_traverse5` dispatches on the tensors' device: the plain version
(`packet_traverse5_reference`, a torch loop vectorised over programs and
walks) for CPU tensors; for CUDA tensors the kernel of csrc/walk5.cu (a
program a thread block cluster of 8 blocks, a walk a 128-thread block, the
walks' words crossing the cluster only at burst boundaries;
`walk5_geometry` is its launch), or an exception.  The two follow the same
order and float32 arithmetic operation for operation and agree bit for bit.

Deviations from the JAX kernel:
  * a stack push past `stack_depth`, a queue append past `qcap` and the
    max_steps backstop raise (the kernel counts them in the per-device
    error flag of ops/traverse.py); the JAX kernel drops the write or ends
    the walk silently;
  * `walks` is fixed at 8: another value raises ValueError;
  * a qcap below tree_width*unroll*npop raises ValueError: the burst vote
    would then pick pure drain with an empty queue forever (the JAX kernel
    never ends);
  * the majority sign is summed in one fixed order (pairwise halving, as
    ops/traverse3.py), where XLA sums in its own: a walk whose sum lies
    within rounding of 0 may visit its nodes in another order (same hits
    up to coplanar ties, other `visits`).
"""

from __future__ import annotations

import ctypes

import torch

from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.ops import _build
from fspt_tpu_torch.ops.traverse import (SENTINEL, PacketHit,
                                         check_kernel_inputs, check_tables,
                                         error_flag, ray_planes,
                                         real_triangles, safe_inv,
                                         valid_children)
from fspt_tpu_torch.ops.traverse3 import _halving_sum

WALKS = 8
LANES = 128
WIDTHS = (8, 16)
MAX_UNITS = 8          # npop + lpop the CUDA kernel takes
STACK_CAP = 1024       # stack_depth the CUDA kernel takes
QCAP_CAP = 1024        # qcap the CUDA kernel takes

NAME = "packet_traverse5"


def _check_args(nodes, leaves, leaf_size, stack_depth, unroll, qcap,
                drain_unroll, npop, lpop, walks, tree_width):
    check_tables(NAME, nodes, leaves, leaf_size, stack_depth)
    if walks != WALKS:
        raise ValueError(f"{NAME}: walks is fixed at {WALKS}, got {walks}")
    if tree_width not in WIDTHS:
        raise ValueError(f"{NAME}: tree_width must be 8 or 16, got "
                         f"{tree_width}")
    if npop < 1 or lpop < 0 or unroll < 1:
        raise ValueError(f"{NAME}: needs npop >= 1, lpop >= 0, unroll >= 1 "
                         f"(got {npop}, {lpop}, {unroll})")
    if qcap < tree_width * unroll * npop:
        raise ValueError(
            f"{NAME}: qcap={qcap} < tree_width*unroll*npop = "
            f"{tree_width * unroll * npop}: every burst would be a pure "
            "drain of an empty queue")
    return drain_unroll if drain_unroll > 0 else unroll


def _mt(row, j, ox, oy, oz, dx, dy, dz, bt):
    """Möller–Trumbore of lanes (B, W, L) against triangle j of rows
    (B, W, 128): (ok before the best-t test, t, u, v)."""
    c = [row[..., 9 * j + i, None] for i in range(9)]
    px = dy * c[8] - dz * c[7]
    py = dz * c[6] - dx * c[8]
    pz = dx * c[7] - dy * c[6]
    det = c[3] * px + c[4] * py + c[5] * pz
    inv = 1.0 / torch.where(torch.abs(det) < 1e-6, torch.ones_like(det), det)
    tx = ox - c[0]
    ty = oy - c[1]
    tz = oz - c[2]
    uu = (tx * px + ty * py + tz * pz) * inv
    qx = ty * c[5] - tz * c[4]
    qy = tz * c[3] - tx * c[5]
    qz = tx * c[4] - ty * c[3]
    ww = (dx * qx + dy * qy + dz * qz) * inv
    tt = (c[6] * qx + c[7] * qy + c[8] * qz) * inv
    ok = ((torch.abs(det) >= 1e-6) & (uu >= 0.0) & (uu <= 1.0) & (ww >= 0.0)
          & (uu + ww <= 1.0) & (tt > 1e-6) & (tt < bt))
    return ok, tt, uu, ww


class _Walks:
    """The walk state of a set of programs: (B, W) per walk, (B, W, L)
    per lane, (B, W, depth) stacks and (B, W, qcap) queues."""

    WALK = ("cur", "ptr", "qlen", "vis", "sx", "sy", "sz")
    LANE = ("ox", "oy", "oz", "dx", "dy", "dz", "ix", "iy", "iz",
            "bt", "bs", "bu", "bv")
    ROWS = ("stack", "queue")
    FIELDS = WALK + LANE + ROWS

    def take(self, idx):
        sub = _Walks()
        for f in self.FIELDS:
            setattr(sub, f, getattr(self, f)[idx])
        return sub

    def put(self, idx, sub):
        for f in self.FIELDS:
            getattr(self, f)[idx] = getattr(sub, f)


def packet_traverse5_reference(nodes, leaves, origin: V3, direction: V3,
                               tmax=None, *, leaf_size: int = 8,
                               any_hit: bool = False, stack_depth: int = 64,
                               unroll: int = 4, qcap: int = 128,
                               drain_unroll: int = 4, npop: int = 2,
                               lpop: int = 2, walks: int = WALKS,
                               tree_width: int = 8,
                               counts: dict | None = None) -> PacketHit:
    """Plain PyTorch version of the v5 kernel: every live program runs one
    burst per loop iteration, its walks in lockstep, in the kernel's
    order.  `counts`, when given, has the launch's node and leaf visits
    added to its "node" and "leaf" entries, and the valid children and
    real triangles those visits tested to "children" and "triangles"
    (tensors on the tables' device), each walk's visit counted once per
    lane of the walk."""
    drain_unroll = _check_args(nodes, leaves, leaf_size, stack_depth, unroll,
                               qcap, drain_unroll, npop, lpop, walks,
                               tree_width)
    tmax, _, dev = ray_planes(NAME, nodes, leaves, origin, direction, tmax)
    n = origin.x.shape[0]
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    if n == 0:
        e = lambda dt: torch.empty(0, dtype=dt, device=dev)
        return PacketHit(t=e(f32), slot=e(i32), u=e(f32), v=e(f32),
                         visits=e(i32))
    tw, D, Q = tree_width, stack_depth, qcap
    group = walks * LANES
    npg = -(-n // group)
    pad = npg * group - n
    n_nodes = nodes.shape[0]
    table = torch.cat([nodes, leaves])
    max_steps = 8 * (table.shape[0] + 64)

    def field(a, value):
        if pad:
            a = torch.cat([a, torch.full((pad,), value, dtype=f32,
                                         device=dev)])
        return a.reshape(npg, walks, LANES)

    st = _Walks()
    st.ox, st.oy, st.oz = (field(a, 1.0e9) for a in origin)
    st.dx, st.dy, st.dz = (field(a, v) for a, v in
                           zip(direction, (0.0, 1.0, 0.0)))
    st.ix, st.iy, st.iz = safe_inv(st.dx), safe_inv(st.dy), safe_inv(st.dz)
    st.sx, st.sy, st.sz = (
        (_halving_sum(a.reshape(npg * walks, LANES)) >= 0.0).reshape(
            npg, walks) for a in (st.dx, st.dy, st.dz))
    st.bt = field(tmax, 0.0).clone()
    st.bs = torch.full((npg, walks, LANES), -1, dtype=i32, device=dev)
    st.bu = torch.zeros((npg, walks, LANES), dtype=f32, device=dev)
    st.bv = torch.zeros((npg, walks, LANES), dtype=f32, device=dev)
    wz = lambda v: torch.full((npg, walks), v, dtype=i64, device=dev)
    st.cur, st.ptr, st.qlen, st.vis = wz(0), wz(1), wz(0), wz(0)
    st.stack = torch.zeros((npg, walks, D), dtype=i64, device=dev)
    st.stack[:, :, 0] = SENTINEL
    st.queue = torch.zeros((npg, walks, Q), dtype=i64, device=dev)
    cols = torch.arange(tw, device=dev)

    def gather(a, idx):
        return torch.gather(a, 2, idx[..., None])[..., 0]

    def tally(**units):
        if counts is not None:
            for key, x in units.items():
                counts[key] = counts.get(key, 0) + x.sum() * LANES

    def drain_select(s, k):
        has, ords = [], []
        for u in range(k):
            qtop = torch.clamp(s.qlen - 1 - u, 0, Q - 1)
            has.append(s.qlen > u)
            ords.append(torch.clamp(-gather(s.queue, qtop) - 1, min=0))
        return has, ords

    def drain_mt(s, has, ords):
        for h, o in zip(has, ords):
            row = table[torch.clamp(n_nodes + o, min=0) * h]
            tally(triangles=real_triangles(row, leaf_size) * h)
            slot_base = (o * leaf_size).to(i32)[..., None]
            mask = h[..., None]
            for j in range(leaf_size):
                ok, tt, uu, ww = _mt(row, j, s.ox, s.oy, s.oz, s.dx, s.dy,
                                     s.dz, s.bt)
                ok = ok & mask
                s.bt = torch.where(ok, tt, s.bt)
                s.bs = torch.where(ok, slot_base + j, s.bs)
                s.bu = torch.where(ok, uu, s.bu)
                s.bv = torch.where(ok, ww, s.bv)

    def unit_wants(s, unit, is_node):
        row = table[torch.clamp(unit, min=0) * is_node]       # (B, W, 128)
        tally(children=valid_children(row, tw) * is_node)
        lane = lambda k: row[:, :, None, k * tw:(k + 1) * tw]
        o = lambda a: a[..., None]
        t1x = (lane(0) - o(s.ox)) * o(s.ix)
        t2x = (lane(3) - o(s.ox)) * o(s.ix)
        t1y = (lane(1) - o(s.oy)) * o(s.iy)
        t2y = (lane(4) - o(s.oy)) * o(s.iy)
        t1z = (lane(2) - o(s.oz)) * o(s.iz)
        t2z = (lane(5) - o(s.oz)) * o(s.iz)
        tmin = torch.fmax(torch.fmax(torch.fmin(t1x, t2x),
                                     torch.fmin(t1y, t2y)),
                          torch.fmin(t1z, t2z))
        tmx = torch.fmin(torch.fmin(torch.fmax(t1x, t2x),
                                    torch.fmax(t1y, t2y)),
                         torch.fmax(t1z, t2z))
        box = (tmx >= tmin) & (tmx > 0.0) & (tmin < o(s.bt))
        links = row[:, :, 6 * tw:7 * tw]
        wants = box.any(2) & (links > -1.0e8) & is_node[..., None]
        axis = row[:, :, 7 * tw]
        fwd = torch.where(axis == 0.0, s.sx,
                          torch.where(axis == 1.0, s.sy, s.sz))
        order = torch.where(fwd[..., None], tw - 1 - cols, cols)
        return (torch.gather(wants, 2, order),
                torch.gather(links, 2, order).to(i32).to(i64))

    def end_done(s):
        if any_hit:
            done = ((s.bs >= 0) | (s.bt <= 0.0)).all(2)
            s.cur = torch.where(done, SENTINEL, s.cur)
            s.ptr = torch.where(done, 0, s.ptr)
            s.qlen = torch.where(done, 0, s.qlen)

    def mixed_substep(s):
        parked = s.cur == SENTINEL
        has, ords = drain_select(s, lpop)                 # entry state only
        taken = torch.clamp(s.qlen, max=lpop)
        units, p0 = [s.cur], s.ptr
        for _ in range(1, npop):
            popped = gather(s.stack, torch.clamp(p0 - 1, 0, D - 1))
            popped = torch.where((p0 >= 2) & ~parked, popped, SENTINEL)
            p0 = torch.where(popped != SENTINEL, p0 - 1, p0)
            units.append(popped)
        is_node = [u != SENTINEL for u in units]
        per_unit = [unit_wants(s, u, m) for u, m in zip(units, is_node)]

        p, q = p0, s.qlen - taken
        top = torch.full_like(p, SENTINEL)
        pushed = torch.zeros_like(parked)
        for u in range(npop - 1, -1, -1):
            want, link = per_unit[u]
            leaf = link < 0
            push, app = want & ~leaf, want & leaf
            pos = p[..., None] + torch.cumsum(push, 2) - 1
            qpos = q[..., None] + torch.cumsum(app, 2) - 1
            if bool((push & (pos >= D)).any()):
                raise RuntimeError(f"{NAME}: stack overflow (a push past "
                                   f"stack_depth={D})")
            if bool((app & (qpos >= Q)).any()):
                raise RuntimeError(f"{NAME}: leaf queue overflow (an "
                                   f"append past qcap={Q})")
            b, w, c = torch.nonzero(push, as_tuple=True)
            s.stack[b, w, pos[b, w, c]] = link[b, w, c]
            b, w, c = torch.nonzero(app, as_tuple=True)
            s.queue[b, w, qpos[b, w, c]] = link[b, w, c]
            k = push.sum(2)
            last = torch.argmax(push * (cols + 1), 2)
            top = torch.where(k > 0, gather(link, last), top)
            pushed = pushed | (k > 0)
            p = p + k
            q = q + app.sum(2)
        nptr = p - 1
        popped = gather(s.stack, torch.clamp(nptr, 0, D - 1))
        ncur = torch.where(pushed, top, popped)
        ncur = torch.where(parked, SENTINEL, ncur)
        s.ptr = torch.where(parked | (ncur == SENTINEL), 0, nptr)
        s.cur = ncur
        drain_mt(s, has, ords)
        s.qlen = q
        node_units = sum(m.to(torch.int64) for m in is_node)
        s.vis = s.vis + node_units + taken
        tally(node=node_units, leaf=taken)
        end_done(s)

    def drain_substep(s):
        k = npop + lpop
        has, ords = drain_select(s, k)
        drain_mt(s, has, ords)
        taken = torch.clamp(s.qlen, max=k)
        s.qlen = s.qlen - taken
        end_done(s)
        s.vis = s.vis + taken
        tally(leaf=taken)

    live = torch.arange(npg, device=dev)
    while live.numel():
        cur, qlen = st.cur[live], st.qlen[live]
        drain = ((qlen.max(1).values + tw * unroll * npop > Q)
                 | (((cur != SENTINEL).sum(1) == 0) & (qlen.sum(1) > 0)))
        for sel, body, reps in ((live[drain], drain_substep, drain_unroll),
                                (live[~drain], mixed_substep, unroll)):
            if sel.numel():
                sub = st.take(sel)
                for _ in range(reps):
                    body(sub)
                st.put(sel, sub)
        cur, qlen, vis = st.cur[live], st.qlen[live], st.vis[live]
        keep = (((cur != SENTINEL) | (qlen > 0)) & (vis < max_steps)).any(1)
        live = live[keep]
    if bool(((st.cur != SENTINEL) | (st.qlen > 0)).any()):
        raise RuntimeError(f"{NAME}: a walk ran past the step backstop "
                           f"({max_steps} visits)")

    flat = lambda a: a.reshape(-1)[:n]
    visits = st.vis.to(i32)[..., None].expand(npg, walks, LANES)
    return PacketHit(t=flat(st.bt), slot=flat(st.bs), u=flat(st.bu),
                     v=flat(st.bv), visits=flat(visits.contiguous()))


# ---- the CUDA kernel ------------------------------------------------------

_F, _I = ctypes.c_void_p, ctypes.c_int
WALK5_ARGTYPES = (
    [_F, _F, _I, _I]           # nodes, leaves, node rows, leaf rows
    + [_F] * 7                 # ox oy oz dx dy dz tmax
    + [_I] * 10                # n, leaf_size, stack_depth, qcap, unroll,
    #                            drain_unroll, npop, lpop, tree_width, any_hit
    + [_F] * 6                 # t, slot, u, v, visits, error flag
    + [_F])                    # stream


def load_walk5() -> ctypes.CDLL:
    """The v5 kernel library (csrc/walk5.cu), built on first call."""
    return _build.load("walk5", {"fspt_walk5": WALK5_ARGTYPES})


def walk5_geometry(n: int) -> dict:
    """The launch csrc/walk5.cu makes for n rays, a program a cluster of
    WALKS blocks of LANES threads: {"programs", "blocks" (the grid: whole
    clusters), "threads" (a block: one walk's rays), "pad_rays" (pad rays
    that fill the last program), "pad_blocks" (walks of the last program
    that hold pad rays only)}.  The kernel library answers the same
    question for its own launch (`walk5_kernel_geometry`); the card's tests
    hold the two together."""
    if n < 0:
        raise ValueError(f"walk5_geometry: n must be >= 0, got {n}")
    programs = -(-n // (WALKS * LANES))
    blocks = programs * WALKS
    return {"programs": programs, "blocks": blocks, "threads": LANES,
            "pad_rays": programs * WALKS * LANES - n,
            "pad_blocks": blocks - -(-n // LANES)}


def walk5_kernel_geometry(n: int) -> tuple[int, int]:
    """(blocks, threads a block) of the launch `fspt_walk5` makes for n
    rays, asked of the built library; it launches nothing."""
    out = ctypes.POINTER(ctypes.c_int)
    lib = _build.load("walk5",
                      {"fspt_walk5_geometry": [ctypes.c_int, out, out]})
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    lib.fspt_walk5_geometry(n, ctypes.byref(blocks), ctypes.byref(threads))
    return blocks.value, threads.value


def packet_traverse5(nodes, leaves, origin: V3, direction: V3, tmax=None, *,
                     leaf_size: int = 8, any_hit: bool = False,
                     stack_depth: int = 64, unroll: int = 4, qcap: int = 128,
                     drain_unroll: int = 4, npop: int = 2, lpop: int = 2,
                     walks: int = WALKS, tree_width: int = 8) -> PacketHit:
    """v5 mixed multi-pop traversal; see the module docstring.

    CPU tensors take the plain version.  CUDA tensors launch the kernel on
    the current stream (asynchronously) or raise; every launch adds one to
    `packet_traverse5.launches`."""
    kw = dict(leaf_size=leaf_size, any_hit=any_hit, stack_depth=stack_depth,
              unroll=unroll, qcap=qcap, drain_unroll=drain_unroll, npop=npop,
              lpop=lpop, walks=walks, tree_width=tree_width)
    tmax, planes, dev = ray_planes(NAME, nodes, leaves, origin, direction,
                                   tmax)
    if dev.type == "cpu":
        return packet_traverse5_reference(nodes, leaves, origin, direction,
                                          tmax, **kw)
    drain_unroll = _check_args(nodes, leaves, leaf_size, stack_depth, unroll,
                               qcap, drain_unroll, npop, lpop, walks,
                               tree_width)
    if npop + lpop > MAX_UNITS or stack_depth > STACK_CAP or qcap > QCAP_CAP:
        raise ValueError(f"{NAME}: the kernel takes npop + lpop <= "
                         f"{MAX_UNITS}, stack_depth <= {STACK_CAP} and qcap "
                         f"<= {QCAP_CAP}")
    n = origin.x.shape[0]
    check_kernel_inputs(NAME, nodes, leaves, planes, n)
    e = lambda dt: torch.empty(n, dtype=dt, device=dev)
    hit = PacketHit(t=e(torch.float32), slot=e(torch.int32),
                    u=e(torch.float32), v=e(torch.float32),
                    visits=e(torch.int32))
    if n == 0:
        return hit
    lib = load_walk5()
    flag = error_flag(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.fspt_walk5(
            nodes.data_ptr(), leaves.data_ptr(), nodes.shape[0],
            leaves.shape[0], *(x.data_ptr() for x in planes), n, leaf_size,
            stack_depth, qcap, unroll, drain_unroll, npop, lpop, tree_width,
            int(any_hit), *(x.data_ptr() for x in hit), flag.data_ptr(),
            ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.fspt_cuda_error_string(err).decode()
        raise RuntimeError(f"{NAME} kernel launch failed: {msg}")
    packet_traverse5.launches += 1
    return hit


packet_traverse5.launches = 0
