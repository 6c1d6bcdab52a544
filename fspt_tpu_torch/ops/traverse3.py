"""Group-walk BVH traversal, v3: the port of fspt_tpu.ops.traverse3.
packet_traverse3, and the group walk that v1 (ops/traverse.py) shares.

Contract (that of the JAX kernel): PacketHit(t, slot, u, v, visits) for N
rays over the packed tables of ops/packing.py, 8 or 16 wide.

How it walks.  Rays go in groups of 128 consecutive rays (the last group
padded with parked rays: origin 1e9, direction +y, tmax 0).  All rays of a
group walk ONE shared node sequence with one shared stack:
  * a node visit slab-tests the node's children for every ray of the
    group; a child is wanted by a ray iff (tmax >= tmin) & (tmax > 0) &
    (tmin < the ray's best t), and by the group iff some ray wants it and
    its link is valid (> -1e8);
  * wanted children are pushed near to far by the node's sort axis (lane
    7*width) and the group's majority direction sign on it (the sum of the
    group's direction components, >= 0, taken in one fixed order: pairwise
    halving, s[i] += s[i + h] for h = group/2 .. 1); the last push is the
    next node, and with no push the next node is a pop;
  * a leaf visit runs Möller–Trumbore over the leaf's `leaf_size`
    triangles for every ray, with the JAX kernel's epsilons and strict
    `t < best t`;
  * any-hit: the walk ends after a visit once every ray of the group has a
    hit or tmax <= 0 (v1 checks after leaf visits only);
  * `visits` is the group's count of node and leaf visits, the same for all
    its rays.  With `lane_counts`, each ray reports instead 1 (the root)
    plus, at every node the group visits, the number of children its own
    box test passes with a valid link: the BVH heatmap's per-pixel count.
    Neither is a per-ray quantity: a ray's count depends on the union of
    nodes its group visits, so the per-thread walk of ops/traverse4 cannot
    stand in for this op.

`packet_traverse3` dispatches on the tables' device: the plain version
(`packet_traverse3_reference`, a torch loop vectorised over groups) for
CPU tensors; for CUDA tensors the kernel `fspt_walk3` of csrc/walk.cu (one
warp per group), or an exception.  The two follow the same visit order and
float32 arithmetic operation for operation and agree bit for bit.

The kernel tests at each row only the rays that wanted it: every entry of
its stack carries the mask of the rays whose own box test passed for it
(the root's, every ray), and a ray outside a node's mask is not tested
there and counts 0 children.  That is exact wherever a child's box
contains every box of that child's own row: a ray that failed the parent's
slab test fails every descendant's, since rounded (plane - o) * inv is
monotone in the plane and the ray's best t only falls.  The packed tables
are built (ops/packing.py) and refit (scene/refit.py) as min/max unions,
so the nesting holds for them; tests/test_torch_walk.py checks it exactly
and holds a plain emulation of the masks to `group_walk_reference` bit for
bit.  At a leaf the kernel runs Moller-Trumbore for the rays of the leaf's
mask alone: it could differ from this version only for a hit that lies
outside its leaf's box by rounding (a ray whose slab test of the leaf
failed, with a triangle's t below its best t).  On the card that case
showed in 2 of 48.5 million lanes of the exact-replay cell's launches
(PERF.md): hits just outside a box, on a seam between two leaves, which a
ray's own walk (ops/traverse4.py) does not take either.
What the masks leave to test is counted on the card (`work_tally`:
(ray, row) pairs, group visits, and the child and triangle tests).

Deviations from the JAX kernel:
  * `table_hbm` is accepted and changes nothing: the tables are in device
    memory either way.  JAX's ValueError for `lane_counts` with
    `table_hbm` is kept.  The TPU tuning knobs (`unroll`, `stage`,
    `walks`) are not ported;
  * the stack is exact up to `stack_depth` live entries (the sentinel
    included) and a walk past it raises; the JAX kernel drops the push;
  * the step backstop (8 * (table rows + 64) visits) raises instead of
    ending the walk with wrong pixels;
  * XLA sums the majority sign in its own order: a group whose sum lies
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
                                         count_lanes, count_launch,
                                         error_flag, ray_planes, safe_inv,
                                         tally_visits)

GROUP = 128            # rays per v3 walk
STACK_CAP = 4096       # shared-memory stack entries the CUDA kernel takes
WIDTHS = (8, 16)


def step_bound(nodes, leaves) -> int:
    """The walk's step backstop: a correct walk visits each row at most
    once per stack entry, far below this."""
    return 8 * (nodes.shape[0] + leaves.shape[0] + 64)


def _halving_sum(x):
    """(G, S) -> (G,) sums in the kernel's order: s[i] += s[i + h] for
    h = S/2 .. 1."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0]


def group_walk_reference(nodes, leaves, origin: V3, direction: V3, tmax=None,
                         *, group: int, tree_width: int, leaf_size: int,
                         any_hit: bool, stack_depth: int,
                         lane_counts: bool = False, v1: bool = False,
                         counts: dict | None = None) -> PacketHit:
    """Plain PyTorch group walk, vectorised over groups: every live group
    makes one visit per loop iteration, in the kernel's order.  `counts`,
    when given, has the launch's node and leaf visits added to its "node"
    and "leaf" entries, and the valid children and real triangles those
    visits tested to "children" and "triangles", each group visit counted
    once per lane of the group (every lane does its arithmetic)."""
    name = "packet_traverse" if v1 else "packet_traverse3"
    check_tables(name, nodes, leaves, leaf_size, stack_depth)
    if tree_width not in WIDTHS:
        raise ValueError(f"{name}: tree_width must be 8 or 16, got "
                         f"{tree_width}")
    tmax, _, dev = ray_planes(name, nodes, leaves, origin, direction, tmax)
    n = origin.x.shape[0]
    f32, i32 = torch.float32, torch.int32
    if n == 0:
        e = lambda dt: torch.empty(0, dtype=dt, device=dev)
        return PacketHit(t=e(f32), slot=e(i32), u=e(f32), v=e(f32),
                         visits=e(i32))
    tw = tree_width
    ng = -(-n // group)
    pad = ng * group - n

    def field(a, value):
        if pad:
            a = torch.cat([a, torch.full((pad,), value, dtype=f32,
                                         device=dev)])
        return a.reshape(ng, group)

    ox, oy, oz = (field(a, 1.0e9) for a in origin)
    dx, dy, dz = (field(a, v) for a, v in zip(direction, (0.0, 1.0, 0.0)))
    bt = field(tmax, 0.0).clone()
    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)
    sx, sy, sz = (_halving_sum(a) >= 0.0 for a in (dx, dy, dz))
    bs = torch.full((ng, group), -1, dtype=i32, device=dev)
    bu = torch.zeros((ng, group), dtype=f32, device=dev)
    bv = torch.zeros((ng, group), dtype=f32, device=dev)
    lane_vis = (torch.ones((ng, group), dtype=i32, device=dev)
                if lane_counts else None)
    steps = torch.zeros(ng, dtype=i32, device=dev)
    cur = torch.zeros(ng, dtype=torch.int64, device=dev)       # root
    ptr = torch.ones(ng, dtype=torch.int64, device=dev)
    stack = torch.full((ng, stack_depth), SENTINEL, dtype=i32, device=dev)
    cols = torch.arange(tw, device=dev)
    bound = step_bound(nodes, leaves)

    live = torch.arange(ng, device=dev)
    it = 0
    while live.numel():
        it += 1
        if it > bound:
            raise RuntimeError(f"{name}: a walk ran past the step backstop "
                               f"({bound} visits)")
        steps[live] += 1
        c = cur[live]
        at_node = c >= 0

        # ---- node visits: slab-test the children for every lane, vote ----
        r = live[at_node]
        if r.numel():
            row = nodes[c[at_node]]
            if counts is not None:
                tally_visits(counts, "node", row, group, tw)
            lane = lambda k: row[:, None, k * tw:(k + 1) * tw]
            o = lambda a: a[r][:, :, None]
            oxr, oyr, ozr = o(ox), o(oy), o(oz)
            ixr, iyr, izr = o(ix), o(iy), o(iz)
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
            valid = links > -1.0e8
            box = ((tmx >= tmin) & (tmx > 0.0) & (tmin < o(bt))
                   & valid[:, None, :])                   # (Gn, group, tw)
            if lane_counts:
                lane_vis[r] += box.sum(-1, dtype=i32)
            want = box.any(1)
            axis = row[:, 7 * tw]
            fwd = torch.where(axis == 0.0, sx[r],
                              torch.where(axis == 1.0, sy[r], sz[r]))
            # push order: children tw-1..0 when fwd (child 0 is pushed last
            # and becomes the next node)
            order = torch.where(fwd[:, None], tw - 1 - cols, cols)
            want = torch.gather(want, 1, order)
            link = torch.gather(links, 1, order).to(i32)
            k = want.sum(1)
            p0 = ptr[r]
            pos = p0[:, None] + torch.cumsum(want, 1) - 1
            top_ptr = p0 + k - 1
            if int(top_ptr.max()) > stack_depth:
                raise RuntimeError(
                    f"{name}: stack overflow (needs {int(top_ptr.max())} > "
                    f"stack_depth={stack_depth})")
            rr, cc = torch.nonzero(want & (pos < stack_depth), as_tuple=True)
            stack[r[rr], pos[rr, cc]] = link[rr, cc]
            last = torch.argmax(want * (cols + 1), 1, keepdim=True)
            top = torch.gather(link, 1, last)[:, 0]
            pushed = k > 0
            popped = stack[r, p0 - 1]
            cur[r] = torch.where(pushed, top, popped).long()
            ptr[r] = torch.where(pushed, top_ptr, p0 - 1)

        # ---- leaf visits: Möller–Trumbore over the leaf's triangles ------
        r = live[~at_node]
        if r.numel():
            leaf = -c[~at_node] - 1
            row = leaves[leaf]
            if counts is not None:
                tally_visits(counts, "leaf", row, group, leaf_size)
            oxr, oyr, ozr = ox[r], oy[r], oz[r]
            dxr, dyr, dzr = dx[r], dy[r], dz[r]
            bt_r, bs_r, bu_r, bv_r = bt[r], bs[r], bu[r], bv[r]
            # every triangle of the leaf at once, (Gl, group, leaf_size);
            # the kernel's in-order `t < best t` keeps the first of the
            # nearest hits, which is argmin's pick
            e = row[:, :9 * leaf_size].reshape(-1, 1, leaf_size, 9)
            e = [e[..., i] for i in range(9)]
            dxr, dyr, dzr = (a[:, :, None] for a in (dxr, dyr, dzr))
            tx, ty, tz = (a[:, :, None] - b
                          for a, b in zip((oxr, oyr, ozr), e[:3]))
            px = dyr * e[8] - dzr * e[7]
            py = dzr * e[6] - dxr * e[8]
            pz = dxr * e[7] - dyr * e[6]
            det = e[3] * px + e[4] * py + e[5] * pz
            inv = 1.0 / torch.where(torch.abs(det) < 1e-6,
                                    torch.ones_like(det), det)
            uu = (tx * px + ty * py + tz * pz) * inv
            qx = ty * e[5] - tz * e[4]
            qy = tz * e[3] - tx * e[5]
            qz = tx * e[4] - ty * e[3]
            ww = (dxr * qx + dyr * qy + dzr * qz) * inv
            tt = (e[6] * qx + e[7] * qy + e[8] * qz) * inv
            ok = ((torch.abs(det) >= 1e-6)
                  & (uu >= 0.0) & (uu <= 1.0) & (ww >= 0.0)
                  & (uu + ww <= 1.0) & (tt > 1e-6) & (tt < bt_r[..., None]))
            j = torch.argmin(torch.where(ok, tt, torch.inf), -1,
                             keepdim=True)
            hit = ok.any(-1)
            pick = lambda a: torch.gather(a, -1, j)[..., 0]
            bt_r = torch.where(hit, pick(tt), bt_r)
            bs_r = torch.where(hit, (leaf * leaf_size).to(i32)[:, None]
                               + j[..., 0].to(i32), bs_r)
            bu_r = torch.where(hit, pick(uu), bu_r)
            bv_r = torch.where(hit, pick(ww), bv_r)
            bt[r], bs[r], bu[r], bv[r] = bt_r, bs_r, bu_r, bv_r
            p0 = ptr[r] - 1
            cur[r] = stack[r, p0].long()
            ptr[r] = p0
            if any_hit and v1:
                done = ((bs_r >= 0) | (bt_r <= 0.0)).all(1)
                cur[r] = torch.where(done, SENTINEL, cur[r])

        if any_hit and not v1:
            done = ((bs[live] >= 0) | (bt[live] <= 0.0)).all(1)
            cur[live] = torch.where(done, SENTINEL, cur[live])
        live = live[cur[live] != SENTINEL]

    visits = (lane_vis if lane_counts
              else steps[:, None].expand(ng, group).contiguous())
    flat = lambda a: a.reshape(-1)[:n]
    return PacketHit(t=flat(bt), slot=flat(bs), u=flat(bu), v=flat(bv),
                     visits=flat(visits))


def packet_traverse3_reference(nodes, leaves, origin: V3, direction: V3,
                               tmax=None, *, leaf_size: int = 8,
                               any_hit: bool = False, stack_depth: int = 64,
                               tree_width: int = 8, table_hbm: bool = False,
                               lane_counts: bool = False,
                               counts: dict | None = None) -> PacketHit:
    """Plain PyTorch version of the v3 kernel (128-ray groups)."""
    _check_v3(table_hbm, lane_counts)
    return group_walk_reference(
        nodes, leaves, origin, direction, tmax, group=GROUP,
        tree_width=tree_width, leaf_size=leaf_size, any_hit=any_hit,
        stack_depth=stack_depth, lane_counts=lane_counts, counts=counts)


def _check_v3(table_hbm, lane_counts):
    if lane_counts and table_hbm:
        raise ValueError("lane_counts is a VMEM-table diagnostic")


# ---- the CUDA kernel ------------------------------------------------------

_F, _I = ctypes.c_void_p, ctypes.c_int
WALK_ARGTYPES = (
    [_F, _F, _I, _I]           # nodes, leaves, node rows, leaf rows
    + [_F] * 7                 # ox oy oz dx dy dz tmax
    + [_I] * 6                 # n, leaf_size, stack_depth, tree_width,
    #                            any_hit, lane_counts
    + [_F] * 6                 # t, slot, u, v, visits, error flag
    + [_F])                    # stream
# fspt_walk3 takes the work tally after the error flag
WALK3_ARGTYPES = WALK_ARGTYPES[:-1] + [_F, _F]
TALLY = ("pairs", "visits", "children", "triangles")

_tallies = {}


def work_tally(device) -> torch.Tensor:
    """The per-device int64 counts that csrc/walk.cu adds to, one atomic
    add a block: [0] the (ray, row) pairs its visits tested (a visit tests
    the rays of its row's mask), [1] its group visits, [2] the (ray, valid
    child) box tests and [3] the (ray, real triangle) tests among those
    pairs (TALLY names them).  No launch resets it: read it before and
    after the launches to count, after a synchronise and off the hot path
    (a read is a device read).  The plain version counts nothing here."""
    key = torch.device(device).index
    if key is None:
        key = torch.cuda.current_device()
    tally = _tallies.get(key)
    if tally is None:
        tally = torch.zeros(len(TALLY), dtype=torch.int64,
                            device=f"cuda:{key}")
        _tallies[key] = tally
    return tally


def tally_growth(run, device="cuda") -> dict:
    """The growth of `device`'s `work_tally` over the walk3 launches that
    run() makes, by TALLY name (synchronises before and after)."""
    torch.cuda.synchronize(device)
    before = work_tally(device).clone()
    run()
    torch.cuda.synchronize(device)
    return dict(zip(TALLY, (work_tally(device) - before).tolist()))


def load_walk() -> ctypes.CDLL:
    """The group-walk kernel library (csrc/walk.cu), built on first call."""
    return _build.load("walk", {"fspt_walk3": WALK3_ARGTYPES})


def launch_walk(name, fn_name, counter, nodes, leaves, planes, *, leaf_size,
                any_hit, stack_depth, tree_width, lane_counts,
                load=load_walk, extra=()) -> PacketHit:
    """Launch `fn_name` of the library `load()` returns (csrc/walk.cu's
    unless told otherwise) on the current stream and add one to
    `counter.launches`; raise on a refused launch.  `extra`: the pointers
    the kernel takes after the error flag (fspt_walk3: its work tally)."""
    n = planes[0].shape[0]
    check_tables(name, nodes, leaves, leaf_size, stack_depth)
    check_kernel_inputs(name, nodes, leaves, planes, n)
    if stack_depth > STACK_CAP:
        raise ValueError(f"{name}: stack_depth {stack_depth} exceeds the "
                         f"kernel's capacity {STACK_CAP}")
    dev = nodes.device
    e = lambda dt: torch.empty(n, dtype=dt, device=dev)
    hit = PacketHit(t=e(torch.float32), slot=e(torch.int32),
                    u=e(torch.float32), v=e(torch.float32),
                    visits=e(torch.int32))
    if n == 0:
        return hit
    lib = load()
    flag = error_flag(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(lib, fn_name)(
            nodes.data_ptr(), leaves.data_ptr(), nodes.shape[0],
            leaves.shape[0], *(x.data_ptr() for x in planes), n, leaf_size,
            stack_depth, tree_width, int(any_hit), int(lane_counts),
            *(x.data_ptr() for x in hit), flag.data_ptr(),
            *extra,
            ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.fspt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")
    count_launch(counter, dev)
    return hit


def packet_traverse3(nodes, leaves, origin: V3, direction: V3, tmax=None, *,
                     leaf_size: int = 8, any_hit: bool = False,
                     stack_depth: int = 64, tree_width: int = 8,
                     table_hbm: bool = False,
                     lane_counts: bool = False) -> PacketHit:
    """v3 group-walk traversal; see the module docstring.

    CPU tensors take the plain version.  CUDA tensors launch the kernel on
    the current stream (asynchronously) or raise; every launch adds one to
    `packet_traverse3.launches` and its work to the device's `work_tally`,
    and every call its rays to
    `packet_traverse3.lanes` (ops/traverse.py `count_lanes`)."""
    _check_v3(table_hbm, lane_counts)
    tmax, planes, dev = ray_planes("packet_traverse3", nodes, leaves, origin,
                                   direction, tmax)
    count_lanes(packet_traverse3, dev, planes[0].shape[0])
    if dev.type == "cpu":
        return packet_traverse3_reference(
            nodes, leaves, origin, direction, tmax, leaf_size=leaf_size,
            any_hit=any_hit, stack_depth=stack_depth, tree_width=tree_width,
            lane_counts=lane_counts)
    if tree_width not in WIDTHS:
        raise ValueError(f"packet_traverse3: tree_width must be 8 or 16, "
                         f"got {tree_width}")
    return launch_walk("packet_traverse3", "fspt_walk3", packet_traverse3,
                       nodes, leaves, planes, leaf_size=leaf_size,
                       any_hit=any_hit, stack_depth=stack_depth,
                       tree_width=tree_width, lane_counts=lane_counts,
                       extra=(work_tally(dev).data_ptr(),))


packet_traverse3.launches = 0
packet_traverse3.captured = 0
packet_traverse3.lanes = 0
packet_traverse3.lanes_captured = 0
