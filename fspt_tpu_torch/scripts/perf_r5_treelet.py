"""Two-level (TLAS + dense treelet) traversal study against the production
walk, on the real captured bounce-0 ray set (port of
scripts/perf_r5_treelet.py).

A shallow TLAS walk over ~T-triangle treelets assigns rays to treelets;
each (ray, treelet) pair is then tested densely.  The script measures each
component on real data and composes the total:

  A. baseline: the production traversal ("split": packet_traverse4) on the
     captured launch;
  B. TLAS walk: the group walk (packet_traverse3) over a leaf_size=T SAH
     tree packed with one dummy triangle per leaf (node descent and want
     enumeration, no leaf work) — time and visits per walk;
  C. pair statistics: an exact NumPy frontier traversal (no best-hit
     feedback: exactly what a two-phase scheme knows) counts lane-level
     and walk-level (ray, treelet) pairs;
  D. queue build: a sort of the pair keys and the (P, 7) ray row gather at
     the measured pair count (plain torch, as the JAX script left it to
     XLA);
  E. dense MT: the kernel of csrc/dense_mt.cu over 1024-pair tiles at the
     measured tile count, with the script's stand-in inputs (random
     treelets, constant 0.5 rays).

`dense_mt` dispatches on the tensors' device: the plain version
(`dense_mt_reference`, vectorised over tiles) for CPU tensors; for CUDA
tensors the kernel (a tile over 8 blocks of 128 threads, the treelet's rows
staged in shared memory, per row only the slots up to its last triangle
with an edge: `tested_slots`), or an exception.  The two agree bit for bit.

Run on the card: python -m fspt_tpu_torch.scripts.perf_r5_treelet
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fspt_tpu_torch.ops import _build
from fspt_tpu_torch.scripts.r5common import capture_bounce0, drain, timed

TILE = 1024
TREELETS = (64, 128)
SCHEDULE = (1.45, 9.5, 40, 128, 512, 2048, 2048, 2048)


def frontier_pairs(bvh, o, d, tmax, active, treelet_leaf):
    """Exact (ray, treelet-leaf) pair enumeration by BFS frontier — NO
    best-hit feedback, i.e. exactly the wants a two-phase scheme has."""
    left, right, tri = bvh.left, bvh.right, bvh.tri_offset
    nmin, nmax = bvh.node_min, bvh.node_max
    inv = 1.0 / np.where(np.abs(d) < 1e-20, np.where(d < 0, -1e-20, 1e-20), d)
    ridx = np.nonzero(active)[0].astype(np.int32)
    nodes = np.zeros(len(ridx), np.int32)
    pairs_r, pairs_l = [], []
    total_visits = 0
    while len(ridx):
        total_visits += len(ridx)
        bmin = nmin[nodes]
        bmax = nmax[nodes]
        t1 = (bmin - o[ridx]) * inv[ridx]
        t2 = (bmax - o[ridx]) * inv[ridx]
        tlo = np.minimum(t1, t2).max(axis=1)
        thi = np.maximum(t1, t2).min(axis=1)
        hit = (thi >= tlo) & (thi > 0.0) & (tlo < tmax[ridx])
        ridx, nodes = ridx[hit], nodes[hit]
        leaf = tri[nodes] >= 0
        pairs_r.append(ridx[leaf])
        pairs_l.append(tri[nodes[leaf]] // treelet_leaf)
        ridx2 = ridx[~leaf]
        nodes2 = nodes[~leaf]
        ridx = np.concatenate([ridx2, ridx2])
        nodes = np.concatenate([left[nodes2], right[nodes2]])
    return (np.concatenate(pairs_r), np.concatenate(pairs_l), total_visits)


def _check(tile_tl, tris, rays, T, in_range=True):
    """Shapes and devices; with `in_range`, also that every treelet's rows
    lie in the table (a read-back of tile_tl: one synchronise)."""
    if T not in TREELETS:
        raise ValueError(f"dense_mt: T must be 64 or 128, got {T}")
    n_tiles = tile_tl.shape[0]
    if tuple(tile_tl.shape) != (n_tiles, 1):
        raise ValueError(f"dense_mt: tile_tl must be (n_tiles, 1), got "
                         f"{tuple(tile_tl.shape)}")
    if tris.dim() != 2 or tris.shape[1] != 128:
        raise ValueError(f"dense_mt: tris must be (rows, 128), got "
                         f"{tuple(tris.shape)}")
    if tuple(rays.shape) != (n_tiles, 7, 8, 128):
        raise ValueError(f"dense_mt: rays must be ({n_tiles}, 7, 8, 128), "
                         f"got {tuple(rays.shape)}")
    if len({x.device for x in (tile_tl, tris, rays)}) != 1:
        raise ValueError("dense_mt: inputs span devices")
    if in_range and n_tiles:
        lo, hi = torch.stack(torch.aminmax(tile_tl)).tolist()
        if lo < 0 or (hi + 1) * (T // 8) > tris.shape[0]:
            raise ValueError(f"dense_mt: a treelet id lies outside the "
                             f"table's {tris.shape[0] // (T // 8)} treelets "
                             f"of {T}")


def dense_mt_reference(tile_tl, tris, rays, T: int):
    """Plain PyTorch version of the kernel: (t f32, slot i32), each
    (n_tiles, 8, 128)."""
    _check(tile_tl, tris, rays, T)
    rows_per = T // 8
    idx = (tile_tl.long() * rows_per
           + torch.arange(rows_per, device=tris.device))       # (n, T/8)
    panel = tris[idx]                                          # (n, T/8, 128)
    ox, oy, oz, dx, dy, dz, bt = (rays[:, c] for c in range(7))
    bs = torch.full(bt.shape, -1, dtype=torch.int32, device=tris.device)
    for r in range(rows_per):
        for j in range(8):
            c = [panel[:, r, 9 * j + i, None, None] for i in range(9)]
            px = dy * c[8] - dz * c[7]
            py = dz * c[6] - dx * c[8]
            pz = dx * c[7] - dy * c[6]
            det = c[3] * px + c[4] * py + c[5] * pz
            inv = 1.0 / torch.where(torch.abs(det) < 1e-6,
                                    torch.ones_like(det), det)
            tx = ox - c[0]
            ty = oy - c[1]
            tz = oz - c[2]
            uu = (tx * px + ty * py + tz * pz) * inv
            qx = ty * c[5] - tz * c[4]
            qy = tz * c[3] - tx * c[5]
            qz = tx * c[4] - ty * c[3]
            ww = (dx * qx + dy * qy + dz * qz) * inv
            tt = (c[6] * qx + c[7] * qy + c[8] * qz) * inv
            ok = ((torch.abs(det) >= 1e-6) & (uu >= 0.0) & (uu <= 1.0)
                  & (ww >= 0.0) & (uu + ww <= 1.0) & (tt > 1e-6) & (tt < bt))
            bt = torch.where(ok, tt, bt)
            bs = torch.where(ok, r * 8 + j, bs)
    return bt, bs


def tested_slots(rows):
    """Per leaf row (..., 128) of 8 triangles: the slots that the kernel
    tests (csrc/walk_common.cuh `leaf_tests`), those up to the row's last
    triangle with an edge, in whole pairs.  A slot past it is all zeros and
    can never be hit; one inside it is tested whatever it holds."""
    edge = (rows[..., :72].reshape(*rows.shape[:-1], 8, 9)[..., 3:]
            != 0.0).any(-1)
    upto = torch.where(edge, torch.arange(1, 9, device=rows.device),
                       0).amax(-1)
    return (upto + 1) // 2 * 2


# ---- the CUDA kernel ------------------------------------------------------

_F, _I = ctypes.c_void_p, ctypes.c_int
DENSE_MT_ARGTYPES = [_F, _F, _I, _F, _F, _F, _I, _I, _F]  # tile_tl, tris,
#                                   rows, rays, t, slot, n_tiles, T, stream


def load_dense_mt() -> ctypes.CDLL:
    """The dense MT kernel library (csrc/dense_mt.cu), built on first
    call."""
    return _build.load("dense_mt", {"fspt_dense_mt": DENSE_MT_ARGTYPES})


def dense_mt(tile_tl, tris, rays, T: int):
    """Each 1024-pair tile against its treelet's T triangles; see the module
    docstring.  CPU tensors take the plain version; CUDA tensors launch the
    kernel on the current stream (`launch_dense_mt`) or raise.  The treelet
    range check reads tile_tl back: one synchronise per call."""
    _check(tile_tl, tris, rays, T)
    dev = tris.device
    if dev.type == "cpu":
        return dense_mt_reference(tile_tl, tris, rays, T)
    if dev.type != "cuda":
        raise ValueError(f"dense_mt runs on cpu or cuda, not {dev}")
    return launch_dense_mt(tile_tl, tris, rays, T)


def launch_dense_mt(tile_tl, tris, rays, T: int):
    """The kernel launch of `dense_mt` without its treelet range check (and
    so without a synchronise), for callers that made tile_tl in range and
    time the kernel alone; a tile whose treelet lies outside the table gets
    NaN t (the kernel reads nothing there).  Every launch adds one to
    `dense_mt.launches`."""
    _check(tile_tl, tris, rays, T, in_range=False)
    dev = tris.device
    if dev.type != "cuda":
        raise ValueError(f"launch_dense_mt takes CUDA tensors, not {dev}")
    if tile_tl.dtype != torch.int32 or not tile_tl.is_contiguous():
        raise ValueError("dense_mt: tile_tl must be contiguous int32")
    for x in (tris, rays):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("dense_mt takes contiguous float32 tris/rays")
    n_tiles = tile_tl.shape[0]
    t = torch.empty((n_tiles, 8, 128), dtype=torch.float32, device=dev)
    slot = torch.empty((n_tiles, 8, 128), dtype=torch.int32, device=dev)
    if n_tiles == 0:
        return t, slot
    lib = load_dense_mt()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.fspt_dense_mt(tile_tl.data_ptr(), tris.data_ptr(),
                                tris.shape[0], rays.data_ptr(), t.data_ptr(),
                                slot.data_ptr(), n_tiles, T,
                                ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.fspt_cuda_error_string(err).decode()
        raise RuntimeError(f"dense_mt kernel launch failed: {msg}")
    dense_mt.launches += 1
    return t, slot


dense_mt.launches = 0


def stand_in_tiles(n_tiles, n_treelets, device):
    """Stage E's inputs, as the JAX script makes them: treelet ids from
    numpy's default_rng(2), every ray plane 0.5."""
    tile_tl = torch.from_numpy(np.random.default_rng(2).integers(
        0, n_treelets, (n_tiles, 1), dtype=np.int32)).to(device)
    rays = torch.full((n_tiles, 7, 8, 128), 0.5, dtype=torch.float32,
                      device=device)
    return tile_tl, rays


def main(scene=None):
    """Stages A-E for T in (64, 128) on the card; returns {"base": s,
    T: {"tlas", "queue", "dense", "composed" (s), "n_tiles", "pairs",
    "walk_pairs", "visits_per_walk", "go"}}."""
    if not torch.cuda.is_available():
        raise SystemExit("perf_r5_treelet: needs a CUDA device")
    from fspt_tpu_torch.config import RenderConfig
    from fspt_tpu_torch.core.integrator import intersect
    from fspt_tpu_torch.core.vec import V3
    from fspt_tpu_torch.ops import packing
    from fspt_tpu_torch.ops.traverse import check_stack_overflow
    from fspt_tpu_torch.ops.traverse3 import packet_traverse3
    from fspt_tpu_torch.scene.bvh import triangle_aabbs
    from fspt_tpu_torch.scene.fastbvh import build_bvh_fast
    from fspt_tpu_torch.testing import make_bunny_standin_scene
    dev = torch.device("cuda")
    scene = scene or make_bunny_standin_scene(subdivisions=6)
    arrays, meta = scene.to_torch(dev), scene.meta
    cfg = RenderConfig(width=512, height=512, bounces=8,
                       extra_refraction_iters=0, compact=True,
                       intersector="split", compact_schedule=SCHEDULE)
    print("capturing bounce-0 launch ...", flush=True)
    so, sd, stm, sa = capture_bounce0(scene, arrays, meta, cfg)
    nl = so.x.shape[0]
    n_active = int(sa.sum())
    print(f"launch lanes={nl} active={n_active}", flush=True)

    # ---- A: baseline production traversal -------------------------------
    t_base = timed(lambda: intersect(arrays, cfg, meta, so, sd, tmax=stm),
                   reps=5)
    check_stack_overflow(dev)
    print(f"A baseline split traversal     {t_base * 1e3:8.2f} ms",
          flush=True)

    o_np = torch.stack(list(so), -1).cpu().numpy()
    d_np = torch.stack(list(sd), -1).cpu().numpy()
    tm_np, a_np = stm.cpu().numpy(), sa.cpu().numpy()
    host = scene.arrays
    tmin, tmax_t = triangle_aabbs(np.stack(
        [host.tri_v0, host.tri_v0 + host.tri_e1, host.tri_v0 + host.tri_e2],
        axis=1))
    out = {"base": t_base}
    for T in TREELETS:
        # ---- B: TLAS walk probe (leaf_size=T SAH tree, dummy leaves) ----
        bvh = build_bvh_fast(np.asarray(tmin), np.asarray(tmax_t),
                             leaf_size=T)
        n_tl = int((bvh.tri_offset >= 0).sum())
        dummy = np.zeros((n_tl, 3), np.float32)
        pk = packing.pack_bvh(bvh.left, bvh.right,
                              np.where(bvh.tri_offset >= 0,
                                       bvh.tri_offset // T, -1),
                              bvh.node_min, bvh.node_max,
                              dummy, dummy, dummy, leaf_size=1, width=8)
        nodes_t = torch.from_numpy(pk.nodes).to(dev)
        leaves_t = torch.from_numpy(pk.leaves).to(dev)

        def tlas():
            return packet_traverse3(nodes_t, leaves_t, so, sd, stm,
                                    leaf_size=1,
                                    stack_depth=8 * (pk.depth + 2))
        t_tlas = timed(tlas, reps=5)
        probe = drain(tlas())
        check_stack_overflow(dev)
        vis = probe.visits.reshape(-1, 128)[:, 0].float().mean().item()

        # ---- C: exact pair statistics -------------------------------------
        pr, pl_, fv = frontier_pairs(bvh, o_np, d_np, tm_np, a_np, T)
        n_pairs = len(pr)
        groups = pr // 128                      # launch-order 128-lane walks
        walk_pairs = len(set(zip(groups.tolist(), pl_.tolist())))

        # ---- D: queue build (sort + ray row gather) at the real count ----
        P = int(np.ceil(n_pairs / TILE) * TILE)
        keys = torch.from_numpy(np.random.default_rng(0).integers(
            0, n_tl, P, dtype=np.int32)).to(dev)
        lanes = torch.from_numpy(np.random.default_rng(1).integers(
            0, nl, P, dtype=np.int32)).to(dev)
        rays7 = torch.stack([*so, *sd, stm], -1)

        def build_queue():
            order = torch.sort(keys).indices
            return rays7[lanes[order].long()]
        t_queue = timed(build_queue, reps=5)

        # ---- E: dense MT at the real tile count ---------------------------
        n_tiles = P // TILE
        # treelet tl's T triangles = production leaf rows
        # [tl*T/8, (tl+1)*T/8) (timing stand-in: treelet count capped to
        # the rows available)
        tri_rows = arrays.pk_leaves
        n_tl_eff = min(n_tl, tri_rows.shape[0] // (T // 8))
        tile_tl, tile_rays = stand_in_tiles(n_tiles, n_tl_eff, dev)
        drain(dense_mt(tile_tl, tri_rows, tile_rays, T))   # ids checked
        t_dense = timed(
            lambda: launch_dense_mt(tile_tl, tri_rows, tile_rays, T), reps=5)

        composed = t_tlas + t_queue + t_dense
        go = composed < t_base * 0.8
        print(f"\n--- treelet T={T}: {n_tl} treelets, TLAS depth {pk.depth}")
        print(f"B TLAS walk                    {t_tlas * 1e3:8.2f} ms  "
              f"(visits/walk={vis:.1f})")
        print(f"C pairs: lane-level={n_pairs} "
              f"({n_pairs / max(n_active, 1):.1f}/ray) "
              f"walk-level={walk_pairs} frontier_visits={fv}")
        print(f"D queue build (sort+gather)    {t_queue * 1e3:8.2f} ms  "
              f"(P={P})")
        print(f"E dense MT ({n_tiles} tiles x {T} tris) "
              f"{t_dense * 1e3:8.2f} ms")
        print(f"=> composed two-level          {composed * 1e3:8.2f} ms "
              f"vs baseline {t_base * 1e3:.2f} ms  "
              f"{'GO' if go else 'NO-GO'}", flush=True)
        out[T] = {"tlas": t_tlas, "queue": t_queue, "dense": t_dense,
                  "composed": composed, "n_tiles": n_tiles,
                  "pairs": n_pairs, "walk_pairs": walk_pairs,
                  "visits_per_walk": vis, "go": go}
    return out


if __name__ == "__main__":
    main()
