"""Round-5: per-substep cost decomposition via a fixed-iteration kernel
(port of scripts/perf_r5d.py).

The micro replays the substep structure of the lockstep walks (8 walks of
128 lanes, one row fetch each, 8-child slab votes, 8-triangle MT, a stack)
for a fixed k substeps, with no termination condition, so that the
variants stay directly comparable:

  full      fetch + slab + stack + MT        (v3 substep)
  node      fetch + slab + stack, no MT      (v4 node substep)
  leaf      fetch + MT only                  (v4 drain substep)
  leaf2/4   2 or 4 independent fetch+MT units per substep
  fetch     8 dynamic row fetches + consume, no tests
  fetch1    ONE dynamic row fetch + consume
  vector    slab + stack + MT on a static panel, no fetch

ns/substep = t / k, and what it means depends on the variant's family,
because csrc/micro.cu lays the three families on the card differently:
  * full, node, vector are chains (a substep's vote names the next row):
    each of the 8 walks is a thread block cluster of 8 blocks on as many
    SMs, eight threads a lane, the vote crossing the cluster through
    distributed shared memory, the next substep's nine candidate rows
    fetched under the tests.  ns/substep is the latency of ONE walk's
    substep with its SMs to itself;
  * leaf, leaf2, leaf4 have no chain (the row sequence is (1 + i) % rows
    and `bt` a minimum), so their substeps are cut into slices over the
    whole card.  ns/substep is the substeps' work over the launch's time: a
    throughput of the card, not a latency;
  * fetch, fetch1 sum in substep order: one chain a walk, a block a walk,
    the known rows kept in flight ahead.  ns/substep is a consume step with
    the fetch hidden.

`micro` dispatches on the tensors' device: the plain version
(`micro_reference`, a torch loop over k) for CPU tensors; for CUDA tensors
the kernels of csrc/micro.cu, or an exception.  Both compute
`out = bt + acc + cur + ptr` exactly as the JAX kernel does, bit for bit
with each other:
  * row indices `cur * -1640531527 + i` wrap in int32 and are reduced by a
    floor modulo (jnp's `%`);
  * `ix = 1 / dx` without safe_inv; float links are cast to int32;
  * the stack overflows by design within a few substeps: a write at
    p >= DEPTH is dropped and the pointer clipped to DEPTH - 1, silently,
    as in the JAX kernel (this is the one kernel of the port that does not
    raise on overflow: its output is defined with the drop);
  * scratch the JAX kernel leaves uninitialised (only stack column 0 and
    panel rows 0-7 are written before use) starts at zero.

Run on the card: python -m fspt_tpu_torch.scripts.perf_r5d
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from fspt_tpu_torch.ops import _build
from fspt_tpu_torch.ops.traverse import real_triangles

WALKS, LANES = 8, 128
K = 4096          # substeps per program
DEPTH = 64
TW = 8
VARIANTS = ("full", "node", "leaf", "leaf2", "leaf4", "fetch", "fetch1",
            "vector")
MAIN_VARIANTS = ("full", "leaf", "leaf2", "leaf4")
_FETCH = ("full", "node", "leaf", "fetch", "fetch1")
_NODE = ("full", "node", "vector")
_MT = ("full", "leaf", "vector")


def _check(table, rays, variant, k):
    if variant not in VARIANTS:
        raise ValueError(f"micro: unknown variant {variant!r}; one of "
                         f"{VARIANTS}")
    if table.dim() != 2 or table.shape[1] != 128 or table.shape[0] < WALKS:
        raise ValueError(f"micro: table must be (rows >= 8, 128), got "
                         f"{tuple(table.shape)}")
    if tuple(rays.shape) != (1, 6, WALKS, LANES):
        raise ValueError(f"micro: rays must be (1, 6, 8, 128), got "
                         f"{tuple(rays.shape)}")
    if table.device != rays.device:
        raise ValueError("micro: table and rays lie on different devices")
    if k < 0:
        raise ValueError(f"micro: k must be >= 0, got {k}")


def _row_hash(cur, i, rows):
    """(cur * -1640531527 + i) in wrapping int32, floor-mod rows."""
    x = (cur * -1640531527 + i) & 0xFFFFFFFF
    x = torch.where(x >= 1 << 31, x - (1 << 32), x)
    return torch.remainder(x, rows)


def micro_reference(table, rays, variant: str, k: int = K,
                    counts: dict | None = None):
    """Plain PyTorch version of the micro kernel: (1, 8, 128) float32.
    `counts`, when given, has the real triangles (ops/traverse.py
    `real_triangles`) of the rows the substeps ran Möller–Trumbore over
    added to its "triangles" entry (a tensor), once per lane.  (The box
    tests take all 8 children of every row: the micro has no link test.)"""
    _check(table, rays, variant, k)
    dev = table.device
    rows = table.shape[0]
    ox, oy, oz, dx, dy, dz = (rays[0, c] for c in range(6))
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    walk = torch.arange(WALKS, device=dev)
    cur = torch.ones(WALKS, dtype=torch.int64, device=dev)
    ptr = torch.ones(WALKS, dtype=torch.int64, device=dev)
    bt = torch.full((WALKS, LANES), 1e9, dtype=torch.float32, device=dev)
    acc = torch.zeros(WALKS, dtype=torch.float32, device=dev)
    panel = torch.zeros((4 * WALKS, LANES), dtype=torch.float32, device=dev)
    panel[0:WALKS] = table[0:WALKS]
    stack = torch.zeros((WALKS, DEPTH), dtype=torch.int64, device=dev)

    def mt(rd, bt):
        if counts is not None:
            counts["triangles"] = (counts.get("triangles", 0)
                                   + real_triangles(rd, 8).sum() * LANES)
        for j in range(8):
            c = [rd[:, 9 * j + q, None] for q in range(9)]
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
                  & (ww >= 0.0) & (uu + ww <= 1.0) & (tt > 1e-6)
                  & (tt < bt))
            bt = torch.where(ok, tt, bt)
        return bt

    for i in range(k):
        if variant in _FETCH:
            base = _row_hash(cur, i, rows)
            if variant == "fetch1":
                panel[0] = table[base[0]]
            else:
                panel[0:WALKS] = table[base]
        rd = panel[0:WALKS]
        if variant in ("fetch", "fetch1"):
            acc = acc + rd[:, 0]
            cur = torch.remainder(cur + 1, rows)
            continue
        if variant in _NODE:
            p, top = ptr, cur
            pushed = torch.zeros(WALKS, dtype=torch.bool, device=dev)
            for c in range(TW):
                t1x = (rd[:, c, None] - ox) * ix
                t2x = (rd[:, 3 * TW + c, None] - ox) * ix
                t1y = (rd[:, TW + c, None] - oy) * iy
                t2y = (rd[:, 4 * TW + c, None] - oy) * iy
                t1z = (rd[:, 2 * TW + c, None] - oz) * iz
                t2z = (rd[:, 5 * TW + c, None] - oz) * iz
                tmin = torch.fmax(torch.fmax(torch.fmin(t1x, t2x),
                                             torch.fmin(t1y, t2y)),
                                  torch.fmin(t1z, t2z))
                tmx = torch.fmin(torch.fmin(torch.fmax(t1x, t2x),
                                            torch.fmax(t1y, t2y)),
                                 torch.fmax(t1z, t2z))
                want = ((tmx >= tmin) & (tmx > 0.0) & (tmin < bt)).any(1)
                link = rd[:, 6 * TW + c].to(torch.int32).to(torch.int64)
                w = walk[want & (p < DEPTH)]         # the drop past DEPTH
                stack[w, p[w]] = link[w]
                top = torch.where(want, link, top)
                pushed = pushed | want
                p = p + want
            nptr = torch.clamp(p - 1, 0, DEPTH - 1)
            popped = stack[walk, nptr]
            cur = torch.remainder(torch.abs(torch.where(pushed, top, popped)),
                                  rows)
            ptr = nptr
        if variant in ("leaf2", "leaf4"):
            kk = 2 if variant == "leaf2" else 4
            base = _row_hash(cur, i, rows)
            for u in range(kk):
                panel[u * WALKS:(u + 1) * WALKS] = table[
                    torch.remainder(base + u, rows)]
            for u in range(kk):
                bt = mt(panel[u * WALKS:(u + 1) * WALKS], bt)
            cur = torch.remainder(cur + 1, rows)
            continue
        if variant in _MT:
            bt = mt(rd, bt)
            if variant == "leaf":
                cur = torch.remainder(cur + 1, rows)
    out = (bt + acc[:, None] + cur.to(torch.float32)[:, None]
           + ptr.to(torch.float32)[:, None])
    return out[None]


# ---- the CUDA kernel ------------------------------------------------------

_F, _I = ctypes.c_void_p, ctypes.c_int
MICRO_ARGTYPES = [_F, _I, _F, _F, _I, _I, _F]   # table, rows, rays, out,
#                                                 variant, k, stream


def load_micro() -> ctypes.CDLL:
    """The micro kernels' library (csrc/micro.cu), built on first call."""
    return _build.load("micro", {"fspt_micro": MICRO_ARGTYPES})


def micro(table, rays, variant: str, k: int = K):
    """k substeps of `variant`; see the module docstring.  CPU tensors take
    the plain version; CUDA tensors launch the variant's kernels on the
    current stream or raise, and every call that launches adds one to
    `micro.launches`."""
    _check(table, rays, variant, k)
    dev = table.device
    if dev.type == "cpu":
        return micro_reference(table, rays, variant, k)
    if dev.type != "cuda":
        raise ValueError(f"micro runs on cpu or cuda, not {dev}")
    for x in (table, rays):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("micro takes contiguous float32 tensors")
    out = torch.empty((1, WALKS, LANES), dtype=torch.float32, device=dev)
    lib = load_micro()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.fspt_micro(table.data_ptr(), table.shape[0],
                             rays.data_ptr(), out.data_ptr(),
                             VARIANTS.index(variant), k,
                             ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.fspt_cuda_error_string(err).decode()
        raise RuntimeError(f"micro kernel launch failed: {msg}")
    micro.launches += 1
    return out


micro.launches = 0


def make_inputs(device, scene=None):
    """The script's inputs: the bench scene's node+leaf table and rays
    N(0, 1) + 0.5 from numpy's default_rng(0)."""
    from fspt_tpu_torch.testing import make_bunny_standin_scene
    scene = scene or make_bunny_standin_scene(subdivisions=6)
    a = scene.arrays
    table = torch.from_numpy(np.concatenate([a.pk_nodes, a.pk_leaves],
                                            axis=0)).to(device)
    rng = np.random.default_rng(0)
    rays = torch.from_numpy(rng.normal(size=(1, 6, WALKS, LANES))
                            .astype(np.float32) + 0.5).to(device)
    return table, rays


def _seconds(fn, reps):
    """Mean wall time of fn() over `reps` runs that end in a synchronise,
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def main(scene=None, k: int = K, reps: int = 20):
    """ns/substep of the script's four variants on the card (see the module
    docstring for what it means for each family); returns {variant:
    ns/substep}."""
    if not torch.cuda.is_available():
        raise SystemExit("perf_r5d: needs a CUDA device")
    dev = torch.device("cuda")
    table, rays = make_inputs(dev, scene)
    out = {}
    for variant in MAIN_VARIANTS:
        dt = _seconds(lambda: micro(table, rays, variant, k), reps)
        out[variant] = dt / k * 1e9
        what = ("a walk's latency" if variant in _NODE
                else "work over time")
        print(f"{variant:8s} {dt / k * 1e9:8.1f} ns/substep, {what} "
              f"({dt * 1e3:.3f} ms for {k})", flush=True)
    return out


if __name__ == "__main__":
    main()
