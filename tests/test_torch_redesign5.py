"""What the Hopper designs of the substep micro (csrc/micro.cu) and of the
packet walk (csrc/walk1.cu) rely on, pinned on the CPU against the plain
PyTorch versions.

The two kernels lay their work on the card in ways the plain versions do not
spell out: the micro's leaf family takes its row sequence in closed form and
its `bt` as an order-free minimum over slices of the substeps; its chain
variants fetch nine candidate rows a substep ahead and form a walk's vote
from the words of eight blocks; the packet walk forms a packet's vote from
eight 128-ray blocks' warp words and sums the packet's 1,024 directions in
every block.  Each test below writes one of those forms out in plain tensor
code (a model of the kernel's schedule, not of CUDA) and holds it bit for
bit to `micro_reference` or `group_walk_reference`, on inputs made from a
seed with numpy; one case goes through the JAX package's Pallas kernel in
interpret mode (rtol 1e-5 / atol 1e-6: XLA's CPU backend may fuse a product
and a sum into one rounding).  The launch geometry of the cluster kernel is
a pure function, tested as such.
"""

import numpy as np
import pytest
import torch

from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.ops import packing
from fspt_tpu_torch.ops.traverse import (CLUSTER, PACKET, SENTINEL,
                                         packet_geometry,
                                         packet_traverse_reference, safe_inv)
from fspt_tpu_torch.scene.bvh import triangle_aabbs
from fspt_tpu_torch.scene.fastbvh import build_bvh_fast
from fspt_tpu_torch.scripts import perf_r5d
from fspt_tpu_torch.testing import make_test_scene

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
F32 = torch.float32


def _same(a, b):
    """Bit-equal float tensors, NaN lanes compared as NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _hash(cur, i, rows):
    """perf_r5d's row hash on Python ints: wrapping int32, floor modulo."""
    x = (cur * -1640531527 + i) & 0xFFFFFFFF
    if x >= 1 << 31:
        x -= 1 << 32
    return x % rows


# ---- the micro -------------------------------------------------------------

@pytest.fixture(scope="module")
def micro_inputs():
    """The test scene's node + leaf table as it is (3e38 boxes included),
    with a NaN, an infinity and an all-zero triangle put into rows the
    substeps draw, and the script's rays."""
    a = make_test_scene(subdivisions=2).arrays
    table = np.concatenate([a.pk_nodes, a.pk_leaves], axis=0).copy()
    table[3, 5] = np.nan
    table[5, 13] = np.inf
    table[6, 18:27] = 0.0
    rays = (np.random.default_rng(0).normal(size=(1, 6, 8, 128))
            .astype(np.float32) + 0.5)
    return torch.from_numpy(table), torch.from_numpy(rays)


def _mt_all(rows_, rays):
    """Möller–Trumbore of every lane against the 8 triangles of every row of
    `rows_` (R, 128), in `micro_reference`'s operations and order, without
    the `t < bt` test: (valid, t), each (R, 8, 1024)."""
    ox, oy, oz, dx, dy, dz = (rays[0, c].reshape(1, 1, -1) for c in range(6))
    c = [rows_[:, :72].reshape(-1, 8, 9)[:, :, q, None] for q in range(9)]
    px = dy * c[8] - dz * c[7]
    py = dz * c[6] - dx * c[8]
    pz = dx * c[7] - dy * c[6]
    det = c[3] * px + c[4] * py + c[5] * pz
    inv = 1.0 / torch.where(torch.abs(det) < 1e-6, torch.ones_like(det), det)
    tx, ty, tz = ox - c[0], oy - c[1], oz - c[2]
    uu = (tx * px + ty * py + tz * pz) * inv
    qx = ty * c[5] - tz * c[4]
    qy = tz * c[3] - tx * c[5]
    qz = tx * c[4] - ty * c[3]
    ww = (dx * qx + dy * qy + dz * qz) * inv
    tt = (c[6] * qx + c[7] * qy + c[8] * qz) * inv
    ok = ((torch.abs(det) >= 1e-6) & (uu >= 0.0) & (uu <= 1.0) & (ww >= 0.0)
          & (uu + ww <= 1.0) & (tt > 1e-6))
    return ok, tt


@pytest.mark.parametrize("rows,variant", [(8, "leaf"), (9, "leaf2"),
                                          (9, "leaf4"), (8, "fetch1"),
                                          (1000, "fetch")])
def test_leaf_family_row_sequence_in_closed_form(monkeypatch, rows, variant):
    """(a) substep i draws row hash((1 + i) % rows, i) whatever it fetched,
    past a wrap of (1 + i) % rows."""
    rng = np.random.default_rng(rows)
    table = torch.from_numpy(rng.normal(size=(rows, 128)).astype(np.float32))
    rays = torch.from_numpy(rng.normal(size=(1, 6, 8, 128))
                            .astype(np.float32) + 0.5)
    k = rows + 5
    drawn = []
    real = perf_r5d._row_hash

    def spy(cur, i, rows_):
        out = real(cur, i, rows_)
        drawn.append(out.clone())
        return out
    monkeypatch.setattr(perf_r5d, "_row_hash", spy)
    perf_r5d.micro_reference(table, rays, variant, k)
    assert len(drawn) == k
    closed = [_hash((1 + i) % rows, i, rows) for i in range(k)]
    for i, base in enumerate(drawn):
        assert base.tolist() == [closed[i]] * 8, i      # every walk alike
    assert len(set(closed)) > 3


@pytest.mark.parametrize("variant,units", [("leaf", 1), ("leaf2", 2),
                                           ("leaf4", 4)])
def test_leaf_family_bt_is_an_order_free_minimum(micro_inputs, variant,
                                                 units):
    """(b) `bt` of the leaf family is the minimum over the valid t of the
    rows drawn, whatever the order: taken per triangle in parallel, per
    slice of 16 substeps, then across the slices, it gives
    `micro_reference`'s bits, NaN rows and degenerate triangles included."""
    table, rays = micro_inputs
    rows, k = table.shape[0], 40
    ref = perf_r5d.micro_reference(table, rays, variant, k)
    drawn = torch.tensor([[(_hash((1 + i) % rows, i, rows) + u) % rows
                           for u in range(units)] for i in range(k)])
    assert {3, 5, 6} & set(drawn.flatten().tolist())     # the doctored rows
    ok, tt = _mt_all(table[drawn.flatten()], rays)       # (k * units, 8, L)
    best = torch.where(ok, tt, torch.full_like(tt, 1e9))
    best = best.reshape(k, units * 8, -1)
    slices = [best[s:s + 16].amin(dim=(0, 1)) for s in range(0, k, 16)]
    bt = torch.stack(slices + [torch.full_like(slices[0], 1e9)]).amin(0)
    # as integers the bits order as the floats do (every valid t > 1e-6)
    as_int = torch.stack([s.view(torch.int32) for s in slices]).amin(0)
    assert torch.equal(torch.minimum(as_int, torch.tensor(
        np.float32(1e9).view(np.int32))).view(F32), bt)
    cur, ptr = float((1 + k) % rows), 1.0
    out = (bt + 0.0 + cur + ptr).reshape(1, 8, 128)
    assert _same(out, ref)
    assert (ref < 1e9).sum() > 20                        # real hits


def _chain_model(table, rays, variant, k, blocks=8):
    """The micro's chain variants as csrc/micro.cu runs them: a walk's vote
    as the OR of `blocks` blocks' warp words (a warp: four lanes' octets),
    `bt` as the octets' minimum, the next row taken from nine candidates
    named before the vote (the 8 children's links, the entry a pop would
    take), the stack with its silent drop.  Returns (out, every next `cur`
    was a candidate, pushes that were dropped)."""
    rows = table.shape[0]
    ox, oy, oz, dx, dy, dz = (rays[0, c] for c in range(6))      # (8, 128)
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    bt = torch.full((8, 128), 1e9, dtype=F32)
    cur, ptr = [1] * 8, [1] * 8
    stack = [[0] * perf_r5d.DEPTH for _ in range(8)]
    fetches, mt = variant != "vector", variant != "node"
    always, dropped = True, 0
    for i in range(k):
        for w in range(8):
            r = table[_hash(cur[w], i, rows) if fetches else w]
            link = [int(np.float32(v).astype(np.int32))
                    for v in r[48:56].tolist()]
            pop = stack[w][min(max(ptr[w] - 1, 0), perf_r5d.DEPTH - 1)]
            cands = [abs(x) % rows for x in link + [pop]]
            # child j's slab for every lane, by the octet's thread j
            o = lambda a: a[w][:, None]
            t1x, t2x = (r[0:8] - o(ox)) * o(ix), (r[24:32] - o(ox)) * o(ix)
            t1y, t2y = (r[8:16] - o(oy)) * o(iy), (r[32:40] - o(oy)) * o(iy)
            t1z, t2z = (r[16:24] - o(oz)) * o(iz), (r[40:48] - o(oz)) * o(iz)
            tmin = torch.fmax(torch.fmax(torch.fmin(t1x, t2x),
                                         torch.fmin(t1y, t2y)),
                              torch.fmin(t1z, t2z))
            tmx = torch.fmin(torch.fmin(torch.fmax(t1x, t2x),
                                        torch.fmax(t1y, t2y)),
                             torch.fmax(t1z, t2z))
            mine = (tmx >= tmin) & (tmx > 0.0) & (tmin < o(bt))  # (128, 8)
            words = mine.reshape(blocks, -1, 4, 8).any(2)  # a word a warp
            want = words.reshape(-1, 8).any(0).tolist()
            if mt:
                ok, tt = _mt_all(r[None], rays)                  # (1, 8, L)
                ok, tt = (x[0][:, w * 128:(w + 1) * 128] for x in (ok, tt))
                ok = ok & (tt < bt[w])
                bt[w] = torch.where(ok, tt, bt[w].expand(8, -1)).amin(0)
            p = ptr[w]
            for c in range(8):
                if want[c]:
                    if p < perf_r5d.DEPTH:
                        stack[w][p] = link[c]
                    else:
                        dropped += 1
                    p += 1
            pushes = sum(want)
            slot = max(c for c in range(8) if want[c]) if pushes else 8
            nptr = min(max(p - 1, 0), perf_r5d.DEPTH - 1)
            # what the plain version does after the pushes
            nxt = link[slot] if pushes else stack[w][nptr]
            always &= abs(nxt) % rows == cands[slot]
            cur[w], ptr[w] = cands[slot], nptr
    out = (bt + 0.0 + torch.tensor(cur, dtype=F32)[:, None]
           + torch.tensor(ptr, dtype=F32)[:, None])
    return out[None], always, dropped


@pytest.mark.parametrize("variant", ["full", "node", "vector"])
def test_chain_next_row_is_among_the_nine_candidates(micro_inputs, variant):
    """(c) for the chain variants the next `cur` is always one of the nine
    named when the row arrives — with the pop's entry read BEFORE this
    substep's pushes, which is the next `cur` only when nothing is pushed —
    over a run in which the stack has overflowed and the pointer is
    clipped; and the walk built that way gives `micro_reference`'s bits."""
    table, rays = micro_inputs
    k = 28
    out, always, dropped = _chain_model(table, rays, variant, k)
    assert always
    assert dropped > 0                                   # the silent drop
    assert _same(out, perf_r5d.micro_reference(table, rays, variant, k))


# ---- the packet walk -------------------------------------------------------

@pytest.fixture(scope="module")
def walk_inputs():
    """400 random triangles packed 8-wide and 8,193 random rays, every
    second one clipped to a tmax of 0.05-1.5."""
    rng = np.random.default_rng(42)
    centers = rng.uniform(-1, 1, size=(400, 1, 3))
    verts = (centers + rng.normal(size=(400, 3, 3)) * 0.05).astype(np.float32)
    tmin, tmax = triangle_aabbs(verts)
    bvh = build_bvh_fast(tmin, tmax, leaf_size=8)
    v = verts[np.where(bvh.slot_tri < 0, 0, bvh.slot_tri)]
    v[bvh.slot_tri < 0] = 0.0
    pk = packing.pack_bvh(bvh.left, bvh.right, bvh.tri_offset, bvh.node_min,
                          bvh.node_max, v[:, 0], v[:, 1] - v[:, 0],
                          v[:, 2] - v[:, 0], leaf_size=8, width=8)
    n = 8193
    o = rng.uniform(-2, 2, size=(3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    tm = rng.uniform(0.05, 1.5, size=n).astype(np.float32)
    tm[::2] = 1.0e5
    return pk, o, d, tm


def _cluster_walk(nodes, leaves, o, d, tmax, *, any_hit):
    """The packet walk as csrc/walk1.cu runs it: a packet's rays in CLUSTER
    blocks, every block summing the packet's 1,024 directions (pad rays
    included) by pairwise halving, a vote as the OR of the blocks' warp
    words, the box tests on the planes the ray's direction sign names, the
    any-hit end as the AND of the warps' done bits after leaf visits.
    Returns (t, slot, u, v, visits) for the n rays."""
    n = tmax.shape[0]
    geo = packet_geometry(n)
    total = geo["packets"] * PACKET
    assert total - n == geo["pad_rays"]

    def field(a, value):
        return torch.cat([a, torch.full((total - n,), value, dtype=F32)])
    ox, oy, oz = (field(a, 1.0e9) for a in o)
    dx, dy, dz = (field(a, v) for a, v in zip(d, (0.0, 1.0, 0.0)))
    bt = field(tmax, 0.0)
    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)
    bs = torch.full((total,), -1, dtype=torch.int32)
    bu, bv = torch.zeros(total), torch.zeros(total)
    visits = torch.zeros(total, dtype=torch.int32)
    for p in range(geo["packets"]):
        s = slice(p * PACKET, (p + 1) * PACKET)
        signs = []
        for a in (dx, dy, dz):
            x = a[s].clone()
            h = PACKET // 2
            while h:
                x[:h] = x[:h] + x[h:2 * h]
                h //= 2
            signs.append(bool(x[0] >= 0.0))
        oxs, oys, ozs, ixs, iys, izs = (a[s][:, None] for a in
                                        (ox, oy, oz, ix, iy, iz))
        stack, cur, steps = [SENTINEL], 0, 0
        while cur != SENTINEL:
            steps += 1
            if cur >= 0:
                r = nodes[cur]
                lo, hi = r[0:24].reshape(3, 8), r[24:48].reshape(3, 8)
                near = [torch.where(i_ > 0, lo[k], hi[k])
                        for k, i_ in enumerate((ixs, iys, izs))]
                far = [torch.where(i_ > 0, hi[k], lo[k])
                       for k, i_ in enumerate((ixs, iys, izs))]
                tmin = torch.fmax(torch.fmax((near[0] - oxs) * ixs,
                                             (near[1] - oys) * iys),
                                  (near[2] - ozs) * izs)
                tmx = torch.fmin(torch.fmin((far[0] - oxs) * ixs,
                                            (far[1] - oys) * iys),
                                 (far[2] - ozs) * izs)
                mine = ((tmx >= tmin) & (tmx > 0.0) & (tmin < bt[s][:, None])
                        & (r[48:56] > -1.0e8))               # (1024, 8)
                words = mine.reshape(CLUSTER, -1, 32, 8).any(2)
                want = words.reshape(-1, 8).any(0).tolist()
                fwd = signs[int(r[56])]
                order = range(7, -1, -1) if fwd else range(8)
                pushed = [int(r[48 + c]) for c in order if want[c]]
                if pushed:
                    stack.extend(pushed[:-1])
                    cur = pushed[-1]
                else:
                    cur = stack.pop()
            else:
                leaf = -cur - 1
                ok, tt = None, None
                row = leaves[leaf]
                e = lambda j, q: row[9 * j + q]
                for j in range(8):
                    px = dy[s] * e(j, 8) - dz[s] * e(j, 7)
                    py = dz[s] * e(j, 6) - dx[s] * e(j, 8)
                    pz = dx[s] * e(j, 7) - dy[s] * e(j, 6)
                    det = e(j, 3) * px + e(j, 4) * py + e(j, 5) * pz
                    inv = 1.0 / torch.where(torch.abs(det) < 1e-6,
                                            torch.ones_like(det), det)
                    tx, ty, tz = ox[s] - e(j, 0), oy[s] - e(j, 1), oz[s] - e(j, 2)
                    uu = (tx * px + ty * py + tz * pz) * inv
                    qx = ty * e(j, 5) - tz * e(j, 4)
                    qy = tz * e(j, 3) - tx * e(j, 5)
                    qz = tx * e(j, 4) - ty * e(j, 3)
                    ww = (dx[s] * qx + dy[s] * qy + dz[s] * qz) * inv
                    tt = (e(j, 6) * qx + e(j, 7) * qy + e(j, 8) * qz) * inv
                    ok = ((torch.abs(det) >= 1e-6) & (uu >= 0.0) & (uu <= 1.0)
                          & (ww >= 0.0) & (uu + ww <= 1.0) & (tt > 1e-6)
                          & (tt < bt[s]))
                    bt[s] = torch.where(ok, tt, bt[s])
                    bs[s] = torch.where(ok, leaf * 8 + j, bs[s])
                    bu[s] = torch.where(ok, uu, bu[s])
                    bv[s] = torch.where(ok, ww, bv[s])
                cur = stack.pop()
                if any_hit:
                    done = ((bs[s] >= 0) | (bt[s] <= 0.0)).reshape(-1, 32)
                    if bool(done.all(1).all()):
                        cur = SENTINEL
        visits[s] = steps
    return tuple(a[:n] for a in (bt, bs, bu, bv, visits))


@pytest.fixture(scope="module")
def walk_tensors(walk_inputs):
    pk, o, d, tm = walk_inputs
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return t(pk.nodes), t(pk.leaves), [t(x) for x in o], [t(x) for x in d], \
        t(tm), 8 * (pk.depth + 2)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n", [1, 1023, 1025, 8193])
def test_packet_walk_as_a_cluster_of_blocks(walk_tensors, n, any_hit):
    """(d) the plain packet walk equals, bit for bit, the walk whose votes
    are the OR of eight 128-ray blocks' warp words and whose signs every
    block sums from the packet's 1,024 directions, on ragged n."""
    nodes, leaves, o, d, tm, depth = walk_tensors
    o, d, tm = [x[:n] for x in o], [x[:n] for x in d], tm[:n]
    ref = packet_traverse_reference(nodes, leaves, V3(*o), V3(*d), tm,
                                    leaf_size=8, any_hit=any_hit,
                                    stack_depth=depth)
    ours = _cluster_walk(nodes, leaves, o, d, tm, any_hit=any_hit)
    for name, a, b in zip(ref._fields, ours, ref):
        assert torch.equal(a, b), name
    if n > 1000:
        assert (ref.slot >= 0).sum() > 20


def test_packet_walk_as_a_cluster_matches_pallas_kernel(walk_tensors):
    """(d) the same walk against the JAX package's Pallas kernel in
    interpret mode, on two packets of which the second is one ray and 1,023
    pad rays."""
    import jax.numpy as jnp
    from fspt_tpu.core.vec import V3 as JV3
    from fspt_tpu.ops.traverse import packet_traverse as jax_packet_traverse
    nodes, leaves, o, d, tm, depth = walk_tensors
    n = 1025
    o, d, tm = [x[:n] for x in o], [x[:n] for x in d], tm[:n]
    t, slot, u, v, visits = _cluster_walk(nodes, leaves, o, d, tm,
                                          any_hit=False)
    j = lambda x: jnp.asarray(x.numpy())
    ref = jax_packet_traverse(j(nodes), j(leaves), JV3(*map(j, o)),
                              JV3(*map(j, d)), j(tm), leaf_size=8,
                              stack_depth=depth, interpret=True)
    ref = [np.asarray(x) for x in ref]
    np.testing.assert_array_equal(slot.numpy(), ref[1])
    for ours, theirs in ((t, ref[0]), (u, ref[2]), (v, ref[3])):
        np.testing.assert_allclose(ours.numpy(), theirs, **TOL)
    # the first packet's direction sums are far from 0 (a steady sign); the
    # second is one ray and pad rays along +y
    sums = np.abs(np.stack([x[:PACKET].numpy() for x in d])
                  .astype(np.float64).sum(1))
    assert sums.min() >= 1e-3
    np.testing.assert_array_equal(visits.numpy()[:PACKET], ref[4][:PACKET])


@pytest.mark.parametrize("n,packets,pad_rays,pad_blocks", [
    (0, 0, 0, 0), (1, 1, 1023, 7), (1024, 1, 0, 0), (1025, 2, 1023, 7),
    (8191, 8, 1, 0), (8192, 8, 0, 0), (8193, 9, 1023, 7)])
def test_packet_launch_geometry(n, packets, pad_rays, pad_blocks):
    """(e) whole packets, a cluster of CLUSTER blocks a packet, blocks of
    1024 / CLUSTER rays and two control warps."""
    g = packet_geometry(n)
    assert g == {"packets": packets, "blocks": packets * CLUSTER,
                 "threads": PACKET // CLUSTER + 64,
                 "rays_per_block": PACKET // CLUSTER, "pad_rays": pad_rays,
                 "pad_blocks": pad_blocks}
    assert g["blocks"] % CLUSTER == 0
    assert g["blocks"] * g["rays_per_block"] == n + pad_rays
    with pytest.raises(ValueError, match="n must be"):
        packet_geometry(-1 - n)
