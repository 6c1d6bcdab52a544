"""Other forms of the v5 walk (csrc/walk5.cu), each timed in turns against
it on the captured bounce-0 launch of the round-5 studies.

Each form is csrc/walk5.cu with one change, written beside it as
csrc/walk5_x<form>.cu while the study runs (and removed after), built
through ops/_build.py and launched through ops/_versus.py; each must give
walk5's hits and visits bit for bit.  Per form it prints its registers and
spill bytes (`ptxas -v`, the launched instance), the clusters the card
holds at once and its blocks an SM, the cycles a substep of the median
program (from the measuring entry point `fspt_walk5_stats`) and its time
against walk5's, in turns (walk5, form, form, walk5).  The forms:

  pad4, pad2, pad1  dynamic shared memory padded so that an SM holds 4, 2,
                    1 blocks: a substep's latency with fewer walks an SM
  lb10, lb12        __launch_bounds__ asking for 10 and 12 blocks an SM
                    (fewer registers, spills)
  skip              the box tests skip each invalid child, not only empty
                    fours of them
  mt2               the two drain units' triangle tests side by side, each
                    on its own copy of the best hit, merged as the plain
                    version's order would (the later row wins only with a
                    smaller t)
  box2              at npop 2, both node units' box tests before their
                    reductions
  vote1w            only warp 0 waits at the burst vote, the other warps at
                    a block barrier
  units             pushes and pre-pops a pass a unit (the form first built)

PERF.md §6 cites its numbers.  Run on the card:
    python -m fspt_tpu_torch.scripts.perf_walk5_forms
"""

from __future__ import annotations

import os
import re

import torch

from fspt_tpu_torch.ops import _build
from fspt_tpu_torch.ops._versus import (WALK5_STATS, walk5_launcher,
                                        walk5_occupancy)
from fspt_tpu_torch.scripts.perf_walk_launches import device_ms

_SET_SMEM = ("cudaFuncSetAttribute(walk5_kernel<{}>, "
             "cudaFuncAttributeMaxDynamicSharedMemorySize, "
             "static_cast<int>({}));\n  ")


def _padded(pad):
    def form(s):
        s = _swap(s, "return static_cast<size_t>(stack_depth + qcap) * "
                     "sizeof(int);",
                  f"return static_cast<size_t>(stack_depth + qcap) * "
                  f"sizeof(int) + {pad};")
        s = _swap(s, "  const cudaError_t e = cudaLaunchKernelEx(",
                  "  " + _SET_SMEM.format("TW, ANY, STATS",
                                          "cfg.dynamicSmemBytes")
                  + "const cudaError_t e = cudaLaunchKernelEx(")
        return _swap(s, "  cudaError_t e = cudaOccupancyMaxActiveClusters(",
                     "  " + _SET_SMEM.format("TW, ANY, false", "smem")
                     + "cudaError_t e = cudaOccupancyMaxActiveClusters(")
    return form


def _bounds(blocks):
    return lambda s: _swap(s, "__launch_bounds__(kLanes, 8)",
                           f"__launch_bounds__(kLanes, {blocks})")


_BOX_EACH = r'''
template <int TW>
__device__ __forceinline__ unsigned box_tests_each(const Ray& q,
                                                   const Planes& p,
                                                   const float* r) {
  const float4* r4 = reinterpret_cast<const float4*>(r);
  unsigned mine = 0;
#pragma unroll
  for (int g = 0; g < TW / 4; ++g) {
    const float4 lk = r4[6 * TW / 4 + g];
    if (!((lk.x > -1.0e8f) | (lk.y > -1.0e8f) | (lk.z > -1.0e8f) |
          (lk.w > -1.0e8f)))
      continue;
    const float4 nx = *reinterpret_cast<const float4*>(r + p.near_x + 4 * g);
    const float4 ny = *reinterpret_cast<const float4*>(r + p.near_y + 4 * g);
    const float4 nz = *reinterpret_cast<const float4*>(r + p.near_z + 4 * g);
    const float4 fx = *reinterpret_cast<const float4*>(r + p.far_x + 4 * g);
    const float4 fy = *reinterpret_cast<const float4*>(r + p.far_y + 4 * g);
    const float4 fz = *reinterpret_cast<const float4*>(r + p.far_z + 4 * g);
#define X_SLAB(k, bit)                                                        \
  if (lk.k > -1.0e8f) {                                                       \
    const float tmin = fmaxf(fmaxf((nx.k - q.ox) * q.ix, (ny.k - q.oy) * q.iy), \
                             (nz.k - q.oz) * q.iz);                           \
    const float tmx = fminf(fminf((fx.k - q.ox) * q.ix, (fy.k - q.oy) * q.iy), \
                            (fz.k - q.oz) * q.iz);                            \
    const bool box = (tmx >= tmin) & (tmx > 0.0f) & (tmin < q.bt);            \
    mine |= static_cast<unsigned>(box) << (4 * g + bit);                      \
  }
    X_SLAB(x, 0)
    X_SLAB(y, 1)
    X_SLAB(z, 2)
    X_SLAB(w, 3)
#undef X_SLAB
  }
  return mine;
}
'''

_LEAF_TESTS2 = r'''
__device__ __forceinline__ int tested_pairs(const float* r, int lane) {
  const float* e = r + 9 * (lane & 7) + 3;
  const unsigned edge =
      (__float_as_uint(e[0]) | __float_as_uint(e[1]) | __float_as_uint(e[2]) |
       __float_as_uint(e[3]) | __float_as_uint(e[4]) | __float_as_uint(e[5]))
      << 1;
  const unsigned has = __ballot_sync(0xffffffffu, edge != 0u) & 0xffu;
  return (32 - __clz(has) + 1) >> 1;
}
__device__ __forceinline__ void leaf_tests2(Ray& q, const float* r0, int s0,
                                            const float* r1, int s1,
                                            int lane) {
  const int pairs = max(tested_pairs(r0, lane), tested_pairs(r1, lane));
  Ray b = q;
#pragma unroll 1
  for (int p = 0; p < pairs; ++p) {
    tri_run<2>(q, r0 + 18 * p, s0 + 2 * p);
    tri_run<2>(b, r1 + 18 * p, s1 + 2 * p);
  }
  if (b.bt < q.bt) q.bt = b.bt, q.bs = b.bs, q.bu = b.bu, q.bv = b.bv;
}
'''

_MT = '''      for (int u = 0; u < taken; ++u)
        leaf_tests(q, panel[bank][first_drain + u], p.leaf_size,
                   sub[bank].ord[u] * p.leaf_size, lane);'''
_MT2 = '''      int u = 0;
      if (p.leaf_size == 8)
        for (; u + 1 < taken; u += 2)
          leaf_tests2(q, panel[bank][first_drain + u], sub[bank].ord[u] * 8,
                      panel[bank][first_drain + u + 1],
                      sub[bank].ord[u + 1] * 8, lane);
      for (; u < taken; ++u)
        leaf_tests(q, panel[bank][first_drain + u], p.leaf_size,
                   sub[bank].ord[u] * p.leaf_size, lane);'''

_BOX = '''        for (int u = 0; u < p.npop; ++u) {
          if (!((node_units >> u) & 1u)) continue;
          const unsigned m = __reduce_or_sync(
              kFull, box_tests<TW>(q, planes, panel[bank][u]));
          if (lane == 0) votes[u][warp] = m;
        }'''
_BOX2 = '''        if (p.npop == 2) {
          const unsigned m0 = box_tests<TW>(q, planes, panel[bank][0]);
          const unsigned m1 = box_tests<TW>(q, planes, panel[bank][1]);
          const unsigned w0 = __reduce_or_sync(kFull, m0);
          const unsigned w1 = __reduce_or_sync(kFull, m1);
          if (lane == 0) votes[0][warp] = w0, votes[1][warp] = w1;
        } else {
          for (int u = 0; u < p.npop; ++u) {
            if (!((node_units >> u) & 1u)) continue;
            const unsigned m = __reduce_or_sync(
                kFull, box_tests<TW>(q, planes, panel[bank][u]));
            if (lane == 0) votes[u][warp] = m;
          }
        }'''

_VOTE = '''    vote.collect(&board, tid == 0, any, all);
    lap(kVote);'''
_VOTE1W = '''    __shared__ unsigned any_of_round;
    if (warp == 0) {
      vote.collect(&board, tid == 0, any, all);
      if (lane == 0) any_of_round = any;
    }
    __syncthreads();
    any = any_of_round;
    lap(kVote);'''

_UNITS = '''  auto plan = [&](bool drain, int b) {
    Plan pl;
    pl.parked = cur == kSentinel;
    pl.nodes = 0;
    pl.ptr = ptr;
    if (!drain) {
      for (int u = 0; u < p.npop; ++u) {
        int unit = cur;
        if (u > 0) {
          const bool pops = !pl.parked && ptr - u >= 1;
          unit = pops ? stack[ptr - u] : kSentinel;
          if (pops) pl.ptr = ptr - u;
        }
        if (unit != kSentinel) {
          pl.nodes |= 1u << u;
          copy16(&panel[b][u][4 * lane],
                 nodes + static_cast<size_t>(unit) * kRow + 4 * lane, true);
        }
      }
    }
    const int k = drain ? units : p.lpop, first = drain ? 0 : p.npop;
    pl.taken = min(qlen, k);
    for (int u = 0; u < pl.taken; ++u) {
      const int ord = max(-queue[qlen - 1 - u] - 1, 0);
      if (lane == 0) sub[b].ord[u] = ord;
      copy16(&panel[b][first + u][4 * lane],
             leaves + static_cast<size_t>(ord) * kRow + 4 * lane, true);
    }
    if (lane == 0) {
      sub[b].nodes = pl.nodes;
      sub[b].has = (1u << pl.taken) - 1u;
    }
    return pl;
  };

  auto push = [&](const Plan& pl, int b) {
    int pp = pl.ptr, qq = qlen - pl.taken, top = kSentinel;
    bool pushed = false;
    const unsigned below = (1u << lane) - 1u;
    for (int u = p.npop - 1; u >= 0; --u) {
      if (!((pl.nodes >> u) & 1u)) continue;
      const float* r = panel[b][u];
      const unsigned want = votes[u][0] | votes[u][1] | votes[u][2] |
                            votes[u][3];
      const float axis = r[7 * TW];
      const bool fwd = axis == 0.0f ? sx : (axis == 1.0f ? sy : sz);
      const int c = fwd ? TW - 1 - lane : lane;
      int link = 0;
      bool on = false;
      if (lane < TW) {
        const float lf = r[6 * TW + c];
        on = ((want >> c) & 1u) && lf > -1.0e8f;
        if (on) link = static_cast<int>(lf);
      }
'''
_PUSH_TAIL = "      const unsigned pm = __ballot_sync(kFull, on && link >= 0);"
_HELPERS_AT = "// warp 0's own record of the substep it planned"


def _swap(s, old, new):
    if s.count(old) != 1:
        raise RuntimeError(f"perf_walk5_forms: csrc/walk5.cu no longer has "
                           f"{old[:60]!r} once")
    return s.replace(old, new)


def _units(s):
    a = s.index("  auto plan = [&](bool drain, int b) {")
    b = s.index(_PUSH_TAIL)
    return s[:a] + _UNITS + s[b:]


FORMS = {
    "pad4": _padded(40 * 1024), "pad2": _padded(90 * 1024),
    "pad1": _padded(150 * 1024), "lb10": _bounds(10), "lb12": _bounds(12),
    "skip": lambda s: _swap(
        _swap(s, _HELPERS_AT, _BOX_EACH + "\n" + _HELPERS_AT),
        "box_tests<TW>(q, planes, panel[bank][u])",
        "box_tests_each<TW>(q, planes, panel[bank][u])"),
    "mt2": lambda s: _swap(_swap(s, _HELPERS_AT,
                                 _LEAF_TESTS2 + "\n" + _HELPERS_AT),
                           _MT, _MT2),
    "box2": lambda s: _swap(s, _BOX, _BOX2),
    "vote1w": lambda s: _swap(s, _VOTE, _VOTE1W),
    "units": _units,
}


def registers(log):
    """(registers, spill bytes stored, loaded) of the instance the captured
    launch runs (width 8, nearest hit, no statistics) in a `ptxas -v` log."""
    part = log.split("walk5_kernelILi8ELb0ELb0E", 1)[1]
    spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       part)
    regs = re.search(r"Used (\d+) registers", part)
    return int(regs.group(1)), int(spills.group(1)), int(spills.group(2))


def main(scene=None, forms=tuple(FORMS)):
    """Every form against walk5 on the captured launch; returns {form:
    {"ms", "walk5_ms", "cycles_per_substep", "clusters", "blocks_per_sm",
    "registers"}} (walk5's own entry included)."""
    if not torch.cuda.is_available():
        raise SystemExit("perf_walk5_forms: needs a CUDA device")
    from fspt_tpu_torch.scripts import perf_r5i, r5common
    from fspt_tpu_torch.scripts.traverse5_proto import walk5_geometry
    from fspt_tpu_torch.testing import make_bunny_standin_scene
    base = open(os.path.join(_build.CSRC, "walk5.cu")).read()
    names = [f"walk5_x{f}" for f in forms]
    written = []
    try:
        for form, name in zip(forms, names):
            path = os.path.join(_build.CSRC, f"{name}.cu")
            with open(path, "w") as f:
                f.write(FORMS[form](base))
            written.append(path)
        _build.build_all(["walk5", *names])
        dev = torch.device("cuda")
        scene = scene or make_bunny_standin_scene(subdivisions=6)
        a, meta = scene.to_torch(dev), scene.meta
        so, sd, stm, _ = r5common.capture_bounce0(scene, a, meta,
                                                  perf_r5i.bench_config())
        launch = (a.pk_nodes, a.pk_leaves, so, sd, stm)
        kw = dict(leaf_size=meta.leaf_size,
                  stack_depth=meta.pk_stack_depth + 16)
        ref = walk5_launcher("walk5", launch, kw)()
        g = walk5_geometry(so.x.shape[0])
        out = {}
        for name in ["walk5", *names]:
            stats = torch.zeros((g["blocks"], len(WALK5_STATS)),
                                dtype=torch.int32, device=dev)
            hit = walk5_launcher(name, launch, kw, stats)()
            torch.cuda.synchronize()
            for f in hit._fields:
                if not torch.equal(getattr(hit, f), getattr(ref, f)):
                    raise AssertionError(f"{name} differs from walk5 in {f}")
            s = dict(zip(WALK5_STATS, stats[::8].T.double()))
            old, new = (walk5_launcher(x, launch, kw) for x in ("walk5", name))
            t = [device_ms(fn, 10) for fn in (old, new, new, old)]
            clusters, per_sm = walk5_occupancy(kw, name)
            out[name] = {
                "ms": (t[1] + t[2]) / 2, "walk5_ms": (t[0] + t[3]) / 2,
                "cycles_per_substep": float(
                    (s["cycles"] / s["substeps"]).median()),
                "clusters": clusters, "blocks_per_sm": per_sm,
                "registers": registers(_build.build_info[name]["log"])}
            r = out[name]
            print(f"[walk5_form] form={name} ms={r['ms']:.4f} "
                  f"walk5_ms={r['walk5_ms']:.4f} "
                  f"turns={','.join(f'{x:.4f}' for x in t)} "
                  f"cycles_per_substep_p50={r['cycles_per_substep']:.0f} "
                  f"clusters={clusters} blocks_per_sm={per_sm} "
                  f"registers,spill_st,spill_ld="
                  f"{','.join(map(str, r['registers']))}", flush=True)
        return out
    finally:
        for path in written:
            os.remove(path)


if __name__ == "__main__":
    main()
