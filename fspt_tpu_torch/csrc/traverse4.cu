// BVH traversal over the packed 8- or 16-wide node+leaf tables: one ray per
// OCTET of threads (8 lanes of a warp), each lane testing one child of a node
// or one triangle of a leaf.
//
// Replaces the TPU kernel fspt_tpu/ops/traverse4.py `_walk4_kernel` (launched
// by `packet_traverse4`).  That kernel walked 8x128-ray lockstep packets with
// one-hot VMEM stacks and a phase split between node bursts and leaf-drain
// bursts, all to hide the TPU's scalar latency.  Hopper schedules divergent
// threads itself, so here each ray walks alone with its own stack, as the GLSL
// original did (reference shader/tracer.fs:366-404).
//
// What it computes (contract of fspt_tpu_torch/ops/traverse4.py, whose
// `packet_traverse4_reference` is the plain PyTorch version and follows this
// visit order and float arithmetic operation for operation, so the two agree
// bit for bit):
//   * a pop visits one entry; a node slab-tests its TW children, a child is
//     wanted iff (tmax >= tmin) & (tmax > 0) & (tmin < best_t) and its link
//     is not the empty marker (<= -1e8);
//   * wanted children (nodes and leaves alike) are pushed far to near by the
//     node's sort axis (lane 7*TW) and the ray's own direction sign on it, so
//     the nearest is popped next;
//   * a leaf runs Moller-Trumbore over its `leaf_size` triangles with the TPU
//     kernel's epsilons and strict `t < best_t`, in slot order: the nearest
//     passing triangle wins and, on equal t, the lowest slot; a miss keeps
//     t = tmax and slot = -1;
//   * ANY_HIT ends the walk at the first hit;
//   * visits counts this ray's node and leaf fetches;
//   * a push past `stack_depth` is counted in error[0] and ends the ray: the
//     wrapper raises on it after a synchronise, never silently.
// Built with --fmad=false: contracting the slab and MT sums into FMAs would
// change edge hits against the plain version.
//
// What bounds it on an H100, and what the design does about it.  The work is
// tiny (under 3 visits a ray on the bench launches) and the tables stay in
// the 50 MB L2, so a launch's floor is its ray and hit planes over the
// memory rate (ops/traverse.py `traversal_bound`).  The first design (one ray
// per thread, PR 1) sat two orders above it for three reasons, each
// measured by chip_smoke.py's [shape] lines in PR 4: a warp ran until the
// longest of its 32 rays ended (lockstep loss), each visit made 57 or
// 72 scalar loads that were 32-way gathers once rays diverged, and the 1 KB
// per-thread stack lived in local memory behind the same L1.  Here
//   * a warp holds 4 rays, so it waits for the longest of 4, and a block of
//     64 threads (8 rays) retires as soon as those are done: the hardware's
//     block scheduler is the ray queue;
//   * a node visit is 8 loads a lane (TW = 8), each a 32-byte sector shared
//     by the octet, and one slab test a lane instead of eight in sequence;
//     a leaf visit is 9 loads and one Moller-Trumbore test a lane, joined by
//     three shuffle steps (minimum t, then lowest slot);
//   * the stack is in shared memory, `stack_depth` entries a ray, interleaved
//     over the block's rays so that the octets of a warp hit different banks;
//     wanted children write their own stack entries in parallel, placed by a
//     ballot and a population count.
// The octet's lanes run in lockstep by construction (all their control flow
// depends on octet-uniform values), so every shuffle and ballot names only
// the octet's own 8 lanes and octets of one warp diverge freely.
//
// The nine launches of one bench sample take 0.53 ms in all with this design
// and 1.19 ms with the first (NVIDIA H100 80GB HBM3 at 700 W; PR 4,
// PERF_FINDINGS_ARCHIVE.md).  What did not help: octets that take the
// warp's next ray from a shared counter when theirs ends (the hardware's
// block scheduler is the better queue: the launches of a few thousand rays
// lose their blocks, and those last as long as their longest ray's chain of
// dependent row fetches, ~0.04 ms whatever the count), prefetching a pushed
// child's row into L1, and reading the near and far planes by the ray's
// direction sign (no change, more registers).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kRow = 128;       // floats per packed row (ops/packing.py)
constexpr int kStackCap = 256;  // must match STACK_CAP in ops/traverse4.py
constexpr int kOctet = 8;       // lanes that share one ray
constexpr int kBlock = 64;      // threads per block
constexpr int kRays = kBlock / kOctet;   // rays per block

__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d;
  return 1.0f / s;
}

// TW: the tree width of the tables (8 or 16; ops/packing.py lanes: boxes at
// [0:6*TW], links at [6*TW:7*TW], the sort axis at 7*TW).  A lane tests the
// children sub, sub + 8, .. of a node and the triangles sub, sub + 8, .. of
// a leaf.
template <int TW, bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
walk4_kernel(const float* __restrict__ nodes, const float* __restrict__ leaves,
             const float* __restrict__ ox_, const float* __restrict__ oy_,
             const float* __restrict__ oz_, const float* __restrict__ dx_,
             const float* __restrict__ dy_, const float* __restrict__ dz_,
             const float* __restrict__ tmax_, int n, int leaf_size,
             int stack_depth, float* __restrict__ t_out,
             int* __restrict__ slot_out, float* __restrict__ u_out,
             float* __restrict__ v_out, int* __restrict__ visits_out,
             int* __restrict__ error) {
  constexpr int kPer = TW / kOctet;      // children a lane tests at a node
  extern __shared__ int stacks[];        // [stack_depth][kRays]

  const int ray_in_block = threadIdx.x / kOctet;
  const int i = blockIdx.x * kRays + ray_in_block;
  if (i >= n) return;                    // the whole octet leaves together
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kOctet - 1);   // this lane's place in its octet
  const int first = lane & ~(kOctet - 1);          // the octet's first lane
  const unsigned omask = 0xffu << first;           // the octet's lanes
  int* stack = stacks + ray_in_block;    // entry p lives at stack[p * kRays]

  const float ox = ox_[i], oy = oy_[i], oz = oz_[i];
  const float dx = dx_[i], dy = dy_[i], dz = dz_[i];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  float bt = tmax_[i];
  int bs = -1;
  float bu = 0.0f, bv = 0.0f;
  int vis = 0;

  int link = 0;                          // the root; the stack starts empty
  int ptr = 0;
  while (true) {
    ++vis;
    if (link >= 0) {
      // ---- node: one slab test per lane and child, parallel pushes ------
      const float* row = nodes + static_cast<size_t>(link) * kRow;
      const float axis = __ldg(row + 7 * TW);
      bool want[kPer];
      int child[kPer];
      unsigned mask = 0;                 // bit c: child c is wanted
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int c = sub + k * kOctet;
        const float t1x = (__ldg(row + c) - ox) * ix;
        const float t2x = (__ldg(row + 3 * TW + c) - ox) * ix;
        const float t1y = (__ldg(row + TW + c) - oy) * iy;
        const float t2y = (__ldg(row + 4 * TW + c) - oy) * iy;
        const float t1z = (__ldg(row + 2 * TW + c) - oz) * iz;
        const float t2z = (__ldg(row + 5 * TW + c) - oz) * iz;
        const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                                 fminf(t1z, t2z));
        const float tmx = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                                fmaxf(t1z, t2z));
        const float lf = __ldg(row + 6 * TW + c);
        want[k] = (tmx >= tmin) & (tmx > 0.0f) & (tmin < bt) & (lf > -1.0e8f);
        child[k] = static_cast<int>(lf);
        const unsigned votes = __ballot_sync(omask, want[k]);
        mask |= ((votes >> first) & 0xffu) << (k * kOctet);
      }
      const bool fwd = axis == 0.0f   ? dx >= 0.0f
                       : axis == 1.0f ? dy >= 0.0f
                                      : dz >= 0.0f;
      // push order: children TW-1..0 when fwd (child 0 ends on top), so a
      // wanted child lands above the wanted children pushed before it
      const int count = __popc(mask);
      if (ptr + count > stack_depth) {
        if (sub == 0) atomicAdd(error, 1);
        break;
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int c = sub + k * kOctet;
        const unsigned before = fwd ? mask & ~((2u << c) - 1u)
                                    : mask & ((1u << c) - 1u);
        if (want[k]) stack[(ptr + __popc(before)) * kRays] = child[k];
      }
      ptr += count;
    } else {
      // ---- leaf: one Moller-Trumbore test per lane and triangle ---------
      const int leaf = -link - 1;
      const float* row = leaves + static_cast<size_t>(leaf) * kRow;
      float mt = bt, mu = 0.0f, mv = 0.0f;   // this lane's best, in j order
      int mj = INT_MAX;
      for (int j = sub; j < leaf_size; j += kOctet) {
        const float* c = row + 9 * j;
        const float c0 = __ldg(c + 0), c1 = __ldg(c + 1), c2 = __ldg(c + 2);
        const float c3 = __ldg(c + 3), c4 = __ldg(c + 4), c5 = __ldg(c + 5);
        const float c6 = __ldg(c + 6), c7 = __ldg(c + 7), c8 = __ldg(c + 8);
        const float px = dy * c8 - dz * c7;
        const float py = dz * c6 - dx * c8;
        const float pz = dx * c7 - dy * c6;
        const float det = c3 * px + c4 * py + c5 * pz;
        const float inv = 1.0f / (fabsf(det) < 1e-6f ? 1.0f : det);
        const float tx = ox - c0;
        const float ty = oy - c1;
        const float tz = oz - c2;
        const float uu = (tx * px + ty * py + tz * pz) * inv;
        const float qx = ty * c5 - tz * c4;
        const float qy = tz * c3 - tx * c5;
        const float qz = tx * c4 - ty * c3;
        const float ww = (dx * qx + dy * qy + dz * qz) * inv;
        const float tt = (c6 * qx + c7 * qy + c8 * qz) * inv;
        const bool ok = (fabsf(det) >= 1e-6f) & (uu >= 0.0f) & (uu <= 1.0f) &
                        (ww >= 0.0f) & (uu + ww <= 1.0f) & (tt > 1e-6f) &
                        (tt < mt);
        if (ok) {
          mt = tt;
          mj = j;
          mu = uu;
          mv = ww;
        }
      }
      // the octet's winner: the least t, and on equal t the lowest j, which
      // is what testing j = 0.. in turn with a strict `<` arrives at
      float wt = mt;
      int wj = mj;
#pragma unroll
      for (int off = kOctet / 2; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(omask, wt, off);
        const int oj = __shfl_xor_sync(omask, wj, off);
        if (oj != INT_MAX && (wj == INT_MAX || ot < wt ||
                              (ot == wt && oj < wj))) {
          wt = ot;
          wj = oj;
        }
      }
      if (wj != INT_MAX) {               // octet-uniform
        const int src = first + (wj & (kOctet - 1));
        bt = wt;
        bs = leaf * leaf_size + wj;
        bu = __shfl_sync(omask, mu, src);
        bv = __shfl_sync(omask, mv, src);
      }
      if (kAnyHit && bs >= 0) break;
    }
    if (ptr == 0) break;
    __syncwarp(omask);                   // the pushes, before the pop
    link = stack[--ptr * kRays];
  }
  if (sub == 0) {
    t_out[i] = bt;
    slot_out[i] = bs;
    u_out[i] = bu;
    v_out[i] = bv;
    visits_out[i] = vis;
  }
}

template <int TW, bool kAnyHit>
void launch(cudaStream_t s, const float* nodes, const float* leaves,
            const float* ox, const float* oy, const float* oz, const float* dx,
            const float* dy, const float* dz, const float* tmax, int n,
            int leaf_size, int stack_depth, float* t, int* slot, float* u,
            float* v, int* visits, int* error) {
  const dim3 grid((n + kRays - 1) / kRays);
  const size_t smem = static_cast<size_t>(stack_depth) * kRays * sizeof(int);
  walk4_kernel<TW, kAnyHit><<<grid, kBlock, smem, s>>>(
      nodes, leaves, ox, oy, oz, dx, dy, dz, tmax, n, leaf_size, stack_depth,
      t, slot, u, v, visits, error);
}

}  // namespace

extern "C" {

// Launches the walk on `stream` (asynchronously) and returns
// cudaGetLastError() of the launch: 0 on success.  error: the int32 pair of
// ops/traverse.py (error[0] counts stack overflows).
int fspt_traverse4(const float* nodes, const float* leaves, const float* ox,
                   const float* oy, const float* oz, const float* dx,
                   const float* dy, const float* dz, const float* tmax, int n,
                   int leaf_size, int stack_depth, int any_hit, int tree_width,
                   float* t, int* slot, float* u, float* v, int* visits,
                   int* error, void* stream) {
  if (stack_depth > kStackCap || (tree_width != 8 && tree_width != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FSPT_LAUNCH(TW, ANY)                                                 \
  launch<TW, ANY>(s, nodes, leaves, ox, oy, oz, dx, dy, dz, tmax, n,         \
                  leaf_size, stack_depth, t, slot, u, v, visits, error)
  if (tree_width == 8) {
    if (any_hit) FSPT_LAUNCH(8, true); else FSPT_LAUNCH(8, false);
  } else {
    if (any_hit) FSPT_LAUNCH(16, true); else FSPT_LAUNCH(16, false);
  }
#undef FSPT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

const char* fspt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
