// The FIRST design of the group-walk kernel (a synchronous 4-byte-a-thread row
// load, two block barriers a node visit, scalar shared-memory reads), kept
// buildable so that chip_smoke.py can time the current csrc/walk.cu against
// it in one call on one card.  No render path loads this file.  Same C
// interface, same results bit for bit.
//
// Group-walk BVH traversal over the packed node+leaf tables: one thread block
// per group of rays, one ray per thread, one shared node sequence and stack.
//
// Replaces two TPU kernels that compute one algorithm at two group sizes:
//   * fspt_tpu/ops/traverse3.py:64 `_walk_kernel` (launched by
//     `packet_traverse3`): walks of 128 rays over 8- or 16-wide tables, with
//     an optional per-lane count mode (the BVH heatmap) -> `fspt_walk3`;
//   * fspt_tpu/ops/traverse.py:243 `_traverse_kernel` with `_packet_state`
//     (launched by `packet_traverse`): packets of 1024 rays over 8-wide
//     tables, any-hit checked after leaf visits only -> `fspt_walk1`.
// The TPU kernels hold a walk's rays in (8, 128) vector lanes with one-hot
// VMEM stacks and packed-count votes.  On Hopper the natural form is the
// Garanzha/Wald packet traversal: a group is a thread block, each thread
// holds one ray, the stack lives in shared memory, and a vote is a
// block-wide OR (one warp __reduce_or_sync, then an OR over the warps'
// words in shared memory).
//
// What it computes (contract of fspt_tpu_torch/ops/traverse3.py, whose
// `group_walk_reference` is the plain PyTorch version and follows this visit
// order and float arithmetic operation for operation, so the two agree bit
// for bit):
//   * block b walks rays [b*GROUP, (b+1)*GROUP); threads past n hold the
//     JAX kernels' pad rays (origin 1e9, direction (0,1,0), tmax 0), which
//     enter the sign sums and votes as on the TPU but write nothing;
//   * the group's majority signs are Σdx, Σdy, Σdz >= 0, summed in one fixed
//     order: pairwise halving, s[i] += s[i+h] for h = GROUP/2 .. 1;
//   * a node visit slab-tests the node's TW children for every thread's ray
//     (safe_inv and the slab of traverse3.py:95-139); a child is wanted by a
//     ray iff (tmax >= tmin) & (tmax > 0) & (tmin < bt) and its link is
//     valid (> -1e8), and by the group iff any ray wants it;
//   * wanted links are pushed in the order fwd ? TW-1..0 : 0..TW-1, fwd
//     being the group's sign on the node's axis (lane 7*TW); the last push is
//     the next node, and with no push the next node is a pop;
//   * a leaf visit runs Moller-Trumbore over the leaf's `leaf_size`
//     triangles with the TPU kernels' epsilons and strict `t < bt`;
//   * visits: the group's count of node and leaf visits, in every lane; with
//     LANE_COUNTS each lane reports 1 plus, at every node visit, the
//     children its own box test passes with a valid link;
//   * ANY_HIT ends the walk once every lane has slot >= 0 or bt <= 0: after
//     every visit (v3), or after leaf visits only (V1) — the two rules give
//     different visit counts, so both are kept;
//   * the stack holds `stack_depth` entries, stack[0] the sentinel; a walk
//     whose live entries would pass it bumps error[0] and ends, and a walk
//     past `max_steps` visits (8 * (table rows + 64), the v3 backstop)
//     bumps error[1] and ends: the wrapper raises on either after a
//     synchronise, never silently.
// Every thread keeps `cur` and `ptr` in registers: all compute them alike
// from the shared vote and the shared stack, so control flow is uniform
// across the block.  Built with --fmad=false, like traverse4.cu.
//
// What bounds it on an H100: each visit is one dependent 512-byte row load
// (the bench tables stay resident in the 50 MB L2) followed by one block
// barrier (two at a node), in sequence, so a block's time is its visit count
// times that latency; and the union tax: a group visits the union of its
// rays' nodes (the TPU rounds measured 85-108 group visits against ~13 for a
// lone ray on incoherent rays, PERF.md section 6), while each thread's slab
// and triangle tests are wasted on the nodes its own ray does not want.
// Many resident blocks per SM hide part of the latency.  Making it fast is
// later work: a row prefetch one visit ahead, smaller groups for incoherent
// launches, warp-level walks without block barriers.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kRow = 128;          // floats per packed row (ops/packing.py)
constexpr int kStackCap = 4096;    // must match STACK_CAP in ops/traverse3.py
constexpr int kSentinel = INT_MIN;

__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d;
  return 1.0f / s;
}

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmax;
};

struct Hits {
  float* t;
  int* slot;
  float* u;
  float* v;
  int* visits;
};

template <int GROUP, int TW, bool ANY_HIT, bool LANE_COUNTS, bool V1>
__global__ void __launch_bounds__(GROUP)
walk_kernel(const float* __restrict__ nodes, const float* __restrict__ leaves,
            Rays rays, int n, int leaf_size, int stack_depth, int max_steps,
            Hits hits, int* __restrict__ error) {
  constexpr int kWarps = GROUP / 32;
  __shared__ float row[2][kRow];        // double-buffered: no barrier needed
  __shared__ float sums[3][GROUP];      // between a visit's reads and the
  __shared__ unsigned votes[kWarps];    // next visit's row load
  extern __shared__ int stack[];        // [stack_depth]

  const int tid = threadIdx.x;
  const int i = blockIdx.x * GROUP + tid;
  const bool real = i < n;
  const float ox = real ? rays.ox[i] : 1.0e9f;
  const float oy = real ? rays.oy[i] : 1.0e9f;
  const float oz = real ? rays.oz[i] : 1.0e9f;
  const float dx = real ? rays.dx[i] : 0.0f;
  const float dy = real ? rays.dy[i] : 1.0f;
  const float dz = real ? rays.dz[i] : 0.0f;
  float bt = real ? rays.tmax[i] : 0.0f;
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

  // ---- the group's majority direction signs, pairwise halving ----------
  sums[0][tid] = dx;
  sums[1][tid] = dy;
  sums[2][tid] = dz;
  if (tid == 0) stack[0] = kSentinel;
  __syncthreads();
#pragma unroll
  for (int h = GROUP / 2; h > 0; h >>= 1) {
    if (tid < h) {
      sums[0][tid] = sums[0][tid] + sums[0][tid + h];
      sums[1][tid] = sums[1][tid] + sums[1][tid + h];
      sums[2][tid] = sums[2][tid] + sums[2][tid + h];
    }
    __syncthreads();
  }
  const bool sx = sums[0][0] >= 0.0f;
  const bool sy = sums[1][0] >= 0.0f;
  const bool sz = sums[2][0] >= 0.0f;

  int bs = -1;
  float bu = 0.0f, bv = 0.0f;
  int lane_vis = 1;                     // every ray visits the root
  int steps = 0;
  int cur = 0, ptr = 1;                 // at the root; stack[0] = sentinel
  int buf = 0;
  const int lane = tid & 31, warp = tid >> 5;

  while (cur != kSentinel) {
    if (++steps > max_steps) {
      if (tid == 0) atomicAdd(error + 1, 1);
      break;
    }
    const float* src = cur >= 0 ? nodes + static_cast<size_t>(cur) * kRow
                                : leaves + static_cast<size_t>(-cur - 1) * kRow;
    float* r = row[buf];
    buf ^= 1;
    if (tid < kRow) r[tid] = __ldg(src + tid);
    __syncthreads();

    if (cur >= 0) {
      // ---- node: this ray's box tests -> one TW-bit mask, block OR -----
      unsigned mine = 0;
#pragma unroll
      for (int c = 0; c < TW; ++c) {
        const float t1x = (r[c] - ox) * ix;
        const float t2x = (r[3 * TW + c] - ox) * ix;
        const float t1y = (r[TW + c] - oy) * iy;
        const float t2y = (r[4 * TW + c] - oy) * iy;
        const float t1z = (r[2 * TW + c] - oz) * iz;
        const float t2z = (r[5 * TW + c] - oz) * iz;
        const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                                 fminf(t1z, t2z));
        const float tmx = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                                fmaxf(t1z, t2z));
        const bool box = (tmx >= tmin) & (tmx > 0.0f) & (tmin < bt) &
                         (r[6 * TW + c] > -1.0e8f);
        mine |= static_cast<unsigned>(box) << c;
      }
      if (LANE_COUNTS) lane_vis += __popc(mine);
      const unsigned wv = __reduce_or_sync(0xffffffffu, mine);
      if (lane == 0) votes[warp] = wv;
      __syncthreads();
      unsigned want = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) want |= votes[w];

      const float axis = r[7 * TW];
      const bool fwd = axis == 0.0f ? sx : (axis == 1.0f ? sy : sz);
      int k = 0, top = 0;
#pragma unroll
      for (int j = 0; j < TW; ++j) {
        const int c = fwd ? TW - 1 - j : j;
        if ((want >> c) & 1u) {
          top = static_cast<int>(r[6 * TW + c]);
          const int pos = ptr + k;
          if (tid == 0 && pos < stack_depth) stack[pos] = top;
          ++k;
        }
      }
      if (k > 0) {
        ptr += k - 1;   // the last push is the next node, not a live entry
        cur = top;
        if (ptr > stack_depth) {
          if (tid == 0) atomicAdd(error, 1);
          break;
        }
      } else {
        cur = stack[--ptr];
      }
    } else {
      // ---- leaf: Moller-Trumbore over its triangles, every lane ----------
      const int slot_base = (-cur - 1) * leaf_size;
      for (int j = 0; j < leaf_size; ++j) {
        const float* c = r + 9 * j;
        const float px = dy * c[8] - dz * c[7];
        const float py = dz * c[6] - dx * c[8];
        const float pz = dx * c[7] - dy * c[6];
        const float det = c[3] * px + c[4] * py + c[5] * pz;
        const float inv = 1.0f / (fabsf(det) < 1e-6f ? 1.0f : det);
        const float tx = ox - c[0];
        const float ty = oy - c[1];
        const float tz = oz - c[2];
        const float uu = (tx * px + ty * py + tz * pz) * inv;
        const float qx = ty * c[5] - tz * c[4];
        const float qy = tz * c[3] - tx * c[5];
        const float qz = tx * c[4] - ty * c[3];
        const float ww = (dx * qx + dy * qy + dz * qz) * inv;
        const float tt = (c[6] * qx + c[7] * qy + c[8] * qz) * inv;
        const bool ok = (fabsf(det) >= 1e-6f) & (uu >= 0.0f) & (uu <= 1.0f) &
                        (ww >= 0.0f) & (uu + ww <= 1.0f) & (tt > 1e-6f) &
                        (tt < bt);
        if (ok) {
          bt = tt;
          bs = slot_base + j;
          bu = uu;
          bv = ww;
        }
      }
      cur = stack[--ptr];
      if (ANY_HIT && V1) {
        if (__syncthreads_and((bs >= 0) | (bt <= 0.0f))) cur = kSentinel;
      }
    }
    if (ANY_HIT && !V1) {
      if (__syncthreads_and((bs >= 0) | (bt <= 0.0f))) cur = kSentinel;
    }
  }

  if (real) {
    hits.t[i] = bt;
    hits.slot[i] = bs;
    hits.u[i] = bu;
    hits.v[i] = bv;
    hits.visits[i] = LANE_COUNTS ? lane_vis : steps;
  }
}

struct Args {
  const float* nodes;
  const float* leaves;
  Rays rays;
  int n, leaf_size, stack_depth, max_steps;
  Hits hits;
  int* error;
  cudaStream_t stream;
};

template <int GROUP, int TW, bool V1>
int launch(const Args& a, bool any_hit, bool lane_counts,
           int pad_bytes = 0) {
  const dim3 grid((a.n + GROUP - 1) / GROUP);
  const size_t smem =
      static_cast<size_t>(a.stack_depth) * sizeof(int) + pad_bytes;
#define FSPT_WALK(ANY, LC)                                                    \
  if (pad_bytes)                                                              \
    cudaFuncSetAttribute(walk_kernel<GROUP, TW, ANY, LC, V1>,                 \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,         \
                         static_cast<int>(smem));                             \
  walk_kernel<GROUP, TW, ANY, LC, V1><<<grid, GROUP, smem, a.stream>>>(       \
      a.nodes, a.leaves, a.rays, a.n, a.leaf_size, a.stack_depth,             \
      a.max_steps, a.hits, a.error)
  if (any_hit) {
    if (lane_counts) { FSPT_WALK(true, true); } else { FSPT_WALK(true, false); }
  } else {
    if (lane_counts) { FSPT_WALK(false, true); } else { FSPT_WALK(false, false); }
  }
#undef FSPT_WALK
  return static_cast<int>(cudaGetLastError());
}

int bad_args(int n, int leaf_size, int stack_depth) {
  return n < 0 || leaf_size < 1 || leaf_size * 9 > kRow || stack_depth < 1 ||
         stack_depth > kStackCap;
}

Args make_args(const float* nodes, const float* leaves, int node_rows,
               int leaf_rows, const float* ox, const float* oy,
               const float* oz, const float* dx, const float* dy,
               const float* dz, const float* tmax, int n, int leaf_size,
               int stack_depth, float* t, int* slot, float* u, float* v,
               int* visits, int* error, void* stream) {
  return Args{nodes, leaves, Rays{ox, oy, oz, dx, dy, dz, tmax}, n, leaf_size,
              stack_depth, 8 * (node_rows + leaf_rows + 64),
              Hits{t, slot, u, v, visits}, error,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// Every entry point launches on `stream` (asynchronously) and returns
// cudaGetLastError() of the launch: 0 on success.  error: the int32 pair of
// ops/traverse.py ([0] stack overflows, [1] walks stopped by the backstop).

// v3 for measurements: fspt_walk3 whose blocks each ask for `pad_bytes` of
// dynamic shared memory they never touch, so that fewer blocks fit an SM.
// The results do not change, and nothing outlasts the call.
int fspt_walk3_padded(const float* nodes, const float* leaves, int node_rows,
                      int leaf_rows, const float* ox, const float* oy,
                      const float* oz, const float* dx, const float* dy,
                      const float* dz, const float* tmax, int n,
                      int leaf_size, int stack_depth, int tree_width,
                      int any_hit, int lane_counts, float* t, int* slot,
                      float* u, float* v, int* visits, int* error,
                      void* stream, int pad_bytes) {
  if (bad_args(n, leaf_size, stack_depth) || pad_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(nodes, leaves, node_rows, leaf_rows, ox, oy, oz,
                           dx, dy, dz, tmax, n, leaf_size, stack_depth, t,
                           slot, u, v, visits, error, stream);
  if (tree_width == 8)
    return launch<128, 8, false>(a, any_hit, lane_counts, pad_bytes);
  if (tree_width == 16)
    return launch<128, 16, false>(a, any_hit, lane_counts, pad_bytes);
  return static_cast<int>(cudaErrorInvalidValue);
}

// v3: 128-ray groups, tree_width 8 or 16, lane counts allowed.
int fspt_walk3(const float* nodes, const float* leaves, int node_rows,
               int leaf_rows, const float* ox, const float* oy,
               const float* oz, const float* dx, const float* dy,
               const float* dz, const float* tmax, int n, int leaf_size,
               int stack_depth, int tree_width, int any_hit, int lane_counts,
               float* t, int* slot, float* u, float* v, int* visits,
               int* error, void* stream) {
  return fspt_walk3_padded(nodes, leaves, node_rows, leaf_rows, ox, oy, oz,
                           dx, dy, dz, tmax, n, leaf_size, stack_depth,
                           tree_width, any_hit, lane_counts, t, slot, u, v,
                           visits, error, stream, 0);
}

// v1: 1024-ray packets, 8-wide tables, no lane counts.
int fspt_walk1(const float* nodes, const float* leaves, int node_rows,
               int leaf_rows, const float* ox, const float* oy,
               const float* oz, const float* dx, const float* dy,
               const float* dz, const float* tmax, int n, int leaf_size,
               int stack_depth, int tree_width, int any_hit, int lane_counts,
               float* t, int* slot, float* u, float* v, int* visits,
               int* error, void* stream) {
  if (bad_args(n, leaf_size, stack_depth) || tree_width != 8 || lane_counts)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(nodes, leaves, node_rows, leaf_rows, ox, oy, oz,
                           dx, dy, dz, tmax, n, leaf_size, stack_depth, t,
                           slot, u, v, visits, error, stream);
  return launch<1024, 8, true>(a, any_hit, false);
}

const char* fspt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
