// The FIRST design of the traverse4 kernel (one ray per thread, a 1 KB local
// stack, scalar loads), kept buildable so that chip_smoke.py can time the
// current csrc/traverse4.cu against it in one call on one card.  No render
// path loads this file.  Same C interface, same results bit for bit.
//
// BVH traversal over the packed 8- or 16-wide node+leaf tables, one ray per
// thread.
//
// Replaces the TPU kernel fspt_tpu/ops/traverse4.py `_walk4_kernel` (launched
// by `packet_traverse4`).  That kernel walked 8x128-ray lockstep packets with
// one-hot VMEM stacks and a phase split between node bursts and leaf-drain
// bursts, all to hide the TPU's scalar latency.  Hopper schedules divergent
// threads itself, so here each thread walks its own ray with its own stack,
// as the GLSL original did (reference shader/tracer.fs:366-404).
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
//     kernel's epsilons and strict `t < best_t`; a miss keeps t = tmax and
//     slot = -1;
//   * ANY_HIT ends the walk at the first hit;
//   * visits counts this ray's node and leaf fetches;
//   * a push past `stack_depth` is counted in error[0] and ends the ray: the
//     wrapper raises on it after a synchronise, never silently.
// Built with --fmad=false: contracting the slab and MT sums into FMAs would
// change edge hits against the plain version.
//
// What bounds it on an H100: each visit is a chain of dependent loads (pop ->
// row -> 57 node floats or 9*leaf_size triangle floats) served from L2 (the
// ~9.4 MB bench tables stay resident in the 50 MB L2), and warps diverge as
// their rays take different paths and lengths.  Tables are read in place
// through the read-only path (__ldg), never restaged.  Making it fast is later
// work: wide (float4) loads of the node row, a short shared-memory stack top,
// persistent threads that refill finished lanes, FMA with a stated tolerance.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 128;       // floats per packed row (ops/packing.py)
constexpr int kStackCap = 256;  // must match STACK_CAP in ops/traverse4.py
constexpr int kBlock = 128;

__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d;
  return 1.0f / s;
}

// TW: the tree width of the tables (8 or 16; ops/packing.py lanes: boxes at
// [0:6*TW], links at [6*TW:7*TW], the sort axis at 7*TW).
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
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = ox_[i], oy = oy_[i], oz = oz_[i];
  const float dx = dx_[i], dy = dy_[i], dz = dz_[i];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  float bt = tmax_[i];
  int bs = -1;
  float bu = 0.0f, bv = 0.0f;
  int vis = 0;

  int stack[kStackCap];
  int ptr = 0;
  stack[ptr++] = 0;  // root
  while (ptr > 0) {
    const int link = stack[--ptr];
    ++vis;
    if (link >= 0) {
      const float* row = nodes + static_cast<size_t>(link) * kRow;
      bool want[TW];
      int child[TW];
#pragma unroll
      for (int c = 0; c < TW; ++c) {
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
        want[c] = (tmx >= tmin) & (tmx > 0.0f) & (tmin < bt) & (lf > -1.0e8f);
        child[c] = static_cast<int>(lf);
      }
      const float axis = __ldg(row + 7 * TW);
      const bool fwd = axis == 0.0f   ? dx >= 0.0f
                       : axis == 1.0f ? dy >= 0.0f
                                      : dz >= 0.0f;
      bool overflowed = false;
#pragma unroll
      for (int j = 0; j < TW; ++j) {
        const int c = fwd ? TW - 1 - j : j;
        if (want[c]) {
          if (ptr >= stack_depth) {
            overflowed = true;
          } else {
            stack[ptr++] = child[c];
          }
        }
      }
      if (overflowed) {
        atomicAdd(error, 1);
        break;
      }
    } else {
      const int leaf = -link - 1;
      const float* row = leaves + static_cast<size_t>(leaf) * kRow;
      const int slot_base = leaf * leaf_size;
      for (int j = 0; j < leaf_size; ++j) {
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
                        (tt < bt);
        if (ok) {
          bt = tt;
          bs = slot_base + j;
          bu = uu;
          bv = ww;
        }
      }
      if (kAnyHit && bs >= 0) break;
    }
  }
  t_out[i] = bt;
  slot_out[i] = bs;
  u_out[i] = bu;
  v_out[i] = bv;
  visits_out[i] = vis;
}

template <int TW, bool kAnyHit>
void launch(dim3 grid, cudaStream_t s, const float* nodes, const float* leaves,
            const float* ox, const float* oy, const float* oz, const float* dx,
            const float* dy, const float* dz, const float* tmax, int n,
            int leaf_size, int stack_depth, float* t, int* slot, float* u,
            float* v, int* visits, int* error) {
  walk4_kernel<TW, kAnyHit><<<grid, kBlock, 0, s>>>(
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
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FSPT_LAUNCH(TW, ANY)                                                 \
  launch<TW, ANY>(grid, s, nodes, leaves, ox, oy, oz, dx, dy, dz, tmax, n,   \
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
