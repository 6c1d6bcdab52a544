// The round-5 substep micro, first design: a fixed number of lockstep-walk
// substeps with no termination condition, one 1024-thread block (8 walks of
// 128 lanes, one lane per thread) on one SM, the TPU kernel's grid (1,)
// carried over.  csrc/micro.cu is the kernel that perf_r5d.micro launches;
// this one stays buildable so that a measurement can time the two in one
// process (ops/_versus.py `micro_launcher`, nothing else loads it): it reads
// what one SM's issue rate makes of eight walks' substeps, which is what a
// substep of the one-block programs of csrc/walk5_v0.cu costs.
//
// Replaces the TPU kernel scripts/perf_r5d.py `micro_kernel` (launched by
// that script's `main`, grid (1,)).  It measures what one substep of the
// lockstep walk costs, by parts: the variant (a template parameter) picks
// the parts, and `k` (a runtime argument) the substep count.
//
// What it computes (contract of fspt_tpu_torch/scripts/perf_r5d.py, whose
// `micro_reference` is the plain PyTorch version; the two agree bit for
// bit): out = bt + acc + cur + ptr after k substeps, where per walk
//   * a fetch loads row (cur * -1640531527 + i) in wrapping int32 (computed
//     here in uint32), floor-mod the table's rows (C's % truncates, so the
//     remainder is corrected to be non-negative);
//   * a node part slab-tests the row's 8 children (ix = 1/dx, no safe_inv),
//     a child is wanted when any lane of the walk passes (warp
//     __reduce_or_sync, then an OR over the walk's 4 warps), wanted float
//     links are cast to int32 and pushed; a push at p >= 64 is DROPPED and
//     the pointer clipped to 63, silently, as in the JAX kernel: the stack
//     overflows by design within a few substeps and the output is defined
//     with the drop, so unlike every other kernel of the port this one does
//     not raise;
//   * an MT part runs Moller-Trumbore over the row's 8 triangles (strict
//     t < bt);
//   * stack and panel start at zero (the JAX scratch is uninitialised but
//     only read where written; panel rows 0-7 start as table rows 0-7).
// Built with --fmad=false, like the traversal kernels.
//
// What bounds it on an H100: the one block lives on one SM of 132, so a
// substep costs its loop-carried chain (the row index depends on the last
// substep's cur, the row load (512 B per walk, from L2) on the index, the
// vote and push on the row, two or three block barriers between them) plus
// its arithmetic at one SM's issue rate: an 8-triangle MT unit is ~400 k
// instructions for the 1,024 threads, ~1.8 us, so the MT variants are
// arithmetic bound (measured: per-unit cost does not fall from leaf to
// leaf4), where the TPU's one core ran the (8, 128) panel as vector ops.
// The design keeps walk state in registers (every thread of a walk
// computes the same cur/ptr from shared data; one thread writes the stack)
// and the rows in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 128;
constexpr int kWalks = 8;
constexpr int kLanes = 128;
constexpr int kBlock = kWalks * kLanes;
constexpr int kDepth = 64;   // DEPTH in perf_r5d.py
constexpr int kTw = 8;

// variant ids: the index in perf_r5d.VARIANTS
enum Variant { kFull, kNode, kLeaf, kLeaf2, kLeaf4, kFetch, kFetch1, kVector };

__device__ __forceinline__ int row_hash(int cur, int i, int rows) {
  const int x = static_cast<int>(static_cast<unsigned>(cur) * 2654435769u +
                                 static_cast<unsigned>(i));
  const int r = x % rows;
  return r < 0 ? r + rows : r;
}

__device__ __forceinline__ float mt8(const float* r, float ox, float oy,
                                     float oz, float dx, float dy, float dz,
                                     float bt) {
  for (int j = 0; j < 8; ++j) {
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
    if (ok) bt = tt;
  }
  return bt;
}

template <int V>
__global__ void __launch_bounds__(kBlock)
micro_kernel(const float* __restrict__ table, int rows,
             const float* __restrict__ rays, float* __restrict__ out, int k) {
  constexpr bool kFetches = V == kFull || V == kNode || V == kLeaf ||
                            V == kFetch || V == kFetch1;
  constexpr bool kNodePart = V == kFull || V == kNode || V == kVector;
  constexpr bool kMtPart = V == kFull || V == kLeaf || V == kVector;
  constexpr int kUnits = V == kLeaf2 ? 2 : (V == kLeaf4 ? 4 : 0);
  __shared__ float panel[4 * kWalks][kRow];
  __shared__ int stack[kWalks][kDepth];
  __shared__ unsigned votes[kWalks][4];

  const int tid = threadIdx.x;
  const int w = tid >> 7, lane = tid & (kLanes - 1), wq = (tid >> 5) & 3;
  const float ox = rays[0 * kBlock + tid], oy = rays[1 * kBlock + tid];
  const float oz = rays[2 * kBlock + tid], dx = rays[3 * kBlock + tid];
  const float dy = rays[4 * kBlock + tid], dz = rays[5 * kBlock + tid];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;

  for (int e = tid; e < 4 * kWalks * kRow; e += kBlock)
    (&panel[0][0])[e] = e < kWalks * kRow ? table[e] : 0.0f;
  for (int e = tid; e < kWalks * kDepth; e += kBlock) (&stack[0][0])[e] = 0;
  __syncthreads();

  int cur = 1, ptr = 1;
  float bt = 1e9f, acc = 0.0f;
  for (int i = 0; i < k; ++i) {
    __syncthreads();                 // last substep's reads are done
    if (kFetches) {
      const int base = row_hash(cur, i, rows);
      if (V != kFetch1 || w == 0)
        panel[w][lane] = __ldg(table + static_cast<size_t>(base) * kRow + lane);
    }
    if (kUnits) {
      const int base = row_hash(cur, i, rows);
      for (int u = 0; u < kUnits; ++u)
        panel[u * kWalks + w][lane] = __ldg(
            table + static_cast<size_t>((base + u) % rows) * kRow + lane);
    }
    __syncthreads();
    const float* rd = panel[w];
    if (V == kFetch || V == kFetch1) {
      acc = acc + rd[0];
      cur = (cur + 1) % rows;
      continue;
    }
    if (kNodePart) {
      unsigned mine = 0;
#pragma unroll
      for (int c = 0; c < kTw; ++c) {
        const float t1x = (rd[c] - ox) * ix;
        const float t2x = (rd[3 * kTw + c] - ox) * ix;
        const float t1y = (rd[kTw + c] - oy) * iy;
        const float t2y = (rd[4 * kTw + c] - oy) * iy;
        const float t1z = (rd[2 * kTw + c] - oz) * iz;
        const float t2z = (rd[5 * kTw + c] - oz) * iz;
        const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                                 fminf(t1z, t2z));
        const float tmx = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                                fmaxf(t1z, t2z));
        mine |= static_cast<unsigned>((tmx >= tmin) & (tmx > 0.0f) &
                                      (tmin < bt)) << c;
      }
      const unsigned wv = __reduce_or_sync(0xffffffffu, mine);
      if ((tid & 31) == 0) votes[w][wq] = wv;
      __syncthreads();
      const unsigned want = votes[w][0] | votes[w][1] | votes[w][2] |
                            votes[w][3];
      int p = ptr, top = cur;
      bool pushed = false;
      for (int c = 0; c < kTw; ++c) {
        if (!((want >> c) & 1u)) continue;
        const int link = static_cast<int>(rd[6 * kTw + c]);
        if (lane == 0 && p < kDepth) stack[w][p] = link;   // drop past DEPTH
        top = link;
        pushed = true;
        ++p;
      }
      __syncthreads();
      const int nptr = min(max(p - 1, 0), kDepth - 1);
      const int nxt = pushed ? top : stack[w][nptr];
      cur = abs(nxt) % rows;
      ptr = nptr;
    }
    if (kUnits) {
      for (int u = 0; u < kUnits; ++u)
        bt = mt8(panel[u * kWalks + w], ox, oy, oz, dx, dy, dz, bt);
      cur = (cur + 1) % rows;
      continue;
    }
    if (kMtPart) {
      bt = mt8(rd, ox, oy, oz, dx, dy, dz, bt);
      if (V == kLeaf) cur = (cur + 1) % rows;
    }
  }
  out[tid] = bt + acc + static_cast<float>(cur) + static_cast<float>(ptr);
}

template <int V>
int launch(const float* table, int rows, const float* rays, float* out, int k,
           cudaStream_t stream) {
  micro_kernel<V><<<1, kBlock, 0, stream>>>(table, rows, rays, out, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` (asynchronously) and returns cudaGetLastError() of
// the launch: 0 on success.  variant: the index in perf_r5d.VARIANTS.
int fspt_micro(const float* table, int rows, const float* rays, float* out,
               int variant, int k, void* stream) {
  if (rows < kWalks || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull: return launch<kFull>(table, rows, rays, out, k, s);
    case kNode: return launch<kNode>(table, rows, rays, out, k, s);
    case kLeaf: return launch<kLeaf>(table, rows, rays, out, k, s);
    case kLeaf2: return launch<kLeaf2>(table, rows, rays, out, k, s);
    case kLeaf4: return launch<kLeaf4>(table, rows, rays, out, k, s);
    case kFetch: return launch<kFetch>(table, rows, rays, out, k, s);
    case kFetch1: return launch<kFetch1>(table, rows, rays, out, k, s);
    case kVector: return launch<kVector>(table, rows, rays, out, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fspt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
