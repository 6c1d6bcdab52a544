// Dense treelet Moller-Trumbore: every (ray, treelet) pair of a 1024-pair
// tile against the T triangles of its treelet, a tile over kSplit blocks of
// kThreads threads, one pair a thread.
//
// Replaces the TPU kernel scripts/perf_r5_treelet.py `dense_mt_kernel`
// (launched by that script's `main`, stage E of the two-level TLAS +
// dense-treelet study).
//
// What it computes (contract of fspt_tpu_torch/scripts/perf_r5_treelet.py,
// whose `dense_mt_reference` is the plain PyTorch version; the two agree bit
// for bit): for tile i with treelet tl = tile_tl[i], best t starts at the
// ray's tmax (plane 6); over rows tl*(T/8) + r, r < T/8, and triangles j < 8
// at lanes 9j of each row, the MT test with the walk kernels' epsilons and
// strict t < best t, no leaf mask; slot = r*8 + j of the last improving
// triangle, or -1.  rays: (n_tiles, 7, 8, 128) planes; outputs (n_tiles, 8,
// 128).  The wrapper checks that every treelet's rows lie in the table; a
// tile whose treelet does not (a caller that skipped the check) reads
// nothing and gets NaN t and slot -1.
// Built with --fmad=false, like the traversal kernels.
//
// What bounds it on an H100, and what the design does about it.  Float
// operations: T triangle tests of ~55 operations a pair against T/8 rows (4
// or 8 KB) that every pair of the tile reads; each tile reads its 28 KB of
// rays once and writes 8 KB.  The first design (PR 3; its times are in
// PERF.md §6) ran a tile as one 1,024-thread block: the stage's 183 tiles
// were 1.39 blocks an SM, so part of the card ran a second block while the
// rest idled, and every pair tested all T slots with the IEEE reciprocal
// alone.  Here:
//   * a tile is kSplit blocks of kThreads, so that the launch is many small
//     blocks that spread evenly over the 132 SMs;
//   * each block stages the treelet's rows into shared memory as 16-byte
//     asynchronous copies, issued before the ray loads;
//   * the tests are csrc/walk_common.cuh's `leaf_tests`: per row only the
//     slots up to the last triangle with an edge (an all-zero padding slot
//     has a determinant of 0 and can never improve, so t and slot stay
//     bit-equal), the same for every thread of the block, two triangles at a
//     time so that their reciprocals run side by side.
// On an NVIDIA H100 80GB HBM3 at 700 W, stage E at T = 64 (183 tiles;
// PR 6, launches queued behind a sleep kernel so that the device time alone
// is read): 0.051 -> 0.029 ms against the first design, ~25% of the bound:
// near the issue rate of its instructions, ~70 a triangle test without fused
// multiply-adds, loads included, against the 55 operations the bound
// counts.

#include <cuda_runtime.h>

#include "walk_common.cuh"   // leaf_tests, copy16

namespace {

constexpr int kTile = 1024;      // pairs a tile: TILE in perf_r5_treelet.py
constexpr int kThreads = 128;
constexpr int kSplit = kTile / kThreads;   // blocks a tile

template <int T>
__global__ void __launch_bounds__(kThreads)
dense_mt_kernel(const int* __restrict__ tile_tl,
                const float* __restrict__ tris,
                const float* __restrict__ rays, float* __restrict__ t_out,
                int* __restrict__ slot_out, int n_treelets) {
  constexpr int kRows = T / 8;
  __shared__ __align__(16) float rows[kRows][kRow];
  const int tile = blockIdx.x / kSplit, tid = threadIdx.x;
  const int pair = (blockIdx.x % kSplit) * kThreads + tid;
  const int tl = tile_tl[tile];
  const size_t out = static_cast<size_t>(tile) * kTile + pair;
  if (tl < 0 || tl >= n_treelets) {            // uniform across the block
    t_out[out] = __int_as_float(0x7fc00000);
    slot_out[out] = -1;
    return;
  }
  const float* src = tris + static_cast<size_t>(tl) * kRows * kRow;
  for (int e = tid; e < kRows * kRow / 4; e += kThreads)
    copy16(&rows[0][0] + 4 * e, src + 4 * e, true);

  const float* ray = rays + static_cast<size_t>(tile) * 7 * kTile + pair;
  Ray q;
  q.ox = ray[0 * kTile], q.oy = ray[1 * kTile], q.oz = ray[2 * kTile];
  q.dx = ray[3 * kTile], q.dy = ray[4 * kTile], q.dz = ray[5 * kTile];
  q.ix = q.iy = q.iz = 0.0f;                   // (no box tests here)
  q.bt = ray[6 * kTile];
  q.bs = -1;
  q.bu = 0.0f, q.bv = 0.0f;
  copies_landed();
  __syncthreads();

  for (int r = 0; r < kRows; ++r) leaf_tests(q, rows[r], 8, r * 8, tid & 31);
  t_out[out] = q.bt;
  slot_out[out] = q.bs;
}

}  // namespace

extern "C" {

// Launches on `stream` (asynchronously) and returns cudaGetLastError() of
// the launch: 0 on success.  T: 64 or 128 triangles per treelet; rows:
// the table's rows (tris is rows x 128).
int fspt_dense_mt(const int* tile_tl, const float* tris, int rows,
                  const float* rays, float* t, int* slot, int n_tiles, int T,
                  void* stream) {
  if (n_tiles < 0 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = n_tiles * kSplit;
  if (T == 64)
    dense_mt_kernel<64><<<blocks, kThreads, 0, s>>>(tile_tl, tris, rays, t,
                                                    slot, rows / 8);
  else if (T == 128)
    dense_mt_kernel<128><<<blocks, kThreads, 0, s>>>(tile_tl, tris, rays, t,
                                                     slot, rows / 16);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* fspt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
