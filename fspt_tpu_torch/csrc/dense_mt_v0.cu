// The FIRST design of the dense treelet MT (one 1,024-thread block a tile,
// every slot tested, one reciprocal at a time), kept buildable so that a
// measurement can time the current csrc/dense_mt.cu against it in one call
// on one card (ops/_versus.py `dense_mt_launcher`; nothing else loads it).
// Same C interface, same results bit for bit.
//
// Dense treelet Moller-Trumbore: every (ray, treelet) pair of a 1024-pair
// tile against all T triangles of its treelet, one 1024-thread block per
// tile, one pair per thread.
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
// What bounds it on an H100: T triangle tests of ~40 flops each per thread
// against T/8 rows (4 or 8 KB) that every thread of the block reads:
// arithmetic and shared-memory reads, not device memory (each tile reads its
// 28 KB of rays once and writes 8 KB).  The design stages the treelet's rows
// into shared memory once per block, with coalesced loads by all threads,
// so that the T tests per thread read broadcast shared words; one barrier
// per tile.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 128;
constexpr int kTile = 1024;

template <int T>
__global__ void __launch_bounds__(kTile)
dense_mt_kernel(const int* __restrict__ tile_tl,
                const float* __restrict__ tris,
                const float* __restrict__ rays, float* __restrict__ t_out,
                int* __restrict__ slot_out, int n_treelets) {
  constexpr int kRows = T / 8;
  __shared__ float rows[kRows * kRow];
  const int tile = blockIdx.x, tid = threadIdx.x;
  const int tl = tile_tl[tile];
  const size_t out = static_cast<size_t>(tile) * kTile + tid;
  if (tl < 0 || tl >= n_treelets) {            // uniform across the block
    t_out[out] = __int_as_float(0x7fc00000);
    slot_out[out] = -1;
    return;
  }
  const float* src = tris + static_cast<size_t>(tl) * kRows * kRow;
  for (int e = tid; e < kRows * kRow; e += kTile) rows[e] = __ldg(src + e);

  const float* ray = rays + static_cast<size_t>(tile) * 7 * kTile + tid;
  const float ox = ray[0 * kTile], oy = ray[1 * kTile], oz = ray[2 * kTile];
  const float dx = ray[3 * kTile], dy = ray[4 * kTile], dz = ray[5 * kTile];
  float bt = ray[6 * kTile];
  int bs = -1;
  __syncthreads();

  for (int r = 0; r < kRows; ++r) {
    for (int j = 0; j < 8; ++j) {
      const float* c = rows + r * kRow + 9 * j;
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
        bs = r * 8 + j;
      }
    }
  }
  t_out[out] = bt;
  slot_out[out] = bs;
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
  if (T == 64)
    dense_mt_kernel<64><<<n_tiles, kTile, 0, s>>>(tile_tl, tris, rays, t,
                                                   slot, rows / 8);
  else if (T == 128)
    dense_mt_kernel<128><<<n_tiles, kTile, 0, s>>>(tile_tl, tris, rays, t,
                                                    slot, rows / 16);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* fspt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
