// PCG4D uniforms on native 32-bit integers: one launch for every
// `stream_uniforms` call on the card (fspt_tpu_torch/core/rng.py).
//
// Replaces no Pallas kernel.  fspt_tpu/core/rng.py's PCG4D is jnp code that
// XLA fuses into its callers on the TPU.  The port first ran it as a chain of
// about 106 elementwise PyTorch ops on int64 tensors (torch has no complete
// u32 arithmetic), each 32x32-bit product split into 16-bit halves so that it
// never leaves int64: that chain, `stream_uniforms_reference`, stays the plain
// version and the CPU path.  This kernel undoes that emulation: u32 registers
// wrap around exactly where the chain masks to 32 bits, so the two agree bit
// for bit.
//
// What it computes (the contract of `stream_uniforms_reference`): for row r
// of `rows` and lane g of n, with the lane's 32-bit id
//   id = (offset + g) mod 2^32, or the low 32 bits of ids[g * id_stride]
//        (int32 or int64 ids);
// the counter (a, b, c, d) is (id, key0, key1, stream << 8 | r), or, with a
// key table of K rows, (id % lanes_per_key, key_rows[id / lanes_per_key],
// stream << 8 | r); the key comes as two host scalars, a (2,) int64 device
// row or that (K, 2) int64 device table, so that a step captured in a CUDA
// graph reads its keys from device memory only.  out[r, g] is PCG4D's d
// output as (d >> 8) * 2^-24: float32 in [0, 1), exact.  A lane whose key
// row lies past the table (which the plain version refuses with an index
// error) reads NaN in every row, never another lane's key.
//
// What bounds it on an H100, and what the design does about it.  The bytes
// are the uniforms stored, 4 each, and the ids read once (4 or 8 bytes a
// lane): bunny8's first bounce, (11, 175,104) with int32 ids, stores 7.70 MB
// and reads 0.70 MB, 2.5 us at 3.35 TB/s, so the output store bounds it (the
// integer work, some 20 instructions a uniform once the lane's first three
// products leave the row loop, is about as long at the card's integer
// rate).  One thread a lane loads its id and key once, keeps the counter in
// registers through the `rows` rounds and stores row by row, so a warp's 32
// stores of one row land on 128 contiguous bytes.  That launch takes 5.0 us
// on an H100 SXM at 700 W, 50% of the store bound (chip_smoke.py phase 6b);
// the int64 chain took 1.2 ms there, issued eagerly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr uint32_t kMul = 1664525u;
constexpr uint32_t kAdd = 1013904223u;

enum IdKind { kIdOffset = 0, kIdInt32 = 1, kIdInt64 = 2 };
enum KeyKind { kKeyHost = 0, kKeyRow = 1, kKeyTable = 2 };

// PCG4D's d output; the arithmetic of `_pcg4d` with the masks left to the
// registers' wrap-around.
__device__ __forceinline__ uint32_t pcg4d_d(uint32_t a, uint32_t b,
                                            uint32_t c, uint32_t d) {
  a = a * kMul + kAdd;
  b = b * kMul + kAdd;
  c = c * kMul + kAdd;
  d = d * kMul + kAdd;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
  a ^= a >> 16;
  b ^= b >> 16;
  c ^= c >> 16;
  d ^= d >> 16;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
  return d;
}

__global__ void __launch_bounds__(kBlock)
    pcg4d_kernel(const void* ids, int id_kind, long long id_stride,
                 uint32_t offset, int key_kind, const long long* key,
                 uint32_t key0, uint32_t key1, long long key_count,
                 uint32_t lanes_per_key, uint32_t stream_bits, int rows, int n,
                 float* out) {
  const int g = blockIdx.x * kBlock + threadIdx.x;
  if (g >= n) return;
  uint32_t id;
  const long long at = static_cast<long long>(g) * id_stride;
  if (id_kind == kIdInt32)
    id = static_cast<uint32_t>(static_cast<const int32_t*>(ids)[at]);
  else if (id_kind == kIdInt64)
    id = static_cast<uint32_t>(static_cast<const long long*>(ids)[at]);
  else
    id = offset + static_cast<uint32_t>(g);
  uint32_t a = id, b = key0, c = key1;
  if (key_kind == kKeyRow) {
    b = static_cast<uint32_t>(key[0]);
    c = static_cast<uint32_t>(key[1]);
  } else if (key_kind == kKeyTable) {
    const uint32_t s = id / lanes_per_key;
    a = id % lanes_per_key;
    if (s >= key_count) {
      for (int r = 0; r < rows; ++r)
        out[static_cast<long long>(r) * n + g] = __int_as_float(0x7fc00000);
      return;
    }
    b = static_cast<uint32_t>(key[2 * s]);
    c = static_cast<uint32_t>(key[2 * s + 1]);
  }
  for (int r = 0; r < rows; ++r) {
    const uint32_t d =
        pcg4d_d(a, b, c, stream_bits | static_cast<uint32_t>(r));
    // the top 24 bits, exact in float32, times 2^-24
    out[static_cast<long long>(r) * n + g] =
        static_cast<float>(d >> 8) * (1.0f / 16777216.0f);
  }
}

}  // namespace

extern "C" {

// Launches the uniforms on `stream` (asynchronously) and returns
// cudaGetLastError() of the launch: 0 on success.  ids: int32 or int64 lane
// ids (id_kind 1 or 2) read at g * id_stride, or none (id_kind 0: offset + g).
// key: the (2,) int64 row (key_kind 1) or the (key_count, 2) int64 table
// (key_kind 2, with lanes_per_key > 0); key_kind 0 takes key0 and key1.
// out: (rows, n) float32, contiguous.
int fspt_pcg4d_uniforms(const void* ids, int id_kind, long long id_stride,
                        unsigned int offset, int key_kind,
                        const long long* key, unsigned int key0,
                        unsigned int key1, long long key_count,
                        unsigned int lanes_per_key, unsigned int stream_bits,
                        int rows, int n, float* out, void* stream) {
  if (id_kind < kIdOffset || id_kind > kIdInt64 || key_kind < kKeyHost ||
      key_kind > kKeyTable || (key_kind == kKeyTable && lanes_per_key == 0) ||
      rows < 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n + kBlock - 1) / kBlock;
  pcg4d_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      ids, id_kind, id_stride, offset, key_kind, key, key0, key1, key_count,
      lanes_per_key, stream_bits, rows, n, out);
  return static_cast<int>(cudaGetLastError());
}

const char* fspt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
