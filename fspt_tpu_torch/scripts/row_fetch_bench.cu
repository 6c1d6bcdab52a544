// How long a lone warp takes to draw N independent 512-byte rows of a packed
// table from L2 into its SM, by four routes: 16-byte loads into registers,
// 16-byte asynchronous copies into shared memory (LDGSTS, .ca and .cg), and
// one 512-byte bulk copy a row (TMA) that completes on an mbarrier.  The rows
// of an iteration are picked at random from a table of the bench scene's
// size (18,302 rows, 9.4 MB: it stays in L2), and an iteration depends on the
// one before, as a walk's visits do.  The row picking costs ~60 cycles a row
// of integer arithmetic that overlaps the fetches in flight.
//
// Build and run (prints one line per case):
//   nvcc -O3 -arch=sm_90a -o row_fetch_bench row_fetch_bench.cu
//   ./row_fetch_bench
// or python -m fspt_tpu_torch.scripts.perf_walk_launches --row-fetch
//
// A measurement study that nothing else builds: it stays because the header
// of csrc/walk.cu and PERF.md cite its cycle counts for the choice of
// asynchronous copies over bulk copies.

#include <cstdio>
#include <cuda_runtime.h>

enum Route { kLoad = 0, kCopyCa = 1, kCopyCg = 2, kBulk = 3 };

template <int N, int ROUTE>
__global__ void fetch(const float* __restrict__ table, int rows, int iters,
                      unsigned long long* cycles, float* sink) {
  __shared__ __align__(128) float buf[4][16][128];
  __shared__ __align__(8) unsigned long long bar[4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned seed = blockIdx.x * 9781u + 12345u + warp * 7919u;
  float acc = 0.0f;
  const unsigned bar_addr =
      static_cast<unsigned>(__cvta_generic_to_shared(&bar[warp]));
  if (ROUTE == kBulk && lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned parity = 0;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    unsigned pick[N];
#pragma unroll
    for (int c = 0; c < N; ++c) {
      seed = seed * 1664525u + 1013904223u;
      pick[c] = (seed >> 8) % rows;
    }
    if (ROUTE == kLoad) {
      float4 v[N];
#pragma unroll
      for (int c = 0; c < N; ++c)
        v[c] = __ldg(reinterpret_cast<const float4*>(
                         table + static_cast<size_t>(pick[c]) * 128) + lane);
#pragma unroll
      for (int c = 0; c < N; ++c) acc += v[c].x + v[c].y + v[c].z + v[c].w;
    } else if (ROUTE == kBulk) {
      if (lane == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                bar_addr),
            "r"(512u * N)
            : "memory");
      __syncwarp();
      unsigned mine = 0;
#pragma unroll
      for (int c = 0; c < N; ++c)
        if (lane == c) mine = pick[c];
      if (lane < N) {
        const unsigned dst = static_cast<unsigned>(
            __cvta_generic_to_shared(&buf[warp][lane][0]));
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
            "l"(table + static_cast<size_t>(mine) * 128), "r"(512u),
            "r"(bar_addr)
            : "memory");
      }
      unsigned done;
      do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar_addr), "r"(parity)
            : "memory");
      } while (!done);
      parity ^= 1;
    } else {
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const unsigned dst = static_cast<unsigned>(
            __cvta_generic_to_shared(&buf[warp][c][lane * 4]));
        const float* src =
            table + static_cast<size_t>(pick[c]) * 128 + lane * 4;
        if (ROUTE == kCopyCa)
          asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                       "l"(src));
        else
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                       "l"(src));
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    if (ROUTE != kLoad) {
      __syncwarp();
#pragma unroll
      for (int c = 0; c < N; ++c) acc += buf[warp][c][lane];
      __syncwarp();
    }
    seed += acc != 12345.678f ? 0u : 1u;   // the next picks wait for the data
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0)
    atomicAdd(cycles, static_cast<unsigned long long>(t1 - t0));
  if (acc == 1.2345f) *sink = acc;
}

template <int N, int ROUTE>
void run(const char* route, const float* table, int rows, int blocks,
         int threads, unsigned long long* cycles, float* sink) {
  const int iters = 2000;
  fetch<N, ROUTE><<<blocks, threads>>>(table, rows, 200, cycles, sink);
  cudaDeviceSynchronize();
  cudaMemset(cycles, 0, sizeof(unsigned long long));
  fetch<N, ROUTE><<<blocks, threads>>>(table, rows, iters, cycles, sink);
  const cudaError_t e = cudaDeviceSynchronize();
  unsigned long long h = 0;
  cudaMemcpy(&h, cycles, sizeof(h), cudaMemcpyDeviceToHost);
  printf("[row_fetch] route=%s rows_in_flight=%d warps_per_sm=%d "
         "cycles_per_iteration=%.0f%s%s\n",
         route, N, threads / 32,
         static_cast<double>(h) / blocks / iters, e ? " error=" : "",
         e ? cudaGetErrorString(e) : "");
}

template <int ROUTE>
void sweep(const char* route, const float* table, int rows, int blocks,
           int threads, unsigned long long* cycles, float* sink) {
  run<1, ROUTE>(route, table, rows, blocks, threads, cycles, sink);
  run<2, ROUTE>(route, table, rows, blocks, threads, cycles, sink);
  run<4, ROUTE>(route, table, rows, blocks, threads, cycles, sink);
  run<9, ROUTE>(route, table, rows, blocks, threads, cycles, sink);
}

int main() {
  const int rows = 18302;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  float *table, *sink;
  unsigned long long* cycles;
  cudaMalloc(&table, static_cast<size_t>(rows) * 512);
  cudaMemset(table, 0, static_cast<size_t>(rows) * 512);
  cudaMalloc(&cycles, sizeof(unsigned long long));
  cudaMalloc(&sink, sizeof(float));
  for (int threads : {32, 128}) {        // one warp on an SM, then four
    sweep<kLoad>("load16", table, rows, sms, threads, cycles, sink);
    sweep<kCopyCa>("async_copy16_ca", table, rows, sms, threads, cycles, sink);
    sweep<kCopyCg>("async_copy16_cg", table, rows, sms, threads, cycles, sink);
    sweep<kBulk>("bulk_copy512", table, rows, sms, threads, cycles, sink);
  }
  return 0;
}
