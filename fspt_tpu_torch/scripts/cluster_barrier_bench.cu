// What a packet's vote costs when the packet is a thread block cluster: the
// cycles for a cluster of 2, 4 and 8 blocks of 192 threads (four ray warps
// and two control warps, the block of csrc/walk1.cu at 8 blocks a packet; 320
// and 576 threads at 4 and 2) to pass one round of
//   every ray warp stores a word into its slot of every block's shared memory
//   (distributed shared memory), the cluster's barrier, every thread reads
//   the cluster's words,
// the same round with no barrier of the cluster (the words go as asynchronous
// stores that count their bytes on an mbarrier of the receiving block, whose
// threads wait on it: csrc/walk_common.cuh `send_word`, what csrc/walk1.cu
// does), and the same round inside one 1,024-thread block (a word a warp,
// then __syncthreads()), which is what csrc/walk.cu `fspt_walk1_block` pays.  An
// iteration depends on the one before (the word it stores is made from the
// words it read), as a walk's visits do.  Each case runs with one cluster
// (or block) alone on the card and with one block on every SM.  The SMs that
// the first cluster's blocks ran on are printed too: whether a cluster's
// blocks share an SM.
//
// Build and run (prints one line per case):
//   nvcc -O3 -arch=sm_90a -o cluster_barrier_bench cluster_barrier_bench.cu
//   ./cluster_barrier_bench
// or python -m fspt_tpu_torch.scripts.perf_walk_launches --cluster-barrier
//
// A measurement study that nothing else builds: it stays because the header
// of csrc/walk1.cu and PERF.md cite its cycle counts for the cluster's size.

#include <cooperative_groups.h>
#include <cstdio>
#include <cuda_runtime.h>

#include "../csrc/walk_common.cuh"   // send_word and the mbarrier calls

namespace cg = cooperative_groups;

constexpr int kPacketWarps = 32;

__device__ __forceinline__ unsigned smid() {
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

template <int CSIZE, bool BY_BARRIER>
__global__ void cluster_round(int iters, unsigned long long* cycles,
                              unsigned* sms, unsigned* sink) {
  constexpr int kRayWarps = kPacketWarps / CSIZE;
  constexpr unsigned kWordBytes = kPacketWarps * sizeof(unsigned);
  __shared__ __align__(16) unsigned words[2][kPacketWarps];
  __shared__ __align__(8) unsigned long long bars[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool sender = warp < kRayWarps && lane < CSIZE;
  if (blockIdx.x < CSIZE && threadIdx.x == 0) sms[blockIdx.x] = smid();
  const unsigned bar0 = shared_addr(&bars[0]);
  if (!BY_BARRIER && threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) mbar_init(bar0 + 8 * b, 1);
    mbar_init_fence();
    for (int b = 0; b < 2; ++b) mbar_expect(bar0 + 8 * b, kWordBytes);
  }
  cluster.sync();
  unsigned peer_word = 0, peer_bar = 0;
  if (!BY_BARRIER && sender) {
    peer_word =
        peer_addr(shared_addr(&words[0][rank * kRayWarps + warp]), lane);
    peer_bar = peer_addr(bar0, lane);
  }
  unsigned word = threadIdx.x + 1u;
  unsigned phases = 0;
  int vb = 0;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if (BY_BARRIER) {
      if (sender)
        *cluster.map_shared_rank(&words[vb][rank * kRayWarps + warp], lane) =
            word;
      cluster.sync();
    } else {
      // (two banks: only the cycles are read here; csrc/walk1.cu, whose
      // control warps read without sending, goes round three)
      if (sender)
        send_word(peer_word + vb * kWordBytes, word, peer_bar + 8 * vb);
      mbar_wait(bar0 + 8 * vb, (phases >> vb) & 1u);
      phases ^= 1u << vb;
    }
    unsigned any = 0;
#pragma unroll
    for (int w = 0; w < kPacketWarps / 4; ++w) {
      const uint4 v = reinterpret_cast<const uint4*>(words[vb])[w];
      any |= v.x | v.y | v.z | v.w;
    }
    if (!BY_BARRIER && threadIdx.x == 0)
      mbar_expect(bar0 + 8 * vb, kWordBytes);
    word = (any >> 1) + it;          // the next round waits for this one
    vb ^= 1;
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0)
    atomicAdd(cycles, static_cast<unsigned long long>(t1 - t0));
  if (word == 0xdeadbeefu) *sink = word;
  cluster.sync();
}

__global__ void __launch_bounds__(1024)
block_round(int iters, unsigned long long* cycles, unsigned* sink) {
  __shared__ __align__(16) unsigned words[2][kPacketWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned word = threadIdx.x + 1u;
  int vb = 0;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if (lane == 0) words[vb][warp] = word;
    __syncthreads();
    unsigned any = 0;
#pragma unroll
    for (int w = 0; w < kPacketWarps / 4; ++w) {
      const uint4 v = reinterpret_cast<const uint4*>(words[vb])[w];
      any |= v.x | v.y | v.z | v.w;
    }
    word = (any >> 1) + it;
    vb ^= 1;
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0)
    atomicAdd(cycles, static_cast<unsigned long long>(t1 - t0));
  if (word == 0xdeadbeefu) *sink = word;
}

double read_cycles(unsigned long long* cycles, int blocks, int iters) {
  unsigned long long h = 0;
  cudaMemcpy(&h, cycles, sizeof(h), cudaMemcpyDeviceToHost);
  return static_cast<double>(h) / blocks / iters;
}

template <int CSIZE, bool BY_BARRIER>
void run_cluster(int clusters, unsigned long long* cycles, unsigned* sms,
                 unsigned* sink) {
  const int iters = 20000, threads = 1024 / CSIZE + 64;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * CSIZE);
  cfg.blockDim = dim3(threads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CSIZE;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, cluster_round<CSIZE, BY_BARRIER>, 200, cycles, sms, sink);
  cudaDeviceSynchronize();
  cudaMemset(cycles, 0, sizeof(unsigned long long));
  cudaLaunchKernelEx(&cfg, cluster_round<CSIZE, BY_BARRIER>, iters, cycles, sms, sink);
  const cudaError_t e = cudaDeviceSynchronize();
  unsigned h[8] = {};
  cudaMemcpy(h, sms, sizeof(unsigned) * CSIZE, cudaMemcpyDeviceToHost);
  printf("[cluster_barrier] exchange=%s blocks_per_cluster=%d "
         "threads_per_block=%d clusters=%d cycles_per_round=%.0f "
         "first_cluster_sms=",
         BY_BARRIER ? "cluster_barrier" : "async_store_mbarrier", CSIZE,
         threads, clusters,
         read_cycles(cycles, clusters * CSIZE, iters));
  for (int r = 0; r < CSIZE; ++r) printf("%s%u", r ? "," : "", h[r]);
  printf("%s%s\n", e ? " error=" : "", e ? cudaGetErrorString(e) : "");
}

void run_block(int blocks, unsigned long long* cycles, unsigned* sink) {
  const int iters = 20000;
  block_round<<<blocks, 1024>>>(200, cycles, sink);
  cudaDeviceSynchronize();
  cudaMemset(cycles, 0, sizeof(unsigned long long));
  block_round<<<blocks, 1024>>>(iters, cycles, sink);
  const cudaError_t e = cudaDeviceSynchronize();
  printf("[cluster_barrier] one_block threads_per_block=1024 blocks=%d "
         "cycles_per_round=%.0f%s%s\n",
         blocks, read_cycles(cycles, blocks, iters), e ? " error=" : "",
         e ? cudaGetErrorString(e) : "");
}

int main() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  unsigned long long* cycles;
  unsigned *sm_ids, *sink;
  cudaMalloc(&cycles, sizeof(unsigned long long));
  cudaMalloc(&sm_ids, sizeof(unsigned) * 8);
  cudaMalloc(&sink, sizeof(unsigned));
  for (int full = 0; full < 2; ++full) {     // alone, then a block an SM
    run_block(full ? sms : 1, cycles, sink);
    run_cluster<2, true>(full ? sms / 2 : 1, cycles, sm_ids, sink);
    run_cluster<4, true>(full ? sms / 4 : 1, cycles, sm_ids, sink);
    run_cluster<8, true>(full ? sms / 8 : 1, cycles, sm_ids, sink);
    run_cluster<2, false>(full ? sms / 2 : 1, cycles, sm_ids, sink);
    run_cluster<4, false>(full ? sms / 4 : 1, cycles, sm_ids, sink);
    run_cluster<8, false>(full ? sms / 8 : 1, cycles, sm_ids, sink);
  }
  return 0;
}
