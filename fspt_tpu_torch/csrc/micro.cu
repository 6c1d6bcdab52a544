// The round-5 substep micro: a fixed number of lockstep-walk substeps with no
// termination condition, for 8 walks of 128 lanes.
//
// Replaces the TPU kernel scripts/perf_r5d.py `micro_kernel` (launched by
// that script's `main`, grid (1,)).  It measures what one substep of the
// lockstep walk costs, by parts: the variant picks the parts, and `k` (a
// runtime argument) the substep count.
//
// What it computes (contract of fspt_tpu_torch/scripts/perf_r5d.py, whose
// `micro_reference` is the plain PyTorch version; the two agree bit for
// bit): out = bt + acc + cur + ptr after k substeps, where per walk
//   * a fetch loads row (cur * -1640531527 + i) in wrapping int32 (computed
//     here in uint32), floor-mod the table's rows (C's % truncates, so the
//     remainder is corrected to be non-negative);
//   * a node part slab-tests the row's 8 children (ix = 1/dx, no safe_inv;
//     the rows are arbitrary, leaf rows included, so lo <= hi does not hold
//     and the test keeps the plain version's min/max of both planes), a
//     child is wanted when any lane of the walk passes, wanted float links
//     are cast to int32 and pushed; a push at p >= 64 is DROPPED and the
//     pointer clipped to 63, silently, as in the JAX kernel: the stack
//     overflows by design within a few substeps and the output is defined
//     with the drop, so unlike every other kernel of the port this one does
//     not raise;
//   * an MT part runs Moller-Trumbore over the row's 8 triangles (strict
//     t < bt; the arithmetic of csrc/walk_common.cuh);
//   * stack and panel start at zero (the JAX scratch is uninitialised but
//     only read where written; panel rows 0-7 start as table rows 0-7).
// Built with --fmad=false, like the traversal kernels.
//
// What bounds it on an H100, and what the design does about it.  The first
// design (PR 3; its times are in PERF.md §6) was the TPU kernel's one
// program as one 1,024-thread block: one SM of 132 ran eight walks'
// substeps at its issue rate, with 8 box and 8 triangle tests in turn in
// every thread and three block barriers a substep.  But the eight walks
// share nothing, and the variants are of three kinds that the card takes
// differently:
//   * full, node, vector are true chains: the vote of substep i names the
//     row of substep i + 1.  A walk is a thread block cluster of 8 blocks on
//     as many SMs (64 blocks a launch), a block 16 of the walk's lanes, and
//     eight threads share a lane as in csrc/traverse4.cu: thread j of a
//     lane's octet tests child j and triangle j, the vote is a ballot folded
//     over the warp's four octets, `bt` the octet's minimum by shuffles (a
//     running minimum of the valid t: no order in it).  The warps' vote
//     words cross the cluster as in csrc/walk1.cu (walk_common.cuh
//     `ClusterVote`: asynchronous stores counted on the receiver's mbarrier,
//     no barrier of the cluster or of the block in a substep), and the
//     triangle tests run while the words travel: this substep's vote needs
//     the old `bt` only.  The next row is one of nine that are known when a
//     row arrives (the 8 children's, and the stack entry a pop would take),
//     so a control warp in every block, which also keeps the block's
//     replica of the stack, fetches all nine as 16-byte asynchronous copies
//     under the tests, into the next bank of a three-bank ring (a testing
//     warp reads its triangle after it has sent its vote, so the control
//     warp can be a substep ahead of it, never two).  What is
//     left is one walk's substep: the nine rows' way from L2, or the tests
//     and the vote's way across the cluster, whichever is longer.  One block
//     a walk (an earlier form) was bound by its SM's issue rate for the
//     walk's 1,024 threads.  The bound of `traversal_bound` divides the
//     operations by the whole card's rate and cannot be approached by eight
//     chains of dependent substeps;
//   * leaf, leaf2, leaf4 have no chain: cur_i = (1 + i) % rows whatever was
//     fetched, every walk draws the same rows, and `bt` is the minimum over
//     all substeps' valid t.  The substeps are cut into slices of kSlice
//     over the whole card (a block: one slice, 256 lanes, a lane a thread,
//     the slice's triangle data staged in shared memory by asynchronous
//     copies), each slice's minima merged by an integer atomicMin on the
//     float's bits (every valid t is > 1e-6 and bt starts at 1e9, so the
//     bits order as the floats do), between a kernel that sets 1e9 and one
//     that adds acc, cur and ptr in the plain version's order;
//   * fetch, fetch1 sum `acc` in substep order, so they stay one chain a
//     walk, but the row sequence is known: a walk is one warp that keeps
//     kAhead - 1 rows in flight as asynchronous copy groups and works out 32
//     substeps' row numbers at a time, a lane each.
// On an NVIDIA H100 80GB HBM3 at 700 W, K = 4096, the bench scene's table
// (chip_smoke.py's [micro_bound] lines; first design -> this, PR 5):
// full 21.9 -> 3.07 ms (~1,480 cycles a substep; `node` costs the same: the
// control warp's two integer modulos and nine-row fetch are the longer
// path, `vector`, which fetches nothing, 2.16 ms), leaf / leaf2 / leaf4 14.4
// / 27.6 / 52.4 -> 0.083 / 0.156 / 0.291 ms (leaf4: 27% of its operations
// bound, over half of what code without fused multiply-adds can reach),
// fetch / fetch1 1.23 / 1.54 -> 0.15 ms.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "walk_common.cuh"   // the Moller-Trumbore arithmetic, copy16, the vote

namespace cg = cooperative_groups;

namespace {

constexpr int kWalks = 8;
constexpr int kLanes = 128;
constexpr int kAll = kWalks * kLanes;
constexpr int kDepth = 64;   // DEPTH in perf_r5d.py
constexpr int kTw = 8;
constexpr unsigned kFull32 = 0xffffffffu;

// variant ids: the index in perf_r5d.VARIANTS
enum Variant { kFull, kNode, kLeaf, kLeaf2, kLeaf4, kFetch, kFetch1, kVector };

__device__ __forceinline__ int row_hash(int cur, int i, int rows) {
  const int x = static_cast<int>(static_cast<unsigned>(cur) * 2654435769u +
                                 static_cast<unsigned>(i));
  const int r = x % rows;
  return r < 0 ? r + rows : r;
}

// `cur` after k substeps of a variant whose cur only counts: (1 + k) % rows
__host__ __device__ inline int counted_cur(int k, int rows) {
  return (1 + k % rows) % rows;
}

__device__ __forceinline__ Ray load_ray(const float* rays, int lane) {
  Ray q;
  q.ox = rays[0 * kAll + lane], q.oy = rays[1 * kAll + lane];
  q.oz = rays[2 * kAll + lane], q.dx = rays[3 * kAll + lane];
  q.dy = rays[4 * kAll + lane], q.dz = rays[5 * kAll + lane];
  q.ix = 1.0f / q.dx, q.iy = 1.0f / q.dy, q.iz = 1.0f / q.dz;
  q.bt = 1e9f, q.bu = 0.0f, q.bv = 0.0f;
  q.bs = -1;
  return q;
}

// ---- full, node, vector: a walk a cluster, eight threads a lane -----------

constexpr int kOctet = 8;
constexpr int kCluster = 8;                        // blocks a walk
constexpr int kBlockLanes = kLanes / kCluster;     // 16 lanes a block
constexpr int kTestThreads = kBlockLanes * kOctet; // 4 warps that test
constexpr int kChainThreads = kTestThreads + 32;   // and the control warp
constexpr int kCand = kTw + 1;     // the 8 children's rows, the pop's
static_assert(kCluster * kTestThreads / 32 == kVoteWords, "a word a warp");

template <int V>
__global__ void __launch_bounds__(kChainThreads)
chain_kernel(const float* __restrict__ table, int rows,
             const float* __restrict__ rays, float* __restrict__ out, int k) {
  constexpr bool kFetches = V != kVector;
  constexpr bool kMtPart = V != kNode;
  // the row ring: the bank the substep reads, the bank the nine candidates
  // of the next substep land in, and a third, because a testing warp still
  // reads substep i's row (its triangle) after the vote that lets the
  // control warp start on substep i + 1, whose copies must land elsewhere
  __shared__ __align__(16) float ring[3][kCand][kRow];
  __shared__ int cand_cur[3][16];
  __shared__ int stack[kDepth];      // this block's replica, the control warp's
  __shared__ VoteBoard board;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int w = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane32 = tid & 31, warp = tid >> 5;
  const bool ctrl = tid >= kTestThreads;
  const int j = tid & (kOctet - 1);                // this thread's child
  const int lane = w * kLanes + rank * kBlockLanes + (ctrl ? 0 : tid >> 3);
  Ray q = load_ray(rays, lane);

  if (ctrl) {
    stack[lane32] = 0, stack[lane32 + 32] = 0;
    // the first substep's row; `vector` reads table row w throughout
    const int base = kFetches ? row_hash(1, 0, rows) : w;
    copy16(&ring[0][0][4 * lane32],
           table + static_cast<size_t>(base) * kRow + 4 * lane32, true);
    copies_landed();
  }
  ClusterVote vote;
  vote.init(&board, tid == 0, 2);    // thread 0's announcement, the control warp
  // the block's barrier too: the row and the zeroed stack are seen, and every
  // block of the cluster runs, its mbarriers set, before any stores into it
  cluster.sync();
  // lane r of a testing warp sends the warp's word to block r
  const bool sender = !ctrl && lane32 < kCluster;
  if (sender) vote.aim(&board, rank * (kTestThreads / 32) + warp, lane32);

  int cur = 1, ptr = 1;
  int bank = 0, slot = 0;            // where this substep's row lies
  for (int i = 0; i < k; ++i) {
    const float* r = kFetches ? ring[bank][slot] : ring[0][0];
    const int nb = bank == 2 ? 0 : bank + 1;
    int link = 0;
    if (ctrl) {
      // lane c: the `cur` that child c's link would make, lane 8: the one a
      // pop would; and those nine rows, for substep i + 1
      __syncwarp();                  // this warp's pushes of the last substep
      if (lane32 < kTw)
        link = static_cast<int>(r[6 * kTw + lane32]);
      else if (lane32 == kTw)
        link = stack[min(max(ptr - 1, 0), kDepth - 1)];
      const int ccur = abs(link) % rows;
      if (lane32 < kCand) cand_cur[nb][lane32] = ccur;
      if (kFetches) {
        const int base = row_hash(ccur, i + 1, rows);
#pragma unroll
        for (int c = 0; c < kCand; ++c)
          copy16(&ring[nb][c][4 * lane32],
                 table + static_cast<size_t>(__shfl_sync(kFull32, base, c)) *
                             kRow + 4 * lane32,
                 true);
        copies_landed();
      }
      __syncwarp();
      if (lane32 == 0) vote.arrive();
    } else {
      // ---- node part: child j's slab, the warp's vote to every block ----
      const float t1x = (r[j] - q.ox) * q.ix;
      const float t2x = (r[3 * kTw + j] - q.ox) * q.ix;
      const float t1y = (r[kTw + j] - q.oy) * q.iy;
      const float t2y = (r[4 * kTw + j] - q.oy) * q.iy;
      const float t1z = (r[2 * kTw + j] - q.oz) * q.iz;
      const float t2z = (r[5 * kTw + j] - q.oz) * q.iz;
      const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                               fminf(t1z, t2z));
      const float tmx = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                              fmaxf(t1z, t2z));
      const unsigned bal = __ballot_sync(
          kFull32, (tmx >= tmin) & (tmx > 0.0f) & (tmin < q.bt));
      if (sender)
        vote.send((bal | bal >> 8 | bal >> 16 | bal >> 24) & 0xffu);
      // ---- MT part, under the vote's way: triangle j, the octet's minimum
      if (kMtPart) {
        const Tri t = tri_prepare(q, r + 9 * j);
        float uu, ww, tt;
        const bool inside = tri_inside(t, 1.0f / tri_divisor(t), uu, ww, tt);
        float best = inside & (tt < q.bt) ? tt : q.bt;
        best = fminf(best, __shfl_xor_sync(kFull32, best, 1));
        best = fminf(best, __shfl_xor_sync(kFull32, best, 2));
        best = fminf(best, __shfl_xor_sync(kFull32, best, 4));
        q.bt = best;
      }
    }
    unsigned want, all;
    vote.collect(&board, tid == 0, want, all);
    // ---- pushes in the order 0..7; a push at p >= 64 is dropped ---------
    if (ctrl && lane32 < kTw && ((want >> lane32) & 1u)) {
      const int pos = ptr + __popc(want & ((1u << lane32) - 1u));
      if (pos < kDepth) stack[pos] = link;
    }
    const int pushes = __popc(want);
    slot = pushes ? 31 - __clz(want) : kTw;        // the last push, or the pop
    cur = cand_cur[nb][slot];
    ptr = min(max(ptr + pushes - 1, 0), kDepth - 1);
    bank = nb;
  }
  if (!ctrl && j == 0)
    out[lane] = q.bt + 0.0f + static_cast<float>(cur) + static_cast<float>(ptr);
  // no block leaves while another may still store into its shared memory
  cluster.sync();
}

// ---- leaf, leaf2, leaf4: slices of the substeps over the whole card -------

constexpr int kSlice = 16;         // substeps a block
constexpr int kLeafThreads = 256;  // lanes a block
constexpr int kTriFloats = 72;     // a row's 8 triangles

__global__ void leaf_begin_kernel(int* __restrict__ best) {
  best[threadIdx.x] = __float_as_int(1e9f);
}

template <int U>
__global__ void __launch_bounds__(kLeafThreads)
leaf_kernel(const float* __restrict__ table, int rows,
            const float* __restrict__ rays, int* __restrict__ best, int k) {
  __shared__ __align__(16) float tris[kSlice * U][kTriFloats];
  __shared__ int base_of[kSlice * U];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kSlice;
  const int units = (min(i0 + kSlice, k) - i0) * U;
  // substep i draws the rows hash((1 + i) % rows, i) + u, u < U
  if (tid < units) {
    const int i = i0 + tid / U;
    base_of[tid] = (row_hash((1 + i) % rows, i, rows) + tid % U) % rows;
  }
  __syncthreads();
  for (int e = tid; e < units * (kTriFloats / 4); e += kLeafThreads) {
    const int unit = e / (kTriFloats / 4), piece = e % (kTriFloats / 4);
    copy16(&tris[unit][4 * piece],
           table + static_cast<size_t>(base_of[unit]) * kRow + 4 * piece,
           true);
  }
  copies_landed();
  __syncthreads();
  const int lane = blockIdx.y * kLeafThreads + tid;
  Ray q = load_ray(rays, lane);
  for (int unit = 0; unit < units; ++unit)
    leaf_tests(q, tris[unit], 8, 0, tid & 31);
  if (q.bt < 1e9f) atomicMin(best + lane, __float_as_int(q.bt));
}

__global__ void leaf_end_kernel(float* __restrict__ out, int cur) {
  const float bt = __int_as_float(reinterpret_cast<int*>(out)[threadIdx.x]);
  out[threadIdx.x] = bt + 0.0f + static_cast<float>(cur) + 1.0f;
}

// ---- fetch, fetch1: a walk a warp, the known row sequence kept in flight ---

constexpr int kAhead = 8;          // ring slots; kAhead - 1 rows in flight

template <int V>
__global__ void __launch_bounds__(32)
fetch_kernel(const float* __restrict__ table, int rows,
             float* __restrict__ out, int k) {
  __shared__ __align__(16) float ring[kAhead][kRow];
  const int w = blockIdx.x;
  const int lane32 = threadIdx.x;
  float acc = 0.0f;                  // every lane sums the same
  if (V == kFetch1 && w > 0) {
    // only walk 0 fetches: the others consume their panel row, table row w
    const float first = table[static_cast<size_t>(w) * kRow];
    for (int i = 0; i < k; ++i) acc = acc + first;
  } else {
    // substep s draws row hash((1 + s) % rows, s) into slot s % kAhead; lane
    // L works out the rows of 32 substeps at a time, substep 32 * (s / 32) + L
    int bases = 0;
    auto issue = [&](int s) {
      if ((s & 31) == 0)
        bases = row_hash((1 + s + lane32) % rows, s + lane32, rows);
      const int base = __shfl_sync(kFull32, bases, s & 31);
      if (s < k)
        copy16(&ring[s % kAhead][4 * lane32],
               table + static_cast<size_t>(base) * kRow + 4 * lane32, true);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    for (int s = 0; s < kAhead - 1; ++s) issue(s);
    for (int i = 0; i < k; ++i) {
      // all but this lane's newest kAhead - 2 groups have landed, and after
      // the warp's barrier every lane's: rows 0..i
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 2) : "memory");
      __syncwarp();
      // slot (i - 1) % kAhead was read before this barrier
      issue(i + kAhead - 1);
      acc = acc + ring[i % kAhead][0];
    }
    copies_landed();
  }
  const float value =
      1e9f + acc + static_cast<float>(counted_cur(k, rows)) + 1.0f;
  for (int l = lane32; l < kLanes; l += 32) out[w * kLanes + l] = value;
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

template <int V>
int launch_chain(const float* table, int rows, const float* rays, float* out,
                 int k, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kWalks * kCluster);
  cfg.blockDim = dim3(kChainThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, chain_kernel<V>, table, rows, rays, out, k);
  return e != cudaSuccess ? static_cast<int>(e) : last_error();
}

template <int U>
int launch_leaf(const float* table, int rows, const float* rays, float* out,
                int k, cudaStream_t stream) {
  int* best = reinterpret_cast<int*>(out);
  leaf_begin_kernel<<<1, kAll, 0, stream>>>(best);
  if (k > 0) {
    const dim3 grid((k + kSlice - 1) / kSlice, kAll / kLeafThreads);
    leaf_kernel<U><<<grid, kLeafThreads, 0, stream>>>(table, rows, rays, best,
                                                      k);
  }
  leaf_end_kernel<<<1, kAll, 0, stream>>>(out, counted_cur(k, rows));
  return last_error();
}

template <int V>
int launch_fetch(const float* table, int rows, float* out, int k,
                 cudaStream_t stream) {
  fetch_kernel<V><<<kWalks, 32, 0, stream>>>(table, rows, out, k);
  return last_error();
}

}  // namespace

extern "C" {

// Launches on `stream` (asynchronously) and returns cudaGetLastError() of
// the launches: 0 on success.  variant: the index in perf_r5d.VARIANTS.
int fspt_micro(const float* table, int rows, const float* rays, float* out,
               int variant, int k, void* stream) {
  if (rows < kWalks || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull: return launch_chain<kFull>(table, rows, rays, out, k, s);
    case kNode: return launch_chain<kNode>(table, rows, rays, out, k, s);
    case kVector: return launch_chain<kVector>(table, rows, rays, out, k, s);
    case kLeaf: return launch_leaf<1>(table, rows, rays, out, k, s);
    case kLeaf2: return launch_leaf<2>(table, rows, rays, out, k, s);
    case kLeaf4: return launch_leaf<4>(table, rows, rays, out, k, s);
    case kFetch: return launch_fetch<kFetch>(table, rows, out, k, s);
    case kFetch1: return launch_fetch<kFetch1>(table, rows, out, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fspt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
