// The 1,024-ray packet walk over the packed node+leaf tables, a packet as a
// thread block cluster: `fspt_walk1`, what ops/traverse.py `packet_traverse`
// launches.
//
// Replaces the TPU kernel fspt_tpu/ops/traverse.py:243 `_traverse_kernel`
// with `_packet_state` (launched by `packet_traverse`, :285): packets of
// 1,024 rays over 8-wide tables, one node sequence and one stack a packet,
// any-hit checked after leaf visits only, `visits` the packet's count.
//
// What it computes is the contract at the head of csrc/walk.cu at a group of
// 1,024 rays with v1's any-hit rule, and the plain PyTorch version is the
// same `group_walk_reference` (group=1024, v1=True): the pad rays, the
// majority signs summed by pairwise halving h = 512 .. 1 over the packet's
// 1,024 directions, pushes in fwd ? 7..0 : 0..7, the error pair.  The ray
// tests are those of csrc/walk_common.cuh, shared with walk.cu, so the two
// kernels and the plain version agree bit for bit.
//
// What bounds it on an H100, and what the design does about it.  As in
// walk.cu the floor is float operations (every lane tests every row the
// packet visits) and the time is a chain: a packet is a sequence of visits
// each of which needs the vote of all 1,024 rays before the next row is
// known.  On the bench scene's camera rays (NVIDIA H100 80GB HBM3 at 700 W;
// chip_smoke.py's [shape] lines) half of the 256 packets end at the root and
// one makes 1,047 visits, so the launch lasts as long as that packet; the
// first bounce's 512 packets make 357 visits each in the mean and fill the
// card.  As one 1,024-thread block (the design before, PR 2-4) a visit
// cost ~4,300 cycles: one SM's issue time for 32 warps under a 64-register
// cap, with nothing else resident on the SM while they wait at the barrier.
// Here a visit of a packet that has its SMs to itself costs ~1,700, and the
// bounce launch runs at walk.cu's lane-visits a millisecond.  A
// packet is a cluster of kCluster blocks on as many SMs, and a block is
// walk.cu's 128-ray block: 1,024 / kCluster rays in one-ray threads plus two
// control warps that fetch, under the tests, every row the next visit can
// need into the block's own ring of shared rows.  Every block keeps its own
// replica of the stack and of cur/ptr/steps; only the vote crosses SMs:
//   * each ray warp stores its 8-bit vote word (bit 8: all its lanes are
//     done, for any-hit) into the same slot of every block's shared memory
//     (distributed shared memory, one lane a peer) as an asynchronous store
//     that counts its bytes on an mbarrier of the receiving block
//     (walk_common.cuh `send_word`);
//   * where the block barrier stood, every thread waits on its own block's
//     mbarrier for the packet's 32 words (and for the control warps' one
//     arrival each, which says their rows have landed), and then ORs the
//     words: all replicas compute the same pushes and the same next row, so
//     control stays uniform across the cluster as it is across a block.  No
//     barrier of the cluster: a round of plain stores and barrier.cluster
//     costs ~1,400 cycles on this card whatever the cluster's size, the
//     round of counted stores ~500, the round inside one 1,024-thread block
//     ~660 (PR 5, PERF_FINDINGS_ARCHIVE.md), and a packet
//     is a chain of such rounds (with the vote through barrier.cluster
//     this kernel took 1.06 against 0.93 ms on the camera rays and 4.7
//     against 4.3 on the first bounce);
//   * a leaf visit of a nearest-hit walk needs no vote, so it keeps the
//     block barrier alone and the blocks of a cluster may run a leaf visit
//     apart; the vote words and their mbarriers go round three banks, so a
//     fast block's vote never lands on words a slow block's control warp
//     still reads (a block can run at most one exchange ahead of a peer's
//     ray warps, two ahead of its control warps);
//   * each block reads the packet's 1,024 directions itself and sums them in
//     the fixed order: the signs cost no exchange.
// Only the cluster's first block bumps the error counters.  A launch's last
// packet is padded with pad rays to whole blocks and a whole cluster.  At 4
// and at 2 blocks a packet the camera rays took 1.1 and 1.5 ms against 0.93
// at 8 (the first bounce 4.4 and 4.9 against 4.3), so 8 it is.

#include <cooperative_groups.h>

#include "walk_common.cuh"   // the ray tests, copy16, Args

namespace cg = cooperative_groups;

namespace {

constexpr int kPacket = 1024;      // rays a packet: PACKET in ops/traverse.py
constexpr int kTW = 8;
constexpr int kBank = kTW + 1;     // a bank: every child's row, the stack top's
static_assert(kPacket / 32 == kVoteWords, "a word a ray warp");
constexpr int kCtrlWarps = 2;
constexpr int kCluster = 8;        // blocks a packet: CLUSTER in ops/traverse.py
constexpr int kRays = kPacket / kCluster;          // rays a block holds
constexpr int kRayWarps = kRays / 32;
constexpr int kThreads = kRays + 32 * kCtrlWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kDoneBit = 1u << kTW;

template <bool ANY_HIT>
__global__ void __launch_bounds__(kThreads)
walk1_kernel(const float* __restrict__ nodes, const float* __restrict__ leaves,
             Rays rays, int n, int leaf_size, int stack_depth, int max_steps,
             Hits hits, int* __restrict__ error) {
  // the row ring: three banks, so that the rows fetched during a visit never
  // land on the row being read or on the one read a visit earlier
  __shared__ __align__(16) float row[3 * kBank][kRow];
  __shared__ float sums[3][kPacket];
  // the packet's vote words, one a ray warp of the cluster, written by the
  // warps themselves through distributed shared memory
  __shared__ VoteBoard board;
  extern __shared__ int stack[];                   // [stack_depth]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int packet = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int cw = warp - kRayWarps;      // control warp 0 keeps the stack
  const bool ctrl = cw >= 0;
  const bool keeper = cw == 0;
  const bool is_ray = tid < kRays;
  const int first = packet * kPacket;   // the packet's first ray
  const int i = first + rank * kRays + tid;
  const bool real = is_ray && i < n;
  const bool leader = rank == 0 && tid == 0;
  auto row_of = [&](int link) {         // (~link == -link - 1)
    return link >= 0 ? nodes + static_cast<size_t>(link) * kRow
                     : leaves + static_cast<size_t>(~link) * kRow;
  };
  // one warp fetches one whole row, 16 bytes a lane, where `on` is set
  auto fetch = [&](const float* src, float* slot, bool on) {
    copy16(slot + 4 * lane, src + 4 * lane, on);
  };
  if (keeper) fetch(nodes, row[0], true);

  Ray q;
  q.ox = real ? rays.ox[i] : 1.0e9f;
  q.oy = real ? rays.oy[i] : 1.0e9f;
  q.oz = real ? rays.oz[i] : 1.0e9f;
  q.dx = real ? rays.dx[i] : 0.0f;
  q.dy = real ? rays.dy[i] : 1.0f;
  q.dz = real ? rays.dz[i] : 0.0f;
  q.bt = real ? rays.tmax[i] : 0.0f;
  q.ix = safe_inv(q.dx), q.iy = safe_inv(q.dy), q.iz = safe_inv(q.dz);
  q.bs = -1;
  q.bu = 0.0f, q.bv = 0.0f;
  const Planes planes = planes_of<kTW>(q);

  // ---- the packet's majority direction signs: every block sums all 1,024
  // directions (pad rays included) by pairwise halving, the order of
  // walk.cu's block and of the plain version ------------------------------
  for (int e = tid; e < kPacket; e += kThreads) {
    const bool in = first + e < n;
    sums[0][e] = in ? rays.dx[first + e] : 0.0f;
    sums[1][e] = in ? rays.dy[first + e] : 1.0f;
    sums[2][e] = in ? rays.dz[first + e] : 0.0f;
  }
  if (tid == 0) stack[0] = kSentinel;
  __syncthreads();
  for (int h = kPacket / 2; h > 0; h >>= 1) {
    for (int e = tid; e < h; e += kThreads) {
      sums[0][e] = sums[0][e] + sums[0][e + h];
      sums[1][e] = sums[1][e] + sums[1][e + h];
      sums[2][e] = sums[2][e] + sums[2][e + h];
    }
    if (h == 1 && keeper) copies_landed();         // the root's row
    __syncthreads();
  }
  const bool sx = sums[0][0] >= 0.0f;
  const bool sy = sums[1][0] >= 0.0f;
  const bool sz = sums[2][0] >= 0.0f;
  ClusterVote vote;
  vote.init(&board, tid == 0, 1 + kCtrlWarps);
  // every block of the cluster runs, with its mbarriers set, before any
  // stores into its shared memory
  cluster.sync();
  // lane r of a ray warp sends the warp's word to block r
  const int my_word = rank * kRayWarps + warp;
  const bool sender = is_ray && lane < kCluster;
  if (sender) vote.aim(&board, my_word, lane);
  // Every ray warp's `word` to every block of the cluster, and back the OR
  // and the AND of the packet's 32 words.  It is also the block's barrier
  // of the visit: the rows the control warps fetched have landed and their
  // pushes are visible when it returns.
  auto exchange = [&](unsigned word, unsigned& any, unsigned& all) {
    if (sender) vote.send(word);
    if (ctrl) {
      copies_landed();
      __syncwarp();
      if (lane == 0) vote.arrive();
    }
    vote.collect(&board, tid == 0, any, all);
  };

  int steps = 0;
  int cur = 0, ptr = 1;                 // at the root; stack[0] = sentinel
  int rs = 0;                           // the ring slot that holds cur's row
  int bank = 1;                         // the bank this visit fetches into

  // At the top of every visit row[rs] holds cur's row and every thread of
  // the block sees it; a visit has one meeting point, after its tests: the
  // exchange where the packet votes, the block's barrier elsewhere.
  while (cur != kSentinel) {
    if (++steps > max_steps) {
      if (leader) atomicAdd(error + 1, 1);
      break;
    }
    const float* r = row[rs];
    float* next_rows = row[bank * kBank];

    if (cur >= 0) {
      const float axis = r[7 * kTW];
      const bool fwd = axis == 0.0f ? sx : (axis == 1.0f ? sy : sz);
      if (ctrl) {
        // every row the next visit can need, fetched under the box tests:
        // each valid child's (child c -> slot c) and the stack top's
        __syncwarp();                   // this warp's pushes of the last visit
        // lane c holds child c's link, lane kTW the stack top
        int link = kSentinel;
        if (lane < kTW) {
          const float lf = r[6 * kTW + lane];
          if (lf > -1.0e8f) link = static_cast<int>(lf);
        } else if (lane == kTW && keeper) {
          link = stack[ptr - 1];
        }
        // (each lane works out its own row's address, so that the copies
        // below are a shuffle and a predicated instruction each, no branch)
        const unsigned valid = __ballot_sync(kFull, link != kSentinel);
        const unsigned long long mine =
            reinterpret_cast<unsigned long long>(row_of(link));
#pragma unroll
        for (int k = 0; k <= kTW / kCtrlWarps; ++k) {
          const int c = cw + k * kCtrlWarps;       // past kTW: no valid bit
          fetch(reinterpret_cast<const float*>(__shfl_sync(kFull, mine, c)),
                next_rows + c * kRow, (valid >> c) & 1u);
        }
      }
      // ---- node: this ray's box tests -> one 8-bit mask, the warp's OR to
      // every block of the cluster -----------------------------------------
      unsigned want = 0, all;
      if (is_ray) want = __reduce_or_sync(kFull, box_tests<kTW>(q, planes, r));
      exchange(want, want, all);
      want &= kDoneBit - 1u;

      const int k = __popc(want);
      if (k > 0) {
        // pushes in the order fwd ? 7..0 : 0..7; the last one is the next
        // node, not a live entry
        const int last = fwd ? __ffs(want) - 1 : 31 - __clz(want);
        if (keeper && ((want >> lane) & 1u)) {
          const unsigned before = fwd ? want & ~((2u << lane) - 1u)
                                      : want & ((1u << lane) - 1u);
          const int pos = ptr + __popc(before);
          if (pos < stack_depth)
            stack[pos] = static_cast<int>(r[6 * kTW + lane]);
        }
        cur = static_cast<int>(r[6 * kTW + last]);
        rs = bank * kBank + last;
        ptr += k - 1;
        if (ptr > stack_depth) {
          if (leader) atomicAdd(error, 1);
          break;
        }
      } else {
        cur = stack[--ptr];
        rs = bank * kBank + kTW;
      }
    } else {
      // ---- leaf: Moller-Trumbore over its triangles ----------------------
      if (keeper) {
        __syncwarp();                   // this warp's pushes of the last visit
        const int top = stack[ptr - 1]; // the next row, unless any-hit ends
        fetch(row_of(top), next_rows + kTW * kRow, top != kSentinel);
      }
      if (is_ray) leaf_tests(q, r, leaf_size, (-cur - 1) * leaf_size, lane);
      if (ANY_HIT) {
        // the walk ends once every lane of the packet has a hit or is dead
        unsigned done = 0, any, all;
        if (is_ray)
          done = __all_sync(kFull, (q.bs >= 0) | (q.bt <= 0.0f)) ? kDoneBit
                                                                : 0u;
        exchange(done, any, all);
        if (all & kDoneBit) break;
      } else {
        if (keeper) copies_landed();
        __syncthreads();
      }
      cur = stack[--ptr];
      rs = bank * kBank + kTW;
    }
    bank = bank == 2 ? 0 : bank + 1;
  }

  if (real) {
    hits.t[i] = q.bt;
    hits.slot[i] = q.bs;
    hits.u[i] = q.bu;
    hits.v[i] = q.bv;
    hits.visits[i] = steps;
  }
  // no block leaves while another may still store into its shared memory
  cluster.sync();
}

// the launch for n rays: whole packets, a cluster a packet
inline void geometry(int n, int* blocks, int* threads) {
  *blocks = (n + kPacket - 1) / kPacket * kCluster;
  *threads = kThreads;
}

int launch(const Args& a, bool any_hit) {
  int blocks, threads;
  geometry(a.n, &blocks, &threads);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(a.stack_depth) * sizeof(int);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a launch that CUDA refuses (no room for the cluster) is an error
  const cudaError_t e =
      any_hit ? cudaLaunchKernelEx(&cfg, walk1_kernel<true>, a.nodes,
                                   a.leaves, a.rays, a.n, a.leaf_size,
                                   a.stack_depth, a.max_steps, a.hits, a.error)
              : cudaLaunchKernelEx(&cfg, walk1_kernel<false>, a.nodes,
                                   a.leaves, a.rays, a.n, a.leaf_size,
                                   a.stack_depth, a.max_steps, a.hits,
                                   a.error);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry point launches on `stream` (asynchronously) and returns the
// launch's error: 0 on success.  error: the int32 pair of ops/traverse.py.

// v1: 1024-ray packets, 8-wide tables, no lane counts; a packet a cluster of
// kCluster blocks.
int fspt_walk1(const float* nodes, const float* leaves, int node_rows,
               int leaf_rows, const float* ox, const float* oy,
               const float* oz, const float* dx, const float* dy,
               const float* dz, const float* tmax, int n, int leaf_size,
               int stack_depth, int tree_width, int any_hit, int lane_counts,
               float* t, int* slot, float* u, float* v, int* visits,
               int* error, void* stream) {
  if (bad_args(n, leaf_size, stack_depth) || tree_width != kTW || lane_counts)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(make_args(nodes, leaves, node_rows, leaf_rows, ox, oy, oz, dx,
                          dy, dz, tmax, n, leaf_size, stack_depth, t, slot, u,
                          v, visits, error, stream),
                any_hit);
}

// The grid and the block of fspt_walk1's launch for n rays, launching
// nothing: what ops/traverse.py `packet_geometry` is held to.
int fspt_walk1_geometry(int n, int* blocks, int* threads) {
  geometry(n, blocks, threads);
  return 0;
}

const char* fspt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
