// v5 mixed multi-pop BVH traversal: a program of 8 walks of 128 rays as a
// thread block cluster of 8 blocks, a walk a 128-thread block.
//
// Replaces the TPU kernel scripts/traverse5_proto.py `_walk5_kernel`
// (launched by `packet_traverse5`), a round-5 prototype measured NO-GO on the
// TPU.  That kernel is defined by its schedule, and the schedule sets
// `visits`: per program a burst vote (pure drain or mixed), `unroll` or
// `drain_unroll` substeps per burst, npop node units (cur plus pre-pops) and
// lpop drain units per mixed substep, drain selections taken from the queue
// at substep entry, node wants decided on the entry best t, pushes and LIFO
// leaf appends unit npop-1 down to 0, and only then the drain units'
// Moller-Trumbore.  A per-thread walk (traverse4.cu) cannot stand in.
//
// What it computes (contract of fspt_tpu_torch/scripts/traverse5_proto.py,
// whose `packet_traverse5_reference` is the plain PyTorch version; the two
// agree bit for bit):
//   * program g holds rays [g*1024, (g+1)*1024), walk w of it the 128 rays
//     from g*1024 + w*128; threads past n hold the JAX kernel's pad rays
//     (origin 1e9, direction (0,1,0), tmax 0), which enter the sign sums,
//     the walks and the votes but write nothing;
//   * walk w's majority signs are its 128 directions summed by pairwise
//     halving, s[i] += s[i+h] for h = 64 .. 1;
//   * a child is wanted by a walk iff some lane's slab test passes
//     ((tmax >= tmin) & (tmax > 0) & (tmin < entry bt)) and its link is
//     valid (> -1e8);
//   * a push past `stack_depth` bumps error[0] and ends the program; a
//     program that stops at the max_steps backstop (8 * (table rows + 64)
//     visits per walk) with work left bumps error[1]: the wrapper raises on
//     either after a synchronise.  The JAX kernel drops the write, or ends
//     with wrong hits, silently.  A leaf append cannot pass `qcap`: the
//     burst vote drains before a mixed burst could, given
//     qcap >= tree_width * unroll * npop, which the entry point requires
//     (below it every burst would drain an empty queue and the program would
//     never end).
// The ray tests are csrc/walk_common.cuh's (`box_tests` picks the near and
// far slab planes by the ray's sign, which equals the plain version's
// fminf/fmaxf on node rows, where lo <= hi; `leaf_tests` is the plain
// version's Moller-Trumbore in its order, two reciprocals side by side, and
// leaves out a leaf's trailing padding slots, which can never be hit).
// Built with --fmad=false, like every traversal kernel.
//
// What bounds it on an H100, and what the design does about it.  The floor
// is float operations (every lane tests every row its walk visits), but the
// time is a chain: a substep's rows are known only once the last substep's
// pushes are.  The first design ran a program as one 1,024-thread block
// whose 8 walks stepped together, three block barriers a substep over 1,024
// threads, a walk that had finished waiting at every barrier of the longest
// one; the micro's first design priced that shape at ~5,350 ns a substep
// against ~750 for a walk on SMs of its own (PR 3-5,
// PERF_FINDINGS_ARCHIVE.md).  But the JAX
// semantics tie the 8 walks together only at burst boundaries (the vote, and
// the loop's end); inside a burst a walk's substeps touch its own state
// alone.  So here:
//   * a walk is a 128-thread block, and its substeps meet only at its own
//     barriers: one after the rows land, one after the votes of the node
//     units (none in a drain substep; one more for any-hit);
//   * warp 0 keeps the walk's state (cur, ptr, qlen, visits, the stack and
//     the LIFO queue, all its lanes alike), picks the next substep's units,
//     and fetches their rows as 16-byte asynchronous copies into the next of
//     two banks of shared rows while the drain units' tests of this substep
//     run; its pushes and appends are a ballot and a popc prefix over the
//     node units' children (32 / tree_width units a pass), its pre-pops and
//     drain selections a shared load a lane, all in the plain version's
//     order;
//   * at a burst boundary every block stores one word (near-full queue,
//     alive, queued leaves, work below the backstop, abort) into every block
//     of the cluster (walk_common.cuh `ClusterVoteOf`: asynchronous stores
//     counted on the receiver's mbarrier) and all compute the same drain and
//     keep decisions from the 8 words: the only traffic between walks;
//   * a parked walk with an empty queue is done for good (the plain
//     version's substeps leave it as it is), so its block leaves the burst at
//     the first substep with nothing to do, and joins every vote until its
//     cluster stops.
// On an NVIDIA H100 80GB HBM3 at 700 W, on the captured bounce-0 launch of
// the studies (342 programs; PR 6, PERF_FINDINGS_ARCHIVE.md): 2.27 -> 1.10
// ms against the first design, ~10% of the bound.  64 registers hold the
// card to 8 blocks an SM and 124 clusters at once; a substep of the median
// program costs ~8,700 cycles, ~5,700 when the block has its SM to itself,
// so the SM's issue rate shared by 8 walks sets it, and a walk waits at the
// burst votes for its program's longest walk (1.58x the mean) as long as it
// works.  Fewer blocks an SM, more (with spills), skipping invalid children
// one by one, the two drain units' tests side by side and the pushes a pass
// a unit all measured equal or slower (PR 6).

#include <cooperative_groups.h>

#include "walk_common.cuh"   // the ray tests, copy16, the cluster vote

namespace cg = cooperative_groups;

namespace {

constexpr int kWalks = 8;          // blocks a cluster: WALKS in traverse5_proto
constexpr int kLanes = 128;        // threads a block: LANES
constexpr int kProgram = kWalks * kLanes;
constexpr int kMaxUnits = 8;       // npop + lpop: MAX_UNITS
constexpr int kStack5Cap = 1024;   // stack_depth: STACK_CAP
constexpr int kQueueCap = 1024;    // qcap: QCAP_CAP
constexpr unsigned kFull = 0xffffffffu;

// the burst vote's word, one a walk
constexpr unsigned kNearFull = 1u;     // qlen + tree_width*unroll*npop > qcap
constexpr unsigned kAlive = 2u;        // a node to visit
constexpr unsigned kQueued = 4u;       // leaves queued
constexpr unsigned kKeep = 8u;         // work left, visits below max_steps
constexpr unsigned kAbort = 16u;       // a push overflowed the stack

struct Params {
  int n, leaf_size, stack_depth, qcap, unroll, drain_unroll, npop, lpop,
      max_steps;
};

// What a substep reads, written by warp 0 before its first barrier: which
// units have a row (node unit u in row slot u of the bank, drain unit u in
// slot first_drain + u) and the drain units' leaf ordinals.
struct Sub {
  unsigned nodes, has;
  int ord[kMaxUnits];
};

// warp 0's own record of the substep it planned
struct Plan {
  int ptr;          // the pointer after the pre-pops
  int taken;        // leaves the drain units take from the queue
  bool parked;
  unsigned nodes;
};

template <int TW, bool ANY_HIT>
__global__ void __launch_bounds__(kLanes, 8)
walk5_kernel(const float* __restrict__ nodes,
             const float* __restrict__ leaves, Rays rays, Params p, Hits hits,
             int* __restrict__ error) {
  __shared__ __align__(16) float panel[2][kMaxUnits][kRow];
  __shared__ float sums[3][kLanes];
  __shared__ Sub sub[2];
  __shared__ unsigned votes[kMaxUnits][kLanes / 32];
  __shared__ unsigned done[kLanes / 32];
  __shared__ int walk_visits;
  __shared__ VoteBoardOf<kWalks> board;
  extern __shared__ int rows5[];     // the stack [stack_depth], the queue [qcap]
  int* stack = rows5;
  int* queue = rows5 + p.stack_depth;
  const int D = p.stack_depth, Q = p.qcap;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());   // the walk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool keeper = warp == 0;     // keeps the walk's state
  const int i = (blockIdx.x / kWalks) * kProgram + rank * kLanes + tid;
  const bool real = i < p.n;
  const bool leader = rank == 0 && tid == 0;

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
  const Planes planes = planes_of<TW>(q);

  // ---- the walk's majority signs, pairwise halving; zeroed stack and queue
  sums[0][tid] = q.dx;
  sums[1][tid] = q.dy;
  sums[2][tid] = q.dz;
  for (int k = tid; k < D + Q; k += kLanes) rows5[k] = 0;
  __syncthreads();
  if (tid == 0) stack[0] = kSentinel;
#pragma unroll
  for (int h = kLanes / 2; h > 0; h >>= 1) {
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

  ClusterVoteOf<kWalks> vote;
  vote.init(&board, tid == 0, 1);
  // every block of the cluster runs, its mbarriers set, before any stores
  // into its shared memory
  cluster.sync();
  // lane r of warp 0 sends the walk's word to block r
  if (keeper && lane < kWalks) vote.aim(&board, rank, lane);

  // ---- warp 0: the walk's state, alike in all its lanes -------------------
  int cur = 0, ptr = 1, qlen = 0, vis = 0;   // at the root; stack[0] sentinel
  bool abort = false;
  const int units = p.npop + p.lpop;

  // The units of the substep that starts from the current state, lane u
  // unit u, their rows copied into bank b (the copies land before the
  // substep's first barrier).
  auto plan = [&](bool drain, int b) {
    Plan pl;
    pl.parked = cur == kSentinel;
    // node units: cur, then pre-pop u takes stack[ptr - u] while ptr - u >= 1
    // (no live entry above the bottom is the sentinel)
    int unit = kSentinel;
    if (!drain && lane < p.npop) {
      if (lane == 0)
        unit = cur;
      else if (!pl.parked && ptr - lane >= 1)
        unit = stack[ptr - lane];
    }
    pl.nodes = __ballot_sync(kFull, unit != kSentinel);
    pl.ptr = ptr - __popc(pl.nodes >> 1);
    // drain units: the queue's top entries at substep entry
    const int k = drain ? units : p.lpop, first = drain ? 0 : p.npop;
    pl.taken = min(qlen, k);
    int ord = 0;
    if (lane < pl.taken) {
      ord = max(-queue[qlen - 1 - lane] - 1, 0);
      sub[b].ord[lane] = ord;
    }
    // every row: 16 bytes a lane
    for (int u = 0; u < p.npop; ++u)
      if ((pl.nodes >> u) & 1u)
        copy16(&panel[b][u][4 * lane],
               nodes + static_cast<size_t>(__shfl_sync(kFull, unit, u)) *
                           kRow + 4 * lane, true);
    for (int u = 0; u < pl.taken; ++u)
      copy16(&panel[b][first + u][4 * lane],
             leaves + static_cast<size_t>(__shfl_sync(kFull, ord, u)) *
                          kRow + 4 * lane, true);
    if (lane == 0) {
      sub[b].nodes = pl.nodes;
      sub[b].has = (1u << pl.taken) - 1u;
    }
    return pl;
  };

  // Pushes and appends of the node units, unit npop-1 down to 0, children in
  // the sign order (lane (k, j): the k-th unit of that order, its j-th
  // child, 32 / TW units a pass); then the walk's next cur and ptr.  False
  // on an overflow.
  auto push = [&](const Plan& pl, int b) {
    int pp = pl.ptr, qq = qlen - pl.taken, top = kSentinel;
    bool pushed = false;
    const unsigned below = (1u << lane) - 1u;
    for (int k0 = 0; k0 < p.npop; k0 += 32 / TW) {
      const int u = p.npop - 1 - (k0 + lane / TW), j = lane % TW;
      int link = 0;
      bool on = false;
      if (u >= 0 && ((pl.nodes >> u) & 1u)) {
        const float* r = panel[b][u];
        const unsigned want = votes[u][0] | votes[u][1] | votes[u][2] |
                              votes[u][3];
        const float axis = r[7 * TW];
        const bool fwd = axis == 0.0f ? sx : (axis == 1.0f ? sy : sz);
        const int c = fwd ? TW - 1 - j : j;
        const float lf = r[6 * TW + c];
        on = ((want >> c) & 1u) && lf > -1.0e8f;
        if (on) link = static_cast<int>(lf);
      }
      const unsigned pm = __ballot_sync(kFull, on && link >= 0);
      const unsigned am = __ballot_sync(kFull, on && link < 0);
      if (pp + __popc(pm) > D || qq + __popc(am) > Q) return false;
      if ((pm >> lane) & 1u) stack[pp + __popc(pm & below)] = link;
      if ((am >> lane) & 1u) queue[qq + __popc(am & below)] = link;
      if (pm) {
        top = __shfl_sync(kFull, link, 31 - __clz(pm));
        pushed = true;
      }
      pp += __popc(pm);
      qq += __popc(am);
    }
    __syncwarp();                    // the pushes, for the lanes that read
    int nptr = pp - 1;
    int ncur = pushed ? top : stack[min(max(nptr, 0), D - 1)];
    if (pl.parked) ncur = kSentinel;
    if (pl.parked || ncur == kSentinel) nptr = 0;
    cur = ncur;
    ptr = nptr;
    qlen = qq;
    vis += __popc(pl.nodes) + pl.taken;
    return true;
  };

  // ---- bursts until no walk of the program has work below the backstop --
  const int push_bound = TW * p.unroll * p.npop;
  int bank = 0;                      // alike in every thread
  unsigned any, all;
  while (true) {
    // the burst vote: the only words between the walks
    if (keeper && lane < kWalks)
      vote.send((qlen + push_bound > Q ? kNearFull : 0u) |
                (cur != kSentinel ? kAlive : 0u) | (qlen > 0 ? kQueued : 0u) |
                ((cur != kSentinel || qlen > 0) && vis < p.max_steps ? kKeep
                                                                    : 0u) |
                (abort ? kAbort : 0u));
    vote.collect(&board, tid == 0, any, all);
    if ((any & kAbort) || !(any & kKeep)) break;
    const bool drain = (any & kNearFull) || (!(any & kAlive) && (any & kQueued));
    const int reps = drain ? p.drain_unroll : p.unroll;
    Plan pl;
    if (keeper) pl = plan(drain, bank);
    for (int r = 0; r < reps; ++r) {
      if (keeper) copies_landed();
      __syncthreads();               // the rows and sub[bank] are seen
      const unsigned node_units = sub[bank].nodes, has = sub[bank].has;
      if (!(node_units | has)) {     // parked, queue empty: done for good
        bank ^= 1;
        break;
      }
      const bool more = r + 1 < reps;
      const int first_drain = drain ? 0 : p.npop;
      Plan next;
      if (!drain) {
        // ---- each node unit's child wants, on the entry best t ----------
        for (int u = 0; u < p.npop; ++u) {
          if (!((node_units >> u) & 1u)) continue;
          const unsigned m = __reduce_or_sync(
              kFull, box_tests<TW>(q, planes, panel[bank][u]));
          if (lane == 0) votes[u][warp] = m;
        }
        __syncthreads();             // the votes
      }
      if (keeper) {
        if (drain) {
          qlen -= pl.taken;
          vis += pl.taken;
        } else if (!push(pl, bank)) {
          // the program ends at the next vote; this walk does nothing more
          if (lane == 0) atomicAdd(error, 1);
          abort = true;
          cur = kSentinel, ptr = 0, qlen = 0;
        }
        if (!ANY_HIT && more) next = plan(drain, bank ^ 1);
      }
      // ---- then the drain units' Moller-Trumbore, which updates best t --
      const int taken = __popc(has);
      for (int u = 0; u < taken; ++u)
        leaf_tests(q, panel[bank][first_drain + u], p.leaf_size,
                   sub[bank].ord[u] * p.leaf_size, lane);
      if (ANY_HIT) {
        // the walk ends once all its lanes have a hit (or tmax <= 0)
        const bool d = __all_sync(kFull, (q.bs >= 0) | (q.bt <= 0.0f));
        if (lane == 0) done[warp] = d;
        __syncthreads();
        if (keeper) {
          if (done[0] & done[1] & done[2] & done[3])
            cur = kSentinel, ptr = 0, qlen = 0;
          if (more) next = plan(drain, bank ^ 1);
        }
      }
      if (keeper && more) pl = next;
      bank ^= 1;
    }
  }

  if (keeper && lane == 0) walk_visits = vis;
  __syncthreads();
  if (real) {
    hits.t[i] = q.bt;
    hits.slot[i] = q.bs;
    hits.u[i] = q.bu;
    hits.v[i] = q.bv;
    hits.visits[i] = walk_visits;
  }
  if (leader && !(any & kAbort) && (any & (kAlive | kQueued)))
    atomicAdd(error + 1, 1);
  // no block leaves while another may still store into its shared memory
  cluster.sync();
}

// the launch for n rays: whole programs, a cluster a program
inline void geometry(int n, int* blocks, int* threads) {
  *blocks = (n + kProgram - 1) / kProgram * kWalks;
  *threads = kLanes;
}

cudaLaunchConfig_t cluster_config(int blocks, size_t smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kLanes);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kWalks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int TW, bool ANY>
int launch(const float* nodes, const float* leaves, const Rays& rays,
           const Params& p, const Hits& hits, int* error,
           cudaStream_t stream) {
  int blocks, threads;
  geometry(p.n, &blocks, &threads);
  cudaLaunchAttribute attr[1];
  // the stack [stack_depth] and the queue [qcap]
  const size_t smem = static_cast<size_t>(p.stack_depth + p.qcap) * sizeof(int);
  const cudaLaunchConfig_t cfg = cluster_config(blocks, smem, stream, attr);
  // a launch that CUDA refuses (no room for the cluster) is an error
  const cudaError_t e = cudaLaunchKernelEx(&cfg, walk5_kernel<TW, ANY>, nodes,
                                           leaves, rays, p, hits, error);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` (asynchronously) and returns the launch's error: 0 on
// success.  error: the int32 pair of ops/traverse.py ([0] stack overflows,
// [1] programs stopped by the backstop).
int fspt_walk5(const float* nodes, const float* leaves, int node_rows,
               int leaf_rows, const float* ox, const float* oy,
               const float* oz, const float* dx, const float* dy,
               const float* dz, const float* tmax, int n, int leaf_size,
               int stack_depth, int qcap, int unroll, int drain_unroll,
               int npop, int lpop, int tree_width, int any_hit, float* t,
               int* slot, float* u, float* v, int* visits, int* error,
               void* stream) {
  if (n < 0 || leaf_size < 1 || leaf_size * 9 > kRow || stack_depth < 1 ||
      stack_depth > kStack5Cap || qcap > kQueueCap || npop < 1 || lpop < 0 ||
      npop + lpop > kMaxUnits || unroll < 1 || drain_unroll < 1 ||
      (tree_width != 8 && tree_width != 16) ||
      qcap < tree_width * unroll * npop)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const Rays rays{ox, oy, oz, dx, dy, dz, tmax};
  const Params p{n,     leaf_size, stack_depth, qcap,
                 unroll, drain_unroll, npop, lpop,
                 8 * (node_rows + leaf_rows + 64)};
  const Hits hits{t, slot, u, v, visits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tree_width == 8)
    return any_hit ? launch<8, true>(nodes, leaves, rays, p, hits, error, s)
                   : launch<8, false>(nodes, leaves, rays, p, hits, error, s);
  return any_hit ? launch<16, true>(nodes, leaves, rays, p, hits, error, s)
                 : launch<16, false>(nodes, leaves, rays, p, hits, error, s);
}

// The grid and the block of fspt_walk5's launch for n rays, launching
// nothing: what traverse5_proto.py `walk5_geometry` is held to.
int fspt_walk5_geometry(int n, int* blocks, int* threads) {
  geometry(n, blocks, threads);
  return 0;
}

const char* fspt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
