// The FIRST design of the v5 kernel (a program as one 1,024-thread block of
// 8 lockstep walks, three block barriers a mixed substep, a leader thread's
// pushes), kept buildable so that a measurement can time the current
// csrc/walk5.cu against it in one call on one card (ops/_versus.py
// `walk5_launcher`; nothing else loads it).  Same C interface, same results
// bit for bit.
//
// v5 mixed multi-pop BVH traversal: one 1024-thread block per program of
// 8 lockstep walks of 128 rays, one ray per thread.
//
// Replaces the TPU kernel scripts/traverse5_proto.py `_walk5_kernel`
// (launched by `packet_traverse5`), a round-5 prototype measured NO-GO on the
// TPU.  That kernel is defined by its schedule, and the schedule sets
// `visits`: per program a burst vote (pure drain or mixed), `unroll` or
// `drain_unroll` substeps per burst, npop node units (cur plus pre-pops) and
// lpop drain units per mixed substep, drain selections taken from the
// queue at substep entry, node wants decided on the entry best t, pushes
// and LIFO leaf appends unit npop-1 down to 0, and only then the drain
// units' Moller-Trumbore.  A per-thread walk (traverse4.cu) cannot stand in,
// so this kernel keeps the TPU's walk structure: a walk is 4 warps, a
// program is a block, all 8 walks step together.
//
// What it computes (contract of fspt_tpu_torch/scripts/traverse5_proto.py,
// whose `packet_traverse5_reference` is the plain PyTorch version and
// follows this order and float arithmetic operation for operation, so the
// two agree bit for bit):
//   * block b holds rays [b*1024, (b+1)*1024); threads past n hold the JAX
//     kernel's pad rays (origin 1e9, direction (0,1,0), tmax 0), which enter
//     the sign sums and votes but write nothing;
//   * walk w's majority signs are its 128 directions summed by pairwise
//     halving, s[i] += s[i+h] for h = 64 .. 1;
//   * a child is wanted by a walk iff some lane's slab test passes
//     ((tmax >= tmin) & (tmax > 0) & (tmin < entry bt)) and its link is
//     valid (> -1e8): a warp __reduce_or_sync, then an OR over the walk's 4
//     warps in shared memory;
//   * one thread per walk makes the pushes and appends in the JAX order;
//     every thread reads the result from shared memory after a barrier, so
//     control flow stays uniform across the block;
//   * a push past `stack_depth` or an append past `qcap` bumps error[0] and
//     ends the program; a program that stops at the max_steps backstop
//     (8 * (table rows + 64) visits per walk) with work left bumps
//     error[1]: the wrapper raises on either after a synchronise.  The JAX
//     kernel drops the write, or ends with wrong hits, silently.
// Built with --fmad=false, like traverse4.cu and walk.cu.
//
// What bounds it on an H100: every substep is a chain of dependent steps
// separated by block barriers (3 per mixed substep, 2 per drain substep, one
// more for any-hit): fetch npop+lpop rows per walk from L2 (the ~9.4 MB
// bench tables stay resident in the 50 MB L2), vote, push on one thread,
// test.  A block is one program, so its time is its substep count times
// that latency chain, and the union tax of a 128-ray walk applies as in
// walk.cu.  The design issues all of a substep's row loads before its
// first barrier (npop+lpop independent 512-byte loads per walk, as the TPU
// kernel issued its fetches before any compute) and keeps the rows in
// shared memory.  Making it fast (cp.async prefetch of the next units,
// fewer barriers) is later work.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kRow = 128;        // floats per packed row (ops/packing.py)
constexpr int kWalks = 8;
constexpr int kLanes = 128;
constexpr int kBlock = kWalks * kLanes;
constexpr int kMaxUnits = 8;     // npop + lpop; MAX_UNITS in traverse5_proto
constexpr int kStackCap = 1024;  // STACK_CAP in traverse5_proto.py
constexpr int kQueueCap = 1024;  // QCAP_CAP in traverse5_proto.py
constexpr int kSentinel = INT_MIN;

__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d;
  return 1.0f / s;
}

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmax;
};

struct Hits {
  float* t;
  int* slot;
  float* u;
  float* v;
  int* visits;
};

struct Params {
  int n, node_rows, leaf_size, stack_depth, qcap, unroll, drain_unroll, npop,
      lpop, max_steps;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

struct Best {
  float t;
  int slot;
  float u, v;
};

// Moller-Trumbore of this thread's ray against the leaf_size triangles of
// row r (leaf ordinal `leaf`), strict t < best t.
__device__ __forceinline__ void leaf_mt(const float* r, int leaf,
                                        int leaf_size, const Ray& a,
                                        Best& b) {
  const int slot_base = leaf * leaf_size;
  for (int j = 0; j < leaf_size; ++j) {
    const float* c = r + 9 * j;
    const float px = a.dy * c[8] - a.dz * c[7];
    const float py = a.dz * c[6] - a.dx * c[8];
    const float pz = a.dx * c[7] - a.dy * c[6];
    const float det = c[3] * px + c[4] * py + c[5] * pz;
    const float inv = 1.0f / (fabsf(det) < 1e-6f ? 1.0f : det);
    const float tx = a.ox - c[0];
    const float ty = a.oy - c[1];
    const float tz = a.oz - c[2];
    const float uu = (tx * px + ty * py + tz * pz) * inv;
    const float qx = ty * c[5] - tz * c[4];
    const float qy = tz * c[3] - tx * c[5];
    const float qz = tx * c[4] - ty * c[3];
    const float ww = (a.dx * qx + a.dy * qy + a.dz * qz) * inv;
    const float tt = (c[6] * qx + c[7] * qy + c[8] * qz) * inv;
    const bool ok = (fabsf(det) >= 1e-6f) & (uu >= 0.0f) & (uu <= 1.0f) &
                    (ww >= 0.0f) & (uu + ww <= 1.0f) & (tt > 1e-6f) &
                    (tt < b.t);
    if (ok) {
      b.t = tt;
      b.slot = slot_base + j;
      b.u = uu;
      b.v = ww;
    }
  }
}

// Shared walk state.  Every field is written by its walk's leader thread
// and read by all after a barrier.
struct WalkState {
  int cur[kWalks], ptr[kWalks], qlen[kWalks], vis[kWalks];
  unsigned votes[kMaxUnits][kWalks][4];
  unsigned done[kWalks][4];
  int abort;
};

template <int TW, bool ANY_HIT>
__global__ void __launch_bounds__(kBlock)
walk5_kernel(const float* __restrict__ nodes,
             const float* __restrict__ leaves, Rays rays, Params p,
             Hits hits, int* __restrict__ error) {
  extern __shared__ float smem[];
  __shared__ WalkState ws;
  const int units = p.npop + p.lpop;
  const int panel_floats = max(units * kWalks * kRow, 3 * kBlock);
  float* panel = smem;                          // also the sign sums at entry
  int* stack = reinterpret_cast<int*>(smem + panel_floats);  // [8][depth]
  int* queue = stack + kWalks * p.stack_depth;                // [8][qcap]

  const int tid = threadIdx.x;
  const int w = tid >> 7, lane = tid & (kLanes - 1);
  const int wq = (tid >> 5) & 3;                // warp within the walk
  const int i = blockIdx.x * kBlock + tid;
  const bool real = i < p.n;
  Ray a;
  a.ox = real ? rays.ox[i] : 1.0e9f;
  a.oy = real ? rays.oy[i] : 1.0e9f;
  a.oz = real ? rays.oz[i] : 1.0e9f;
  a.dx = real ? rays.dx[i] : 0.0f;
  a.dy = real ? rays.dy[i] : 1.0f;
  a.dz = real ? rays.dz[i] : 0.0f;
  a.ix = safe_inv(a.dx);
  a.iy = safe_inv(a.dy);
  a.iz = safe_inv(a.dz);
  Best b{real ? rays.tmax[i] : 0.0f, -1, 0.0f, 0.0f};

  // ---- per-walk majority signs, pairwise halving; zeroed stacks/queues --
  panel[tid] = a.dx;
  panel[kBlock + tid] = a.dy;
  panel[2 * kBlock + tid] = a.dz;
  for (int k = tid; k < kWalks * p.stack_depth; k += kBlock) stack[k] = 0;
  for (int k = tid; k < kWalks * p.qcap; k += kBlock) queue[k] = 0;
  __syncthreads();
  if (tid < kWalks) {
    stack[tid * p.stack_depth] = kSentinel;
    ws.cur[tid] = 0;                           // the root
    ws.ptr[tid] = 1;
    ws.qlen[tid] = 0;
    ws.vis[tid] = 0;
  }
  if (tid == 0) ws.abort = 0;
#pragma unroll
  for (int h = kLanes / 2; h > 0; h >>= 1) {
    if (lane < h) {
      panel[tid] = panel[tid] + panel[tid + h];
      panel[kBlock + tid] = panel[kBlock + tid] + panel[kBlock + tid + h];
      panel[2 * kBlock + tid] =
          panel[2 * kBlock + tid] + panel[2 * kBlock + tid + h];
    }
    __syncthreads();
  }
  const bool sx = panel[w * kLanes] >= 0.0f;
  const bool sy = panel[kBlock + w * kLanes] >= 0.0f;
  const bool sz = panel[2 * kBlock + w * kLanes] >= 0.0f;
  __syncthreads();                              // sums read: panel is free

  int* my_stack = stack + w * p.stack_depth;
  int* my_queue = queue + w * p.qcap;
  const int D = p.stack_depth, Q = p.qcap;

  // drain selections of the walk's entry queue: k units, rows fetched into
  // panel rows (off + u) * 8 + w
  int has[kMaxUnits], ords[kMaxUnits];
  auto drain_select_fetch = [&](int qlen, int k, int off) {
    for (int u = 0; u < k; ++u) {
      has[u] = qlen > u;
      const int qtop = min(max(qlen - 1 - u, 0), Q - 1);
      ords[u] = has[u] ? max(-my_queue[qtop] - 1, 0) : 0;
      const float* src = has[u] ? leaves + static_cast<size_t>(ords[u]) * kRow
                                : nodes;
      panel[((off + u) * kWalks + w) * kRow + lane] = __ldg(src + lane);
    }
  };
  auto drain_mt = [&](int k, int off) {
    for (int u = 0; u < k; ++u)
      if (has[u])
        leaf_mt(panel + ((off + u) * kWalks + w) * kRow, ords[u],
                p.leaf_size, a, b);
  };
  // any-hit: a walk whose lanes all have a hit (or tmax <= 0) ends; then
  // the barrier that closes the substep
  auto finish = [&]() {
    if (ANY_HIT) {
      const unsigned d = __all_sync(0xffffffffu, (b.slot >= 0) | (b.t <= 0.0f));
      if ((tid & 31) == 0) ws.done[w][wq] = d;
      __syncthreads();
      if (lane == 0 &&
          (ws.done[w][0] & ws.done[w][1] & ws.done[w][2] & ws.done[w][3])) {
        ws.cur[w] = kSentinel;
        ws.ptr[w] = 0;
        ws.qlen[w] = 0;
      }
    }
    __syncthreads();
  };

  auto mixed_substep = [&]() {
    const int cur = ws.cur[w], ptr = ws.ptr[w], qlen = ws.qlen[w];
    const bool parked = cur == kSentinel;
    drain_select_fetch(qlen, p.lpop, p.npop);
    const int taken = min(qlen, p.lpop);
    int unit[kMaxUnits];
    unit[0] = cur;
    int p0 = ptr;
    for (int u = 1; u < p.npop; ++u) {
      const int pop_at = min(max(p0 - 1, 0), D - 1);
      const int popped =
          (p0 >= 2 && !parked) ? my_stack[pop_at] : kSentinel;
      if (popped != kSentinel) --p0;
      unit[u] = popped;
    }
    for (int u = 0; u < p.npop; ++u) {
      const int row = unit[u] != kSentinel ? max(unit[u], 0) : 0;
      panel[(u * kWalks + w) * kRow + lane] =
          __ldg(nodes + static_cast<size_t>(row) * kRow + lane);
    }
    __syncthreads();

    // ---- each node unit's child wants, on the entry best t ----------------
    for (int u = 0; u < p.npop; ++u) {
      const float* r = panel + (u * kWalks + w) * kRow;
      unsigned mine = 0;
#pragma unroll
      for (int c = 0; c < TW; ++c) {
        const float t1x = (r[c] - a.ox) * a.ix;
        const float t2x = (r[3 * TW + c] - a.ox) * a.ix;
        const float t1y = (r[TW + c] - a.oy) * a.iy;
        const float t2y = (r[4 * TW + c] - a.oy) * a.iy;
        const float t1z = (r[2 * TW + c] - a.oz) * a.iz;
        const float t2z = (r[5 * TW + c] - a.oz) * a.iz;
        const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                                 fminf(t1z, t2z));
        const float tmx = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                                fmaxf(t1z, t2z));
        const bool box = (tmx >= tmin) & (tmx > 0.0f) & (tmin < b.t);
        mine |= static_cast<unsigned>(box) << c;
      }
      const unsigned wv = __reduce_or_sync(0xffffffffu, mine);
      if ((tid & 31) == 0) ws.votes[u][w][wq] = wv;
    }
    __syncthreads();

    // ---- the walk's leader: pushes and appends, unit npop-1 down to 0 ----
    if (lane == 0) {
      int pp = p0, q = qlen - taken, top = kSentinel, nodes_seen = 0;
      bool pushed = false, bad = false;
      for (int u = p.npop - 1; u >= 0; --u) {
        if (unit[u] == kSentinel) continue;
        ++nodes_seen;
        const float* r = panel + (u * kWalks + w) * kRow;
        const unsigned want = ws.votes[u][w][0] | ws.votes[u][w][1] |
                              ws.votes[u][w][2] | ws.votes[u][w][3];
        const float axis = r[7 * TW];
        const bool fwd = axis == 0.0f ? sx : (axis == 1.0f ? sy : sz);
        for (int j = 0; j < TW; ++j) {
          const int c = fwd ? TW - 1 - j : j;
          const float lf = r[6 * TW + c];
          if (!((want >> c) & 1u) || !(lf > -1.0e8f)) continue;
          const int link = static_cast<int>(lf);
          if (link < 0) {
            if (q >= Q) { bad = true; break; }
            my_queue[q++] = link;
          } else {
            if (pp >= D) { bad = true; break; }
            my_stack[pp++] = link;
            top = link;
            pushed = true;
          }
        }
        if (bad) break;
      }
      if (bad) {
        atomicAdd(error, 1);
        ws.abort = 1;
      }
      int nptr = pp - 1;
      int ncur = pushed ? top : my_stack[min(max(nptr, 0), D - 1)];
      if (parked) ncur = kSentinel;
      if (parked || ncur == kSentinel) nptr = 0;
      ws.cur[w] = ncur;
      ws.ptr[w] = nptr;
      ws.qlen[w] = q;
      ws.vis[w] += nodes_seen + taken;
    }
    // ---- then the drain units' MT, which updates best t --------------------
    drain_mt(p.lpop, p.npop);
    finish();
  };

  auto drain_substep = [&]() {
    const int qlen = ws.qlen[w];
    const int k = units;
    drain_select_fetch(qlen, k, 0);
    __syncthreads();
    drain_mt(k, 0);
    if (lane == 0) {
      const int taken = min(qlen, k);
      ws.qlen[w] = qlen - taken;
      ws.vis[w] += taken;
    }
    finish();
  };

  // ---- bursts until no walk has work below the backstop ------------------
  const int push_bound = TW * p.unroll * p.npop;
  while (true) {
    int total_q = 0, max_q = 0, alive = 0;
    for (int s = 0; s < kWalks; ++s) {
      total_q += ws.qlen[s];
      max_q = max(max_q, ws.qlen[s]);
      alive += ws.cur[s] != kSentinel;
    }
    const bool drain = (max_q + push_bound > Q) || (alive == 0 && total_q > 0);
    if (drain) {
      for (int r = 0; r < p.drain_unroll && !ws.abort; ++r) drain_substep();
    } else {
      for (int r = 0; r < p.unroll && !ws.abort; ++r) mixed_substep();
    }
    if (ws.abort) break;
    bool keep = false;
    for (int s = 0; s < kWalks; ++s)
      keep |= (ws.cur[s] != kSentinel || ws.qlen[s] > 0) &&
              ws.vis[s] < p.max_steps;
    if (!keep) break;
  }
  if (tid == 0 && !ws.abort) {
    bool left = false;
    for (int s = 0; s < kWalks; ++s)
      left |= ws.cur[s] != kSentinel || ws.qlen[s] > 0;
    if (left) atomicAdd(error + 1, 1);
  }

  if (real) {
    hits.t[i] = b.t;
    hits.slot[i] = b.slot;
    hits.u[i] = b.u;
    hits.v[i] = b.v;
    hits.visits[i] = ws.vis[w];
  }
}

template <int TW, bool ANY>
int launch_one(const float* nodes, const float* leaves, const Rays& rays,
               const Params& p, const Hits& hits, int* error,
               cudaStream_t stream) {
  const int units = p.npop + p.lpop;
  const size_t panel = static_cast<size_t>(
      units * kWalks * kRow > 3 * kBlock ? units * kWalks * kRow : 3 * kBlock);
  const size_t smem = panel * sizeof(float) +
                      static_cast<size_t>(kWalks) *
                          (p.stack_depth + p.qcap) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      walk5_kernel<TW, ANY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.n + kBlock - 1) / kBlock);
  walk5_kernel<TW, ANY><<<grid, kBlock, smem, stream>>>(nodes, leaves, rays,
                                                         p, hits, error);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` (asynchronously) and returns cudaGetLastError() of
// the launch: 0 on success.  error: the int32 pair of ops/traverse.py ([0]
// stack or queue overflows, [1] programs stopped by the backstop).
int fspt_walk5(const float* nodes, const float* leaves, int node_rows,
               int leaf_rows, const float* ox, const float* oy,
               const float* oz, const float* dx, const float* dy,
               const float* dz, const float* tmax, int n, int leaf_size,
               int stack_depth, int qcap, int unroll, int drain_unroll,
               int npop, int lpop, int tree_width, int any_hit, float* t,
               int* slot, float* u, float* v, int* visits, int* error,
               void* stream) {
  if (n < 0 || leaf_size < 1 || leaf_size * 9 > kRow || stack_depth < 1 ||
      stack_depth > kStackCap || qcap < 1 || qcap > kQueueCap || npop < 1 ||
      lpop < 0 || npop + lpop > kMaxUnits || unroll < 1 || drain_unroll < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const Rays rays{ox, oy, oz, dx, dy, dz, tmax};
  const Params p{n, node_rows, leaf_size, stack_depth, qcap, unroll,
                 drain_unroll, npop, lpop, 8 * (node_rows + leaf_rows + 64)};
  const Hits hits{t, slot, u, v, visits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tree_width == 8)
    return any_hit ? launch_one<8, true>(nodes, leaves, rays, p, hits, error, s)
                   : launch_one<8, false>(nodes, leaves, rays, p, hits, error,
                                          s);
  if (tree_width == 16)
    return any_hit
               ? launch_one<16, true>(nodes, leaves, rays, p, hits, error, s)
               : launch_one<16, false>(nodes, leaves, rays, p, hits, error, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fspt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
