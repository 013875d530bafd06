// MoE routing's queue positions and slot tables in one pass, for Hopper
// (sm_90a), with a plain C interface.
//
// Replaces no Pallas kernel: it fuses the eager integer chain of
// repro_torch/models/moe.py's route(), the counterpart of lines 75-80 of
// repro/models/moe.py (one_hot of every choice, an outer-dimension int64
// cumsum, gather, where, repeat_interleave, full and index_put), and the
// one_hot sum that fed the aux loss's f_e. Its plain PyTorch version is
// repro_torch/kernels/moe_route.py::moe_route_plain.
//
// For each routing group of T tokens with k expert ids each (int64, read
// in place through the token stride ld, e.g. the sort's indices[:, :k] of a
// (T, E) tensor), in (token, choice) order:
//   pos(c)     = before[e] + the choices of expert e = id(c) ahead of c
//   slot(c)    = e * cap + pos(c), or E * cap (the overflow slot) when
//                pos(c) >= cap: the choice is dropped
//   tfs[s]     = the token of slot s, T for a slot no choice of this group
//                holds (and for the overflow slot E * cap)
//   counts[e]  = the group's choices of expert e, before capacity
// before (E,) carries the choices of each expert on the fsdp group's lower
// ranks (NULL: none). An id outside [0, E) is not counted and goes to the
// overflow slot (the plain version's one_hot refuses it).
//
// Bound: bytes and one launch. At the MoE cells' routing (T = 4,096, k = 6,
// E = 64, cap = 480) the tables are 516,356 B: the ids in and the slots out
// at 8 B a choice, 30,721 slot owners at 4 B, 64 counts: 0.15 us at
// 3.35 TB/s, far below a launch. The eager chain moved 12.6 MB of one-hots
// and as much of scan, and its outer-dimension scan gave one thread to each
// of the E columns, each walking T k dependent strided loads (7.4 ms).
//
// Design: one block of 1,024 threads ranks a contiguous chunk of up to
// kChunk choices of one group; the grid is (blocks a group, groups), so the
// route blocks of a batch of groups go in one launch. Each warp takes a
// contiguous run of its block's chunk, a multiple of 32 choices.
//   Pass 1: each warp counts its run per expert into its own row of shared
//   memory with shared-memory atomicAdd: integer counts, the same in any
//   order. A lane walks (token, choice) by increments, without a division.
//   Scan: thread e walks the 32 warps' counts of expert e, turning each into
//   the warp's first position: before[e], plus the group's earlier blocks'
//   counts (a multi-block group), plus the earlier warps' counts.
//   Pass 2: each warp walks its run again; a lane's position is its warp's
//   running position for its expert plus __popc(peers below the lane), and
//   the peers' lowest lane then moves the running position on by their
//   number: a stable counting rank in exact integers, whatever order the
//   warps run in. The kept choices write their slot's owner; every other
//   slot of the table is written T by the blocks in parallel, from the
//   counts alone, so the two sets of writes never meet.
// A group of more than kChunk choices (serving, large batches) takes two
// launches: the counting entry writes each block's counts per expert, and
// the ranking launch adds its earlier blocks' counts to before. The fsdp
// group path also calls the counting entry alone, for the counts it
// all-gathers before it ranks. The kernel allocates nothing and does not
// synchronise beyond its block; shared memory is 32 x 256 x 4 B of warp
// counts and 2 KiB of per-expert totals and starts, 34 KiB at E = 256.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxExperts = 256;          // deepseek-v3's 256 routed experts
constexpr int kMaxTopK = 8;               // its top-8
constexpr int kChunk = 32768;             // choices one block ranks
constexpr int kBatch = 8;                 // ids a lane loads before it ranks
constexpr int kMaxGroups = 65535;         // the grid's y extent

struct Args {
  const long long* ids;      // (G, T, >= k) int64, choice stride 1
  long long group_stride;    // elements between groups
  long long ld;              // elements between tokens
  int t, k, e, cap;
  int blocks;                // blocks a group: ceil(T k / kChunk), at least 1
  const long long* before;   // (G, E) int64 or NULL
  const int* block_counts;   // (G, blocks, E): the counting launch's; NULL
                             // when blocks == 1
  long long* slot;           // (G, T k) int64
  int* tfs;                  // (G, E cap + 1) int32
  int* counts;               // (G, E) int32
  int* block_counts_out;     // counting launch: (G, blocks, E) int32
  int count_only;
};

// A lane's walk over its warp's run, 32 choices a step: choice c is choice
// j of token t, moved on without a division.
struct Walk {
  int t, j, dt, dj, k;
  __device__ Walk(int c, int k_) : t(c / k_), j(c % k_), dt(32 / k_), dj(32 % k_), k(k_) {}
  __device__ __forceinline__ void step() {
    t += dt;
    j += dj;
    if (j >= k) {
      j -= k;
      ++t;
    }
  }
};

// The expert of the walk's choice c (c < end), -1 past end or outside [0, E).
__device__ __forceinline__ int load_id(const long long* ids, const Walk& w, int c,
                                       int end, long long ld, int e) {
  if (c >= end) return -1;
  const long long v = __ldg(ids + (long long)w.t * ld + w.j);
  return (v >= 0 && v < e) ? (int)v : -1;
}

__global__ void __launch_bounds__(kThreads, 1) moe_route_kernel(Args a) {
  __shared__ int run[kWarps][kMaxExperts];   // a warp's counts, then its positions
  __shared__ int total[kMaxExperts];         // the group's choices of e
  __shared__ int start[kMaxExperts];         // before[e]: this group's first position
  const int g = blockIdx.y, b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = a.t * a.k;
  const int lo = b * kChunk;
  const int hi = min(n, lo + kChunk);
  const int per_warp = (max(hi - lo, 0) + kThreads - 1) / kThreads * 32;
  const int wlo = min(hi, lo + warp * per_warp);
  const int whi = min(hi, wlo + per_warp);
  const long long* ids = a.ids + (long long)g * a.group_stride;

  for (int i = threadIdx.x; i < kWarps * kMaxExperts; i += kThreads)
    (&run[0][0])[i] = 0;
  __syncthreads();

  // pass 1: the warp's counts per expert (integer sums: any order)
  Walk w1(wlo + lane, a.k);
  for (int c0 = wlo; c0 < whi; c0 += 32 * kBatch) {
    int id[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      id[u] = load_id(ids, w1, c0 + 32 * u + lane, whi, a.ld, a.e);
      w1.step();
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (id[u] >= 0) atomicAdd(&run[warp][id[u]], 1);
  }
  __syncthreads();

  if (a.count_only) {
    if (threadIdx.x < a.e) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) s += run[w][threadIdx.x];
      a.block_counts_out[((long long)g * a.blocks + b) * a.e + threadIdx.x] = s;
    }
    return;
  }

  // scan: each warp's first position per expert
  if (threadIdx.x < a.e) {
    const int e = threadIdx.x;
    const int first = a.before ? (int)a.before[(long long)g * a.e + e] : 0;
    int pos = first, tot = 0;
    if (a.block_counts) {
      const int* bc = a.block_counts + (long long)g * a.blocks * a.e + e;
      for (int i = 0; i < a.blocks; ++i) {
        const int v = bc[(long long)i * a.e];
        if (i < b) pos += v;
        tot += v;
      }
    }
    int own = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int v = run[w][e];
      run[w][e] = pos;
      pos += v;
      own += v;
    }
    if (!a.block_counts) tot = own;
    total[e] = tot;
    start[e] = first;
    if (b == 0) a.counts[(long long)g * a.e + e] = tot;
  }
  __syncthreads();

  // pass 2: each choice's position, slot and the slot's owner
  const long long slots = (long long)a.e * a.cap + 1;
  int* tfs = a.tfs + (long long)g * slots;
  long long* slot = a.slot + (long long)g * n;
  const unsigned below = (1u << lane) - 1u;
  Walk w2(wlo + lane, a.k);
  for (int c0 = wlo; c0 < whi; c0 += 32 * kBatch) {
    int id[kBatch], tok[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      id[u] = load_id(ids, w2, c0 + 32 * u + lane, whi, a.ld, a.e);
      tok[u] = w2.t;
      w2.step();
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + 32 * u + lane;
      const unsigned peers = __match_any_sync(0xffffffffu, id[u]);
      const int pos = id[u] >= 0 ? run[warp][id[u]] + __popc(peers & below) : 0;
      __syncwarp();
      if (id[u] >= 0 && lane == __ffs(peers) - 1) run[warp][id[u]] += __popc(peers);
      __syncwarp();
      if (c < whi) {
        long long s = slots - 1;
        if (id[u] >= 0 && pos < a.cap) {
          s = (long long)id[u] * a.cap + pos;
          tfs[s] = tok[u];
        }
        slot[c] = s;
      }
    }
  }

  // every slot this group's choices do not hold: T, split over the blocks
  const int n_slots = (int)slots;         // + kThreads < 2^31: launch() checks
  const int per_block = (n_slots + a.blocks - 1) / a.blocks;
  const int s_hi = (int)min((long long)n_slots, (long long)(b + 1) * per_block);
  const int first_slot = b * per_block + threadIdx.x;
  int e = first_slot / a.cap, p = first_slot % a.cap;   // slot s = e cap + p
  const int de = kThreads / a.cap, dp = kThreads % a.cap;
  for (int s = first_slot; s < s_hi; s += kThreads) {
    const bool held = s < n_slots - 1 && p >= start[e] &&
                      (long long)p < (long long)start[e] + total[e];
    if (!held) tfs[s] = a.t;
    e += de;
    p += dp;
    if (p >= a.cap) {
      p -= a.cap;
      ++e;
    }
  }
}

// The grid's blocks a group and the block of a launch over n_choices choices
// a group: ceil(n_choices / kChunk), at least 1, of kThreads. launch() and
// the audits' probes (repro_torch/analysis/kernel_lint.py, K1) both take it
// from here.
int launch_config(long long n_choices, int* grid, int* block) {
  const long long want = (n_choices + kChunk - 1) / kChunk;
  *grid = (int)(want > 1 ? want : 1);
  *block = kThreads;
  return (int)cudaSuccess;
}

// What the compiler gave the kernel and its resident blocks per SM: the
// audits' K3 leg.
int attributes(int* num_regs, long long* shared_bytes, long long* local_bytes,
               int* max_threads, int* blocks_per_sm) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, moe_route_kernel);
  if (err != cudaSuccess) return (int)err;
  *num_regs = a.numRegs;
  *shared_bytes = (long long)a.sharedSizeBytes;
  *local_bytes = (long long)a.localSizeBytes;
  *max_threads = a.maxThreadsPerBlock;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, moe_route_kernel, kThreads, 0);
}

int launch(Args a, int groups, void* stream) {
  if (groups < 1 || groups > kMaxGroups || a.t < 0 || a.k < 1 ||
      a.k > kMaxTopK || a.e < 1 || a.e > kMaxExperts ||
      (long long)a.t * a.k > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!a.count_only && (a.cap < 1 || (long long)a.e * a.cap + 1 + kThreads > 0x7fffffffLL))
    return (int)cudaErrorInvalidValue;
  int blocks = 0, block = 0;
  const int err = launch_config((long long)a.t * a.k, &blocks, &block);
  if (err != (int)cudaSuccess) return err;
  if (a.blocks != blocks || (!a.count_only && blocks > 1 && !a.block_counts))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, groups);
  moe_route_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ids: (groups, T, >= k) int64 on the device, choice stride 1, group_stride
// and ld its other strides in elements; blocks = ceil(T k / 32768), at least
// 1. E <= 256, k <= 8, T k < 2^31, groups <= 65,535.
//
// Counting: block_counts (groups, blocks, E) int32, each block's choices per
// expert. Returns cudaGetLastError() after the launch.
int moe_route_count(const void* ids, long long group_stride, long long ld,
                    int groups, int t, int k, int e, int blocks,
                    void* block_counts, void* stream) {
  Args a = {};
  a.ids = static_cast<const long long*>(ids);
  a.group_stride = group_stride;
  a.ld = ld;
  a.t = t;
  a.k = k;
  a.e = e;
  a.blocks = blocks;
  a.block_counts_out = static_cast<int*>(block_counts);
  a.count_only = 1;
  return launch(a, groups, stream);
}

// Ranking: before (groups, E) int64 or NULL; block_counts the counting
// launch's (NULL when blocks == 1); slot (groups, T k) int64, tfs (groups,
// E cap + 1) int32, counts (groups, E) int32. Returns cudaGetLastError()
// after the launch.
int moe_route_rank(const void* ids, long long group_stride, long long ld,
                   int groups, int t, int k, int e, int cap, int blocks,
                   const void* before, const void* block_counts, void* slot,
                   void* tfs, void* counts, void* stream) {
  Args a = {};
  a.ids = static_cast<const long long*>(ids);
  a.group_stride = group_stride;
  a.ld = ld;
  a.t = t;
  a.k = k;
  a.e = e;
  a.cap = cap;
  a.blocks = blocks;
  a.before = static_cast<const long long*>(before);
  a.block_counts = static_cast<const int*>(block_counts);
  a.slot = static_cast<long long*>(slot);
  a.tfs = static_cast<int*>(tfs);
  a.counts = static_cast<int*>(counts);
  return launch(a, groups, stream);
}

// The launch's blocks a group and block for n_choices choices a group, and
// the compiled kernel's attributes, per entry. Each returns a cudaError_t.
int moe_route_count_launch_config(long long n_choices, int* grid, int* block) {
  return launch_config(n_choices, grid, block);
}

int moe_route_rank_launch_config(long long n_choices, int* grid, int* block) {
  return launch_config(n_choices, grid, block);
}

int moe_route_count_attributes(int* num_regs, long long* shared_bytes,
                               long long* local_bytes, int* max_threads,
                               int* blocks_per_sm) {
  return attributes(num_regs, shared_bytes, local_bytes, max_threads,
                    blocks_per_sm);
}

int moe_route_rank_attributes(int* num_regs, long long* shared_bytes,
                              long long* local_bytes, int* max_threads,
                              int* blocks_per_sm) {
  return attributes(num_regs, shared_bytes, local_bytes, max_threads,
                    blocks_per_sm);
}

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
