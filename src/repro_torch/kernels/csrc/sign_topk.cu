// Blockwise exact-k SignTopK for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas kernel src/repro/kernels/sign_topk.py::sign_topk_blocks
// (body _sign_topk_kernel, shared math _block_compress and _row_threshold).
// Its plain PyTorch version is repro_torch/kernels/sign_topk.py::_block_compress.
//
// Per 1024-element tile (one row of the (n_tiles, 1024) inputs):
//   diff      = f32(x_half) - f32(x_hat)      (x_hat == NULL: diff = f32(x_half))
//   thr       = the exact k_b-th largest |diff|, as an f32 bit pattern (|diff|
//               has bit 31 clear, so the pattern order is the numeric order)
//   support   = |diff| > thr, then the lowest-index ties |diff| == thr until
//               k_b are chosen; zero lanes are never chosen (|support| <= k_b)
//   scale     = mean |diff| over the support (0 for an empty support)
//   q         = support ? (trig * scale) * (diff >= 0 ? +1 : -1) : 0,
//               rounded to the input type; every lane of q is written
//   x_hat_new = x_hat + q in the input type   (only when x_hat != NULL)
//   scale_out = trig * scale, f32             (only when scale_out != NULL)
//
// Bound: bytes. The ensemble mode of the training main path (x_hat == NULL,
// f32, (2,420,196, 1024) tiles for 4 nodes of Qwen1.5-0.5B) must read diff
// and write q and the scales: 19.84 GB, 5.921 ms at 3.35 TB/s. The fused
// mode reads 8 B and writes 8 B per element.
//
// Design: one warp per tile, blocks of 4 warps walking the tiles grid-stride
// with 64-bit offsets (the main path has 2.48e9 elements).
//
// Loads: coalesced 16-byte streaming loads straight into registers; lane l
// holds tile elements 128*c + 4*l + e (chunk c < 8, e < 4).
//
// Select: the threshold is a histogram-and-filter select:
//   1. a histogram of the first digit, pattern bits 30..20 (11 bits, 2048
//      bins), one shared-memory atomicAdd per element; the bins are 16-bit
//      counts, two to a 32-bit word (a tile has at most 1024 elements);
//   2. a two-level warp suffix scan finds the digit D that holds the k_b-th
//      largest pattern and the rank k' left inside it: each lane sums 64
//      contiguous bins from the top, a shuffle scan picks the lane whose bins
//      cross k_b, and a second shuffle scan over that lane's 32 words picks
//      the bin;
//   3. the patterns of digit D are compacted into the same shared words (the
//      histogram is dead by then) through a per-warp counter; on Gaussian
//      tiles at k_b = 103 they are about 27 (at most a few dozen);
//   4. one-bit passes resolve bits 19..0 over the candidates only: a register
//      compare and one __reduce_add_sync a pass while they fit one to a lane,
//      a strided shared-memory walk otherwise (up to 1024 of them, for a
//      constant tile or k_b = 1024).
// Steps 3 and 4 were also tried as a ballot-scan compaction and a 32-shuffle
// rank of the candidates: more instructions, and slower on the card. A
// second digit histogram was not built for step 4: over a few dozen
// candidates its clear, atomics and scan issue more than 20 passes of one
// compare. The tie rank is an index-ordered prefix count, chunk by chunk, by
// a warp inclusive scan (__shfl_up_sync); it runs only when the ties at thr
// outnumber the quota, which real data rarely gives.
//
// Budget: shared memory per warp is the 4 KB of histogram words, reused for
// the candidates, and the counter: 16,400 B of static shared memory per
// 4-warp block. __launch_bounds__(128, 4) allows 128 registers; ptxas gives
// 118 (f32 and bf16), no spills. So 4 blocks, 16 warps, are resident per
// SM, held there by registers: a cap of 80 registers for 24 warps spilled
// and ran slower on the card. The grid is the resident block count times
// the SMs (cudaOccupancyMaxActiveBlocksPerMultiprocessor), capped by the
// tiles.
//
// Not built: a two-slot ring per warp of tiles filled by the 1-D bulk copy
// (cp.async.bulk on an mbarrier), so that a warp's next loads overlap its
// select. This kernel is within 1.5x of its byte bound without it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;
constexpr int kWarps = 4;                 // tiles in flight per 128-thread block
constexpr int kMinBlocks = 4;             // resident blocks per SM: <= 128 registers
constexpr int kChunks = kTile / 128;      // 8 chunks of 4 elements per lane
constexpr int kDigitShift = 20;           // first digit: pattern bits 30..20
constexpr int kWords = 1024;              // 2048 16-bit bins, two per word
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load(const float* p, float v[4]) {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  static __device__ __forceinline__ void store(float* p, const float v[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
  // round an f32 value to the storage type and back
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float v[4]) {
    const uint2 x = __ldcs(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float v[4]) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 x;
    x.x = *reinterpret_cast<const unsigned*>(&lo);
    x.y = *reinterpret_cast<const unsigned*>(&hi);
    __stcs(reinterpret_cast<uint2*>(p), x);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += up;
  }
  return v;
}

// The k_b-th largest of the warp's 1024 patterns u (lane-held, 32 each).
// words: this warp's kWords shared words; count: its shared counter.
__device__ __forceinline__ unsigned select_kth(const unsigned u[32], int k_b,
                                               int lane, unsigned* words,
                                               unsigned* count) {
  // 1. first-digit histogram: bin b counts in the low (b even) or high
  // (b odd) half of word b / 2
  __syncwarp();  // the previous tile's candidates are read
  uint4* w4 = reinterpret_cast<uint4*>(words);
#pragma unroll
  for (int i = 0; i < kWords / 128; ++i) w4[lane + 32 * i] = make_uint4(0, 0, 0, 0);
  if (lane == 0) *count = 0;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 32; ++i)
    atomicAdd(&words[u[i] >> (kDigitShift + 1)], 1u << ((u[i] >> 16) & 16));
  __syncwarp();

  // 2a. lane l sums words [992 - 32l, 1023 - 32l], the top digits in lane 0;
  // the 16-byte reads rotate by lane so a quarter-warp hits distinct banks
  const uint4* own = reinterpret_cast<const uint4*>(words + kWords - 32 - 32 * lane);
  unsigned packed = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint4 w = own[(i + lane) & 7];
    packed += w.x + w.y + w.z + w.w;   // each half stays <= 1024: no carry
  }
  const int sum = (int)((packed & 0xffffu) + (packed >> 16));
  const int incl = warp_inclusive_scan(sum, lane);
  const int top = __ffs(__ballot_sync(kFull, incl >= k_b)) - 1;
  const int rank = k_b - __shfl_sync(kFull, incl - sum, top);   // >= 1

  // 2b. lane j takes word 1023 - 32*top - j of that lane's range
  const int w = kWords - 1 - 32 * top - lane;
  const unsigned word = words[w];
  const int hi = (int)(word >> 16), lo = (int)(word & 0xffffu);
  const int incl2 = warp_inclusive_scan(hi + lo, lane);
  const int at = __ffs(__ballot_sync(kFull, incl2 >= rank)) - 1;
  const int above = incl2 - hi - lo;
  const bool in_hi = above + hi >= rank;
  const unsigned digit = __shfl_sync(kFull, 2u * w + (in_hi ? 1u : 0u), at);
  const int kk = __shfl_sync(kFull, in_hi ? rank - above : rank - above - hi, at);
  const int n = __shfl_sync(kFull, in_hi ? hi : lo, at);
  __syncwarp();  // every lane has read its words

  // 3. compact the candidates (patterns of digit D) into the words; their
  // order does not matter, the threshold is a value
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if ((u[i] >> kDigitShift) == digit) words[atomicAdd(count, 1u)] = u[i];
  __syncwarp();

  // 4. resolve bits 19..0: the largest t with #(candidates >= t) >= kk.
  // Every tested t has a bit set, so the empty lanes' 0 never counts
  unsigned prefix = digit << kDigitShift;
  if (n <= 32) {
    const unsigned v = lane < n ? words[lane] : 0u;
#pragma unroll 1
    for (int bit = kDigitShift - 1; bit >= 0; --bit) {
      const unsigned c = prefix | (1u << bit);
      if (__reduce_add_sync(kFull, v >= c ? 1u : 0u) >= (unsigned)kk) prefix = c;
    }
  } else {
#pragma unroll 1
    for (int bit = kDigitShift - 1; bit >= 0; --bit) {
      const unsigned c = prefix | (1u << bit);
      unsigned cnt = 0;
      for (int i = lane; i < n; i += 32) cnt += words[i] >= c ? 1u : 0u;
      if (__reduce_add_sync(kFull, cnt) >= (unsigned)kk) prefix = c;
    }
  }
  return prefix;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
sign_topk_kernel(const T* __restrict__ x_half, const T* __restrict__ x_hat,
                 float trig, int k_b, long long n_tiles, T* __restrict__ q_out,
                 T* __restrict__ x_hat_out, float* __restrict__ scale_out) {
  // per warp: the histogram words, reused for the candidates, and a counter
  __shared__ __align__(16) unsigned words[kWarps][kWords];
  __shared__ unsigned count[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long tile = (long long)blockIdx.x * kWarps + warp; tile < n_tiles;
       tile += stride) {
    const long long base = tile * kTile + 4 * lane;

    // |diff| bit patterns in registers, and which lanes are negative
    unsigned u[32];
    unsigned neg = 0;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      float d[4];
      Io<T>::load(x_half + base + 128 * c, d);
      if (x_hat != nullptr) {
        float e[4];
        Io<T>::load(x_hat + base + 128 * c, e);
#pragma unroll
        for (int i = 0; i < 4; ++i) d[i] = d[i] - e[i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        u[4 * c + i] = __float_as_uint(fabsf(d[i]));
        neg |= (d[i] >= 0.0f ? 0u : 1u) << (4 * c + i);
      }
    }
    const float thr = __uint_as_float(
        select_kth(u, k_b, lane, words[warp], &count[warp]));

    // support: strictly above thr, then lowest-index ties, never zero lanes
    unsigned gt = 0, tie = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float a = __uint_as_float(u[i]);
      const bool pos = a > 0.0f;
      const bool g = pos && a > thr;
      gt |= (g ? 1u : 0u) << i;
      tie |= (pos && !g && a >= thr ? 1u : 0u) << i;
    }
    const int quota = k_b - __reduce_add_sync(kFull, __popc(gt));
    const int n_tie = __reduce_add_sync(kFull, __popc(tie));
    unsigned sel = gt;
    if (n_tie <= quota) {
      sel |= tie;
    } else {
      int before = 0;  // ties in earlier chunks
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const unsigned t4 = (tie >> (4 * c)) & 0xfu;
        const int own = __popc(t4);
        const int incl = warp_inclusive_scan(own, lane);
        int rank = before + incl - own;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if ((t4 >> e) & 1u) {
            ++rank;
            if (rank <= quota) sel |= 1u << (4 * c + e);
          }
        }
        before += __shfl_sync(kFull, incl, 31);
      }
    }

    // scale = mean |diff| over the support
    float mass = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) mass += (sel >> i) & 1u ? __uint_as_float(u[i]) : 0.0f;
    mass = warp_sum(mass);
    const float nsel = (float)__reduce_add_sync(kFull, __popc(sel));
    const float ts = trig * (mass / fmaxf(nsel, 1.0f));

#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      float q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * c + i;
        q[i] = (sel >> j) & 1u ? ((neg >> j) & 1u ? -ts : ts) : 0.0f;
      }
      Io<T>::store(q_out + base + 128 * c, q);
      if (x_hat_out != nullptr) {
        // x_hat is read a second time here rather than held in 32 more
        // registers: the fused mode is off the main path
        float e[4];
        Io<T>::load(x_hat + base + 128 * c, e);
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = e[i] + Io<T>::round(q[i]);
        Io<T>::store(x_hat_out + base + 128 * c, e);
      }
    }
    if (scale_out != nullptr && lane == 0) scale_out[tile] = ts;
  }
}

// The grid and block of a launch over n_tiles: the resident block count
// times the SMs, capped by the tiles. launch() and the audits' probes
// (repro_torch/analysis/kernel_lint.py, K1) both take it from here.
template <typename T>
int launch_config(long long n_tiles, int* grid, int* block) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sign_topk_kernel<T>, kWarps * 32, 0);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n_tiles + kWarps - 1) / kWarps;
  const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  *grid = (int)(want < cap ? want : cap);
  *block = kWarps * 32;
  return (int)cudaSuccess;
}

// What the compiler gave the kernel (cudaFuncGetAttributes) and its resident
// blocks per SM at the launch's block size: the audits' K3 leg.
template <typename T>
int attributes(int* num_regs, long long* shared_bytes, long long* local_bytes,
               int* max_threads, int* blocks_per_sm) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, sign_topk_kernel<T>);
  if (err != cudaSuccess) return (int)err;
  *num_regs = a.numRegs;
  *shared_bytes = (long long)a.sharedSizeBytes;
  *local_bytes = (long long)a.localSizeBytes;
  *max_threads = a.maxThreadsPerBlock;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, sign_topk_kernel<T>, kWarps * 32, 0);
}

template <typename T>
int launch(const void* x_half, const void* x_hat, float trig, int k_b,
           long long n_tiles, void* q, void* x_hat_new, void* scale,
           void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  int grid = 0, block = 0;
  const int err = launch_config<T>(n_tiles, &grid, &block);
  if (err != (int)cudaSuccess) return err;
  sign_topk_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x_half), static_cast<const T*>(x_hat), trig, k_b,
      n_tiles, static_cast<T*>(q), static_cast<T*>(x_hat_new),
      static_cast<float*>(scale));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x_half, x_hat, q, x_hat_new: (n_tiles, 1024) of one type; scale: (n_tiles,)
// f32. x_hat and x_hat_new are both NULL (ensemble mode) or both set; scale
// may be NULL. Returns cudaGetLastError() after the launch.
int sign_topk_f32(const void* x_half, const void* x_hat, float trig, int k_b,
                  long long n_tiles, void* q, void* x_hat_new, void* scale,
                  void* stream) {
  return launch<float>(x_half, x_hat, trig, k_b, n_tiles, q, x_hat_new, scale,
                       stream);
}

int sign_topk_bf16(const void* x_half, const void* x_hat, float trig, int k_b,
                   long long n_tiles, void* q, void* x_hat_new, void* scale,
                   void* stream) {
  return launch<__nv_bfloat16>(x_half, x_hat, trig, k_b, n_tiles, q,
                               x_hat_new, scale, stream);
}

// The launch's grid and block for n_tiles, and the compiled kernel's
// attributes, per instantiated type. Each returns a cudaError_t.
int sign_topk_f32_launch_config(long long n_tiles, int* grid, int* block) {
  return launch_config<float>(n_tiles, grid, block);
}

int sign_topk_bf16_launch_config(long long n_tiles, int* grid, int* block) {
  return launch_config<__nv_bfloat16>(n_tiles, grid, block);
}

int sign_topk_f32_attributes(int* num_regs, long long* shared_bytes,
                             long long* local_bytes, int* max_threads,
                             int* blocks_per_sm) {
  return attributes<float>(num_regs, shared_bytes, local_bytes, max_threads,
                           blocks_per_sm);
}

int sign_topk_bf16_attributes(int* num_regs, long long* shared_bytes,
                              long long* local_bytes, int* max_threads,
                              int* blocks_per_sm) {
  return attributes<__nv_bfloat16>(num_regs, shared_bytes, local_bytes,
                                   max_threads, blocks_per_sm);
}

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
