// The sync's x_hat update and gossip mixing in one pass, for Hopper (sm_90a),
// with a plain C interface.
//
// Replaces no Pallas kernel: it replaces repro_torch/dist/sparq_dist.py's
// eager x_hat update and mix_term in sync() (about a dozen elementwise
// kernels and two torch.roll copies per column chunk, 261 chunks of 2^22 at
// deepseek-moe-16b's width), the counterpart of core/sparq.gossip_mix with
// lines 13 and 15 of Algorithm 1 in the reference. Its plain PyTorch version
// is repro_torch/kernels/xhat_mix.py::xhat_mix_plain.
//
// Over the rank's n rows (every node: one rank), for every column j:
//   xe_i      = round_xhat(x_hat_i + q_i * trig_i)   (line 13; f32 or bf16)
//   x_hat_i   = xe_i
//   x_i      += gamma * mix_i(xe)                     (line 15)
// with mix_i in one of two modes, each a template choice:
//   roll:  a static circulant W (first row c): mix_i = (c_0 - 1) xe_i, then
//          + c_s xe_{(i+s) mod n} for each shift s with c_s > 0, in order;
//          every product and sum separately rounded (__fmul_rn, __fadd_rn),
//          the one-process order of mix_term, so x and x_hat are bit for
//          bit the eager path's;
//   dense: any W (n, n) on the device: mix_i = sum_j W_ij xe_j - xe_i, a
//          fused multiply-add chain over j, within float32 rounding of
//          gossip_mix's tensordot (the GEMM sums in its own order).
// gamma * mix and x + that are separately rounded in both modes, as the
// eager `params += gamma * mix` is. trig (n,) and W (n, n) are read on the
// device; the circulant's coefficients and gamma come by value.
//
// Bound: bytes. It reads q, x_hat and x and writes x_hat and x: 20 B a
// coordinate at float32 (16 B with a bfloat16 x_hat). At the (4,
// 1,091,315,712) rows of deepseek-moe-16b's two-layer cut that is 87.3 GB,
// 26.06 ms at 3.35 TB/s; at stablelm-2-1.6b's (2, 1,644,367,872), 65.8 GB,
// 19.63 ms. The arithmetic, a few float32 operations a coordinate per
// shift (n per coordinate in dense mode), is far below the bytes.
//
// Design: each thread holds all n rows of its columns in registers, so a
// roll is a register read and nothing is fetched twice. One warp walks one
// 1024-column tile of every row at a time; lane l holds columns
// 32 * kCols * c + kCols * l + e of a tile (chunk c, e < kCols), kCols = 4
// (f32) or 8 (bf16), so every x_hat access is one 16-byte vector and a
// warp's access is 512 contiguous bytes of a row (q and x: 16 B or two 16 B
// vectors a lane). Up to n = 4 a lane loads x_hat, q and x of every row of
// its chunk (two chunks at n = 2) before it computes: 12 vectors in flight
// at n = 4; past that each row's vectors are loaded just before their use,
// so the registers hold the n rounded rows and the spills stay off. Dense
// mode keeps W in registers up to n = 4 and reads it from L1 past that.
// Loads and stores stream (__ldcs, __stcs): nothing is read twice. Blocks of
// 8 warps walk the tiles grid-stride with 64-bit row offsets (m x D_pad
// reaches 4.4e9 elements); the grid is 8 blocks a SM, capped by the tiles,
// the most that can be resident, so whatever occupancy an instantiation
// reaches is filled. __launch_bounds__(256, 2) caps the registers at 128.
// The kernel allocates nothing and uses no shared memory. A bf16 x_hat
// keeps its rounded rows packed two to a register.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;
constexpr int kWarps = 8;                 // tiles in flight per 256-thread block
constexpr int kMinBlocks = 2;             // resident blocks per SM: <= 128 registers
constexpr int kBlocksPerSm = 8;           // grid cap: 2048 threads an SM
constexpr int kMinNodes = 2;
constexpr int kMaxNodes = 16;             // the largest n_nodes of the configs

// The circulant's coefficients, by value: c0m1 = c_0 - 1, c[s] for shift s,
// summed where bit s of mask is set.
struct Roll {
  float c0m1;
  float c[kMaxNodes];
  unsigned mask;
};

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

// x_hat's element type: one 16-byte vector of kCols columns, and a row of
// them as kept in registers after rounding.
template <typename T>
struct Xh;

template <>
struct Xh<float> {
  static constexpr int kCols = 4;
  struct Row { float v[4]; };
  static __device__ __forceinline__ void load(const float* p, float* v) {
    load4(p, v);
  }
  static __device__ __forceinline__ void keep(Row& r, const float* s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) r.v[e] = s[e];
  }
  static __device__ __forceinline__ float get(const Row& r, int e) {
    return r.v[e];
  }
  static __device__ __forceinline__ void store(float* p, const Row& r) {
    store4(p, r.v);
  }
};

template <>
struct Xh<__nv_bfloat16> {
  static constexpr int kCols = 8;
  struct Row { __nv_bfloat162 v[4]; };
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  // .to(bfloat16): round to nearest even; the row keeps the rounded values
  static __device__ __forceinline__ void keep(Row& r, const float* s) {
#pragma unroll
    for (int k = 0; k < 4; ++k) r.v[k] = __floats2bfloat162_rn(s[2 * k], s[2 * k + 1]);
  }
  static __device__ __forceinline__ float get(const Row& r, int e) {
    const float2 f = __bfloat1622float2(r.v[e >> 1]);
    return (e & 1) ? f.y : f.x;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const Row& r) {
    uint4 a;
    a.x = *reinterpret_cast<const unsigned*>(&r.v[0]);
    a.y = *reinterpret_cast<const unsigned*>(&r.v[1]);
    a.z = *reinterpret_cast<const unsigned*>(&r.v[2]);
    a.w = *reinterpret_cast<const unsigned*>(&r.v[3]);
    __stcs(reinterpret_cast<uint4*>(p), a);
  }
};

// One row's x_hat, q and x vectors at offset off.
template <typename X, typename T>
__device__ __forceinline__ void load_row(const T* x_hat, const float* x,
                                         const float* q, long long off,
                                         float* hv, float* qv, float* xv) {
  X::load(x_hat + off, hv);
#pragma unroll
  for (int k = 0; k < X::kCols; k += 4) load4(q + off + k, qv + k);
#pragma unroll
  for (int k = 0; k < X::kCols; k += 4) load4(x + off + k, xv + k);
}

// W_ij in dense mode: up to 4 nodes W stays in registers across the tiles;
// past that it is read again at each use (a volatile load, which the
// compiler neither hoists out of the tile loop nor keeps: 256 registers at
// n = 16), a broadcast hit in L1.
template <int N>
__device__ __forceinline__ float w_at(const float* p) {
  if constexpr (N <= 4) {
    return __ldg(p);
  } else {
    float v;
    asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
    return v;
  }
}

// x_hat, x, q: (N, ld) row-major, the first n_tiles * 1024 columns of each
// row used; trig: (N,) f32; w: (N, N) f32 (dense mode, else unused).
template <int N, typename T, bool kRoll>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
xhat_mix_kernel(T* __restrict__ x_hat, float* __restrict__ x,
                const float* __restrict__ q, const float* __restrict__ trig,
                const float* __restrict__ w, Roll roll, float gamma,
                long long n_tiles, long long ld) {
  using X = Xh<T>;
  constexpr int kCols = X::kCols;
  constexpr int kChunks = kTile / (32 * kCols);    // chunks a lane walks a tile
  constexpr int kStep = N <= 2 ? 2 : 1;            // chunks a lane has in flight
  // up to 4 rows every load of a chunk is issued before its first use;
  // past that a row's loads come just before its use (the registers hold
  // the n rows of x_hat and not 3n vectors in flight)
  constexpr bool kAhead = N <= 4;
  const int lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  float tf[N];
#pragma unroll
  for (int i = 0; i < N; ++i) tf[i] = __ldg(trig + i);

  for (long long tile = first; tile < n_tiles; tile += stride) {
#pragma unroll 1
    for (int c = 0; c < kChunks; c += kStep) {
      float hv[kStep][N][kCols], qv[kStep][N][kCols], xv[kStep][N][kCols];
      typename X::Row xe[kStep][N];
      long long col[kStep];
#pragma unroll
      for (int u = 0; u < kStep; ++u)
        col[u] = tile * kTile + (long long)((c + u) * 32 + lane) * kCols;
      if constexpr (kAhead) {
#pragma unroll
        for (int u = 0; u < kStep; ++u)
#pragma unroll
          for (int i = 0; i < N; ++i) load_row<X>(x_hat, x, q, (long long)i * ld + col[u],
                                                  hv[u][i], qv[u][i], xv[u][i]);
      }
      // line 13: x_hat + q * trig, rounded to x_hat's type
#pragma unroll
      for (int u = 0; u < kStep; ++u)
#pragma unroll
        for (int i = 0; i < N; ++i) {
          if constexpr (!kAhead) {
            const long long off = (long long)i * ld + col[u];
            X::load(x_hat + off, hv[u][i]);
#pragma unroll
            for (int k = 0; k < kCols; k += 4) load4(q + off + k, qv[u][i] + k);
          }
          float s[kCols];
#pragma unroll
          for (int e = 0; e < kCols; ++e)
            s[e] = __fadd_rn(hv[u][i][e], __fmul_rn(qv[u][i][e], tf[i]));
          X::keep(xe[u][i], s);
        }
      // line 15: x + gamma * (W xe - xe)
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const long long off = (long long)i * ld + col[u];
          if constexpr (!kAhead) {
#pragma unroll
            for (int k = 0; k < kCols; k += 4) load4(x + off + k, xv[u][i] + k);
          }
          float acc[kCols];
          if constexpr (kRoll) {
#pragma unroll
            for (int e = 0; e < kCols; ++e) {
              acc[e] = __fmul_rn(roll.c0m1, X::get(xe[u][i], e));
#pragma unroll
              for (int s = 1; s < N; ++s)
                if ((roll.mask >> s) & 1u)
                  acc[e] = __fadd_rn(acc[e], __fmul_rn(roll.c[s],
                                                       X::get(xe[u][(i + s) % N], e)));
            }
          } else {
#pragma unroll
            for (int j = 0; j < N; ++j) {
              const float wij = w_at<N>(w + i * N + j);
#pragma unroll
              for (int e = 0; e < kCols; ++e)
                acc[e] = j == 0 ? __fmul_rn(wij, X::get(xe[u][0], e))
                                : __fmaf_rn(wij, X::get(xe[u][j], e), acc[e]);
            }
#pragma unroll
            for (int e = 0; e < kCols; ++e)
              acc[e] = __fsub_rn(acc[e], X::get(xe[u][i], e));
          }
#pragma unroll
          for (int e = 0; e < kCols; ++e)
            xv[u][i][e] = __fadd_rn(xv[u][i][e], __fmul_rn(gamma, acc[e]));
#pragma unroll
          for (int k = 0; k < kCols; k += 4) store4(x + off + k, xv[u][i] + k);
          X::store(x_hat + off, xe[u][i]);
        }
      }
    }
  }
}

// The grid and block of a launch over n_tiles (of every row): 8 blocks a
// SM, capped by the tiles. launch() and the audits' probes (repro_torch/
// analysis/kernel_lint.py, K1) both take it from here; it is the same for
// every n and mode.
int launch_config(long long n_tiles, int* grid, int* block) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n_tiles + kWarps - 1) / kWarps;
  const long long cap = (long long)kBlocksPerSm * sms;
  *grid = (int)(want < cap ? want : cap);
  *block = kWarps * 32;
  return (int)cudaSuccess;
}

// The instantiation for n = N and above, so that n names the one of
// N..kMaxNodes to take; cudaErrorInvalidValue past kMaxNodes.
template <typename T, bool kRoll, int N = kMinNodes>
int attributes_from(int n, cudaFuncAttributes* a, int* blocks_per_sm) {
  if constexpr (N > kMaxNodes) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (n != N) return attributes_from<T, kRoll, N + 1>(n, a, blocks_per_sm);
    const cudaError_t err = cudaFuncGetAttributes(a, xhat_mix_kernel<N, T, kRoll>);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, xhat_mix_kernel<N, T, kRoll>, kWarps * 32, 0);
  }
}

template <typename T, bool kRoll, int N = kMinNodes>
int launch_from(int n, int grid, int block, cudaStream_t stream, T* x_hat,
                float* x, const float* q, const float* trig, const float* w,
                const Roll& roll, float gamma, long long n_tiles,
                long long ld) {
  if constexpr (N > kMaxNodes) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (n != N)
      return launch_from<T, kRoll, N + 1>(n, grid, block, stream, x_hat, x, q,
                                          trig, w, roll, gamma, n_tiles, ld);
    xhat_mix_kernel<N, T, kRoll><<<grid, block, 0, stream>>>(
        x_hat, x, q, trig, w, roll, gamma, n_tiles, ld);
    return (int)cudaGetLastError();
  }
}

// What the compiler gave the kernel (cudaFuncGetAttributes) and its resident
// blocks per SM at the launch's block size, the worst over n = 2..16: the
// most registers and local memory, the fewest threads and blocks. The
// audits' K3 leg.
template <typename T, bool kRoll>
int attributes(int* num_regs, long long* shared_bytes, long long* local_bytes,
               int* max_threads, int* blocks_per_sm) {
  *num_regs = 0;
  *shared_bytes = 0;
  *local_bytes = 0;
  *max_threads = 1 << 30;
  *blocks_per_sm = 1 << 30;
  for (int n = kMinNodes; n <= kMaxNodes; ++n) {
    cudaFuncAttributes a;
    int blocks = 0;
    const int err = attributes_from<T, kRoll>(n, &a, &blocks);
    if (err != (int)cudaSuccess) return err;
    if (a.numRegs > *num_regs) *num_regs = a.numRegs;
    if ((long long)a.sharedSizeBytes > *shared_bytes)
      *shared_bytes = (long long)a.sharedSizeBytes;
    if ((long long)a.localSizeBytes > *local_bytes)
      *local_bytes = (long long)a.localSizeBytes;
    if (a.maxThreadsPerBlock < *max_threads) *max_threads = a.maxThreadsPerBlock;
    if (blocks < *blocks_per_sm) *blocks_per_sm = blocks;
  }
  return (int)cudaSuccess;
}

template <typename T, bool kRoll>
int launch(void* x_hat, void* x, const void* q, const void* trig,
           const void* w, const float* coefs, unsigned mask, float gamma,
           int n, long long n_tiles, long long ld, void* stream) {
  if (n < kMinNodes || n > kMaxNodes) return (int)cudaErrorInvalidValue;
  if (n_tiles <= 0) return (int)cudaSuccess;
  Roll roll = {};
  if constexpr (kRoll) {
    roll.c0m1 = coefs[0];
    for (int s = 1; s < n; ++s) roll.c[s] = coefs[s];
    roll.mask = mask;
  }
  int grid = 0, block = 0;
  const int err = launch_config(n_tiles, &grid, &block);
  if (err != (int)cudaSuccess) return err;
  return launch_from<T, kRoll>(
      n, grid, block, (cudaStream_t)stream, static_cast<T*>(x_hat),
      static_cast<float*>(x), static_cast<const float*>(q),
      static_cast<const float*>(trig), static_cast<const float*>(w), roll,
      gamma, n_tiles, ld);
}

}  // namespace

extern "C" {

// x_hat: (n, ld) of the entry's type, x and q: (n, ld) f32, the first
// n_tiles * 1024 columns of each row used; trig: (n,) f32 on the device.
// Roll entries: coefs (host, n floats) holds c_0 - 1 and c_s for s = 1..n-1,
// bit s of mask marks a summed shift; w is unused. Dense entries: w (n, n)
// f32 on the device; coefs and mask are unused. 2 <= n <= 16. Returns
// cudaGetLastError() after the launch.
int xhat_mix_roll_f32(void* x_hat, void* x, const void* q, const void* trig,
                      const void* w, const float* coefs, unsigned mask,
                      float gamma, int n, long long n_tiles, long long ld,
                      void* stream) {
  return launch<float, true>(x_hat, x, q, trig, w, coefs, mask, gamma, n,
                             n_tiles, ld, stream);
}

int xhat_mix_roll_bf16(void* x_hat, void* x, const void* q, const void* trig,
                       const void* w, const float* coefs, unsigned mask,
                       float gamma, int n, long long n_tiles, long long ld,
                       void* stream) {
  return launch<__nv_bfloat16, true>(x_hat, x, q, trig, w, coefs, mask, gamma,
                                     n, n_tiles, ld, stream);
}

int xhat_mix_dense_f32(void* x_hat, void* x, const void* q, const void* trig,
                       const void* w, const float* coefs, unsigned mask,
                       float gamma, int n, long long n_tiles, long long ld,
                       void* stream) {
  return launch<float, false>(x_hat, x, q, trig, w, coefs, mask, gamma, n,
                              n_tiles, ld, stream);
}

int xhat_mix_dense_bf16(void* x_hat, void* x, const void* q, const void* trig,
                        const void* w, const float* coefs, unsigned mask,
                        float gamma, int n, long long n_tiles, long long ld,
                        void* stream) {
  return launch<__nv_bfloat16, false>(x_hat, x, q, trig, w, coefs, mask,
                                      gamma, n, n_tiles, ld, stream);
}

// The launch's grid and block for n_tiles, and the compiled kernel's
// attributes (the worst over n), per entry. Each returns a cudaError_t.
int xhat_mix_roll_f32_launch_config(long long n_tiles, int* grid, int* block) {
  return launch_config(n_tiles, grid, block);
}

int xhat_mix_roll_bf16_launch_config(long long n_tiles, int* grid, int* block) {
  return launch_config(n_tiles, grid, block);
}

int xhat_mix_dense_f32_launch_config(long long n_tiles, int* grid, int* block) {
  return launch_config(n_tiles, grid, block);
}

int xhat_mix_dense_bf16_launch_config(long long n_tiles, int* grid,
                                      int* block) {
  return launch_config(n_tiles, grid, block);
}

int xhat_mix_roll_f32_attributes(int* num_regs, long long* shared_bytes,
                                 long long* local_bytes, int* max_threads,
                                 int* blocks_per_sm) {
  return attributes<float, true>(num_regs, shared_bytes, local_bytes,
                                 max_threads, blocks_per_sm);
}

int xhat_mix_roll_bf16_attributes(int* num_regs, long long* shared_bytes,
                                  long long* local_bytes, int* max_threads,
                                  int* blocks_per_sm) {
  return attributes<__nv_bfloat16, true>(num_regs, shared_bytes, local_bytes,
                                         max_threads, blocks_per_sm);
}

int xhat_mix_dense_f32_attributes(int* num_regs, long long* shared_bytes,
                                  long long* local_bytes, int* max_threads,
                                  int* blocks_per_sm) {
  return attributes<float, false>(num_regs, shared_bytes, local_bytes,
                                  max_threads, blocks_per_sm);
}

int xhat_mix_dense_bf16_attributes(int* num_regs, long long* shared_bytes,
                                   long long* local_bytes, int* max_threads,
                                   int* blocks_per_sm) {
  return attributes<__nv_bfloat16, false>(num_regs, shared_bytes, local_bytes,
                                          max_threads, blocks_per_sm);
}

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
