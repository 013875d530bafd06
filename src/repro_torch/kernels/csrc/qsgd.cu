// Blockwise QSGD stochastic quantizer for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces the Pallas kernel src/repro/kernels/qsgd.py::qsgd_blocks (body
// _qsgd_kernel, shared math _qsgd_rows). Its plain PyTorch version is
// repro_torch/kernels/qsgd.py::qsgd_blocks_plain.
//
// Per 1024-element tile (one row of the (n_tiles, 1024) inputs), in f32:
//   norm  = sqrt(sum x^2)
//   level = (|x| / (norm > 0 ? norm : 1)) * s
//   q     = (floor(level) + (u < level - floor(level) ? 1 : 0)) / s
//   out   = (norm * sign(x)) * q, sign(0) = 0, rounded to x's type
// The uniform noise u is an input (the reference's noise contract): there
// is no generator in the kernel, so one u gives one answer.
//
// Bound: memory. It reads x and u and writes out, 12 B per element in f32
// (8 B in bf16), for about 10 f32 operations: at the training buffer's
// shape, (2,420,196 x 1024) f32, 29.7 GB or 8.9 ms at 3.35 TB/s, against
// about 0.4 ms of arithmetic. Design for that: one warp per tile, so the
// norm is a register sum and five __shfl_xor_sync steps, with no shared
// memory and no __syncthreads. Lane l holds elements 128*c + 4*l + e
// (c < 8, e < 4), so each warp-wide 16 B load (8 B in bf16) covers 512
// contiguous bytes, and a lane issues all 16 of its loads (x and u) before
// it waits on any, which keeps enough bytes in flight to cover the memory
// latency. Loads and stores are streaming (__ldcs/__stcs): nothing is read
// twice. Blocks of 8 warps walk the tiles grid-stride with 64-bit offsets:
// the training buffer holds 2.48e9 elements.
//
// Rounding matches the plain version operation for operation: the products
// and quotients are __fmul_rn/__fdiv_rn, so the compiler cannot contract
// level - floor(level) into a fused multiply-add. Only the sum of squares is
// added in another order than PyTorch's, so norm may differ by an ulp, and
// such a difference can move an element by one level (norm / s) where
// level - floor(level) or u lies within ulps of a rounding boundary
// (repro_torch/kernels/parity.py counts those).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;
constexpr int kWarps = 8;                 // tiles in flight per 256-thread block
constexpr int kChunks = kTile / 128;      // 8 chunks of 4 elements per lane
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
    const __nv_bfloat16 b0 = __float2bfloat16_rn(v[0]);
    const __nv_bfloat16 b1 = __float2bfloat16_rn(v[1]);
    const __nv_bfloat16 b2 = __float2bfloat16_rn(v[2]);
    const __nv_bfloat16 b3 = __float2bfloat16_rn(v[3]);
    uint2 x;
    x.x = (unsigned)__bfloat16_as_ushort(b0) | ((unsigned)__bfloat16_as_ushort(b1) << 16);
    x.y = (unsigned)__bfloat16_as_ushort(b2) | ((unsigned)__bfloat16_as_ushort(b3) << 16);
    __stcs(reinterpret_cast<uint2*>(p), x);
  }
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
qsgd_kernel(const T* __restrict__ x, const float* __restrict__ u, float s,
            long long n_tiles, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;

  for (long long tile = first; tile < n_tiles; tile += stride) {
    const long long base = tile * kTile + 4 * lane;
    float v[kChunks][4];
    float r[kChunks][4];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) Io<T>::load(x + base + 128 * c, v[c]);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) Io<float>::load(u + base + 128 * c, r[c]);

    float sq = 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) sq = fmaf(v[c][e], v[c][e], sq);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(kFull, sq, o);
    const float norm = sqrtf(sq);
    const float safe = norm > 0.0f ? norm : 1.0f;

#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = v[c][e];
        const float level = __fmul_rn(__fdiv_rn(fabsf(a), safe), s);
        const float low = floorf(level);
        const float up = r[c][e] < level - low ? 1.0f : 0.0f;
        const float q = __fdiv_rn(low + up, s);
        const float sgn = a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : 0.0f);
        o[e] = __fmul_rn(__fmul_rn(norm, sgn), q);
      }
      Io<T>::store(out + base + 128 * c, o);
    }
  }
}

// The grid and block of a launch over n_tiles: 32 blocks per SM, capped by
// the tiles. launch() and the audits' probes (repro_torch/analysis/
// kernel_lint.py, K1) both take it from here.
template <typename T>
int launch_config(long long n_tiles, int* grid, int* block) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n_tiles + kWarps - 1) / kWarps;
  const long long cap = 32LL * sms;
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
  cudaError_t err = cudaFuncGetAttributes(&a, qsgd_kernel<T>);
  if (err != cudaSuccess) return (int)err;
  *num_regs = a.numRegs;
  *shared_bytes = (long long)a.sharedSizeBytes;
  *local_bytes = (long long)a.localSizeBytes;
  *max_threads = a.maxThreadsPerBlock;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, qsgd_kernel<T>, kWarps * 32, 0);
}

template <typename T>
int launch(const void* x, const void* u, int s, long long n_tiles, void* out,
           void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  int grid = 0, block = 0;
  const int err = launch_config<T>(n_tiles, &grid, &block);
  if (err != (int)cudaSuccess) return err;
  qsgd_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(u), (float)s,
      n_tiles, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: (n_tiles, 1024) of one type; u: (n_tiles, 1024) f32; s >= 1.
// Returns cudaGetLastError() after the launch.
int qsgd_f32(const void* x, const void* u, int s, long long n_tiles, void* out,
             void* stream) {
  return launch<float>(x, u, s, n_tiles, out, stream);
}

int qsgd_bf16(const void* x, const void* u, int s, long long n_tiles,
              void* out, void* stream) {
  return launch<__nv_bfloat16>(x, u, s, n_tiles, out, stream);
}

// The launch's grid and block for n_tiles, and the compiled kernel's
// attributes, per instantiated type. Each returns a cudaError_t.
int qsgd_f32_launch_config(long long n_tiles, int* grid, int* block) {
  return launch_config<float>(n_tiles, grid, block);
}

int qsgd_bf16_launch_config(long long n_tiles, int* grid, int* block) {
  return launch_config<__nv_bfloat16>(n_tiles, grid, block);
}

int qsgd_f32_attributes(int* num_regs, long long* shared_bytes,
                        long long* local_bytes, int* max_threads,
                        int* blocks_per_sm) {
  return attributes<float>(num_regs, shared_bytes, local_bytes, max_threads,
                           blocks_per_sm);
}

int qsgd_bf16_attributes(int* num_regs, long long* shared_bytes,
                         long long* local_bytes, int* max_threads,
                         int* blocks_per_sm) {
  return attributes<__nv_bfloat16>(num_regs, shared_bytes, local_bytes,
                                   max_threads, blocks_per_sm);
}

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
