// Blockwise exact-k SignTopK for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas kernel src/repro/kernels/sign_topk.py::sign_topk_blocks
// (body _sign_topk_kernel, shared math _block_compress and _row_threshold).
// Its plain PyTorch version is repro_torch/kernels/sign_topk.py::_block_compress.
//
// Per 1024-element tile (one row of the (n_tiles, 1024) inputs):
//   diff      = f32(x_half) - f32(x_hat)      (x_hat == NULL: diff = f32(x_half))
//   thr       = the exact k_b-th largest |diff|, by 31 one-bit radix passes
//               over the f32 bit patterns (|diff| has bit 31 clear, so the
//               pattern order is the numeric order and pass 31 never fires)
//   support   = |diff| > thr, then the lowest-index ties |diff| == thr until
//               k_b are chosen; zero lanes are never chosen (|support| <= k_b)
//   scale     = mean |diff| over the support (0 for an empty support)
//   q         = support ? (trig * scale) * (diff >= 0 ? +1 : -1) : 0,
//               rounded to the input type; every lane of q is written
//   x_hat_new = x_hat + q in the input type   (only when x_hat != NULL)
//   scale_out = trig * scale, f32             (only when scale_out != NULL)
//
// Bound: memory. The ensemble mode of the training main path (x_hat == NULL,
// f32) reads 4 B and writes 4 B per element: 19.8 GB per sync for 4 nodes of
// Qwen1.5-0.5B, 5.9 ms at 3.35 TB/s. The fused mode reads 8 B and writes 8 B.
//
// Design: one warp per tile, so no pass needs shared memory or
// __syncthreads. Lane l holds tile elements 128*c + 4*l + e (chunk c < 8,
// e < 4) in registers, loaded 16 B (f32) or 8 B (bf16) at a time, so each
// warp load covers 512 contiguous bytes. A radix pass is 32 register
// compares and one __reduce_add_sync. The tie rank is an index-ordered
// prefix count, chunk by chunk, by a warp inclusive scan (__shfl_up_sync);
// it runs only when the ties at thr outnumber the quota, which real data
// rarely gives. Blocks of 8 warps walk the tiles grid-stride. Offsets are
// 64-bit: the main path has 2.48e9 elements.

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

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
sign_topk_kernel(const T* __restrict__ x_half, const T* __restrict__ x_hat,
                 float trig, int k_b, long long n_tiles, T* __restrict__ q_out,
                 T* __restrict__ x_hat_out, float* __restrict__ scale_out) {
  const int lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;

  for (long long tile = first; tile < n_tiles; tile += stride) {
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

    // threshold: the largest pattern t with count(u >= t) >= k_b
    unsigned prefix = 0;
#pragma unroll 1
    for (int bit = 30; bit >= 0; --bit) {
      const unsigned cand = prefix | (1u << bit);
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) cnt += u[i] >= cand ? 1 : 0;
      if (__reduce_add_sync(kFull, cnt) >= k_b) prefix = cand;
    }
    const float thr = __uint_as_float(prefix);

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
        int incl = own;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int up = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += up;
        }
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

template <typename T>
int launch(const void* x_half, const void* x_hat, float trig, int k_b,
           long long n_tiles, void* q, void* x_hat_new, void* scale,
           void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n_tiles + kWarps - 1) / kWarps;
  const long long cap = 32LL * sms;
  const int grid = (int)(want < cap ? want : cap);
  sign_topk_kernel<T><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
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

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
