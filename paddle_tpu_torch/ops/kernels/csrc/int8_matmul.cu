// Weight-only int8 matmul for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/kernels/int8_matmul.py `int8_matmul` (Pallas body
// `_int8_kernel`). out = x @ dequant(W)^T (trans = 1, the GPT tied head with
// W stored (N, K)) or x @ dequant(W) (trans = 0, the Llama head with W stored
// (K, N)). dequant is exactly `(float(q) * (scale / 127.f))` rounded to x's
// dtype, with one per-tensor f32 scale; products accumulate in f32 and the
// output is written in x's dtype.
//
// What bounds it on the H100: the weight bytes. At the serving head's shapes
// (M <= 32 rows, K = 2048, N = 50304) the int8 weight is ~103 MB against
// ~0.1-4 MB of activations, and M <= 32 rows give at most 64 FLOPs per weight
// byte, below the ~295 FLOP/byte where bf16 tensor cores become the limit.
//
// What the design does about that (simple first, GEMV-like on CUDA cores):
//  - one output column per thread, 128 columns per block, so the weight is
//    streamed from device memory exactly once for up to 32 rows; with trans
//    each thread reads its column's K bytes 16 at a time (one 128-bit load)
//    and dequantizes them in registers: nothing dense is ever written back;
//  - x is staged through shared memory in K chunks of 128 (as f32) and read
//    as broadcasts, so the 32 rows' accumulators stay in registers;
//  - more than 32 rows run as further passes over the weight.
// On CUDA cores the 2*M*N*K FLOPs cost more than the weight read once M
// passes a few rows; moving the product to tensor cores is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // output columns per block
constexpr int kMT = 32;        // rows per pass
constexpr int kKC = 128;       // K chunk staged in shared memory
constexpr int kKV = 16;        // weight bytes per inner step

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// the reference's dequant, rounded to the activation dtype, back in f32
template <typename T>
__device__ __forceinline__ float dequant(int8_t qv, float s127) {
  return to_f(from_f<T>(static_cast<float>(qv) * s127));
}

template <typename T, bool TRANS>
__device__ __forceinline__ void load_w(const int8_t* __restrict__ w, int n,
                                       int N, int K, int k, int cnt,
                                       bool vec, float s127, float (&wf)[kKV]) {
  if (TRANS && vec && cnt == kKV) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(w + (size_t)n * K + k));
    const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j)  // little-endian: byte j of word c is k + 4c + j
        wf[4 * c + j] = dequant<T>(static_cast<int8_t>(words[c] >> (8 * j)), s127);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kKV; ++j) {
    if (j < cnt) {
      const size_t off = TRANS ? (size_t)n * K + k + j : (size_t)(k + j) * N + n;
      wf[j] = dequant<T>(w[off], s127);
    } else {
      wf[j] = 0.f;
    }
  }
}

template <typename T, bool TRANS>
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, T* __restrict__ out, int M, int N, int K,
    bool vec) {
  __shared__ __align__(16) float xs[kMT][kKC];
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const float s127 = scale[0] / 127.0f;
  for (int m0 = 0; m0 < M; m0 += kMT) {
    const int mc = min(kMT, M - m0);
    float acc[kMT];
#pragma unroll
    for (int m = 0; m < kMT; ++m) acc[m] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kKC) {
      const int kc = min(kKC, K - k0);
      __syncthreads();
      for (int i = threadIdx.x; i < kMT * kKC; i += kThreads) {
        const int m = i / kKC;
        const int k = i % kKC;
        xs[m][k] = (m < mc && k < kc) ? to_f(x[(size_t)(m0 + m) * K + k0 + k]) : 0.f;
      }
      __syncthreads();
      if (n < N) {
        for (int kk = 0; kk < kc; kk += kKV) {
          float wf[kKV];
          load_w<T, TRANS>(w, n, N, K, k0 + kk, min(kKV, kc - kk), vec, s127, wf);
#pragma unroll
          for (int m = 0; m < kMT; ++m) {
            if (m < mc) {
              const float4* xr = reinterpret_cast<const float4*>(&xs[m][kk]);
              float a = acc[m];
#pragma unroll
              for (int j4 = 0; j4 < kKV / 4; ++j4) {
                const float4 xv = xr[j4];
                a = fmaf(wf[4 * j4 + 0], xv.x, a);
                a = fmaf(wf[4 * j4 + 1], xv.y, a);
                a = fmaf(wf[4 * j4 + 2], xv.z, a);
                a = fmaf(wf[4 * j4 + 3], xv.w, a);
              }
              acc[m] = a;
            }
          }
        }
      }
    }
    if (n < N) {
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        if (m < mc) out[(size_t)(m0 + m) * N + n] = from_f<T>(acc[m]);
    }
  }
}

template <typename T, bool TRANS>
int launch(const void* x, const void* w, const void* scale, void* out, int M,
           int N, int K, cudaStream_t stream) {
  const int grid = (N + kThreads - 1) / kThreads;
  // 128-bit weight loads need 16-byte aligned rows
  const bool vec = K % kKV == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  int8_matmul_kernel<T, TRANS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<T*>(out), M, N, K, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (M, K); w int8 (N, K) if trans else
// (K, N); scale: one f32 on the device; out (M, N). All contiguous on the
// current device.
int pt_int8_matmul(int dtype, int trans, const void* x, const void* w,
                   const void* scale, void* out, int M, int N, int K,
                   void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return trans ? launch<float, true>(x, w, scale, out, M, N, K, s)
                 : launch<float, false>(x, w, scale, out, M, N, K, s);
  if (dtype == 1)
    return trans ? launch<__nv_bfloat16, true>(x, w, scale, out, M, N, K, s)
                 : launch<__nv_bfloat16, false>(x, w, scale, out, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
