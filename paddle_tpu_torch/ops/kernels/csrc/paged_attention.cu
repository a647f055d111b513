// Paged-attention decode read for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/kernels/paged_attention.py `paged_attention_rows`
// (Pallas body `_paged_kernel`). One decode step: each batch row attends with
// its one fresh query token over the K/V blocks its block table names, masked
// to positions <= pos[row]. GQA-grouped: query head h = g * rep + r reads KV
// head g. Output is (B, H * D) in q's dtype.
//
// What bounds it on the H100: device-memory bytes. Every live token's K and
// V row (2 * KV * D elements) is read once and used for 2 * H * D FLOPs, far
// below the ~295 FLOP/byte the card needs before compute matters.
//
// What the design does about that:
//  - one thread block per (row, KV head); the block reads `tables` and `pos`
//    itself and walks only the live blocks 0 .. pos / BS straight out of the
//    pool. Nothing is gathered into a dense context and trash blocks are never
//    read (the TPU kernel copied them only to keep dead context finite);
//  - 8 warps split the row's tokens; a warp reads one token's D-wide K and V
//    row with neighbouring lanes on neighbouring elements (coalesced) and
//    keeps an online softmax (running max, sum and output) in f32 registers
//    for each of the `rep` query heads that share the KV head, so the K/V of
//    a group is read once whatever rep is;
//  - the warps' partial results are merged once through shared memory.
// q.k is taken in f32 and the scale applied after the product, as
// `_grouped_attention` does; the scale arrives already rounded to q's dtype.
//
// Contract (as the reference's): the caller scatters the step's fresh K/V
// into the pool BEFORE this read, and pos[row] >= 0 (padding rows point at
// the trash block with pos 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRepD = 1024;  // rep * D bound of the shared merge buffer

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// REP: compile-time bound on the query heads per KV head (rep <= REP).
// EPL: elements of a D-wide row each lane holds (D <= 32 * EPL).
template <typename T, int REP, int EPL>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kpool,
    const T* __restrict__ vpool, const int* __restrict__ tables,
    const int* __restrict__ pos, T* __restrict__ out, int KV, int rep, int D,
    int BS, int MB, float scale) {
  __shared__ float s_m[kWarps][REP];
  __shared__ float s_l[kWarps][REP];
  __shared__ float s_acc[kWarps][kMaxRepD];

  const int b = blockIdx.x / KV;
  const int g = blockIdx.x % KV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int H = KV * rep;
  // a pos past the table's end reads no further than the table (the plain
  // path's mask then has every position live too)
  const int p = min(pos[b], MB * BS - 1);
  const int* table = tables + (size_t)b * MB;

  float qr[REP][EPL];
  float acc[REP][EPL];
  float m[REP];
  float l[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = lane + 32 * i;
      qr[r][i] = (r < rep && d < D)
                     ? to_f(q[((size_t)b * H + g * rep + r) * D + d]) : 0.f;
      acc[r][i] = 0.f;
    }
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int t = warp; t <= p; t += kWarps) {
    const int bid = table[t / BS];
    const size_t base = (((size_t)bid * BS + (t % BS)) * KV + g) * (size_t)D;
    float kr[EPL];
    float vr[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = lane + 32 * i;
      kr[i] = d < D ? to_f(kpool[base + d]) : 0.f;
      vr[i] = d < D ? to_f(vpool[base + d]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r < rep) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) s = fmaf(qr[r][i], kr[i], s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        s *= scale;
        const float mn = fmaxf(m[r], s);
        const float corr = expf(m[r] - mn);  // 0 on the first token
        const float pe = expf(s - mn);
        l[r] = l[r] * corr + pe;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[r][i] = fmaf(pe, vr[i], acc[r][i] * corr);
        m[r] = mn;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r < rep) {
      if (lane == 0) {
        s_m[warp][r] = m[r];
        s_l[warp][r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) s_acc[warp][r * D + d] = acc[r][i];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rep * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][r]);
    float den = 0.f;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no token holds m = -inf, l = 0, acc = 0
      const float c = s_m[w][r] == -INFINITY ? 0.f : expf(s_m[w][r] - mx);
      den = fmaf(s_l[w][r], c, den);
      num = fmaf(s_acc[w][idx], c, num);
    }
    out[(size_t)b * H * D + (size_t)(g * rep + r) * D + d] = from_f<T>(num / den);
  }
}

template <typename T, int REP, int EPL>
int launch(const void* q, const void* kpool, const void* vpool,
           const int* tables, const int* pos, void* out, int B, int KV,
           int rep, int D, int BS, int MB, float scale, cudaStream_t stream) {
  paged_attention_kernel<T, REP, EPL><<<B * KV, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), tables, pos, static_cast<T*>(out), KV, rep,
      D, BS, MB, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int REP>
int dispatch_epl(const void* q, const void* kpool, const void* vpool,
                 const int* tables, const int* pos, void* out, int B, int KV,
                 int rep, int D, int BS, int MB, float scale, cudaStream_t s) {
  const int epl = (D + 31) / 32;
  if (epl <= 1) return launch<T, REP, 1>(q, kpool, vpool, tables, pos, out, B, KV, rep, D, BS, MB, scale, s);
  if (epl <= 2) return launch<T, REP, 2>(q, kpool, vpool, tables, pos, out, B, KV, rep, D, BS, MB, scale, s);
  if (epl <= 4) return launch<T, REP, 4>(q, kpool, vpool, tables, pos, out, B, KV, rep, D, BS, MB, scale, s);
  if (epl <= 8) return launch<T, REP, 8>(q, kpool, vpool, tables, pos, out, B, KV, rep, D, BS, MB, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* kpool, const void* vpool,
             const int* tables, const int* pos, void* out, int B, int KV,
             int rep, int D, int BS, int MB, float scale, cudaStream_t s) {
  if (rep <= 1) return dispatch_epl<T, 1>(q, kpool, vpool, tables, pos, out, B, KV, rep, D, BS, MB, scale, s);
  if (rep <= 2) return dispatch_epl<T, 2>(q, kpool, vpool, tables, pos, out, B, KV, rep, D, BS, MB, scale, s);
  if (rep <= 4) return dispatch_epl<T, 4>(q, kpool, vpool, tables, pos, out, B, KV, rep, D, BS, MB, scale, s);
  if (rep <= 8) return dispatch_epl<T, 8>(q, kpool, vpool, tables, pos, out, B, KV, rep, D, BS, MB, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (B, KV*rep, D); kpool/vpool
// (NB, BS, KV, D) of one layer; tables (B, MB) int32; pos (B,) int32;
// out (B, KV*rep*D). All contiguous on the current device.
int pt_paged_attention(int dtype, const void* q, const void* kpool,
                       const void* vpool, const void* tables, const void* pos,
                       void* out, int B, int KV, int rep, int D, int BS,
                       int MB, float scale, void* stream) {
  if (B <= 0 || KV <= 0 || rep <= 0 || rep > 8 || D <= 0 || D > 256 ||
      rep * D > kMaxRepD || BS <= 0 || MB <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, kpool, vpool, t, p, out, B, KV, rep, D, BS, MB, scale, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, kpool, vpool, t, p, out, B, KV, rep, D, BS, MB, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
