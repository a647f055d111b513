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
// byte, far below the ~295 FLOP/byte where bf16 tensor cores become the
// limit. The least time is the weight read at HBM rate (~31 us); the
// dequant and the products have to hide under it.
//
// bf16, `int8_matmul_mma` (the serving path):
//  - operands swapped: out^T (N x M) = dequant(W) (N x K) . x^T (K x M). A
//    tile of 16 weight rows is the A operand of `mma.sync.m16n8k16` (bf16,
//    f32 sums) and up to 32 rows of x are its narrow N side (M padded to a
//    multiple of 8 and masked at the store; more rows run further passes
//    over the weight, one launch each). `mma.sync` and not `wgmma`: at
//    M = 32 the product is ~50 MFLOP per SM, which `mma.sync` finishes
//    inside the bytes bound, and its register A operand takes the dequant's
//    output directly, in any k order (see below); `wgmma` would read x from
//    shared memory in its fixed k order.
//  - each block owns 384 contiguous weight rows (12 warps of two 16-row
//    tiles: 131 blocks at N = 50304, one wave of one block per SM) and
//    walks K outermost, so x is read from L2 once per block. The weight and
//    x stream through a 4-stage ring of 128-byte K chunks filled by 16-byte
//    `cp.async` (zero-filled past N and K), so each weight row is read in
//    contiguous 128-byte runs and three stages (~170 KB) are in flight while
//    the fourth is consumed. 12 warps rather than 8 hide the MMAs behind the
//    dequant; 64-byte chunks with a deeper ring were slower (PERF.md).
//  - the MMA's k order is permuted: lane t of a quad owns the 16-byte
//    pieces t + 4v of each of its rows in a chunk, one shared load each
//    (odd rows swap the halves of every 128 bytes, so no two lanes of a
//    load phase share a bank), and reads x with the same permutation, so
//    the sums are unchanged.
//  - the dequant is exact and cheap: a byte goes into the mantissa of 2^23
//    by `__byte_perm` (after one XOR per 4 bytes that turns q into q + 128),
//    one FADD removes 2^23 + 128, leaving float(q) exactly, one FMUL by
//    scale / 127 and a paired round to bf16 (`__floats2bfloat162_rn`), which
//    is bit for bit the reference's rounding. No I2F conversion is issued.
//  - trans = 0 (W stored (K, N)) gives each lane four adjacent weight rows
//    as its A rows (the row a fragment slot stands for is free, as long as
//    a quad agrees), so one 4-byte shared load of a k row holds all four,
//    and a 4 x 4 byte transpose (8 `__byte_perm`) of four such loads gives
//    each row 4 consecutive k: the same shared-memory wavefronts as
//    trans = 1's 16-byte loads, plus 0.5 PRMT a weight. The 16-byte pieces
//    of a k row are XOR-swizzled by k so the four lanes of a quad read
//    different banks.
//  - the accumulators are rounded to bf16 and staged through shared memory,
//    so each output row is written as contiguous 16-byte runs.
// f32 (checks only; a tensor-core f32 product would be TF32) keeps the CUDA
// core kernel `int8_matmul_kernel`: one output column per thread, x staged
// through shared memory as f32, f32 FMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// f32: one output column per thread on CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;  // output columns per block
constexpr int kMT = 32;        // rows per pass
constexpr int kKC = 128;       // K chunk staged in shared memory
constexpr int kKV = 16;        // weight bytes per inner step

template <bool TRANS>
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
        wf[4 * c + j] = static_cast<float>(static_cast<int8_t>(words[c] >> (8 * j))) * s127;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kKV; ++j) {
    if (j < cnt) {
      const size_t off = TRANS ? (size_t)n * K + k + j : (size_t)(k + j) * N + n;
      wf[j] = static_cast<float>(w[off]) * s127;
    } else {
      wf[j] = 0.f;
    }
  }
}

template <bool TRANS>
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ out, int M, int N,
    int K, bool vec) {
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
        xs[m][k] = (m < mc && k < kc) ? x[(size_t)(m0 + m) * K + k0 + k] : 0.f;
      }
      __syncthreads();
      if (n < N) {
        for (int kk = 0; kk < kc; kk += kKV) {
          float wf[kKV];
          load_w<TRANS>(w, n, N, K, k0 + kk, min(kKV, kc - kk), vec, s127, wf);
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
        if (m < mc) out[(size_t)(m0 + m) * N + n] = acc[m];
    }
  }
}

template <bool TRANS>
int launch_f32(const void* x, const void* w, const void* scale, void* out,
               int M, int N, int K, cudaStream_t stream) {
  const int grid = (N + kThreads - 1) / kThreads;
  // 128-bit weight loads need 16-byte aligned rows
  const bool vec = K % kKV == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  int8_matmul_kernel<TRANS><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out), M, N, K, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor-core products on a pipelined weight stream
// ---------------------------------------------------------------------------

constexpr int kWarps = 12;
constexpr int kTThreads = kWarps * 32;
constexpr int kStages = 4;
constexpr int kC = 128;            // K bytes (and x elements) per ring stage
static_assert(kC % 128 == 0, "a lane owns 16-byte pieces t + 4v of a row");
constexpr int kXPitch = kC + 8;    // x elements per row in a stage
constexpr int kMP = 32;            // x rows per pass
constexpr int kR = 2;              // 16-row tiles per warp
constexpr int kBN = 16 * kWarps * kR;  // weight rows per block
constexpr float kMagic = 8388736.0f;  // 2^23 + 128
constexpr int kStageBytes = kBN * kC + kMP * kXPitch * 2;
constexpr int kSmemBytes = kStages * kStageBytes;
static_assert(kSmemBytes <= 232448,
              "the ring must fit the shared memory a block can take");
static_assert(kBN % 128 == 0, "trans = 0 swizzles groups of 8 pieces of 16");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared (L2 only); the bytes past `src_bytes` are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes 2h and 2h + 1 of u (= 4 int8 values XOR 0x80808080, so each byte is
// q + 128) dequantized and packed as bf16x2 (byte 2h in the low half):
// bf16(float(q) * s127), exactly. float(q) comes from the byte placed in the
// mantissa of 2^23 minus (2^23 + 128), both exact for |q| <= 128.
__device__ __forceinline__ uint32_t dequant2(uint32_t u, int h, float s127) {
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + 2 * h));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 + 2 * h));
  const __nv_bfloat162 v =
      __floats2bfloat162_rn((f0 - kMagic) * s127, (f1 - kMagic) * s127);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Where 16-byte piece p of weight row r sits in a stage (trans = 1): odd
// rows swap the two halves of every 128 bytes, so the lanes of rows g and
// g + 1 read different banks.
__host__ __device__ constexpr int wpiece(int p, int r) {
  return p ^ ((r & 1) << 2);
}

// Where 16-byte piece p of k row kr sits in a stage (trans = 0): the four
// lanes t of a quad read k rows 16t + ..; XOR-ing the piece by 2t puts them
// on different banks.
__host__ __device__ constexpr int kpiece(int p, int kr) {
  return p ^ (((kr >> 4) & 3) << 1);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One ring stage: the block's weight rows x kC bytes of K from k0, and the
// pass's x rows x kC elements. 16-byte copies where the rows allow them
// (wvec / xvec), else plain loads; zeros past N, K and M.
template <int NT, bool TRANS>
__device__ __forceinline__ void load_stage(
    uint8_t* ws, bf16* xs, const int8_t* __restrict__ w,
    const bf16* __restrict__ x, int n0, int k0, int M, int N, int K,
    bool wvec, bool xvec) {
  const int tid = threadIdx.x;
  if (TRANS) {  // W (N, K): each row's chunk is kC contiguous bytes
    for (int p = tid; p < kBN * (kC / 16); p += kTThreads) {
      const int r = p / (kC / 16), pc = p % (kC / 16);
      const int n = n0 + r, k = k0 + pc * 16;
      uint8_t* dst = ws + r * kC + wpiece(pc, r) * 16;
      if (wvec) {
        const bool ok = n < N && k < K;
        cp_async16(dst, ok ? w + (size_t)n * K + k : w, ok ? 16 : 0);
      } else {
        alignas(16) int8_t b[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          b[i] = (n < N && k + i < K) ? w[(size_t)n * K + k + i] : 0;
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(b);
      }
    }
  } else {  // W (K, N): kC rows of kBN contiguous bytes, pieces swizzled
    for (int p = tid; p < kC * (kBN / 16); p += kTThreads) {
      const int kr = p / (kBN / 16), pc = p % (kBN / 16);
      const int k = k0 + kr, n = n0 + pc * 16;
      uint8_t* dst = ws + kr * kBN + kpiece(pc, kr) * 16;
      if (wvec) {
        const bool ok = k < K && n < N;
        cp_async16(dst, ok ? w + (size_t)k * N + n : w, ok ? 16 : 0);
      } else {
        alignas(16) int8_t b[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          b[i] = (k < K && n + i < N) ? w[(size_t)k * N + n + i] : 0;
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(b);
      }
    }
  }
  for (int p = tid; p < NT * 8 * (kC / 8); p += kTThreads) {
    const int m = p / (kC / 8), pc = p % (kC / 8);
    const int k = k0 + pc * 8;
    bf16* dst = xs + m * kXPitch + pc * 8;
    if (xvec) {
      const bool ok = m < M && k < K;
      cp_async16(dst, ok ? x + (size_t)m * K + k : x, ok ? 16 : 0);
    } else {
      alignas(16) bf16 b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        b[i] = (m < M && k + i < K) ? x[(size_t)m * K + k + i]
                                    : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(b);
    }
  }
}

// trans = 0: the 16 weight bytes at the chunk's k offsets [kk, kk + 16) of
// the 4 adjacent rows n, n + 1, n + 2, n + 3 (n a multiple of 4), one uint4
// a row (byte i of the uint4 is k offset kk + i). Each 4-byte read takes the
// four rows at one k; a 4 x 4 byte transpose of four such reads gives each
// row 4 consecutive k.
__device__ __forceinline__ void gather_kn(const uint8_t* ws, int n, int kk,
                                          uint4 (&rows)[4]) {
  uint32_t v[4][4];  // [row][word]
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = kk + 4 * s + i;
      l[i] = *reinterpret_cast<const uint32_t*>(
          ws + kr * kBN + kpiece(n >> 4, kr) * 16 + (n & 15));
    }
    const uint32_t t0 = __byte_perm(l[0], l[1], 0x5140);
    const uint32_t t1 = __byte_perm(l[0], l[1], 0x7362);
    const uint32_t t2 = __byte_perm(l[2], l[3], 0x5140);
    const uint32_t t3 = __byte_perm(l[2], l[3], 0x7362);
    v[0][s] = __byte_perm(t0, t2, 0x5410);
    v[1][s] = __byte_perm(t0, t2, 0x7632);
    v[2][s] = __byte_perm(t1, t3, 0x5410);
    v[3][s] = __byte_perm(t1, t3, 0x7632);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    rows[j] = make_uint4(v[j][0], v[j][1], v[j][2], v[j][3]);
}

// The block row that the lane's A fragment row g + 8h of tile r stands for.
// trans = 1: row wrow + 16r + 8h + g. trans = 0: the lane's four rows are
// adjacent, wrow + 4g + 2r + h, so one 4-byte read of a k row serves all.
// Either way it depends on g, not t, so a quad agrees on its rows.
template <bool TRANS>
__device__ __forceinline__ int frag_row(int wrow, int g, int r, int h) {
  return TRANS ? wrow + 16 * r + 8 * h + g : wrow + 4 * g + 2 * r + h;
}

// One pass: out rows [0, M) (M <= 32, NT = ceil(M / 8)) for the block's
// weight rows. Lane (g, t) = (lane / 4, lane % 4): in the chunk's k-step
// (v, s), MMA k slots {2t, 2t+1, 2t+8, 2t+9} hold the chunk's bytes
// 16t + 64v + 4s + {0, 1, 2, 3}, for A (the rows `frag_row` names) and for
// B (x row 8j + g) alike.
template <int NT, bool TRANS>
__global__ void __launch_bounds__(kTThreads, 1) int8_matmul_mma(
    const bf16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, bf16* __restrict__ out, int M, int N,
    int K, bool wvec, bool xvec, bool ovec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int wrow = warp * 16 * kR;  // the warp's first row in the block
  const float s127 = scale[0] / 127.0f;
  const int chunks = (K + kC - 1) / kC;

  auto stage_w = [&](int s) { return smem + s * kStageBytes; };
  auto stage_x = [&](int s) {
    return reinterpret_cast<bf16*>(smem + s * kStageBytes + kBN * kC);
  };

  float acc[kR][NT][4];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][j][i] = 0.f;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks)
      load_stage<NT, TRANS>(stage_w(c), stage_x(c), w, x, n0, c * kC, M, N,
                            K, wvec, xvec);
    cp_commit();
  }

#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    cp_wait<kStages - 2>();
    __syncthreads();  // stage c landed for all; stage c - 1 is free again
    const int cn = c + kStages - 1;
    if (cn < chunks)
      load_stage<NT, TRANS>(stage_w(cn % kStages), stage_x(cn % kStages), w,
                            x, n0, cn * kC, M, N, K, wvec, xvec);
    cp_commit();

    const uint8_t* ws = stage_w(c % kStages);
    const bf16* xs = stage_x(c % kStages);
#pragma unroll
    for (int v = 0; v < kC / 64; ++v) {
      const int kk = 16 * t + 64 * v;  // this lane's 16 k offsets
      uint4 xb[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* xr = xs + (8 * j + g) * kXPitch + kk;
        xb[j][0] = *reinterpret_cast<const uint4*>(xr);
        xb[j][1] = *reinterpret_cast<const uint4*>(xr + 8);
      }
      uint4 wr[2 * kR];  // [2r + h]: the 16 bytes of row frag_row(.., r, h)
      if (TRANS) {
#pragma unroll
        for (int i = 0; i < 2 * kR; ++i) {
          const int row = frag_row<TRANS>(wrow, g, i >> 1, i & 1);
          wr[i] = *reinterpret_cast<const uint4*>(
              ws + row * kC + wpiece(kk / 16, row) * 16);
        }
      } else {
        static_assert(2 * kR == 4, "gather_kn reads 4 adjacent rows");
        gather_kn(ws, frag_row<TRANS>(wrow, g, 0, 0), kk, wr);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t qa = word(wr[2 * r], s) ^ 0x80808080u;
          const uint32_t qb = word(wr[2 * r + 1], s) ^ 0x80808080u;
          const uint32_t a[4] = {dequant2(qa, 0, s127), dequant2(qb, 0, s127),
                                 dequant2(qa, 1, s127), dequant2(qb, 1, s127)};
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma(acc[r][j], a, word(xb[j][s >> 1], 2 * (s & 1)),
                word(xb[j][s >> 1], 2 * (s & 1) + 1));
        }
      }
    }
  }

  // epilogue: bf16 accumulators through shared memory, then each output
  // row's kBN columns as contiguous 16-byte runs
  cp_wait<0>();
  __syncthreads();
  constexpr int OP = kBN + 8;  // output pitch (elements) in shared memory
  bf16* os = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row0 = frag_row<TRANS>(wrow, g, r, 0);
    const int row1 = frag_row<TRANS>(wrow, g, r, 1);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int m = 8 * j + 2 * t;
      os[m * OP + row0] = __float2bfloat16_rn(acc[r][j][0]);
      os[(m + 1) * OP + row0] = __float2bfloat16_rn(acc[r][j][1]);
      os[m * OP + row1] = __float2bfloat16_rn(acc[r][j][2]);
      os[(m + 1) * OP + row1] = __float2bfloat16_rn(acc[r][j][3]);
    }
  }
  __syncthreads();
  for (int p = tid; p < M * (kBN / 8); p += kTThreads) {
    const int m = p / (kBN / 8), pc = p % (kBN / 8);
    const int n = n0 + pc * 8;
    const bf16* src = os + m * OP + pc * 8;
    bf16* dst = out + (size_t)m * N + n;
    if (ovec && n + 8 <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < 8 && n + i < N; ++i) dst[i] = src[i];
    }
  }
}

// Lets this instantiation take its dynamic shared memory, set once per device.
template <int NT, bool TRANS>
int allow_smem() {
  static std::mutex mu;
  static std::set<int> done;  // devices
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return static_cast<int>(e);
  std::lock_guard<std::mutex> hold(mu);
  if (done.count(dev)) return 0;
  e = cudaFuncSetAttribute(int8_matmul_mma<NT, TRANS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (!e) done.insert(dev);
  return static_cast<int>(e);
}

template <int NT, bool TRANS>
int launch_pass(const bf16* x, const int8_t* w, const float* scale, bf16* out,
                int M, int N, int K, cudaStream_t stream) {
  int e = allow_smem<NT, TRANS>();
  if (e) return e;
  const bool wvec = (TRANS ? K : N) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool xvec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool ovec = N % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int grid = (N + kBN - 1) / kBN;
  int8_matmul_mma<NT, TRANS><<<grid, kTThreads, kSmemBytes, stream>>>(
      x, w, scale, out, M, N, K, wvec, xvec, ovec);
  return static_cast<int>(cudaGetLastError());
}

template <bool TRANS>
int launch_bf16(const void* x, const void* w, const void* scale, void* out,
                int M, int N, int K, cudaStream_t s) {
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  for (int m0 = 0; m0 < M; m0 += kMP) {  // one pass over the weight per 32 rows
    const int mp = M - m0 < kMP ? M - m0 : kMP;
    const bf16* xp = static_cast<const bf16*>(x) + (size_t)m0 * K;
    bf16* op = static_cast<bf16*>(out) + (size_t)m0 * N;
    int e;
    switch ((mp + 7) / 8) {
      case 1: e = launch_pass<1, TRANS>(xp, wp, sp, op, mp, N, K, s); break;
      case 2: e = launch_pass<2, TRANS>(xp, wp, sp, op, mp, N, K, s); break;
      case 3: e = launch_pass<3, TRANS>(xp, wp, sp, op, mp, N, K, s); break;
      default: e = launch_pass<4, TRANS>(xp, wp, sp, op, mp, N, K, s); break;
    }
    if (e) return e;
  }
  return 0;
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
    return trans ? launch_f32<true>(x, w, scale, out, M, N, K, s)
                 : launch_f32<false>(x, w, scale, out, M, N, K, s);
  if (dtype == 1)
    return trans ? launch_bf16<true>(x, w, scale, out, M, N, K, s)
                 : launch_bf16<false>(x, w, scale, out, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
