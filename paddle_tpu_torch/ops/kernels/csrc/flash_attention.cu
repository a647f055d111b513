// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas flash kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   pt_flash_fwd  <- `_flash_fwd_inner` (:321; bodies `_fwd_kernel` :45,
//                    `_fwd_kernel_resident` :417, `_fwd_kernel_multi` :167) and
//                    `_flash_hd_fwd_inner` (:719; body `_fwd_kernel_hd` :574)
//   pt_flash_dq   <- the dQ halves of `_flash_bwd_inner` (:1038; `_dq_kernel`
//                    :847, `_dq_kernel_resident` :470, `_dq_kernel_multi` :219,
//                    dQ of `_dfused_kernel_resident` :966) and of
//                    `_flash_hd_bwd_inner` (:750; `_dq_kernel_hd` :625)
//   pt_flash_dkv  <- the dK/dV halves of the same (`_dkv_kernel` :894,
//                    `_dkv_kernel_resident` :512, `_dkv_kernel_multi` :267,
//                    `_dfused_kernel_resident`, `_dkv_kernel_hd` :669)
// The TPU needed a (B*H, T, D) route and a native (B, T, H*D) route because
// its transposes are HBM passes and its VMEM bounds the resident tiles. Here
// every kernel reads q, k, v (and dO) in the reference's (B, T, H, D) layout
// through strides, so one kernel covers both routes, any T != T_kv, ragged
// tails and any D <= 256 with D % 8 == 0, with no transpose and no padding.
//
// Function (as the reference's): S = scale * Q K^T in f32 with scale = 1/sqrt(D);
// entries with k_pos >= T_kv or, if causal, q_pos < k_pos (top-left aligned,
// also when T != T_kv) are set to -1e30; O = softmax(S) V with the row sum
// floored at 1e-30; LSE = max + log(sum) in f32, stored (B, H, T). Backward:
// P = exp(S - LSE), dP = dO V^T, dS = P * (dP - delta) with delta =
// rowsum(dO * O) computed by the caller; dQ = scale * dS K, dK = scale * dS^T Q,
// dV = P^T dO. In bf16 P and dS are rounded to bf16 before their products, as
// the reference's `.astype(v.dtype)` does; every sum is kept in f32.
//
// What bounds them on the H100: operations. At the training shape (B=2,
// T=2048, H=16, D=128, causal) the forward does ~3.4e10 FLOP (~0.035 ms at
// 989 TFLOP/s) against ~33 MB of q/k/v/o (~0.01 ms at 3.35 TB/s); the backward
// does ~2.5x the forward's FLOPs. So the products go to the tensor cores.
//
// What the design does about that (a right, simple kernel; wgmma, TMA and warp
// specialisation are later work):
//  - bf16: warp-level `mma.sync.m16n8k16` (bf16 in, f32 accumulate). One block
//    of 4 warps per (64-row tile, head, batch); each warp owns 16 rows. The
//    score accumulator is reused in registers as the A operand of the next
//    product (P V, dS K, P^T dO, dS^T Q), so no score tile touches shared or
//    device memory. Fragments come from shared memory by `ldmatrix` (its
//    `.trans` form for the operands read k-major: V, K, Q, dO), with tile
//    rows padded by 16 bytes so the reads are free of bank conflicts. The
//    streamed tiles are double-buffered: the next tile's `cp.async` runs
//    under the current tile's products.
//  - f32: the same tiling on CUDA cores (32-row tiles, 4 threads a row, fmaf),
//    the path that checks the algorithm to f32 precision.
//  - blocks run in parallel and carry nothing between them: a loop inside the
//    block walks the K/V tiles (forward, dQ) or the Q tiles (dK/dV). With
//    causal masking the loop stops at (forward, dQ) or starts from (dK/dV)
//    the diagonal, so dead tiles are never loaded, not only skipped.
//  - dK/dV are owned by the block of their key tile: no atomics, and the
//    result is the same from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the reference's _NEG_INF
constexpr int kThreads = 128;
constexpr int kTile = 64;   // rows of a q or k tile in the bf16 kernels
constexpr int kFTile = 32;  // rows of a q or k tile in the f32 kernels

struct Strides {
  long long b, t, h;  // element strides; the D axis is unit-stride
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out0;  // o (forward), dq, or dk
  void* out1;  // dv
  float* lse_out;
  Strides sq, sk, sv, sdo;
  int B, H, T, Tk, D;
  float scale;
  int causal;
};

__device__ __forceinline__ bool live(const Args& a, int qp, int kp) {
  return kp < a.Tk && qp < a.T && (!a.causal || qp >= kp);
}

// Copies rows [row0, row0 + ROWS) of head h of batch b of a (B, T, H, D)
// tensor into a row-major shared tile (leading dimension ld). Rows at or past
// `nrows` and columns at or past D are zero. 16 bytes per load.
template <typename T, int ROWS, int DM>
__device__ __forceinline__ void load_tile(T* tile, int ld, const T* base,
                                          const Strides& s, int b, int h,
                                          int row0, int nrows, int D) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = DM / VEC;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += kThreads) {
    const int r = idx / CH;
    const int c = (idx % CH) * VEC;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < nrows && c < D)
      val = *reinterpret_cast<const uint4*>(
          base + b * s.b + (long long)row * s.t + h * s.h + c);
    *reinterpret_cast<uint4*>(tile + r * ld + c) = val;
  }
}

// ---------------------------------------------------------------- bf16 ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without staging in registers; zero-filled when
// !pred (the source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// load_tile's rows and zero fill, issued as cp.async (completes at cp_wait).
template <int DM>
__device__ __forceinline__ void load_tile_async(bf16* tile, int ld,
                                                const bf16* base,
                                                const Strides& s, int b, int h,
                                                int row0, int nrows, int D) {
  constexpr int CH = DM / 8;
  for (int idx = threadIdx.x; idx < kTile * CH; idx += kThreads) {
    const int r = idx / CH;
    const int c = (idx % CH) * 8;
    const int row = row0 + r;
    const bool in = row < nrows && c < D;
    cp_async16(tile + r * ld + c,
               in ? base + b * s.b + (long long)row * s.t + h * s.h + c : base,
               in);
  }
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Fragment layout of m16n8k16 (g = lane / 4, tq = lane % 4):
//   A: a0 (row g, cols 2tq..2tq+1), a1 (row g+8, same), a2 (row g, cols
//      2tq+8..), a3 (row g+8, cols 2tq+8..)
//   B: b0 (k = 2tq..2tq+1, n = g), b1 (k = 2tq+8.., n = g)
//   C: c0, c1 (row g, cols 2tq, 2tq+1), c2, c3 (row g+8, same cols)
// ldmatrix hands out exactly these from 8x8 blocks of shared memory, each
// lane naming one 16-byte row; every tile row is padded by 16 bytes, so the
// 8 rows of a block fall in distinct banks.

// A fragment: rows m0..m0+16, cols k0..k0+16 of a row-major tile.
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* x, int ld,
                                       int m0, int k0, int lane) {
  ldsm_x4(a, x + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B fragments of n-tiles n0 and n0+8 (b[0..1], b[2..3]) with B[k][n] =
// y[n][k] for a row-major tile y whose rows are n (S = Q K^T: y = K).
__device__ __forceinline__ void frag_b_nt(uint32_t b[4], const bf16* y, int ld,
                                          int n0, int k0, int lane) {
  ldsm_x4(b, y + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}

// B fragments of n-tiles n0 and n0+8 with B[k][n] = z[k][n] for a row-major
// tile z whose rows are k (O = P V: z = V), transposed by ldmatrix.
__device__ __forceinline__ void frag_b_kn(uint32_t b[4], const bf16* z, int ld,
                                          int k0, int n0, int lane) {
  ldsm_x4_t(b, z + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// The C fragments of n-tiles 2kc and 2kc+1 of a 16x64 f32 accumulator are
// exactly the A fragment of its k-slice kc, rounded to bf16.
__device__ __forceinline__ void acc_as_a(uint32_t a[4], float (*s)[4], int kc) {
  a[0] = pack(s[2 * kc][0], s[2 * kc][1]);
  a[1] = pack(s[2 * kc][2], s[2 * kc][3]);
  a[2] = pack(s[2 * kc + 1][0], s[2 * kc + 1][1]);
  a[3] = pack(s[2 * kc + 1][2], s[2 * kc + 1][3]);
}

// acc (16 x 64) = X[m0..m0+16, :DM] * Y[0..64, :DM]^T, both row-major tiles.
template <int DM>
__device__ __forceinline__ void mm_nt(float (*acc)[4], const bf16* x,
                                      const bf16* y, int ld, int m0,
                                      int lane) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk) {
    uint32_t a[4];
    frag_a(a, x, ld, m0, kk * 16, lane);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; nt += 2) {
      uint32_t bb[4];
      frag_b_nt(bb, y, ld, nt * 8, kk * 16, lane);
      mma(acc[nt], a, bb[0], bb[1]);
      mma(acc[nt + 1], a, bb[2], bb[3]);
    }
  }
}

// out (16 x DM) += P (16 x 64, accumulator registers) * Z[0..64, :DM], Z a
// row-major tile.
template <int DM>
__device__ __forceinline__ void mm_acc(float (*out)[4], float (*p)[4],
                                       const bf16* z, int ld, int lane) {
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc) {
    uint32_t a[4];
    acc_as_a(a, p, kc);
#pragma unroll
    for (int dt = 0; dt < DM / 8; dt += 2) {
      uint32_t bb[4];
      frag_b_kn(bb, z, ld, kc * 16, dt * 8, lane);
      mma(out[dt], a, bb[0], bb[1]);
      mma(out[dt + 1], a, bb[2], bb[3]);
    }
  }
}

template <int DM>
__device__ __forceinline__ void store_rows(bf16* dst, float (*acc)[4],
                                           float mul0, float mul1, int row,
                                           int nrows, long long row_stride,
                                           int D, int tq) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= nrows) continue;
    const float mul = i ? mul1 : mul0;
#pragma unroll
    for (int dt = 0; dt < DM / 8; ++dt) {
      const int d = dt * 8 + 2 * tq;
      if (d < D)
        *reinterpret_cast<uint32_t*>(dst + r * row_stride + d) =
            pack(acc[dt][2 * i] * mul, acc[dt][2 * i + 1] * mul);
    }
  }
}

// Shared memory: row-major tiles of 64 rows; the streamed operands (K/V in
// the forward and dQ, Q/dO in dK/dV) are double-buffered so the next tile's
// cp.async runs under this tile's products.
template <int DM>
struct BfSmem {
  static constexpr int LD = DM + 8;
  static constexpr int TILE = kTile * LD;
  static constexpr size_t fwd = 5 * TILE * sizeof(bf16);
  static constexpr size_t dq = 6 * TILE * sizeof(bf16);
  static constexpr size_t dkv =
      6 * TILE * sizeof(bf16) + 4 * kTile * sizeof(float);
};

template <int DM>
__global__ void __launch_bounds__(kThreads) fwd_bf16(Args a) {
  using S = BfSmem<DM>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Kb = Qs + S::TILE;      // two K buffers
  bf16* Vb = Kb + 2 * S::TILE;  // two V buffers
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's tile rows: r0 and r0 + 8
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);

  int n_kv = (a.Tk + kTile - 1) / kTile;
  if (a.causal) n_kv = min(n_kv, (q0 + kTile - 1) / kTile + 1);
  load_tile_async<DM>(Qs, S::LD, q, a.sq, b, h, q0, a.T, a.D);
  load_tile_async<DM>(Kb, S::LD, k, a.sk, b, h, 0, a.Tk, a.D);
  load_tile_async<DM>(Vb, S::LD, v, a.sv, b, h, 0, a.Tk, a.D);
  cp_commit();

  float o[DM / 8][4];
#pragma unroll
  for (int dt = 0; dt < DM / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kTile;
    if (kt + 1 < n_kv) {
      const int nb = (kt + 1) & 1;
      load_tile_async<DM>(Kb + nb * S::TILE, S::LD, k, a.sk, b, h, k0 + kTile,
                          a.Tk, a.D);
      load_tile_async<DM>(Vb + nb * S::TILE, S::LD, v, a.sv, b, h, k0 + kTile,
                          a.Tk, a.D);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* Ks = Kb + (kt & 1) * S::TILE;
    const bf16* Vs = Vb + (kt & 1) * S::TILE;
    float s[kTile / 8][4];
    mm_nt<DM>(s, Qs, Ks, S::LD, warp * 16, lane);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = q0 + r0 + (e >> 1) * 8;
        const int kp = k0 + nt * 8 + 2 * tq + (e & 1);
        const float x = live(a, qp, kp) ? s[nt][e] * a.scale : kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - mn);
      m[i] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int dt = 0; dt < DM / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    mm_acc<DM>(o, s, Vs, S::LD, lane);
    __syncthreads();  // the next iteration's cp.async reuses this buffer
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float ls = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / ls;
    const int t = q0 + r0 + 8 * i;
    if (tq == 0 && t < a.T)
      a.lse_out[((long long)b * a.H + h) * a.T + t] = m[i] + logf(ls);
  }
  bf16* out = static_cast<bf16*>(a.out0) +
              (((long long)b * a.T + q0) * a.H + h) * a.D;
  store_rows<DM>(out, o, inv[0], inv[1], r0, a.T - q0, (long long)a.H * a.D,
                 a.D, tq);
}

template <int DM>
__global__ void __launch_bounds__(kThreads) dq_bf16(Args a) {
  using S = BfSmem<DM>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + S::TILE;
  bf16* Kb = dOs + S::TILE;     // two K buffers
  bf16* Vb = Kb + 2 * S::TILE;  // two V buffers
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + g;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);

  int n_kv = (a.Tk + kTile - 1) / kTile;
  if (a.causal) n_kv = min(n_kv, (q0 + kTile - 1) / kTile + 1);
  load_tile_async<DM>(Qs, S::LD, q, a.sq, b, h, q0, a.T, a.D);
  load_tile_async<DM>(dOs, S::LD, dout, a.sdo, b, h, q0, a.T, a.D);
  load_tile_async<DM>(Kb, S::LD, k, a.sk, b, h, 0, a.Tk, a.D);
  load_tile_async<DM>(Vb, S::LD, v, a.sv, b, h, 0, a.Tk, a.D);
  cp_commit();
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + r0 + 8 * i;
    const long long at = ((long long)b * a.H + h) * a.T + t;
    lse[i] = t < a.T ? a.lse_in[at] : 0.f;
    dl[i] = t < a.T ? a.delta[at] : 0.f;
  }

  float acc[DM / 8][4];
#pragma unroll
  for (int dt = 0; dt < DM / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kTile;
    if (kt + 1 < n_kv) {
      const int nb = (kt + 1) & 1;
      load_tile_async<DM>(Kb + nb * S::TILE, S::LD, k, a.sk, b, h, k0 + kTile,
                          a.Tk, a.D);
      load_tile_async<DM>(Vb + nb * S::TILE, S::LD, v, a.sv, b, h, k0 + kTile,
                          a.Tk, a.D);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* Ks = Kb + (kt & 1) * S::TILE;
    const bf16* Vs = Vb + (kt & 1) * S::TILE;
    float s[kTile / 8][4], dp[kTile / 8][4];
    mm_nt<DM>(s, Qs, Ks, S::LD, warp * 16, lane);
    mm_nt<DM>(dp, dOs, Vs, S::LD, warp * 16, lane);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = q0 + r0 + (e >> 1) * 8;
        const int kp = k0 + nt * 8 + 2 * tq + (e & 1);
        const float x = live(a, qp, kp) ? s[nt][e] * a.scale : kNegInf;
        const float p = expf(x - lse[e >> 1]);
        s[nt][e] = p * (dp[nt][e] - dl[e >> 1]);  // dS
      }
    mm_acc<DM>(acc, s, Ks, S::LD, lane);
    __syncthreads();
  }
  bf16* out = static_cast<bf16*>(a.out0) +
              (((long long)b * a.T + q0) * a.H + h) * a.D;
  store_rows<DM>(out, acc, a.scale, a.scale, r0, a.T - q0,
                 (long long)a.H * a.D, a.D, tq);
}

template <int DM>
__global__ void __launch_bounds__(kThreads) dkv_bf16(Args a) {
  using S = BfSmem<DM>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + S::TILE;
  bf16* Qb = Vs + S::TILE;        // two Q buffers
  bf16* dOb = Qb + 2 * S::TILE;   // two dO buffers
  float* lse_b = reinterpret_cast<float*>(dOb + 2 * S::TILE);  // 2 x kTile
  float* dl_b = lse_b + 2 * kTile;                              // 2 x kTile
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's key rows: r0 and r0 + 8
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int n_q = (a.T + kTile - 1) / kTile;
  const int first = a.causal ? k0 / kTile : 0;

  // Q/dO tile qt into buffer qt & 1 (cp.async), its LSE/delta by plain loads
  auto stage = [&](int qt) {
    const int nb = qt & 1, q0 = qt * kTile;
    load_tile_async<DM>(Qb + nb * S::TILE, S::LD, q, a.sq, b, h, q0, a.T, a.D);
    load_tile_async<DM>(dOb + nb * S::TILE, S::LD, dout, a.sdo, b, h, q0, a.T,
                        a.D);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int t = q0 + i;
      const long long at = ((long long)b * a.H + h) * a.T + t;
      lse_b[nb * kTile + i] = t < a.T ? a.lse_in[at] : 0.f;
      dl_b[nb * kTile + i] = t < a.T ? a.delta[at] : 0.f;
    }
  };
  load_tile_async<DM>(Ks, S::LD, k, a.sk, b, h, k0, a.Tk, a.D);
  load_tile_async<DM>(Vs, S::LD, v, a.sv, b, h, k0, a.Tk, a.D);
  if (first < n_q) stage(first);
  cp_commit();

  float dk[DM / 8][4], dv[DM / 8][4];
#pragma unroll
  for (int dt = 0; dt < DM / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  for (int qt = first; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    if (qt + 1 < n_q) stage(qt + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* Qs = Qb + (qt & 1) * S::TILE;
    const bf16* dOs = dOb + (qt & 1) * S::TILE;
    const float* lse_s = lse_b + (qt & 1) * kTile;
    const float* dl_s = dl_b + (qt & 1) * kTile;
    // transposed scores: rows are this warp's 16 keys, columns the 64 queries
    float p[kTile / 8][4], ds[kTile / 8][4];
    mm_nt<DM>(p, Ks, Qs, S::LD, warp * 16, lane);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + r0 + (e >> 1) * 8;
        const int qi = nt * 8 + 2 * tq + (e & 1);
        const float x = live(a, q0 + qi, kp) ? p[nt][e] * a.scale : kNegInf;
        p[nt][e] = expf(x - lse_s[qi]);
      }
    mm_acc<DM>(dv, p, dOs, S::LD, lane);  // dV += P^T dO
    mm_nt<DM>(ds, Vs, dOs, S::LD, warp * 16, lane);  // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * tq + (e & 1);
        ds[nt][e] = p[nt][e] * (ds[nt][e] - dl_s[qi]);
      }
    mm_acc<DM>(dk, ds, Qs, S::LD, lane);  // dK += dS^T Q
    __syncthreads();
  }
  cp_wait<0>();
  const long long rs = (long long)a.H * a.D;
  const long long off = (((long long)b * a.Tk + k0) * a.H + h) * a.D;
  store_rows<DM>(static_cast<bf16*>(a.out0) + off, dk, a.scale, a.scale, r0,
                 a.Tk - k0, rs, a.D, tq);
  store_rows<DM>(static_cast<bf16*>(a.out1) + off, dv, 1.f, 1.f, r0,
                 a.Tk - k0, rs, a.D, tq);
}

// ----------------------------------------------------------------- f32 ----
// 32-row tiles, 4 threads a row (thread s of a row holds columns s, s+4, ...);
// a dot product is reduced over the 4 lanes with two shuffles.

template <int DM>
struct F32Smem {
  static constexpr int LD = DM + 4;
  static constexpr int TILE = kFTile * LD;
  static constexpr size_t fwd = 3 * TILE * sizeof(float);
  static constexpr size_t dq = 4 * TILE * sizeof(float);
  static constexpr size_t dkv = (4 * TILE + 2 * kFTile) * sizeof(float);
};

template <int DM>
__device__ __forceinline__ float dot4(const float* x, const float* y, int s) {
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < DM / 4; ++i) d = fmaf(x[s + 4 * i], y[s + 4 * i], d);
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  return d;
}

template <int DM>
__device__ __forceinline__ void store_row_f32(float* dst, const float* acc,
                                              float mul, int s, int D) {
#pragma unroll
  for (int i = 0; i < DM / 4; ++i)
    if (s + 4 * i < D) dst[s + 4 * i] = acc[i] * mul;
}

template <int DM>
__global__ void __launch_bounds__(kThreads) fwd_f32(Args a) {
  using S = F32Smem<DM>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + S::TILE;
  float* Vs = Ks + S::TILE;
  const int q0 = blockIdx.x * kFTile, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 2, s = threadIdx.x & 3;
  const float* q = static_cast<const float*>(a.q);
  load_tile<float, kFTile, DM>(Qs, S::LD, q, a.sq, b, h, q0, a.T, a.D);
  int n_kv = (a.Tk + kFTile - 1) / kFTile;
  if (a.causal) n_kv = min(n_kv, (q0 + kFTile - 1) / kFTile + 1);
  float acc[DM / 4];
#pragma unroll
  for (int i = 0; i < DM / 4; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kFTile;
    __syncthreads();
    load_tile<float, kFTile, DM>(
        Ks, S::LD, static_cast<const float*>(a.k), a.sk, b, h, k0,
        a.Tk, a.D);
    load_tile<float, kFTile, DM>(
        Vs, S::LD, static_cast<const float*>(a.v), a.sv, b, h, k0,
        a.Tk, a.D);
    __syncthreads();
    float sc[kFTile];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kFTile; ++j) {
      const float d = dot4<DM>(Qs + r * S::LD, Ks + j * S::LD, s);
      sc[j] = live(a, q0 + r, k0 + j) ? d * a.scale : kNegInf;
      mx = fmaxf(mx, sc[j]);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    m = mn;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < kFTile; ++j) {
      sc[j] = expf(sc[j] - mn);
      ps += sc[j];
    }
    l = l * alpha + ps;
#pragma unroll
    for (int i = 0; i < DM / 4; ++i) {
      float o = acc[i] * alpha;
#pragma unroll
      for (int j = 0; j < kFTile; ++j)
        o = fmaf(sc[j], Vs[j * S::LD + s + 4 * i], o);
      acc[i] = o;
    }
  }
  const int t = q0 + r;
  if (t >= a.T) return;
  const float ls = fmaxf(l, 1e-30f);
  float* out = static_cast<float*>(a.out0) +
               (((long long)b * a.T + t) * a.H + h) * a.D;
#pragma unroll
  for (int i = 0; i < DM / 4; ++i)
    if (s + 4 * i < a.D) out[s + 4 * i] = acc[i] / ls;
  if (s == 0) a.lse_out[((long long)b * a.H + h) * a.T + t] = m + logf(ls);
}

template <int DM>
__global__ void __launch_bounds__(kThreads) dq_f32(Args a) {
  using S = F32Smem<DM>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + S::TILE;
  float* Ks = dOs + S::TILE;
  float* Vs = Ks + S::TILE;
  const int q0 = blockIdx.x * kFTile, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 2, s = threadIdx.x & 3;
  load_tile<float, kFTile, DM>(
      Qs, S::LD, static_cast<const float*>(a.q), a.sq, b, h, q0,
      a.T, a.D);
  load_tile<float, kFTile, DM>(
      dOs, S::LD, static_cast<const float*>(a.dout), a.sdo, b, h,
      q0, a.T, a.D);
  const int t = q0 + r;
  const long long at = ((long long)b * a.H + h) * a.T + t;
  const float lse = t < a.T ? a.lse_in[at] : 0.f;
  const float dl = t < a.T ? a.delta[at] : 0.f;
  int n_kv = (a.Tk + kFTile - 1) / kFTile;
  if (a.causal) n_kv = min(n_kv, (q0 + kFTile - 1) / kFTile + 1);
  float acc[DM / 4];
#pragma unroll
  for (int i = 0; i < DM / 4; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kFTile;
    __syncthreads();
    load_tile<float, kFTile, DM>(
        Ks, S::LD, static_cast<const float*>(a.k), a.sk, b, h, k0,
        a.Tk, a.D);
    load_tile<float, kFTile, DM>(
        Vs, S::LD, static_cast<const float*>(a.v), a.sv, b, h, k0,
        a.Tk, a.D);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < kFTile; ++j) {
      const float d = dot4<DM>(Qs + r * S::LD, Ks + j * S::LD, s);
      const float dp = dot4<DM>(dOs + r * S::LD, Vs + j * S::LD, s);
      const float x = live(a, t, k0 + j) ? d * a.scale : kNegInf;
      const float ds = expf(x - lse) * (dp - dl);
#pragma unroll
      for (int i = 0; i < DM / 4; ++i)
        acc[i] = fmaf(ds, Ks[j * S::LD + s + 4 * i], acc[i]);
    }
  }
  if (t < a.T)
    store_row_f32<DM>(static_cast<float*>(a.out0) +
                          (((long long)b * a.T + t) * a.H + h) * a.D,
                      acc, a.scale, s, a.D);
}

template <int DM>
__global__ void __launch_bounds__(kThreads) dkv_f32(Args a) {
  using S = F32Smem<DM>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + S::TILE;
  float* Qs = Vs + S::TILE;
  float* dOs = Qs + S::TILE;
  float* lse_s = dOs + S::TILE;
  float* dl_s = lse_s + kFTile;
  const int k0 = blockIdx.x * kFTile, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 2, s = threadIdx.x & 3;
  const int kp = k0 + r;
  load_tile<float, kFTile, DM>(
      Ks, S::LD, static_cast<const float*>(a.k), a.sk, b, h, k0,
      a.Tk, a.D);
  load_tile<float, kFTile, DM>(
      Vs, S::LD, static_cast<const float*>(a.v), a.sv, b, h, k0,
      a.Tk, a.D);
  const int n_q = (a.T + kFTile - 1) / kFTile;
  const int first = a.causal ? k0 / kFTile : 0;
  float dk[DM / 4], dv[DM / 4];
#pragma unroll
  for (int i = 0; i < DM / 4; ++i) dk[i] = dv[i] = 0.f;
  for (int qt = first; qt < n_q; ++qt) {
    const int q0 = qt * kFTile;
    __syncthreads();
    load_tile<float, kFTile, DM>(
        Qs, S::LD, static_cast<const float*>(a.q), a.sq, b, h, q0,
        a.T, a.D);
    load_tile<float, kFTile, DM>(
        dOs, S::LD, static_cast<const float*>(a.dout), a.sdo, b,
        h, q0, a.T, a.D);
    for (int i = threadIdx.x; i < kFTile; i += kThreads) {
      const int t = q0 + i;
      const long long at = ((long long)b * a.H + h) * a.T + t;
      lse_s[i] = t < a.T ? a.lse_in[at] : 0.f;
      dl_s[i] = t < a.T ? a.delta[at] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < kFTile; ++i) {
      const float d = dot4<DM>(Qs + i * S::LD, Ks + r * S::LD, s);
      const float dp = dot4<DM>(dOs + i * S::LD, Vs + r * S::LD, s);
      const float x = live(a, q0 + i, kp) ? d * a.scale : kNegInf;
      const float p = expf(x - lse_s[i]);
      const float ds = p * (dp - dl_s[i]);
#pragma unroll
      for (int c = 0; c < DM / 4; ++c) {
        dv[c] = fmaf(p, dOs[i * S::LD + s + 4 * c], dv[c]);
        dk[c] = fmaf(ds, Qs[i * S::LD + s + 4 * c], dk[c]);
      }
    }
  }
  if (kp >= a.Tk) return;
  const long long off = (((long long)b * a.Tk + kp) * a.H + h) * a.D;
  store_row_f32<DM>(static_cast<float*>(a.out0) + off, dk, a.scale, s, a.D);
  store_row_f32<DM>(static_cast<float*>(a.out1) + off, dv, 1.f, s, a.D);
}

// ------------------------------------------------------------- launch ----

template <typename K>
int launch(K* kernel, int rows, int tile, size_t smem, const Args& a,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((rows + tile - 1) / tile, a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <int DM>
int dispatch_dm(int dtype, Which w, const Args& a, cudaStream_t s) {
  using B = BfSmem<DM>;
  using F = F32Smem<DM>;
  if (dtype == 1) {
    if (w == kFwd) return launch(fwd_bf16<DM>, a.T, kTile, B::fwd, a, s);
    if (w == kDq) return launch(dq_bf16<DM>, a.T, kTile, B::dq, a, s);
    return launch(dkv_bf16<DM>, a.Tk, kTile, B::dkv, a, s);
  }
  if (w == kFwd) return launch(fwd_f32<DM>, a.T, kFTile, F::fwd, a, s);
  if (w == kDq) return launch(dq_f32<DM>, a.T, kFTile, F::dq, a, s);
  return launch(dkv_f32<DM>, a.Tk, kFTile, F::dkv, a, s);
}

int dispatch(int dtype, Which w, Args& a, const long long* strides, int n,
             cudaStream_t s) {
  if (a.B <= 0 || a.H <= 0 || a.T <= 0 || a.Tk <= 0 || a.D <= 0 ||
      a.D > 256 || a.D % 8 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides* dst[4] = {&a.sq, &a.sk, &a.sv, &a.sdo};
  for (int i = 0; i < n; ++i)
    *dst[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  if (a.D <= 64) return dispatch_dm<64>(dtype, w, a, s);
  if (a.D <= 128) return dispatch_dm<128>(dtype, w, a, s);
  return dispatch_dm<256>(dtype, w, a, s);
}

Args make_args(const void* q, const void* k, const void* v, int B, int H,
               int T, int Tk, int D, float scale, int causal) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.B = B;
  a.H = H;
  a.T = T;
  a.Tk = Tk;
  a.D = D;
  a.scale = scale;
  a.causal = causal;
  return a;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (B, T, H, D), k/v (B, Tk, H, D) read
// through `strides` (b, t, h element strides of q, k, v; the D axis is
// unit-stride and each row start 16-byte aligned). Writes o (B, T, H, D)
// contiguous in q's dtype and lse (B, H, T) float32.
int pt_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                 void* o, void* lse, const long long* strides, int B, int H,
                 int T, int Tk, int D, float scale, int causal, void* stream) {
  Args a = make_args(q, k, v, B, H, T, Tk, D, scale, causal);
  a.out0 = o;
  a.lse_out = static_cast<float*>(lse);
  return dispatch(dtype, kFwd, a, strides, 3, static_cast<cudaStream_t>(stream));
}

// As pt_flash_fwd, plus dout (B, T, H, D) through the 4th stride triple,
// lse and delta (B, H, T) float32 contiguous; writes dq (B, T, H, D)
// contiguous.
int pt_flash_dq(int dtype, const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta, void* dq,
                const long long* strides, int B, int H, int T, int Tk, int D,
                float scale, int causal, void* stream) {
  Args a = make_args(q, k, v, B, H, T, Tk, D, scale, causal);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out0 = dq;
  return dispatch(dtype, kDq, a, strides, 4, static_cast<cudaStream_t>(stream));
}

// As pt_flash_dq; writes dk and dv (B, Tk, H, D) contiguous.
int pt_flash_dkv(int dtype, const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, const long long* strides, int B, int H,
                 int T, int Tk, int D, float scale, int causal, void* stream) {
  Args a = make_args(q, k, v, B, H, T, Tk, D, scale, causal);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out0 = dk;
  a.out1 = dv;
  return dispatch(dtype, kDkv, a, strides, 4, static_cast<cudaStream_t>(stream));
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
