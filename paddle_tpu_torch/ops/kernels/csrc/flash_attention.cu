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
// every entry reads q, k, v (and dO) in the reference's (B, T, H, D) layout
// through strides, so each entry covers both routes, any T != T_kv, ragged
// tails and any D <= 256 with D % 8 == 0, with no transpose and no padding.
//
// Function (as the reference's): S = scale * Q K^T in f32 with scale = 1/sqrt(D);
// entries with k_pos >= T_kv or, if causal, q_pos < k_pos (top-left aligned,
// also when T != T_kv) are set to -1e30; O = softmax(S) V with the row sum
// floored at 1e-30; LSE = max + log(sum) in f32, stored (B, H, T). Backward:
// P = exp(S - LSE), dP = dO V^T, dS = P * (dP - delta) with delta =
// rowsum(dO * O) computed by the caller; dQ = scale * dS K, dK = scale * dS^T Q,
// dV = P^T dO. In bf16 P and dS are rounded to bf16 before their products, as
// the reference's `.astype(v.dtype)` does; every sum is kept in f32. The
// bf16 Hopper kernels take their exponentials from ex2.approx.ftz (about 2
// ulp of f32, subnormal results flushed to zero): far below the bf16
// rounding of P and dS (2^-9 relative) that follows, and the dropped
// subnormals are below bf16's own resolution next to the row's largest P.
//
// What bounds them on the H100: operations. At the training shape (B=2,
// T=2048, H=16, D=128, causal) the forward does 4*D*live = 3.4e10 FLOP
// (live = B*H*T*(T+1)/2 scores; 0.0348 ms at 989 TFLOP/s) against ~33 MB of
// q/k/v/o (~0.01 ms at 3.35 TB/s); dQ does 1.5x and dK/dV 2x the forward's
// FLOPs (0.0521 and 0.0695 ms). So the products go to the tensor cores, and
// the softmax between them must not leave those idle.
//
// Which kernel runs, a static rule by dtype and head width, decided before
// the launch:
//  - bf16 with D <= 128 (instantiations DM = 64, 128): the Hopper kernels
//    `fwd_wgmma`, `dq_wgmma` and `dkv_wgmma` below;
//  - bf16 with 128 < D <= 256 (DM = 256): warp-level `mma.sync` kernels
//    (`fwd_bf16`, `dq_bf16`, `dkv_bf16`). No path of the port has D > 128;
//    a wgmma tiling of D = 256 without spills is open work;
//  - f32: CUDA-core kernels (`*_f32`) that check the algorithm to f32
//    precision.
//
// What the Hopper design does about the operation bound:
//  - wgmma: two consumer warpgroups, each owning 64 rows (q rows in the
//    forward and dQ, key rows in dK/dV), run m64nNk16 products with their
//    f32 accumulators in registers. S = Q K^T, dP = dO V^T, S^T = K Q^T and
//    dP^T = V dO^T read both operands from shared memory, K-major; O += P V,
//    dQ += dS K, dV += P^T dO and dK += dS^T Q take P, dS, P^T or dS^T from
//    the score accumulator rounded to bf16 in registers (the m64
//    accumulator's per-warp layout is the A operand's) and B from shared
//    memory MN-major (transpose-B). No score tile touches shared or device
//    memory.
//  - TMA: one producer thread loads every tile with cp.async.bulk.tensor
//    from a 4-D tensor map (D, H, T, B) built on the host from the
//    wrapper's strides, so the strided q/k/v views of the fused QKV output
//    go in without a copy. Boxes are 64 columns wide (one 128-byte swizzled
//    panel; D = 128 is two panels) and zero-filled past D, T and T_kv, which
//    covers ragged tails and any D % 8 == 0 below the instantiation's
//    width. Completion is signalled on mbarriers: Q (forward), Q and dO
//    (dQ) or K and V (dK/dV) once, the streamed tiles through a 2-stage
//    full/empty ring (dQ streams 64-row K/V tiles, so S, dP and dQ fit in
//    32 + 32 + 64 registers a thread at D = 128).
//    The producer warpgroup gives its registers up (setmaxnreg 24) so the
//    consumers can hold 240; ptxas reports no spills.
//  - The softmax runs in the log2 domain: ex2.approx with scale*log2(e)
//    folded into one multiply; LSE = m*ln(2) + log(l) is stored in natural
//    log.
//    The causal/edge mask (`live`) is evaluated only on tiles that cross the
//    diagonal, T or T_kv.
//  - Blocks run in parallel and carry nothing between them: a loop inside
//    the block walks the K/V tiles (forward, dQ) or the Q tiles (dK/dV);
//    with causal masking it stops at (forward, dQ) or starts from (dK/dV)
//    the diagonal, so dead tiles are never loaded. The heaviest causal
//    blocks are scheduled first (the last q tiles of the forward and dQ,
//    the first key tiles of dK/dV) so that no long block is left for the
//    tail.
//  - dQ is owned by the block of its q tile, dK/dV by the block of their
//    key tile: no atomics, and the result is bitwise the same from run to
//    run.
//
// The mma.sync kernels (bf16 above D = 128): one
// block of 4 warps per (64-row tile, head, batch), each warp owning 16
// rows; fragments from padded shared tiles by `ldmatrix` (`.trans` for the
// k-major operands), the streamed tiles double-buffered by `cp.async`.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

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

// ------------------------------------------------- bf16, Hopper (wgmma) ----
// The forward, dQ and dK/dV kernels for D <= 128: TMA loads into 128-byte-swizzled
// shared memory signalled through mbarriers, one producer warp, two consumer
// warpgroups of 64 rows each running wgmma with f32 accumulators in registers.

constexpr int kWgThreads = 384;  // warpgroups 0-1 consume, warpgroup 2 loads
constexpr int kPanel = 64;       // bf16 columns of one 128-byte panel
constexpr int kRowBytes = 128;   // one panel row in shared memory
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the special-function unit (ex2.approx.ftz: ~2 ulp, subnormal
// results flushed to 0); faster than exp2f in these kernels (PERF.md §6,
// measured with flash_ab.py).
__device__ __forceinline__ float fexp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival (release: this thread's shared stores are seen by the waiters).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also makes the phase wait for `bytes` of TMA writes.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map (D, H, rows, B) at coordinates (c0, c1, c2,
// c3), innermost first; completion is counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties every accumulator register to the preceding wait, so that no use of
// it is scheduled before the asynchronous product has written it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: bits 0-13
// start address >> 4, 16-29 leading byte offset >> 4, 32-45 stride byte
// offset >> 4, 62-63 layout (1: 128-byte swizzle). Tiles are stored as
// 128-byte rows (64 bf16 columns, one TMA panel), 8-row groups 1024 bytes
// apart (the stride offset). A K-major operand steps 16 columns by adding 32
// bytes to the start inside a panel and ignores `lead`; an MN-major one steps
// 16 rows by adding 2048 bytes, and `lead` is the distance between panels.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lead) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lead >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The m64nNk16 accumulator of a warpgroup gives thread (warp w, lane = 4g +
// tq) rows 16w + g and 16w + g + 8; d[4j + e] is column 8j + 2tq + (e & 1)
// of row 16w + g + 8 * (e >> 1) — per warp exactly the m16n8 C fragments of
// mma.sync, and the register A operand of a k16 slice takes the same
// fragments. So `acc_as_a` packs columns 16kc..16kc+15 of a wgmma
// accumulator, viewed as float[N/8][4], into the A operand of slice kc.
template <int N>
__device__ __forceinline__ float (*frags(float (&d)[N]))[4] {
  return reinterpret_cast<float(*)[4]>(d);
}

// d (64 x 64, f32) = A (64 x 16) * B (16 x 64) + (scale_d ? d : 0), A and
// B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 }, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) = A (64 x 16) * B (16 x 128) + (scale_d ? d : 0), A and
// B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 }, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared memory,
// MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 }, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, shared memory,
// MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 }, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Forward. One block per (q tile of 128 rows, head, batch); warpgroup wg owns
// q rows 64wg..64wg+63 of the tile. Q is loaded once; K and V stream through
// a ring of kStages stages (full barriers per K and per V, one empty barrier
// that both consumer warpgroups release after their P V).
template <int DM>
struct FwdWg {
  static constexpr int NP = DM / kPanel;  // 64-column panels
  static constexpr int BM = 128, BN = 128, kStages = 2;
  static constexpr int Q_BYTES = NP * BM * kRowBytes;
  static constexpr int KV_BYTES = NP * BN * kRowBytes;  // one K or V tile
  static constexpr size_t smem =
      1024 + Q_BYTES + 2 * kStages * KV_BYTES + (1 + 3 * kStages) * 8;
};

template <int DM>
__global__ void __launch_bounds__(kWgThreads, 1)
    fwd_wgmma(const __grid_constant__ CUtensorMap mq,
              const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv, Args a) {
  using C = FwdWg<DM>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Ks = Qs + C::Q_BYTES;
  unsigned char* Vs = Ks + C::kStages * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + C::kStages * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + C::kStages;
  uint64_t* empty = v_full + C::kStages;

  // the last q tiles carry the most causal work: they are scheduled first
  const int n_q = (a.T + C::BM - 1) / C::BM;
  const int bh = blockIdx.x % (a.B * a.H);
  const int q0 = (n_q - 1 - blockIdx.x / (a.B * a.H)) * C::BM;
  const int h = bh % a.H, b = bh / a.H;
  int n_kv = (a.Tk + C::BN - 1) / C::BN;
  if (a.causal) n_kv = min(n_kv, (min(q0 + C::BM, a.T) - 1) / C::BN + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: one thread issues every load
    regs_dec<24>();
    if (threadIdx.x == 256) {
      mbar_arrive_tx(q_full, C::Q_BYTES);
      for (int p = 0; p < C::NP; ++p)
        tma_load(Qs + p * C::BM * kRowBytes, &mq, q_full, p * kPanel, h, q0, b);
      for (int kt = 0; kt < n_kv; ++kt) {
        const int s = kt % C::kStages, ph = (kt / C::kStages) & 1;
        mbar_wait(empty + s, ph ^ 1);
        unsigned char* kd = Ks + s * C::KV_BYTES;
        unsigned char* vd = Vs + s * C::KV_BYTES;
        mbar_arrive_tx(k_full + s, C::KV_BYTES);
        for (int p = 0; p < C::NP; ++p)
          tma_load(kd + p * C::BN * kRowBytes, &mk, k_full + s, p * kPanel, h,
                   kt * C::BN, b);
        mbar_arrive_tx(v_full + s, C::KV_BYTES);
        for (int p = 0; p < C::NP; ++p)
          tma_load(vd + p * C::BN * kRowBytes, &mv, v_full + s, p * kPanel, h,
                   kt * C::BN, b);
      }
    }
  } else {  // consumers
    regs_inc<240>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane >> 2, tq = lane & 3;
    const int r0 = wg * 64 + warp * 16 + g;  // tile rows r0 and r0 + 8
    const float sl2 = a.scale * kLog2e;      // scores in the log2 domain
    const uint32_t q_addr = smem_addr(Qs) + wg * 64 * kRowBytes;
    float o[DM / 2];
#pragma unroll
    for (int i = 0; i < DM / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int kt = 0; kt < n_kv; ++kt) {
      const int s = kt % C::kStages, ph = (kt / C::kStages) & 1;
      const int k0 = kt * C::BN;
      const uint32_t k_addr = smem_addr(Ks + s * C::KV_BYTES);
      const uint32_t v_addr = smem_addr(Vs + s * C::KV_BYTES);
      float sc[C::BN / 2];
      mbar_wait(k_full + s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk) {
        const uint32_t col = (kk / 4) * C::BM * kRowBytes + (kk % 4) * 32;
        wgmma_ss(sc, sw128_desc(q_addr + col, 16),
                 sw128_desc(k_addr + col, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // the mask only on the tile that crosses the diagonal or an edge
      const bool edge = (a.causal && k0 + C::BN - 1 > q0) ||
                        k0 + C::BN > a.Tk || q0 + C::BM > a.T;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * sl2;
          if (edge && !live(a, q0 + r0 + (e >> 1) * 8, k0 + 8 * j + 2 * tq +
                                                          (e & 1)))
            x = kNegInf;
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mn = fmaxf(m[i], mx[i]);
        alpha[i] = fexp2(m[i] - mn);
        m[i] = mn;
      }
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i) {
        const float p = fexp2(sc[i] - m[(i >> 1) & 1]);
        sc[i] = p;
        rs[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
      for (int i = 0; i < DM / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      uint32_t pa[C::BN / 16][4];
#pragma unroll
      for (int kc = 0; kc < C::BN / 16; ++kc) acc_as_a(pa[kc], frags(sc), kc);

      mbar_wait(v_full + s, ph);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < C::BN / 16; ++kc)
        wgmma_rs(o, pa[kc],
                 sw128_desc(v_addr + kc * 16 * kRowBytes, C::BN * kRowBytes));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty + s);
    }

    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const float ls = fmaxf(l[i], 1e-30f);
      inv[i] = 1.f / ls;
      const int tp = q0 + r0 + 8 * i;
      if (tq == 0 && tp < a.T)
        a.lse_out[((long long)b * a.H + h) * a.T + tp] = m[i] * kLn2 + logf(ls);
    }
    bf16* out = static_cast<bf16*>(a.out0) +
                (((long long)b * a.T + q0) * a.H + h) * a.D;
    store_rows<DM>(out, frags(o), inv[0], inv[1], r0,
                   a.T - q0, (long long)a.H * a.D, a.D, tq);
  }
}

// dK/dV. One block per (key tile of 128 rows, head, batch); warpgroup wg owns
// keys 64wg..64wg+63 and their dK, dV accumulators. K and V are loaded once;
// Q, dO and the tile's LSE (times log2 e) and delta stream through the ring:
// lane 0 of the producer warp issues the TMA loads, all 32 lanes copy the
// row vectors and arrive.
template <int DM>
struct DkvWg {
  static constexpr int NP = DM / kPanel;
  static constexpr int BK = 128, BQ = 64, kStages = 2;
  static constexpr int KV_BYTES = NP * BK * kRowBytes;  // K or V
  static constexpr int QT_BYTES = NP * BQ * kRowBytes;  // one Q or dO tile
  static constexpr size_t smem = 1024 + 2 * KV_BYTES +
                                 kStages * (2 * QT_BYTES + 2 * BQ * 4) +
                                 (1 + 2 * kStages) * 8;
};

template <int DM>
__global__ void __launch_bounds__(kWgThreads, 1)
    dkv_wgmma(const __grid_constant__ CUtensorMap mq,
              const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv,
              const __grid_constant__ CUtensorMap mdo, Args a) {
  using C = DkvWg<DM>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + C::KV_BYTES;
  unsigned char* Qs = Vs + C::KV_BYTES;             // kStages Q tiles
  unsigned char* dOs = Qs + C::kStages * C::QT_BYTES;  // kStages dO tiles
  float* lse2 = reinterpret_cast<float*>(dOs + C::kStages * C::QT_BYTES);
  float* dls = lse2 + C::kStages * C::BQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dls + C::kStages * C::BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + C::kStages;

  // the first key tiles carry the most causal work: they are scheduled first
  const int bh = blockIdx.x % (a.B * a.H);
  const int k0 = (blockIdx.x / (a.B * a.H)) * C::BK;
  const int h = bh % a.H, b = bh / a.H;
  const int n_q = (a.T + C::BQ - 1) / C::BQ;
  const int first = a.causal ? k0 / C::BQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer warp
    regs_dec<24>();
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x - 256;
      if (lane == 0) {
        mbar_arrive_tx(kv_full, 2 * C::KV_BYTES);
        for (int p = 0; p < C::NP; ++p) {
          tma_load(Ks + p * C::BK * kRowBytes, &mk, kv_full, p * kPanel, h, k0,
                   b);
          tma_load(Vs + p * C::BK * kRowBytes, &mv, kv_full, p * kPanel, h, k0,
                   b);
        }
      }
      for (int qt = first; qt < n_q; ++qt) {
        const int it = qt - first;
        const int s = it % C::kStages, ph = (it / C::kStages) & 1;
        const int q0 = qt * C::BQ;
        mbar_wait(empty + s, ph ^ 1);
        for (int i = lane; i < C::BQ; i += 32) {
          const int tp = q0 + i;
          const long long at = ((long long)b * a.H + h) * a.T + tp;
          lse2[s * C::BQ + i] = tp < a.T ? a.lse_in[at] * kLog2e : 0.f;
          dls[s * C::BQ + i] = tp < a.T ? a.delta[at] : 0.f;
        }
        if (lane == 0) {
          unsigned char* qd = Qs + s * C::QT_BYTES;
          unsigned char* dd = dOs + s * C::QT_BYTES;
          mbar_arrive_tx(full + s, 2 * C::QT_BYTES);
          for (int p = 0; p < C::NP; ++p) {
            tma_load(qd + p * C::BQ * kRowBytes, &mq, full + s, p * kPanel, h,
                     q0, b);
            tma_load(dd + p * C::BQ * kRowBytes, &mdo, full + s, p * kPanel, h,
                     q0, b);
          }
        } else {
          mbar_arrive(full + s);
        }
      }
    }
  } else {  // consumers
    regs_inc<240>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane >> 2, tq = lane & 3;
    const int kw0 = k0 + wg * 64;   // this warpgroup's first key
    const int kr = warp * 16 + g;   // its key rows kr and kr + 8
    const float sl2 = a.scale * kLog2e;
    const uint32_t k_addr = smem_addr(Ks) + wg * 64 * kRowBytes;
    const uint32_t v_addr = smem_addr(Vs) + wg * 64 * kRowBytes;
    float dk[DM / 2], dv[DM / 2];
#pragma unroll
    for (int i = 0; i < DM / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int qt = first; qt < n_q; ++qt) {
      const int it = qt - first;
      const int s = it % C::kStages, ph = (it / C::kStages) & 1;
      const int q0 = qt * C::BQ;
      mbar_wait(full + s, ph);
      if (a.causal && q0 + C::BQ - 1 < kw0) {  // every query before every key
        mbar_arrive(empty + s);
        continue;
      }
      const uint32_t q_addr = smem_addr(Qs + s * C::QT_BYTES);
      const uint32_t do_addr = smem_addr(dOs + s * C::QT_BYTES);
      const float* lse_s = lse2 + s * C::BQ;
      const float* dl_s = dls + s * C::BQ;
      // transposed scores: rows are this warpgroup's 64 keys, columns the
      // tile's 64 queries
      float st[C::BQ / 2], dpt[C::BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk)  // S^T = K Q^T
        wgmma_ss(st,
                 sw128_desc(k_addr + (kk / 4) * C::BK * kRowBytes +
                                (kk % 4) * 32, 16),
                 sw128_desc(q_addr + (kk / 4) * C::BQ * kRowBytes +
                                (kk % 4) * 32, 16),
                 kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk)  // dP^T = V dO^T
        wgmma_ss(dpt,
                 sw128_desc(v_addr + (kk / 4) * C::BK * kRowBytes +
                                (kk % 4) * 32, 16),
                 sw128_desc(do_addr + (kk / 4) * C::BQ * kRowBytes +
                                (kk % 4) * 32, 16),
                 kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      const bool edge = (a.causal && q0 < kw0 + 63) || q0 + C::BQ > a.T ||
                        kw0 + 64 > a.Tk;
#pragma unroll
      for (int j = 0; j < C::BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * tq + (e & 1);
          float x = st[4 * j + e] * sl2;
          if (edge && !live(a, q0 + qi, kw0 + kr + (e >> 1) * 8)) x = kNegInf;
          st[4 * j + e] = fexp2(x - lse_s[qi]);  // P^T
        }
      uint32_t pa[C::BQ / 16][4];
#pragma unroll
      for (int kc = 0; kc < C::BQ / 16; ++kc) acc_as_a(pa[kc], frags(st), kc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < C::BQ / 16; ++kc)  // dV += P^T dO
        wgmma_rs(dv, pa[kc],
                 sw128_desc(do_addr + kc * 16 * kRowBytes, C::BQ * kRowBytes));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dpt);

#pragma unroll
      for (int j = 0; j < C::BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * tq + (e & 1);
          dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dl_s[qi]);  // dS^T
        }
      uint32_t da[C::BQ / 16][4];
#pragma unroll
      for (int kc = 0; kc < C::BQ / 16; ++kc) acc_as_a(da[kc], frags(dpt), kc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < C::BQ / 16; ++kc)  // dK += dS^T Q
        wgmma_rs(dk, da[kc],
                 sw128_desc(q_addr + kc * 16 * kRowBytes, C::BQ * kRowBytes));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(empty + s);
    }

    const long long rs = (long long)a.H * a.D;
    const long long off = (((long long)b * a.Tk + kw0) * a.H + h) * a.D;
    store_rows<DM>(static_cast<bf16*>(a.out0) + off,
                   frags(dk), a.scale, a.scale, kr,
                   a.Tk - kw0, rs, a.D, tq);
    store_rows<DM>(static_cast<bf16*>(a.out1) + off,
                   frags(dv), 1.f, 1.f, kr, a.Tk - kw0,
                   rs, a.D, tq);
  }
}

// dQ. One block per (q tile of 128 rows, head, batch); warpgroup wg owns q
// rows 64wg..64wg+63 and their dQ accumulator. Q and dO are loaded once; K
// and V stream through the ring in 64-row tiles (full barriers per K and per
// V, one empty barrier that both consumer warpgroups release after dS K).
// Each consumer thread reads the LSE (times log2 e) and delta of its own
// two rows straight into registers.
template <int DM>
struct DqWg {
  static constexpr int NP = DM / kPanel;
  static constexpr int BM = 128, BN = 64, kStages = 2;
  static constexpr int Q_BYTES = NP * BM * kRowBytes;   // Q or dO
  static constexpr int KV_BYTES = NP * BN * kRowBytes;  // one K or V tile
  static constexpr size_t smem =
      1024 + 2 * Q_BYTES + 2 * kStages * KV_BYTES + (1 + 3 * kStages) * 8;
};

template <int DM>
__global__ void __launch_bounds__(kWgThreads, 1)
    dq_wgmma(const __grid_constant__ CUtensorMap mq,
             const __grid_constant__ CUtensorMap mk,
             const __grid_constant__ CUtensorMap mv,
             const __grid_constant__ CUtensorMap mdo, Args a) {
  using C = DqWg<DM>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* dOs = Qs + C::Q_BYTES;
  unsigned char* Ks = dOs + C::Q_BYTES;
  unsigned char* Vs = Ks + C::kStages * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + C::kStages * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + C::kStages;
  uint64_t* empty = v_full + C::kStages;

  // the last q tiles carry the most causal work: they are scheduled first
  const int n_q = (a.T + C::BM - 1) / C::BM;
  const int bh = blockIdx.x % (a.B * a.H);
  const int q0 = (n_q - 1 - blockIdx.x / (a.B * a.H)) * C::BM;
  const int h = bh % a.H, b = bh / a.H;
  const int n_all = (a.Tk + C::BN - 1) / C::BN;
  // K/V tiles that rows q0 .. q0 + rows - 1 reach
  auto tiles = [&](int rows) {
    return a.causal ? min(n_all, (min(q0 + rows, a.T) - 1) / C::BN + 1)
                    : n_all;
  };
  const int n_kv = tiles(C::BM);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: one thread issues every load
    regs_dec<24>();
    if (threadIdx.x == 256) {
      mbar_arrive_tx(q_full, 2 * C::Q_BYTES);
      for (int p = 0; p < C::NP; ++p) {
        tma_load(Qs + p * C::BM * kRowBytes, &mq, q_full, p * kPanel, h, q0, b);
        tma_load(dOs + p * C::BM * kRowBytes, &mdo, q_full, p * kPanel, h, q0,
                 b);
      }
      for (int kt = 0; kt < n_kv; ++kt) {
        const int s = kt % C::kStages, ph = (kt / C::kStages) & 1;
        mbar_wait(empty + s, ph ^ 1);
        unsigned char* kd = Ks + s * C::KV_BYTES;
        unsigned char* vd = Vs + s * C::KV_BYTES;
        mbar_arrive_tx(k_full + s, C::KV_BYTES);
        for (int p = 0; p < C::NP; ++p)
          tma_load(kd + p * C::BN * kRowBytes, &mk, k_full + s, p * kPanel, h,
                   kt * C::BN, b);
        mbar_arrive_tx(v_full + s, C::KV_BYTES);
        for (int p = 0; p < C::NP; ++p)
          tma_load(vd + p * C::BN * kRowBytes, &mv, v_full + s, p * kPanel, h,
                   kt * C::BN, b);
      }
    }
  } else {  // consumers
    regs_inc<240>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane >> 2, tq = lane & 3;
    const int qw0 = q0 + wg * 64;   // this warpgroup's first q row
    const int kr = warp * 16 + g;   // its rows kr and kr + 8
    // with causal masking warpgroup 0 reaches one tile fewer than the block
    const int n_wg = tiles(wg * 64 + 64);
    const float sl2 = a.scale * kLog2e;
    const uint32_t q_addr = smem_addr(Qs) + wg * 64 * kRowBytes;
    const uint32_t do_addr = smem_addr(dOs) + wg * 64 * kRowBytes;
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tp = qw0 + kr + 8 * i;
      const long long at = ((long long)b * a.H + h) * a.T + tp;
      lse2[i] = tp < a.T ? a.lse_in[at] * kLog2e : 0.f;
      dl[i] = tp < a.T ? a.delta[at] : 0.f;
    }
    float dq[DM / 2];
#pragma unroll
    for (int i = 0; i < DM / 2; ++i) dq[i] = 0.f;
    mbar_wait(q_full, 0);

    for (int kt = 0; kt < n_kv; ++kt) {
      const int s = kt % C::kStages, ph = (kt / C::kStages) & 1;
      const int k0 = kt * C::BN;
      mbar_wait(k_full + s, ph);
      if (kt >= n_wg) {  // every key of the tile follows every row
        mbar_arrive(empty + s);
        continue;
      }
      const uint32_t k_addr = smem_addr(Ks + s * C::KV_BYTES);
      const uint32_t v_addr = smem_addr(Vs + s * C::KV_BYTES);
      float sc[C::BN / 2], dp[C::BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk)  // S = Q K^T
        wgmma_ss(sc,
                 sw128_desc(q_addr + (kk / 4) * C::BM * kRowBytes +
                                (kk % 4) * 32, 16),
                 sw128_desc(k_addr + (kk / 4) * C::BN * kRowBytes +
                                (kk % 4) * 32, 16),
                 kk > 0);
      wgmma_commit();
      mbar_wait(v_full + s, ph);
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk)  // dP = dO V^T
        wgmma_ss(dp,
                 sw128_desc(do_addr + (kk / 4) * C::BM * kRowBytes +
                                (kk % 4) * 32, 16),
                 sw128_desc(v_addr + (kk / 4) * C::BN * kRowBytes +
                                (kk % 4) * 32, 16),
                 kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // the mask only on the tile that crosses the diagonal or an edge
      const bool edge = (a.causal && k0 + C::BN - 1 > qw0) ||
                        k0 + C::BN > a.Tk || qw0 + 64 > a.T;
#pragma unroll
      for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * sl2;
          if (edge && !live(a, qw0 + kr + (e >> 1) * 8,
                            k0 + 8 * j + 2 * tq + (e & 1)))
            x = kNegInf;
          sc[4 * j + e] = fexp2(x - lse2[e >> 1]);  // P
        }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i)
        dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);  // dS
      uint32_t da[C::BN / 16][4];
#pragma unroll
      for (int kc = 0; kc < C::BN / 16; ++kc) acc_as_a(da[kc], frags(dp), kc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < C::BN / 16; ++kc)  // dQ += dS K
        wgmma_rs(dq, da[kc],
                 sw128_desc(k_addr + kc * 16 * kRowBytes, C::BN * kRowBytes));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      mbar_arrive(empty + s);
    }

    bf16* out = static_cast<bf16*>(a.out0) +
                (((long long)b * a.T + qw0) * a.H + h) * a.D;
    store_rows<DM>(out, frags(dq), a.scale, a.scale, kr, a.T - qw0,
                   (long long)a.H * a.D, a.D, tq);
  }
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

// Lets `kernel` take `smem` bytes of dynamic shared memory (above 48 KB), on
// the first launch of each kernel on each device.
template <typename K>
int set_smem(K* kernel, size_t smem) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;  // (kernel, device)
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return static_cast<int>(e);
  std::lock_guard<std::mutex> hold(mu);
  if (done.count({reinterpret_cast<const void*>(kernel), dev})) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (!e) done.insert({reinterpret_cast<const void*>(kernel), dev});
  return static_cast<int>(e);
}

template <typename K>
int launch(K* kernel, int rows, int tile, size_t smem, const Args& a,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const int e = set_smem(kernel, smem);
    if (e) return e;
  }
  const dim3 grid((rows + tile - 1) / tile, a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library needs no link against libcuda.
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 4-D map (D, H, rows, B) of a bf16 (B, rows, H, D) tensor read through
// its element strides: boxes of 64 columns x box_rows rows of one head, the
// 128-byte swizzle that wgmma reads, zero fill past D, rows and every other
// edge. A size-1 axis gets a packed stride (its stride is never used).
int make_map(CUtensorMap* map, const void* base, const Strides& s, int B,
             int H, int rows, int D, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t ph = (cuuint64_t)D * 2, pt = ph * H, pb = pt * rows;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)rows,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {H > 1 ? (cuuint64_t)s.h * 2 : ph,
                           rows > 1 ? (cuuint64_t)s.t * 2 : pt,
                           B > 1 ? (cuuint64_t)s.b * 2 : pb};
  cuuint32_t box[4] = {(cuuint32_t)kPanel, 1, (cuuint32_t)box_rows, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int DM>
int launch_fwd_wgmma(const Args& a, cudaStream_t stream) {
  using C = FwdWg<DM>;
  CUtensorMap mq, mk, mv;
  int e = make_map(&mq, a.q, a.sq, a.B, a.H, a.T, a.D, C::BM);
  if (!e) e = make_map(&mk, a.k, a.sk, a.B, a.H, a.Tk, a.D, C::BN);
  if (!e) e = make_map(&mv, a.v, a.sv, a.B, a.H, a.Tk, a.D, C::BN);
  if (!e) e = set_smem(fwd_wgmma<DM>, C::smem);
  if (e) return e;
  const int n_q = (a.T + C::BM - 1) / C::BM;
  fwd_wgmma<DM><<<n_q * a.B * a.H, kWgThreads, C::smem, stream>>>(mq, mk, mv,
                                                                   a);
  return static_cast<int>(cudaGetLastError());
}

template <int DM>
int launch_dkv_wgmma(const Args& a, cudaStream_t stream) {
  using C = DkvWg<DM>;
  CUtensorMap mq, mk, mv, mdo;
  int e = make_map(&mq, a.q, a.sq, a.B, a.H, a.T, a.D, C::BQ);
  if (!e) e = make_map(&mk, a.k, a.sk, a.B, a.H, a.Tk, a.D, C::BK);
  if (!e) e = make_map(&mv, a.v, a.sv, a.B, a.H, a.Tk, a.D, C::BK);
  if (!e) e = make_map(&mdo, a.dout, a.sdo, a.B, a.H, a.T, a.D, C::BQ);
  if (!e) e = set_smem(dkv_wgmma<DM>, C::smem);
  if (e) return e;
  const int n_k = (a.Tk + C::BK - 1) / C::BK;
  dkv_wgmma<DM><<<n_k * a.B * a.H, kWgThreads, C::smem, stream>>>(mq, mk, mv,
                                                                   mdo, a);
  return static_cast<int>(cudaGetLastError());
}

template <int DM>
int launch_dq_wgmma(const Args& a, cudaStream_t stream) {
  using C = DqWg<DM>;
  CUtensorMap mq, mk, mv, mdo;
  int e = make_map(&mq, a.q, a.sq, a.B, a.H, a.T, a.D, C::BM);
  if (!e) e = make_map(&mk, a.k, a.sk, a.B, a.H, a.Tk, a.D, C::BN);
  if (!e) e = make_map(&mv, a.v, a.sv, a.B, a.H, a.Tk, a.D, C::BN);
  if (!e) e = make_map(&mdo, a.dout, a.sdo, a.B, a.H, a.T, a.D, C::BM);
  if (!e) e = set_smem(dq_wgmma<DM>, C::smem);
  if (e) return e;
  const int n_q = (a.T + C::BM - 1) / C::BM;
  dq_wgmma<DM><<<n_q * a.B * a.H, kWgThreads, C::smem, stream>>>(mq, mk, mv,
                                                                 mdo, a);
  return static_cast<int>(cudaGetLastError());
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// bf16: the wgmma kernels for D <= 128 (DM 64 and 128), the mma.sync
// kernels for 128 < D <= 256.
template <int DM>
int dispatch_dm(int dtype, Which w, const Args& a, cudaStream_t s) {
  using B = BfSmem<DM>;
  using F = F32Smem<DM>;
  if (dtype == 1) {
    if constexpr (DM <= 128) {
      if (w == kFwd) return launch_fwd_wgmma<DM>(a, s);
      if (w == kDq) return launch_dq_wgmma<DM>(a, s);
      return launch_dkv_wgmma<DM>(a, s);
    } else {
      if (w == kFwd) return launch(fwd_bf16<DM>, a.T, kTile, B::fwd, a, s);
      if (w == kDq) return launch(dq_bf16<DM>, a.T, kTile, B::dq, a, s);
      return launch(dkv_bf16<DM>, a.Tk, kTile, B::dkv, a, s);
    }
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
