// Paged-attention decode read for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/kernels/paged_attention.py `paged_attention_rows`
// (Pallas body `_paged_kernel`). One decode step: each batch row attends with
// its one fresh query token over the K/V blocks its block table names, masked
// to positions <= pos[row]. GQA-grouped: query head h = g * rep + r reads KV
// head g. Output is (B, H * D) in q's dtype.
//
// What bounds it on the H100: device-memory bytes. Every live token's K and
// V row (2 * KV * D elements) is read once and used for 4 * rep * D FLOPs,
// far below the ~295 FLOP/byte the card needs before compute matters. So the
// design keeps enough bytes in flight, and as little serial work as it can
// between one load and the next:
//  - whole pool blocks, not single tokens: each warp walks its own share of
//    a row's context one tile at a time, a tile being a whole pool block of
//    BS tokens (a piece of one when its K and V rows of one head exceed
//    8 KB or a warp's passes). A lane loads 16-byte chunks of the tile's K
//    and V rows with `cp.async` (a D = 128 bf16 row is 16 lanes x 16 bytes,
//    so a warp covers two rows per load) into its warp's 2-stage
//    shared-memory ring: the next tile is in flight while one is scored,
//    and the small ring lets three blocks share an SM (two stages beat
//    three by 18% at the decode shape, PERF.md §6). Each lane reads back
//    exactly the chunks it loaded, so its own `cp.async.wait_group` orders
//    them and the loop has no barrier at all. The row's block ids are read
//    into shared memory once, ahead of every load; trash blocks are never
//    read;
//  - softmax once per tile: the scores of all the tile's tokens are taken
//    first (q.k reduced over the lanes that hold one row), then one max and
//    one rescale per tile and query head, in the log2 domain (exp2f), with
//    warp shuffles only; P V accumulates in each lane's own rows and
//    columns, and the warp's row groups are folded once at the end;
//  - a row's context split over up to 8 thread blocks of a cluster when
//    B * KV blocks cannot fill the card: warp w of block s takes tiles
//    4s + w, 4s + w + 4 * split, ... and the partial (max, sum, output) of
//    every warp of the cluster are merged through distributed shared memory
//    in (block, warp) order (no scratch in device memory, no second launch,
//    deterministic). The host picks the split from B * KV, MB * BS and the
//    SM count (`split_for`; `pt_paged_split` reports it), never from pos,
//    which lives on the device, unless the caller names one (the kernel
//    registry's `split` axis: 1, 2, 4 or 8, each block of the cluster
//    keeping at least 64 positions of the table);
//  - the K/V of a group is read once whatever rep is: the scores and the
//    running output of every query head of the group share each tile.
// q.k is taken in f32 and the scale applied after the product, as
// `_grouped_attention` does; the scale arrives already rounded to q's dtype.
//
// Contract (as the reference's): the caller scatters the step's fresh K/V
// into the pool BEFORE this read, and pos[row] >= 0 (padding rows point at
// the trash block with pos 0). D is a multiple of 8 (16-byte rows in bf16).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <set>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;           // tiles in each warp's ring
constexpr int kStageBytes = 8192;    // K + V of one tile at most
constexpr int kMaxTile = 64;         // tokens of one tile at most
constexpr int kMaxSplit = 8;         // thread blocks of a cluster
constexpr int kMaxRepD = 1024;       // rep * D bound of the merge buffer
constexpr int kMaxSmem = 227 * 1024; // dynamic shared memory of a block at most
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// the 16 bytes at p as f32 values (8 bf16 or 4 f32)
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, not staged in registers (L2 only)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Lanes that hold one K/V row in the score pass: the row's 16-byte chunks,
// rounded up to a power of two, at most 32 (a lane then holds 2 chunks).
__host__ __device__ inline int row_lanes(int D, int elem_bytes) {
  const int rc = D * elem_bytes / 16;
  int lpr = 1;
  while (lpr < rc && lpr < 32) lpr *= 2;
  return lpr;
}

// Passes of a warp over one tile, at most: each pass scores 32 / lpr rows.
template <int REP>
__host__ __device__ constexpr int max_passes() { return REP >= 8 ? 4 : 8; }

// Tokens of one tile: a whole pool block unless its K and V rows of one head
// exceed kStageBytes, kMaxTile tokens or a warp's passes; then the largest
// divisor of BS within those bounds, so that no tile crosses a block.
template <int REP>
int tile_tokens(int BS, int D, int elem_bytes) {
  int cap = kStageBytes / (2 * D * elem_bytes);
  const int passes = max_passes<REP>() * (32 / row_lanes(D, elem_bytes));
  if (cap > passes) cap = passes;
  if (cap > kMaxTile) cap = kMaxTile;
  int tt = cap < BS ? cap : BS;
  while (tt > 1 && BS % tt) --tt;
  return tt < 1 ? 1 : tt;
}

// Shared memory: the warps' rings (after the loop, the warps' partial
// results in the same bytes), then the block ids.
template <typename T, int REP>
__host__ __device__ inline size_t work_bytes(int TT, int D) {
  const size_t ring = (size_t)kWarps * kStages * 2 * TT * D * sizeof(T);
  const size_t part = (size_t)kWarps * (2 * REP + REP * D) * 4;
  return ((ring > part ? ring : part) + 15) / 16 * 16;
}

template <typename T, int REP>
size_t smem_bytes(int TT, int D, int MB) {
  return work_bytes<T, REP>(TT, D) + (size_t)MB * 4;
}

// REP: bound on the query heads per KV head (rep <= REP).
template <typename T, int REP>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kpool,
    const T* __restrict__ vpool, const int* __restrict__ tables,
    const int* __restrict__ pos, T* __restrict__ out, int KV, int rep, int D,
    int BS, int MB, int TT, int split, float scale) {
  constexpr int VE = 16 / sizeof(T);  // elements of a 16-byte chunk
  constexpr int CPL = 8 / VE;         // chunks of a row one lane holds
  constexpr int NP = max_passes<REP>();
  constexpr int PW = 2 * REP;         // floats of a warp's partial, + REP * D
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tile_elems = TT * D;  // one K or V tile
  T* ring = reinterpret_cast<T*>(smem) + (size_t)warp * kStages * 2 * tile_elems;
  float* part = reinterpret_cast<float*>(smem);
  int* ids = reinterpret_cast<int*>(smem + work_bytes<T, REP>(TT, D));

  const int unit = blockIdx.x / split, sp = blockIdx.x % split;
  const int b = unit / KV, g = unit % KV;
  const int H = KV * rep;
  // a pos past the table's end reads no further than the table (the plain
  // path's mask then has every position live too)
  const int p = min(pos[b], MB * BS - 1);
  const int cpb = BS / TT;  // tiles of one pool block (TT divides BS)
  const int n_live = p / BS + 1;
  // tile u of the row is piece u % cpb of live block u / cpb; warp w of
  // cluster block sp takes tiles gw, gw + nw, ...
  const int u_end = (p / BS) * cpb + (p % BS) / TT + 1;
  const int nw = split * kWarps, gw = sp * kWarps + warp;
  const int n_mine = u_end > gw ? (u_end - gw + nw - 1) / nw : 0;
  for (int j = tid; j < n_live; j += kThreads)
    ids[j] = tables[(size_t)b * MB + j];

  // lane (gi, gl): chunks gl + lpr * c of rows gi + rpp * k of every tile;
  // it loads exactly what it reads, so its own cp.async waits order them
  const int rc = D / VE, lpr = row_lanes(D, sizeof(T)), rpp = 32 / lpr;
  const int gi = lane / lpr, gl = lane % lpr;
  float qr[REP][8], acc[REP][8], m[REP], l[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int ch = gl + lpr * c;
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        acc[r][c * VE + e] = 0.f;
        qr[r][c * VE + e] =
            r < rep && ch < rc
                ? to_f(q[((size_t)b * H + g * rep + r) * D + ch * VE + e])
                : 0.f;
      }
    }
  }
  __syncthreads();  // the block ids

  // live tokens of this warp's tile i
  auto live_rows = [&](int i) {
    const int u = gw + i * nw;
    return min(TT, p - ((u / cpb) * BS + (u % cpb) * TT) + 1);
  };
  // this lane's chunks of tile i's live rows into its stage; one commit
  // group per tile, empty past the last
  auto issue = [&](int i) {
    if (i < n_mine) {
      const int u = gw + i * nw, nt = live_rows(i);
      const size_t base =
          (((size_t)ids[u / cpb] * BS + (u % cpb) * TT) * KV + g) * D;
      T* kd = ring + (i % kStages) * 2 * tile_elems;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int row = gi + rpp * k;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int ch = gl + lpr * c;
          if (row < nt && ch < rc) {
            const size_t src = base + (size_t)row * KV * D + ch * VE;
            cp_async16(kd + row * D + ch * VE, kpool + src);
            cp_async16(kd + tile_elems + row * D + ch * VE, vpool + src);
          }
        }
      }
    }
    cp_commit();
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < n_mine; ++i) {
    cp_wait<kStages - 2>();  // this lane's chunks of tile i have landed
    issue(i + kStages - 1);  // into the stage it finished reading last
    const int nt = live_rows(i);
    const T* kd = ring + (i % kStages) * 2 * tile_elems;
    const T* vd = kd + tile_elems;

    // scores, log2 domain: q.k over the lpr lanes of a row, -inf past the
    // live tokens
    float s[REP][NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int row = gi + rpp * k;
      float dot[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) dot[r] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int ch = gl + lpr * c;
        if (row < nt && ch < rc) {
          float kx[VE];
          load16(kd + row * D + ch * VE, kx);
#pragma unroll
          for (int r = 0; r < REP; ++r)
#pragma unroll
            for (int e = 0; e < VE; ++e)
              dot[r] = fmaf(qr[r][c * VE + e], kx[e], dot[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        if (r < rep)
          for (int off = lpr / 2; off > 0; off >>= 1)
            dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
        s[r][k] = r < rep && row < nt ? dot[r] * scale * kLog2e : -INFINITY;
      }
    }

    // one max and one rescale per tile and head (every tile has a live
    // token, so the max is finite)
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r < rep) {
        float mx = -INFINITY;
#pragma unroll
        for (int k = 0; k < NP; ++k) mx = fmaxf(mx, s[r][k]);
        for (int off = lpr; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mn = fmaxf(m[r], mx);
        const float al = exp2f(m[r] - mn);  // 0 on the first tile
        m[r] = mn;
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          s[r][k] = exp2f(s[r][k] - mn);
          sum += s[r][k];
        }
        for (int off = lpr; off < 32; off <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[r] = l[r] * al + sum;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] *= al;
      }
    }

    // P V over this lane's rows and columns
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int row = gi + rpp * k;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int ch = gl + lpr * c;
        if (row < nt && ch < rc) {
          float vx[VE];
          load16(vd + row * D + ch * VE, vx);
#pragma unroll
          for (int r = 0; r < REP; ++r)
            if (r < rep)
#pragma unroll
              for (int e = 0; e < VE; ++e)
                acc[r][c * VE + e] = fmaf(s[r][k], vx[e], acc[r][c * VE + e]);
        }
      }
    }
  }
  cp_wait<0>();

  // the warp's rows are split over its row groups: fold them
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      for (int off = lpr; off < 32; off <<= 1)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
  __syncthreads();  // every ring is read: the partials take its bytes
  float* pw = part + warp * (PW + REP * D);
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r < rep) {
      if (lane == 0) {
        pw[r] = m[r];
        pw[REP + r] = l[r];
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int ch = gl + lpr * c;
        if (gi == 0 && ch < rc)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            pw[PW + r * D + ch * VE + e] = acc[r][c * VE + e];
      }
    }
  }

  // merge every warp of the cluster in (block, warp) order; a warp that saw
  // no tile holds max -inf, sum 0, output 0
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1)
    cluster.sync();
  else
    __syncthreads();
  const size_t orow = (size_t)b * H * D + (size_t)g * rep * D;
  for (int x = sp * kThreads + tid; x < rep * D; x += split * kThreads) {
    const int r = x / D;
    float mx = -INFINITY;
    for (int s = 0; s < split; ++s) {
      const float* src = split > 1 ? cluster.map_shared_rank(part, s) : part;
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, src[w * (PW + REP * D) + r]);
    }
    float den = 0.f, num = 0.f;
    for (int s = 0; s < split; ++s) {
      const float* src = split > 1 ? cluster.map_shared_rank(part, s) : part;
      for (int w = 0; w < kWarps; ++w) {
        const float* pp = src + w * (PW + REP * D);
        const float c = pp[r] == -INFINITY ? 0.f : exp2f(pp[r] - mx);
        den = fmaf(pp[REP + r], c, den);
        num = fmaf(pp[PW + x], c, num);
      }
    }
    out[orow + x] = from_f<T>(num / den);
  }
  if (split > 1) cluster.sync();  // no block leaves while another reads it
}

// The cluster size for B * KV (row, KV head) pairs over MB * BS positions:
// doubled while the blocks would not fill 4 per SM and every block keeps at
// least 64 positions of the table.
int split_for(int B, int KV, int BS, int MB, int n_sm) {
  const long long units = (long long)B * KV, ctx = (long long)MB * BS;
  int split = 1;
  while (split < kMaxSplit && units * split < 4LL * n_sm &&
         ctx >= 128LL * split)
    split *= 2;
  return split;
}

int sm_count(int* n) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (!e) e = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

// Lets this instantiation take up to kMaxSmem of dynamic shared memory, set
// once per device (an allowance only: each launch asks for what it needs,
// and the blocks an SM holds follow that).
template <typename T, int REP>
int allow_smem() {
  static std::mutex mu;
  static std::set<int> done;  // devices
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return static_cast<int>(e);
  std::lock_guard<std::mutex> hold(mu);
  if (done.count(dev)) return 0;
  e = cudaFuncSetAttribute(paged_attention_kernel<T, REP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (!e) done.insert(dev);
  return static_cast<int>(e);
}

// A cluster size the caller may name: 0 (split_for's choice), 1, or 2, 4, 8
// where every block of the cluster keeps at least 64 positions of the table
// (split_for's own floor).
bool split_ok(int split, int BS, int MB) {
  if (split == 0 || split == 1) return true;
  if (split != 2 && split != 4 && split != kMaxSplit) return false;
  return (long long)MB * BS >= 64LL * split;
}

template <typename T, int REP>
int launch(const void* q, const void* kpool, const void* vpool,
           const int* tables, const int* pos, void* out, int B, int KV,
           int rep, int D, int BS, int MB, float scale, cudaStream_t stream,
           int req_split) {
  auto* kernel = paged_attention_kernel<T, REP>;
  const int TT = tile_tokens<REP>(BS, D, sizeof(T));
  const size_t smem = smem_bytes<T, REP>(TT, D, MB);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  int n_sm = 0;
  int e = sm_count(&n_sm);
  if (!e && smem > 48 * 1024) e = allow_smem<T, REP>();
  if (e) return e;
  const int split = req_split ? req_split : split_for(B, KV, BS, MB, n_sm);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KV * split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), tables, pos, static_cast<T*>(out), KV, rep,
      D, BS, MB, TT, split, scale);
  if (le) return static_cast<int>(le);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* kpool, const void* vpool,
             const int* tables, const int* pos, void* out, int B, int KV,
             int rep, int D, int BS, int MB, float scale, cudaStream_t s,
             int split) {
  if (rep <= 1) return launch<T, 1>(q, kpool, vpool, tables, pos, out, B, KV, rep, D, BS, MB, scale, s, split);
  if (rep <= 2) return launch<T, 2>(q, kpool, vpool, tables, pos, out, B, KV, rep, D, BS, MB, scale, s, split);
  if (rep <= 4) return launch<T, 4>(q, kpool, vpool, tables, pos, out, B, KV, rep, D, BS, MB, scale, s, split);
  return launch<T, 8>(q, kpool, vpool, tables, pos, out, B, KV, rep, D, BS, MB, scale, s, split);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (B, KV*rep, D); kpool/vpool
// (NB, BS, KV, D) of one layer; tables (B, MB) int32; pos (B,) int32;
// out (B, KV*rep*D). All contiguous on the current device; D % 8 == 0.
// split: the cluster size, 0 for split_for's (see split_ok).
int pt_paged_attention(int dtype, const void* q, const void* kpool,
                       const void* vpool, const void* tables, const void* pos,
                       void* out, int B, int KV, int rep, int D, int BS,
                       int MB, float scale, void* stream, int split) {
  if (B <= 0 || KV <= 0 || rep <= 0 || rep > 8 || D <= 0 || D > 256 ||
      D % 8 || rep * D > kMaxRepD || BS <= 0 || MB <= 0 ||
      !split_ok(split, BS, MB))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, kpool, vpool, t, p, out, B, KV, rep, D, BS, MB, scale, s, split);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, kpool, vpool, t, p, out, B, KV, rep, D, BS, MB, scale, s, split);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The cluster size pt_paged_attention launches with for these shapes on the
// current device (0 or less: a CUDA error, negated).
int pt_paged_split(int B, int KV, int BS, int MB) {
  int n_sm = 0;
  const int e = sm_count(&n_sm);
  return e ? -e : split_for(B, KV, BS, MB, n_sm);
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
