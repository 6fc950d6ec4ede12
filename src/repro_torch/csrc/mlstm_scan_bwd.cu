// The mLSTM scan's backward for Hopper (sm_90a): dq, dk, dv, d(i_gate),
// d(f_gate) of the forward in mlstm_scan.cu.
//
// The TPU kernel `_kernel` / `mlstm_scan` of src/repro/kernels/mlstm_scan.py
// has no backward (the reference differentiates its jnp recurrence); the
// port's training paths send every mLSTM block through kernel 6, so its
// gradient is this kernel.  It differentiates the xLSTM paper's parallel
// form (mlstm_scan.cu, kernel 1), with k~ = k / sqrt(hd):
//   F_t = sum_{r<=t} log sigmoid(f_r),  g_s = i_s - F_s,
//   D_ts = exp(g_s - M_t) (s <= t),  S_ts = q_t . k~_s,  P_ts = S_ts D_ts,
//   a_t = sum_s P_ts,  den_t = max(|a_t|, exp(-m_t)),  h_t = sum_s P_ts v_s / den_t
// with the stabilizer m_t held constant: scaling every D_ts of row t and
// exp(-m_t) by one factor cancels in h_t, so the gradient through the
// recurrence's max is zero in exact arithmetic.  Written with D_ts =
// exp(i_s + F_t - F_s - m_t), a forget gate f_r moves only the pairs that
// straddle it (s < r <= t).  From the forward's h, its a_t and the m_t it
// used (both fp32 [B, S, H]):
//   dN_t = dh_t / den_t,  delta_t = -(dh_t . h_t) / den_t
//   da_t = delta_t sign(a_t) where |a_t| >= exp(-m_t), else 0
//   dP_ts = dN_t . v_s + da_t,  dS_ts = dP_ts D_ts,  Q_ts = dP_ts P_ts
//   dq_t = sum_s dS_ts k~_s,  dk_s = sum_t dS_ts q_t / sqrt(hd),
//   dv_s = sum_t P_ts dN_t,  di_s = sum_{t>=s} Q_ts,
//   df_r = sigmoid(-f_r) sum_{s<r<=t} Q_ts
// df sums the straddling pairs themselves: the equal sum over all pairs
// with t >= r less those with s >= r (with the floor's term) cancels terms
// in the thousands down to 1e-2 where forget gates of -30 cut the
// sequence, and loses every digit in fp32.
// The forward's m_t may differ from the fp64 prefix's F_t + M_t by the
// fp32 recurrence's rounding (kernel 2); the prefix kernel folds that
// difference into M_t, so D, a_t and exp(-m_t) share one scale.
//
// Nothing atomic, every sum in a fixed order (so repeated calls are
// bitwise equal).  Four launches a call in bf16, six in fp32:
//   1. `prep_kernel`: blocks [0, B*H) are the prefix, a block per (b, h):
//      F and M as fp64 scans (as the forward's), g_s = i_s - F_s and the
//      scale-matched M_t in fp64; the rest a warp per (b, t, h): dh_t .
//      h_t, 1 / den_t and da_t.
//   2. `scores_wg` (bf16) / `scores_f32`, a block per (b, h, 64-row query
//      tile, 64-key tile) on or below the diagonal: S = Q K^T and E = dH
//      V^T over all of hd, then P' = P / den_t and dS into an [S, S]
//      workspace per (b, h), and the tile's column and row sums of Q (di's
//      and df's parts) and, on the diagonal, each row's straddling sum
//      inside it.
//   3. bf16: `products_wg`, a block per (b, h, product, 64-row output tile)
//      across all of hd: dV = P'^T dH, dK = dS^T Q / sqrt(hd) and dQ = dS K
//      / sqrt(hd) over the live tiles, each live workspace tile read once
//      per output tile.  fp32: `gemm_f32` three times, a block per (b, h,
//      64-row tile, 64-column slice of hd).
//   4. `gates_kernel`, a block per (b, h, 64-position tile), a thread per
//      position: di_s from the column parts in tile order, and each r's
//      straddling sum from the diagonal's, the row parts of its own tile's
//      rows t >= r and the column parts of the later tiles at s < r (fp64
//      sums, in a fixed order).
// hd = 512 is the design constraint: one 64-key tile's fp32 dK and dV are
// 128 KB each, past the registers and beside Q, dO, K, V past shared
// memory.  Rather than recompute S and dP once per head-dim slice, the
// scores form them once and write P' and dS to device memory (8 * S^2
// bytes per (b, h): 8.4 MB at S = 512 for all of xlstm-350m's 4 heads at
// b = 1); the per-(b, h) workspace is fp64 g and M, fp32 1/den, da and the
// diagonal sums, the tiles' column and row sums of Q ([sp/64][sp] each),
// then P' and dS, each [sp][sp] fp32 on the fp32 path and on the bf16 path
// its bf16 high part [sp][sp] followed by its bf16 low part [sp][sp] (the
// same 4 bytes an element).
//
// bf16 (the training paths): every product on `wgmma`, bf16 operands, fp32
// accumulators, operands in 128-byte-swizzled shared tiles filled by TMA
// (helpers in hopper.cuh) and handed from a producer warp to the consumer
// warpgroups through full/empty mbarriers.  `scores_wg`: one consumer
// warpgroup; the ring holds hd's 64-dim chunks of Q, dH, K and V (S and E
// as m64n64k16, K-major, over the chunks in order); the epilogue on the
// fragments writes P' and dS already split into bf16 high and low parts
// (about 2^-17 relative together, as the forward's PV takes P: where den
// cancels, da_t is large and one bf16 rounding of dP is not enough) into
// shared memory, then to the workspace in 16-byte rows, and the tile's sums
// of Q through shared memory in the parent design's order.  `products_wg`:
// the output tile's 64 rows across all of hd in one or two consumer
// warpgroups (m64nNk16, N = hd or hd / 2 up to 256: 128 fp32 accumulators
// a thread at hd 512); the ring holds a live 64-position step's workspace
// tile (high and low) and the matching 64 rows of dH, Q or K over all of
// hd.  dV and dK read the workspace tile through the A transpose bit
// (MN-major), dQ K-major; dH, Q and K are MN-major B operands through the
// B transpose bit: nothing is transposed in memory.  The high and low
// parts are two wgmmas on the same B.  Output tiles are launched heaviest
// first.  fp32 (the parity paths; `_f32`): the same on the CUDA cores in
// fp32, TF32 unused.  Bound on the H100 at xlstm-350m's training shape (8 x
// 512 tokens, 4 heads of 512): bytes (q, k, v, h, dh read, dq, dk, dv
// written once) over operations (5 products of each causal pair); the
// workspace's P' and dS and the recomputation are this design's cost
// (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::pack_bf16;
using hopper::smem_u32;
using hopper::sw128_desc;
using hopper::tma_3d;
using hopper::tma_4d;
using hopper::tma_rows;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

constexpr int T = 64;             // rows and keys a tile, columns a slice
constexpr int THREADS = 128;      // the fp32 kernels: 4 warps
constexpr int LDF = T + 4;        // fp32 tile row (16-byte aligned rows)
constexpr int GT = 256;           // threads of the prep kernel's blocks
// the bf16 path; mirrored by kernels/mlstm_scan.py (mlstm_bwd_plan)
constexpr int WG = 128;           // threads a warpgroup
constexpr int SC_STAGES = 3;      // scores' ring of 64-dim chunks
constexpr int PR_STAGES = 2;      // products' ring of 64-position steps
constexpr int GATE_THREADS = 64;  // a gates block: one tile's positions
constexpr int GATE_STAGE = 8192;  // floats of a gates block's stage
constexpr int LDS = T + 8;        // bf16 staging row (16-byte aligned rows)
// hd as held in shared memory (hd 32 padded to 64: its chunk's dims past
// hd are the next head's or zeros, and no product reads them)
__host__ __device__ constexpr int hdp(int hd) { return hd < 64 ? 64 : hd; }
// consumer warpgroups of a products block: N = hdp / consumers <= 256
__host__ __device__ constexpr int consumers(int hdp) {
  return hdp > 256 ? 2 : 1;
}
// shared memory of a block in bytes (1024 align the swizzled tiles): the
// ring's stages (Q, dH, K, V chunks; or a workspace tile's high and low
// parts and 64 rows of B over hdp) and each stage's full and empty
// mbarriers
constexpr int scores_smem() { return 1024 + SC_STAGES * (4 * T * 128 + 16); }
constexpr int products_smem(int hdp) {
  return 1024 + PR_STAGES * (2 * T * 128 + T * hdp * 2 + 16);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ double warp_scan_sum(double x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

__device__ __forceinline__ double warp_scan_max(double x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x = fmax(x, y);
  }
  return x;
}

// The per-(b, h) workspace: fp64 g and M (sp each), fp32 1/den, da and
// the diagonal tiles' straddling sums (sp each), Q's column and row sums
// per tile ([tiles][sp] each), fp32 P' and dS ([sp][sp] each).
struct Ws {
  double *g, *mc;
  float *inv, *da, *diag, *part, *rpart, *p, *ds;
};

__host__ __device__ inline int64_t ws_bytes_per_bh(int64_t sp) {
  const int64_t tiles = sp / T;
  return sp * 16 + sp * 12 + 2 * tiles * sp * 4 + 2 * sp * sp * 4;
}

__device__ __forceinline__ Ws carve(uint8_t* base, int64_t bh, int64_t sp) {
  const int64_t tiles = sp / T;
  uint8_t* p = base + bh * ws_bytes_per_bh(sp);
  Ws w;
  w.g = reinterpret_cast<double*>(p);
  w.mc = w.g + sp;
  w.inv = reinterpret_cast<float*>(w.mc + sp);
  w.da = w.inv + sp;
  w.diag = w.da + sp;
  w.part = w.diag + sp;
  w.rpart = w.part + tiles * sp;
  w.p = w.rpart + tiles * sp;
  w.ds = w.p + sp * sp;
  return w;
}

// byte offset of P' in a (b, h)'s workspace (dS follows it: sp^2 * 4 on)
__host__ __device__ inline int64_t p_offset(int64_t sp) {
  return sp * 28 + 2 * (sp / T) * sp * 4;
}

// 1a. A block per (b, h): F_t, M_t as the forward's prefix kernel takes
// them (fp64 scans, log sigmoid in fp32), the forward's stabilizer m_t
// against the prefix's float(F_t + M_t), and g_s = i_s - F_s and the
// scale-matched Mc_t = M_t + (m_t - float(F_t + M_t)) in fp64.  Padding
// rows [S, sp) get 0.
__device__ __forceinline__ void prefix_body(const float* __restrict__ ig,
                                            const float* __restrict__ fg,
                                            const float* __restrict__ m_fwd,
                                            uint8_t* __restrict__ ws,
                                            int64_t s_len, int64_t heads,
                                            int64_t sp, int64_t bh) {
  __shared__ double wsum[GT / 32], wmax[GT / 32], fs[GT];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t b = bh / heads, hh = bh % heads;
  const Ws w = carve(ws, bh, sp);
  double carry_f = 0.0, carry_m = -1e30;
  for (int64_t base = 0; base < sp; base += GT) {
    const int64_t t = base + tid;
    const bool valid = t < s_len;
    const int64_t gi = (b * s_len + t) * heads + hh;
    float fi = 0.f, ii = 0.f;
    if (valid) {
      fi = fg[gi];
      ii = ig[gi];
    }
    const float lf =
        valid ? -(fmaxf(-fi, 0.f) + log1pf(expf(-fabsf(fi)))) : 0.f;
    const double x = warp_scan_sum(static_cast<double>(lf), lane);
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    double f_t = carry_f;
    for (int v = 0; v < warp; ++v) f_t += wsum[v];
    f_t += x;
    const double g = valid ? static_cast<double>(ii) - f_t : -1e300;
    const double mx = warp_scan_max(g, lane);
    if (lane == 31) wmax[warp] = mx;
    fs[tid] = f_t;
    __syncthreads();
    double m_t = carry_m;
    for (int v = 0; v < warp; ++v) m_t = fmax(m_t, wmax[v]);
    m_t = fmax(m_t, mx);
    if (t < sp) {
      double gv = 0.0, mc = 0.0;
      if (valid) {
        const float m_pf = static_cast<float>(f_t + m_t);
        gv = g;
        mc = m_t + (static_cast<double>(m_fwd[gi]) -
                    static_cast<double>(m_pf));
      }
      w.g[t] = gv;
      w.mc[t] = mc;
    }
    double cm = carry_m;
    for (int v = 0; v < GT / 32; ++v) cm = fmax(cm, wmax[v]);
    const double cf = fs[GT - 1];
    __syncthreads();  // the next chunk rewrites the shared sums
    carry_f = cf;
    carry_m = cm;
  }
}

// 1b. A warp per row (b, t, h): 1 / den_t and da_t.
template <typename TT, int HD>
__device__ __forceinline__ void rows_body(const TT* __restrict__ h,
                                          const TT* __restrict__ dh,
                                          const float* __restrict__ a_fwd,
                                          const float* __restrict__ m_fwd,
                                          uint8_t* __restrict__ ws,
                                          int64_t rows, int64_t s_len,
                                          int64_t heads, int64_t sp,
                                          int64_t block) {
  const int64_t row = block * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(to_f32(h[row * HD + d]), to_f32(dh[row * HD + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane != 0) return;
  const int64_t hh = row % heads, bt = row / heads, t = bt % s_len,
                b = bt / s_len;
  const Ws w = carve(ws, b * heads + hh, sp);
  const float a = a_fwd[row], floor_ = expf(-m_fwd[row]);
  const float inv = 1.f / fmaxf(fabsf(a), floor_);
  const float delta = -acc * inv;
  w.inv[t] = inv;
  w.da[t] = fabsf(a) >= floor_ ? (a > 0.f ? delta : -delta) : 0.f;
}

// 1. The prefix's blocks (one per (b, h)) and then the rows' blocks (8
// rows each), in one launch: neither reads what the other writes.
template <typename TT, int HD>
__global__ void __launch_bounds__(GT)
prep_kernel(const float* __restrict__ ig, const float* __restrict__ fg,
            const float* __restrict__ m_fwd, const TT* __restrict__ h,
            const TT* __restrict__ dh, const float* __restrict__ a_fwd,
            uint8_t* __restrict__ ws, int64_t rows, int64_t s_len,
            int64_t heads, int64_t sp, int64_t bhs) {
  const int64_t blk = blockIdx.x;
  if (blk < bhs)
    prefix_body(ig, fg, m_fwd, ws, s_len, heads, sp, blk);
  else
    rows_body<TT, HD>(h, dh, a_fwd, m_fwd, ws, rows, s_len, heads, sp,
                      blk - bhs);
}

// the (query tile, key tile) pair of a linear index over the tiles on or
// below the diagonal: row tt holds tt + 1 pairs
__device__ __forceinline__ void tri(int idx, int& tt, int& st) {
  tt = static_cast<int>((sqrtf(8.f * idx + 1.f) - 1.f) * 0.5f);
  while ((tt + 1) * (tt + 2) / 2 <= idx) ++tt;
  while (tt * (tt + 1) / 2 > idx) --tt;
  st = idx - tt * (tt + 1) / 2;
}

// scores' epilogue for one (row tl, key sl) of the tile: P' and dS
// (`terms`, also dP * P into `red` for the tile's sums), stored to the
// workspace in fp32 by the fp32 path (`operator()`)
struct Epi {
  const double *g, *mc;     // the tile's g_s [T] and Mc_t [T] (shared)
  const float *inv, *da;    // the tile's 1/den_t and da_t (shared)
  float *p, *ds;            // the workspace rows of this (b, h)
  float* red;               // [T][T + 1] shared
  int64_t t0, s0, sp, s_len;
  float scale;

  __device__ __forceinline__ void terms(int tl, int sl, float sv, float ev,
                                        float& pv, float& dsv) const {
    const int64_t t = t0 + tl, s = s0 + sl;
    float r = 0.f;
    pv = dsv = 0.f;
    if (t < s_len && s <= t) {
      const float d = expf(static_cast<float>(g[sl] - mc[tl]));
      const float pr = sv * scale * d;
      const float dp = ev * inv[tl] + da[tl];
      pv = pr * inv[tl];
      dsv = dp * d;
      r = dp * pr;
    }
    red[tl * (T + 1) + sl] = r;
  }

  __device__ __forceinline__ void operator()(int tl, int sl, float sv,
                                             float ev) const {
    float pv, dsv;
    terms(tl, sl, sv, ev, pv, dsv);
    const int64_t t = t0 + tl, s = s0 + sl;
    p[t * sp + s] = pv;
    ds[t * sp + s] = dsv;
  }
};

__device__ __forceinline__ void load_scalars(const Ws& w, int64_t t0,
                                             int64_t s0, double* gs,
                                             double* ms, float* inv,
                                             float* da) {
  const int i = threadIdx.x;
  if (i < T) {
    gs[i] = w.g[s0 + i];
    ms[i] = w.mc[t0 + i];
    inv[i] = w.inv[t0 + i];
    da[i] = w.da[t0 + i];
  }
}

// The tile's sums of Q (`red`, complete once the caller's barrier has
// passed), each in a fixed order: its column sums (threads 0-63) and row
// sums (64-127), and on the diagonal, for each row r, the pairs of the
// tile that straddle it (t >= r > s).
__device__ __forceinline__ void tile_sums(const Ws& w, const float* red,
                                          int tt, int st, int64_t t0,
                                          int64_t s0, int64_t sp) {
  const int i = threadIdx.x;
  float acc = 0.f;
  if (i < T) {
    for (int r = 0; r < T; ++r) acc += red[r * (T + 1) + i];
    w.part[tt * sp + s0 + i] = acc;
  } else {
    for (int c = 0; c < T; ++c) acc += red[(i - T) * (T + 1) + c];
    w.rpart[st * sp + t0 + i - T] = acc;
  }
  if (tt == st && i < T) {
    float d = 0.f;
    for (int r = i; r < T; ++r)
      for (int c = 0; c < i; ++c) d += red[r * (T + 1) + c];
    w.diag[t0 + i] = d;
  }
}

// named barrier 1 over the consumer warpgroup(s) (the producer warp has
// left by then)
template <int N>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// two neighbours' bf16 high parts at `hi` and low parts T * LDS on (the
// rest rounded once more: about 2^-17 relative together)
__device__ __forceinline__ void split_pair(__nv_bfloat16* hi, float v0,
                                           float v1) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(v0),
                      h1 = __float2bfloat16_rn(v1);
  __nv_bfloat162 h, l;
  h.x = h0;
  h.y = h1;
  l.x = __float2bfloat16_rn(v0 - __bfloat162float(h0));
  l.y = __float2bfloat16_rn(v1 - __bfloat162float(h1));
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  *reinterpret_cast<__nv_bfloat162*>(hi + T * LDS) = l;
}

// 2 (bf16). A block per (query tile tt, key tile st, b, h): consumer
// warpgroup (threads 0-127) and producer warp (128-159).  The producer
// sends hd's 64-dim chunks of Q and dH (rows t0..), K and V (rows s0..)
// by TMA into a ring of SC_STAGES stages; the warpgroup accumulates S =
// Q K^T and E = dH V^T (m64n64k16, both operands K-major, over the chunks
// and their 16-dim steps in order, from zeroed accumulators), and its
// fragments hold row 16 warp + lane / 4 (+ 8), key 8 (i / 4) + 2 (lane %
// 4) + i % 2 of element i.  The epilogue computes what `Epi` computes,
// writes Q's terms to `red` and P', dS split into bf16 high and low parts
// to the staging tiles (both over the ring), then the tile's sums and the
// four staged tiles to the workspace in 16-byte rows.
template <int HD>
__global__ void __launch_bounds__(WG + 32)
scores_wg(const __grid_constant__ CUtensorMap mq,
          const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv,
          const __grid_constant__ CUtensorMap mdh, uint8_t* __restrict__ ws,
          int s_len, int heads, int sp, float scale) {
  constexpr int CH = HD < 64 ? HD : 64;  // dims of a chunk the products use
  constexpr int NCH = hdp(HD) / 64;      // chunks
  constexpr uint32_t TILE = T * 128, STAGE = 4 * TILE;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ double gs[T], ms[T];
  __shared__ float inv[T], da[T];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + SC_STAGES * STAGE, empty = full + 8 * SC_STAGES;
  uint8_t* ring_p = smem_raw + (ring - smem_u32(smem_raw));
  int tt, st;
  tri(blockIdx.x, tt, st);
  const int bh = blockIdx.y, b = bh / heads, hh = bh % heads;
  const int t0 = tt * T, s0 = st * T;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < SC_STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= WG) {  // the producer warp: one thread sends
    if (threadIdx.x == WG) {
      for (int c = 0; c < NCH; ++c) {
        const int stg = c % SC_STAGES;
        if (c >= SC_STAGES) mbar_wait(empty + 8 * stg, (c / SC_STAGES - 1) & 1);
        const uint32_t dst = ring + stg * STAGE, bar = full + 8 * stg;
        const int col = hh * HD + c * 64;
        mbar_expect(bar, STAGE);
        tma_3d(dst, &mq, bar, col, t0, b);
        tma_3d(dst + TILE, &mdh, bar, col, t0, b);
        tma_3d(dst + 2 * TILE, &mk, bar, col, s0, b);
        tma_3d(dst + 3 * TILE, &mv, bar, col, s0, b);
      }
    }
    return;
  }
  const Ws w = carve(ws, bh, sp);
  load_scalars(w, t0, s0, gs, ms, inv, da);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float sacc[32], eacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = eacc[i] = 0.f;
  for (int c = 0; c < NCH; ++c) {
    const int stg = c % SC_STAGES;
    mbar_wait(full + 8 * stg, (c / SC_STAGES) & 1);
    const uint32_t qt = ring + stg * STAGE;
    const uint64_t dq = sw128_desc(qt, 16, 1024),
                   ddh = sw128_desc(qt + TILE, 16, 1024),
                   dk = sw128_desc(qt + 2 * TILE, 16, 1024),
                   dv = sw128_desc(qt + 3 * TILE, 16, 1024);
    fence_regs<32>(sacc);
    fence_regs<32>(eacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk)  // 16 dims (32 bytes) a step
      hopper::wgmma_ss_m64n64(sacc, dq + 2 * kk, dk + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk)
      hopper::wgmma_ss_m64n64(eacc, ddh + 2 * kk, dv + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(sacc);
    fence_regs<32>(eacc);
    mbar_arrive(empty + 8 * stg);
  }
  consumers_sync<WG>();  // the ring is read: `red` and the staging reuse it
  float* red = reinterpret_cast<float*>(ring_p);          // [T][T + 1]
  __nv_bfloat16* stage =                                   // 4 x [T][LDS]
      reinterpret_cast<__nv_bfloat16*>(ring_p + T * (T + 1) * 4);
  const Epi epi{gs, ms, inv, da, nullptr, nullptr, red, t0, s0, sp, s_len,
                scale};
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int tl = 16 * warp + lane / 4 + ((i % 4) >= 2 ? 8 : 0);
    const int sl = 8 * (i / 4) + 2 * (lane % 4);
    float p0, p1, d0, d1;
    epi.terms(tl, sl, sacc[i], eacc[i], p0, d0);
    epi.terms(tl, sl + 1, sacc[i + 1], eacc[i + 1], p1, d1);
    split_pair(stage + tl * LDS + sl, p0, p1);           // P' high, low
    split_pair(stage + 2 * T * LDS + tl * LDS + sl, d0, d1);  // dS
  }
  consumers_sync<WG>();
  tile_sums(w, red, tt, st, t0, s0, sp);
  // the staged P' high, low, dS high, low rows to the workspace (each
  // part [sp][sp], the low part after the high)
#pragma unroll
  for (int it = 0; it < 4 * T * 8 / WG; ++it) {
    const int e = it * WG + threadIdx.x;
    const int which = e / (T * 8), r = e / 8 % T, c = e % 8 * 8;
    const uint4 val = *reinterpret_cast<const uint4*>(
        stage + which * T * LDS + r * LDS + c);
    __nv_bfloat16* dst =
        reinterpret_cast<__nv_bfloat16*>(which < 2 ? w.p : w.ds) +
        (which & 1) * static_cast<int64_t>(sp) * sp;
    *reinterpret_cast<uint4*>(dst + static_cast<int64_t>(t0 + r) * sp + s0 +
                              c) = val;
  }
}
// 2 (fp32). Thread (rg, cg) owns rows rg*8 .. +8 and keys cg*4 .. +4 of
// the tile; 32-dim chunks of Q, dH, K, V sit transposed ([dim][row]) in
// shared memory.
template <int HD>
__global__ void __launch_bounds__(THREADS)
scores_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dh,
           uint8_t* __restrict__ ws, int64_t s_len, int64_t heads,
           int64_t sp, float scale) {
  constexpr int CH = 32;
  __shared__ __align__(16) float tiles[4][CH * LDF];
  __shared__ double gs[T], ms[T];
  __shared__ float inv[T], da[T];
  int tt, st;
  tri(blockIdx.x, tt, st);
  const int64_t bh = blockIdx.y, b = bh / heads, hh = bh % heads;
  const int64_t t0 = static_cast<int64_t>(tt) * T,
                s0 = static_cast<int64_t>(st) * T;
  const Ws w = carve(ws, bh, sp);
  load_scalars(w, t0, s0, gs, ms, inv, da);
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const int64_t pos_stride = heads * HD, head0 = (b * s_len * heads + hh) * HD;

  float sacc[8][4], eacc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) sacc[j][c] = eacc[j][c] = 0.f;

  for (int d0 = 0; d0 < HD; d0 += CH) {
    __syncthreads();
    for (int e = threadIdx.x; e < 4 * T * CH; e += THREADS) {
      const int which = e / (T * CH), r = e / CH % T, c = e % CH;
      const float* src = which == 0 ? q : which == 1 ? dh : which == 2 ? k : v;
      const int64_t pos = (which < 2 ? t0 : s0) + r;
      float val = 0.f;
      if (pos < s_len && d0 + c < HD) val = src[head0 + pos * pos_stride + d0 + c];
      tiles[which][c * LDF + r] = val;
    }
    __syncthreads();
#pragma unroll 4
    for (int d = 0; d < CH; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&tiles[0][d * LDF + rg * 8]);
      const float4 qb = *reinterpret_cast<const float4*>(&tiles[0][d * LDF + rg * 8 + 4]);
      const float4 ga = *reinterpret_cast<const float4*>(&tiles[1][d * LDF + rg * 8]);
      const float4 gb = *reinterpret_cast<const float4*>(&tiles[1][d * LDF + rg * 8 + 4]);
      const float4 kk = *reinterpret_cast<const float4*>(&tiles[2][d * LDF + cg * 4]);
      const float4 vv = *reinterpret_cast<const float4*>(&tiles[3][d * LDF + cg * 4]);
      const float qr[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      const float gr[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      const float kc[4] = {kk.x, kk.y, kk.z, kk.w};
      const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sacc[j][c] = fmaf(qr[j], kc[c], sacc[j][c]);
          eacc[j][c] = fmaf(gr[j], vc[c], eacc[j][c]);
        }
    }
  }
  __syncthreads();
  float* red = &tiles[0][0];   // T * (T + 1) floats fit in the 4 tiles
  const Epi epi{gs, ms, inv, da, w.p, w.ds, red, t0, s0, sp, s_len, scale};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) epi(rg * 8 + j, cg * 4 + c, sacc[j][c], eacc[j][c]);
  __syncthreads();
  tile_sums(w, red, tt, st, t0, s0, sp);
}

// 3 (fp32). out[r, c0 + c] = alpha * sum_j A(r, j) B[j, c0 + c] for one
// (b, h), a 64-row tile and a 64-column slice of hd, over the live
// 64-position tiles j: A from the workspace ([sp][sp], read as A(r, j) =
// X[r][j], or X[j][r] when `tr`), B a [B, S, H, hd] tensor's rows j.
// `upper`: the live j tiles are those at or after the row tile (dK, dV:
// keys s take rows t >= s), else at or before it (dQ).
struct Gemm {
  int which;          // 0: P', 1: dS
  int tr, upper;
  float alpha;
};

// 3 (bf16). A block per (product, b, h, 64-row output tile), across all
// of hd: blockIdx.x = 3 (b, h) + product (0 dV, 1 dK, 2 dQ), blockIdx.y
// the tile's rank by work (0 the heaviest: dV's and dK's first key tile,
// dQ's last query tile).  out[r, :] = alpha sum_j A(r, j) B[j, :] over
// the live 64-position steps j: dV, dK take keys s's rows t >= s (steps
// from the tile on) with A(s, t) = P'[t][s] or dS[t][s], read from the
// workspace tile [t][s] through the A transpose bit; dQ takes rows t's
// keys s <= t (steps up to the tile) with A(t, s) = dS[t][s], K-major.
// B is 64 rows of dH, Q or K over hdp (MN-major, the B transpose bit).
// The producer warp (the last 32 threads) sends each step's high and low
// workspace tiles and its B rows by TMA into a ring of PR_STAGES stages;
// each consumer warpgroup w owns output columns [w N, (w + 1) N) and runs
// per 16-position step the high and then the low part on the same B.
template <int HD, int TA>
__device__ __forceinline__ void product_steps(float* acc, uint32_t ring,
                                              uint32_t full, uint32_t empty,
                                              int n_steps, int wg) {
  constexpr int HDP = hdp(HD), N = HDP / consumers(HDP);
  constexpr uint32_t A_B = T * 128, STAGE = 2 * A_B + T * HDP * 2;
  // A: K-major steps of 32 bytes, or MN-major steps of 16 rows (2048
  // bytes); B: MN-major, 64-column blocks T * 128 bytes apart
  constexpr uint32_t A_STEP = TA ? 2048 >> 4 : 32 >> 4;
  for (int j = 0; j < n_steps; ++j) {
    const int stg = j % PR_STAGES;
    mbar_wait(full + 8 * stg, (j / PR_STAGES) & 1);
    const uint32_t ahi = ring + stg * STAGE, alo = ahi + A_B;
    const uint32_t bt = ahi + 2 * A_B + wg * (N / 64) * (T * 128);
    const uint64_t dhi = sw128_desc(ahi, TA ? T * 128 : 16, 1024),
                   dlo = sw128_desc(alo, TA ? T * 128 : 16, 1024),
                   db = sw128_desc(bt, T * 128, 1024);
    fence_regs<N / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      if constexpr (N == 256) {
        hopper::wgmma_ss_m64n256_bmn<TA>(acc, dhi + kk * A_STEP, db + kk * 128);
        hopper::wgmma_ss_m64n256_bmn<TA>(acc, dlo + kk * A_STEP, db + kk * 128);
      } else if constexpr (N == 128) {
        hopper::wgmma_ss_m64n128_bmn<TA>(acc, dhi + kk * A_STEP, db + kk * 128);
        hopper::wgmma_ss_m64n128_bmn<TA>(acc, dlo + kk * A_STEP, db + kk * 128);
      } else {
        hopper::wgmma_ss_m64n64_bmn<TA>(acc, dhi + kk * A_STEP, db + kk * 128);
        hopper::wgmma_ss_m64n64_bmn<TA>(acc, dlo + kk * A_STEP, db + kk * 128);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<N / 2>(acc);
    mbar_arrive(empty + 8 * stg);
  }
}

template <int HD>
__global__ void __launch_bounds__(consumers(hdp(HD)) * WG + 32, 1)
products_wg(const __grid_constant__ CUtensorMap mq,
            const __grid_constant__ CUtensorMap mk,
            const __grid_constant__ CUtensorMap mdh,
            const __grid_constant__ CUtensorMap mp,   // P' (high, low)
            const __grid_constant__ CUtensorMap mds,  // dS (high, low)
            __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
            __nv_bfloat16* __restrict__ dv, int s_len, int heads, int tiles,
            float scale) {
  constexpr int HDP = hdp(HD), W = consumers(HDP), N = HDP / W;
  constexpr uint32_t A_B = T * 128, STAGE = 2 * A_B + T * HDP * 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + PR_STAGES * STAGE, empty = full + 8 * PR_STAGES;
  const int prod = blockIdx.x % 3, bh = blockIdx.x / 3;
  const int b = bh / heads, hh = bh % heads, rank = blockIdx.y;
  const int rt = prod < 2 ? rank : tiles - 1 - rank;
  const int j0 = prod < 2 ? rt : 0, n_steps = prod < 2 ? tiles - rt : rt + 1;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < PR_STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, W * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= W * WG) {  // the producer warp: one thread sends
    if (threadIdx.x == W * WG) {
      const CUtensorMap* am = prod == 0 ? &mp : &mds;
      const CUtensorMap* bm = prod == 0 ? &mdh : prod == 1 ? &mq : &mk;
      for (int j = 0; j < n_steps; ++j) {
        const int stg = j % PR_STAGES, jt = j0 + j;
        if (j >= PR_STAGES)
          mbar_wait(empty + 8 * stg, (j / PR_STAGES - 1) & 1);
        const uint32_t dst = ring + stg * STAGE, bar = full + 8 * stg;
        // the workspace tile [t][s]: rows jt, keys rt (dV, dK) or rows rt,
        // keys jt (dQ)
        const int col = (prod < 2 ? rt : jt) * T;
        const int row = (prod < 2 ? jt : rt) * T;
        mbar_expect(bar, STAGE);
        tma_4d(dst, am, bar, col, row, 0, bh);
        tma_4d(dst + A_B, am, bar, col, row, 1, bh);
        tma_rows<HDP, T>(dst + 2 * A_B, bm, bar, HD, hh, jt * T, b);
      }
    }
    return;
  }
  const int wg = threadIdx.x / WG, warp = threadIdx.x % WG / 32;
  const int lane = threadIdx.x % 32;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  if (prod == 2)  // uniform over the block
    product_steps<HD, 0>(acc, ring, full, empty, n_steps, wg);
  else
    product_steps<HD, 1>(acc, ring, full, empty, n_steps, wg);
  const float alpha = prod == 0 ? 1.f : scale;
  __nv_bfloat16* out = prod == 0 ? dv : prod == 1 ? dk : dq;
  const int64_t pos_stride = static_cast<int64_t>(heads) * HD;
  const int64_t head0 = (static_cast<int64_t>(b) * s_len * heads + hh) * HD;
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int col = wg * N + 8 * (i / 4) + 2 * (lane % 4);
    const int pos = rt * T + 16 * warp + lane / 4 + ((i % 4) >= 2 ? 8 : 0);
    if (col < HD && pos < s_len)
      *reinterpret_cast<uint32_t*>(out + head0 + pos * pos_stride + col) =
          pack_bf16(acc[i] * alpha, acc[i + 1] * alpha);
  }
}
template <int HD>
__global__ void __launch_bounds__(THREADS)
gemm_f32(const float* __restrict__ bsrc, uint8_t* __restrict__ ws,
         float* __restrict__ out, int64_t s_len, int64_t heads, int64_t sp,
         Gemm gm) {
  __shared__ __align__(16) float at[T * LDF], bs[T * LDF];  // [j][r], [j][c]
  const int rt = blockIdx.x, c0 = blockIdx.y * T;
  const int64_t bh = blockIdx.z, b = bh / heads, hh = bh % heads;
  const int tiles = static_cast<int>(sp / T);
  const Ws w = carve(ws, bh, sp);
  const float* x = gm.which ? w.ds : w.p;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const int64_t pos_stride = heads * HD, head0 = (b * s_len * heads + hh) * HD;
  const int64_t r0 = static_cast<int64_t>(rt) * T;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  const int j_begin = gm.upper ? rt : 0, j_end = gm.upper ? tiles : rt + 1;
  for (int jt = j_begin; jt < j_end; ++jt) {
    const int64_t j0 = static_cast<int64_t>(jt) * T;
    __syncthreads();
    for (int e = threadIdx.x; e < T * T; e += THREADS) {
      const int r = gm.tr ? e % T : e / T, j = gm.tr ? e / T : e % T;
      at[j * LDF + r] = gm.tr ? x[(j0 + j) * sp + r0 + r]
                              : x[(r0 + r) * sp + j0 + j];
      const int jb = e / T, cb = e % T;
      const int64_t pos = j0 + jb;
      bs[jb * LDF + cb] = (pos < s_len && c0 + cb < HD)
                              ? bsrc[head0 + pos * pos_stride + c0 + cb]
                              : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < T; ++j) {
      const float4 xa = *reinterpret_cast<const float4*>(&at[j * LDF + rg * 8]);
      const float4 xb = *reinterpret_cast<const float4*>(&at[j * LDF + rg * 8 + 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&bs[j * LDF + cg * 4]);
      const float xr[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float bc[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xr[r], bc[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int64_t pos = r0 + rg * 8 + r;
    if (pos >= s_len) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = c0 + cg * 4 + c;
      if (col < HD) out[head0 + pos * pos_stride + col] = acc[r][c] * gm.alpha;
    }
  }
}

// 4. A block per (b, h, 64-position tile), a thread per position: di_s =
// the column parts of the tiles at or after s's; for r in tile R, the
// pairs straddling r: the diagonal tile's, the row parts (tiles before R)
// of R's rows t >= r, and the column parts of the tiles after R at every
// s < r; df_r = that sum (fp64, in a fixed order) times sigmoid(-f_r).
// The parts a block's chains read go through shared memory first, as
// many tiles' rows at a time as GATE_STAGE floats hold (up to 128 tiles;
// past that the chains read device memory), so a chain waits on shared
// memory, not on a load a step.
template <bool STAGED>
__device__ __forceinline__ double gate_chains(const Ws& w, float* stage,
                                              int64_t tile, int64_t tiles,
                                              int64_t r, int64_t sp) {
  const int64_t t0 = tile * T, end = t0 + T;
  double g = w.diag[r];
  if constexpr (STAGED) {  // R's rows' parts of the tiles before it
    for (int64_t e = threadIdx.x; e < tile * T; e += GATE_THREADS)
      stage[e] = w.rpart[(e / T) * sp + t0 + e % T];
    __syncthreads();
    for (int64_t t = r; t < end; ++t)
      for (int64_t st = 0; st < tile; ++st) g += stage[st * T + t - t0];
  } else {
    for (int64_t t = r; t < end; ++t)
      for (int64_t st = 0; st < tile; ++st) g += w.rpart[st * sp + t];
  }
  if constexpr (STAGED) {  // the later tiles' columns s < end, in rounds
    const int64_t per = GATE_STAGE / end;
    for (int64_t tt0 = tile + 1; tt0 < tiles; tt0 += per) {
      const int64_t n = (tiles - tt0 < per ? tiles - tt0 : per) * end;
      __syncthreads();  // the previous round is read
      for (int64_t e = threadIdx.x; e < n; e += GATE_THREADS)
        stage[e] = w.part[(tt0 + e / end) * sp + e % end];
      __syncthreads();
      for (int64_t k = 0; k < n / end; ++k)
        for (int64_t s = 0; s < r; ++s) g += stage[k * end + s];
    }
  } else {
    for (int64_t tt = tile + 1; tt < tiles; ++tt)
      for (int64_t s = 0; s < r; ++s) g += w.part[tt * sp + s];
  }
  return g;
}

__global__ void __launch_bounds__(GATE_THREADS)
gates_kernel(const float* __restrict__ fg, uint8_t* __restrict__ ws,
             float* __restrict__ di, float* __restrict__ df, int64_t s_len,
             int64_t heads, int64_t sp) {
  __shared__ float stage[GATE_STAGE];
  const int64_t bh = blockIdx.y, b = bh / heads, hh = bh % heads;
  const Ws w = carve(ws, bh, sp);
  const int64_t tiles = sp / T, tile = blockIdx.x;
  // positions past S run the chains too (uniform barriers), unstored
  const int64_t r = tile * T + threadIdx.x;
  const double g = tile < GATE_STAGE / T
                       ? gate_chains<true>(w, stage, tile, tiles, r, sp)
                       : gate_chains<false>(w, stage, tile, tiles, r, sp);
  if (r < s_len) {
    const int64_t gi = (b * s_len + r) * heads + hh;
    float col = 0.f;
    for (int64_t tt = tile; tt < tiles; ++tt) col += w.part[tt * sp + r];
    di[gi] = col;
    df[gi] = static_cast<float>(g) / (1.f + expf(fg[gi]));
  }
}

// the kernel launches this library has made (each launch's error checked
// right after it, and counted when there is none): the tests and checks
// read how many one call makes
std::atomic<int64_t> launched{0};

cudaError_t counted(cudaError_t e) {
  if (e == cudaSuccess) ++launched;
  return e;
}

// the fp32 path: prep, scores, three products, gates
template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const void* ig,
               const void* fg, const void* h, const void* a, const void* m,
               const void* dh, void* dq, void* dk, void* dv, void* di,
               void* df, void* ws, int64_t b, int64_t s, int64_t heads,
               float scale, cudaStream_t st) {
  const int64_t bh = b * heads, tiles = (s + T - 1) / T, sp = tiles * T;
  const int64_t rows = b * s * heads;
  const int64_t pairs = tiles * (tiles + 1) / 2;
  if (bh > 65535 || pairs > 2147483647LL ||
      bh + (rows + 7) / 8 > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  uint8_t* w = static_cast<uint8_t*>(ws);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dhp = static_cast<const float*>(dh);
  prep_kernel<float, HD>
      <<<static_cast<unsigned>(bh + (rows + 7) / 8), GT, 0, st>>>(
          static_cast<const float*>(ig), static_cast<const float*>(fg),
          static_cast<const float*>(m), static_cast<const float*>(h), dhp,
          static_cast<const float*>(a), w, rows, s, heads, sp, bh);
  cudaError_t e = counted(cudaGetLastError());
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 sgrid(static_cast<unsigned>(pairs), static_cast<unsigned>(bh));
  scores_f32<HD><<<sgrid, THREADS, 0, st>>>(qp, kp, vp, dhp, w, s, heads, sp,
                                            scale);
  e = counted(cudaGetLastError());
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 ggrid(static_cast<unsigned>(tiles),
                   static_cast<unsigned>((HD + T - 1) / T),
                   static_cast<unsigned>(bh));
  // dV = P'^T dH, dK = dS^T Q / sqrt(hd), dQ = dS K / sqrt(hd)
  const Gemm g_dv{0, 1, 1, 1.f}, g_dk{1, 1, 1, scale}, g_dq{1, 0, 0, scale};
  const float* srcs[3] = {dhp, qp, kp};
  void* outs[3] = {dv, dk, dq};
  const Gemm gms[3] = {g_dv, g_dk, g_dq};
  for (int i = 0; i < 3; ++i) {
    gemm_f32<HD><<<ggrid, THREADS, 0, st>>>(
        srcs[i], w, static_cast<float*>(outs[i]), s, heads, sp, gms[i]);
    e = counted(cudaGetLastError());
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gates_kernel<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(bh)),
                 GATE_THREADS, 0, st>>>(static_cast<const float*>(fg), w,
                                        static_cast<float*>(di),
                                        static_cast<float*>(df), s, heads, sp);
  return static_cast<int>(counted(cudaGetLastError()));
}

// the TMA map of one workspace array pair (P' or dS: high part [sp][sp]
// then low part) of every (b, h): [bh][2][sp][sp] bf16 with the (b, h)
// stride of the workspace, boxes of one 64 x 64 tile
bool ws_map(CUtensorMap* m, uint8_t* ws, int64_t off, int64_t sp,
            int64_t bh) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(sp),
                              static_cast<cuuint64_t>(sp), 2,
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sp * 2),
                                 static_cast<cuuint64_t>(sp * sp * 2),
                                 static_cast<cuuint64_t>(ws_bytes_per_bh(sp))};
  const cuuint32_t box[4] = {T, T, 1, 1};
  return hopper::bf16_map(m, ws + off, 4, dims, strides, box);
}

// the bf16 path: prep, scores, the three products in one launch, gates
template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* ig,
              const void* fg, const void* h, const void* a, const void* m,
              const void* dh, void* dq, void* dk, void* dv, void* di,
              void* df, void* ws, int64_t b, int64_t s, int64_t heads,
              float scale, cudaStream_t st) {
  using bf = __nv_bfloat16;
  constexpr int HDP = hdp(HD), S1 = scores_smem(), S2 = products_smem(HDP);
  static bool smem_set = false;  // the attributes hold for the process
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        scores_wg<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, S1);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(products_wg<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, S2);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const int64_t bh = b * heads, tiles = (s + T - 1) / T, sp = tiles * T;
  const int64_t rows = b * s * heads;
  const int64_t pairs = tiles * (tiles + 1) / 2;
  // positions are 32-bit inside the kernels, as are TMA's coordinates
  if (bh > 65535 || pairs > 2147483647LL || tiles > 65535 ||
      bh + (rows + 7) / 8 > 2147483647LL || sp > INT_MAX / 4 ||
      heads * HD > INT_MAX / 4)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  uint8_t* w = static_cast<uint8_t*>(ws);
  CUtensorMap mq, mk, mv, mdh, mp, mds;
  if (!hopper::row_map(&mq, q, b, s, heads * HD, T) ||
      !hopper::row_map(&mk, k, b, s, heads * HD, T) ||
      !hopper::row_map(&mv, v, b, s, heads * HD, T) ||
      !hopper::row_map(&mdh, dh, b, s, heads * HD, T) ||
      !ws_map(&mp, w, p_offset(sp), sp, bh) ||
      !ws_map(&mds, w, p_offset(sp) + sp * sp * 4, sp, bh))
    return static_cast<int>(cudaErrorInvalidValue);
  prep_kernel<bf, HD>
      <<<static_cast<unsigned>(bh + (rows + 7) / 8), GT, 0, st>>>(
          static_cast<const float*>(ig), static_cast<const float*>(fg),
          static_cast<const float*>(m), static_cast<const bf*>(h),
          static_cast<const bf*>(dh), static_cast<const float*>(a), w, rows, s,
          heads, sp, bh);
  cudaError_t e = counted(cudaGetLastError());
  if (e != cudaSuccess) return static_cast<int>(e);
  scores_wg<HD><<<dim3(static_cast<unsigned>(pairs),
                       static_cast<unsigned>(bh)),
                  WG + 32, S1, st>>>(mq, mk, mv, mdh, w, static_cast<int>(s),
                                     static_cast<int>(heads),
                                     static_cast<int>(sp), scale);
  e = counted(cudaGetLastError());
  if (e != cudaSuccess) return static_cast<int>(e);
  products_wg<HD><<<dim3(static_cast<unsigned>(3 * bh),
                         static_cast<unsigned>(tiles)),
                    consumers(HDP) * WG + 32, S2, st>>>(
      mq, mk, mdh, mp, mds, static_cast<bf*>(dq), static_cast<bf*>(dk),
      static_cast<bf*>(dv), static_cast<int>(s), static_cast<int>(heads),
      static_cast<int>(tiles), scale);
  e = counted(cudaGetLastError());
  if (e != cudaSuccess) return static_cast<int>(e);
  gates_kernel<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(bh)),
                 GATE_THREADS, 0, st>>>(static_cast<const float*>(fg), w,
                                        static_cast<float*>(di),
                                        static_cast<float*>(df), s, heads, sp);
  return static_cast<int>(counted(cudaGetLastError()));
}

}  // namespace

// q, k, v, h, dh, dq, dk, dv: contiguous [B, S, H, hd], all fp32 (dtype 0)
// or all bf16 (dtype 1, 16-byte aligned); i_gate, f_gate, a, m, di, df:
// contiguous fp32 [B, S, H] (a and m the forward's signed row sum and
// stabilizer); ws: B * H * ws_bytes_per_bh(sp) bytes, 16-byte aligned, sp
// = S rounded up to 64 (`bwd_workspace_bytes` in kernels/mlstm_scan.py).
// hd in 32 .. 512, a power of two.  Four launches (bf16) or six (fp32) on
// `stream`, no synchronisation; returns the first error.
extern "C" int repro_mlstm_scan_bwd(
    const void* q, const void* k, const void* v, const void* i_gate,
    const void* f_gate, const void* h, const void* a, const void* m,
    const void* dh, void* dq, void* dk, void* dv, void* di, void* df,
    void* ws, int64_t b, int64_t s, int64_t heads, int64_t hd, float scale,
    int dtype, void* stream) {
  if (b == 0 || s == 0 || heads == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_MLSTM_BWD(FN, HD)                                              \
  case HD:                                                                   \
    return FN<HD>(q, k, v, i_gate, f_gate, h, a, m, dh, dq, dk, dv, di, df,  \
                  ws, b, s, heads, scale, st);
  if (dtype == 0) {
    switch (hd) {
      REPRO_MLSTM_BWD(launch_f32, 32)
      REPRO_MLSTM_BWD(launch_f32, 64)
      REPRO_MLSTM_BWD(launch_f32, 128)
      REPRO_MLSTM_BWD(launch_f32, 256)
      REPRO_MLSTM_BWD(launch_f32, 512)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 1) {
    switch (hd) {
      REPRO_MLSTM_BWD(launch_tc, 32)
      REPRO_MLSTM_BWD(launch_tc, 64)
      REPRO_MLSTM_BWD(launch_tc, 128)
      REPRO_MLSTM_BWD(launch_tc, 256)
      REPRO_MLSTM_BWD(launch_tc, 512)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef REPRO_MLSTM_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// the kernel launches made so far by repro_mlstm_scan_bwd in this process
extern "C" int64_t repro_mlstm_scan_bwd_launches() { return launched; }
