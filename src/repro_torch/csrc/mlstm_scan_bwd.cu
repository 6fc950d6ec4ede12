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
// Seven launches a call, nothing atomic, every sum in a fixed order (so
// repeated calls are bitwise equal):
//   1. `prefix_kernel`, a block per (b, h): F and M as fp64 scans (as the
//      forward's), g_s = i_s - F_s and the scale-matched M_t in fp64.
//   2. `rows_kernel`, a warp per (b, t, h): dh_t . h_t, 1 / den_t and da_t.
//   3. `scores_tc` / `scores_f32`, a block per (b, h, 64-row query tile, 64-key tile)
//      on or below the diagonal: S = Q K^T and E = dH V^T over all of hd,
//      then P' = P / den_t and dS in fp32 into an [S, S] workspace per
//      (b, h), and the tile's column and row sums of Q (di's and df's
//      parts) and, on the diagonal, each row's straddling sum inside it.
//   4. `gemm_tc` / `gemm_f32` three times, a block per (b, h, 64-row tile, 64-column
//      slice of hd): dV = P'^T dH, dK = dS^T Q / sqrt(hd) and
//      dQ = dS K / sqrt(hd) over the live tiles.
//   5. `gates_kernel`, a block per (b, h): di_s from the column parts in
//      tile order, and each r's straddling sum from the diagonal's, the
//      row parts of its own tile's rows t >= r and the column parts of the
//      later tiles at s < r (fp64 sums, in a fixed order).
// hd = 512 is the design constraint: one 64-key tile's fp32 dK and dV are
// 128 KB each, past the registers and beside Q, dO, K, V past shared
// memory.  Rather than recompute S and dP once per head-dim slice (eight
// times at hd 512), kernel 3 forms them once and writes P' and dS to
// device memory (8 * S^2 bytes per (b, h): 8.4 MB at S = 512 for all of
// xlstm-350m's 4 heads at b = 1), and the products of kernel 4 each own a
// 64 x 64 output tile of one slice.
//
// bf16 (the training paths; the `_tc` kernels): S and E on the tensor cores (mma.sync
// m16n8k16, bf16 operands exact, fp32 accumulators); the products of
// kernel 4 take P' and dS as two bf16 parts each (high and low, about
// 2^-17 relative, as the forward's PV takes P: where den cancels, da_t is
// large and one bf16 rounding of dP is not enough) against the exact bf16
// dH, Q and K.  fp32 (the parity paths; `_f32`): the same on the CUDA cores
// in fp32, TF32 unused.  Bound on the H100 at xlstm-350m's training shape
// (8 x 512 tokens, 4 heads of 512): bytes (q, k, v, h, dh read, dq, dk,
// dv written once) over operations (5 products of each causal pair); the
// workspace's P' and dS and the recomputation are this design's cost
// (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::a_frag;
using hopper::b_frag;
using hopper::mma;
using hopper::pack_bf16;

constexpr int T = 64;             // rows and keys a tile, columns a slice
constexpr int THREADS = 128;      // 4 warps
constexpr int LDB = T + 8;        // bf16 tile row (no bank conflicts)
constexpr int LDF = T + 4;        // fp32 tile row (16-byte aligned rows)
constexpr int GT = 256;           // threads of the per-(b, h) scans

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

// 1. A block per (b, h): F_t, M_t as the forward's prefix kernel takes
// them (fp64 scans, log sigmoid in fp32), the forward's stabilizer m_t
// against the prefix's float(F_t + M_t), and g_s = i_s - F_s and the
// scale-matched Mc_t = M_t + (m_t - float(F_t + M_t)) in fp64.  Padding
// rows [S, sp) get 0.
__global__ void __launch_bounds__(GT)
prefix_kernel(const float* __restrict__ ig, const float* __restrict__ fg,
              const float* __restrict__ m_fwd, uint8_t* __restrict__ ws,
              int64_t s_len, int64_t heads, int64_t sp) {
  __shared__ double wsum[GT / 32], wmax[GT / 32], fs[GT];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t bh = blockIdx.x, b = bh / heads, hh = bh % heads;
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

// 2. A warp per row (b, t, h): 1 / den_t and da_t.
template <typename TT, int HD>
__global__ void __launch_bounds__(256)
rows_kernel(const TT* __restrict__ h, const TT* __restrict__ dh,
            const float* __restrict__ a_fwd, const float* __restrict__ m_fwd,
            uint8_t* __restrict__ ws, int64_t rows, int64_t s_len,
            int64_t heads, int64_t sp) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
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

// the (query tile, key tile) pair of a linear index over the tiles on or
// below the diagonal: row tt holds tt + 1 pairs
__device__ __forceinline__ void tri(int idx, int& tt, int& st) {
  tt = static_cast<int>((sqrtf(8.f * idx + 1.f) - 1.f) * 0.5f);
  while ((tt + 1) * (tt + 2) / 2 <= idx) ++tt;
  while (tt * (tt + 1) / 2 > idx) --tt;
  st = idx - tt * (tt + 1) / 2;
}

// scores' epilogue for one (row tl, key sl) of the tile: P' and dS into
// the workspace, dP * P into `red` for di's column sums
struct Epi {
  const double *g, *mc;     // the tile's g_s [T] and Mc_t [T] (shared)
  const float *inv, *da;    // the tile's 1/den_t and da_t (shared)
  float *p, *ds;            // the workspace rows of this (b, h)
  float* red;               // [T][T + 1] shared
  int64_t t0, s0, sp, s_len;
  float scale;

  __device__ __forceinline__ void operator()(int tl, int sl, float sv,
                                             float ev) const {
    const int64_t t = t0 + tl, s = s0 + sl;
    float pv = 0.f, dsv = 0.f, r = 0.f;
    if (t < s_len && s <= t) {
      const float d = expf(static_cast<float>(g[sl] - mc[tl]));
      const float pr = sv * scale * d;
      const float dp = ev * inv[tl] + da[tl];
      pv = pr * inv[tl];
      dsv = dp * d;
      r = dp * pr;
    }
    p[t * sp + s] = pv;
    ds[t * sp + s] = dsv;
    red[tl * (T + 1) + sl] = r;
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

// The tile's sums of Q (`red`), each in a fixed order: its column sums
// (threads 0-63) and row sums (64-127), and on the diagonal, for each row
// r, the pairs of the tile that straddle it (t >= r > s).
__device__ __forceinline__ void tile_sums(const Ws& w, const float* red,
                                          int tt, int st, int64_t t0,
                                          int64_t s0, int64_t sp) {
  __syncthreads();
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

// 3 (bf16). Warp w owns query rows w*16 .. +16 of the tile, all 64 keys:
// S and E accumulate over hd in 64-dim chunks of Q, dH, K, V in shared
// memory, rows padded to LDB.
template <int HD>
__global__ void __launch_bounds__(THREADS)
scores_tc(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          const __nv_bfloat16* __restrict__ dh, uint8_t* __restrict__ ws,
          int64_t s_len, int64_t heads, int64_t sp, float scale) {
  __shared__ __align__(16) __nv_bfloat16 tiles[4][T * LDB];
  __shared__ double gs[T], ms[T];
  __shared__ float inv[T], da[T];
  int tt, st;
  tri(blockIdx.x, tt, st);
  const int64_t bh = blockIdx.y, b = bh / heads, hh = bh % heads;
  const int64_t t0 = static_cast<int64_t>(tt) * T,
                s0 = static_cast<int64_t>(st) * T;
  const Ws w = carve(ws, bh, sp);
  load_scalars(w, t0, s0, gs, ms, inv, da);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int64_t pos_stride = heads * HD, head0 = (b * s_len * heads + hh) * HD;

  float sacc[T / 8][4], eacc[T / 8][4];
#pragma unroll
  for (int n = 0; n < T / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) sacc[n][i] = eacc[n][i] = 0.f;

  constexpr int CH = HD < T ? HD : T;        // dims a chunk
  for (int d0 = 0; d0 < HD; d0 += CH) {
    __syncthreads();  // the previous chunk's tiles are used
    for (int e = threadIdx.x; e < 4 * T * (T / 8); e += THREADS) {
      const int which = e / (T * (T / 8)), r = e / (T / 8) % T,
                c = (e % (T / 8)) * 8;
      const __nv_bfloat16* src = which == 0 ? q : which == 1 ? dh
                                 : which == 2 ? k : v;
      const int64_t pos = (which < 2 ? t0 : s0) + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (pos < s_len && c < CH)
        val = *reinterpret_cast<const uint4*>(src + head0 + pos * pos_stride +
                                              d0 + c);
      *reinterpret_cast<uint4*>(&tiles[which][r * LDB + c]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      uint32_t aq[4], ad[4];
      a_frag(aq, tiles[0], LDB, warp * 16, kk * 16);
      a_frag(ad, tiles[1], LDB, warp * 16, kk * 16);
#pragma unroll
      for (int n = 0; n < T / 8; ++n) {
        uint32_t b0, b1;
        b_frag(b0, b1, tiles[2], LDB, n * 8, kk * 16);
        mma(sacc[n], aq, b0, b1);
        b_frag(b0, b1, tiles[3], LDB, n * 8, kk * 16);
        mma(eacc[n], ad, b0, b1);
      }
    }
  }
  __syncthreads();  // every warp is done with the tiles: `red` reuses them
  float* red = reinterpret_cast<float*>(&tiles[0][0]);
  const Epi epi{gs, ms, inv, da, w.p, w.ds, red, t0, s0, sp, s_len, scale};
#pragma unroll
  for (int n = 0; n < T / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      epi(warp * 16 + g + (i >= 2 ? 8 : 0), n * 8 + c2 + (i & 1), sacc[n][i],
          eacc[n][i]);
  tile_sums(w, red, tt, st, t0, s0, sp);
}

// 3 (fp32). Thread (rg, cg) owns rows rg*8 .. +8 and keys cg*4 .. +4 of
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
  tile_sums(w, red, tt, st, t0, s0, sp);
}

// 4. out[r, c0 + c] = alpha * sum_j A(r, j) B[j, c0 + c] for one (b, h), a
// 64-row tile and a 64-column slice of hd, over the live 64-position tiles
// j: A from the workspace ([sp][sp], read as A(r, j) = X[r][j], or
// X[j][r] when `tr`), B a [B, S, H, hd] tensor's rows j.  `upper`: the
// live j tiles are those at or after the row tile (dK, dV: keys s take
// rows t >= s), else at or before it (dQ).
struct Gemm {
  int which;          // 0: P', 1: dS
  int tr, upper;
  float alpha;
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
gemm_tc(const __nv_bfloat16* __restrict__ bsrc, uint8_t* __restrict__ ws,
        __nv_bfloat16* __restrict__ out, int64_t s_len, int64_t heads,
        int64_t sp, Gemm gm) {
  __shared__ __align__(16) __nv_bfloat16 ahi[T * LDB], alo[T * LDB],
      bt[T * LDB];
  const int rt = blockIdx.x, c0 = blockIdx.y * T;
  const int64_t bh = blockIdx.z, b = bh / heads, hh = bh % heads;
  const int tiles = static_cast<int>(sp / T);
  const Ws w = carve(ws, bh, sp);
  const float* x = gm.which ? w.ds : w.p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int64_t pos_stride = heads * HD, head0 = (b * s_len * heads + hh) * HD;
  const int64_t r0 = static_cast<int64_t>(rt) * T;

  float acc[T / 8][4];
#pragma unroll
  for (int n = 0; n < T / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  const int j_begin = gm.upper ? rt : 0, j_end = gm.upper ? tiles : rt + 1;
  for (int jt = j_begin; jt < j_end; ++jt) {
    const int64_t j0 = static_cast<int64_t>(jt) * T;
    __syncthreads();  // the previous tile's operands are used
    for (int e = threadIdx.x; e < T * T; e += THREADS) {
      // coalesced along the workspace row: (r, j) = (e / T, e % T) or
      // (e % T, e / T) when transposed
      const int r = gm.tr ? e % T : e / T, j = gm.tr ? e / T : e % T;
      const float val = gm.tr ? x[(j0 + j) * sp + r0 + r]
                              : x[(r0 + r) * sp + j0 + j];
      const __nv_bfloat16 hi = __float2bfloat16_rn(val);
      ahi[r * LDB + j] = hi;
      alo[r * LDB + j] = __float2bfloat16_rn(val - __bfloat162float(hi));
    }
    for (int e = threadIdx.x; e < T * (T / 8); e += THREADS) {
      const int j = e / (T / 8), c = (e % (T / 8)) * 8;
      const int64_t pos = j0 + j;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (pos < s_len && c0 + c < HD)
        val = *reinterpret_cast<const uint4*>(bsrc + head0 + pos * pos_stride +
                                              c0 + c);
      const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) bt[(c + i) * LDB + j] = xs[i];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      uint32_t ah[4], al[4];
      a_frag(ah, ahi, LDB, warp * 16, kk * 16);
      a_frag(al, alo, LDB, warp * 16, kk * 16);
#pragma unroll
      for (int n = 0; n < T / 8; ++n) {
        uint32_t b0, b1;
        b_frag(b0, b1, bt, LDB, n * 8, kk * 16);
        mma(acc[n], ah, b0, b1);
        mma(acc[n], al, b0, b1);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < T / 8; ++n) {
    const int c = c0 + n * 8 + c2;
    if (c >= HD) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int64_t pos = r0 + warp * 16 + g + 8 * hr;
      if (pos >= s_len) continue;
      *reinterpret_cast<uint32_t*>(out + head0 + pos * pos_stride + c) =
          pack_bf16(acc[n][2 * hr] * gm.alpha, acc[n][2 * hr + 1] * gm.alpha);
    }
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

// 5. A block per (b, h), a thread per position: di_s = the column parts
// of the tiles at or after s's; for r in tile R, the pairs straddling r:
// the diagonal tile's, the row parts (tiles before R) of R's rows t >= r,
// and the column parts of the tiles after R at every s < r; df_r = that
// sum (fp64, in a fixed order) times sigmoid(-f_r).
__global__ void __launch_bounds__(GT)
gates_kernel(const float* __restrict__ fg, uint8_t* __restrict__ ws,
             float* __restrict__ di, float* __restrict__ df, int64_t s_len,
             int64_t heads, int64_t sp) {
  const int64_t bh = blockIdx.x, b = bh / heads, hh = bh % heads;
  const Ws w = carve(ws, bh, sp);
  const int64_t tiles = sp / T;
  for (int64_t r = threadIdx.x; r < s_len; r += GT) {
    const int64_t tile = r / T, gi = (b * s_len + r) * heads + hh;
    float col = 0.f;
    for (int64_t tt = tile; tt < tiles; ++tt) col += w.part[tt * sp + r];
    di[gi] = col;
    double g = w.diag[r];
    for (int64_t t = r; t < (tile + 1) * T; ++t)
      for (int64_t st = 0; st < tile; ++st) g += w.rpart[st * sp + t];
    for (int64_t tt = tile + 1; tt < tiles; ++tt)
      for (int64_t s = 0; s < r; ++s) g += w.part[tt * sp + s];
    df[gi] = static_cast<float>(g) / (1.f + expf(fg[gi]));
  }
}

template <typename TT, int HD>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, const void* h, const void* a, const void* m,
           const void* dh, void* dq, void* dk, void* dv, void* di, void* df,
           void* ws, int64_t b, int64_t s, int64_t heads, float scale,
           cudaStream_t st) {
  constexpr bool BF = sizeof(TT) == 2;
  const int64_t bh = b * heads, tiles = (s + T - 1) / T, sp = tiles * T;
  const int64_t rows = b * s * heads;
  const int64_t pairs = tiles * (tiles + 1) / 2;
  if (bh > 65535 || pairs > 2147483647LL || (rows + 7) / 8 > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  uint8_t* w = static_cast<uint8_t*>(ws);
  const TT* qp = static_cast<const TT*>(q);
  const TT* kp = static_cast<const TT*>(k);
  const TT* vp = static_cast<const TT*>(v);
  const TT* dhp = static_cast<const TT*>(dh);
  const float* mf = static_cast<const float*>(m);
  prefix_kernel<<<static_cast<unsigned>(bh), GT, 0, st>>>(
      static_cast<const float*>(ig), static_cast<const float*>(fg), mf, w, s,
      heads, sp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rows_kernel<TT, HD><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const TT*>(h), dhp, static_cast<const float*>(a), mf, w,
      rows, s, heads, sp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 sgrid(static_cast<unsigned>(pairs), static_cast<unsigned>(bh));
  if constexpr (BF)
    scores_tc<HD><<<sgrid, THREADS, 0, st>>>(qp, kp, vp, dhp, w, s, heads, sp,
                                             scale);
  else
    scores_f32<HD><<<sgrid, THREADS, 0, st>>>(qp, kp, vp, dhp, w, s, heads,
                                              sp, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 ggrid(static_cast<unsigned>(tiles),
                   static_cast<unsigned>((HD + T - 1) / T),
                   static_cast<unsigned>(bh));
  // dV = P'^T dH, dK = dS^T Q / sqrt(hd), dQ = dS K / sqrt(hd)
  const Gemm g_dv{0, 1, 1, 1.f}, g_dk{1, 1, 1, scale}, g_dq{1, 0, 0, scale};
  const void* srcs[3] = {dh, q, k};
  void* outs[3] = {dv, dk, dq};
  const Gemm gms[3] = {g_dv, g_dk, g_dq};
  for (int i = 0; i < 3; ++i) {
    if constexpr (BF)
      gemm_tc<HD><<<ggrid, THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(srcs[i]), w,
          static_cast<__nv_bfloat16*>(outs[i]), s, heads, sp, gms[i]);
    else
      gemm_f32<HD><<<ggrid, THREADS, 0, st>>>(
          static_cast<const float*>(srcs[i]), w, static_cast<float*>(outs[i]),
          s, heads, sp, gms[i]);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gates_kernel<<<static_cast<unsigned>(bh), GT, 0, st>>>(
      static_cast<const float*>(fg), w, static_cast<float*>(di),
      static_cast<float*>(df), s, heads, sp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, h, dh, dq, dk, dv: contiguous [B, S, H, hd], all fp32 (dtype 0)
// or all bf16 (dtype 1, 16-byte aligned); i_gate, f_gate, a, m, di, df:
// contiguous fp32 [B, S, H] (a and m the forward's signed row sum and
// stabilizer); ws: B * H * ws_bytes_per_bh(sp) bytes, sp = S rounded up
// to 64 (`bwd_workspace_bytes` in kernels/mlstm_scan.py).  hd in 32 .. 512, a
// power of two.  Seven launches on `stream`, no synchronisation; returns
// the first cudaGetLastError() that is not 0.
extern "C" int repro_mlstm_scan_bwd(
    const void* q, const void* k, const void* v, const void* i_gate,
    const void* f_gate, const void* h, const void* a, const void* m,
    const void* dh, void* dq, void* dk, void* dv, void* di, void* df,
    void* ws, int64_t b, int64_t s, int64_t heads, int64_t hd, float scale,
    int dtype, void* stream) {
  if (b == 0 || s == 0 || heads == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_MLSTM_BWD(TT, HD)                                              \
  case HD:                                                                   \
    return launch<TT, HD>(q, k, v, i_gate, f_gate, h, a, m, dh, dq, dk, dv,  \
                          di, df, ws, b, s, heads, scale, st);
  if (dtype == 0) {
    switch (hd) {
      REPRO_MLSTM_BWD(float, 32)
      REPRO_MLSTM_BWD(float, 64)
      REPRO_MLSTM_BWD(float, 128)
      REPRO_MLSTM_BWD(float, 256)
      REPRO_MLSTM_BWD(float, 512)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 1) {
    switch (hd) {
      REPRO_MLSTM_BWD(__nv_bfloat16, 32)
      REPRO_MLSTM_BWD(__nv_bfloat16, 64)
      REPRO_MLSTM_BWD(__nv_bfloat16, 128)
      REPRO_MLSTM_BWD(__nv_bfloat16, 256)
      REPRO_MLSTM_BWD(__nv_bfloat16, 512)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef REPRO_MLSTM_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
