// The stabilized mLSTM recurrence (the xLSTM matrix memory) for Hopper
// (sm_90a), from an empty state.
//
// Replaces the TPU kernel `_kernel` / `mlstm_scan` of
// src/repro/kernels/mlstm_scan.py, which keeps the per-(batch, head)
// state C [hd, hd], n [hd], m resident in VMEM across all chunks of the
// sequence.  Per step t, with k scaled by 1/sqrt(hd) in fp32:
//   log_f = -softplus(-f_t),  m' = max(log_f + m, i_t)
//   ig = exp(i_t - m'),  fg = exp(log_f + m - m')
//   C = fg * C + ig * v_t k_t^T,  n = fg * n + ig * k_t
//   h_t = (C q_t) / max(|n . q_t|, exp(-m'))
// Two kernels compute it; the wrapper picks by type and counts each path.
//
// 1. `par::mlstm_tc_kernel` (+ `par::gates_kernel`), bf16: the xLSTM
//    paper's parallel form (arXiv:2405.04517, section 2.3 and appendix B)
//    on the tensor cores.  With F_t = sum_{r<=t} log_f_r,
//      h_t = sum_{s<=t} D_ts S_ts v_s / max(|sum_{s<=t} D_ts S_ts|, exp(-m_t)),
//      S_ts = q_t . k_s / sqrt(hd),  D_ts = exp(i_s + F_t - F_s - m_t),
//    and the recurrence's m_t = max_{s<=t}(i_s + F_t - F_s) (from -1e30) is
//    known from the gates alone, so this is causal attention with a fixed
//    stabilizer: no online rescaling, and den = P's signed row sum where
//    flash has the softmax sum.  Bound: at S = 512, 4 * hd flops per causal
//    pair on bf16 tensor cores, less than the bytes (q, k, v read once, h
//    written once); the recurrence's 5 * hd^2 flops a step become tile
//    products.  The prefix kernel takes F and M_t = m_t - F_t as fp64 scans
//    (F reaches hundreds in a few hundred steps, and F_t - F_s cancels two
//    such sums: an fp32 cumsum is off by several ulps of F in every D).
//    The tile kernel takes the exponent as gl_s - c_t with gl_s = i_s -
//    (F_s - F_k0) and c_t = M_t + F_k0 (k0 the key tile's first key), each
//    formed in fp64 and rounded once, so the large terms cancel before
//    rounding.  S = Q K^T is `wgmma` m64n64k16 bf16 -> fp32 (both operands
//    the bf16 inputs, so the products are exact), scaled by 1/sqrt(hd) in
//    fp32; P = S * D in fp32; den sums P in fp32 before any rounding.  The
//    PV product takes P as two bf16 parts, p = bf16(P) and pl = bf16(P - p),
//    so P enters it rounded to about 2^-17 relative, and O accumulates in
//    fp32.  P rounded once to bf16 (2^-9) is not enough: where den cancels
//    (|sum P| much smaller than sum |P|) the error of h grows by that
//    ratio, and with extreme gates at hd = 512 it reached 1.04x the bf16
//    bar 3e-2 in the plain parallel form and 2x on the card.  Tiles past the diagonal are skipped, blocks run
//    heaviest query tiles first, and nothing is atomic, so repeated calls
//    are bitwise equal.  Layout and schedule: at the kernel.
// 2. `mlstm_scan_kernel`, fp32 (the fp32 parity paths): the recurrence
//    itself, on the CUDA cores (fp32 products have no tensor-core form
//    without TF32).  What bounds it is the sequential chain of S steps (per
//    step 5 hd^2 + 5 hd flops per (b, h) on a state that must stay on chip:
//    with ig * v_t[r] taken once per row, each element of C costs a multiply
//    and an FMA and C q_t an FMA).  At hd = 512, C is 1 MiB of fp32 per
//    (b, h): it fits neither one SM's shared memory nor its registers.  The
//    rows of C (the v axis) are independent and only den = max(|n . q_t|,
//    exp(-m')) is shared, where n is an [hd] vector any warp can keep: grid
//    (B * H, hd / 16), 4 warps a block, each warp holding 4 rows of C in
//    registers (lane l owns columns l, l + 32, ...) and its own n and m,
//    walking all S steps in order with step t + 1's inputs loaded while
//    step t computes.
// Kernel 1 takes bf16 q, k, v and writes bf16 h; kernel 2 takes and
// writes fp32.  The gates are fp32 on both.  For the backward
// (mlstm_scan_bwd.cu) either kernel also writes, when asked, each row's
// signed sum a_t (kernel 1's den before |.|, kernel 2's n . q_t) and the
// stabilizer m_t it used, fp32 [B, S, H]; h does not change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NW = 4;            // warps per block
constexpr int RW = 4;            // rows of C per warp
constexpr int ROWS = NW * RW;    // rows of C per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int COLS>
struct Step {
  float q[COLS], k[COLS], v[RW], i, f;

  __device__ __forceinline__ void load(const float* __restrict__ qp,
                                       const float* __restrict__ kp,
                                       const float* __restrict__ vp,
                                       const float* __restrict__ ip,
                                       const float* __restrict__ fp,
                                       int64_t base, int64_t gate, int64_t v0,
                                       int lane, float scale) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      q[c] = qp[base + lane + 32 * c];
      k[c] = kp[base + lane + 32 * c] * scale;
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) v[r] = vp[base + v0 + r];
    i = ip[gate];
    f = fp[gate];
  }
};

template <int COLS>
__global__ void __launch_bounds__(NW * 32)
mlstm_scan_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ ig,
                  const float* __restrict__ fg, float* __restrict__ h,
                  float* __restrict__ a_out, float* __restrict__ m_out,
                  int64_t s_len, int64_t heads, float scale) {
  constexpr int HD = 32 * COLS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int64_t b = blockIdx.x / heads, hh = blockIdx.x % heads;
  const int64_t v0 = static_cast<int64_t>(blockIdx.y) * ROWS + warp * RW;

  float cst[RW][COLS], n[COLS];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) cst[r][c] = 0.f;
#pragma unroll
  for (int c = 0; c < COLS; ++c) n[c] = 0.f;
  float m = -1e30f;

  Step<COLS> cur, nxt;
  if (s_len > 0)
    cur.load(q, k, v, ig, fg, (b * s_len * heads + hh) * HD,
             b * s_len * heads + hh, v0, lane, scale);
  for (int64_t t = 0; t < s_len; ++t) {
    const int64_t gate = (b * s_len + t) * heads + hh;
    const int64_t base = gate * HD;
    if (t + 1 < s_len)
      nxt.load(q, k, v, ig, fg, base + heads * HD, gate + heads, v0, lane,
               scale);

    // log sigmoid(f) = -softplus(-f) = -(max(-f, 0) + log1p(exp(-|f|)))
    const float log_f = -(fmaxf(-cur.f, 0.f) + log1pf(expf(-fabsf(cur.f))));
    const float m_new = fmaxf(log_f + m, cur.i);
    const float i_g = expf(cur.i - m_new);
    const float f_g = expf(log_f + m - m_new);

    float nq = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      n[c] = f_g * n[c] + i_g * cur.k[c];
      nq = fmaf(n[c], cur.q[c], nq);
    }
    const float a_t = warp_sum(nq);
    const float den = fmaxf(fabsf(a_t), expf(-m_new));
    if (a_out != nullptr && blockIdx.y == 0 && warp == 0 && lane == 0) {
      a_out[gate] = a_t;
      m_out[gate] = m_new;
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float iv = i_g * cur.v[r];
      float num = 0.f;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        cst[r][c] = fmaf(f_g, cst[r][c], iv * cur.k[c]);
        num = fmaf(cst[r][c], cur.q[c], num);
      }
      num = warp_sum(num);
      if (lane == r) h[base + v0 + r] = num / den;
    }
    m = m_new;
    if (t + 1 < s_len) cur = nxt;
  }
}

template <int COLS>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, void* h, void* a, void* m, int64_t b, int64_t s,
           int64_t heads, float scale, cudaStream_t stream) {
  constexpr int HD = 32 * COLS;
  if (b * heads > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(b * heads), HD / ROWS);
  mlstm_scan_kernel<COLS><<<grid, NW * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(ig),
      static_cast<const float*>(fg), static_cast<float*>(h),
      static_cast<float*>(a), static_cast<float*>(m), s, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_hd(const void* q, const void* k, const void* v, const void* ig,
                const void* fg, void* h, void* a, void* m, int64_t b,
                int64_t s, int64_t heads, int64_t hd, float scale,
                cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<1>(q, k, v, ig, fg, h, a, m, b, s, heads, scale, stream);
    case 64:
      return launch<2>(q, k, v, ig, fg, h, a, m, b, s, heads, scale, stream);
    case 128:
      return launch<4>(q, k, v, ig, fg, h, a, m, b, s, heads, scale, stream);
    case 256:
      return launch<8>(q, k, v, ig, fg, h, a, m, b, s, heads, scale, stream);
    case 512:
      return launch<16>(q, k, v, ig, fg, h, a, m, b, s, heads, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The parallel form on the tensor cores (bf16)
// ---------------------------------------------------------------------------

using namespace hopper;

namespace par {

constexpr int KT = 64;          // keys per K/V tile, query rows per block
constexpr int WG = 2;           // warpgroups per block, one per column half
constexpr int THREADS = 128 * WG;
constexpr int GT = 256;         // threads of the gate-prefix kernel
constexpr double LOG2E = 1.4426950408889634;

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

// One block per (b, h): the prefix of the gates in fp64, GT positions at a
// time with a carry.  F_t = sum_{r<=t} log sigmoid(f_r) (log sigmoid in
// fp32, as the recurrence takes it), M_t = max(-1e30, max_{s<=t} i_s - F_s),
// and gl_s = (i_s - (F_s - F_k0)) * log2(e) rounded to fp32, k0 the first
// key of s's 64-key tile.  Rows [S, sp) are padding (gl = 0, F and M
// carried), so the tile kernel reads whole tiles without bounds.
__global__ void __launch_bounds__(GT)
gates_kernel(const float* __restrict__ ig, const float* __restrict__ fg,
             double* __restrict__ f_cum, double* __restrict__ m_run,
             float* __restrict__ gl, int64_t s_len, int64_t heads,
             int64_t sp) {
  __shared__ double wsum[GT / 32], wmax[GT / 32], fs[GT];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t bh = blockIdx.x, b = bh / heads, hh = bh % heads;
  double carry_f = 0.0, carry_m = -1e30;
  for (int64_t base = 0; base < sp; base += GT) {
    const int64_t t = base + tid;
    const bool valid = t < s_len;
    float fi = 0.f, ii = 0.f;
    if (valid) {
      const int64_t gi = (b * s_len + t) * heads + hh;
      fi = fg[gi];
      ii = ig[gi];
    }
    const float lf =
        valid ? -(fmaxf(-fi, 0.f) + log1pf(expf(-fabsf(fi)))) : 0.f;
    const double x = warp_scan_sum(static_cast<double>(lf), lane);
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    double f_t = carry_f;
    for (int w = 0; w < warp; ++w) f_t += wsum[w];
    f_t += x;
    const double g = valid ? static_cast<double>(ii) - f_t : -1e300;
    const double mx = warp_scan_max(g, lane);
    if (lane == 31) wmax[warp] = mx;
    fs[tid] = f_t;
    __syncthreads();
    double m_t = carry_m;
    for (int w = 0; w < warp; ++w) m_t = fmax(m_t, wmax[w]);
    m_t = fmax(m_t, mx);
    if (t < sp) {
      const double fk0 = fs[tid & ~(KT - 1)];
      f_cum[bh * sp + t] = f_t;
      m_run[bh * sp + t] = m_t;
      gl[bh * sp + t] =
          valid ? static_cast<float>((static_cast<double>(ii) - (f_t - fk0)) *
                                     LOG2E)
                : 0.f;
    }
    double cm = carry_m;
    for (int w = 0; w < GT / 32; ++w) cm = fmax(cm, wmax[w]);
    const double cf = fs[GT - 1];
    __syncthreads();  // the next chunk rewrites the shared sums
    carry_f = cf;
    carry_m = cm;
  }
}

// One block per (query tile of 64 rows, (b, h)), heaviest tiles first.  Both
// warpgroups compute S = Q K^T for the tile's 64 rows over all of hd (S is
// recomputed, not shared: sharing it needs a 16 KB exchange and a barrier
// per tile, recomputing costs one more 64x64xhd product); warpgroup w owns
// output columns [w * HDP/2, (w + 1) * HDP/2), its O accumulator 64 x HDP/2
// fp32 (128 registers a thread at hd = 512).  Q, one K tile and one V tile
// sit in shared memory (3 x 64 KB at hd = 512, 128-byte swizzle): the next
// K tile loads while this tile's P and PV run, the next V tile while the
// next S runs.  hd < 128 is held zero-padded to 128.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
mlstm_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const double* __restrict__ f_cum,
                const double* __restrict__ m_run,
                const float* __restrict__ gl, __nv_bfloat16* __restrict__ h,
                float* __restrict__ a_out, float* __restrict__ m_out,
                int64_t s_len, int64_t heads, int64_t sp, float scale,
                int64_t q_tiles) {
  constexpr int HDP = HD < 128 ? 128 : HD;  // head dim in shared memory
  constexpr int CPR = HDP / 8;              // 16-byte chunks a row
  constexpr uint32_t TILE = KT * HDP * 2;   // bytes of a Q, K or V tile
  constexpr int NC = HDP / 2;               // output columns a warpgroup
  constexpr int NO = NC / 2;                // O accumulators a thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t qs = (base + 1023u) & ~1023u;
  const uint32_t ks = qs + TILE, vs = ks + TILE, gs = vs + TILE;
  const float* gl_s = reinterpret_cast<const float*>(smem_raw + (gs - base));

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int64_t bh = blockIdx.x, b = bh / heads, hh = bh % heads;
  const int64_t qt = q_tiles - 1 - blockIdx.y;  // heaviest first
  const int64_t q0 = qt * KT;
  const int n_tiles = static_cast<int>(qt) + 1;
  const int64_t pos_stride = heads * HD;        // elements between positions
  const int64_t head0 = (b * s_len * heads + hh) * HD;
  const int64_t g0 = bh * sp;

  // 64 rows from position p0 into a swizzled tile (zero past S and hd)
  auto load_rows = [&](uint32_t dst, const __nv_bfloat16* src, int64_t p0) {
#pragma unroll
    for (int it = 0; it < KT * CPR / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int r = e / CPR, c = e % CPR;
      const int64_t p = p0 + r;
      const bool ok = p < s_len && c * 8 < HD;
      cp16(dst + sw_off(r, c, KT), ok ? src + head0 + p * pos_stride + c * 8
                                      : src, ok ? 16 : 0);
    }
  };
  auto load_k = [&](int tile) {
    load_rows(ks, k, static_cast<int64_t>(tile) * KT);
    if (tid < KT / 4)
      cp16(gs + (tile & 1) * KT * 4 + tid * 16,
           gl + g0 + static_cast<int64_t>(tile) * KT + tid * 4, 16);
  };

  load_rows(qs, q, q0);
  load_k(0);
  cp_commit();  // Q, K_0, gl_0
  load_rows(vs, v, 0);
  cp_commit();  // V_0

  // this thread's rows of the accumulator fragments: ra and ra + 8
  const int ra = 16 * warp + lane / 4, rb = ra + 8;
  const double mra = m_run[g0 + q0 + ra], mrb = m_run[g0 + q0 + rb];
  const float ma = static_cast<float>(f_cum[g0 + q0 + ra] + mra);
  const float mb = static_cast<float>(f_cum[g0 + q0 + rb] + mrb);
  float o[NO], s[32];
  uint32_t p[16], pl[16];  // P as bf16 pairs: P ~ p + pl (high, low parts)
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = pl[i] = 0u;
  float den_a = 0.f, den_b = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_wait<1>();  // Q, K_tile and gl_tile have landed (this thread's part)
    fence_proxy_async();
    __syncthreads();  // ... everyone's
    // S = Q K^T over hd (both operands K-major, 16 dims = 32 bytes a step)
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs<32>(s);
    fence_regs<NO>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t cb = kk / 4, col = (kk % 4) * 32;
      const uint64_t da = sw128_desc(qs + cb * KT * 128 + col, 16, 1024);
      const uint64_t db = sw128_desc(ks + cb * KT * 128 + col, 16, 1024);
      wgmma_ss_m64n64(s, da, db, kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(s);
    __syncthreads();  // every warpgroup's S has landed: K is free
    if (tile + 1 < n_tiles) load_k(tile + 1);
    cp_commit();

    // P = S * scale * D, D = 2^(gl_s - c_t), c_t = (M_t + F_k0) log2(e):
    // exp(i_s + F_t - F_s - m_t) with the large terms cancelled in fp64;
    // keys past the row's position (the diagonal tile only) are 0
    const double fk0 = f_cum[g0 + static_cast<int64_t>(tile) * KT];
    const float c_a = static_cast<float>((mra + fk0) * LOG2E);
    const float c_b = static_cast<float>((mrb + fk0) * LOG2E);
    const float* gt = gl_s + (tile & 1) * KT;
    const bool diag = tile == qt;
    float ta = 0.f, tb = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c0 = 8 * j + 2 * quad;
      const float g_0 = gt[c0], g_1 = gt[c0 + 1];
      float p0 = s[4 * j] * scale * ex2(g_0 - c_a);
      float p1 = s[4 * j + 1] * scale * ex2(g_1 - c_a);
      float p2 = s[4 * j + 2] * scale * ex2(g_0 - c_b);
      float p3 = s[4 * j + 3] * scale * ex2(g_1 - c_b);
      if (diag) {
        if (c0 > ra) p0 = 0.f;
        if (c0 + 1 > ra) p1 = 0.f;
        if (c0 > rb) p2 = 0.f;
        if (c0 + 1 > rb) p3 = 0.f;
      }
      ta += p0 + p1;
      tb += p2 + p3;
      // the S fragment is P's A fragment: p[2j] row ra, p[2j+1] row rb;
      // pl holds what bf16 rounding left of P
      p[2 * j] = pack_bf16(p0, p1);
      p[2 * j + 1] = pack_bf16(p2, p3);
      const float2 ha = unpack_bf16(p[2 * j]), hb = unpack_bf16(p[2 * j + 1]);
      pl[2 * j] = pack_bf16(p0 - ha.x, p1 - ha.y);
      pl[2 * j + 1] = pack_bf16(p2 - hb.x, p3 - hb.y);
    }
    den_a += ta;
    den_b += tb;

    cp_wait<1>();  // V_tile has landed (K_{tile+1} may be in flight)
    fence_proxy_async();
    __syncthreads();
    // O += P V over this warpgroup's columns, the high and then the low
    // part of P: 16 keys a step, V MN-major (8-key groups 1024 bytes apart,
    // 64-dim column blocks KT * 128 apart)
    fence_regs_u32<16>(p);
    fence_regs_u32<16>(pl);
    fence_regs<NO>(o);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC / 64; ++c) {
      const uint32_t vb = vs + (wg * (NC / 64) + c) * KT * 128;
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        const uint64_t db = sw128_desc(vb + kk * 2048, KT * 128, 1024);
        wgmma_rs_m64n64_mn(o + 32 * c, p + 4 * kk, db);
        wgmma_rs_m64n64_mn(o + 32 * c, pl + 4 * kk, db);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NO>(o);
    fence_regs_u32<16>(p);
    fence_regs_u32<16>(pl);
    __syncthreads();  // every warpgroup's PV has landed: V is free
    if (tile + 1 < n_tiles)
      load_rows(vs, v, static_cast<int64_t>(tile + 1) * KT);
    cp_commit();
  }
  cp_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    den_a += __shfl_xor_sync(0xffffffffu, den_a, off);
    den_b += __shfl_xor_sync(0xffffffffu, den_b, off);
  }
  const float inv_a = 1.f / fmaxf(fabsf(den_a), expf(-ma));
  const float inv_b = 1.f / fmaxf(fabsf(den_b), expf(-mb));
  if (a_out != nullptr && wg == 0 && quad == 0) {
    // the backward's a_t and m_t: both warpgroups hold the same sums
    const int64_t pa = q0 + ra, pb = q0 + rb;
    if (pa < s_len) {
      a_out[(b * s_len + pa) * heads + hh] = den_a;
      m_out[(b * s_len + pa) * heads + hh] = ma;
    }
    if (pb < s_len) {
      a_out[(b * s_len + pb) * heads + hh] = den_b;
      m_out[(b * s_len + pb) * heads + hh] = mb;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int64_t pos = q0 + (hr ? rb : ra);
    if (pos >= s_len) continue;
    const float inv = hr ? inv_b : inv_a;
    __nv_bfloat16* orow = h + head0 + pos * pos_stride;
#pragma unroll
    for (int c = 0; c < NC / 64; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = wg * NC + c * 64 + 8 * j + 2 * quad;
        if (col >= HD) continue;
        const float* oc = o + 32 * c + 4 * j + 2 * hr;
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(oc[0] * inv, oc[1] * inv);
      }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, void* h, void* a, void* m, void* ws, int64_t b,
           int64_t s, int64_t heads, float scale, cudaStream_t stream) {
  constexpr int HDP = HD < 128 ? 128 : HD;
  constexpr int SMEM = 1024 + 3 * KT * HDP * 2 + 2 * KT * 4;
  static bool smem_set = false;  // the attribute holds for the process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlstm_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const int64_t bh = b * heads, tiles = (s + KT - 1) / KT, sp = tiles * KT;
  if (bh > 2147483647LL || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  double* f_cum = static_cast<double*>(ws);
  double* m_run = f_cum + bh * sp;
  float* gl = reinterpret_cast<float*>(m_run + bh * sp);
  gates_kernel<<<static_cast<unsigned>(bh), GT, 0, stream>>>(
      static_cast<const float*>(ig), static_cast<const float*>(fg), f_cum,
      m_run, gl, s, heads, sp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>(tiles));
  mlstm_tc_kernel<HD><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), f_cum, m_run, gl,
      static_cast<__nv_bfloat16*>(h), static_cast<float*>(a),
      static_cast<float*>(m), s, heads, sp, scale, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace par

}  // namespace

// q, k, v, h: contiguous [B, S, H, hd]; i_gate, f_gate: contiguous fp32
// [B, S, H]; all fp32 (the recurrence).  a, m: null, or fp32 [B, S, H] for
// the backward: each row's signed sum a_t = n_t . q_t and its stabilizer
// m_t.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() of the launch.
extern "C" int repro_mlstm_scan(const void* q, const void* k, const void* v,
                                const void* i_gate, const void* f_gate,
                                void* h, void* a, void* m, int64_t b,
                                int64_t s, int64_t heads, int64_t hd,
                                float scale, void* stream) {
  if (b == 0 || s == 0 || heads == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_hd(q, k, v, i_gate, f_gate, h, a, m, b, s, heads, hd,
                     scale, st);
}

// The parallel form on the tensor cores: q, k, v, h contiguous bf16
// [B, S, H, hd], 16-byte aligned; i_gate, f_gate contiguous fp32 [B, S, H];
// a, m null or fp32 [B, S, H] (the signed row sum of P and m_t, for the
// backward); ws a workspace of B * H * sp * 20 bytes, sp = S rounded up to
// 64 (the gates' prefix: F and M in fp64, gl in fp32).  Two launches on
// `stream` (the prefix, then the tiles), no synchronisation; returns the
// first cudaGetLastError() that is not 0.
extern "C" int repro_mlstm_parallel(const void* q, const void* k,
                                    const void* v, const void* i_gate,
                                    const void* f_gate, void* h, void* a,
                                    void* m, void* ws, int64_t b, int64_t s,
                                    int64_t heads, int64_t hd, float scale,
                                    void* stream) {
  if (b == 0 || s == 0 || heads == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_MLSTM_PAR(HD)                                                  \
  case HD:                                                                   \
    return par::launch<HD>(q, k, v, i_gate, f_gate, h, a, m, ws, b, s,       \
                           heads, scale, st);
  switch (hd) {
    REPRO_MLSTM_PAR(32)
    REPRO_MLSTM_PAR(64)
    REPRO_MLSTM_PAR(128)
    REPRO_MLSTM_PAR(256)
    REPRO_MLSTM_PAR(512)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_MLSTM_PAR
}
