// Flash attention backward for Hopper (sm_90a), with GQA, causal and
// sliding-window masks: dQ, dK, dV of the forward in flash_attention.cu.
//
// The TPU kernel `_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py has no backward (the reference
// differentiates its jnp attention); the port's training paths send every
// attention through kernel 4, so its gradient is this kernel, from the
// forward's output O and its per-row log-sum-exp lse [B, Hq, Sq] (fp32):
//   P  = exp(scale * Q K^T - lse)   (0 where masked)
//   D  = rowsum(dO * O)
//   dV = P^T dO,  dS = P * (dO V^T - D)
//   dQ = scale * dS K,  dK = scale * dS^T Q
// Deterministic: no atomics, every sum in a fixed order, and the tiling
// depends on (sq, sk, hq, hkv, hd, causal, window) alone, never on the
// batch (a batch of folded cells gives each cell its own run's bits).
// Three kernels a call: D, then dK/dV with one block per (b, kv head, key
// tile) that walks the group's q heads x the Q tiles the mask leaves live
// (causal: rows from the tile's first key; window: rows below its last
// key + window), so GQA's sum stays inside the block; then dQ with one
// block per (b, q head, row tile) walking the live key tiles.  Each pass
// recomputes S and dP (7 products a live pair in all, against 5 at
// least): dQ as its own pass costs two products, where per-key-tile dQ
// partials summed by a second pass would cost far more in bytes.
//
// bf16 (the training paths; `tcb::`): every product on `wgmma`, bf16
// operands, fp32 accumulators.  A block is one warpgroup of 64 keys
// (dK/dV) or 64 rows (dQ); two blocks share an SM, so one block's
// exponentials overlap the other's products.  K and V (or Q and dO) of
// the block sit in shared memory; the other side streams in steps of N
// rows (or keys) through a double-buffered ring that TMA fills (one
// thread sends a step's tiles to the stage's mbarrier, 128-byte swizzled,
// zeros past the edges), step t + 1 landing while step t's products run;
// lse and D of a step's rows come beside it by cp.async (the TMA helpers
// are hopper.cuh's, shared with kernels 5's and 6's backwards).  N is 128
// at hd <= 64 where the pass streams more than 128 rows (keys), else 64.
// Tiles are held as column blocks of [rows][64 bf16] with the swizzle the
// wgmma descriptors name (hd 32 and 96 padded to 64 and 128: dims past
// hd hold the next head's or zeros, and only products whose output
// columns are dropped read them).  dK/dV: S^T = K Q^T and dP^T = V dO^T
// as m64nNk16 with both operands K-major in shared memory; P^T and dS^T
// are formed on the accumulator fragments (2^(s * scale log2e - lse
// log2e) by one FFMA and one ex2, while dP^T is still on the tensor
// cores; masks from 32-bit bounds, skipped on a step inside every mask),
// packed to bf16 A fragments once both products have landed, and dV +=
// P^T dO, dK += dS^T Q run as m64n{64,128}k16 with A from registers and
// dO, Q read MN-major through the transpose bit: no transposed copy is
// made.  dQ: S = Q K^T, dP = dO V^T, then dQ += dS K with K MN-major.
// P and dS are rounded to bf16 for the three products (about 2^-9
// relative, as the forward's PV); S, dP, P, dS are fp32.  D reads O and
// dO in 16-byte vectors.  No wgmma sits under a branch: loop bounds are
// uniform over a block and masking happens on the fragments.
// fp32 (the parity paths): the same on the CUDA cores in fp32, 32 x 32
// tiles, one thread a key and a share of the rows for S and dP, 8 keys x
// 4 dims of dK and dV (or 8 rows x 4 dims of dQ) a thread; TF32 unused.
// A block has hd padded to 32, 64 or 128 (hd 96 runs as 128 with zero
// columns).
// Bound on the H100 (chip_smoke.py): bytes (q, k, v, o, dO read, dq, dk,
// dv written once) at smollm's and qwen3's shapes, operations (5 products
// of each live (q, k) pair at 989 TFLOP/s) at whisper's 1500-long
// encoder.  What holds it above the bound (PERF.md): two exponentials a
// live pair (one a pass) on the SFU, the elementwise work between the
// products, and the two extra products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::pack_bf16;

constexpr int T32 = 32;           // rows (keys) a tile

__device__ __forceinline__ float to_f32(float v) { return v; }

__host__ __device__ constexpr int hdp(int hd) {
  return hd <= 32 ? 32 : (hd <= 64 ? 64 : 128);
}

// rows [r0, r0 + 32) of a [.., S, H, hd] fp32 tensor at head `head` into
// a [32][LD] tile (zero past `s` and past hd)
template <int HD, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t b,
                                          int64_t s, int64_t h, int64_t head,
                                          int64_t r0) {
  constexpr int P = hdp(HD);
  for (int e = threadIdx.x; e < T32 * P; e += blockDim.x) {
    const int r = e / P, d = e % P;
    const int64_t row = r0 + r;
    float v = 0.f;
    if (row < s && d < HD) v = src[((b * s + row) * h + head) * HD + d];
    dst[r * LD + d] = v;
  }
}

template <typename T, int HD>
__global__ void bwd_d_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                             float* __restrict__ dvec, int64_t rows, int64_t sq,
                             int64_t hq) {
  // row = (b * sq + pos) * hq + head, as O is laid out
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(to_f32(o[row * HD + d]), to_f32(dout[row * HD + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t head = row % hq, bp = row / hq, pos = bp % sq, b = bp / sq;
    dvec[(b * hq + head) * sq + pos] = acc;
  }
}

// S and dP of the 32 x 32 tile: lane = key, warp w rows [w*RQ, (w+1)*RQ);
// qs/dos [32][P] and ks/vs [32][P + 4]
template <int P, int RQ>
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       float (&s)[RQ], float (&dp)[RQ]) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < RQ; ++i) s[i] = dp[i] = 0.f;
  const float* kr = ks + lane * (P + 4);
  const float* vr = vs + lane * (P + 4);
#pragma unroll 4
  for (int d = 0; d < P; d += 4) {
    const float4 kk = *reinterpret_cast<const float4*>(kr + d);
    const float4 vv = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int q = w * RQ + i;
      const float4 a = *reinterpret_cast<const float4*>(qs + q * P + d);
      const float4 g = *reinterpret_cast<const float4*>(dos + q * P + d);
      s[i] = fmaf(a.x, kk.x, fmaf(a.y, kk.y, fmaf(a.z, kk.z, fmaf(a.w, kk.w, s[i]))));
      dp[i] = fmaf(g.x, vv.x, fmaf(g.y, vv.y, fmaf(g.z, vv.z, fmaf(g.w, vv.w, dp[i]))));
    }
  }
}

__device__ __forceinline__ bool visible(int64_t qp, int64_t kp, int64_t sq,
                                        int64_t sk, int causal,
                                        int64_t window) {
  bool ok = qp < sq && kp < sk;
  if (causal) ok = ok && kp <= qp;
  if (window) ok = ok && kp > qp - window;
  return ok;
}

template <int HD>
__global__ void __launch_bounds__(hdp(HD))
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dvec,
                float* __restrict__ dk, float* __restrict__ dv, int64_t sq, int64_t sk,
                int64_t hq, int64_t hkv, int causal, int64_t window,
                float scale) {
  constexpr int P = hdp(HD), KP = P + 4, NT = P, RQ = T32 * T32 / NT;
  constexpr int CG = P / 4;               // column groups of 4 dims
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                         // [32][KP]
  float* vs = ks + T32 * KP;              // [32][KP]
  float* qs = vs + T32 * KP;              // [32][P]
  float* dos = qs + T32 * P;              // [32][P]
  float* ps = dos + T32 * P;              // [32 q][32 k]
  float* dss = ps + T32 * T32;            // [32 q][32 k]
  float* ls = dss + T32 * T32;            // [32] lse
  float* ds = ls + T32;                   // [32] D

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int64_t b = blockIdx.z, hk = blockIdx.y;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * T32;
  const int64_t group = hq / hkv;
  load_tile<HD, KP>(ks, k, b, sk, hkv, hk, k0);
  load_tile<HD, KP>(vs, v, b, sk, hkv, hk, k0);

  // live Q tiles: causal rows at or after k0; window rows below k0+31+window
  int64_t q_begin = causal ? k0 / T32 * T32 : 0;
  int64_t q_end = sq;
  if (window && k0 + T32 - 1 + window < q_end) q_end = k0 + T32 - 1 + window;

  const int cg = tid % CG, kg = tid / CG;  // 4 dims, 8 keys: kg*8 .. +8
  float acc_k[8][4], acc_v[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;

  for (int64_t g = 0; g < group; ++g) {
    const int64_t head = hk * group + g;
    for (int64_t q0 = q_begin; q0 < q_end; q0 += T32) {
      __syncthreads();  // the previous tile's Q, dO, P and dS are used
      load_tile<HD, P>(qs, q, b, sq, hq, head, q0);
      load_tile<HD, P>(dos, dout, b, sq, hq, head, q0);
      if (tid < T32) {
        const int64_t qp = q0 + tid;
        ls[tid] = qp < sq ? lse[(b * hq + head) * sq + qp] : 0.f;
        ds[tid] = qp < sq ? dvec[(b * hq + head) * sq + qp] : 0.f;
      }
      __syncthreads();
      float s[RQ], dp[RQ];
      scores<P, RQ>(qs, dos, ks, vs, s, dp);
      const int64_t kp = k0 + lane;
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int r = w * RQ + i;
        const int64_t qp = q0 + r;
        float pv = 0.f;
        if (visible(qp, kp, sq, sk, causal, window))
          pv = expf(s[i] * scale - ls[r]);
        ps[r * T32 + lane] = pv;
        dss[r * T32 + lane] = pv * (dp[i] - ds[r]);
      }
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < T32; ++r) {
        const float4 g4 = *reinterpret_cast<const float4*>(dos + r * P + 4 * cg);
        const float4 q4 = *reinterpret_cast<const float4*>(qs + r * P + 4 * cg);
        const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
        const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
        const float4 pa = *reinterpret_cast<const float4*>(ps + r * T32 + 8 * kg);
        const float4 pb = *reinterpret_cast<const float4*>(ps + r * T32 + 8 * kg + 4);
        const float4 sa = *reinterpret_cast<const float4*>(dss + r * T32 + 8 * kg);
        const float4 sb = *reinterpret_cast<const float4*>(dss + r * T32 + 8 * kg + 4);
        const float pj[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
        const float sj[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc_v[j][c] = fmaf(pj[j], gv[c], acc_v[j][c]);
            acc_k[j][c] = fmaf(sj[j], qv[c], acc_k[j][c]);
          }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int64_t kp = k0 + 8 * kg + j;
    if (kp >= sk) continue;
    const int64_t off = ((b * sk + kp) * hkv + hk) * HD;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * cg + c;
      if (d >= HD) continue;
      dk[off + d] = acc_k[j][c] * scale;
      dv[off + d] = acc_v[j][c];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(hdp(HD))
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dvec,
              float* __restrict__ dq, int64_t sq, int64_t sk, int64_t hq,
              int64_t hkv, int causal, int64_t window, float scale) {
  constexpr int P = hdp(HD), KP = P + 4, NT = P, RQ = T32 * T32 / NT;
  constexpr int CG = P / 4;
  constexpr int DT = T32 + 1;             // dS^T row stride (no conflicts)
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                         // [32][KP]
  float* vs = ks + T32 * KP;              // [32][KP]
  float* qs = vs + T32 * KP;              // [32][P]
  float* dos = qs + T32 * P;              // [32][P]
  float* dst = dos + T32 * P;             // [32 k][DT] dS transposed
  float* ls = dst + T32 * DT;             // [32]
  float* ds = ls + T32;                   // [32]

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int64_t b = blockIdx.z, head = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * T32;
  const int64_t hk = head / (hq / hkv);
  load_tile<HD, P>(qs, q, b, sq, hq, head, q0);
  load_tile<HD, P>(dos, dout, b, sq, hq, head, q0);
  if (tid < T32) {
    const int64_t qp = q0 + tid;
    ls[tid] = qp < sq ? lse[(b * hq + head) * sq + qp] : 0.f;
    ds[tid] = qp < sq ? dvec[(b * hq + head) * sq + qp] : 0.f;
  }
  // live key tiles: causal keys up to the last row; window keys after the
  // first row - window
  const int64_t q_hi = (q0 + T32 < sq ? q0 + T32 : sq) - 1;
  int64_t k_end = sk;
  if (causal && q_hi + 1 < k_end) k_end = q_hi + 1;
  int64_t k_begin = 0;
  if (window && q0 - window + 1 > 0) k_begin = (q0 - window + 1) / T32 * T32;

  const int cg = tid % CG, rg = tid / CG;  // 4 dims of rows rg*8 .. +8
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += T32) {
    __syncthreads();  // Q, dO, lse, D are in; the previous K, V, dS are used
    load_tile<HD, KP>(ks, k, b, sk, hkv, hk, k0);
    load_tile<HD, KP>(vs, v, b, sk, hkv, hk, k0);
    __syncthreads();
    float s[RQ], dp[RQ];
    scores<P, RQ>(qs, dos, ks, vs, s, dp);
    const int64_t kp = k0 + lane;
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = w * RQ + i;
      const int64_t qp = q0 + r;
      float dsv = 0.f;
      if (visible(qp, kp, sq, sk, causal, window)) {
        const float pv = expf(s[i] * scale - ls[r]);
        dsv = pv * (dp[i] - ds[r]);
      }
      dst[lane * DT + r] = dsv;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < T32; ++kk) {
      const float4 k4 = *reinterpret_cast<const float4*>(ks + kk * KP + 4 * cg);
      const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float sv = dst[kk * DT + 8 * rg + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = fmaf(sv, kv[c], acc[j][c]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int64_t qp = q0 + 8 * rg + j;
    if (qp >= sq) continue;
    const int64_t off = ((b * sq + qp) * hq + head) * HD;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * cg + c;
      if (d < HD) dq[off + d] = acc[j][c] * scale;
    }
  }
}

template <int HD>
constexpr int dkdv_smem() {
  return (2 * T32 * (hdp(HD) + 4) + 2 * T32 * hdp(HD) + 2 * T32 * T32 +
          2 * T32) * 4;
}
template <int HD>
constexpr int dq_smem() {
  return (2 * T32 * (hdp(HD) + 4) + 2 * T32 * hdp(HD) + T32 * (T32 + 1) +
          2 * T32) * 4;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dvec, void* dq,
           void* dk, void* dv, int64_t b, int64_t sq, int64_t sk, int64_t hq,
           int64_t hkv, int causal, int64_t window, float scale,
           cudaStream_t st) {
  constexpr int NT = hdp(HD), S1 = dkdv_smem<HD>(), S2 = dq_smem<HD>();
  static bool smem_set = false;  // the attributes hold for the process
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S1);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(bwd_dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, S2);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const int64_t rows = b * sq * hq;
  const int64_t kt = (sk + T32 - 1) / T32, qt = (sq + T32 - 1) / T32;
  if ((rows + 7) / 8 > 2147483647LL || kt > 2147483647LL ||
      qt > 2147483647LL || hq > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  bwd_d_kernel<float, HD>
      <<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
          static_cast<const float*>(o), dop, dvec, rows, sq, hq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_dkdv_kernel<HD>
      <<<dim3(static_cast<unsigned>(kt), static_cast<unsigned>(hkv),
              static_cast<unsigned>(b)),
         NT, S1, st>>>(qp, kp, vp, dop, lse, dvec, static_cast<float*>(dk),
                       static_cast<float*>(dv), sq, sk, hq, hkv, causal,
                       window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_dq_kernel<HD>
      <<<dim3(static_cast<unsigned>(qt), static_cast<unsigned>(hq),
              static_cast<unsigned>(b)),
         NT, S2, st>>>(qp, kp, vp, dop, lse, dvec, static_cast<float*>(dq),
                       sq, sk, hq, hkv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}



// ---------------------------------------------------------------------------
// bf16: every product on wgmma (helpers in hopper.cuh).  P and dS are
// rounded to bf16 for the dV, dK and dQ products (about 2^-9 relative, as
// the forward's PV); S, dP, P and dS themselves are fp32.
// ---------------------------------------------------------------------------

namespace tcb {

using hopper::cp_commit;
using hopper::cp_wait;
using hopper::ex2;
using hopper::fence_regs;
using hopper::fence_regs_u32;
using hopper::mbar_expect;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::row_map;
using hopper::smem_u32;
using hopper::sw128_desc;
using hopper::tma_rows;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_rs_m64n128_mn;
using hopper::wgmma_rs_m64n64_mn;
using hopper::wgmma_ss_m64n128;
using hopper::wgmma_ss_m64n64;
using hopper::wgmma_wait;

// mirrored by kernels/flash_attention.py (flash_bwd_plan)
constexpr int THREADS = 128;      // one warpgroup a block
constexpr int BLOCKS = 2;         // blocks an SM holds
constexpr int BKV = 64;           // keys a dK/dV block
constexpr int BQQ = 64;           // query rows a dQ block
constexpr int STAGES = 2;         // the TMA ring: step t + 1 lands while
                                  // step t's products run
constexpr float LOG2E = 1.4426950408889634f;

// the head dim as held in shared memory: whole [rows][64 bf16] column
// blocks (hd 32 as 64, hd 96 as 128; tma_rows says what the padding holds)
__host__ __device__ constexpr int tc_hdp(int hd) { return hd <= 64 ? 64 : 128; }
// the rows (dK/dV) or keys (dQ) a step streams, the N of its S and dP,
// from the pass's streamed length: 128 at hd <= 64 past LONG of them
// (S, dP and the gradient's accumulators still fit a thread's registers;
// at 128 or fewer, or causal near the diagonal, a 128 step would be half
// padding), else 64
constexpr int LONG = 128;
__host__ __device__ constexpr int tc_step(int hdp, int64_t len) {
  return hdp == 64 && len > LONG ? 128 : 64;
}
// shared memory of a block in bytes (1024 of them align the tiles): K and
// V, then the ring's (Q, dO) tiles, its (lse, D) of a step's n rows and
// its mbarriers
constexpr int dkdv_smem(int hdp, int n) {
  return 1024 + 2 * BKV * 2 * hdp + STAGES * (2 * n * 2 * hdp + 2 * n * 4 + 8);
}
// Q and dO of the block's rows, then the ring's (K, V) tiles of n keys
// and its mbarriers
constexpr int dq_smem(int hdp, int n) {
  return 1024 + 2 * BQQ * 2 * hdp + STAGES * (2 * n * 2 * hdp + 8);
}

// D = rowsum(dO * O) of the bf16 rows, read in 16-byte vectors: G lanes a
// row (8 dims each; G the power of two at or above hd / 8), 32 / G rows a
// warp, the row's sum by shuffles within its G lanes
template <int HD>
__global__ void d_kernel(const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout,
                         float* __restrict__ dvec, int64_t rows, int64_t sq,
                         int64_t hq) {
  constexpr int G = HD <= 32 ? 4 : (HD <= 64 ? 8 : 16);
  // row = (b * sq + pos) * hq + head, as O is laid out
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int part = threadIdx.x % G;
  float acc = 0.f;
  if (row < rows && part * 8 < HD) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * HD + part * 8);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + row * HD + part * 8);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = hopper::unpack_bf16(av[i]), y = hopper::unpack_bf16(gv[i]);
      acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0 && row < rows) {
    const int64_t head = row % hq, bp = row / hq, pos = bp % sq, b = bp / sq;
    dvec[(b * hq + head) * sq + pos] = acc;
  }
}

// 4-byte cp.async of `bytes` (0 or 4) valid bytes, the rest zero-filled
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

// acc (64 x N) = A B^T over hd, 16 dims a step, one commit group: A's 64
// rows from descriptor `da`, B's N rows from `db`, both K-major; the
// first step overwrites acc (scale-d 0)
template <int HD, int N>
__device__ __forceinline__ void scores(float* acc, uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t cb = kk / 4, col = (kk % 4) * 32;
    const uint64_t a = da + ((cb * 64 * 128 + col) >> 4);
    const uint64_t b = db + ((cb * N * 128 + col) >> 4);
    if constexpr (N == 128)
      wgmma_ss_m64n128(acc, a, b, kk > 0 ? 1 : 0);
    else
      wgmma_ss_m64n64(acc, a, b, kk > 0 ? 1 : 0);
  }
  wgmma_commit();
}

// S and dP (or S^T and dP^T) as two commit groups: A rows at `a0`, `a1`,
// B rows at `b0`, `b1` (shared-memory addresses of K-major tiles).  No
// register is written before them: the first step overwrites.
template <int HD, int N>
__device__ __forceinline__ void issue_scores(float* s, float* dp, uint32_t a0,
                                             uint32_t a1, uint32_t b0,
                                             uint32_t b1) {
  // the bases opaque, so each step makes its four descriptors and adds
  // the steps' offsets (bytes / 16, inside the address field) to them,
  // rather than keeping 16 descriptors live across the caller's loop
  asm volatile("" : "+r"(a0), "+r"(a1), "+r"(b0), "+r"(b1));
  fence_regs<N / 2>(s);
  fence_regs<N / 2>(dp);
  wgmma_fence();
  scores<HD, N>(s, sw128_desc(a0, 16, 1024), sw128_desc(b0, 16, 1024));
  scores<HD, N>(dp, sw128_desc(a1, 16, 1024), sw128_desc(b1, 16, 1024));
}

// acc += A B over the K rows of B (16 a step): A the register fragments
// `a`, B a swizzled [K][HDP] tile at `bm` read MN-major through the
// transpose bit (8-row groups 1024 bytes apart, 64-dim column blocks
// K * 128 apart)
template <int HDP, int K>
__device__ __forceinline__ void mma_rs(float* acc, const uint32_t* a,
                                       uint32_t bm) {
  const uint64_t db = sw128_desc(bm, K * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    if constexpr (HDP == 128)
      wgmma_rs_m64n128_mn(acc, a + 4 * kk, db + kk * (2048 >> 4));
    else
      wgmma_rs_m64n64_mn(acc, a + 4 * kk, db + kk * (2048 >> 4));
  }
}

// element i of a 64 x N fragment is row r (+ 8 when i % 4 >= 2), column
// 8 (i / 4) + 2 quad + i % 2: zero where that column falls outside
// [lo, hi) of its row (bounds taken relative to column 2 quad)
template <int N>
__device__ __forceinline__ void mask(float* x, int lo_a, int hi_a, int lo_b,
                                     int hi_b) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int c = 8 * (i / 4) + (i % 2);
    const bool ok = (i % 4) < 2 ? c >= lo_a && c < hi_a : c >= lo_b && c < hi_b;
    if (!ok) x[i] = 0.f;
  }
}

// a block per (b, kv head, BKV-key tile), whose keys are the fragments'
// rows.  It walks the group's q heads x the live N-row Q steps, streamed
// through the ring with their lse and D:
// S^T = K Q^T and dP^T = V dO^T (wgmma, both K-major), P^T and dS^T on
// the fragments, then dV += P^T dO and dK += dS^T Q with P^T, dS^T as
// register A operands and dO, Q read MN-major (no transposed copy).
template <int HD, int N>
__global__ void __launch_bounds__(THREADS, BLOCKS)
dkdv_kernel(const __grid_constant__ CUtensorMap mq,   // N-row boxes
            const __grid_constant__ CUtensorMap mdo,  // N-row boxes
            const __grid_constant__ CUtensorMap mk,   // BKV-row boxes
            const __grid_constant__ CUtensorMap mv,   // BKV-row boxes
            const float* __restrict__ lse, const float* __restrict__ dvec,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int sq, int sk, int hq, int hkv, int causal, int window,
            float scale) {
  constexpr int HDP = tc_hdp(HD), NA = HDP / 2;  // dK, dV floats a thread
  constexpr int NS = N / 2;                      // S^T floats a thread
  constexpr uint32_t KV_BYTES = BKV * HDP * 2, T_BYTES = N * HDP * 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t ks = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t vs = ks + KV_BYTES;
  const uint32_t ring = vs + KV_BYTES;                 // STAGES x [Q][dO]
  const uint32_t stats = ring + STAGES * 2 * T_BYTES;  // STAGES x [lse][D]
  const uint32_t bars = stats + STAGES * 2 * N * 4;    // STAGES mbarriers
  const float* stats_f =
      reinterpret_cast<const float*>(smem_raw + (stats - smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int64_t b = blockIdx.z;
  const int hk = blockIdx.y, group = hq / hkv;
  const int k0 = blockIdx.x * BKV;
  const int k_last = (k0 + BKV < sk ? k0 + BKV : sk) - 1;
  // the live query rows (bwd_q_range): causal rows from k0, windowed rows
  // below the last key + window; uniform over the block
  const int q_begin = causal ? k0 : 0;
  int q_end = sq;
  if (window && k_last + window < q_end) q_end = k_last + window;
  const int n_qt = q_end > q_begin ? (q_end - q_begin + N - 1) / N : 0;
  const int n_steps = group * n_qt;

  const float* lb = lse + b * hq * sq;
  const float* db = dvec + b * hq * sq;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // step t: q head hk * group + t / n_qt, rows q_begin + (t % n_qt) * N;
  // thread 0 sends its Q and dO tiles (with K and V at step 0) by TMA to
  // the stage's barrier, every thread copies a share of its lse and D
  auto load_step = [&](int t) {
    const uint32_t st = static_cast<uint32_t>(t % STAGES);
    const int head = hk * group + t / n_qt;
    const int q0 = q_begin + (t % n_qt) * N;
    const uint32_t qt = ring + st * 2 * T_BYTES, bar = bars + 8 * st;
    if (tid == 0) {
      mbar_expect(bar, 2 * T_BYTES + (t == 0 ? 2 * KV_BYTES : 0));
      if (t == 0) {
        tma_rows<HDP, BKV>(ks, &mk, bar, HD, hk, k0, static_cast<int>(b));
        tma_rows<HDP, BKV>(vs, &mv, bar, HD, hk, k0, static_cast<int>(b));
      }
      tma_rows<HDP, N>(qt, &mq, bar, HD, head, q0, static_cast<int>(b));
      tma_rows<HDP, N>(qt + T_BYTES, &mdo, bar, HD, head, q0,
                       static_cast<int>(b));
    }
#pragma unroll
    for (int it = 0; it < 2 * N / THREADS; ++it) {  // lse of the rows, D
      const int e = tid + it * THREADS, qp = q0 + e % N;
      const float* src = (e < N ? lb : db) + static_cast<int64_t>(head) * sq;
      cp4(stats + (st * 2 * N + e) * 4, qp < sq ? src + qp : src,
          qp < sq ? 4 : 0);
    }
  };
  // iteration t brings step t + 1 into the stage step t - 1 left
  if (n_steps > 0) load_step(0);
  cp_commit();

  // this thread's keys in the fragments: ka and ka + 8
  const int ka = k0 + 16 * warp + lane / 4;
  const float sl2 = scale * LOG2E;
  float dka[NA], dva[NA], s[NS], dp[NS];
  uint32_t pa[NS / 2], sa[NS / 2];
#pragma unroll
  for (int i = 0; i < NA; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    const uint32_t st = static_cast<uint32_t>(t % STAGES);
    mbar_wait(bars + 8 * st, (t / STAGES) & 1);  // step t's tiles landed
    cp_wait<0>();     // ... and this thread's lse, D
    __syncthreads();  // everyone's; step t - 1 is wholly consumed
    if (t + 1 < n_steps) load_step(t + 1);
    cp_commit();
    const uint32_t qt = ring + st * 2 * T_BYTES, dt = qt + T_BYTES;
    const float* ls = stats_f + st * 2 * N;
    const float* dd = ls + N;
    const int q0 = q_begin + (t % n_qt) * N;

    // S^T = K Q^T, then dP^T = V dO^T
    issue_scores<HD, N>(s, dp, ks, vs, qt, dt);
    wgmma_wait<1>();  // S^T has landed; dP^T may still run
    fence_regs<NS>(s);
    // P^T = exp(scale S^T - lse) = 2^(S^T scale log2e - lse log2e)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * quad);
      const float n0 = -l.x * LOG2E, n1 = -l.y * LOG2E;
      s[4 * j] = ex2(fmaf(s[4 * j], sl2, n0));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sl2, n1));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sl2, n0));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sl2, n1));
    }
    // rows of this step that key ka (ka + 8) sees, as columns from
    // q0 + 2 quad: below sq; causal from the key on; windowed below the
    // key + window.  A step wholly inside every mask skips it.
    const bool full = q0 + N <= sq && (!causal || k0 + BKV - 1 <= q0) &&
                      (!window || k0 > q0 + N - 1 - window);
    if (!full) {
      const int off = q0 + 2 * quad;
      const int hi_a = window && ka + window < sq ? ka + window : sq;
      const int hi_b = window && ka + 8 + window < sq ? ka + 8 + window : sq;
      mask<N>(s, causal ? ka - off : INT_MIN / 2, hi_a - off,
              causal ? ka + 8 - off : INT_MIN / 2, hi_b - off);
    }
    wgmma_wait<0>();  // dP^T has landed
    fence_regs<NS>(dp);
    // dS^T = P^T (dP^T - D); P^T and dS^T packed 4 columns at a time, so
    // their fp32 values die as the fragments fill
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(dd + 8 * j + 2 * quad);
      const float* p = s + 4 * j;
      const float* g = dp + 4 * j;
      sa[2 * j] = pack_bf16(p[0] * (g[0] - d.x), p[1] * (g[1] - d.y));
      sa[2 * j + 1] = pack_bf16(p[2] * (g[2] - d.x), p[3] * (g[3] - d.y));
      pa[2 * j] = pack_bf16(p[0], p[1]);
      pa[2 * j + 1] = pack_bf16(p[2], p[3]);
    }
    // dV += P^T dO and dK += dS^T Q over the step's N rows
    fence_regs_u32<NS / 2>(pa);
    fence_regs_u32<NS / 2>(sa);
    fence_regs<NA>(dva);
    fence_regs<NA>(dka);
    wgmma_fence();
    mma_rs<HDP, N>(dva, pa, dt);
    mma_rs<HDP, N>(dka, sa, qt);
    wgmma_commit();
    wgmma_wait<0>();  // the next iteration refills this stage
    fence_regs<NA>(dva);
    fence_regs<NA>(dka);
    fence_regs_u32<NS / 2>(pa);
    fence_regs_u32<NS / 2>(sa);
  }
  cp_wait<0>();

#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int d = 8 * j + 2 * quad;
    if (d >= HD) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kp = ka + 8 * h;
      if (kp >= sk) continue;
      const int64_t off = ((b * sk + kp) * hkv + hk) * HD + d;
      *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(
          dka[4 * j + 2 * h] * scale, dka[4 * j + 2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) =
          pack_bf16(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
    }
  }
}

// a block per (b, q head, BQQ-row tile), heaviest (latest rows) first,
// whose rows are the fragments' rows.  It walks the live N-key
// steps, K and V streamed through the ring: S = Q K^T and dP = dO V^T
// (wgmma, both K-major), P and dS on the fragments, then dQ += dS K with
// dS as the register A operand and K read MN-major (no transposed copy).
template <int HD, int N>
__global__ void __launch_bounds__(THREADS, BLOCKS)
dq_kernel(const __grid_constant__ CUtensorMap mq,   // BQQ-row boxes
          const __grid_constant__ CUtensorMap mdo,  // BQQ-row boxes
          const __grid_constant__ CUtensorMap mk,   // N-row boxes
          const __grid_constant__ CUtensorMap mv,   // N-row boxes
          const float* __restrict__ lse, const float* __restrict__ dvec,
          __nv_bfloat16* __restrict__ dq, int sq, int sk, int hq, int hkv,
          int causal, int window, float scale, int row_tiles) {
  constexpr int HDP = tc_hdp(HD), NA = HDP / 2;  // dQ floats a thread
  constexpr int NS = N / 2;                      // S floats a thread
  constexpr uint32_t R_BYTES = BQQ * HDP * 2, T_BYTES = N * HDP * 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t dos = qs + R_BYTES;
  const uint32_t ring = dos + R_BYTES;  // STAGES x [K][V]
  const uint32_t bars = ring + STAGES * 2 * T_BYTES;  // STAGES mbarriers

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int64_t b = blockIdx.z;
  const int head = blockIdx.y, hk = head / (hq / hkv);
  const int q0 = (row_tiles - 1 - static_cast<int>(blockIdx.x)) * BQQ;
  // the live keys (bwd_k_range): causal keys up to the last row, windowed
  // keys from the first row - window + 1, rounded down to a step; uniform
  // over the block
  const int q_hi = (q0 + BQQ < sq ? q0 + BQQ : sq) - 1;
  int k_end = sk;
  if (causal && q_hi + 1 < k_end) k_end = q_hi + 1;
  const int k_lo = window && q0 - window + 1 > 0 ? q0 - window + 1 : 0;
  const int k_begin = k_lo / N * N;
  const int n_steps = k_end > k_lo ? (k_end - k_begin + N - 1) / N : 0;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0 sends step t's K and V tiles (with Q and dO at step 0) by TMA
  // to the stage's barrier
  auto load_step = [&](int t) {
    if (tid != 0) return;
    const uint32_t st = static_cast<uint32_t>(t % STAGES);
    const uint32_t kt = ring + st * 2 * T_BYTES, bar = bars + 8 * st;
    mbar_expect(bar, 2 * T_BYTES + (t == 0 ? 2 * R_BYTES : 0));
    if (t == 0) {
      tma_rows<HDP, BQQ>(qs, &mq, bar, HD, head, q0, static_cast<int>(b));
      tma_rows<HDP, BQQ>(dos, &mdo, bar, HD, head, q0, static_cast<int>(b));
    }
    tma_rows<HDP, N>(kt, &mk, bar, HD, hk, k_begin + t * N,
                     static_cast<int>(b));
    tma_rows<HDP, N>(kt + T_BYTES, &mv, bar, HD, hk, k_begin + t * N,
                     static_cast<int>(b));
  };
  if (n_steps > 0) load_step(0);

  // this thread's rows in the fragments: ra and ra + 8, with -lse log2e
  // and D
  const int ra = q0 + 16 * warp + lane / 4, rb = ra + 8;
  const float* lrow = lse + (b * hq + head) * sq;
  const float* drow = dvec + (b * hq + head) * sq;
  const float n_a = ra < sq ? -lrow[ra] * LOG2E : 0.f;
  const float n_b = rb < sq ? -lrow[rb] * LOG2E : 0.f;
  const float d_a = ra < sq ? drow[ra] : 0.f;
  const float d_b = rb < sq ? drow[rb] : 0.f;
  const float sl2 = scale * LOG2E;
  float acc[NA], s[NS], dp[NS];
  uint32_t sa[NS / 2];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    const uint32_t st = static_cast<uint32_t>(t % STAGES);
    mbar_wait(bars + 8 * st, (t / STAGES) & 1);  // step t's tiles landed
    __syncthreads();  // step t - 1 is wholly consumed
    if (t + 1 < n_steps) load_step(t + 1);
    const uint32_t kt = ring + st * 2 * T_BYTES;
    const uint32_t vt = kt + T_BYTES;
    const int k0 = k_begin + t * N;

    // S = Q K^T, then dP = dO V^T
    issue_scores<HD, N>(s, dp, qs, dos, kt, vt);
    wgmma_wait<1>();
    fence_regs<NS>(s);
#pragma unroll
    for (int i = 0; i < NS; ++i)
      s[i] = ex2(fmaf(s[i], sl2, (i % 4) < 2 ? n_a : n_b));
    // keys of this step that row ra (rb) sees, as columns from k0 + 2 quad:
    // below sk; causal up to the row; windowed above the row - window
    const bool full = k0 + N <= sk && (!causal || k0 + N - 1 <= q0) &&
                      (!window || k0 > q0 + BQQ - 1 - window);
    if (!full) {
      const int off = k0 + 2 * quad;
      const int hi_a = causal && ra + 1 < sk ? ra + 1 : sk;
      const int hi_b = causal && rb + 1 < sk ? rb + 1 : sk;
      mask<N>(s, window ? ra - window + 1 - off : INT_MIN / 2, hi_a - off,
              window ? rb - window + 1 - off : INT_MIN / 2, hi_b - off);
    }
    wgmma_wait<0>();
    fence_regs<NS>(dp);
    // dS = P (dP - D), packed 4 columns at a time
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float* p = s + 4 * j;
      const float* g = dp + 4 * j;
      sa[2 * j] = pack_bf16(p[0] * (g[0] - d_a), p[1] * (g[1] - d_a));
      sa[2 * j + 1] = pack_bf16(p[2] * (g[2] - d_b), p[3] * (g[3] - d_b));
    }
    fence_regs_u32<NS / 2>(sa);
    fence_regs<NA>(acc);
    wgmma_fence();
    mma_rs<HDP, N>(acc, sa, kt);
    wgmma_commit();
    wgmma_wait<0>();  // the next iteration refills this stage
    fence_regs<NA>(acc);
    fence_regs_u32<NS / 2>(sa);
  }

#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int d = 8 * j + 2 * quad;
    if (d >= HD) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = ra + 8 * h;
      if (qp >= sq) continue;
      *reinterpret_cast<uint32_t*>(dq + ((b * sq + qp) * hq + head) * HD + d) =
          pack_bf16(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
    }
  }
}

template <int HD, int NQ, int NK>
int launch_steps(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* dvec, void* dq,
                 void* dk, void* dv, int64_t b, int64_t sq, int64_t sk,
                 int64_t hq, int64_t hkv, int causal, int64_t window,
                 float scale, cudaStream_t st) {
  using bf = __nv_bfloat16;
  constexpr int S1 = dkdv_smem(tc_hdp(HD), NQ), S2 = dq_smem(tc_hdp(HD), NK);
  static bool smem_set = false;  // the attributes hold for the process
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        dkdv_kernel<HD, NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, S1);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(dq_kernel<HD, NK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, S2);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const int64_t rows = b * sq * hq;
  const int64_t kt = (sk + BKV - 1) / BKV, qt = (sq + BQQ - 1) / BQQ;
  // positions are 32-bit inside the kernels, as are TMA's coordinates
  if ((rows + 3) / 4 > INT_MAX || sq > INT_MAX / 4 || sk > INT_MAX / 4 ||
      hq > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  // a window past every position masks nothing more than INT_MAX / 4 does
  const int win = window > INT_MAX / 4 ? INT_MAX / 4 : static_cast<int>(window);
  // the TMA maps: Q and dO in the dK/dV pass's NQ-row steps and the dQ
  // pass's BQQ-row blocks, K and V in BKV-row blocks and NK-key steps
  CUtensorMap q_steps, do_steps, k_block, v_block, q_block, do_block,
      k_steps, v_steps;
  if (!row_map(&q_steps, q, b, sq, hq * HD, NQ) ||
      !row_map(&do_steps, dout, b, sq, hq * HD, NQ) ||
      !row_map(&k_block, k, b, sk, hkv * HD, BKV) ||
      !row_map(&v_block, v, b, sk, hkv * HD, BKV) ||
      !row_map(&q_block, q, b, sq, hq * HD, BQQ) ||
      !row_map(&do_block, dout, b, sq, hq * HD, BQQ) ||
      !row_map(&k_steps, k, b, sk, hkv * HD, NK) ||
      !row_map(&v_steps, v, b, sk, hkv * HD, NK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int D_ROWS = 256 / (HD <= 32 ? 4 : (HD <= 64 ? 8 : 16));
  d_kernel<HD><<<static_cast<unsigned>((rows + D_ROWS - 1) / D_ROWS), 256, 0,
                 st>>>(static_cast<const bf*>(o), static_cast<const bf*>(dout),
                       dvec, rows, sq, hq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // the grids' batch axis is the last: the tiling never reads b
  const dim3 g1(static_cast<unsigned>(kt), static_cast<unsigned>(hkv),
                static_cast<unsigned>(b));
  dkdv_kernel<HD, NQ><<<g1, THREADS, S1, st>>>(
      q_steps, do_steps, k_block, v_block, lse, dvec, static_cast<bf*>(dk),
      static_cast<bf*>(dv), static_cast<int>(sq), static_cast<int>(sk),
      static_cast<int>(hq), static_cast<int>(hkv), causal, win, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g2(static_cast<unsigned>(qt), static_cast<unsigned>(hq),
                static_cast<unsigned>(b));
  dq_kernel<HD, NK><<<g2, THREADS, S2, st>>>(
      q_block, do_block, k_steps, v_steps, lse, dvec, static_cast<bf*>(dq),
      static_cast<int>(sq), static_cast<int>(sk), static_cast<int>(hq),
      static_cast<int>(hkv), causal, win, scale, static_cast<int>(qt));
  return static_cast<int>(cudaGetLastError());
}

// the step sizes of both passes from the streamed lengths (tc_step)
template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dvec, void* dq,
           void* dk, void* dv, int64_t b, int64_t sq, int64_t sk, int64_t hq,
           int64_t hkv, int causal, int64_t window, float scale,
           cudaStream_t st) {
  constexpr int HDP = tc_hdp(HD);
  const int nq = tc_step(HDP, sq), nk = tc_step(HDP, sk);
#define REPRO_FA_BWD_STEPS(NQ, NK)                                           \
  if (nq == NQ && nk == NK)                                                  \
    return launch_steps<HD, NQ, NK>(q, k, v, o, dout, lse, dvec, dq, dk, dv, \
                                    b, sq, sk, hq, hkv, causal, window,      \
                                    scale, st);
  if constexpr (HDP == 64) {
    REPRO_FA_BWD_STEPS(128, 128)
    REPRO_FA_BWD_STEPS(128, 64)
    REPRO_FA_BWD_STEPS(64, 128)
  }
  REPRO_FA_BWD_STEPS(64, 64)
#undef REPRO_FA_BWD_STEPS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tcb

// the fp32 backward (the CUDA cores) at head dim `hd`
int dispatch_hd(int64_t hd, const void* q, const void* k, const void* v,
                const void* o, const void* dout, const float* lse,
                float* dvec, void* dq, void* dk, void* dv, int64_t b,
                int64_t sq, int64_t sk, int64_t hq, int64_t hkv, int causal,
                int64_t window, float scale, cudaStream_t st) {
#define REPRO_FA_BWD(HD)                                                     \
  case HD:                                                                   \
    return launch<HD>(q, k, v, o, dout, lse, dvec, dq, dk, dv, b, sq, sk,    \
                      hq, hkv, causal, window, scale, st);
  switch (hd) {
    REPRO_FA_BWD(32)
    REPRO_FA_BWD(64)
    REPRO_FA_BWD(96)
    REPRO_FA_BWD(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FA_BWD
}

}  // namespace

// q, o, dout, dq: contiguous [B, Sq, Hq, hd]; k, v, dk, dv: contiguous
// [B, Sk, Hkv, hd]; all fp32 (dtype 0) or all bf16 (dtype 1); lse: the
// forward's fp32 [B, Hq, Sq]; ws: fp32 [B, Hq, Sq] for D.  hd in 32, 64,
// 96, 128.  Three launches on `stream`, no synchronisation; returns the
// first error.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* ws, void* dq, void* dk,
    void* dv, int64_t b, int64_t sq, int64_t sk, int64_t hq, int64_t hkv,
    int64_t hd, int64_t causal, int64_t window, float scale, int dtype,
    void* stream) {
  if (b == 0 || sq == 0 || hq == 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > 65535 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dvec = static_cast<float*>(ws);
  const int c = causal ? 1 : 0;
  if (dtype == 0)
    return dispatch_hd(hd, q, k, v, o, dout, l, dvec, dq, dk, dv, b, sq, sk,
                       hq, hkv, c, window, scale, st);
  if (dtype == 1) {
#define REPRO_FA_BWD_TC(HD)                                                  \
  if (hd == HD)                                                              \
    return tcb::launch<HD>(q, k, v, o, dout, l, dvec, dq, dk, dv, b, sq, sk, \
                           hq, hkv, c, window, scale, st);
    REPRO_FA_BWD_TC(32)
    REPRO_FA_BWD_TC(64)
    REPRO_FA_BWD_TC(96)
    REPRO_FA_BWD_TC(128)
#undef REPRO_FA_BWD_TC
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
