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
// Deterministic: no atomics, every sum in a fixed order.  Three kernels a
// call: D (`bwd_d_kernel`, one warp a row), then dK/dV with one block per
// (b, kv head, key tile) that loops over the group's q heads and the Q
// tiles the mask leaves live (causal: rows at or after the tile; window:
// rows before tile + window), so GQA's sum over the group happens inside
// the block; then dQ with one block per (b, q head, Q tile) looping over
// the live key tiles.  Both recompute S and dP tile by tile.
//
// bf16 (the training paths; `tcb::`): the products on the tensor cores,
// `mma.sync` m16n8k16 with bf16 operands and fp32 accumulators, 4 warps a
// block of 64 keys (dK/dV, 32-row Q steps) or 64 rows (dQ, 32-key steps),
// each warp 16 of them.  dK/dV computes S^T = K Q^T and dP^T = V dO^T
// (keys x rows), so that P^T and dS^T leave the accumulators already as
// the A fragments of dV += P^T dO and dK += dS^T Q; Q and dO sit in shared
// memory both row-major (S^T's B operand) and transposed (dV's and dK's).
// P and dS are rounded to bf16 for those products (about 2^-9 relative, as
// the forward's PV); S, dP, P, dS are fp32.  Rows padded by 8 elements
// keep the fragment loads free of bank conflicts.
// fp32 (the parity paths): the same on the CUDA cores in fp32, 32 x 32
// tiles, one thread a key and a share of the rows for S and dP, 8 keys x
// 4 dims of dK and dV (or 8 rows x 4 dims of dQ) a thread; TF32 unused.
// A block has hd padded to 32, 64 or 128 (hd 96 runs as 128 with zero
// columns).
// Bound on the H100 at the training shapes: bytes (q, k, v, o, dO read,
// dq, dk, dv written once) at smollm's and qwen3's shapes, operations (5
// products of each live (q, k) pair) at longer sequences (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::pack_bf16;

constexpr int T32 = 32;           // rows (keys) a tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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
// bf16: the same three products on the tensor cores (mma.sync m16n8k16,
// bf16 operands, fp32 accumulators).  P and dS are rounded to bf16 for the
// dV, dK and dQ products (about 2^-9 relative, as the forward's PV); S, dP,
// P and dS themselves are fp32.
// ---------------------------------------------------------------------------

namespace tcb {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BKV = 16 * WARPS;   // keys a dK/dV block (16 a warp)
constexpr int BQ = 32;            // query rows a dK/dV step
constexpr int BQQ = 16 * WARPS;   // query rows a dQ block (16 a warp)
constexpr int BK = 32;            // keys a dQ step

using hopper::a_frag;
using hopper::b_frag;
using hopper::mma;

// rows [r0, r0 + R) of a [.., S, H, hd] bf16 tensor at head `head` into
// shared memory as [R][ld] (row-major) and, when `tr`, as [P][ldt]
// (transposed); zero past `s` and past hd
template <int HD, int R>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          __nv_bfloat16* tr,
                                          const __nv_bfloat16* src, int64_t b,
                                          int64_t s, int64_t h, int64_t head,
                                          int64_t r0, int ld, int ldt) {
  constexpr int P = hdp(HD), CPR = P / 8;
  for (int e = threadIdx.x; e < R * CPR; e += THREADS) {
    const int r = e / CPR, c = (e % CPR) * 8;
    const int64_t row = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < s && c < HD)
      v = *reinterpret_cast<const uint4*>(src + ((b * s + row) * h + head) * HD
                                          + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
    if (tr != nullptr) {
      const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) tr[(c + i) * ldt + r] = x[i];
    }
  }
}

template <int HD>
constexpr int dkdv_smem() {
  constexpr int P = hdp(HD), LD = P + 8, LDT = BQ + 8;
  return (2 * BKV * LD + 2 * BQ * LD + 2 * P * LDT) * 2 + 2 * BQ * 4;
}
template <int HD>
constexpr int dq_smem() {
  constexpr int P = hdp(HD), LD = P + 8, LDT = BK + 8;
  return (2 * BQQ * LD + 2 * BK * LD + P * LDT) * 2;
}

// a block per (b, kv head, 64-key tile); warp w owns keys w*16 .. +16.
// Per (q head of the group, live 32-row Q tile): S^T = K Q^T and
// dP^T = V dO^T (keys x rows), P^T and dS^T, then dV += P^T dO and
// dK += dS^T Q with P^T, dS^T as A fragments straight from the
// accumulators.
template <int HD>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dvec,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int64_t sq, int64_t sk, int64_t hq, int64_t hkv, int causal,
            int64_t window, float scale) {
  constexpr int P = hdp(HD), LD = P + 8, LDT = BQ + 8, NT = P / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + BKV * LD;
  __nv_bfloat16* qs = vs + BKV * LD;      // [BQ][LD]
  __nv_bfloat16* dos = qs + BQ * LD;      // [BQ][LD]
  __nv_bfloat16* qt = dos + BQ * LD;      // [P][LDT]
  __nv_bfloat16* dot = qt + P * LDT;      // [P][LDT]
  float* ls = reinterpret_cast<float*>(dot + P * LDT);
  float* ds = ls + BQ;

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int64_t b = blockIdx.z, hk = blockIdx.y;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * BKV;
  const int64_t group = hq / hkv;
  load_rows<HD, BKV>(ks, nullptr, k, b, sk, hkv, hk, k0, LD, 0);
  load_rows<HD, BKV>(vs, nullptr, v, b, sk, hkv, hk, k0, LD, 0);

  int64_t q_begin = causal ? k0 / BQ * BQ : 0;
  int64_t q_end = sq;
  if (window && k0 + BKV - 1 + window < q_end) q_end = k0 + BKV - 1 + window;

  float acc_v[NT][4], acc_k[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_v[n][i] = acc_k[n][i] = 0.f;
  const int64_t key_a = k0 + w * 16 + g, key_b = key_a + 8;

  for (int64_t gi = 0; gi < group; ++gi) {
    const int64_t head = hk * group + gi;
    for (int64_t q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();  // the previous step's tiles are used
      load_rows<HD, BQ>(qs, qt, q, b, sq, hq, head, q0, LD, LDT);
      load_rows<HD, BQ>(dos, dot, dout, b, sq, hq, head, q0, LD, LDT);
      if (threadIdx.x < BQ) {
        const int64_t qp = q0 + threadIdx.x;
        ls[threadIdx.x] = qp < sq ? lse[(b * hq + head) * sq + qp] : 0.f;
        ds[threadIdx.x] = qp < sq ? dvec[(b * hq + head) * sq + qp] : 0.f;
      }
      __syncthreads();
      float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        uint32_t ak[4], av[4];
        a_frag(ak, ks, LD, w * 16, kk * 16);
        a_frag(av, vs, LD, w * 16, kk * 16);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          uint32_t b0, b1;
          b_frag(b0, b1, qs, LD, n * 8, kk * 16);
          mma(st[n], ak, b0, b1);
          b_frag(b0, b1, dos, LD, n * 8, kk * 16);
          mma(dpt[n], av, b0, b1);
        }
      }
      // P^T and dS^T (rows key_a, key_b; columns this thread's rows of Q),
      // packed as A fragments over the Q axis
      uint32_t ap[BQ / 16][4], as[BQ / 16][4];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ql = n * 8 + c2 + (i & 1);
          const int64_t kp = i < 2 ? key_a : key_b;
          float p = 0.f;
          if (visible(q0 + ql, kp, sq, sk, causal, window))
            p = expf(st[n][i] * scale - ls[ql]);
          pv[i] = p;
          sv[i] = p * (dpt[n][i] - ds[ql]);
        }
        const int j = n / 2, h = n % 2;
        ap[j][2 * h] = pack_bf16(pv[0], pv[1]);
        ap[j][2 * h + 1] = pack_bf16(pv[2], pv[3]);
        as[j][2 * h] = pack_bf16(sv[0], sv[1]);
        as[j][2 * h + 1] = pack_bf16(sv[2], sv[3]);
      }
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t b0, b1;
          b_frag(b0, b1, dot, LDT, n * 8, j * 16);
          mma(acc_v[n], ap[j], b0, b1);
          b_frag(b0, b1, qt, LDT, n * 8, j * 16);
          mma(acc_k[n], as[j], b0, b1);
        }
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + c2;
    if (d >= HD) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t kp = h ? key_b : key_a;
      if (kp >= sk) continue;
      const int64_t off = ((b * sk + kp) * hkv + hk) * HD + d;
      *reinterpret_cast<uint32_t*>(dk + off) =
          pack_bf16(acc_k[n][2 * h] * scale, acc_k[n][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) =
          pack_bf16(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
    }
  }
}

// a block per (b, q head, 64-row Q tile); warp w owns rows w*16 .. +16.
// Per live 32-key tile: S = Q K^T and dP = dO V^T, P and dS, then
// dQ += dS K with dS as A fragments.
template <int HD>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dvec,
          __nv_bfloat16* __restrict__ dq, int64_t sq, int64_t sk, int64_t hq,
          int64_t hkv, int causal, int64_t window, float scale) {
  constexpr int P = hdp(HD), LD = P + 8, LDT = BK + 8, NT = P / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + BQQ * LD;
  __nv_bfloat16* ks = dos + BQQ * LD;    // [BK][LD]
  __nv_bfloat16* vs = ks + BK * LD;      // [BK][LD]
  __nv_bfloat16* kt = vs + BK * LD;      // [P][LDT]

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int64_t b = blockIdx.z, head = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * BQQ;
  const int64_t hk = head / (hq / hkv);
  load_rows<HD, BQQ>(qs, nullptr, q, b, sq, hq, head, q0, LD, 0);
  load_rows<HD, BQQ>(dos, nullptr, dout, b, sq, hq, head, q0, LD, 0);
  const int64_t row_a = q0 + w * 16 + g, row_b = row_a + 8;
  float l_a = 0.f, l_b = 0.f, d_a = 0.f, d_b = 0.f;
  if (row_a < sq) {
    l_a = lse[(b * hq + head) * sq + row_a];
    d_a = dvec[(b * hq + head) * sq + row_a];
  }
  if (row_b < sq) {
    l_b = lse[(b * hq + head) * sq + row_b];
    d_b = dvec[(b * hq + head) * sq + row_b];
  }
  const int64_t q_hi = (q0 + BQQ < sq ? q0 + BQQ : sq) - 1;
  int64_t k_end = sk;
  if (causal && q_hi + 1 < k_end) k_end = q_hi + 1;
  int64_t k_begin = 0;
  if (window && q0 - window + 1 > 0) k_begin = (q0 - window + 1) / BK * BK;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q and dO are in; the previous K, V tiles are used
    load_rows<HD, BK>(ks, kt, k, b, sk, hkv, hk, k0, LD, LDT);
    load_rows<HD, BK>(vs, nullptr, v, b, sk, hkv, hk, k0, LD, 0);
    __syncthreads();
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
      uint32_t aq[4], ao[4];
      a_frag(aq, qs, LD, w * 16, kk * 16);
      a_frag(ao, dos, LD, w * 16, kk * 16);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t b0, b1;
        b_frag(b0, b1, ks, LD, n * 8, kk * 16);
        mma(s[n], aq, b0, b1);
        b_frag(b0, b1, vs, LD, n * 8, kk * 16);
        mma(dp[n], ao, b0, b1);
      }
    }
    uint32_t as[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t kp = k0 + n * 8 + c2 + (i & 1);
        const int64_t qp = i < 2 ? row_a : row_b;
        float x = 0.f;
        if (visible(qp, kp, sq, sk, causal, window)) {
          const float p = expf(s[n][i] * scale - (i < 2 ? l_a : l_b));
          x = p * (dp[n][i] - (i < 2 ? d_a : d_b));
        }
        sv[i] = x;
      }
      const int j = n / 2, h = n % 2;
      as[j][2 * h] = pack_bf16(sv[0], sv[1]);
      as[j][2 * h + 1] = pack_bf16(sv[2], sv[3]);
    }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        b_frag(b0, b1, kt, LDT, n * 8, j * 16);
        mma(acc[n], as[j], b0, b1);
      }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + c2;
    if (d >= HD) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t qp = h ? row_b : row_a;
      if (qp >= sq) continue;
      *reinterpret_cast<uint32_t*>(dq + ((b * sq + qp) * hq + head) * HD + d) =
          pack_bf16(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dvec, void* dq,
           void* dk, void* dv, int64_t b, int64_t sq, int64_t sk, int64_t hq,
           int64_t hkv, int causal, int64_t window, float scale,
           cudaStream_t st) {
  using bf = __nv_bfloat16;
  constexpr int S1 = dkdv_smem<HD>(), S2 = dq_smem<HD>();
  static bool smem_set = false;  // the attributes hold for the process
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, S1);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, S2);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const int64_t rows = b * sq * hq;
  const int64_t kt = (sk + BKV - 1) / BKV, qt = (sq + BQQ - 1) / BQQ;
  if ((rows + 7) / 8 > 2147483647LL || kt > 2147483647LL ||
      qt > 2147483647LL || hq > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bf* qp = static_cast<const bf*>(q);
  const bf* kp = static_cast<const bf*>(k);
  const bf* vp = static_cast<const bf*>(v);
  const bf* dop = static_cast<const bf*>(dout);
  bwd_d_kernel<bf, HD><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const bf*>(o), dop, dvec, rows, sq, hq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv_kernel<HD><<<dim3(static_cast<unsigned>(kt),
                         static_cast<unsigned>(hkv),
                         static_cast<unsigned>(b)),
                    THREADS, S1, st>>>(qp, kp, vp, dop, lse, dvec,
                                       static_cast<bf*>(dk),
                                       static_cast<bf*>(dv), sq, sk, hq, hkv,
                                       causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kernel<HD><<<dim3(static_cast<unsigned>(qt), static_cast<unsigned>(hq),
                       static_cast<unsigned>(b)),
                  THREADS, S2, st>>>(qp, kp, vp, dop, lse, dvec,
                                     static_cast<bf*>(dq), sq, sk, hq, hkv,
                                     causal, window, scale);
  return static_cast<int>(cudaGetLastError());
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
