// Stabilized mLSTM recurrence (the xLSTM matrix memory) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `mlstm_scan` of
// src/repro/kernels/mlstm_scan.py, which keeps the per-(batch, head)
// state C [hd, hd], n [hd], m resident in VMEM across all chunks of the
// sequence.  Per step t, with k scaled by 1/sqrt(hd) in fp32:
//   log_f = -softplus(-f_t),  m' = max(log_f + m, i_t)
//   ig = exp(i_t - m'),  fg = exp(log_f + m - m')
//   C = fg * C + ig * v_t k_t^T,  n = fg * n + ig * k_t
//   h_t = (C q_t) / max(|n . q_t|, exp(-m'))
//
// What bounds it on the card: neither bytes nor flops, but the sequential
// chain of S steps.  Per step each (b, h) needs 5 hd^2 + 5 hd flops on a
// state it must keep on chip: with ig * v_t[r] taken once per row, each
// element of C costs a multiply and an FMA and C q_t an FMA; n and n . q_t
// the same per column.  At xlstm-350m's hd = 512 the state C is 1 MiB of
// fp32 per (b, h): it fits neither one SM's shared memory (227 KB) nor its
// registers.
//
// Design: the rows of C (the v axis) are independent — row v updates
// from v_t[v] and k_t, and num[v] = C[v, :] . q_t — and only
// den = max(|n . q_t|, exp(-m')) is shared, where n is an [hd] vector any
// warp can keep itself.  So the v axis is split across warps: grid
// (B * H, hd / 16), 4 warps per block, each warp holding 4 rows of C in
// registers (lane l owns columns l, l + 32, ...) and its own copy of n
// and m, and walking all S steps in order.  Warps share nothing, so there
// is no barrier; q_t and k_t are re-read by every warp (L1/L2 hits), and
// step t + 1's inputs are loaded while step t computes.  There is no
// padding: the loop stops at S, so the TPU's pad gates are not needed.
// q, k, v are fp32 or bf16 (one type); gates fp32; h has q's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;            // warps per block
constexpr int RW = 4;            // rows of C per warp
constexpr int ROWS = NW * RW;    // rows of C per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int COLS>
struct Step {
  float q[COLS], k[COLS], v[RW], i, f;

  __device__ __forceinline__ void load(const T* __restrict__ qp,
                                       const T* __restrict__ kp,
                                       const T* __restrict__ vp,
                                       const float* __restrict__ ip,
                                       const float* __restrict__ fp,
                                       int64_t base, int64_t gate, int64_t v0,
                                       int lane, float scale) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      q[c] = to_f32(qp[base + lane + 32 * c]);
      k[c] = to_f32(kp[base + lane + 32 * c]) * scale;
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) v[r] = to_f32(vp[base + v0 + r]);
    i = ip[gate];
    f = fp[gate];
  }
};

template <typename T, int COLS>
__global__ void __launch_bounds__(NW * 32)
mlstm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ ig,
                  const float* __restrict__ fg, T* __restrict__ h,
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

  Step<T, COLS> cur, nxt;
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
    const float den = fmaxf(fabsf(warp_sum(nq)), expf(-m_new));
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
      if (lane == r) store(h + base + v0 + r, num / den);
    }
    m = m_new;
    if (t + 1 < s_len) cur = nxt;
  }
}

template <typename T, int COLS>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, void* h, int64_t b, int64_t s, int64_t heads,
           float scale, cudaStream_t stream) {
  constexpr int HD = 32 * COLS;
  if (b * heads > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(b * heads), HD / ROWS);
  mlstm_scan_kernel<T, COLS><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ig),
      static_cast<const float*>(fg), static_cast<T*>(h), s, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, const void* ig,
                const void* fg, void* h, int64_t b, int64_t s, int64_t heads,
                int64_t hd, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 1>(q, k, v, ig, fg, h, b, s, heads, scale, stream);
    case 64:
      return launch<T, 2>(q, k, v, ig, fg, h, b, s, heads, scale, stream);
    case 128:
      return launch<T, 4>(q, k, v, ig, fg, h, b, s, heads, scale, stream);
    case 256:
      return launch<T, 8>(q, k, v, ig, fg, h, b, s, heads, scale, stream);
    case 512:
      return launch<T, 16>(q, k, v, ig, fg, h, b, s, heads, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, h: contiguous [B, S, H, hd]; i_gate, f_gate: contiguous fp32
// [B, S, H]; dtype 0 = fp32, 1 = bf16.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError() of the launch.
extern "C" int repro_mlstm_scan(const void* q, const void* k, const void* v,
                                const void* i_gate, const void* f_gate,
                                void* h, int64_t b, int64_t s, int64_t heads,
                                int64_t hd, float scale, int dtype,
                                void* stream) {
  if (b == 0 || s == 0 || heads == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, i_gate, f_gate, h, b, s, heads, hd,
                              scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, i_gate, f_gate, h, b, s,
                                      heads, hd, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
