// Flash attention forward for Hopper (sm_90a), with GQA, causal and
// sliding-window masks and a key-count limit (sk_valid).
//
// Replaces the TPU kernel `_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py: online-softmax attention over
// q [B, Sq, Hq, hd] and k, v [B, Sk, Hkv, hd], every attention block of the
// dense token models in prefill (Sq = Sk = prompt) and in decode (Sq = 1
// against the KV cache, sk_valid = position + 1).
//
// What bounds it on the card: at prefill, operations (4 * B * Hq * Sq * Sk
// * hd flops, half of them under a causal mask); at decode, memory (the
// K/V cache is read once).  This first version does its products on the
// CUDA cores in fp32; wgmma/TMA and a split over the KV axis for decode
// are later work.
//
// Design:
// - K/V tiles move from device memory in 16-byte vectors (so q, k, v must
//   sit at 16-byte aligned addresses), every load of a thread issued before
//   the previous tile's barrier, so the copy overlaps the other warps' work.
// - The TPU walked the KV tiles as its sequential third grid axis with
//   (m, l, acc) in VMEM scratch.  Blocks here run in no order, so one
//   block owns (batch b, kv head hk, a tile of BQ = 16 query rows) and
//   loops over the KV tiles itself; (m, l, acc) stay in registers.
// - GQA: the G = Hq / Hkv query heads of kv head hk are folded into the
//   block's rows, row r = position * G + head-in-group, so one K/V tile in
//   shared memory serves the whole group and no K/V is copied per head.
// - 4 warps, each owning 4 rows.  Scores: lane j takes key j of the
//   32-key tile (K rows padded by 4 floats, so the float4 reads of 32
//   lanes hit distinct banks; the query row is a broadcast read).  The
//   online softmax reduces each row over the warp with xor shuffles.  PV:
//   lane l accumulates dims l, l + 32, ... of each row, with p of key j
//   broadcast from lane j by a shuffle.
// - Masks as on the TPU: a masked score is -1e30 before the row max, and
//   the output is acc / max(l, 1e-30).  KV tiles wholly masked for every
//   row of the block (above the causal diagonal, below the window, at or
//   past sk_valid) are skipped: there p = 0 and the correction is 1.
// q, k, v are fp32 or bf16 (all one type); math is fp32; out has q's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;           // warps per block
constexpr int RW = 4;           // query rows per warp
constexpr int BQ = NW * RW;     // query rows per block
constexpr int BK = 32;          // keys per KV tile (one per lane)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of T (8 bf16 or 4 fp32) from a 16-byte aligned address, as fp32
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    out[0] = r.x, out[1] = r.y, out[2] = r.z, out[3] = r.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x, out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NW * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int64_t sq,
                 int64_t sk, int64_t hq, int64_t hkv, int causal,
                 int64_t window, int64_t sk_valid, float scale) {
  constexpr int C = HD / 32;    // dims per lane in the PV sum
  constexpr int KP = HD + 4;    // padded K row (float4-aligned, no conflicts)
  __shared__ __align__(16) float qs[BQ][HD];
  __shared__ __align__(16) float ks[BK][KP];
  __shared__ __align__(16) float vs[BK][HD];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid & 31;
  const int64_t b = blockIdx.z, hk = blockIdx.y;
  const int64_t group = hq / hkv;
  const int64_t rows = sq * group;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * BQ;

  // query tile, row r = position * group + head-in-group
  for (int e = tid; e < BQ * HD; e += NW * 32) {
    const int rr = e / HD, dd = e % HD;
    const int64_t r = r0 + rr;
    float val = 0.f;
    if (r < rows) {
      const int64_t pos = r / group, head = hk * group + r % group;
      val = to_f32(q[((b * sq + pos) * hq + head) * HD + dd]);
    }
    qs[rr][dd] = val;
  }

  int64_t qpos[RW];
  float m[RW], l[RW], acc[RW][C];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int64_t r = r0 + warp * RW + i;
    qpos[i] = (r < rows ? r : rows - 1) / group;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }
  const bool active = r0 + warp * RW < rows;

  // KV range that some row of this block can see
  const int64_t q_lo = r0 / group;
  const int64_t q_hi = ((r0 + BQ < rows ? r0 + BQ : rows) - 1) / group;
  int64_t kv_end = sk_valid < sk ? sk_valid : sk;
  if (causal && q_hi + 1 < kv_end) kv_end = q_hi + 1;
  int64_t kv_begin = 0;
  if (window && q_lo - window + 1 > 0) kv_begin = (q_lo - window + 1) / BK * BK;

  // the K/V tile moves in 16-byte vectors, all of a thread's loads issued
  // before its shared-memory stores
  constexpr int VEC = Vec<T>::N;
  constexpr int VPR = HD / VEC;                    // vectors per row
  constexpr int ITER = BK * VPR / (NW * 32);       // vectors per thread
  static_assert(ITER >= 1 && BK * VPR % (NW * 32) == 0, "tile split");
  for (int64_t k0 = kv_begin; k0 < kv_end; k0 += BK) {
    float kf[ITER][VEC], vf[ITER][VEC];
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int e = tid + it * NW * 32;
      const int64_t kp = k0 + e / VPR;
      if (kp < sk) {
        const int64_t off = ((b * sk + kp) * hkv + hk) * HD + (e % VPR) * VEC;
        Vec<T>::load(k + off, kf[it]);
        Vec<T>::load(v + off, vf[it]);
      } else {
#pragma unroll
        for (int x = 0; x < VEC; ++x) kf[it][x] = vf[it][x] = 0.f;
      }
    }
    __syncthreads();  // the query tile is in; the previous KV tile is used
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int e = tid + it * NW * 32;
      const int j = e / VPR, d0 = (e % VPR) * VEC;
#pragma unroll
      for (int x = 0; x < VEC; x += 4) {
        *reinterpret_cast<float4*>(&ks[j][d0 + x]) =
            make_float4(kf[it][x], kf[it][x + 1], kf[it][x + 2], kf[it][x + 3]);
        *reinterpret_cast<float4*>(&vs[j][d0 + x]) =
            make_float4(vf[it][x], vf[it][x + 1], vf[it][x + 2], vf[it][x + 3]);
      }
    }
    __syncthreads();
    if (!active) continue;

    // scores of key k0 + lane against the warp's rows
    float s[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) s[i] = 0.f;
#pragma unroll 8
    for (int d4 = 0; d4 < HD; d4 += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(&ks[lane][d4]);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(&qs[warp * RW + i][d4]);
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }
    const int64_t kp = k0 + lane;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      bool ok = kp < sk_valid && kp < sk;
      if (causal) ok = ok && kp <= qpos[i];
      if (window) ok = ok && kp > qpos[i] - window;
      const float si = ok ? s[i] * scale : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(si));
      const float p = expf(si - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= corr;
      s[i] = p;
    }

    // acc += p @ v, p of key j broadcast from lane j
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pj[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) pj[i] = __shfl_sync(0xffffffffu, s[i], j);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float vv = vs[j][lane + 32 * c];
#pragma unroll
        for (int i = 0; i < RW; ++i) acc[i][c] = fmaf(pj[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int64_t r = r0 + warp * RW + i;
    if (r >= rows) continue;
    const int64_t pos = r / group, head = hk * group + r % group;
    T* orow = out + ((b * sq + pos) * hq + head) * HD;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c) store(orow + lane + 32 * c, acc[i][c] * inv_l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t b, int64_t sq, int64_t sk, int64_t hq, int64_t hkv,
           int causal, int64_t window, int64_t sk_valid, float scale,
           cudaStream_t stream) {
  const int64_t tiles = (sq * (hq / hkv) + BQ - 1) / BQ;
  if (tiles > 2147483647LL || hkv > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(hkv),
                  static_cast<unsigned>(b));
  flash_fwd_kernel<T, HD><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, hq, hkv, causal,
      window, sk_valid, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* out,
                int64_t b, int64_t sq, int64_t sk, int64_t hq, int64_t hkv,
                int64_t hd, int causal, int64_t window, int64_t sk_valid,
                float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, b, sq, sk, hq, hkv, causal, window,
                           sk_valid, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, b, sq, sk, hq, hkv, causal, window,
                           sk_valid, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, b, sq, sk, hq, hkv, causal, window,
                            sk_valid, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: contiguous [B, Sq, Hq, hd]; k, v: contiguous [B, Sk, Hkv, hd];
// dtype 0 = fp32, 1 = bf16.  Launches on `stream`, does not synchronise,
// returns cudaGetLastError() of the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int64_t b,
                                     int64_t sq, int64_t sk, int64_t hq,
                                     int64_t hkv, int64_t hd, int64_t causal,
                                     int64_t window, int64_t sk_valid,
                                     float scale, int dtype, void* stream) {
  if (b == 0 || sq == 0 || hq == 0) return 0;
  if (hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = causal ? 1 : 0;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, out, b, sq, sk, hq, hkv, hd, c,
                              window, sk_valid, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, out, b, sq, sk, hq, hkv, hd,
                                      c, window, sk_valid, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
