// Flash attention forward for Hopper (sm_90a), with GQA, causal and
// sliding-window masks, a key-count limit (sk_valid) in prefill, and a
// decode that masks each cache slot by the position it stores.
//
// Replaces the TPU kernel `_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py: online-softmax attention over
// q [B, Sq, Hq, hd] and k, v [B, Sk, Hkv, hd], every attention block of the
// dense token models in prefill (Sq = Sk = prompt) and in decode (Sq = 1
// against the KV cache, each slot masked by its stored position).  Three kernels share the
// contract (GQA folded into a block's rows, row = position * G +
// head-in-group, so K/V is never copied per head; masked scores -1e30
// before the row max; KV tiles wholly masked are skipped; the output is
// acc / max(l, 1e-30) in q's type; hd in {32, 64, 96, 128}):
//
// 1. `tc::flash_tc_kernel`, bf16 with Sq > 1 (prefill).  Bound: operations
//    on the tensor cores (4 * B * Hq * pairs * hd flops at 989 TFLOP/s; at
//    qwen3's prefill shape the bytes, 0.421 ms for 28 calls, are the larger
//    bound).  A block owns (b, kv head, 128 folded rows): two warpgroups of
//    64 rows each.  The Q tile is copied once into shared memory; K/V tiles
//    of 64 keys go through a 4-stage ring filled by cp.async (16 bytes a
//    thread, zero-fill past the valid keys), two tiles ahead.  Every tile
//    sits in shared memory as column blocks of [rows][64 bf16] with the
//    128-byte swizzle that the wgmma descriptors name.  S = Q K^T is
//    `wgmma` m64n64k16 with both operands K-major in shared memory (K is
//    stored [.., hd]).  The online softmax runs on the fp32 accumulator
//    fragments: masks per element from 32-bit bounds of the row (a masked
//    score is -inf here, so a row that sees no key keeps l = 0), the row
//    max and sum as trees and then over the 4 threads of a row by
//    shuffles, p = 2^(s * scale * log2e - m) by one FFMA and one ex2.  P is
//    rounded to bf16 in registers and becomes the A operand of O += P V
//    (`wgmma` m64n{hd}k16, A from registers, V as the MN-major B operand
//    through the transpose bit, so V is not transposed anywhere).  Per
//    tile, S_t and then P_{t-1} V_{t-1} are issued together; the softmax
//    of S_t starts once S_t lands, and P is packed once the PV product has
//    landed (ptxas schedules the exponentials after that wait too).  No
//    wgmma sits under a branch (ptxas would serialize it).
//    Numerics: bf16 x bf16 products are exact in fp32; P's rounding to
//    bf16 for the PV product (about 2^-9 relative) is the one departure
//    from the TPU kernel, which kept P in fp32; l sums the unrounded p.
//    Row tiles are launched heaviest first (latest positions under a
//    causal mask).  hd = 32 is held padded to 64 in shared memory, and
//    hd = 96 padded to 128 (`hdp`).  What holds it above its bound on the
//    H100 (PERF.md): with 8 warps on an SM, the load path alone (cp.async,
//    barriers, stores) and the math alone each take longer than a library
//    call takes for both.
// 2. `dec::flash_decode_split_kernel` + `dec::flash_decode_combine_kernel`,
//    Sq == 1 (decode), fp32 or bf16, against a cache whose slots carry the
//    absolute position they hold: k_pos [B, C] (int32, -1 = empty) and the
//    query's position cur [B] (int32), both in device memory, and the
//    window.  Key j of sequence b counts when k_pos[b, j] >= 0,
//    k_pos[b, j] <= cur[b] and, with a window, k_pos[b, j] > cur[b] -
//    window: the reference's `decode_attention` for any slot order (a ring
//    cache, a windowed cache, each sequence at its own position).  Bound:
//    bytes (the valid cache rows and the positions, read once).  One (b, kv
//    head) has too few keys for one block to keep the memory busy, so the
//    C slots are cut into `splits` chunks of whole 32-key tiles (planned on
//    the host from C alone, so no position is read there); each block
//    streams its chunk through a 4-stage cp.async ring.  A tile's 32
//    positions are read (one 4-byte load a lane) before its K/V: their
//    validity bits become the tile's mask (one ballot), and only the valid
//    keys' K/V rows are copied (the rest zero-filled); a tile with no valid
//    key costs its positions and nothing else, so a cache filled only at
//    its start costs about its filled part.  Scores and the online softmax
//    of the G query rows run on the CUDA cores in fp32 (P stays fp32); each
//    block writes its unnormalised (m, l, acc) to an fp32 workspace and the
//    combine kernel merges the splits in a fixed order (no atomics, so
//    repeated calls are bitwise equal).  A split or warp that sees no
//    valid key keeps m = -1e30, l = 0, acc = 0 and adds exactly 0.
// The prefill kernels (1) and (3) also write, when asked (the training
// forward), each row's fp32 log-sum-exp lse = m + log(l) of the scaled
// scores, [B, Hq, Sq], from which the backward (flash_attention_bwd.cu)
// recomputes P; serving does not ask, and its launches are unchanged.
//
// 3. `flash_fwd_kernel`, fp32 with Sq > 1 (the fp32 parity paths), on the
//    CUDA cores: fp32 products have no tensor-core form without TF32, which
//    the port's fp32 parity rule excludes.  A block owns (b, kv head, 16
//    folded rows) and loops over 32-key tiles moved in 16-byte vectors;
//    4 warps of 4 rows, lane j scoring key j, the PV sum by shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// the CUDA-core kernel (3)
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

// 16 bytes of T (4 fp32) from a 16-byte aligned address, as fp32
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
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int64_t sq, int64_t sk, int64_t hq,
                 int64_t hkv, int causal, int64_t window, int64_t sk_valid,
                 float scale) {
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
    if (lse != nullptr && lane == 0)
      lse[(b * hq + head) * sq + pos] = m[i] + logf(l[i]);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int64_t b, int64_t sq, int64_t sk, int64_t hq,
           int64_t hkv, int causal, int64_t window, int64_t sk_valid,
           float scale, cudaStream_t stream) {
  const int64_t tiles = (sq * (hq / hkv) + BQ - 1) / BQ;
  if (tiles > 2147483647LL || hkv > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(hkv),
                  static_cast<unsigned>(b));
  flash_fwd_kernel<T, HD><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, sk, hq, hkv,
      causal, window, sk_valid, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* out,
                float* lse, int64_t b, int64_t sq, int64_t sk, int64_t hq,
                int64_t hkv, int64_t hd, int causal, int64_t window,
                int64_t sk_valid, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, b, sq, sk, hq, hkv, causal, window,
                           sk_valid, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, b, sq, sk, hq, hkv, causal, window,
                           sk_valid, scale, stream);
    case 96:
      return launch<T, 96>(q, k, v, out, lse, b, sq, sk, hq, hkv, causal, window,
                           sk_valid, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, b, sq, sk, hq, hkv, causal, window,
                            sk_valid, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// The tensor-core and split-KV kernels (helpers in hopper.cuh)
// ---------------------------------------------------------------------------

using namespace hopper;

namespace tc {

constexpr int WG = 2;             // consumer warpgroups per block
constexpr int THREADS = 128 * WG;
constexpr int ROWS = 64 * WG;     // GQA-folded query rows per block
constexpr int KT = 64;            // keys per K/V tile
constexpr int STAGES = 4;         // K/V ring depth

// The head dim as held in shared memory: whole [rows][64 bf16] column
// blocks, so the wgmma descriptors and the PV product (m64n64 or m64n128)
// see 64 or 128 dims.  hd 32 is held as 64 and hd 96 as 128: the padded
// Q and K columns are zero-filled (they add nothing to S), the padded V
// columns are zero too, and PV's extra output columns are never written.
__host__ __device__ constexpr int hdp(int hd) { return hd <= 64 ? 64 : 128; }

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int64_t sq, int64_t sk, int64_t hq, int64_t hkv, int causal,
                int64_t window, int64_t sk_valid, float scale_log2,
                int64_t row_tiles) {
  constexpr int HDP = hdp(HD);            // head dim as held in shared memory
  constexpr int CPR = HDP / 8;            // 16-byte chunks per row
  constexpr uint32_t Q_BYTES = ROWS * HDP * 2;
  constexpr uint32_t KV_BYTES = KT * HDP * 2;
  constexpr int NO = HDP / 2;             // O accumulators per thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ks = qs + Q_BYTES;                  // STAGES K tiles
  const uint32_t vs = ks + STAGES * KV_BYTES;        // STAGES V tiles

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int64_t b = blockIdx.z, hk = blockIdx.y;
  const int64_t group = hq / hkv, rows = sq * group;
  // heaviest row tiles (latest positions under a causal mask) first
  const int64_t r0 = (row_tiles - 1 - blockIdx.x) * ROWS;

  // KV range that some row of this block can see
  const int64_t q_lo = r0 / group;
  const int64_t q_hi = ((r0 + ROWS < rows ? r0 + ROWS : rows) - 1) / group;
  const int64_t kv_valid = sk_valid < sk ? sk_valid : sk;
  int64_t kv_end = kv_valid;
  if (causal && q_hi + 1 < kv_end) kv_end = q_hi + 1;
  int64_t kv_begin = 0;
  if (window && q_lo - window + 1 > 0) kv_begin = (q_lo - window + 1) / KT * KT;
  const int n_tiles =
      kv_end > kv_begin ? static_cast<int>((kv_end - kv_begin + KT - 1) / KT)
                        : 0;

  if (n_tiles == 0) {  // no visible key: acc = 0, l = 0, the rows are 0
    for (int e = tid; e < ROWS * HD; e += THREADS) {
      const int64_t r = r0 + e / HD;
      if (r >= rows) continue;
      const int64_t pos = r / group, head = hk * group + r % group;
      out[((b * sq + pos) * hq + head) * HD + e % HD] = __float2bfloat16(0.f);
      // lse = +inf: P = exp(s - lse) is 0 for every key
      if (lse != nullptr && e % HD == 0)
        lse[(b * hq + head) * sq + pos] = __int_as_float(0x7f800000);
    }
    return;
  }

  // Q tile: row i is folded row r0 + i (zero past the last row / past hd)
#pragma unroll
  for (int it = 0; it < ROWS * CPR / THREADS; ++it) {
    const int e = tid + it * THREADS;
    const int i = e / CPR, c = e % CPR;
    const int64_t r = r0 + i;
    const __nv_bfloat16* src = q;
    int bytes = 0;
    if (r < rows && c * 8 < HD) {
      const int64_t pos = r / group, head = hk * group + r % group;
      src = q + ((b * sq + pos) * hq + head) * HD + c * 8;
      bytes = 16;
    }
    cp16(qs + sw_off(i, c, ROWS), src, bytes);
  }
  auto load_kv = [&](int tile) {
    const uint32_t st = static_cast<uint32_t>(tile % STAGES) * KV_BYTES;
    const int64_t k0 = kv_begin + static_cast<int64_t>(tile) * KT;
#pragma unroll
    for (int it = 0; it < KT * CPR / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int j = e / CPR, c = e % CPR;
      const int64_t kp = k0 + j;
      int64_t off = 0;
      int bytes = 0;
      if (kp < kv_end && c * 8 < HD) {
        off = ((b * sk + kp) * hkv + hk) * HD + c * 8;
        bytes = 16;
      }
      const uint32_t o = sw_off(j, c, KT);
      cp16(ks + st + o, k + off, bytes);
      cp16(vs + st + o, v + off, bytes);
    }
  };
  // group t holds tile t (group 0 also Q): tiles 0 .. STAGES-3 go now;
  // iteration t refills the stage of tile t - 2 with tile t + STAGES - 2
  // (tile t - 1's V is still being read by its PV product then)
#pragma unroll
  for (int t = 0; t < STAGES - 2; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_commit();
  }

  // this thread's rows in the accumulator fragments: ra and ra + 8
  const int64_t ra = r0 + 64 * wg + 16 * warp + lane / 4, rb = ra + 8;
  const int64_t pa = ra / group, pb = rb / group;
  const int quad = lane % 4;
  float o[NO], s[32];
  uint32_t p[16];  // P (bf16 pairs) of the tile in the PV product
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = 0u;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  const uint32_t q_wg = qs + wg * 64 * 128;  // this warpgroup's 64 rows

  // O += P V over one V tile: 16 keys a step, V MN-major (8-key groups
  // 1024 bytes apart, 64-dim column blocks KT * 128 bytes apart)
  auto issue_pv = [&](int tile) {
    const uint32_t vt = vs + static_cast<uint32_t>(tile % STAGES) * KV_BYTES;
    fence_regs_u32<16>(p);  // P and O settled before this wgmma stage
    fence_regs<NO>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint64_t db = sw128_desc(vt + kk * 2048, KT * 128, 1024);
      if (HDP == 128)
        wgmma_rs_m64n128_mn(o, p + 4 * kk, db);
      else
        wgmma_rs_m64n64_mn(o, p + 4 * kk, db);
    }
    wgmma_commit();
  };

  // the stage holding `tile` is in for every thread; refill tile - 2's
  auto wait_tile = [&](int tile) {
    cp_wait<STAGES - 3>();  // group `tile` has landed (this thread's part)
    fence_proxy_async();
    __syncthreads();  // ... everyone's; tile - 2 is wholly consumed
    if (tile + STAGES - 2 < n_tiles) load_kv(tile + STAGES - 2);
    cp_commit();
  };
  // S = Q K^T over hd (K-major operands; 16 columns = 32 bytes a step)
  auto issue_s = [&](int tile) {
    const uint32_t kt = ks + static_cast<uint32_t>(tile % STAGES) * KV_BYTES;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs<32>(s);
    fence_regs<NO>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t cb = kk / 4, col = (kk % 4) * 32;
      const uint64_t da = sw128_desc(q_wg + cb * ROWS * 128 + col, 16, 1024);
      const uint64_t db = sw128_desc(kt + cb * KT * 128 + col, 16, 1024);
      wgmma_ss_m64n64(s, da, db, kk > 0 ? 1 : 0);
    }
    wgmma_commit();
  };
  // the S fragment is P's A fragment: p[2j] = row ra, p[2j+1] = row rb of
  // key block j; packed once the previous PV product has landed
  auto pack_p = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      p[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
      p[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
  };
  float c_a, c_b;
  // keys row ra (rb) may see, as offsets from a tile's first key and this
  // thread's first column (2 * quad): [lo, hi), 32-bit
  const int64_t hi_a64 = causal && pa + 1 < kv_valid ? pa + 1 : kv_valid;
  const int64_t hi_b64 = causal && pb + 1 < kv_valid ? pb + 1 : kv_valid;
  const int hi_a = static_cast<int>(hi_a64 - kv_begin) - 2 * quad;
  const int hi_b = static_cast<int>(hi_b64 - kv_begin) - 2 * quad;
  const int lo_a = window ? static_cast<int>(pa - window + 1 - kv_begin) -
                                2 * quad
                          : INT_MIN / 2;
  const int lo_b = window ? static_cast<int>(pb - window + 1 - kv_begin) -
                                2 * quad
                          : INT_MIN / 2;
  // mask, online softmax of rows ra, rb on the raw scores: the max on raw
  // scores (scale > 0), p = 2^(s * scale·log2e - m) by one FFMA and one
  // ex2 each; the new p (fp32) into s, O's rescale factors into c_a, c_b
  auto softmax = [&](int tile) {
    const int t0 = tile * KT;
    const int64_t k0 = kv_begin + t0;
    const bool full = k0 + KT <= kv_valid &&
                      (!causal || k0 + KT - 1 <= q_lo) &&
                      (!window || k0 > q_hi - window);
    if (!full) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = t0 + 8 * (i / 4) + (i % 2);
        const bool ok = (i % 4) < 2 ? c < hi_a && c >= lo_a
                                    : c < hi_b && c >= lo_b;
        // -inf, not NEG_INF: a row whose keys so far are all masked keeps
        // m = NEG_INF, and 2^(NEG_INF * scale_log2 - m) would be 2^(the
        // product's rounding error), up to inf; 2^-inf is 0 exactly
        if (!ok) s[i] = -__int_as_float(0x7f800000);
      }
    }
    // row maxima (and below, sums) as trees over the thread's 16 values
    // of each row, then over the 4 threads of the row
    float ta[8], tb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ta[j] = fmaxf(s[4 * j], s[4 * j + 1]);
      tb[j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
    }
#pragma unroll
    for (int w = 4; w > 0; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) {
        ta[j] = fmaxf(ta[j], ta[j + w]);
        tb[j] = fmaxf(tb[j], tb[j + w]);
      }
    float mx_a = ta[0], mx_b = tb[0];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a * scale_log2);
    const float mn_b = fmaxf(m_b, mx_b * scale_log2);
    c_a = ex2(m_a - mn_a);
    c_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float e0 = ex2(fmaf(s[4 * j], scale_log2, -mn_a));
      const float e1 = ex2(fmaf(s[4 * j + 1], scale_log2, -mn_a));
      const float e2 = ex2(fmaf(s[4 * j + 2], scale_log2, -mn_b));
      const float e3 = ex2(fmaf(s[4 * j + 3], scale_log2, -mn_b));
      ta[j] = e0 + e1;
      tb[j] = e2 + e3;
      s[4 * j] = e0, s[4 * j + 1] = e1, s[4 * j + 2] = e2, s[4 * j + 3] = e3;
    }
#pragma unroll
    for (int w = 4; w > 0; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) {
        ta[j] += ta[j + w];
        tb[j] += tb[j + w];
      }
    l_a = l_a * c_a + ta[0];
    l_b = l_b * c_b + tb[0];
  };

  // Tile 0 alone, then per tile t: S_t = Q K_t^T is issued, then
  // O += P_{t-1} V_{t-1}; the softmax of S_t runs while that PV product is
  // in flight, and O is rescaled once it lands.  Every wgmma sits on a path
  // all threads take (a wgmma under a branch is serialized by ptxas).
  wait_tile(0);
  issue_s(0);
  wgmma_wait<0>();
  fence_regs<32>(s);
  softmax(0);  // O is zero: no rescale
  pack_p();
  for (int tile = 1; tile < n_tiles; ++tile) {
    wait_tile(tile);
    issue_s(tile);
    issue_pv(tile - 1);
    wgmma_wait<1>();  // S has landed; the PV product may still run
    fence_regs<32>(s);
    softmax(tile);
    wgmma_wait<0>();  // the PV product of tile - 1 has landed
    fence_regs<NO>(o);
    fence_regs_u32<16>(p);
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= (i % 4) < 2 ? c_a : c_b;
    pack_p();
  }
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs<NO>(o);
  fence_regs_u32<16>(p);
  cp_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = h ? rb : ra;
    if (r >= rows) continue;
    const float inv = h ? inv_b : inv_a;
    const int64_t pos = r / group, head = hk * group + r % group;
    __nv_bfloat16* orow = out + ((b * sq + pos) * hq + head) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const uint32_t pk =
          pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * quad) = pk;
    }
    // lse (natural units) = (m + log2 l) * ln 2, m in log2 units
    if (lse != nullptr && quad == 0)
      lse[(b * hq + head) * sq + pos] =
          ((h ? m_b : m_a) + log2f(h ? l_b : l_a)) * 0.6931471805599453f;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int64_t b, int64_t sq, int64_t sk, int64_t hq, int64_t hkv,
           int causal, int64_t window, int64_t sk_valid, float scale,
           cudaStream_t stream) {
  constexpr int HDP = hdp(HD);
  constexpr int SMEM = 1024 + ROWS * HDP * 2 + 2 * STAGES * KT * HDP * 2;
  static bool smem_set = false;  // the attribute holds for the process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const int64_t tiles = (sq * (hq / hkv) + ROWS - 1) / ROWS;
  if (tiles > 2147483647LL || hkv > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(hkv),
                  static_cast<unsigned>(b));
  flash_tc_kernel<HD><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, sq, sk, hq, hkv, causal, window, sk_valid,
      scale * 1.4426950408889634f, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

namespace dec {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int KT = 32;      // keys per tile, 8 per warp
constexpr int STAGES = 4;   // cp.async ring depth

// N consecutive elements of T (N * sizeof(T) bytes, as aligned) as fp32
template <int N, typename T>
__device__ __forceinline__ void load_f32(const T* p, float* o) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  if constexpr (BYTES == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_f32(e[i]);
  } else if constexpr (BYTES == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_f32(p[i]);
  }
}

template <typename T, int HD>
constexpr int ring_bytes() {
  return 2 * STAGES * KT * HD * static_cast<int>(sizeof(T));
}
template <int HD, int GR>
constexpr int merge_bytes() {
  return WARPS * GR * (HD + 2) * 4;
}

// grid (splits, hkv * ceil(G / GR), b): split s of (b, kv head) covers the
// slots [s * chunk, min(sk, (s + 1) * chunk)) for GR of the G query rows;
// writes (m, l) and acc (fp32, log2 domain) per (b, head, s)
template <typename T, int HD, int GR>
__global__ void __launch_bounds__(THREADS)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ kpos,
                          const int* __restrict__ cur,
                          float* __restrict__ ws_ml,
                          float* __restrict__ ws_acc, int64_t sk, int64_t hq,
                          int64_t hkv, int64_t window, int64_t chunk,
                          int64_t splits, float scale_log2) {
  constexpr int DPL = HD / 32;                  // dims per lane
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int CPR = HD / VEC;                 // 16-byte chunks per key
  constexpr int TILE = KT * HD;                 // elements per K (V) tile
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ uint32_t tmask[STAGES];            // valid keys of each stage
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + STAGES * TILE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t s = blockIdx.x, b = blockIdx.z;
  const int64_t group = hq / hkv, groups = (group + GR - 1) / GR;
  const int64_t hk = blockIdx.y / groups, g0 = (blockIdx.y % groups) * GR;
  const int64_t k_lo = s * chunk;
  const int64_t k_hi = sk < k_lo + chunk ? sk : k_lo + chunk;
  const int n_tiles =
      k_hi > k_lo ? static_cast<int>((k_hi - k_lo + KT - 1) / KT) : 0;
  const int64_t now = cur[b];
  const int64_t oldest = window > 0 ? now - window : INT64_MIN;

  // every warp reads the tile's 32 positions and forms the same mask; only
  // valid keys' rows are copied, a tile without one issues no copy
  auto issue = [&](int tile) {
    const int st = tile % STAGES;
    const int64_t k0 = k_lo + static_cast<int64_t>(tile) * KT;
    bool ok = false;
    if (k0 + lane < k_hi) {
      const int64_t p = kpos[b * sk + k0 + lane];
      ok = p >= 0 && p <= now && p > oldest;
    }
    const uint32_t live = __ballot_sync(0xffffffffu, ok);
    if (tid == 0) tmask[st] = live;
    if (live == 0) return;
#pragma unroll
    for (int it = 0; it < KT * CPR / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int j = e / CPR, c = e % CPR;
      int64_t off = 0;
      int bytes = 0;
      if ((live >> j) & 1u) {
        off = ((b * sk + k0 + j) * hkv + hk) * HD + c * VEC;
        bytes = 16;
      }
      const int at = st * TILE + j * HD + c * VEC;
      cp16(smem_u32(ks + at), k + off, bytes);
      cp16(smem_u32(vs + at), v + off, bytes);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) issue(st);
    cp_commit();
  }

  // the GR query rows at this lane's dims, fp32, scaled into log2 units
  float qr[GR][DPL], acc[GR][DPL], m[GR], l[GR];
#pragma unroll
  for (int i = 0; i < GR; ++i) {
    const int64_t g = g0 + i;
    if (g < group) {
      load_f32<DPL>(q + (b * hq + hk * group + g) * HD + lane * DPL,
                        qr[i]);
    } else {
#pragma unroll
      for (int d = 0; d < DPL; ++d) qr[i][d] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      qr[i][d] *= scale_log2;
      acc[i][d] = 0.f;
    }
    m[i] = NEG_INF;
    l[i] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // tile landed for all; tile - 1's stage is free
    const uint32_t tile_live = tmask[tile % STAGES];
    const uint32_t live = tile_live >> (warp * 8);  // this warp's 8 keys
    if (tile + STAGES - 1 < n_tiles) issue(tile + STAGES - 1);
    cp_commit();
    if (tile_live == 0) continue;  // the same for the whole block
    const T* kt = ks + (tile % STAGES) * TILE + warp * 8 * HD + lane * DPL;
    const T* vt = vs + (tile % STAGES) * TILE + warp * 8 * HD + lane * DPL;

    // this warp's 8 keys: scores of every row, reduced over the warp
    float sc[GR][8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float kf[DPL];
      load_f32<DPL>(kt + jj * HD, kf);
#pragma unroll
      for (int i = 0; i < GR; ++i) {
        float x = 0.f;
#pragma unroll
        for (int d = 0; d < DPL; ++d) x = fmaf(qr[i][d], kf[d], x);
        sc[i][jj] = x;
      }
    }
#pragma unroll
    for (int i = 0; i < GR; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        sc[i][jj] = warp_sum(sc[i][jj]);

    float pv[GR][8];
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        if ((live >> jj) & 1u) mx = fmaxf(mx, sc[i][jj]);
      const float mn = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        pv[i][jj] = (live >> jj) & 1u ? exp2f(sc[i][jj] - mn) : 0.f;
        sum += pv[i][jj];
      }
      m[i] = mn;
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] *= corr;
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float vf[DPL];
      load_f32<DPL>(vt + jj * HD, vf);
#pragma unroll
      for (int i = 0; i < GR; ++i)
#pragma unroll
        for (int d = 0; d < DPL; ++d)
          acc[i][d] = fmaf(pv[i][jj], vf[d], acc[i][d]);
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: merge the 4 warps through it

  float* red = reinterpret_cast<float*>(smem_raw);  // [WARPS][GR][2 + HD]
#pragma unroll
  for (int i = 0; i < GR; ++i) {
    float* row = red + (warp * GR + i) * (HD + 2);
    if (lane == 0) row[0] = m[i], row[1] = l[i];
#pragma unroll
    for (int d = 0; d < DPL; ++d) row[2 + lane * DPL + d] = acc[i][d];
  }
  __syncthreads();
  for (int e = tid; e < GR * HD; e += THREADS) {
    const int i = e / HD, d = e % HD;
    const int64_t g = g0 + i;
    if (g >= group) continue;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      mm = fmaxf(mm, red[(w * GR + i) * (HD + 2)]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* row = red + (w * GR + i) * (HD + 2);
      const float f = exp2f(row[0] - mm);
      a = fmaf(row[2 + d], f, a);
      ll = fmaf(row[1], f, ll);
    }
    const int64_t at = (b * hq + hk * group + g) * splits + s;
    ws_acc[at * HD + d] = a;
    if (d == 0) ws_ml[2 * at] = mm, ws_ml[2 * at + 1] = ll;
  }
}

// grid (hq, b), HD threads: out[b, 0, head, d] from the splits, in order
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
flash_decode_combine_kernel(const float* __restrict__ ws_ml,
                            const float* __restrict__ ws_acc,
                            T* __restrict__ out, int64_t splits) {
  const int64_t row = static_cast<int64_t>(blockIdx.y) * gridDim.x +
                      blockIdx.x;  // b * hq + head
  const int d = threadIdx.x;
  const float* ml = ws_ml + 2 * row * splits;
  float mm = NEG_INF;
  for (int64_t s = 0; s < splits; ++s) mm = fmaxf(mm, ml[2 * s]);
  float a = 0.f, ll = 0.f;
  for (int64_t s = 0; s < splits; ++s) {
    const float f = exp2f(ml[2 * s] - mm);
    a = fmaf(ws_acc[(row * splits + s) * HD + d], f, a);
    ll = fmaf(ml[2 * s + 1], f, ll);
  }
  store(out + row * HD + d, a / fmaxf(ll, 1e-30f));
}

template <typename T, int HD, int GR>
int launch(const void* q, const void* k, const void* v, const int* kpos,
           const int* cur, void* out, float* ws, int64_t b, int64_t sk,
           int64_t hq, int64_t hkv, int64_t window, int64_t splits,
           int64_t chunk, float scale, cudaStream_t stream) {
  constexpr int RING = ring_bytes<T, HD>(), MERGE = merge_bytes<HD, GR>();
  constexpr int SMEM = RING > MERGE ? RING : MERGE;
  auto split_kernel = flash_decode_split_kernel<T, HD, GR>;
  static bool smem_set = false;  // the attribute holds for the process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const int64_t groups = (hq / hkv + GR - 1) / GR;
  if (splits > 2147483647LL || hkv * groups > 65535 || b > 65535 ||
      hq > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  float* ws_ml = ws;
  float* ws_acc = ws + 2 * b * hq * splits;
  const dim3 grid(static_cast<unsigned>(splits),
                  static_cast<unsigned>(hkv * groups),
                  static_cast<unsigned>(b));
  split_kernel<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kpos, cur, ws_ml, ws_acc, sk, hq, hkv,
      window, chunk, splits, scale * 1.4426950408889634f);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_decode_combine_kernel<T, HD>
      <<<dim3(static_cast<unsigned>(hq), static_cast<unsigned>(b)), HD, 0,
         stream>>>(ws_ml, ws_acc, static_cast<T*>(out), splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int GR>
int dispatch_hd(int64_t hd, const void* q, const void* k, const void* v,
                const int* kpos, const int* cur, void* out, float* ws,
                int64_t b, int64_t sk, int64_t hq, int64_t hkv,
                int64_t window, int64_t splits, int64_t chunk, float scale,
                cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32, GR>(q, k, v, kpos, cur, out, ws, b, sk, hq, hkv,
                               window, splits, chunk, scale, st);
    case 64:
      return launch<T, 64, GR>(q, k, v, kpos, cur, out, ws, b, sk, hq, hkv,
                               window, splits, chunk, scale, st);
    case 96:
      return launch<T, 96, GR>(q, k, v, kpos, cur, out, ws, b, sk, hq, hkv,
                               window, splits, chunk, scale, st);
    case 128:
      return launch<T, 128, GR>(q, k, v, kpos, cur, out, ws, b, sk, hq, hkv,
                                window, splits, chunk, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace dec

}  // namespace

// q, out: contiguous fp32 [B, Sq, Hq, hd]; k, v: contiguous fp32
// [B, Sk, Hkv, hd].  The CUDA-core kernel (3).  `lse`, when not null, gets
// the fp32 log-sum-exp of each row's scaled scores, [B, Hq, Sq] (the
// training forward; the backward recomputes P from it).  Launches on
// `stream`, does not synchronise, returns cudaGetLastError() of the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int64_t b,
                                     int64_t sq, int64_t sk, int64_t hq,
                                     int64_t hkv, int64_t hd, int64_t causal,
                                     int64_t window, int64_t sk_valid,
                                     float scale, void* lse, void* stream) {
  if (b == 0 || sq == 0 || hq == 0) return 0;
  if (hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_hd<float>(q, k, v, out, static_cast<float*>(lse), b, sq,
                            sk, hq, hkv, hd,
                            causal ? 1 : 0, window, sk_valid, scale,
                            static_cast<cudaStream_t>(stream));
}

// The tensor-core kernel (1): bf16 q, k, v, out as above (16-byte aligned),
// `lse` as above.
extern "C" int repro_flash_attention_tc(const void* q, const void* k,
                                        const void* v, void* out, int64_t b,
                                        int64_t sq, int64_t sk, int64_t hq,
                                        int64_t hkv, int64_t hd,
                                        int64_t causal, int64_t window,
                                        int64_t sk_valid, float scale,
                                        void* lse, void* stream) {
  if (b == 0 || sq == 0 || hq == 0) return 0;
  if (hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = causal ? 1 : 0;
  float* const l = static_cast<float*>(lse);
  switch (hd) {
    case 32:
      return tc::launch<32>(q, k, v, out, l, b, sq, sk, hq, hkv, c, window,
                            sk_valid, scale, s);
    case 64:
      return tc::launch<64>(q, k, v, out, l, b, sq, sk, hq, hkv, c, window,
                            sk_valid, scale, s);
    case 96:
      return tc::launch<96>(q, k, v, out, l, b, sq, sk, hq, hkv, c, window,
                            sk_valid, scale, s);
    case 128:
      return tc::launch<128>(q, k, v, out, l, b, sq, sk, hq, hkv, c, window,
                             sk_valid, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The split-KV decode (2): q, out [B, 1, Hq, hd]; k, v [B, C, Hkv, hd];
// kpos [B, C] int32 (the position each slot holds, -1 = empty) and cur
// [B] int32 (the query's position), in device memory; window 0 = none.
// The C slots are cut into `splits` chunks of `chunk` slots (a multiple of
// 32, every chunk non-empty); `rows` query rows of a group per block (2 or
// 8); ws holds B * Hq * splits * (hd + 2) floats.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* kpos, const void* cur,
                                  void* out, void* ws, int64_t b, int64_t sk,
                                  int64_t hq, int64_t hkv, int64_t hd,
                                  int64_t window, int64_t splits,
                                  int64_t chunk, int64_t rows, float scale,
                                  int dtype, void* stream) {
  if (b == 0 || hq == 0) return 0;
  // every split non-empty, together exactly [0, C); C = 0 is one empty
  // split (the output is then 0, as with no valid key in prefill)
  const bool plan_ok = sk == 0 ? splits == 1
                               : (splits - 1) * chunk < sk &&
                                     splits * chunk >= sk;
  if (hkv <= 0 || hq % hkv != 0 || splits < 1 || chunk <= 0 ||
      chunk % dec::KT != 0 || sk < 0 || window < 0 || !plan_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const int* kp = static_cast<const int*>(kpos);
  const int* cp = static_cast<const int*>(cur);
#define REPRO_DEC(T, GR)                                                     \
  dec::dispatch_hd<T, GR>(hd, q, k, v, kp, cp, out, w, b, sk, hq, hkv,       \
                          window, splits, chunk, scale, s)
  if (dtype == 0 && rows == 2) return REPRO_DEC(float, 2);
  if (dtype == 0 && rows == 8) return REPRO_DEC(float, 8);
  if (dtype == 1 && rows == 2) return REPRO_DEC(__nv_bfloat16, 2);
  if (dtype == 1 && rows == 8) return REPRO_DEC(__nv_bfloat16, 8);
#undef REPRO_DEC
  return static_cast<int>(cudaErrorInvalidValue);
}
