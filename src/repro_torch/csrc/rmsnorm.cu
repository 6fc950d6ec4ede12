// Fused RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the TPU kernel `_kernel` / `rmsnorm` of
// src/repro/kernels/rmsnorm.py (one HBM read, fp32 accumulation in VMEM),
// which every norm of the token models computes: the attention/FFN
// pre-norms, the per-head q/k norms of qwen3, the xLSTM block norms and
// the final norm.
//
// What bounds it on the card: memory.  Each row is read once from device
// memory and written once, 2 * rows * d * itemsize bytes plus the scale;
// the work is a handful of flops per element, far below the H100's ridge.
// At the serving shapes a call moves a few MB or less, so a call is short
// and the host's launch path is as long as the kernel (the wrapper keeps
// it lean).
//
// Design:
// - a row is read once: each thread loads its part into registers (NV
//   vectors), the sum of squares is taken in fp32, and the same registers
//   are scaled and written.  Rows too wide for the registers of 1024
//   threads (NV = 0) loop and read the row a second time;
// - loads and stores are 16-byte vectors (VEC elements) where d * itemsize
//   is a multiple of 16 and x, scale and out are 16-byte aligned, neighbour
//   threads on neighbour vectors; otherwise single elements (VEC = 1);
// - the wrapper's plan sets the threads per row (tpr, a power of two up
//   to 1024) and the rows per block from the row count and d: two vectors
//   a thread where rows are thousands (prefill's 4096 rows of 2048: 4
//   warps a row; the qk-norms' 65536 rows of 128: 8 threads a row, 4 rows
//   a warp), one vector a thread where rows are few (decode's 8 rows of
//   2048: 8 blocks of 256 threads), so that they reach more SMs; a block
//   is one row or one warp of rows.  On the H100 this measured fastest of
//   the plans the entry point takes (repro_torch.rmsnorm_ablation; PERF.md);
//   a warp holding a row of 2048 in 8 vectors a thread took 1.8x as long;
// - a row's sum is reduced by xor shuffles within its lanes of a warp,
//   then across the row's warps through shared memory in a fixed order;
// - x * inv is taken first and then times the fp32 scale, cast last: the
//   reference's order.
// x is fp32 or bf16; scale is fp32; out has x's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC consecutive elements (one 16-byte vector, or one element) as fp32
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  if constexpr (VEC == 1) {
    f[0] = to_f32(*p);
  } else {
    static_assert(VEC * sizeof(T) == 16, "a vector is 16 bytes");
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_f32(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  if constexpr (VEC == 1) {
    *p = from_f32<T>(f[0]);
  } else {
    uint4 r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = r;
  }
}

template <int VEC>
__device__ __forceinline__ void load_scale(const float* p, float* f) {
  if constexpr (VEC == 1) {
    f[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 r = *reinterpret_cast<const float4*>(p + i);
      f[i] = r.x, f[i + 1] = r.y, f[i + 2] = r.z, f[i + 3] = r.w;
    }
  }
}

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(1024)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int64_t rows, int64_t d, float eps,
               int tpr) {
  __shared__ float red[32];
  const int t = threadIdx.x % tpr;  // this thread's place in its row
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / tpr) +
                      threadIdx.x / tpr;
  const bool live = row < rows;
  const int64_t nvec = d / VEC;
  const T* xr = x + (live ? row : 0) * d;

  float ss = 0.f;
  float xv[NV > 0 ? NV : 1][VEC];
  if constexpr (NV > 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int64_t j = t + static_cast<int64_t>(i) * tpr;
      if (live && j < nvec) {
        load_vec<T, VEC>(xr + j * VEC, xv[i]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) xv[i][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss = fmaf(xv[i][e], xv[i][e], ss);
    }
  } else if (live) {
    for (int64_t j = t; j < nvec; j += tpr) {
      load_vec<T, VEC>(xr + j * VEC, xv[0]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss = fmaf(xv[0][e], xv[0][e], ss);
    }
  }
  // xor partners stay inside the row's aligned group of min(tpr, 32) lanes
  for (int off = (tpr < 32 ? tpr : 32) / 2; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tpr > 32) {  // uniform over the block: every thread reaches the barrier
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = ss;
    __syncthreads();
    const int wpr = tpr / 32, first = (threadIdx.x / tpr) * wpr;
    ss = 0.f;
    for (int w = 0; w < wpr; ++w) ss += red[first + w];
  }
  if (!live) return;
  // 1/sqrt, both correctly rounded (rsqrtf is within 2 ulp)
  const float inv = 1.f / sqrtf(ss / static_cast<float>(d) + eps);

  T* orow = out + row * d;
  float sc[VEC], y[VEC];
  if constexpr (NV > 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int64_t j = t + static_cast<int64_t>(i) * tpr;
      if (j < nvec) {
        load_scale<VEC>(scale + j * VEC, sc);
#pragma unroll
        for (int e = 0; e < VEC; ++e) y[e] = xv[i][e] * inv * sc[e];
        store_vec<T, VEC>(orow + j * VEC, y);
      }
    }
  } else {
    for (int64_t j = t; j < nvec; j += tpr) {
      load_vec<T, VEC>(xr + j * VEC, xv[0]);
      load_scale<VEC>(scale + j * VEC, sc);
#pragma unroll
      for (int e = 0; e < VEC; ++e) y[e] = xv[0][e] * inv * sc[e];
      store_vec<T, VEC>(orow + j * VEC, y);
    }
  }
}

template <typename T, int VEC>
int launch_nv(const void* x, const void* scale, void* out, int64_t rows,
              int64_t d, float eps, int tpr, int nv, int rpb,
              cudaStream_t s) {
  const int64_t blocks = (rows + rpb - 1) / rpb;
  if (blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks));
  const int threads = tpr * rpb;
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  T* op = static_cast<T*>(out);
  switch (nv) {
    case 0:
      rmsnorm_kernel<T, VEC, 0><<<grid, threads, 0, s>>>(xp, sp, op, rows, d,
                                                         eps, tpr);
      break;
    case 1:
      rmsnorm_kernel<T, VEC, 1><<<grid, threads, 0, s>>>(xp, sp, op, rows, d,
                                                         eps, tpr);
      break;
    case 2:
      rmsnorm_kernel<T, VEC, 2><<<grid, threads, 0, s>>>(xp, sp, op, rows, d,
                                                         eps, tpr);
      break;
    case 4:
      rmsnorm_kernel<T, VEC, 4><<<grid, threads, 0, s>>>(xp, sp, op, rows, d,
                                                         eps, tpr);
      break;
    case 8:
      rmsnorm_kernel<T, VEC, 8><<<grid, threads, 0, s>>>(xp, sp, op, rows, d,
                                                         eps, tpr);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int64_t rows,
           int64_t d, float eps, int vec, int tpr, int nv, int rpb,
           cudaStream_t s) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if (vec == V && d % V == 0)
    return launch_nv<T, V>(x, scale, out, rows, d, eps, tpr, nv, rpb, s);
  if (vec == 1)
    return launch_nv<T, 1>(x, scale, out, rows, d, eps, tpr, nv, rpb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, out: contiguous [rows, d]; scale: [d] fp32.  `plan` packs the type
// and the wrapper's `rmsnorm_plan` into one int (fewer ctypes arguments):
// bits 0-1 the type (0 = fp32, 1 = bf16), 2-5 vec, the elements a load (1,
// or 16 bytes' worth where d and the three pointers allow it), 6-9 nv, the
// vectors a thread holds in registers (1, 2, 4, 8; 0 = loop and read
// twice), 10-20 tpr, the threads a row (a power of two, 1..1024), 21-31
// rpb, the rows a block (tpr * rpb a multiple of 32, at most 1024, so every
// warp is whole).  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out,
                             int64_t rows, int64_t d, float eps, int plan,
                             void* stream) {
  if (rows == 0 || d == 0) return 0;
  const int dtype = plan & 3, vec = (plan >> 2) & 15, nv = (plan >> 6) & 15;
  const int tpr = (plan >> 10) & 2047, rpb = (plan >> 21) & 2047;
  const bool tpr_ok = tpr >= 1 && tpr <= 1024 && (tpr & (tpr - 1)) == 0;
  if (!tpr_ok || rpb < 1 || tpr * rpb > 1024 || (tpr * rpb) % 32 != 0 ||
      (nv > 0 && static_cast<int64_t>(tpr) * nv * vec < d))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, scale, out, rows, d, eps, vec, tpr, nv, rpb, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, vec, tpr, nv,
                                 rpb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
