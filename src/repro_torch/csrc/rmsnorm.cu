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
//
// Design (a simple, correct first kernel):
// - one warp per row, 8 rows per 256-thread block, so a row needs no
//   shared memory and no block barrier;
// - each lane walks its row at a stride of 32 elements (neighbouring lanes
//   on neighbouring addresses), with a masked tail for any d;
// - the sum of squares is taken in fp32 and reduced with xor shuffles, so
//   every lane holds it;
// - the second pass re-reads the row (an L1/L2 hit at these sizes) and
//   writes x * rsqrt(var + eps), times the fp32 scale, cast last: the
//   reference's order.
// x is fp32 or bf16; scale is fp32; out has x's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int64_t rows, int64_t d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.f;
  for (int64_t i = lane; i < d; i += 32) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  // 1/sqrt, both correctly rounded (rsqrtf is within 2 ulp)
  const float inv = 1.f / sqrtf(ss / static_cast<float>(d) + eps);
  for (int64_t i = lane; i < d; i += 32)
    store(orow + i, to_f32(xr[i]) * inv * scale[i]);
}

}  // namespace

// x, out: contiguous [rows, d]; scale: [d] fp32.  dtype 0 = fp32, 1 = bf16.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out,
                             int64_t rows, int64_t d, float eps, int dtype,
                             void* stream) {
  if (rows == 0 || d == 0) return 0;
  const int64_t blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (dtype == 0) {
    rmsnorm_kernel<float><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(out), rows, d, eps);
  } else if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), rows, d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
