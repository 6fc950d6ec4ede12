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
//   reference's order;
// - the scale is [d], or [G, d] with the rows grouped contiguously by G
//   (row r takes scale row r / group_rows): the client-stacked training
//   forward gives each client its own norm scale.
// x is fp32 or bf16; scale is fp32; out has x's type.
//
// The backward (`repro_rmsnorm_bwd`, the training paths' gradient; the TPU
// kernel had none, the reference differentiates its jnp form) computes in
// fp32, with r = 1 / sqrt(mean(x^2) + eps) and gs = dy * scale:
//   dx = r * gs - x * r^3 * mean(gs * x)        (x's type)
//   dscale[g] = sum over group g's rows of dy * x * r   (fp32 [G, d])
// It is bound by memory as the forward is.  Three launches, no atomics, so
// repeated calls are bitwise equal: (1) `rmsnorm_bwd_dx_kernel`, a row per
// `tpr` threads on the forward's plan, reads x and dy once (registers),
// writes dx and r [rows]; (2) `rmsnorm_bwd_partial_kernel`, a thread per
// column over a chunk of BWD_CHUNK rows of one group, writes the chunk's
// partial sums of dy * x * r (it reads x and dy a second time: a simple
// right kernel first); (3) `rmsnorm_bwd_reduce_kernel` sums each group's
// partials in chunk order.

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
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale_all,
               T* __restrict__ out, int64_t rows, int64_t d,
               int64_t group_rows, float eps, int tpr) {
  __shared__ float red[32];
  const int t = threadIdx.x % tpr;  // this thread's place in its row
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / tpr) +
                      threadIdx.x / tpr;
  const bool live = row < rows;
  const int64_t nvec = d / VEC;
  const T* xr = x + (live ? row : 0) * d;
  const float* scale = scale_all + (live ? row / group_rows : 0) * d;

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
              int64_t d, int64_t gr, float eps, int tpr, int nv, int rpb,
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
                                                         gr, eps, tpr);
      break;
    case 1:
      rmsnorm_kernel<T, VEC, 1><<<grid, threads, 0, s>>>(xp, sp, op, rows, d,
                                                         gr, eps, tpr);
      break;
    case 2:
      rmsnorm_kernel<T, VEC, 2><<<grid, threads, 0, s>>>(xp, sp, op, rows, d,
                                                         gr, eps, tpr);
      break;
    case 4:
      rmsnorm_kernel<T, VEC, 4><<<grid, threads, 0, s>>>(xp, sp, op, rows, d,
                                                         gr, eps, tpr);
      break;
    case 8:
      rmsnorm_kernel<T, VEC, 8><<<grid, threads, 0, s>>>(xp, sp, op, rows, d,
                                                         gr, eps, tpr);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int64_t rows,
           int64_t d, int64_t gr, float eps, int vec, int tpr, int nv,
           int rpb, cudaStream_t s) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if (vec == V && d % V == 0)
    return launch_nv<T, V>(x, scale, out, rows, d, gr, eps, tpr, nv, rpb, s);
  if (vec == 1)
    return launch_nv<T, 1>(x, scale, out, rows, d, gr, eps, tpr, nv, rpb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------------

constexpr int BWD_CHUNK = 64;     // rows a partial-sum block covers
constexpr int BWD_COLS = 256;     // columns (threads) a partial-sum block

// dx of one row per `tpr` threads (the forward's plan), and r = 1 / sqrt(
// mean(x^2) + eps) per row for the dscale pass
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(1024)
rmsnorm_bwd_dx_kernel(const T* __restrict__ x,
                      const float* __restrict__ scale_all,
                      const T* __restrict__ dy, T* __restrict__ dx,
                      float* __restrict__ rinv, int64_t rows, int64_t d,
                      int64_t group_rows, float eps, int tpr) {
  __shared__ float red[2][32];
  const int t = threadIdx.x % tpr;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / tpr) +
                      threadIdx.x / tpr;
  const bool live = row < rows;
  const int64_t nvec = d / VEC;
  const int64_t base = (live ? row : 0) * d;
  const float* scale = scale_all + (live ? row / group_rows : 0) * d;

  // ss = sum x^2, sg = sum (dy * scale) * x, both fp32
  float ss = 0.f, sg = 0.f;
  float xv[NV > 0 ? NV : 1][VEC], gv[NV > 0 ? NV : 1][VEC];
  float sc[VEC];
  if constexpr (NV > 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int64_t j = t + static_cast<int64_t>(i) * tpr;
      if (live && j < nvec) {
        load_vec<T, VEC>(x + base + j * VEC, xv[i]);
        load_vec<T, VEC>(dy + base + j * VEC, gv[i]);
        load_scale<VEC>(scale + j * VEC, sc);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) xv[i][e] = gv[i][e] = sc[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        gv[i][e] *= sc[e];
        ss = fmaf(xv[i][e], xv[i][e], ss);
        sg = fmaf(gv[i][e], xv[i][e], sg);
      }
    }
  } else if (live) {
    for (int64_t j = t; j < nvec; j += tpr) {
      load_vec<T, VEC>(x + base + j * VEC, xv[0]);
      load_vec<T, VEC>(dy + base + j * VEC, gv[0]);
      load_scale<VEC>(scale + j * VEC, sc);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ss = fmaf(xv[0][e], xv[0][e], ss);
        sg = fmaf(gv[0][e] * sc[e], xv[0][e], sg);
      }
    }
  }
  for (int off = (tpr < 32 ? tpr : 32) / 2; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
    sg += __shfl_xor_sync(0xffffffffu, sg, off);
  }
  if (tpr > 32) {
    if (threadIdx.x % 32 == 0) {
      red[0][threadIdx.x / 32] = ss;
      red[1][threadIdx.x / 32] = sg;
    }
    __syncthreads();
    const int wpr = tpr / 32, first = (threadIdx.x / tpr) * wpr;
    ss = 0.f;
    sg = 0.f;
    for (int w = 0; w < wpr; ++w) {
      ss += red[0][first + w];
      sg += red[1][first + w];
    }
  }
  if (!live) return;
  const float fd = static_cast<float>(d);
  const float inv = 1.f / sqrtf(ss / fd + eps);
  const float c = inv * inv * inv * (sg / fd);
  if (t == 0) rinv[row] = inv;
  float y[VEC];
  if constexpr (NV > 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int64_t j = t + static_cast<int64_t>(i) * tpr;
      if (j < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          y[e] = inv * gv[i][e] - xv[i][e] * c;
        store_vec<T, VEC>(dx + base + j * VEC, y);
      }
    }
  } else {
    for (int64_t j = t; j < nvec; j += tpr) {
      load_vec<T, VEC>(x + base + j * VEC, xv[0]);
      load_vec<T, VEC>(dy + base + j * VEC, gv[0]);
      load_scale<VEC>(scale + j * VEC, sc);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        y[e] = inv * (gv[0][e] * sc[e]) - xv[0][e] * c;
      store_vec<T, VEC>(dx + base + j * VEC, y);
    }
  }
}

// grid (chunks, column blocks): chunk q = g * cpg + k covers rows
// [g * group_rows + k * BWD_CHUNK, ...) of group g; one thread a column
template <typename T>
__global__ void __launch_bounds__(BWD_COLS)
rmsnorm_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                           const float* __restrict__ rinv,
                           float* __restrict__ part, int64_t d,
                           int64_t group_rows, int64_t cpg) {
  const int64_t col = static_cast<int64_t>(blockIdx.y) * BWD_COLS +
                      threadIdx.x;
  if (col >= d) return;
  const int64_t q = blockIdx.x, g = q / cpg, k = q % cpg;
  const int64_t r0 = g * group_rows + k * BWD_CHUNK;
  const int64_t end = (g + 1) * group_rows;
  const int64_t r1 = r0 + BWD_CHUNK < end ? r0 + BWD_CHUNK : end;
  float acc = 0.f;
  for (int64_t r = r0; r < r1; ++r) {
    const float n = __fmul_rn(to_f32(x[r * d + col]), rinv[r]);
    acc = __fadd_rn(acc, __fmul_rn(to_f32(dy[r * d + col]), n));
  }
  part[q * d + col] = acc;
}

// dscale[g, c] = the group's partials summed in chunk order
__global__ void __launch_bounds__(256)
rmsnorm_bwd_reduce_kernel(const float* __restrict__ part,
                          float* __restrict__ dscale, int64_t d, int64_t cpg,
                          int64_t n) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= n) return;
  const int64_t g = e / d, c = e % d;
  float acc = 0.f;
  for (int64_t k = 0; k < cpg; ++k) acc += part[(g * cpg + k) * d + c];
  dscale[e] = acc;
}

template <typename T, int VEC>
int launch_bwd_dx(const void* x, const void* scale, const void* dy, void* dx,
                  float* rinv, int64_t rows, int64_t d, int64_t gr, float eps,
                  int tpr, int nv, int rpb, cudaStream_t s) {
  const int64_t blocks = (rows + rpb - 1) / rpb;
  if (blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks));
  const int threads = tpr * rpb;
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  const T* gp = static_cast<const T*>(dy);
  T* op = static_cast<T*>(dx);
  switch (nv) {
#define REPRO_RMS_BWD(NV)                                                    \
  case NV:                                                                   \
    rmsnorm_bwd_dx_kernel<T, VEC, NV><<<grid, threads, 0, s>>>(              \
        xp, sp, gp, op, rinv, rows, d, gr, eps, tpr);                        \
    break;
    REPRO_RMS_BWD(0)
    REPRO_RMS_BWD(1)
    REPRO_RMS_BWD(2)
    REPRO_RMS_BWD(4)
    REPRO_RMS_BWD(8)
#undef REPRO_RMS_BWD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
               void* dscale, float* ws, int64_t rows, int64_t d, int64_t gr,
               float eps, int vec, int tpr, int nv, int rpb, cudaStream_t s) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  float* rinv = ws;
  int err;
  if (vec == V && d % V == 0)
    err = launch_bwd_dx<T, V>(x, scale, dy, dx, rinv, rows, d, gr, eps, tpr,
                              nv, rpb, s);
  else if (vec == 1)
    err = launch_bwd_dx<T, 1>(x, scale, dy, dx, rinv, rows, d, gr, eps, tpr,
                              nv, rpb, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  const int64_t groups = rows / gr, cpg = (gr + BWD_CHUNK - 1) / BWD_CHUNK;
  const int64_t chunks = groups * cpg, cblocks = (d + BWD_COLS - 1) / BWD_COLS;
  if (chunks > 2147483647LL || cblocks > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  float* part = ws + rows;
  rmsnorm_bwd_partial_kernel<T>
      <<<dim3(static_cast<unsigned>(chunks), static_cast<unsigned>(cblocks)),
         BWD_COLS, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(dy),
                           rinv, part, d, gr, cpg);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n = groups * d;
  rmsnorm_bwd_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                              s>>>(part, static_cast<float*>(dscale), d, cpg,
                                   n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: contiguous [rows, d]; scale: fp32 [rows / group_rows, d], row r
// taking scale row r / group_rows (group_rows = rows: one [d] scale).
// `plan` packs the type
// and the wrapper's `rmsnorm_plan` into one int (fewer ctypes arguments):
// bits 0-1 the type (0 = fp32, 1 = bf16), 2-5 vec, the elements a load (1,
// or 16 bytes' worth where d and the three pointers allow it), 6-9 nv, the
// vectors a thread holds in registers (1, 2, 4, 8; 0 = loop and read
// twice), 10-20 tpr, the threads a row (a power of two, 1..1024), 21-31
// rpb, the rows a block (tpr * rpb a multiple of 32, at most 1024, so every
// warp is whole).  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out,
                             int64_t rows, int64_t d, int64_t group_rows,
                             float eps, int plan, void* stream) {
  if (rows == 0 || d == 0) return 0;
  if (group_rows < 1 || rows % group_rows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dtype = plan & 3, vec = (plan >> 2) & 15, nv = (plan >> 6) & 15;
  const int tpr = (plan >> 10) & 2047, rpb = (plan >> 21) & 2047;
  const bool tpr_ok = tpr >= 1 && tpr <= 1024 && (tpr & (tpr - 1)) == 0;
  if (!tpr_ok || rpb < 1 || tpr * rpb > 1024 || (tpr * rpb) % 32 != 0 ||
      (nv > 0 && static_cast<int64_t>(tpr) * nv * vec < d))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, scale, out, rows, d, group_rows, eps, vec, tpr,
                         nv, rpb, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, out, rows, d, group_rows, eps, vec,
                                 tpr, nv, rpb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: x, dy, dx contiguous [rows, d] in x's type; scale fp32
// [rows / group_rows, d]; dscale fp32 [rows / group_rows, d]; ws fp32 of
// rows + (rows / group_rows) * ceil(group_rows / 64) * d floats.  `plan`
// as the forward's.  Three launches on `stream` (dx and r, partial sums,
// their reduction), no synchronisation; returns the first error.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale,
                                 const void* dy, void* dx, void* dscale,
                                 void* ws, int64_t rows, int64_t d,
                                 int64_t group_rows, float eps, int plan,
                                 void* stream) {
  if (rows == 0 || d == 0) return 0;
  if (group_rows < 1 || rows % group_rows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dtype = plan & 3, vec = (plan >> 2) & 15, nv = (plan >> 6) & 15;
  const int tpr = (plan >> 10) & 2047, rpb = (plan >> 21) & 2047;
  const bool tpr_ok = tpr >= 1 && tpr <= 1024 && (tpr & (tpr - 1)) == 0;
  if (!tpr_ok || rpb < 1 || tpr * rpb > 1024 || (tpr * rpb) % 32 != 0 ||
      (nv > 0 && static_cast<int64_t>(tpr) * nv * vec < d))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == 0)
    return launch_bwd<float>(x, scale, dy, dx, dscale, w, rows, d,
                             group_rows, eps, vec, tpr, nv, rpb, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, scale, dy, dx, dscale, w, rows, d,
                                     group_rows, eps, vec, tpr, nv, rpb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
