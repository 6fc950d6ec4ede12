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
// It is bound by memory as the forward is: x and dy read once, dx written
// once.  Two launches.  `rmsnorm_bwd_rows_kernel` (tpr <= 512, every
// training shape): a block per chunk of BWD_CHUNK rows of one group, a
// step of 256 / tpr, 512 / tpr or 1024 / tpr of its rows at a time on the
// forward's plan (more where the chunks are fewer than the SMs can hold);
// each step's rows arrive by TMA bulk copies into a shared ring BWD_AHEAD
// steps ahead (where a chunk takes 4 steps or more), or by direct loads;
// from the registers they are read into come r, dx and each element's
// dy * (x * r), which go through a shared stage so that each thread adds
// its columns row by row.  Rows wider than 512 threads' registers take
// `rmsnorm_bwd_walk_kernel`, a row at a time.  Then
// `rmsnorm_bwd_sum_kernel` (a programmatic dependent launch) adds each
// group's chunk sums in chunk order, SUM_COLS columns a block.  Nothing
// atomic, so repeated calls are bitwise equal, and dx and dscale are
// those of the three-pass form it replaces (a dx pass, a partial-sum pass
// that read x and dy a second time, a one-thread-a-column reduction):
// every sum keeps its order, and dx's one fusable product is fused as
// that form's compiled code fused it.  A group's chunk sums are a chain
// no block can split; they get a launch of their own so that a group of
// many chunks (qwen3's q-norm: 1024) is fed by a whole block's loads.
// What bounds the rows' kernel on the H100 (PERF.md): at `train_lm`'s
// round shape 512 chunks of 64 rows, each a chain of 16 steps, and
// their dx stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"

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
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // two elements a conversion (each rounded to nearest, as one at a time)
    uint4 r;
    uint32_t* w = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = r;
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

constexpr int BWD_CHUNK = 64;     // rows a block covers, all of one group
constexpr int BWD_THREADS = 512;  // a block's threads (chunks < 2 an SM)
constexpr int BWD_AHEAD = 3;      // steps of rows the ring holds (RING)
constexpr int BWD_SMEM = 200 * 1024;  // bytes of a block's shared memory
constexpr int SMS = 132;          // the H100's SMs
constexpr int SUM_COLS = 32;      // columns a sum block owns
constexpr int SUM_ROWS = 256;     // chunks a sum block stages at a time
constexpr int SUM_THREADS = 256;

// A row's two sums, the forward's order: within the row's lanes of a
// warp, then (tpr > 32) across its warps through `red` in warp order,
// the row's warps meeting at a barrier of their own (1 + the row's place
// in the block) where the block holds at most 15 rows, else the block's.
// `red` is [2 (ss, sg)][warps]; the caller alternates two of them, so one
// barrier a row suffices.
__device__ __forceinline__ void row_sums(float& ss, float& sg, float* red,
                                         int tpr) {
  for (int o = (tpr < 32 ? tpr : 32) / 2; o > 0; o >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
    sg += __shfl_xor_sync(0xffffffffu, sg, o);
  }
  if (tpr > 32) {  // uniform over the block
    const int warps = blockDim.x / 32, first = threadIdx.x / tpr * (tpr / 32);
    if (threadIdx.x % 32 == 0) {
      red[threadIdx.x / 32] = ss;
      red[warps + threadIdx.x / 32] = sg;
    }
    if (blockDim.x / tpr < 16)  // uniform: a barrier id 1..15 a row
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + threadIdx.x / tpr),
                   "r"(tpr)
                   : "memory");
    else
      __syncthreads();
    ss = 0.f;
    sg = 0.f;
    for (int w = 0; w < tpr / 32; ++w) {
      ss += red[first + w];
      sg += red[warps + first + w];
    }
  }
}

// A block per chunk q = g * cpg + k: rows [g * group_rows + k * BWD_CHUNK,
// ...) of group g, at most BWD_CHUNK of them, THREADS / tpr rows at a
// step on the forward's plan (tpr <= BWD_THREADS, nv <= 2).  x and dy
// are read once: with RING, thread 0 sends each step's rows (contiguous in
// the chunk) by two bulk copies into a ring slot BWD_AHEAD steps ahead,
// completing on the slot's mbarrier; else each thread loads its own.
// Each row's sums are reduced as the forward reduces its own, dx is
// written, and the rows' dy * (x * r) go to a shared stage (two,
// alternating), from which each thread adds its columns' sums row by row
// (`acc`, in shared memory), so a column's chunk sum runs in row order.
// At most 64 registers a thread (1024 threads an SM); offsets inside the
// chunk are 32-bit (at most 64 rows of at most 8192 elements).
template <typename T, int VEC, int NV, bool RING, int THREADS>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
rmsnorm_bwd_rows_kernel(const T* __restrict__ x,
                        const float* __restrict__ scale_all,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ part, int d, int64_t group_rows,
                        int64_t cpg, float eps, int tpr) {
  extern __shared__ __align__(16) float smem[];  // acc [d], stage [2][R][d]
  __shared__ float red[2][2 * THREADS / 32];
  const int at_once = THREADS / tpr;
  const int t = threadIdx.x % tpr, rho = threadIdx.x / tpr;
  const int64_t q = blockIdx.x, g = q / cpg;
  const int64_t r0 = g * group_rows + (q % cpg) * BWD_CHUNK;
  const int64_t g_end = (g + 1) * group_rows;
  const int n = static_cast<int>(
      (r0 + BWD_CHUNK < g_end ? r0 + BWD_CHUNK : g_end) - r0);
  const int nvec = d / VEC;
  const T* xc = x + r0 * d;  // the chunk's rows
  const T* gc = dy + r0 * d;
  T* dc = dx + r0 * d;
  const float* scale = scale_all + g * d;
  const float fd = static_cast<float>(d);
  float* acc = smem;  // then stage [2][R][d] fp32, ring [AHEAD][2][R][d] T
  float* stage = smem + ((d + 3) & ~3);
  T* ring = reinterpret_cast<T*>(stage + 2 * at_once * d);
  const int slot = at_once * 2 * d;  // T elements a ring step: x, then dy
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + BWD_AHEAD * slot);
  for (int col = threadIdx.x; col < d; col += blockDim.x) acc[col] = 0.f;
  // the step's rows from `first` (contiguous in the chunk) into their ring
  // slot: one bulk copy of x's and one of dy's, completing on the slot's
  // mbarrier (thread 0; nothing past the chunk)
  auto copy_step = [&](int first) {
    if (first >= n) return;
    const int rows = n - first < at_once ? n - first : at_once;
    const uint32_t bytes = static_cast<uint32_t>(rows * d * sizeof(T));
    const int sl = first / at_once % BWD_AHEAD;
    const uint32_t bar = hopper::smem_u32(bars + sl);
    T* dst = ring + sl * slot;
    hopper::mbar_expect(bar, 2 * bytes);
    hopper::bulk_copy(hopper::smem_u32(dst), xc + first * d, bytes, bar);
    hopper::bulk_copy(hopper::smem_u32(dst + at_once * d), gc + first * d,
                      bytes, bar);
  };
  if constexpr (RING) {
    if (threadIdx.x == 0) {
      for (int a = 0; a < BWD_AHEAD; ++a)
        hopper::mbar_init(hopper::smem_u32(bars + a), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int a = 0; a < BWD_AHEAD; ++a) copy_step(a * at_once);
    }
    __syncthreads();  // the barriers are initialised
  }

  for (int base = 0; base < n; base += 2 * at_once) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {  // rows base + b * at_once .., stage b
      const int first = base + b * at_once;
      if (first >= n) break;  // uniform
      const int i = first + rho;
      const bool live = i < n;
      const int off = (live ? i : 0) * d;
      const T* xs = xc + off;
      const T* gs = gc + off;
      if constexpr (RING) {
        const int step = first / at_once;
        hopper::mbar_wait(hopper::smem_u32(bars + step % BWD_AHEAD),
                          (step / BWD_AHEAD) & 1);  // the step landed
        xs = ring + step % BWD_AHEAD * slot + rho * d;
        gs = xs + at_once * d;
      }
      // x and dy as read (zeros past the row); (dy * scale) rounded once,
      // as the forward's order takes it
      float ss = 0.f, sg = 0.f;
      float xv[NV][VEC], gv[NV][VEC], sc[VEC];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int j = t + v * tpr;
        if (live && j < nvec) {
          load_vec<T, VEC>(xs + j * VEC, xv[v]);
          load_vec<T, VEC>(gs + j * VEC, gv[v]);
          load_scale<VEC>(scale + j * VEC, sc);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) xv[v][e] = gv[v][e] = sc[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ss = fmaf(xv[v][e], xv[v][e], ss);
          sg = fmaf(__fmul_rn(gv[v][e], sc[e]), xv[v][e], sg);
        }
      }
      row_sums(ss, sg, red[b], tpr);
      const float inv = 1.f / sqrtf(ss / fd + eps);
      const float c = inv * inv * inv * (sg / fd);
      float* st = stage + (b * at_once + rho) * d;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int j = t + v * tpr;
        if (j < nvec) {
          float y[VEC];
          if (live) {
            load_scale<VEC>(scale + j * VEC, sc);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              y[e] = __fmaf_rn(inv, __fmul_rn(gv[v][e], sc[e]),
                               -__fmul_rn(xv[v][e], c));
            store_vec<T, VEC>(dc + off + j * VEC, y);
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            y[e] = __fmul_rn(gv[v][e], __fmul_rn(xv[v][e], inv));
#pragma unroll
          for (int e = 0; e < VEC; e += (VEC >= 4 ? 4 : 1)) {
            if constexpr (VEC >= 4)
              *reinterpret_cast<float4*>(st + j * VEC + e) =
                  make_float4(y[e], y[e + 1], y[e + 2], y[e + 3]);
            else
              st[j * VEC + e] = y[e];
          }
        }
      }
      __syncthreads();  // the step's rows are staged (and read from the ring)
      if constexpr (RING) {
        if (threadIdx.x == 0) {  // the slot the step read: the step AHEAD on
          hopper::fence_proxy_async();
          copy_step(first + BWD_AHEAD * at_once);
        }
      }
      const int rows_in = n - first < at_once ? n - first : at_once;
      const float* sb = stage + b * at_once * d;
      for (int col = threadIdx.x; col < d; col += blockDim.x) {
        float a = acc[col];
        for (int rr = 0; rr < rows_in; ++rr)
          a = __fadd_rn(a, sb[rr * d + col]);
        acc[col] = a;
      }
    }
  }
  // the sums' launch may start (it waits for this grid's end to read)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  float* qpart = part + q * d;
  for (int col = threadIdx.x; col < d; col += blockDim.x)
    qpart[col] = acc[col];
}

// The same for the widest rows (tpr 1024: one row at a time, the block
// its 1024 threads), each thread adding its own columns' products row by
// row.  NV = 0 (a row past the registers of 1024 threads): the second
// pass reads the row again and the sums accumulate in `part`.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(1024)
rmsnorm_bwd_walk_kernel(const T* __restrict__ x,
                        const float* __restrict__ scale_all,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ part, int64_t d,
                        int64_t group_rows, int64_t cpg, float eps, int tpr) {
  constexpr int NVV = NV > 0 ? NV : 1;
  __shared__ float red[2][2 * 1024 / 32];
  const int t = threadIdx.x;
  const int64_t q = blockIdx.x, g = q / cpg;
  const int64_t r0 = g * group_rows + (q % cpg) * BWD_CHUNK;
  const int64_t g_end = (g + 1) * group_rows;
  const int64_t n = (r0 + BWD_CHUNK < g_end ? r0 + BWD_CHUNK : g_end) - r0;
  const int64_t nvec = d / VEC;
  const float* scale = scale_all + g * d;
  float* qpart = part + q * d;
  const float fd = static_cast<float>(d);
  float acc[NVV][VEC];
#pragma unroll
  for (int v = 0; v < NVV; ++v)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[v][e] = 0.f;

  for (int64_t i = 0; i < n; ++i) {
    const int64_t off = (r0 + i) * d;
    float ss = 0.f, sg = 0.f, xv[NVV][VEC], gv[NVV][VEC], sc[VEC], y[VEC];
    if constexpr (NV == 0) {
      for (int64_t j = t; j < nvec; j += tpr) {
        load_vec<T, VEC>(x + off + j * VEC, xv[0]);
        load_vec<T, VEC>(dy + off + j * VEC, gv[0]);
        load_scale<VEC>(scale + j * VEC, sc);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ss = fmaf(xv[0][e], xv[0][e], ss);
          sg = fmaf(__fmul_rn(gv[0][e], sc[e]), xv[0][e], sg);
        }
      }
    } else {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int64_t j = t + static_cast<int64_t>(v) * tpr;
        if (j < nvec) {
          load_vec<T, VEC>(x + off + j * VEC, xv[v]);
          load_vec<T, VEC>(dy + off + j * VEC, gv[v]);
          load_scale<VEC>(scale + j * VEC, sc);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) xv[v][e] = gv[v][e] = sc[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ss = fmaf(xv[v][e], xv[v][e], ss);
          sg = fmaf(__fmul_rn(gv[v][e], sc[e]), xv[v][e], sg);
        }
      }
    }
    row_sums(ss, sg, red[i & 1], tpr);
    const float inv = 1.f / sqrtf(ss / fd + eps);
    const float c = inv * inv * inv * (sg / fd);
    if constexpr (NV == 0) {
      for (int64_t j = t; j < nvec; j += tpr) {
        load_vec<T, VEC>(x + off + j * VEC, xv[0]);
        load_vec<T, VEC>(dy + off + j * VEC, gv[0]);
        load_scale<VEC>(scale + j * VEC, sc);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          y[e] = __fmaf_rn(inv, __fmul_rn(gv[0][e], sc[e]),
                           -__fmul_rn(xv[0][e], c));
        store_vec<T, VEC>(dx + off + j * VEC, y);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float pv = __fmul_rn(gv[0][e], __fmul_rn(xv[0][e], inv));
          const float prev = i == 0 ? 0.f : qpart[j * VEC + e];
          qpart[j * VEC + e] = __fadd_rn(prev, pv);
        }
      }
    } else {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int64_t j = t + static_cast<int64_t>(v) * tpr;
        if (j < nvec) {
          load_scale<VEC>(scale + j * VEC, sc);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            y[e] = __fmaf_rn(inv, __fmul_rn(gv[v][e], sc[e]),
                             -__fmul_rn(xv[v][e], c));
          store_vec<T, VEC>(dx + off + j * VEC, y);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[v][e] = __fadd_rn(
                acc[v][e], __fmul_rn(gv[v][e], __fmul_rn(xv[v][e], inv)));
        }
      }
    }
  }
  if constexpr (NV > 0) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int64_t j = t + static_cast<int64_t>(v) * tpr;
      if (j < nvec)
#pragma unroll
        for (int e = 0; e < VEC; ++e) qpart[j * VEC + e] = acc[v][e];
    }
  }
}

// dscale[g, c] = group g's chunk sums of column c added in chunk order.  A
// block per (SUM_COLS columns, group): its threads stage SUM_ROWS chunks'
// sums of those columns in shared memory, then the first SUM_COLS threads
// add them, a column each.
__global__ void __launch_bounds__(SUM_THREADS)
rmsnorm_bwd_sum_kernel(const float* __restrict__ part,
                       float* __restrict__ dscale, int64_t d, int64_t cpg) {
  // launched while the rows' grid ends (programmatic dependent launch):
  // wait until it has finished and its writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ float slab[SUM_ROWS][SUM_COLS + 1];
  const int64_t g = blockIdx.y, c0 = static_cast<int64_t>(blockIdx.x) *
                                         SUM_COLS;
  const float* gpart = part + g * cpg * d;
  const int cl = threadIdx.x % SUM_COLS, rl = threadIdx.x / SUM_COLS;
  constexpr int LANES = SUM_THREADS / SUM_COLS;
  float v[SUM_ROWS / LANES];
  // the slab of chunks [k0, k0 + SUM_ROWS) into registers
  auto load = [&](int64_t k0) {
#pragma unroll
    for (int u = 0; u < SUM_ROWS / LANES; ++u) {
      const int64_t k = k0 + rl + static_cast<int64_t>(u) * LANES;
      v[u] = k < cpg && c0 + cl < d ? gpart[k * d + c0 + cl] : 0.f;
    }
  };
  float s = 0.f;
  load(0);
  for (int64_t k0 = 0; k0 < cpg; k0 += SUM_ROWS) {
    __syncthreads();  // the previous slab is added
#pragma unroll
    for (int u = 0; u < SUM_ROWS / LANES; ++u)
      slab[rl + u * LANES][cl] = v[u];
    __syncthreads();
    if (k0 + SUM_ROWS < cpg) load(k0 + SUM_ROWS);  // lands while we add
    const int64_t rows = cpg - k0 < SUM_ROWS ? cpg - k0 : SUM_ROWS;
    if (threadIdx.x < SUM_COLS)
      for (int64_t k = 0; k < rows; ++k) s += slab[k][threadIdx.x];
  }
  if (threadIdx.x < SUM_COLS && c0 + threadIdx.x < d)
    dscale[g * d + c0 + threadIdx.x] = s;
}

// the backward's kernel launches so far (each launch's error checked right
// after it, and counted when there is none): the tests and checks read
// how many one call makes
std::atomic<int64_t> bwd_launched{0};

cudaError_t counted(cudaError_t e) {
  if (e == cudaSuccess) ++bwd_launched;
  return e;
}

template <typename T, int VEC>
int launch_bwd_nv(const void* x, const void* scale, const void* dy, void* dx,
                  float* part, int64_t chunks, int64_t d, int64_t gr,
                  int64_t cpg, float eps, int tpr, int nv, cudaStream_t s) {
  if (chunks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(chunks));
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  const T* gp = static_cast<const T*>(dy);
  T* op = static_cast<T*>(dx);
  if (tpr <= BWD_THREADS && (nv == 1 || nv == 2)) {
    // the rows a block holds at a step, from how many blocks the chunks
    // give each SM: fewer chunks than SMs, 1024 threads; fewer than two
    // an SM, 512; else 256, four an SM; at least two rows a step
    int threads = chunks < SMS       ? 2 * BWD_THREADS
                  : chunks < 2 * SMS ? BWD_THREADS
                                     : BWD_THREADS / 2;
    if (threads < 2 * tpr) threads = 2 * tpr;
    const int64_t rows = threads / tpr;
    // the ring where a chunk takes 4 steps or more (16-byte vectors)
    const bool ring =
        threads <= BWD_THREADS && VEC > 1 && rows <= BWD_CHUNK / 4;
    const int64_t bytes =
        (((d + 3) & ~static_cast<int64_t>(3)) + 2 * rows * d) * 4 +
        (ring ? BWD_AHEAD * (rows * 2 * d * sizeof(T)) + 8 * BWD_AHEAD : 0);
    if (bytes > BWD_SMEM) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = static_cast<int>(bytes);
    const int di = static_cast<int>(d);  // <= 8192 here (the stages fit)
#define REPRO_RMS_ROWS(NV, RING, THREADS)                                    \
  {                                                                          \
    static bool smem_set = false; /* the attribute holds */                  \
    if (!smem_set) {                                                         \
      const cudaError_t e = cudaFuncSetAttribute(                            \
          rmsnorm_bwd_rows_kernel<T, VEC, NV, RING, THREADS>,                \
          cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);            \
      if (e != cudaSuccess) return static_cast<int>(e);                      \
      smem_set = true;                                                       \
    }                                                                        \
    rmsnorm_bwd_rows_kernel<T, VEC, NV, RING, THREADS>                       \
        <<<grid, THREADS, smem, s>>>(xp, sp, gp, op, part, di, gr, cpg, eps,  \
                                     tpr);                                   \
  }
#define REPRO_RMS_ROWS_NV(RING, THREADS)                                     \
  if (nv == 1) REPRO_RMS_ROWS(1, RING, THREADS)                              \
  else REPRO_RMS_ROWS(2, RING, THREADS)
    if (threads == 2 * BWD_THREADS) {
      REPRO_RMS_ROWS_NV(false, 2 * BWD_THREADS)
    } else if (ring) {
      if constexpr (VEC > 1) {
        if (threads == BWD_THREADS) {
          REPRO_RMS_ROWS_NV(true, BWD_THREADS)
        } else {
          REPRO_RMS_ROWS_NV(true, BWD_THREADS / 2)
        }
      }
    } else if (threads == BWD_THREADS) {
      REPRO_RMS_ROWS_NV(false, BWD_THREADS)
    } else {
      REPRO_RMS_ROWS_NV(false, BWD_THREADS / 2)
    }
#undef REPRO_RMS_ROWS_NV
#undef REPRO_RMS_ROWS
    return static_cast<int>(counted(cudaGetLastError()));
  }
  // the widest rows: a block of 1024 threads walks its chunk's rows
  if (tpr != 2 * BWD_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  switch (nv) {
#define REPRO_RMS_BWD(NV)                                                    \
  case NV:                                                                   \
    rmsnorm_bwd_walk_kernel<T, VEC, NV><<<grid, tpr, 0, s>>>(                \
        xp, sp, gp, op, part, d, gr, cpg, eps, tpr);                         \
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
  return static_cast<int>(counted(cudaGetLastError()));
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
               void* dscale, float* part, int64_t rows, int64_t d, int64_t gr,
               float eps, int vec, int tpr, int nv, cudaStream_t s) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int64_t cpg = (gr + BWD_CHUNK - 1) / BWD_CHUNK;
  const int64_t groups = rows / gr, chunks = groups * cpg;
  const int64_t col_blocks = (d + SUM_COLS - 1) / SUM_COLS;
  if (groups > 65535 || col_blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  int err;
  if (vec == V && d % V == 0)
    err = launch_bwd_nv<T, V>(x, scale, dy, dx, part, chunks, d, gr, cpg, eps,
                              tpr, nv, s);
  else if (vec == 1)
    err = launch_bwd_nv<T, 1>(x, scale, dy, dx, part, chunks, d, gr, cpg, eps,
                              tpr, nv, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  // the sums, as a programmatic dependent launch: set up while the rows'
  // grid ends, run once it has
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(col_blocks),
                     static_cast<unsigned>(groups));
  cfg.blockDim = dim3(SUM_THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(counted(cudaLaunchKernelEx(
      &cfg, rmsnorm_bwd_sum_kernel, static_cast<const float*>(part),
      static_cast<float*>(dscale), d, cpg)));
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
// [rows / group_rows, d]; dscale fp32 [rows / group_rows, d]; part fp32 of
// (rows / group_rows) * ceil(group_rows / 64) * d floats (the chunks'
// column sums).  `plan` as the forward's (its rows a block unused).  Two
// launches on `stream` (the rows, then the chunk sums' sum), no
// synchronisation; returns the first error.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale,
                                 const void* dy, void* dx, void* dscale,
                                 void* part, int64_t rows, int64_t d,
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
  float* pp = static_cast<float*>(part);
  if (dtype == 0)
    return launch_bwd<float>(x, scale, dy, dx, dscale, pp, rows, d,
                             group_rows, eps, vec, tpr, nv, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, scale, dy, dx, dscale, pp, rows, d,
                                     group_rows, eps, vec, tpr, nv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the kernel launches made so far by repro_rmsnorm_bwd in this process
extern "C" int64_t repro_rmsnorm_bwd_launches() { return bwd_launched; }
