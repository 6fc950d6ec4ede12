// Fused clip + SGD + Eq. 4/7 mean-fold update of every parameter leaf of a
// HASFL round, in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_kernel` (the flat update) and `_kernel_ext`
// (the external-mean update of mesh mode) of src/repro/kernels/clip_sgd.py,
// both called from `clip_sgd_update`.  Per [N, D] leaf, with
// spec = p - gamma * (g * scale):
//   flat:      out = keep ? spec : (!any(keep) && cnt > 0 ? mean : p),
//              mean = sum_n(w_n * spec_n) / where(cnt > 0, cnt, 1),
//              cnt = sum_n(w_n)
//   external:  out = keep ? spec : (use ? c : p), c the precomputed mean
//
// What bounds it on the card: memory.  An element takes a few flops;
// reading p and g and writing p once is 12 * N * sum(D) bytes (plus
// 4 * sum(D) for the external mean rows): 0.44 ms for a VGG-16 round at
// N = 8 at 3.35 TB/s.  A round's small leaves (biases of 64-512) move
// almost nothing, so launching each leaf alone costs more host time than
// the device spends on all of them.
//
// Design:
// - one launch updates every leaf of a round: the leaves travel in a table
//   passed by value (a __grid_constant__ parameter of up to CAPACITY
//   leaves; a round with more takes more launches).  Each leaf's columns
//   are cut into chunks of one block each; a block finds its leaf by a
//   binary search over the table's first-chunk offsets;
// - no [N, block] tile is held (the TPU kernel kept it in VMEM so that the
//   client mean was an in-register sum).  By the select's structure the
//   mean is read only where no client keeps, and then every row receives
//   it.  So where some client keeps, and always for the external mean, a
//   column is elementwise; where none keeps, one pass over the rows sums
//   w_n * spec_n in registers and writes the mean to every row.  Rows
//   stream R at a time (2 * R independent loads a thread in flight); any N
//   works;
// - a row whose result does not depend on p and g is not read: a row that
//   takes neither spec nor a mean is left as it is, and a row that takes
//   the external mean is only written;
// - a table entry is one (cell, leaf) pair: the grid runner folds G cells of
//   N clients into [G * N, D] leaves, and an entry points at its cell's N
//   rows of the leaf and, by `row`, of the per-client columns.  Its mean
//   sums its own N rows in row order, as a one-cell launch does, so a
//   folded round is bitwise equal to G one-cell rounds;
// - 16-byte vectors where D % 4 == 0 and the leaf's pointers are 16-byte
//   aligned, single elements otherwise (the fc head's D = 10);
// - the per-client columns (scale, keep, weights) sit in shared memory;
//   `any(keep)` is one __syncthreads_or;
// - products and sums round as the plain version's separate operations do
//   (no fused multiply-add), and the mean is a division;
// - a leaf is fp32 or bf16 (the token models' units), by a per-leaf flag:
//   a bf16 leaf is read and written as 4 bf16 (8-byte vectors, or single
//   elements), its math is fp32 and its result is rounded once on the
//   store, as the TPU kernel's `.astype(o_ref.dtype)`.  The per-client
//   columns and the external mean stay fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // a block
constexpr int CAPACITY = 64;   // leaves a launch (resnet18-cifar has 42)
constexpr int MAX_N = 4096;    // clients: 3 fp32 columns in shared memory

struct Leaf {
  void* p;           // [n, d] fp32 or bf16, updated in place
  const void* g;     // [n, d], p's type
  const float* c;    // [d] the external mean, or null (flat update)
  int64_t d;
  int32_t start;     // the leaf's first chunk
  int32_t flags;     // bit 0: keep_spec; bit 1: vectors of 4 elements;
                     // bit 2: bf16 (else fp32)
  int32_t row;       // the entry's first row of the per-client columns
};

struct Table {
  Leaf leaf[CAPACITY];
  const float* scale;  // [rows] clip factors
  const float* w;      // [rows] participation weights, or null (all ones)
  const float* keep;   // [rows] the caller's keep vector (> 0 keeps), or
                       //     null: keep_spec && w > 0, per leaf
  const float* u;      // [1] external: the caller's use-common flag, or
                       //     the global survivor count (u_is_count)
  float gamma;
  int32_t n;           // rows of an entry (a cell's clients)
  int32_t leaves;
  int32_t chunks;      // blocks of the launch
  int32_t u_is_count;  // use = u > 0 && !keep_spec (else use = u > 0)
};

template <int VW>
__device__ __forceinline__ void load(const float* a, float (&f)[VW]) {
  if constexpr (VW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(a);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else {
    f[0] = *a;
  }
}

template <int VW>
__device__ __forceinline__ void load(const __nv_bfloat16* a, float (&f)[VW]) {
  if constexpr (VW == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(a);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __bfloat162float(e[i]);
  } else {
    f[0] = __bfloat162float(*a);
  }
}

template <int VW>
__device__ __forceinline__ void store(float* a, const float (&f)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(a) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    *a = f[0];
  }
}

template <int VW>
__device__ __forceinline__ void store(__nv_bfloat16* a, const float (&f)[VW]) {
  if constexpr (VW == 4) {
    uint2 v;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = __float2bfloat16(f[i]);
    *reinterpret_cast<uint2*>(a) = v;
  } else {
    *a = __float2bfloat16(f[0]);
  }
}

// p - gamma * (g * s), rounded at each operation
__device__ __forceinline__ float sgd(float p, float g, float s, float gamma) {
  return __fsub_rn(p, __fmul_rn(gamma, __fmul_rn(g, s)));
}

// Columns of one chunk where the update is elementwise: a keeping row
// takes spec, else the external mean where `use`, else stays.
template <int R, int V, int VW, typename T>
__device__ __forceinline__ void elementwise(const Leaf& L, int64_t chunk,
                                            const float* s, const float* k,
                                            int n, float gamma, bool use) {
  T* const P = static_cast<T*>(L.p);
  const T* const G = static_cast<const T*>(L.g);
  int64_t col[V];
  bool ok[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    col[v] = (chunk * V + v) * (THREADS * VW) + threadIdx.x * VW;
    ok[v] = col[v] < L.d;
  }
  float cv[V][VW];
  if (use) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (ok[v]) load<VW>(L.c + col[v], cv[v]);
  }
  for (int n0 = 0; n0 < n; n0 += R) {
    float pv[R][V][VW], gv[R][V][VW];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = n0 + r;
      if (row < n && k[row] != 0.f) {
        const int64_t base = static_cast<int64_t>(row) * L.d;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (ok[v]) {
            load<VW>(P + base + col[v], pv[r][v]);
            load<VW>(G + base + col[v], gv[r][v]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = n0 + r;
      if (row >= n) continue;
      T* out = P + static_cast<int64_t>(row) * L.d;
      if (k[row] != 0.f) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (!ok[v]) continue;
          float y[VW];
#pragma unroll
          for (int e = 0; e < VW; ++e)
            y[e] = sgd(pv[r][v][e], gv[r][v][e], s[row], gamma);
          store<VW>(out + col[v], y);
        }
      } else if (use) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (ok[v]) store<VW>(out + col[v], cv[v]);
      }
    }
  }
}

// Columns of one chunk where no client keeps and cnt > 0: every row takes
// sum_n(w_n * spec_n) / cnt, the sum in row order.
template <int R, int V, int VW, typename T>
__device__ __forceinline__ void mean(const Leaf& L, int64_t chunk,
                                     const float* s, const float* w, int n,
                                     float gamma, float cnt) {
  T* const P = static_cast<T*>(L.p);
  const T* const G = static_cast<const T*>(L.g);
  int64_t col[V];
  bool ok[V];
  float acc[V][VW];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    col[v] = (chunk * V + v) * (THREADS * VW) + threadIdx.x * VW;
    ok[v] = col[v] < L.d;
#pragma unroll
    for (int e = 0; e < VW; ++e) acc[v][e] = 0.f;
  }
  for (int n0 = 0; n0 < n; n0 += R) {
    float pv[R][V][VW], gv[R][V][VW];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = n0 + r;
      if (row < n) {
        const int64_t base = static_cast<int64_t>(row) * L.d;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (ok[v]) {
            load<VW>(P + base + col[v], pv[r][v]);
            load<VW>(G + base + col[v], gv[r][v]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = n0 + r;
      if (row >= n) continue;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (!ok[v]) continue;
#pragma unroll
        for (int e = 0; e < VW; ++e)
          acc[v][e] = __fadd_rn(
              acc[v][e],
              __fmul_rn(sgd(pv[r][v][e], gv[r][v][e], s[row], gamma), w[row]));
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int e = 0; e < VW; ++e) acc[v][e] = __fdiv_rn(acc[v][e], cnt);
  for (int row = 0; row < n; ++row) {
    T* out = P + static_cast<int64_t>(row) * L.d;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (ok[v]) store<VW>(out + col[v], acc[v]);
  }
}

template <int R, int V, int VW, typename T>
__device__ __forceinline__ void update(const Leaf& L, int64_t chunk,
                                       const float* s, const float* k,
                                       const float* w, int n, float gamma,
                                       bool any, bool use) {
  if (L.c != nullptr || any) {
    elementwise<R, V, VW, T>(L, chunk, s, k, n, gamma, use);
    return;
  }
  float cnt = 0.f;
  for (int i = 0; i < n; ++i) cnt = __fadd_rn(cnt, w[i]);
  if (cnt > 0.f) mean<R, V, VW, T>(L, chunk, s, w, n, gamma, cnt);
  // else no survivor: every row holds p
}

template <int R, int V>
__global__ void __launch_bounds__(THREADS)
clip_sgd_kernel(const __grid_constant__ Table t) {
  extern __shared__ float sh[];
  const int n = t.n;
  float* s = sh;
  float* k = sh + n;
  float* w = sh + 2 * n;
  // this block's leaf: the last one whose first chunk is at or before it
  const int b = static_cast<int>(blockIdx.x);
  int lo = 0, hi = t.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].start <= b) lo = mid; else hi = mid - 1;
  }
  const Leaf& L = t.leaf[lo];
  const bool keep_spec = (L.flags & 1) != 0;
  const int row = L.row;
  bool mine = false;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float wi = t.w != nullptr ? t.w[row + i] : 1.f;
    const bool keep = t.keep != nullptr ? t.keep[row + i] > 0.f
                                        : keep_spec && wi > 0.f;
    s[i] = t.scale[row + i];
    k[i] = keep ? 1.f : 0.f;
    w[i] = wi;
    mine |= keep;
  }
  const bool any = __syncthreads_or(mine) != 0;
  bool use = false;
  if (L.c != nullptr) {
    const float u = *t.u;
    use = t.u_is_count ? u > 0.f && !keep_spec : u > 0.f;
    if (!any && !use) return;  // every row holds p
  }
  const int64_t chunk = b - L.start;
  if (L.flags & 4) {
    if (L.flags & 2)
      update<R, V, 4, __nv_bfloat16>(L, chunk, s, k, w, n, t.gamma, any, use);
    else
      update<R, V, 1, __nv_bfloat16>(L, chunk, s, k, w, n, t.gamma, any, use);
  } else if (L.flags & 2) {
    update<R, V, 4, float>(L, chunk, s, k, w, n, t.gamma, any, use);
  } else {
    update<R, V, 1, float>(L, chunk, s, k, w, n, t.gamma, any, use);
  }
}

}  // namespace

// sizeof(Table), for the wrapper's check of its ctypes layout
extern "C" int repro_clip_sgd_table_bytes() {
  return static_cast<int>(sizeof(Table));
}

// One launch over the `Table` at `table` (the wrapper fills it: pointers, d,
// flags, first chunks and the chunk count under the same plan).  `plan`
// packs R, the rows a thread streams at once (bits 0-3: 1, 2, 4, 8), and
// V, the column vectors a thread owns in a chunk (bits 4-7: 1, 2); a
// chunk is THREADS * V vectors of 4 or 1 elements.  Launches on `stream`,
// does not synchronise, returns cudaGetLastError().
extern "C" int repro_clip_sgd(const void* table, int plan, void* stream) {
  const Table* t = static_cast<const Table*>(table);
  if (t->n < 1 || t->n > MAX_N || t->leaves < 1 || t->leaves > CAPACITY ||
      t->chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(t->n);
  const dim3 grid(static_cast<unsigned>(t->chunks));
  switch (plan) {
#define REPRO_CLIP_SGD_PLAN(R, V)                                      \
  case (R) | (V) << 4:                                                 \
    clip_sgd_kernel<R, V><<<grid, THREADS, smem, s>>>(*t);             \
    break;
    REPRO_CLIP_SGD_PLAN(1, 1)
    REPRO_CLIP_SGD_PLAN(2, 1)
    REPRO_CLIP_SGD_PLAN(4, 1)
    REPRO_CLIP_SGD_PLAN(8, 1)
    REPRO_CLIP_SGD_PLAN(1, 2)
    REPRO_CLIP_SGD_PLAN(2, 2)
    REPRO_CLIP_SGD_PLAN(4, 2)
    REPRO_CLIP_SGD_PLAN(8, 2)
#undef REPRO_CLIP_SGD_PLAN
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
