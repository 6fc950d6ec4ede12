// Per-unit moments of the gradient samples behind the HASFL controller's
// online G^2 / sigma^2 estimate, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference takes these moments in numpy on the
// host (src/repro/core/convergence.py `estimate_constants`, over fp64 copies
// of every gradient sample), and the port's CPU path still does
// (scenarios/controller.py `estimate_profile_constants`).  For K samples
// x_0 .. x_{K-1} of a model's gradients (the controller draws K = 3
// batches), per unit u, over every element i of the unit's leaves, in fp64:
//   g_sq[u]     = mean_k sum_i x_k[i]^2
//   sigma_sq[u] = mean_k sum_i (x_k[i] - m[i])^2,
//   m[i]        = ((x_0[i] + x_1[i]) + x_2[i]) / K
// with the sums over k left to right, as numpy's `stack.mean(axis=0)` and
// `np.mean` take them, and each product, difference, sum and the division
// rounded once, as numpy's separate operations are (no fused multiply-add).
// Only the order of the sums over i differs from numpy's pairwise sums.
//
// What bounds it on the card: memory.  Each sample is read once, K *
// itemsize * sum(n) bytes: VGG-16's 15.2M fp32 entries at K = 3 are 183 MB,
// 0.055 ms at 3.35 TB/s.  The fp64 arithmetic, about 35 operations an
// element with one division, stays under that on the fp64 units.
//
// Design:
// - a table in device memory holds one entry per (unit, leaf), unit after
//   unit: the K samples' pointers, the element count, the leaf's first
//   chunk and its flags.  So one launch covers every leaf of every unit,
//   whatever their number;
// - a block takes a chunk of CHUNK elements of one leaf, found by a binary
//   search over the entries' first chunks.  Thread t takes the 16-byte
//   vectors t, t + THREADS, ... of the chunk (4 fp32 or 8 bf16 elements
//   each) where the leaf's K pointers are 16-byte aligned and its count is
//   a multiple of the vector, else the single elements t, t + THREADS, ...;
//   it widens each value exactly to fp64 and keeps the 2K sums in
//   registers, element after element;
// - the block's sums: a shuffle tree inside each warp (offsets 16 .. 1),
//   then the warps in order; 2K fp64 partial sums a chunk to a workspace;
// - a second launch, a block per unit, adds the unit's chunk partials in
//   chunk order and writes g_sq and sigma_sq: the per-sample sums added
//   left to right, divided by K;
// - no atomics: every sum has one order, so a result repeats bitwise; no
//   fp64 copy and no temporary of the gradients' size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // a block of the chunks' launch
constexpr int CHUNK = 8192;      // elements a block
constexpr int MAX_SAMPLES = 4;   // K
constexpr int UNIT_THREADS = 32;  // a block of the units' launch

struct Entry {
  const void* x[MAX_SAMPLES];  // the leaf in each sample (K of them used)
  int64_t n;                   // elements
  int64_t start;               // the leaf's first chunk
  int64_t flags;               // bit 0: 16-byte vectors; bit 1: bf16
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
  if constexpr (VW == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(a);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
  } else {
    f[0] = __bfloat162float(*a);
  }
}

// One element of the K samples into the 2K sums: x_k^2 into acc[k],
// (x_k - m)^2 into acc[K + k].
template <int K>
__device__ __forceinline__ void add_element(const double (&x)[K],
                                            double (&acc)[2 * K]) {
  double s = x[0];
#pragma unroll
  for (int k = 1; k < K; ++k) s = __dadd_rn(s, x[k]);
  const double m = __ddiv_rn(s, static_cast<double>(K));
#pragma unroll
  for (int k = 0; k < K; ++k) {
    acc[k] = __dadd_rn(acc[k], __dmul_rn(x[k], x[k]));
    const double d = __dsub_rn(x[k], m);
    acc[K + k] = __dadd_rn(acc[K + k], __dmul_rn(d, d));
  }
}

template <int K, int VW, typename T>
__device__ __forceinline__ void chunk_sums(const Entry& e, int64_t chunk,
                                           double (&acc)[2 * K]) {
  const T* x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = static_cast<const T*>(e.x[k]);
  const int64_t lo = chunk * CHUNK;
  const int64_t hi = lo + CHUNK < e.n ? lo + CHUNK : e.n;
  // with vectors, n is a multiple of VW: a vector that starts in the
  // chunk ends in it
  for (int64_t j = lo + threadIdx.x * VW; j < hi; j += THREADS * VW) {
    float v[K][VW];
#pragma unroll
    for (int k = 0; k < K; ++k) load<VW>(x[k] + j, v[k]);
#pragma unroll
    for (int i = 0; i < VW; ++i) {
      double w[K];
#pragma unroll
      for (int k = 0; k < K; ++k) w[k] = static_cast<double>(v[k][i]);
      add_element<K>(w, acc);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS)
grad_moments_chunks_kernel(const Entry* __restrict__ t, int entries,
                           double* __restrict__ partials) {
  // this block's leaf: the last entry whose first chunk is at or before it
  const int64_t b = blockIdx.x;
  int lo = 0, hi = entries - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t[mid].start <= b) lo = mid; else hi = mid - 1;
  }
  const Entry e = t[lo];
  const int64_t chunk = b - e.start;
  double acc[2 * K];
#pragma unroll
  for (int q = 0; q < 2 * K; ++q) acc[q] = 0.0;
  switch (e.flags & 3) {
    case 0: chunk_sums<K, 1, float>(e, chunk, acc); break;
    case 1: chunk_sums<K, 4, float>(e, chunk, acc); break;
    case 2: chunk_sums<K, 1, __nv_bfloat16>(e, chunk, acc); break;
    default: chunk_sums<K, 8, __nv_bfloat16>(e, chunk, acc); break;
  }
  __shared__ double warp_sums[THREADS / 32][2 * K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 2 * K; ++q) {
    double v = acc[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) warp_sums[warp][q] = v;
  }
  __syncthreads();
  if (threadIdx.x < 2 * K) {
    double s = warp_sums[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w)
      s = __dadd_rn(s, warp_sums[w][threadIdx.x]);
    partials[b * (2 * K) + threadIdx.x] = s;
  }
}

template <int K>
__global__ void __launch_bounds__(UNIT_THREADS)
grad_moments_units_kernel(const int64_t* __restrict__ bounds,
                          const double* __restrict__ partials,
                          double* __restrict__ out) {
  __shared__ double sums[2 * K];
  const int u = blockIdx.x;
  const int q = threadIdx.x;
  if (q < 2 * K) {
    double s = 0.0;
    for (int64_t c = bounds[u]; c < bounds[u + 1]; ++c)
      s = __dadd_rn(s, partials[c * (2 * K) + q]);
    sums[q] = s;
  }
  __syncthreads();
  if (q == 0) {
    double g = sums[0], v = sums[K];
#pragma unroll
    for (int k = 1; k < K; ++k) {
      g = __dadd_rn(g, sums[k]);
      v = __dadd_rn(v, sums[K + k]);
    }
    out[2 * u] = __ddiv_rn(g, static_cast<double>(K));
    out[2 * u + 1] = __ddiv_rn(v, static_cast<double>(K));
  }
}

template <int K>
void launch(const Entry* t, int entries, const int64_t* bounds, int units,
            int64_t chunks, double* partials, double* out, cudaStream_t s) {
  grad_moments_chunks_kernel<K><<<static_cast<unsigned>(chunks), THREADS, 0,
                                  s>>>(t, entries, partials);
  grad_moments_units_kernel<K><<<units, UNIT_THREADS, 0, s>>>(bounds,
                                                              partials, out);
}

}  // namespace

// sizeof(Entry), for the wrapper's check of its table layout
extern "C" int repro_grad_moments_entry_bytes() {
  return static_cast<int>(sizeof(Entry));
}

// Two launches over the table at `entries` (in device memory; the wrapper
// fills it: pointers, counts, first chunks and flags under one plan) and
// the `units + 1` first chunks of each unit and the chunk count at `bounds`
// (device memory): the chunks' sums into `partials` (2 * samples fp64 a
// chunk, device memory), then each unit's [g_sq, sigma_sq] into `out`
// ([units, 2] fp64, device memory).  Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int repro_grad_moments(const void* entries, int n_entries,
                                  const void* bounds, int units,
                                  int64_t chunks, int samples,
                                  void* partials, void* out, void* stream) {
  if (n_entries < 1 || units < 1 || chunks < 1 || chunks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const Entry* t = static_cast<const Entry*>(entries);
  const int64_t* b = static_cast<const int64_t*>(bounds);
  double* p = static_cast<double*>(partials);
  double* o = static_cast<double*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (samples) {
    case 1: launch<1>(t, n_entries, b, units, chunks, p, o, s); break;
    case 2: launch<2>(t, n_entries, b, units, chunks, p, o, s); break;
    case 3: launch<3>(t, n_entries, b, units, chunks, p, o, s); break;
    case 4: launch<4>(t, n_entries, b, units, chunks, p, o, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
