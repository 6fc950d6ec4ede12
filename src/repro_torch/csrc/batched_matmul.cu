// Client-batched fp32 GEMM for Hopper (sm_90a): C[n] = A[n] @ B[n].
//
// Replaces the TPU kernel `_bmm_kernel` / `batched_matmul_pallas` of
// src/repro/kernels/batched_conv.py, which realizes every per-client 3x3
// convolution of the HASFL edge simulator as im2col patches times the
// reshaped filter: the forward (patches @ W), dW (patches^T @ dy) and dx
// (im2col(dilated, re-padded dy) @ flipped W^T).
//
// What bounds it on the card: at the VGG-16 shapes of the main path the
// GEMMs do 2*M*K*C FLOPs on (M*K + K*C + M*C) floats, far above the
// H100's fp32 ridge point, so the bound is operations: full-fp32 FMAs on
// the CUDA cores (no TF32, so results match the fp32 reference).
//
// Design (redesigned from the first 64x64, 4x4-per-thread version):
// - Block tile BM x BN = 128 x 128 (256 threads) or 128 x 64 (128 threads,
//   taken where C <= 64), each thread owning 8 x 8 outputs: per k, two
//   float4 reads of A and two of B from shared memory feed 64 FMAs.  A
//   thread's rows are {4ty..4ty+3} and {BM/2+4ty..}, its columns likewise,
//   so the float4 reads of a quarter-warp hit distinct banks or broadcast.
// - K moves in slabs of BK = 16 through a ring of STAGES = 3 shared-memory
//   stages filled by cp.async: the next two slabs load while this one
//   computes, and one barrier per slab guards the ring.
// - A keeps its stride-1 axis contiguous in shared memory ([m][k] for the
//   forward and dx, [k][m] for dW's patches^T, a transposed view); the
//   compute loop reads either layout with the same count of float4 loads.
//   B is held as [k][c] (c is its unit stride on every path).  Arbitrary
//   strides stay.  Where the stride-1 axis is 16-byte aligned (base, the
//   other strides) a thread copies 16 bytes at a time, with src-size
//   zero-fill at the ragged edge; any other operand (K = 27 of the first
//   conv, no unit stride) takes 4-byte copies.
// - Split-K for shapes whose output tiles leave the card under-filled (the
//   long-K dW shapes): the wrapper picks `splits` and a `chunk` of K (a
//   multiple of BK); split s writes its partial tile to an fp32 workspace
//   [S, N, M, C] and a second kernel sums the S partials in a fixed order,
//   so repeated calls are bitwise equal (no atomics).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BK = 16;
constexpr int STAGES = 3;
constexpr int PAD = 4;  // keeps rows 16-byte aligned, staggers banks

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy of `bytes` (0..16) valid bytes, the rest zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One operand tile of ROWS x BK (A: ROWS = BM, rows m) or BK x ROWS (B:
// ROWS = BN, columns c) in shared memory.  K_CONTIG: the shared layout is
// [row][k] (k contiguous); otherwise [k][row].  `vec` (16-byte copies)
// needs the unit stride on the contiguous axis; without it each element
// is copied alone, at any strides.
template <int ROWS, bool K_CONTIG, int THREADS>
struct Tile {
  static constexpr int LD = K_CONTIG ? BK + PAD : ROWS + PAD;
  static constexpr int FLOATS = K_CONTIG ? ROWS * LD : BK * LD;

  // copy rows [r0, r0 + ROWS) x k [k0, k0 + BK) of a matrix with `rows`
  // rows, k limit `k_end`, strides (s_r, s_k), into `dst`
  __device__ __forceinline__ static void load(float* dst, const float* src,
                                              int64_t r0, int64_t rows,
                                              int64_t k0, int64_t k_end,
                                              int64_t s_r, int64_t s_k,
                                              bool vec, int tid) {
    if (vec) {
      constexpr int CHUNKS = ROWS * BK / 4;
      static_assert(CHUNKS % THREADS == 0, "chunk split");
#pragma unroll
      for (int it = 0; it < CHUNKS / THREADS; ++it) {
        const int e = tid + it * THREADS;
        int r, kk;
        if (K_CONTIG) {
          r = e / (BK / 4);
          kk = (e % (BK / 4)) * 4;
        } else {
          kk = e / (ROWS / 4);
          r = (e % (ROWS / 4)) * 4;
        }
        const int64_t gr = r0 + r, gk = k0 + kk;
        int bytes = 0;
        const float* p = src;
        if (K_CONTIG) {
          if (gr < rows && gk < k_end) {
            const int64_t left = k_end - gk;
            bytes = 4 * static_cast<int>(left < 4 ? left : 4);
            p = src + gr * s_r + gk;
          }
          cp_async16(dst + r * LD + kk, p, bytes);
        } else {
          if (gr < rows && gk < k_end) {
            const int64_t left = rows - gr;
            bytes = 4 * static_cast<int>(left < 4 ? left : 4);
            p = src + gk * s_k + gr;
          }
          cp_async16(dst + kk * LD + r, p, bytes);
        }
      }
    } else {
      constexpr int ELEMS = ROWS * BK;
      static_assert(ELEMS % THREADS == 0, "element split");
#pragma unroll
      for (int it = 0; it < ELEMS / THREADS; ++it) {
        const int e = tid + it * THREADS;
        int r, kk;
        if (K_CONTIG) {
          r = e / BK;
          kk = e % BK;
        } else {
          kk = e / ROWS;
          r = e % ROWS;
        }
        const int64_t gr = r0 + r, gk = k0 + kk;
        const bool ok = gr < rows && gk < k_end;
        const float* p = ok ? src + gr * s_r + gk * s_k : src;
        cp_async4(dst + (K_CONTIG ? r * LD + kk : kk * LD + r), p,
                  ok ? 4 : 0);
      }
    }
  }

  // v[i][x] = tile(row of output i, k = kb + x), x in 0..3, for the 8 rows
  // {base + i} (i < 4) and {ROWS/2 + base + i - 4}
  __device__ __forceinline__ static void read(const float* t, int base,
                                              int kb, float v[8][4]) {
    if (K_CONTIG) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (i < 4 ? base + i : ROWS / 2 + base + i - 4);
        const float4 f = *reinterpret_cast<const float4*>(t + r * LD + kb);
        v[i][0] = f.x, v[i][1] = f.y, v[i][2] = f.z, v[i][3] = f.w;
      }
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float4 lo =
            *reinterpret_cast<const float4*>(t + (kb + x) * LD + base);
        const float4 hi = *reinterpret_cast<const float4*>(
            t + (kb + x) * LD + ROWS / 2 + base);
        v[0][x] = lo.x, v[1][x] = lo.y, v[2][x] = lo.z, v[3][x] = lo.w;
        v[4][x] = hi.x, v[5][x] = hi.y, v[6][x] = hi.z, v[7][x] = hi.w;
      }
    }
  }
};

// grid (m tiles, c tiles, n * splits); split s of client n covers
// k in [s * chunk, min(K, (s + 1) * chunk)) and writes to out + s * N*M*C
// (splits == 1: out is C itself)
template <int BN, bool A_K>
__global__ void __launch_bounds__((BM / 8) * (BN / 8))
bmm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ out, int64_t N, int64_t M, int64_t K,
               int64_t NC, int64_t sa_n, int64_t sa_m, int64_t sa_k,
               int64_t sb_n, int64_t sb_k, int64_t sb_c, int64_t splits,
               int64_t chunk, int a_vec, int b_vec) {
  constexpr int THREADS = (BM / 8) * (BN / 8);
  using TA = Tile<BM, A_K, THREADS>;
  using TB = Tile<BN, false, THREADS>;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + STAGES * TA::FLOATS;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / 8), ty = tid / (BN / 8);
  const int64_t n = blockIdx.z / splits, s = blockIdx.z % splits;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * BN;
  A += n * sa_n;
  B += n * sb_n;
  out += (s * N + n) * M * NC;
  const int64_t k_lo = s * chunk;
  const int64_t k_hi = K < k_lo + chunk ? K : k_lo + chunk;
  const int steps = static_cast<int>((k_hi - k_lo + BK - 1) / BK);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto issue = [&](int step) {
    const int st = step % STAGES;
    const int64_t k0 = k_lo + static_cast<int64_t>(step) * BK;
    TA::load(As + st * TA::FLOATS, A, m0, M, k0, k_hi, sa_m, sa_k, a_vec,
             tid);
    TB::load(Bs + st * TB::FLOATS, B, c0, NC, k0, k_hi, sb_c, sb_k, b_vec,
             tid);
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps) issue(st);
    cp_commit();
  }

  for (int step = 0; step < steps; ++step) {
    cp_wait<STAGES - 2>();  // slab `step` has landed (this thread's part)
    __syncthreads();        // ... everyone's; slab step-1 is consumed
    if (step + STAGES - 1 < steps) issue(step + STAGES - 1);
    cp_commit();
    const float* at = As + (step % STAGES) * TA::FLOATS;
    const float* bt = Bs + (step % STAGES) * TB::FLOATS;
#pragma unroll
    for (int kb = 0; kb < BK; kb += 4) {
      float a[8][4], b[8][4];
      TA::read(at, 4 * ty, kb, a);
      TB::read(bt, 4 * tx, kb, b);
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a[i][x], b[j][x], acc[i][j]);
    }
  }
  cp_wait<0>();

  const bool vec_out = (NC % 4) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t gm = m0 + (i < 4 ? 4 * ty + i : BM / 2 + 4 * ty + i - 4);
    if (gm >= M) continue;
    float* row = out + gm * NC;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gc = c0 + h * (BN / 2) + 4 * tx;
      const float* v = &acc[i][4 * h];
      if (vec_out && gc + 3 < NC) {
        *reinterpret_cast<float4*>(row + gc) = make_float4(v[0], v[1], v[2],
                                                           v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < NC) row[gc + j] = v[j];
      }
    }
  }
}

// out[e] = sum over s of ws[s * total + e], s in order
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     float* __restrict__ out, int64_t total,
                                     int64_t splits) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if (total % 4 == 0) {
    const int64_t quads = total / 4;
    for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
         e < quads; e += stride) {
      float4 acc = reinterpret_cast<const float4*>(ws)[e];
      for (int64_t s = 1; s < splits; ++s) {
        const float4 v = reinterpret_cast<const float4*>(ws + s * total)[e];
        acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
      }
      reinterpret_cast<float4*>(out)[e] = acc;
    }
  } else {
    for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
         e < total; e += stride) {
      float acc = ws[e];
      for (int64_t s = 1; s < splits; ++s) acc += ws[s * total + e];
      out[e] = acc;
    }
  }
}

template <int BN, bool A_K>
int launch_gemm(const float* a, const float* b, float* out, int64_t n,
                int64_t m, int64_t k, int64_t nc, int64_t sa_n, int64_t sa_m,
                int64_t sa_k, int64_t sb_n, int64_t sb_k, int64_t sb_c,
                int64_t splits, int64_t chunk, bool a_vec, bool b_vec,
                cudaStream_t stream) {
  constexpr int THREADS = (BM / 8) * (BN / 8);
  constexpr int SMEM = STAGES *
                       (Tile<BM, A_K, THREADS>::FLOATS +
                        Tile<BN, false, THREADS>::FLOATS) * 4;
  auto kern = bmm_f32_kernel<BN, A_K>;
  static bool smem_set = false;  // the attribute holds for the process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const int64_t grid_x = (m + BM - 1) / BM, grid_y = (nc + BN - 1) / BN;
  if (grid_x > 2147483647LL || grid_y > 65535 || n * splits > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y),
                  static_cast<unsigned>(n * splits));
  kern<<<grid, THREADS, SMEM, stream>>>(a, b, out, n, m, k, nc, sa_n, sa_m,
                                        sa_k, sb_n, sb_k, sb_c, splits, chunk,
                                        a_vec ? 1 : 0, b_vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// A: [N, M, K] at strides (sa_n, sa_m, sa_k); B: [N, K, C] at strides
// (sb_n, sb_k, sb_c); C: contiguous [N, M, C].  splits > 1: K is cut into
// chunks of `chunk` (a multiple of 16) and `ws` holds splits * N * M * C
// floats of partial sums.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() of the launches.
extern "C" int repro_bmm_f32(const void* a, const void* b, void* c, void* ws,
                             int64_t n, int64_t m, int64_t k, int64_t nc,
                             int64_t sa_n, int64_t sa_m, int64_t sa_k,
                             int64_t sb_n, int64_t sb_k, int64_t sb_c,
                             int64_t splits, int64_t chunk, void* stream) {
  if (n == 0 || m == 0 || nc == 0) return 0;
  if (splits < 1 || (splits > 1 && (ws == nullptr || chunk % BK != 0 ||
                                    chunk * (splits - 1) >= k)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits == 1) chunk = k > 0 ? k : 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* out = splits > 1 ? static_cast<float*>(ws) : static_cast<float*>(c);
  // A's shared layout follows its unit stride (k first); B is held as
  // [k][c].  16-byte copies where the unit-stride axis starts 16-byte
  // aligned in every row
  const bool a_k = sa_k == 1 || sa_m != 1;
  const bool a_vec = (a_k ? sa_k == 1 : sa_m == 1) && aligned16(a) &&
                     sa_n % 4 == 0 && (a_k ? sa_m : sa_k) % 4 == 0;
  const bool b_vec = sb_c == 1 && aligned16(b) && sb_n % 4 == 0 &&
                     sb_k % 4 == 0;
#define REPRO_BMM(BN, AK)                                                  \
  launch_gemm<BN, AK>(fa, fb, out, n, m, k, nc, sa_n, sa_m, sa_k, sb_n,    \
                      sb_k, sb_c, splits, chunk, a_vec, b_vec, st)
  const int err = nc <= 64 ? (a_k ? REPRO_BMM(64, true) : REPRO_BMM(64, false))
                           : (a_k ? REPRO_BMM(128, true)
                                  : REPRO_BMM(128, false));
#undef REPRO_BMM
  if (err != 0 || splits == 1) return err;
  const int64_t total = n * m * nc;
  const int64_t work = total % 4 == 0 ? total / 4 : total;
  int64_t blocks = (work + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  splitk_reduce_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(c), total, splits);
  return static_cast<int>(cudaGetLastError());
}
