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
// Design (a simple, correct first kernel):
// - one 64x64 output tile per block, blockIdx.z = client;
// - K staged through shared memory in steps of 16; each of the 256
//   threads owns a 4x4 register tile of outputs (16 FMAs per pair of
//   float4 shared loads);
// - every edge is masked, so any M, K, C runs without zero-padding
//   copies (the first VGG conv has K = 27);
// - A and B take arbitrary row/column strides, so dW reads patches^T as
//   a transposed view; the load pattern follows whichever stride is 1 so
//   neighbouring threads read neighbouring addresses.
// wgmma/TMA and split-K for the long-K dW shapes are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;  // keeps float4 alignment, breaks 16-way conflicts

__global__ void __launch_bounds__(THREADS)
bmm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ C, int64_t M, int64_t K, int64_t NC,
               int64_t sa_n, int64_t sa_m, int64_t sa_k,
               int64_t sb_n, int64_t sb_k, int64_t sb_c,
               int a_m_major, int b_k_major) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t n = blockIdx.z;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * BN;
  A += n * sa_n;
  B += n * sb_n;
  C += n * M * NC;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      int mm, kk;
      if (a_m_major) {
        mm = e % BM;
        kk = e / BM;
      } else {
        kk = e % BK;
        mm = e / BK;
      }
      const int64_t gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? A[gm * sa_m + gk * sa_k] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (BK * BN) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      int kk, cc;
      if (b_k_major) {
        kk = e % BK;
        cc = e / BK;
      } else {
        cc = e % BN;
        kk = e / BN;
      }
      const int64_t gk = k0 + kk, gc = c0 + cc;
      Bs[kk][cc] = (gk < K && gc < NC) ? B[gk * sb_k + gc * sb_c] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gc = c0 + tx * TN + j;
      if (gc < NC) C[gm * NC + gc] = acc[i][j];
    }
  }
}

}  // namespace

// A: [N, M, K] at strides (sa_n, sa_m, sa_k); B: [N, K, C] at strides
// (sb_n, sb_k, sb_c); C: contiguous [N, M, C].  Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() of the launch.
extern "C" int repro_bmm_f32(const void* a, const void* b, void* c,
                             int64_t n, int64_t m, int64_t k, int64_t nc,
                             int64_t sa_n, int64_t sa_m, int64_t sa_k,
                             int64_t sb_n, int64_t sb_k, int64_t sb_c,
                             void* stream) {
  if (n == 0 || m == 0 || nc == 0) return 0;
  // M tiles on x (up to 2^31 - 1 blocks), C tiles and clients on the
  // 65535-limited y and z
  const int64_t grid_x = (m + BM - 1) / BM, grid_y = (nc + BN - 1) / BN;
  if (grid_x > 2147483647LL || grid_y > 65535 || n > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y),
                  static_cast<unsigned>(n));
  const int a_m_major = (sa_m == 1 && sa_k != 1) ? 1 : 0;
  const int b_k_major = (sb_k == 1 && sb_c != 1) ? 1 : 0;
  bmm_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), m, k, nc, sa_n, sa_m, sa_k, sb_n, sb_k, sb_c,
      a_m_major, b_k_major);
  return static_cast<int>(cudaGetLastError());
}
