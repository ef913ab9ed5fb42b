// Shared-memory tile product of the DK/STDK MLP tail kernels
// (dk_mlp_tail.cu, dk_mlp_tail_bwd.cu).
//
// A block of kTY x kTX = 208 threads computes C[m, n] = sum_k A(m, k) * B(k, n)
// with both operands in shared memory and a register block per thread:
// thread (ty, tx) owns rows m = ty + kTY * i (i < TM) and columns
// n = tx + kTX * j (j < TN), so one k step is TM + TN shared loads for TM * TN
// fused multiply-adds. Operands are addressed by two strides each, so one
// stored copy of a matrix serves as A or B, plain or transposed. Strided
// ownership keeps the loads of a warp on neighbouring addresses where the
// unit stride runs along m or n, and on distinct banks where it runs along k
// and the other stride is 4 mod 32 floats (hidden 100, row tiles padded by 4).
// Rows and columns past M and N are clamped to the last valid one: they
// compute a duplicate that the caller ignores, and read nothing out of range.
//
// Everything is float32 with float32 accumulation. The products are spelled
// fmaf, so the library's -fmad=false (needed by the IDW kernels, which select
// on exact ties) does not halve the rate here; nothing in the tail selects.

#pragma once

#include <cuda_runtime.h>

namespace dkmlp {

constexpr int kTY = 16;
constexpr int kTX = 13;
constexpr int kThreads = kTY * kTX;
constexpr int kTN = 8;                  // columns a thread owns
constexpr int kMaxHidden = kTX * kTN;   // 104

// acc[i][j] = sum_k A[m_i * a_sm + k * a_sk] * B[k * b_sk + n_j * b_sn].
// kAddRelu: A is read as relu(A + a_bias[k]) (the first layer's activation,
// formed on the fly from the resident phi tile and the row's hidden offset).
template <int TM, int TN, bool kAddRelu>
__device__ __forceinline__ void tile_gemm(float (&acc)[TM][TN], const float* A,
                                          int a_sm, int a_sk, const float* B,
                                          int b_sk, int b_sn, int M, int N, int K,
                                          int ty, int tx, const float* a_bias) {
  int ao[TM];
  int bo[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) ao[i] = min(ty + kTY * i, M - 1) * a_sm;
#pragma unroll
  for (int j = 0; j < TN; ++j) bo[j] = min(tx + kTX * j, N - 1) * b_sn;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float* Ak = A + k * a_sk;
    const float* Bk = B + k * b_sk;
    float a[TM];
    float b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = Ak[ao[i]];
    if (kAddRelu) {
      const float o = a_bias[k];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = fmaxf(a[i] + o, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bk[bo[j]];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Block-wide copy of n floats from device memory into shared memory.
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src,
                                         int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

}  // namespace dkmlp
