// Factored IDW combine for N windows that share one gauge mask.
//
// Replaces p2igan_tpu/ops/pallas/idw_factored_kernel.py::
// factored_combine_table_multi_pallas (_combine_table_multi_kernel).
// The candidate selection (csrc/idw_select.cuh, shared with the backward) picks
// k (frame, gauge slot) candidates per (pixel, z) with their IDW weights; every
// window then reads its k values from its own (D, G) table:
// out = (sum_r w_r * v_r) / (sum_r w_r + 1e-12).
//
// The TPU kernel gathers the values with one-hot matmuls on the MXU and reduces
// over every candidate row; here the gather is a plain indexed load of the k
// selected (frame, slot) entries, accumulated round by round, which is the
// arithmetic of the plain PyTorch version (_factored_combine_xla).
//
// Bound on the H100: the output write, N*D*HW*4 bytes (8 MB at N=8, D=16,
// 128x128), and the selection. One thread per (pixel, z) -- a grid of HW/128 x
// D blocks fills the 132 SMs -- runs the selection once and applies it to all
// N windows, so the selection cost does not grow with N. With k=4, kf=5 its
// kf*k candidate distances are computed once into registers and the rounds run
// there (select_candidates<4, 5>); other shapes take the run-time rounds. The
// tables (N*D*G*4 bytes, 64 KB at N=8) are read through the read-only cache;
// they are small enough to stay resident in L1/L2 for any N.
//
// Rounding: sqrt, division, products and sums use round-to-nearest intrinsics
// and no FMA contraction, so the selection and the value equal the plain
// version's bit for bit.

#include <cuda_runtime.h>

#include "idw_select.cuh"

namespace {

using p2i::kMaxK;

// K, KF: k and kf at compile time (4, 5: D=16, k=4), or 0 for run time.
template <int K, int KF>
__global__ void combine_table_multi_kernel(const float* __restrict__ gd2,
                                           const int* __restrict__ gsel,
                                           const float* __restrict__ tables,
                                           const int* __restrict__ sel,
                                           const float* __restrict__ fd2,
                                           float* __restrict__ out,
                                           int N, int D, int G, int HW, int k,
                                           int kf, float rho, float tau,
                                           int rho_is_2) {
  extern __shared__ unsigned char smem_raw[];
  const int ncand = kf * k;
  const int z = blockIdx.y;
  float* s_fd2 = reinterpret_cast<float*>(smem_raw);  // (ncand,) row z of fd2
  int* s_sel = reinterpret_cast<int*>(s_fd2 + ncand);  // (kf,) row z of sel
  for (int i = threadIdx.x; i < ncand; i += blockDim.x) s_fd2[i] = fd2[z * ncand + i];
  for (int i = threadIdx.x; i < kf; i += blockDim.x) s_sel[i] = sel[z * kf + i];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;

  float g2[kMaxK];
  int gs[kMaxK];
  p2i::load_gauges(gd2, gsel, p, HW, k, g2, gs);
  float wr[kMaxK];
  int off[kMaxK];
  const float denom = p2i::select_candidates<K, KF>(g2, gs, s_fd2, s_sel, G, k, kf, rho,
                                                    tau, rho_is_2, wr, off);

  const size_t plane = static_cast<size_t>(D) * G;
  for (int n = 0; n < N; ++n) {
    const float* tab = tables + n * plane;
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      if (r < k) acc = __fadd_rn(acc, __fmul_rn(wr[r], __ldg(tab + off[r])));
    }
    out[(static_cast<size_t>(n) * D + z) * HW + p] = __fdiv_rn(acc, denom);
  }
}

}  // namespace

extern "C" int p2i_combine_table_multi(const float* gd2, const int* gsel,
                                       const float* tables, const int* sel,
                                       const float* fd2, float* out, int N, int D,
                                       int G, int HW, int k, int kf, float rho,
                                       float tau, int rho_is_2, void* stream) {
  if (N < 1 || D < 1 || G < 1 || HW < 1 || k < 1 || k > kMaxK || kf < 1 ||
      kf * k > p2i::kMaxCand) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 128;
  dim3 grid((HW + threads - 1) / threads, D);
  const size_t smem = static_cast<size_t>(kf) * k * sizeof(float) + kf * sizeof(int);
  auto kernel = k == 4 && kf == 5 ? combine_table_multi_kernel<4, 5>
                                  : combine_table_multi_kernel<0, 0>;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      gd2, gsel, tables, sel, fd2, out, N, D, G, HW, k, kf, rho, tau, rho_is_2);
  return static_cast<int>(cudaGetLastError());
}
