// Factored IDW combine of ONE window whose candidate values arrive as a dense
// matrix gathered from the field.
//
// Replaces p2igan_tpu/ops/pallas/idw_factored_kernel.py::
// factored_combine_pallas (_combine_kernel). Inputs: gd2 (k, HW), the squared
// distances of every pixel's k nearest gauges, and cvals (D*k, HW), row
// f*k + s holding the field's value at frame f and at the pixel's s-th gauge.
// For every (pixel, z) the candidate selection (csrc/idw_select.cuh, shared
// with the table combines) picks k candidates (frame, slot) with their IDW
// weights; called with G = k and slot ids 0..k-1 its table offset f*G + s IS the
// cvals row. The values are accumulated round by round, wv += w_r * v_r, and
// divided by (sum_r w_r + 1e-12), the order of _accumulate_values in the TPU
// kernel and of the plain PyTorch version.
//
// Bound on the H100: bytes. 4*HW*(k + D*k + D) = 5.5 MB a window at D=16, k=4,
// 128x128 (1.6 us at 3.35 TB/s); the kernel reads only the k selected rows'
// entries of a pixel (each a coalesced access across the block's pixels), so
// it moves less than the bound counts. One thread per (z, pixel).
//
// Rounding: as the table combines, round-to-nearest intrinsics and no FMA
// contraction: bitwise equal to the plain version.

#include <cuda_runtime.h>

#include "idw_select.cuh"

namespace {

using p2i::kMaxK;

__global__ void combine_dense_kernel(const float* __restrict__ gd2,
                                     const float* __restrict__ cvals,
                                     const int* __restrict__ sel,
                                     const float* __restrict__ fd2,
                                     float* __restrict__ out, int D, int HW,
                                     int k, int kf, float rho, float tau,
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
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    g2[s] = (s < k) ? gd2[s * HW + p] : 0.0f;
    gs[s] = s;
  }
  float wr[kMaxK];
  int off[kMaxK];
  const float denom = p2i::select_candidates(g2, gs, s_fd2, s_sel, /*G=*/k, k, kf,
                                             rho, tau, rho_is_2, wr, off);

  float acc = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    if (r < k) {
      const float v = __ldg(cvals + static_cast<size_t>(off[r]) * HW + p);
      acc = __fadd_rn(acc, __fmul_rn(wr[r], v));
    }
  }
  out[static_cast<size_t>(z) * HW + p] = __fdiv_rn(acc, denom);
}

}  // namespace

extern "C" int p2i_combine_dense(const float* gd2, const float* cvals,
                                 const int* sel, const float* fd2, float* out,
                                 int D, int HW, int k, int kf, float rho,
                                 float tau, int rho_is_2, void* stream) {
  const int threads = 128;
  dim3 grid((HW + threads - 1) / threads, D);
  const size_t smem = static_cast<size_t>(kf) * k * sizeof(float) + kf * sizeof(int);
  combine_dense_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      gd2, cvals, sel, fd2, out, D, HW, k, kf, rho, tau, rho_is_2);
  return static_cast<int>(cudaGetLastError());
}
