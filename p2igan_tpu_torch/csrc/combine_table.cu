// Factored IDW combine for B windows that each carry their OWN gauge mask.
//
// Replaces p2igan_tpu/ops/pallas/idw_factored_kernel.py::
// factored_combine_table_pallas (_combine_table_kernel), which the JAX package
// vmaps over the batch: here the batch is a grid axis, one launch for all
// samples. Sample b has its own per-pixel gauge distances^2 and slot ids
// (gd2, gsel: (B, k, HW)) and its own (D, G) table of values at the gauge
// slots. The candidate selection (csrc/idw_select.cuh, the code the shared-mask
// combine and both backwards run) picks k (frame, slot) candidates per (pixel,
// z) with their IDW weights; the values are accumulated round by round,
// wv += w_r * v_r, and divided by (sum_r w_r + 1e-12): the order of
// _accumulate_values in the TPU kernel and of the plain PyTorch version.
//
// The TPU kernel gathers the candidate values with one-hot matmuls against the
// VMEM-resident table; here the gather is an indexed load of the k selected
// entries through the read-only cache. A table is D*G*4 bytes (16 KB at G=256,
// 72 KB at G=1152, beyond the static shared-memory limit), small enough to stay
// in L1/L2, so no shared-memory copy is made and G is not limited by it.
//
// Bound on the H100: the output write, B*D*HW*4 bytes (12.6 MB at B=12), plus
// the selection, B*D*HW*kf*k*k square roots. Unlike the shared-mask combine the
// selection cannot be shared between the samples: its cost grows with B. One
// thread per (sample, z, pixel); a grid of HW/128 x D x B blocks.
//
// Rounding: sqrt, division, products and sums use round-to-nearest intrinsics
// and no FMA contraction, so the result equals the plain version's bit for bit.

#include <cuda_runtime.h>

#include "idw_select.cuh"

namespace {

using p2i::kMaxK;

__global__ void combine_table_kernel(const float* __restrict__ gd2,
                                     const int* __restrict__ gsel,
                                     const float* __restrict__ tables,
                                     const int* __restrict__ sel,
                                     const float* __restrict__ fd2,
                                     float* __restrict__ out, int D, int G,
                                     int HW, int k, int kf, float rho, float tau,
                                     int rho_is_2) {
  extern __shared__ unsigned char smem_raw[];
  const int ncand = kf * k;
  const int z = blockIdx.y;
  const size_t b = blockIdx.z;
  float* s_fd2 = reinterpret_cast<float*>(smem_raw);  // (ncand,) row z of fd2
  int* s_sel = reinterpret_cast<int*>(s_fd2 + ncand);  // (kf,) row z of sel
  for (int i = threadIdx.x; i < ncand; i += blockDim.x) s_fd2[i] = fd2[z * ncand + i];
  for (int i = threadIdx.x; i < kf; i += blockDim.x) s_sel[i] = sel[z * kf + i];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;

  float g2[kMaxK];
  int gs[kMaxK];
  p2i::load_gauges(gd2 + b * k * HW, gsel + b * k * HW, p, HW, k, g2, gs);
  float wr[kMaxK];
  int off[kMaxK];
  const float denom = p2i::select_candidates(g2, gs, s_fd2, s_sel, G, k, kf, rho,
                                             tau, rho_is_2, wr, off);

  const float* tab = tables + b * D * G;
  float acc = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    if (r < k) acc = __fadd_rn(acc, __fmul_rn(wr[r], __ldg(tab + off[r])));
  }
  out[(b * D + z) * HW + p] = __fdiv_rn(acc, denom);
}

}  // namespace

extern "C" int p2i_combine_table(const float* gd2, const int* gsel,
                                 const float* tables, const int* sel,
                                 const float* fd2, float* out, int B, int D,
                                 int G, int HW, int k, int kf, float rho,
                                 float tau, int rho_is_2, void* stream) {
  const int threads = 128;
  dim3 grid((HW + threads - 1) / threads, D, B);
  const size_t smem = static_cast<size_t>(kf) * k * sizeof(float) + kf * sizeof(int);
  combine_table_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      gd2, gsel, tables, sel, fd2, out, D, G, HW, k, kf, rho, tau, rho_is_2);
  return static_cast<int>(cudaGetLastError());
}
