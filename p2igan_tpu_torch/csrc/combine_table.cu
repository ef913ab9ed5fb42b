// Factored IDW combine for B windows that each carry their OWN gauge mask.
//
// Replaces p2igan_tpu/ops/pallas/idw_factored_kernel.py::
// factored_combine_table_pallas (_combine_table_kernel), which the JAX package
// vmaps over the batch: here the batch is a grid axis, one launch for all
// samples. Sample b has its own per-pixel gauge distances^2 and slot ids
// (gd2, gsel: (B, k, HW)) and its own (D, G) table of values at the gauge
// slots. For every query frame z the candidate selection (csrc/idw_select.cuh,
// the code the backward runs too) picks k (frame, slot) candidates with their
// IDW weights; the values are accumulated round by round, wv += w_r * v_r,
// and divided by (sum_r w_r + 1e-12): the order of _accumulate_values in the
// TPU kernel and of the plain PyTorch version.
//
// One thread per (sample, pixel) walks all D query frames. It loads the
// pixel's k distances and slots once and builds its table of the nv*k
// distinct candidate distances once (select_from_table: sqrt(gd2 + fd2) takes
// only nv distinct fd2 values over all (z, frame), 13 at D=16, k=4), so a
// pixel takes 52 square roots, not the 1280 of k rounds over kf*k = 20
// candidates for each of 16 frames. The tables of a block's pixels sit in
// shared memory, interleaved so that a warp's reads hit 32 banks. The D
// outputs of a pixel are written frame by frame, coalesced along pixels. The
// TPU kernel gathers the candidate values with one-hot matmuls against the
// VMEM-resident table; here the gather is an indexed load of the k selected
// entries through the read-only cache (a sample's table is D*G*4 bytes: 16 KB
// at G=256, 72 KB at G=1152, and stays in L1/L2).
//
// Bound on the H100: the output write, B*D*HW*4 bytes (12.6 MB at B=12), and
// the selection: per (sample, z, pixel) k rounds over kf*k candidates, which
// now outweigh the nv*k square roots of a pixel. Unlike the shared-mask
// combine the selection cannot be shared between the samples.
//
// Rounding: sqrt, division, products and sums use round-to-nearest intrinsics
// and no FMA contraction, so the result equals the plain version's bit for bit.

#include <cuda_runtime.h>

#include "idw_select.cuh"

namespace {

using p2i::kMaxK;

constexpr int kThreads = 128;  // pixels a block

// K, KF: k and kf at compile time (4, 5: D=16, k=4), or 0 for run time.
template <int K, int KF>
__global__ void combine_table_kernel(const float* __restrict__ gd2,
                                     const int* __restrict__ gsel,
                                     const float* __restrict__ tables,
                                     const int* __restrict__ sel,
                                     const float* __restrict__ vals,
                                     const int* __restrict__ vmap,
                                     float* __restrict__ out, int D, int G,
                                     int HW, int k, int kf, int nv, float rho,
                                     float tau, int rho_is_2) {
  extern __shared__ float smem[];
  float* s_dist = smem;                                          // (nv*k, kThreads)
  float* s_vals = s_dist + nv * k * kThreads;                    // (nv,)
  int* s_vmap = reinterpret_cast<int*>(s_vals + nv);             // (D, kf)
  int* s_sel = s_vmap + D * kf;                                  // (D, kf)
  for (int i = threadIdx.x; i < nv; i += kThreads) s_vals[i] = vals[i];
  for (int i = threadIdx.x; i < D * kf; i += kThreads) {
    s_vmap[i] = vmap[i];
    s_sel[i] = sel[i];
  }
  __syncthreads();

  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const size_t b = blockIdx.y;

  float g2[kMaxK];
  int gs[kMaxK];
  p2i::load_gauges(gd2 + b * k * HW, gsel + b * k * HW, p, HW, k, g2, gs);
  float* t = s_dist + threadIdx.x;
  p2i::distance_table(g2, s_vals, nv, k, t, kThreads);

  const float* tab = tables + b * D * G;
  float* out_b = out + b * D * HW + p;
#pragma unroll 2
  for (int z = 0; z < D; ++z) {
    float wr[kMaxK];
    int off[kMaxK];
    const float denom = p2i::select_from_table<K, KF>(t, kThreads, s_vmap + z * kf, gs,
                                                      s_sel + z * kf, G, k, kf, rho, tau,
                                                      rho_is_2, wr, off);
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      if (r < k) acc = __fadd_rn(acc, __fmul_rn(wr[r], __ldg(tab + off[r])));
    }
    out_b[static_cast<size_t>(z) * HW] = __fdiv_rn(acc, denom);
  }
}

}  // namespace

// Returns a cudaError_t.
extern "C" int p2i_combine_table(const float* gd2, const int* gsel,
                                 const float* tables, const int* sel,
                                 const float* vals, const int* vmap, float* out,
                                 int B, int D, int G, int HW, int k, int kf, int nv,
                                 float rho, float tau, int rho_is_2, void* stream) {
  if (B < 1 || D < 1 || G < 1 || HW < 1 || k < 1 || k > kMaxK || kf < 1 || nv < 1 ||
      kf * k > p2i::kMaxCand) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the tables of a block's pixels, the distinct values, the map, the frames
  const size_t smem =
      (static_cast<size_t>(nv) * k * kThreads + nv + 2 * static_cast<size_t>(D) * kf) * 4;
  auto kernel = k == 4 && kf == 5 ? combine_table_kernel<4, 5> : combine_table_kernel<0, 0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((HW + kThreads - 1) / kThreads, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      gd2, gsel, tables, sel, vals, vmap, out, D, G, HW, k, kf, nv, rho, tau, rho_is_2);
  return static_cast<int>(cudaGetLastError());
}
