// Backward of the per-sample factored IDW combine: d_tables (B, D, G) from the
// output cotangent g (B, D, HW), every sample with its own gauge selection.
//
// Replaces p2igan_tpu/ops/pallas/idw_factored_kernel.py::
// factored_combine_table_bwd_pallas (_combine_table_bwd_kernel), which the JAX
// package vmaps over the batch; here the batch is grid.y of one launch. The
// forward is linear in the table and its selection depends only on the mask
// geometry, so no values are saved: for every (pixel, z) the forward's
// selection is re-run (csrc/idw_select.cuh, the same code) and each selected
// candidate r (frame f, gauge slot s) receives wnorm_r * g[b, z, p], with
// wnorm_r = w_r / (w_sum + 1e-12) as in the TPU kernel. Its (D, D, kf) route
// matmuls and one-hot scatter matmuls are MXU devices; here the route is
// sel[z][fi] and the scatter an atomic add.
//
// Accumulation: HW pixels feed G slots (16384 into 256, or into 1152), so a
// block sums the contributions of its pixels, for all D query frames, into a
// (D, G) tile of 64-bit fixed-point totals in shared memory and adds the tile's
// non-zero totals into the global ones. Both adds are integer atomics
// (fixed_sum.cuh): the result does not depend on their order or on the grid,
// and two runs agree bit for bit. The tile is D*G*8 bytes: 32 KB at G=256,
// 144 KB at G=1152 (dynamic shared memory, opted in by the launcher); the
// wrapper refuses a tile beyond its limit. A block walks `iters` strips of 128
// pixels, so that a large tile is zeroed and flushed once for more pixels (the
// wrapper picks iters from D*G).
//
// Bound on the H100: the selection (B*D*HW*kf*k*k square roots, as in the
// forward, not shared between samples) and the shared atomics, which
// serialize where neighbouring pixels hit the same gauge slot; the cotangent
// read is B*D*HW*4 bytes (12.6 MB at B=12).
//
// Rounding: the weights are the forward's bit for bit; each term is rounded
// once to the fixed point (a unit of at most 2^-42 of the sample's largest
// |g|) and the total once back to float32, so the result agrees with the plain
// version (float32 sums in autograd's order) to a tolerance.

#include <cuda_runtime.h>

#include "fixed_sum.cuh"
#include "idw_select.cuh"

namespace {

using p2i::kMaxK;
using p2i::u64;

constexpr int kThreads = 128;  // pixels per strip

__global__ void combine_table_bwd_kernel(
    const float* __restrict__ gd2, const int* __restrict__ gsel,
    const float* __restrict__ g, const int* __restrict__ sel,
    const float* __restrict__ fd2, u64* __restrict__ acc,
    unsigned* __restrict__ flags, const unsigned* __restrict__ rowmax, int D,
    int G, int HW, int k, int kf, float rho, float tau, int rho_is_2, int iters,
    int log2_terms) {
  extern __shared__ u64 smem_u[];
  const int ncand = kf * k;
  const int plane = D * G;
  const size_t b = blockIdx.y;
  u64* s_acc = smem_u;                                                // (D, G)
  float* s_fd2 = reinterpret_cast<float*>(s_acc + plane);             // (D, ncand)
  int* s_sel = reinterpret_cast<int*>(s_fd2 + D * ncand);             // (D, kf)
  for (int i = threadIdx.x; i < plane; i += blockDim.x) s_acc[i] = 0;
  for (int i = threadIdx.x; i < D * ncand; i += blockDim.x) s_fd2[i] = fd2[i];
  for (int i = threadIdx.x; i < D * kf; i += blockDim.x) s_sel[i] = sel[i];
  __syncthreads();

  const float* gd2_b = gd2 + b * k * HW;
  const int* gsel_b = gsel + b * k * HW;
  const float* g_b = g + b * D * HW;
  unsigned* flags_b = flags + b * plane;
  const int shift = p2i::fixed_shift(rowmax[b], log2_terms);
  for (int it = 0; it < iters; ++it) {
    const int p = (blockIdx.x * iters + it) * kThreads + threadIdx.x;
    if (p >= HW) break;
    float g2[kMaxK];
    int gs[kMaxK];
    p2i::load_gauges(gd2_b, gsel_b, p, HW, k, g2, gs);
    for (int z = 0; z < D; ++z) {
      float wr[kMaxK];
      int off[kMaxK];
      const float denom = p2i::select_candidates(
          g2, gs, s_fd2 + z * ncand, s_sel + z * kf, G, k, kf, rho, tau,
          rho_is_2, wr, off);
      const float gv = g_b[static_cast<size_t>(z) * HW + p];
#pragma unroll
      for (int r = 0; r < kMaxK; ++r) {
        if (r < k) {
          p2i::fixed_add(s_acc + off[r], flags_b + off[r],
                         __fmul_rn(__fdiv_rn(wr[r], denom), gv), shift);
        }
      }
    }
  }
  __syncthreads();
  p2i::fixed_flush(s_acc, acc + b * plane, plane);
}

}  // namespace

// scratch: p2i::fixed_scratch_bytes(B * D * G, B) bytes (the caller allocates
// it). Returns a cudaError_t.
extern "C" int p2i_combine_table_bwd(const float* gd2, const int* gsel,
                                     const float* g, const int* sel,
                                     const float* fd2, void* scratch, float* out,
                                     int B, int D, int G, int HW, int k, int kf,
                                     float rho, float tau, int rho_is_2,
                                     int iters, void* stream) {
  if (iters < 1 || B < 1 || D < 1 || G < 1 || HW < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(D) * G * sizeof(u64) +
                      (static_cast<size_t>(D) * kf * k + static_cast<size_t>(D) * kf) * 4;
  cudaError_t err = cudaFuncSetAttribute(combine_table_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = static_cast<long long>(D) * G;
  const long long total = B * plane;
  p2i::FixedScratch fs;
  err = p2i::fixed_begin(scratch, total, g, nullptr, 1, B, static_cast<long long>(D) * HW, s, fs);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int log2_terms = p2i::fixed_log2_terms(static_cast<long long>(D) * HW);
  dim3 grid((HW + kThreads * iters - 1) / (kThreads * iters), B);
  combine_table_bwd_kernel<<<grid, kThreads, smem, s>>>(
      gd2, gsel, g, sel, fd2, fs.acc, fs.flags, fs.rowmax, D, G, HW, k, kf, rho, tau,
      rho_is_2, iters, log2_terms);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(p2i::fixed_end(fs, out, total, plane, log2_terms, s));
}
