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
// (D, G) tile in shared memory with shared-memory atomics and writes the tile
// as its partial; sum_partials_kernel then adds the partials in block order.
// The tile is D*G*4 bytes: 16 KB at G=256, 72 KB at G=1152 (dynamic shared
// memory, opted in by the launcher); the wrapper refuses a tile beyond its
// limit. A block walks `iters` strips of 128 pixels, so that a large tile is
// zeroed and written once for more pixels (the wrapper picks iters from D*G).
//
// Bound on the H100: the selection (B*D*HW*kf*k*k square roots, as in the
// forward, not shared between samples) and the shared atomics, which
// serialize where neighbouring pixels hit the same gauge slot; the cotangent
// read is B*D*HW*4 bytes (12.6 MB at B=12), the partials nblk*B*D*G*4.
//
// Rounding: the weights are the forward's bit for bit; the order of the sums
// differs from the plain version's, and shared atomics take no fixed order, so
// the result agrees with it to a tolerance and its last bits may change from
// run to run.

#include <cuda_runtime.h>

#include "idw_select.cuh"
#include "sum_partials.cuh"

namespace {

using p2i::kMaxK;

constexpr int kThreads = 128;  // pixels per strip

__global__ void combine_table_bwd_partial_kernel(
    const float* __restrict__ gd2, const int* __restrict__ gsel,
    const float* __restrict__ g, const int* __restrict__ sel,
    const float* __restrict__ fd2, float* __restrict__ parts, int B, int D,
    int G, int HW, int k, int kf, float rho, float tau, int rho_is_2,
    int iters) {
  extern __shared__ float smem_f[];
  const int ncand = kf * k;
  const int plane = D * G;
  const size_t b = blockIdx.y;
  float* s_acc = smem_f;                                       // (D, G)
  float* s_fd2 = s_acc + plane;                                // (D, ncand)
  int* s_sel = reinterpret_cast<int*>(s_fd2 + D * ncand);      // (D, kf)
  for (int i = threadIdx.x; i < plane; i += blockDim.x) s_acc[i] = 0.0f;
  for (int i = threadIdx.x; i < D * ncand; i += blockDim.x) s_fd2[i] = fd2[i];
  for (int i = threadIdx.x; i < D * kf; i += blockDim.x) s_sel[i] = sel[i];
  __syncthreads();

  const float* gd2_b = gd2 + b * k * HW;
  const int* gsel_b = gsel + b * k * HW;
  const float* g_b = g + b * D * HW;
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
          atomicAdd(s_acc + off[r], __fmul_rn(__fdiv_rn(wr[r], denom), gv));
        }
      }
    }
  }
  __syncthreads();

  float* out = parts + (static_cast<size_t>(blockIdx.x) * B + b) * plane;
  for (int i = threadIdx.x; i < plane; i += blockDim.x) out[i] = s_acc[i];
}

}  // namespace

// parts: scratch of nblk * B * D * G floats, nblk = ceil(HW / (128 * iters))
// (the caller allocates it; the launcher checks nblk). Returns a cudaError_t.
extern "C" int p2i_combine_table_bwd(const float* gd2, const int* gsel,
                                     const float* g, const int* sel,
                                     const float* fd2, float* parts, float* out,
                                     int B, int D, int G, int HW, int k, int kf,
                                     float rho, float tau, int rho_is_2,
                                     int iters, int nblk, void* stream) {
  if (iters < 1 || nblk != (HW + kThreads * iters - 1) / (kThreads * iters)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (static_cast<size_t>(D) * G + D * kf * k) * sizeof(float) +
                      static_cast<size_t>(D) * kf * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(combine_table_bwd_partial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(nblk, B);
  combine_table_bwd_partial_kernel<<<grid, kThreads, smem, s>>>(
      gd2, gsel, g, sel, fd2, parts, B, D, G, HW, k, kf, rho, tau, rho_is_2,
      iters);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = B * D * G;
  p2i::sum_partials_kernel<<<(total + 255) / 256, 256, 0, s>>>(parts, out, nblk, total);
  return static_cast<int>(cudaGetLastError());
}
