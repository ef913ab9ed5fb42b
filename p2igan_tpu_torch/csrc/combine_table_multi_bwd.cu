// Backward of the multi-window factored IDW combine: d_tables (N, D, G) from the
// output cotangent g (N, D, HW).
//
// Replaces p2igan_tpu/ops/pallas/idw_factored_kernel.py::
// factored_combine_table_multi_bwd_pallas (_combine_table_multi_bwd_kernel).
// The forward is linear in the tables, and its selection depends only on the
// mask geometry, so the backward needs no saved values: for every (pixel, z)
// it re-runs the forward's selection (csrc/idw_select.cuh, the same code the
// forward runs) and, for every window n and selected candidate r (frame f,
// gauge slot s), adds wnorm_r * g[n, z, p] to d_tables[n, f, s], with
// wnorm_r = w_r / (w_sum + 1e-12) as in the TPU kernel.
//
// Accumulation: many pixels feed the same (n, f, slot) -- 16384 pixels share
// G=128 slots at 128x128 -- so a block of 128 pixels sums its contributions for
// all D query frames into a shared-memory tile of n_tile * D * G floats (96 KiB
// at n_tile=12, D=16, G=128; above the 48 KiB default, so the launcher opts in
// to the larger dynamic shared memory) with shared-memory atomics, then writes
// the tile as its partial. A second kernel sums the per-block partials in block
// order. The TPU kernel also writes one partial per pixel block and sums them
// outside; its one-hot MXU scatter becomes the shared atomics here. Windows
// beyond n_tile take further blocks along grid.y, each re-running the
// selection for its pixels.
//
// Bound on the H100: the selection (D*HW*kf*k*k square roots, as in the
// forward) and the shared atomics, which serialize where neighbouring pixels
// hit the same gauge slot; the cotangent read is N*D*HW*4 bytes (12.6 MB at
// N=12) and the partials nblk*N*D*G*4 (12.6 MB at 128 blocks).
//
// Rounding: the weights are the forward's bit for bit; the order of the sums
// differs from the plain version's (and shared atomics take no fixed order), so
// the result agrees with it to a tolerance, not bitwise.

#include <cuda_runtime.h>

#include "idw_select.cuh"

namespace {

using p2i::kMaxK;

constexpr int kThreads = 128;  // pixels per block

__global__ void combine_table_multi_bwd_partial_kernel(
    const float* __restrict__ gd2, const int* __restrict__ gsel,
    const float* __restrict__ g, const int* __restrict__ sel,
    const float* __restrict__ fd2, float* __restrict__ parts, int N, int D,
    int G, int HW, int k, int kf, float rho, float tau, int rho_is_2,
    int n_tile) {
  extern __shared__ float smem_f[];
  const int ncand = kf * k;
  const int plane = D * G;
  const int n0 = blockIdx.y * n_tile;
  const int nt = min(n_tile, N - n0);
  const int tile = nt * plane;
  float* s_acc = smem_f;                                       // (nt, D, G)
  float* s_fd2 = s_acc + n_tile * plane;                       // (D, ncand)
  int* s_sel = reinterpret_cast<int*>(s_fd2 + D * ncand);      // (D, kf)
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s_acc[i] = 0.0f;
  for (int i = threadIdx.x; i < D * ncand; i += blockDim.x) s_fd2[i] = fd2[i];
  for (int i = threadIdx.x; i < D * kf; i += blockDim.x) s_sel[i] = sel[i];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < HW) {
    float g2[kMaxK];
    int gs[kMaxK];
    p2i::load_gauges(gd2, gsel, p, HW, k, g2, gs);
    for (int z = 0; z < D; ++z) {
      float wr[kMaxK];
      int off[kMaxK];
      const float denom = p2i::select_candidates(
          g2, gs, s_fd2 + z * ncand, s_sel + z * kf, G, k, kf, rho, tau,
          rho_is_2, wr, off);
#pragma unroll
      for (int r = 0; r < kMaxK; ++r) wr[r] = __fdiv_rn(wr[r], denom);
      for (int n = 0; n < nt; ++n) {
        const float gv = g[(static_cast<size_t>(n0 + n) * D + z) * HW + p];
        float* acc = s_acc + n * plane;
#pragma unroll
        for (int r = 0; r < kMaxK; ++r) {
          if (r < k) atomicAdd(acc + off[r], __fmul_rn(wr[r], gv));
        }
      }
    }
  }
  __syncthreads();

  float* out = parts + (static_cast<size_t>(blockIdx.x) * N + n0) * plane;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) out[i] = s_acc[i];
}

// d_tables[i] = sum over pixel blocks b, in order, of parts[b][i].
__global__ void sum_partials_kernel(const float* __restrict__ parts,
                                    float* __restrict__ out, int nblk,
                                    int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = 0.0f;
  for (int b = 0; b < nblk; ++b) {
    acc = __fadd_rn(acc, parts[static_cast<size_t>(b) * total + i]);
  }
  out[i] = acc;
}

}  // namespace

// parts: scratch of nblk * N * D * G floats, nblk = ceil(HW / 128) (the
// caller allocates it; the launcher checks nblk). Returns a cudaError_t.
extern "C" int p2i_combine_table_multi_bwd(const float* gd2, const int* gsel,
                                           const float* g, const int* sel,
                                           const float* fd2, float* parts,
                                           float* out, int N, int D, int G,
                                           int HW, int k, int kf, float rho,
                                           float tau, int rho_is_2, int n_tile,
                                           int nblk, void* stream) {
  if (nblk != (HW + kThreads - 1) / kThreads || n_tile < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (static_cast<size_t>(n_tile) * D * G + D * kf * k) * sizeof(float) +
                      static_cast<size_t>(D) * kf * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(combine_table_multi_bwd_partial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(nblk, (N + n_tile - 1) / n_tile);
  combine_table_multi_bwd_partial_kernel<<<grid, kThreads, smem, s>>>(
      gd2, gsel, g, sel, fd2, parts, N, D, G, HW, k, kf, rho, tau, rho_is_2,
      n_tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = N * D * G;
  sum_partials_kernel<<<(total + 255) / 256, 256, 0, s>>>(parts, out, nblk, total);
  return static_cast<int>(cudaGetLastError());
}
