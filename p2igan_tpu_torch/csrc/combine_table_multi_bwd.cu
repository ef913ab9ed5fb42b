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
// all D query frames into a shared-memory tile of n_tile * D * G 64-bit
// fixed-point totals (32 KiB at the wrapper's default n_tile=2, D=16, G=128:
// 12 windows then take 6 blocks along grid.y, several resident on an SM; up
// to 192 KiB, dynamic shared memory opted in by the launcher), then adds the
// tile's non-zero totals into the global ones. Both adds are integer atomics (fixed_sum.cuh), so the result does
// not depend on their order, on n_tile or on the grid: two runs agree bit for
// bit. The TPU kernel writes one partial per pixel block and sums them outside;
// its one-hot MXU scatter becomes the atomics here. Windows beyond n_tile take
// further blocks along grid.y, each re-running the selection for its pixels.
//
// Bound on the H100: the selection (D*HW*kf*k*k square roots, as in the
// forward) and the shared atomics, which serialize where neighbouring pixels
// hit the same gauge slot; the cotangent read is N*D*HW*4 bytes (12.6 MB at
// N=12).
//
// Rounding: the weights are the forward's bit for bit; each term w * g is
// rounded once to the fixed point (a unit of at most 2^-42 of the window's
// largest |g|) and the total once back to float32, so the result agrees with
// the plain version (float32 sums in autograd's order) to a tolerance.

#include <cuda_runtime.h>

#include "fixed_sum.cuh"
#include "idw_select.cuh"

namespace {

using p2i::kMaxK;
using p2i::u64;

constexpr int kThreads = 128;  // pixels per block

__global__ void combine_table_multi_bwd_kernel(
    const float* __restrict__ gd2, const int* __restrict__ gsel,
    const float* __restrict__ g, const int* __restrict__ sel,
    const float* __restrict__ fd2, u64* __restrict__ acc,
    unsigned* __restrict__ flags, const unsigned* __restrict__ rowmax, int N,
    int D, int G, int HW, int k, int kf, float rho, float tau, int rho_is_2,
    int n_tile, int log2_terms) {
  extern __shared__ u64 smem_u[];
  const int ncand = kf * k;
  const int plane = D * G;
  const int n0 = blockIdx.y * n_tile;
  const int nt = min(n_tile, N - n0);
  const int tile = nt * plane;
  u64* s_acc = smem_u;                                                 // (nt, D, G)
  float* s_fd2 = reinterpret_cast<float*>(s_acc + n_tile * plane);     // (D, ncand)
  int* s_sel = reinterpret_cast<int*>(s_fd2 + D * ncand);              // (D, kf)
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s_acc[i] = 0;
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
        const size_t row = static_cast<size_t>(n0 + n);
        const float gv = g[(row * D + z) * HW + p];
        const int shift = p2i::fixed_shift(rowmax[row], log2_terms);
        u64* t_acc = s_acc + n * plane;
        unsigned* t_flags = flags + row * plane;
#pragma unroll
        for (int r = 0; r < kMaxK; ++r) {
          if (r < k) {
            p2i::fixed_add(t_acc + off[r], t_flags + off[r], __fmul_rn(wr[r], gv), shift);
          }
        }
      }
    }
  }
  __syncthreads();
  p2i::fixed_flush(s_acc, acc + static_cast<size_t>(n0) * plane, tile);
}

}  // namespace

// scratch: p2i::fixed_scratch_bytes(N * D * G, N) bytes (the caller allocates
// it). Returns a cudaError_t.
extern "C" int p2i_combine_table_multi_bwd(const float* gd2, const int* gsel,
                                           const float* g, const int* sel,
                                           const float* fd2, void* scratch,
                                           float* out, int N, int D, int G,
                                           int HW, int k, int kf, float rho,
                                           float tau, int rho_is_2, int n_tile,
                                           void* stream) {
  if (n_tile < 1 || N < 1 || D < 1 || G < 1 || HW < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(n_tile) * D * G * sizeof(p2i::u64) +
                      (static_cast<size_t>(D) * kf * k + static_cast<size_t>(D) * kf) * 4;
  cudaError_t err = cudaFuncSetAttribute(combine_table_multi_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = static_cast<long long>(D) * G;
  const long long total = N * plane;
  p2i::FixedScratch fs;
  err = p2i::fixed_begin(scratch, total, g, nullptr, 1, N, static_cast<long long>(D) * HW, s, fs);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int log2_terms = p2i::fixed_log2_terms(static_cast<long long>(D) * HW);
  dim3 grid((HW + kThreads - 1) / kThreads, (N + n_tile - 1) / n_tile);
  combine_table_multi_bwd_kernel<<<grid, kThreads, smem, s>>>(
      gd2, gsel, g, sel, fd2, fs.acc, fs.flags, fs.rowmax, N, D, G, HW, k, kf, rho,
      tau, rho_is_2, n_tile, log2_terms);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(p2i::fixed_end(fs, out, total, plane, log2_terms, s));
}
