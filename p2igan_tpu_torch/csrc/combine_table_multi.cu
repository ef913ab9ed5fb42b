// Factored IDW combine for N windows that share one gauge mask.
//
// Replaces p2igan_tpu/ops/pallas/idw_factored_kernel.py::
// factored_combine_table_multi_pallas (_combine_table_multi_kernel).
// For query frame z and pixel p the candidates are (frame sel[z][fi], gauge slot
// s): fi < kf pruned frames (ascending, from the host's _frame_selection) times
// the k nearest slots of p (gd2/gsel). Candidate distance sqrt(gd2 + fd2), capped
// at 1e15; k rounds of first-min extraction (lowest candidate index on ties,
// which is the flat frame-major order of the reference); weights
// w = 1/(d + tau)^2, zero at the 1e15 cap. Every window then reads its k values
// from its own (D, G) table: out = (sum_r w_r * v_r) / (sum_r w_r + 1e-12).
//
// The TPU kernel gathers the values with one-hot matmuls on the MXU and reduces
// over every candidate row; here the gather is a plain indexed load of the k
// selected (frame, slot) entries, accumulated round by round, which is the
// arithmetic of the plain PyTorch version (_factored_combine_xla).
//
// Bound on the H100: the output write, N*D*HW*4 bytes (8 MB at N=8, D=16,
// 128x128) plus D*HW*kf*k*k square roots for the selection. One thread per
// (pixel, z) -- a grid of HW/128 x D blocks fills the 132 SMs -- runs the
// selection once and applies it to all N windows, so the selection cost does
// not grow with N. The tables (N*D*G*4 bytes, 64 KB at N=8) are read through the
// read-only cache; they are small enough to stay resident in L1/L2 for any N.
//
// Rounding: sqrt, division, products and sums use round-to-nearest intrinsics
// and no FMA contraction, so the selection and the value equal the plain
// version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 8;
constexpr int kMaxCand = 64;   // kf * k, one bit each in the taken mask
constexpr float kBigD = 1e15f;  // == sqrtf(1e30f), the invalid-candidate cap

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
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    g2[s] = 0.0f;
    gs[s] = 0;
    if (s < k) {
      g2[s] = gd2[s * HW + p];
      gs[s] = gsel[s * HW + p];
    }
  }

  uint64_t taken = 0;
  float w_sum = 0.0f;
  float wr[kMaxK];
  int cr[kMaxK];
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    wr[r] = 0.0f;
    cr[r] = 0;
    if (r < k) {
      float best = 0.0f;
      int bc = -1;
      for (int fi = 0; fi < kf; ++fi) {
#pragma unroll
        for (int s = 0; s < kMaxK; ++s) {
          if (s < k) {
            const int c = fi * k + s;
            float d = kBigD;
            if (!((taken >> c) & 1ull)) {
              d = __fsqrt_rn(__fadd_rn(g2[s], s_fd2[c]));
              d = d < kBigD ? d : kBigD;
            }
            if (bc < 0 || d < best) {  // strict <: lowest candidate wins a tie
              best = d;
              bc = c;
            }
          }
        }
      }
      taken |= 1ull << bc;
      float w = 0.0f;
      if (best < kBigD) {
        const float dt = __fadd_rn(best, tau);
        if (rho_is_2) {
          const float invd = __fdiv_rn(1.0f, dt);
          w = __fmul_rn(invd, invd);
        } else {
          w = __fdiv_rn(1.0f, powf(dt, rho));
        }
      }
      w_sum = __fadd_rn(w_sum, w);
      wr[r] = w;
      cr[r] = bc;
    }
  }
  const float denom = __fadd_rn(w_sum, 1e-12f);

  // (frame row, gauge slot) of each selected candidate, shared by all windows
  int off[kMaxK];
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    off[r] = 0;
    if (r < k) {
      const int fi = cr[r] / k;
      const int s = cr[r] - fi * k;
      int g = gs[0];
#pragma unroll
      for (int s2 = 1; s2 < kMaxK; ++s2) g = (s2 == s) ? gs[s2] : g;
      off[r] = s_sel[fi] * G + g;
    }
  }

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
  const int threads = 128;
  dim3 grid((HW + threads - 1) / threads, D);
  const size_t smem = static_cast<size_t>(kf) * k * sizeof(float) + kf * sizeof(int);
  combine_table_multi_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      gd2, gsel, tables, sel, fd2, out, N, D, G, HW, k, kf, rho, tau, rho_is_2);
  return static_cast<int>(cudaGetLastError());
}
