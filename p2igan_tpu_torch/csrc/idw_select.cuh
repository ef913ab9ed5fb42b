// The candidate selection of the factored IDW, shared by the multi-window
// combine (combine_table_multi.cu), the per-sample combine (combine_table.cu),
// their backwards (combine_table_multi_bwd.cu, combine_table_bwd.cu) and the
// dense-field combine (combine_dense.cu), so the tie-sensitive arithmetic
// exists exactly once, as _selection_weights and _accumulate_values do in
// p2igan_tpu/ops/pallas/idw_factored_kernel.py.
//
// For query frame z and pixel p the candidates are (frame sel[z][fi], gauge slot
// s): fi < kf pruned frames (ascending, from the host's _frame_selection) times
// the k nearest slots of p (gd2/gsel). Candidate distance sqrt(gd2 + fd2), capped
// at 1e15; k rounds of first-min extraction (lowest candidate index on ties,
// which is the flat frame-major order of the reference); weights
// w = 1/(d + tau)^rho, zero at the 1e15 cap.
//
// Rounding: sqrt, division, products and sums use round-to-nearest intrinsics
// and the library builds with -fmad=false, so the selection equals the plain
// PyTorch version's bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace p2i {

constexpr int kMaxK = 8;
constexpr int kMaxCand = 64;    // kf * k, one bit each in the taken mask
constexpr float kBigD = 1e15f;  // == sqrtf(1e30f), the invalid-candidate cap

// Loads pixel p's k gauge distances^2 and slot ids from the (k, HW) tables.
__device__ __forceinline__ void load_gauges(const float* __restrict__ gd2,
                                            const int* __restrict__ gsel, int p,
                                            int HW, int k, float (&g2)[kMaxK],
                                            int (&gs)[kMaxK]) {
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    g2[s] = 0.0f;
    gs[s] = 0;
    if (s < k) {
      g2[s] = gd2[s * HW + p];
      gs[s] = gsel[s * HW + p];
    }
  }
}

// The k selection rounds of one (pixel, z). s_fd2 is row z of fd2 (kf*k,) and
// s_sel row z of sel (kf,). Returns the weight sum's denominator
// w_sum + 1e-12; wr[r] is round r's weight and off[r] the offset
// sel[z][fi] * G + gsel[s][p] of its candidate in a (D, G) table.
__device__ __forceinline__ float select_candidates(
    const float (&g2)[kMaxK], const int (&gs)[kMaxK],
    const float* __restrict__ s_fd2, const int* __restrict__ s_sel, int G,
    int k, int kf, float rho, float tau, int rho_is_2, float (&wr)[kMaxK],
    int (&off)[kMaxK]) {
  uint64_t taken = 0;
  float w_sum = 0.0f;
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

  // (frame row, gauge slot) of each selected candidate, shared by all windows
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
  return __fadd_rn(w_sum, 1e-12f);
}

}  // namespace p2i
