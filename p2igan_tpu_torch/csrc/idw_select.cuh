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
// w = 1/(d + tau)^rho, zero at the 1e15 cap. The rounds exist once
// (select_rounds); the per-sample combines feed them from a table of each
// pixel's distinct candidate distances (distance_table, select_from_table),
// the others compute every candidate's distance (select_candidates).
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

// Weight of a round whose best distance is `best`: 1/(best + tau)^rho, zero
// at the 1e15 cap.
__device__ __forceinline__ float round_weight(float best, float rho, float tau,
                                              int rho_is_2) {
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
  return w;
}

// (frame row, gauge slot) of each round's candidate cr[r] = fi * k + s: the
// offset sel[z][fi] * G + gsel[s][p] in a (D, G) table.
__device__ __forceinline__ void round_offsets(const int (&cr)[kMaxK],
                                              const int (&gs)[kMaxK],
                                              const int* __restrict__ s_sel, int G,
                                              int k, int (&off)[kMaxK]) {
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
}

// The first least of cd[LO..HI) and its index, as a tournament of depth
// log2(HI - LO): the left half holds the lower candidates, so the right one
// wins only when strictly less, and the lowest candidate wins a tie, as in a
// scan from the left.
template <int LO, int HI, int N>
__device__ __forceinline__ void first_min(const float (&cd)[N], float& best, int& bc) {
  if constexpr (HI - LO == 1) {
    best = cd[LO];
    bc = LO;
  } else {
    constexpr int kMid = (LO + HI) / 2;
    float b1, b2;
    int c1, c2;
    first_min<LO, kMid>(cd, b1, c1);
    first_min<kMid, HI>(cd, b2, c2);
    const bool right = b2 < b1;
    best = right ? b2 : b1;
    bc = right ? c2 : c1;
  }
}

// The k selection rounds of one (pixel, z) over its kf*k candidates, whose
// distances dist(fi, s) gives (already capped at kBigD). Round r takes the
// first candidate of least distance, a taken one counting as kBigD (so a
// round with no valid candidate left takes candidate 0, at weight 0). s_sel
// is row z of sel (kf,). Returns the weight sum's denominator w_sum + 1e-12;
// wr[r] is round r's weight and off[r] its candidate's offset (round_offsets).
//
// K, KF > 0: k and kf fixed at compile time (the shipped D=16, k=4 takes
// kf=5): the kf*k distances are read once into registers, every round finds
// their first least by a tournament (first_min), and a taken candidate is
// overwritten by kBigD. K = KF = 0: k and
// kf at run time, distances read in every round, a taken mask. The two give
// the same rounds, hence the same bits.
template <int K, int KF, class Dist>
__device__ __forceinline__ float select_rounds(
    Dist dist, const int (&gs)[kMaxK], const int* __restrict__ s_sel, int G,
    int k, int kf, float rho, float tau, int rho_is_2, float (&wr)[kMaxK],
    int (&off)[kMaxK]) {
  float w_sum = 0.0f;
  int cr[kMaxK];
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    wr[r] = 0.0f;
    cr[r] = 0;
  }
  if constexpr (K > 0 && KF > 0) {
    static_assert(K <= kMaxK && K * KF <= kMaxCand, "candidates beyond the routine");
    constexpr int kN = K * KF;
    float cd[kN];
#pragma unroll
    for (int fi = 0; fi < KF; ++fi) {
#pragma unroll
      for (int s = 0; s < K; ++s) cd[fi * K + s] = dist(fi, s);
    }
#pragma unroll
    for (int r = 0; r < K; ++r) {
      float best;
      int bc;
      first_min<0, kN>(cd, best, bc);
#pragma unroll
      for (int c = 0; c < kN; ++c) cd[c] = c == bc ? kBigD : cd[c];
      const float w = round_weight(best, rho, tau, rho_is_2);
      w_sum = __fadd_rn(w_sum, w);
      wr[r] = w;
      cr[r] = bc;
    }
    round_offsets(cr, gs, s_sel, G, K, off);
  } else {
    uint64_t taken = 0;
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      if (r < k) {
        float best = 0.0f;
        int bc = -1;
        for (int fi = 0; fi < kf; ++fi) {
#pragma unroll
          for (int s = 0; s < kMaxK; ++s) {
            if (s < k) {
              const int c = fi * k + s;
              const float d = ((taken >> c) & 1ull) ? kBigD : dist(fi, s);
              if (bc < 0 || d < best) {  // strict <: lowest candidate wins a tie
                best = d;
                bc = c;
              }
            }
          }
        }
        taken |= 1ull << bc;
        const float w = round_weight(best, rho, tau, rho_is_2);
        w_sum = __fadd_rn(w_sum, w);
        wr[r] = w;
        cr[r] = bc;
      }
    }
    round_offsets(cr, gs, s_sel, G, k, off);
  }
  return __fadd_rn(w_sum, 1e-12f);
}

// Candidate distance sqrt(g2 + fd2), capped at kBigD (a NaN caps too).
__device__ __forceinline__ float candidate_distance(float g2, float fd2) {
  const float d = __fsqrt_rn(__fadd_rn(g2, fd2));
  return d < kBigD ? d : kBigD;
}

// The selection with every candidate's distance computed from fd2: kf*k square
// roots in each of the k rounds at run time (K = KF = 0), once a (pixel, z)
// with k and kf fixed (select_rounds). s_fd2 is row z of fd2 (kf*k,).
template <int K = 0, int KF = 0>
__device__ __forceinline__ float select_candidates(
    const float (&g2)[kMaxK], const int (&gs)[kMaxK],
    const float* __restrict__ s_fd2, const int* __restrict__ s_sel, int G,
    int k, int kf, float rho, float tau, int rho_is_2, float (&wr)[kMaxK],
    int (&off)[kMaxK]) {
  auto dist = [&](int fi, int s) {
    float g = g2[0];
#pragma unroll
    for (int s2 = 1; s2 < kMaxK; ++s2) g = (s2 == s) ? g2[s2] : g;
    return candidate_distance(g, s_fd2[fi * (K > 0 ? K : k) + s]);
  };
  return select_rounds<K, KF>(dist, gs, s_sel, G, k, kf, rho, tau, rho_is_2, wr, off);
}

// Each distance once. The pruned frames' squared z-distances take only nv
// distinct values over all (z, frame) (13 at D=16, k=4; the host's
// distinct_frame_table): s_vals (nv,) and, per query z, s_vmap (kf,) from
// pruned frame to value. A pixel's table t[(j * k + s) * stride] =
// candidate_distance(g2[s], s_vals[j]) holds all nv*k distances its D
// selections read; the same float inputs give the same bits, so selecting
// through it equals select_candidates bit for bit. stride: the table's
// pitch, so that neighbouring threads' tables interleave in shared memory.
// j0, jstep: the rows this thread fills, j0, j0 + jstep, ... (where several
// threads of one pixel share its table, each fills its share).
__device__ __forceinline__ void distance_table(const float (&g2)[kMaxK],
                                               const float* __restrict__ s_vals,
                                               int nv, int k, float* t, int stride,
                                               int j0 = 0, int jstep = 1) {
  for (int j = j0; j < nv; j += jstep) {
    const float v = s_vals[j];
#pragma unroll
    for (int s = 0; s < kMaxK; ++s) {
      if (s < k) t[(j * k + s) * stride] = candidate_distance(g2[s], v);
    }
  }
}

// The selection of query frame z read from a pixel's distance table (K, KF:
// as select_rounds).
template <int K, int KF>
__device__ __forceinline__ float select_from_table(
    const float* t, int stride, const int* __restrict__ s_vmap,
    const int (&gs)[kMaxK], const int* __restrict__ s_sel, int G, int k,
    int kf, float rho, float tau, int rho_is_2, float (&wr)[kMaxK],
    int (&off)[kMaxK]) {
  const int kk = K > 0 ? K : k;
  auto dist = [&](int fi, int s) { return t[(s_vmap[fi] * kk + s) * stride]; };
  return select_rounds<K, KF>(dist, gs, s_sel, G, k, kf, rho, tau, rho_is_2, wr, off);
}

}  // namespace p2i
