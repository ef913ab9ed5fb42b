// The selection arithmetic of the generic IDW k-NN, used by its one forward
// kernel, the cell search (#9, idw_knn_cells.cu), which also serves the
// single-pass range of the JAX package (#8), so the tie-sensitive arithmetic
// exists once, as _idw_kernel / _idw_topk_chunk_kernel / _idw_bwd_kernel share
// it in p2igan_tpu/ops/pallas/idw_kernel.py.
//
// A point is a float4 (x, y, z, penalty): the penalty is 0 for a valid point
// and 1e30 for an invalid or padding slot. The selection metric is
// sqrt(((dx*dx + dy*dy) + dz*dz) + penalty), every step rounded to nearest
// (the library builds with -fmad=false, and the intrinsics spell it out).
// A query keeps its k best (d, index) pairs in registers, sorted
// lexicographically. The search visits points out of index order, so its entry
// test (knn_scan_any_order) compares (d, index) pairs: the k lexicographically
// least pairs are exactly k first-min rounds with the lowest-index tie rule.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace p2i {

constexpr int kKnnMaxK = 8;

struct KnnList {
  float d[kKnnMaxK];
  int idx[kKnnMaxK];
  float worst;  // d[k - 1]: a candidate must be strictly below it to enter
};

__device__ __forceinline__ void knn_init(KnnList& l) {
#pragma unroll
  for (int r = 0; r < kKnnMaxK; ++r) {
    l.d[r] = __int_as_float(0x7f800000);  // +inf
    l.idx[r] = INT_MAX;
  }
  l.worst = __int_as_float(0x7f800000);
}

__device__ __forceinline__ float knn_distance(float qx, float qy, float qz,
                                              float4 p) {
  const float dx = __fsub_rn(qx, p.x);
  const float dy = __fsub_rn(qy, p.y);
  const float dz = __fsub_rn(qz, p.z);
  const float d2 = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)),
      p.w);
  return __fsqrt_rn(d2);
}

// Insert (d, i) into the first k entries, keeping them sorted on (d, index).
__device__ __forceinline__ void knn_insert(KnnList& l, float d, int i, int k) {
  float cd = d;
  int ci = i;
#pragma unroll
  for (int r = 0; r < kKnnMaxK; ++r) {
    if (r < k) {
      const bool before = cd < l.d[r] || (cd == l.d[r] && ci < l.idx[r]);
      const float td = before ? l.d[r] : cd;
      const int ti = before ? l.idx[r] : ci;
      l.d[r] = before ? cd : l.d[r];
      l.idx[r] = before ? ci : l.idx[r];
      cd = td;
      ci = ti;
    }
  }
  float w = l.d[0];
#pragma unroll
  for (int r = 1; r < kKnnMaxK; ++r) w = (r == k - 1) ? l.d[r] : w;
  l.worst = w;
}

// The entry test is lexicographic: (d, index) strictly below the k-th entry.
// worst_idx carries the k-th entry's index beside l.worst.
__device__ __forceinline__ int knn_worst_idx(const KnnList& l, int k) {
  int w = l.idx[0];
#pragma unroll
  for (int r = 1; r < kKnnMaxK; ++r) w = (r == k - 1) ? l.idx[r] : w;
  return w;
}

__device__ __forceinline__ void knn_scan_any_order(KnnList& l, int& worst_idx,
                                                   float qx, float qy, float qz,
                                                   const float4* s_pts,
                                                   const int* s_idx, int n, int k) {
  for (int j = 0; j < n; ++j) {
    const float d = knn_distance(qx, qy, qz, s_pts[j]);
    const int i = s_idx[j];
    if (d < l.worst || (d == l.worst && i < worst_idx)) {
      knn_insert(l, d, i, k);
      worst_idx = knn_worst_idx(l, k);
    }
  }
}

// Gap along one axis between [q_lo, q_hi] and a box's [b_lo, b_hi], 0 where
// they overlap; rounded as knn_distance's difference, so that it is at most
// |q - p| of every q in the first range and p in the second.
__device__ __forceinline__ float knn_gap(float q_lo, float q_hi, float b_lo, float b_hi) {
  return b_lo > q_hi ? __fsub_rn(b_lo, q_hi) : (q_lo > b_hi ? __fsub_rn(q_lo, b_hi) : 0.0f);
}

// Lower bound of knn_distance from any query in [q_lo, q_hi] to any point in a
// box lo.xyz..hi.xyz whose least penalty is lo.w: the same rounded operations
// in the same order on smaller (or equal) operands. Round-to-nearest is
// monotone, so the bound is <= the computed d of every member; an empty box
// (lo = +inf) gives +inf.
__device__ __forceinline__ float knn_box_bound(float3 q_lo, float3 q_hi, float4 lo,
                                               float4 hi) {
  const float gx = knn_gap(q_lo.x, q_hi.x, lo.x, hi.x);
  const float gy = knn_gap(q_lo.y, q_hi.y, lo.y, hi.y);
  const float gz = knn_gap(q_lo.z, q_hi.z, lo.z, hi.z);
  const float d2 = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz)),
      lo.w);
  return __fsqrt_rn(d2);
}

// IDW weight of a selected distance (_weight_from_d of the TPU kernels): an
// invalid slot's 1e15 gives ~1e-30, effectively zero.
__device__ __forceinline__ float knn_weight(float d, float rho, float tau,
                                            int rho_is_2) {
  const float dt = __fadd_rn(d, tau);
  if (rho_is_2) {
    const float invd = __fdiv_rn(1.0f, dt);
    return __fmul_rn(invd, invd);
  }
  return __fdiv_rn(1.0f, powf(dt, rho));
}

// The k weights in round order and their sum + 1e-12 (the normalizer).
__device__ __forceinline__ float knn_weights(const KnnList& l, int k, float rho,
                                             float tau, int rho_is_2,
                                             float (&w)[kKnnMaxK]) {
  float w_sum = 0.0f;
#pragma unroll
  for (int r = 0; r < kKnnMaxK; ++r) {
    w[r] = 0.0f;
    if (r < k) {
      w[r] = knn_weight(l.d[r], rho, tau, rho_is_2);
      w_sum = __fadd_rn(w_sum, w[r]);
    }
  }
  return __fadd_rn(w_sum, 1e-12f);
}

// A query's weighted mean of its k selected values, and, where sel is not
// null, its selection: indices and normalized weights.
__device__ __forceinline__ void knn_write_out(const KnnList& l,
                                              const float* __restrict__ vals, int k,
                                              float rho, float tau, int rho_is_2,
                                              float* out, int* sel, float* w_norm) {
  float w[kKnnMaxK];
  const float denom = knn_weights(l, k, rho, tau, rho_is_2, w);
  float wv = 0.0f;
#pragma unroll
  for (int r = 0; r < kKnnMaxK; ++r) {
    if (r < k) wv = __fadd_rn(wv, __fmul_rn(w[r], vals[l.idx[r]]));
  }
  *out = __fdiv_rn(wv, denom);
  if (sel != nullptr) {
#pragma unroll
    for (int r = 0; r < kKnnMaxK; ++r) {
      if (r < k) {
        sel[r] = l.idx[r];
        w_norm[r] = __fdiv_rn(w[r], denom);
      }
    }
  }
}

}  // namespace p2i
