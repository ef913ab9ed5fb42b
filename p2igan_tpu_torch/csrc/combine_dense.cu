// Factored IDW combine of ONE window whose candidate values arrive as a dense
// matrix gathered from the field.
//
// Replaces p2igan_tpu/ops/pallas/idw_factored_kernel.py::
// factored_combine_pallas (_combine_kernel). Inputs: gd2 (k, HW), the squared
// distances of every pixel's k nearest gauges, and cvals (D*k, HW), row
// f*k + s holding the field's value at frame f and at the pixel's s-th gauge.
// For every (pixel, z) the candidate selection (csrc/idw_select.cuh, shared
// with the table combines) picks k candidates (frame, slot) with their IDW
// weights; called with G = k and slot ids 0..k-1 its table offset f*G + s IS the
// cvals row. The values are accumulated round by round, wv += w_r * v_r, and
// divided by (sum_r w_r + 1e-12), the order of _accumulate_values in the TPU
// kernel and of the plain PyTorch version.
//
// A block owns 32 pixels (a warp's lanes) and all D query frames: warp y walks
// the frames [y * span, (y + 1) * span) of its lane's pixel, the last warp
// fewer where span does not divide D. sqrt(gd2 + fd2) takes only nv distinct
// fd2 values over all (z, frame) (the host's distinct_frame_table: 13 at D=16,
// k=4), so a pixel's selections read only nv*k distances: the block's warps
// build each pixel's table once between them (warp y fills rows y, y + Y, ...),
// interleaved in shared memory so that a warp's reads hit 32 banks, and every
// warp runs its frames' rounds from it (on registers for k=4, kf=5,
// select_from_table<4, 5>). A pixel takes 52 square roots, where one thread a
// (z, pixel) computing its 20 candidates in each of 4 rounds took 1280. The
// span sets the warps a block (ceil(D / span)) and so the warps in flight:
// one window has only HW / 32 pixel groups. A warp takes its frames in pairs,
// both selections before the 2k value loads, so that the loads of the two
// frames are in flight together.
//
// Bound on the H100: bytes. 4*HW*(k + D*k + D) = 5.5 MB a window at D=16, k=4,
// 128x128 (1.6 us at 3.35 TB/s); the kernel reads only the k selected rows'
// entries of a pixel (each a coalesced access across the warp's pixels
// wherever neighbours pick the same candidate), so it moves less than the
// bound counts. What is left is the rounds' arithmetic and the latency of
// one wave of blocks (a launch, the gauge loads, a barrier, the value loads).
//
// Rounding: as the table combines, round-to-nearest intrinsics and no FMA
// contraction: bitwise equal to the plain version.

#include <cuda_runtime.h>

#include "idw_select.cuh"

namespace {

using p2i::kMaxK;

constexpr int kLanes = 32;    // pixels a block
constexpr int kMaxWarps = 16;  // warps a block at most: ceil(D / span)

// K, KF: k and kf at compile time (4, 5: D=16, k=4), or 0 for run time.
template <int K, int KF>
__global__ void __launch_bounds__(kLanes * kMaxWarps)
combine_dense_kernel(const float* __restrict__ gd2, const float* __restrict__ cvals,
                     const int* __restrict__ sel, const float* __restrict__ vals,
                     const int* __restrict__ vmap, float* __restrict__ out, int D,
                     int HW, int k, int kf, int nv, int span, float rho, float tau,
                     int rho_is_2) {
  extern __shared__ float smem[];
  float* s_dist = smem;                               // (nv*k, kLanes)
  float* s_vals = s_dist + nv * k * kLanes;           // (nv,)
  int* s_vmap = reinterpret_cast<int*>(s_vals + nv);  // (D, kf)
  int* s_sel = s_vmap + D * kf;                       // (D, kf)
  const int p = blockIdx.x * kLanes + threadIdx.x;
  const bool live = p < HW;
  // the pixel's gauge distances are in flight while the frame tables load
  float g2[kMaxK];
  int gs[kMaxK];
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    g2[s] = (live && s < k) ? gd2[s * HW + p] : 0.0f;
    gs[s] = s;
  }
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int nthreads = blockDim.y * kLanes;
  for (int i = tid; i < nv; i += nthreads) s_vals[i] = vals[i];
  for (int i = tid; i < D * kf; i += nthreads) {
    s_vmap[i] = vmap[i];
    s_sel[i] = sel[i];
  }
  __syncthreads();
  float* t = s_dist + threadIdx.x;
  p2i::distance_table(g2, s_vals, nv, k, t, kLanes, threadIdx.y, blockDim.y);
  __syncthreads();
  if (!live) return;

  auto select = [&](int z, float(&wr)[kMaxK], int(&off)[kMaxK]) {
    return p2i::select_from_table<K, KF>(t, kLanes, s_vmap + z * kf, gs, s_sel + z * kf,
                                         /*G=*/k, k, kf, rho, tau, rho_is_2, wr, off);
  };
  auto combine = [&](const float(&wr)[kMaxK], const float(&v)[kMaxK], float denom) {
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      if (r < k) acc = __fadd_rn(acc, __fmul_rn(wr[r], v[r]));
    }
    return __fdiv_rn(acc, denom);
  };
  // frames in pairs: both selections first, then the 2k value loads at once
  const int z0 = threadIdx.y * span;
  const int z1 = min(D, z0 + span);
  for (int z = z0; z < z1; z += 2) {
    const bool two = z + 1 < z1;
    float wa[kMaxK], wb[kMaxK], va[kMaxK], vb[kMaxK];
    int oa[kMaxK], ob[kMaxK];
    const float da = select(z, wa, oa);
    float db = 1.0f;
    if (two) db = select(z + 1, wb, ob);
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      va[r] = vb[r] = 0.0f;
      if (r < k) {
        va[r] = __ldg(cvals + static_cast<size_t>(oa[r]) * HW + p);
        if (two) vb[r] = __ldg(cvals + static_cast<size_t>(ob[r]) * HW + p);
      }
    }
    out[static_cast<size_t>(z) * HW + p] = combine(wa, va, da);
    if (two) out[static_cast<size_t>(z + 1) * HW + p] = combine(wb, vb, db);
  }
}

}  // namespace

// vals (nv,), vmap (D, kf): distinct_frame_table; span: frames a warp walks.
// Returns a cudaError_t.
extern "C" int p2i_combine_dense(const float* gd2, const float* cvals,
                                 const int* sel, const float* vals, const int* vmap,
                                 float* out, int D, int HW, int k, int kf, int nv,
                                 int span, float rho, float tau, int rho_is_2,
                                 void* stream) {
  const int warps = span > 0 ? (D + span - 1) / span : 0;
  if (D < 1 || HW < 1 || k < 1 || k > kMaxK || kf < 1 || nv < 1 ||
      kf * k > p2i::kMaxCand || warps < 1 || warps > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the pixels' distance tables, the distinct values, the map, the frames
  const size_t smem =
      (static_cast<size_t>(nv) * k * kLanes + nv + 2 * static_cast<size_t>(D) * kf) * 4;
  auto kernel = k == 4 && kf == 5 ? combine_dense_kernel<4, 5> : combine_dense_kernel<0, 0>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((HW + kLanes - 1) / kLanes);
  dim3 block(kLanes, warps);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      gd2, cvals, sel, vals, vmap, out, D, HW, k, kf, nv, span, rho, tau, rho_is_2);
  return static_cast<int>(cudaGetLastError());
}
