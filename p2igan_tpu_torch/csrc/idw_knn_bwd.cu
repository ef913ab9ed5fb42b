// Backward of the single-pass generic IDW (#8): d_values (B, Pp) from the
// output cotangent g (B, Q).
//
// Replaces p2igan_tpu/ops/pallas/idw_kernel.py::idw_3d_knn_bwd_pallas
// (_idw_bwd_kernel), P <= 4096. The forward is linear in the values and its
// selection depends only on the points, so no values are saved: every query
// re-runs the forward's selection (idw_knn.cuh, the same code) for its weight
// sum, then adds w_r * (g / (w_sum + 1e-12)) into each selected point: the
// TPU kernel's order of operations.
//
// Accumulation: Q queries feed Pp points (262144 into 4096), so a block sums
// the contributions of its queries into a (Pp,) tile in shared memory with
// shared-memory atomics (16 KB at Pp = 4096, beside the 64 KB of points) and
// writes the tile as its partial; sum_partials_kernel then adds the partials
// in block order. A block walks `iters` strips of 256 queries, so that a tile
// is zeroed and written once for up to 2048 queries.
//
// Bound on the H100: operations, as the forward (Q*P pairs a sample, 9 + 3k
// operations and a square root each); the atomics are k a query.
//
// Rounding: the weights are the forward's bit for bit. The sums are not in a
// fixed order: shared-memory atomics take none (two runs may differ in the last
// bits), and they differ from the plain version's index_add_, so the result
// agrees with it to a tolerance.

#include <cuda_runtime.h>

#include "idw_knn.cuh"
#include "sum_partials.cuh"

namespace {

using p2i::kKnnMaxK;

constexpr int kThreads = 256;  // queries a strip

__global__ void idw_knn_bwd_partial_kernel(const float4* __restrict__ pts,
                                           const float* __restrict__ g,
                                           const float* __restrict__ lx,
                                           const float* __restrict__ ly,
                                           const float* __restrict__ lz,
                                           float* __restrict__ parts, int B,
                                           int Pp, int Q, int H, int W, int k,
                                           float rho, float tau, int rho_is_2,
                                           int iters) {
  extern __shared__ float4 s_pts[];                       // (Pp,)
  float* s_acc = reinterpret_cast<float*>(s_pts + Pp);    // (Pp,)
  const size_t b = blockIdx.y;
  for (int i = threadIdx.x; i < Pp; i += blockDim.x) {
    s_pts[i] = pts[b * Pp + i];
    s_acc[i] = 0.0f;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    const int q = (blockIdx.x * iters + it) * kThreads + threadIdx.x;
    if (q >= Q) break;
    float qx, qy, qz;
    p2i::knn_query(lx, ly, lz, q, H, W, qx, qy, qz);
    p2i::KnnList l;
    p2i::knn_init(l);
    p2i::knn_scan(l, qx, qy, qz, s_pts, Pp, 0, k);
    float w[kKnnMaxK];
    const float denom = p2i::knn_weights(l, k, rho, tau, rho_is_2, w);
    const float scale = __fdiv_rn(g[b * Q + q], denom);
#pragma unroll
    for (int r = 0; r < kKnnMaxK; ++r) {
      if (r < k) atomicAdd(s_acc + l.idx[r], __fmul_rn(w[r], scale));
    }
  }
  __syncthreads();

  float* out = parts + (static_cast<size_t>(blockIdx.x) * B + b) * Pp;
  for (int i = threadIdx.x; i < Pp; i += blockDim.x) out[i] = s_acc[i];
}

}  // namespace

// parts: scratch of nblk * B * Pp floats, nblk = ceil(Q / (256 * iters)) (the
// caller allocates it; the launcher checks nblk); out: (B, Pp). Pp <= 4096.
// Returns a cudaError_t.
extern "C" int p2i_idw_knn_bwd(const float* pts, const float* g, const float* lx,
                               const float* ly, const float* lz, float* parts,
                               float* out, int B, int Pp, int D, int H, int W,
                               int k, float rho, float tau, int rho_is_2,
                               int iters, int nblk, void* stream) {
  const int Q = D * H * W;
  if (k < 1 || k > kKnnMaxK || Pp < 1 || Pp > 4096 || B < 1 || iters < 1 ||
      nblk != (Q + kThreads * iters - 1) / (kThreads * iters)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(Pp) * (sizeof(float4) + sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(idw_knn_bwd_partial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(nblk, B);
  idw_knn_bwd_partial_kernel<<<grid, kThreads, smem, s>>>(
      reinterpret_cast<const float4*>(pts), g, lx, ly, lz, parts, B, Pp, Q, H, W,
      k, rho, tau, rho_is_2, iters);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = B * Pp;
  p2i::sum_partials_kernel<<<(total + 255) / 256, 256, 0, s>>>(parts, out, nblk, total);
  return static_cast<int>(cudaGetLastError());
}
