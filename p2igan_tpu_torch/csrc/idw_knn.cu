// Generic IDW k-NN forward: every query of the (D, H, W) grid takes its k
// nearest of a sample's points (by the f32 sqrt distance, lowest index on
// ties) and writes their inverse-distance-weighted mean. B samples a launch,
// the sample on grid.y, one thread per query.
//
// Two entry points over one body (knn_forward): the points stream through
// shared memory in tiles, and each query's top-k runs across all tiles in
// registers.
// * idw_knn_single_kernel replaces p2igan_tpu/ops/pallas/idw_kernel.py::
//   _idw_forward_single (P <= 4096): one tile holds the sample's padded
//   points (x, y, z, penalty) in dynamic shared memory, 16 bytes a point,
//   64 KB at Pp = 4096.
// * idw_knn_chunked_kernel replaces _idw_forward_chunked (any P; the masks
//   that vary per frame have 65536 to 98304 points), in tiles of kTile. That
//   does the work of the TPU kernel's per-chunk top-k and of its XLA merge
//   together: no (chunks, k, Q) tensor reaches device memory. It writes the
//   selection (sel_idx, w_norm: (B, Q, k)) when asked, for the backward's
//   scatter.
// A query reads its k selected values from device memory.
//
// Bound on the H100: operations. Every (query, point) pair costs 9 + 3k
// float32 operations by the TPU kernels' cost model and one correctly rounded
// square root: Q*P pairs a sample (2.6e10 at Q = 262144, P = 98304). The
// bytes are small (the points once a block, through shared memory). The
// design keeps the pair loop to one broadcast shared-memory load, the
// distance, the square root and one compare against the k-th entry; an
// insertion into the register list is rare once the list holds near points.
// Pruning (spatial bins, skipping the square root where d2 is far above the
// k-th entry) is later work.
//
// Rounding: every step is round-to-nearest with no FMA contraction (see
// idw_knn.cuh), and the weights, sums and division follow the plain PyTorch
// version's order, so the output equals it bit for bit.

#include <cuda_runtime.h>

#include "idw_knn.cuh"

namespace {

using p2i::kKnnMaxK;

constexpr int kThreads = 256;  // queries a block
constexpr int kTile = 2048;    // points a tile of the chunked kernel (32 KB)

__device__ __forceinline__ void write_out(const p2i::KnnList& l,
                                          const float* __restrict__ vals, int k,
                                          float rho, float tau, int rho_is_2,
                                          float* out, int* sel, float* w_norm) {
  float w[kKnnMaxK];
  const float denom = p2i::knn_weights(l, k, rho, tau, rho_is_2, w);
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

// Both forwards: sample blockIdx.y's Pp points pass through s_pts in tiles of
// `tile` points; then each query writes its weighted mean (and selection).
__device__ __forceinline__ void knn_forward(
    const float4* __restrict__ pts, const float* __restrict__ vals,
    const float* __restrict__ lx, const float* __restrict__ ly,
    const float* __restrict__ lz, float* __restrict__ out, int* __restrict__ sel,
    float* __restrict__ w_norm, float4* s_pts, int tile, int Pp, int Q, int H,
    int W, int k, float rho, float tau, int rho_is_2) {
  const size_t b = blockIdx.y;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = q < Q;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) p2i::knn_query(lx, ly, lz, q, H, W, qx, qy, qz);
  p2i::KnnList l;
  p2i::knn_init(l);
  for (int base = 0; base < Pp; base += tile) {
    const int n = min(tile, Pp - base);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_pts[i] = pts[b * Pp + base + i];
    __syncthreads();
    if (active) p2i::knn_scan(l, qx, qy, qz, s_pts, n, base, k);
  }
  if (!active) return;
  const size_t row = b * Q + q;
  write_out(l, vals + b * Pp, k, rho, tau, rho_is_2, out + row,
            sel == nullptr ? nullptr : sel + row * k,
            w_norm == nullptr ? nullptr : w_norm + row * k);
}

__global__ void idw_knn_single_kernel(const float4* __restrict__ pts,
                                      const float* __restrict__ vals,
                                      const float* __restrict__ lx,
                                      const float* __restrict__ ly,
                                      const float* __restrict__ lz,
                                      float* __restrict__ out, int Pp, int Q,
                                      int H, int W, int k, float rho, float tau,
                                      int rho_is_2) {
  extern __shared__ float4 s_all[];  // (Pp,): one tile
  knn_forward(pts, vals, lx, ly, lz, out, nullptr, nullptr, s_all, Pp, Pp, Q, H, W,
              k, rho, tau, rho_is_2);
}

__global__ void idw_knn_chunked_kernel(const float4* __restrict__ pts,
                                       const float* __restrict__ vals,
                                       const float* __restrict__ lx,
                                       const float* __restrict__ ly,
                                       const float* __restrict__ lz,
                                       float* __restrict__ out,
                                       int* __restrict__ sel,
                                       float* __restrict__ w_norm, int Pp,
                                       int Q, int H, int W, int k, float rho,
                                       float tau, int rho_is_2) {
  __shared__ float4 s_tile[kTile];
  knn_forward(pts, vals, lx, ly, lz, out, sel, w_norm, s_tile, kTile, Pp, Q, H, W,
              k, rho, tau, rho_is_2);
}

}  // namespace

// pts: (B, Pp, 4) float32 rows (x, y, z, penalty), 16-byte aligned; vals:
// (B, Pp); lx/ly/lz: the grid's (W,), (H,), (D,) coordinates; out: (B, Q),
// Q = D*H*W. Pp <= 4096. Returns a cudaError_t.
extern "C" int p2i_idw_knn_single(const float* pts, const float* vals,
                                  const float* lx, const float* ly,
                                  const float* lz, float* out, int B, int Pp,
                                  int D, int H, int W, int k, float rho,
                                  float tau, int rho_is_2, void* stream) {
  if (k < 1 || k > kKnnMaxK || Pp < 1 || Pp > 4096 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Q = D * H * W;
  const size_t smem = static_cast<size_t>(Pp) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(idw_knn_single_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Q + kThreads - 1) / kThreads, B);
  idw_knn_single_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(pts), vals, lx, ly, lz, out, Pp, Q, H, W, k,
      rho, tau, rho_is_2);
  return static_cast<int>(cudaGetLastError());
}

// As p2i_idw_knn_single for any Pp; sel (B, Q, k) int32 and w_norm (B, Q, k)
// are written when both are non-null.
extern "C" int p2i_idw_knn_chunked(const float* pts, const float* vals,
                                   const float* lx, const float* ly,
                                   const float* lz, float* out, int* sel,
                                   float* w_norm, int B, int Pp, int D, int H,
                                   int W, int k, float rho, float tau,
                                   int rho_is_2, void* stream) {
  if (k < 1 || k > kKnnMaxK || Pp < 1 || B < 1 || ((sel == nullptr) != (w_norm == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Q = D * H * W;
  dim3 grid((Q + kThreads - 1) / kThreads, B);
  idw_knn_chunked_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(pts), vals, lx, ly, lz, out, sel, w_norm, Pp,
      Q, H, W, k, rho, tau, rho_is_2);
  return static_cast<int>(cudaGetLastError());
}
