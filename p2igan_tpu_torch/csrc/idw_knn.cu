// Generic IDW k-NN forward, single pass: every query of the (D, H, W) grid
// takes its k nearest of a sample's points (by the f32 sqrt distance, lowest
// index on ties) and writes their inverse-distance-weighted mean. B samples a
// launch, the sample on grid.y, one thread per query.
//
// idw_knn_single_kernel replaces p2igan_tpu/ops/pallas/idw_kernel.py::
// _idw_forward_single (P <= 4096): one tile holds the sample's padded points
// (x, y, z, penalty) in dynamic shared memory, 16 bytes a point, 64 KB at
// Pp = 4096; each query's top-k runs over it in registers, and a query reads
// its k selected values from device memory. (The tiled forward for any P,
// #9, is a search over cells of points: idw_knn_cells.cu.)
//
// Bound on the H100: operations. Every (query, point) pair costs 9 + 3k
// float32 operations by the TPU kernels' cost model and one correctly rounded
// square root: Q*P pairs a sample (8.4e8 at Q = 262144, P = 3200). The
// bytes are small (the points once a block, through shared memory). The
// design keeps the pair loop to one broadcast shared-memory load, the
// distance, the square root and one compare against the k-th entry; an
// insertion into the register list is rare once the list holds near points.
//
// Rounding: every step is round-to-nearest with no FMA contraction (see
// idw_knn.cuh), and the weights, sums and division follow the plain PyTorch
// version's order, so the output equals it bit for bit.

#include <cuda_runtime.h>

#include "idw_knn.cuh"

namespace {

using p2i::kKnnMaxK;

constexpr int kThreads = 256;  // queries a block

// Sample blockIdx.y's Pp points pass through s_pts in tiles of `tile` points;
// then each query writes its weighted mean (and selection).
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
  p2i::knn_write_out(l, vals + b * Pp, k, rho, tau, rho_is_2, out + row,
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
