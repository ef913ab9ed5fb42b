// Fused DK/STDK MLP tail, forward:
//   out[j, p] = fc4 . relu(fc3^T relu(fc2^T relu(phi[p] + off[j]) + b2) + b3) + b4
// for every row j = (b, t) of the hidden offsets and every pixel p.
//
// Replaces p2igan_tpu/ops/pallas/dk_mlp_kernel.py::_mlp_tail_pallas (_kernel).
// The TPU kernel walks a grid (pixel tiles outer, j chunks inner) in order and
// relies on phi staying resident over the inner axis. Here a block owns one
// tile of 128 pixels and loops over j inside: the phi tile is read from device
// memory once, transposed into shared memory, and both (h, h) weight matrices
// stay in shared memory beside it (80 KB at h = 100, so the launcher opts in
// to dynamic shared memory above 48 KB). Per j the block runs two tile
// products (dk_mlp_tile.cuh): relu(phi + off[j]) is formed on the fly as the
// first product's A operand, its relu output goes to a second shared tile, and
// the second product's output never leaves registers: relu, the dot with fc4
// and a fixed-order sum over the 13 column owners give 128 outputs, stored
// coalesced. Nothing of size (J, HW, h) touches device memory.
//
// Bound on the H100: operations. J * HW * (4 h^2 + 4 h) flops (1.27e11 at
// J = 192, HW = 16384, h = 100) against 67 TFLOP/s float32; the bytes (phi
// 6.6 MB in, out 12.6 MB) are negligible. The hidden width is not padded: the
// thread grid covers 104 columns, so 4% of the products are duplicates.
// This first version reads its operands with scalar shared loads (16 loads per
// 64 FMAs and thread), which caps it near half of the FMA rate; wider loads
// and tensor cores (a precision-policy change) are later work.

#include <cuda_runtime.h>

#include "dk_mlp_tile.cuh"

namespace {

using namespace dkmlp;

constexpr int kRows = 128;             // pixels per block
constexpr int kRS = kRows + 4;         // row stride of the (h, kRows) tiles
constexpr int kRedS = kRows + 1;       // row stride of the fc4 partial sums
constexpr int kTM = kRows / kTY;       // 8 rows a thread

__global__ void __launch_bounds__(kThreads, 1)
dk_mlp_tail_kernel(const float* __restrict__ phi, const float* __restrict__ off,
                   const float* __restrict__ fc2, const float* __restrict__ b2,
                   const float* __restrict__ fc3, const float* __restrict__ b3,
                   const float* __restrict__ fc4, const float* __restrict__ b4,
                   float* __restrict__ out, int HW, int J, int h) {
  extern __shared__ float smem[];
  float* fc2s = smem;                  // (h, h) as (in, out)
  float* fc3s = fc2s + h * h;
  float* X = fc3s + h * h;             // phi tile, X[k * kRS + r]
  float* Y = X + h * kRS;              // relu(layer 2), Y[n * kRS + r]
  float* red = Y + h * kRS;            // (kTX, kRedS) fc4 partial sums
  float* b2s = red + kTX * kRedS;
  float* b3s = b2s + h;
  float* fc4s = b3s + h;
  float* offs = fc4s + h;              // (2, h): this row's offsets, the next's

  const int tid = threadIdx.x;
  const int ty = tid / kTX;
  const int tx = tid - ty * kTX;
  const int p0 = blockIdx.x * kRows;

  load_vec(fc2s, fc2, h * h);
  load_vec(fc3s, fc3, h * h);
  load_vec(b2s, b2, h);
  load_vec(b3s, b3, h);
  load_vec(fc4s, fc4, h);
  load_vec(offs, off, h);
  for (int e = tid; e < kRows * h; e += kThreads) {
    const int r = e / h;
    const int k = e - r * h;
    const int p = p0 + r;
    X[k * kRS + r] = p < HW ? phi[static_cast<size_t>(p) * h + k] : 0.0f;
  }
  const float bias4 = b4[0];
  __syncthreads();

  for (int j = 0; j < J; ++j) {
    const float* offj = offs + (j & 1) * h;
    // the other half of offs was last read by the previous row's first product
    if (j + 1 < J) {
      load_vec(offs + ((j + 1) & 1) * h, off + static_cast<size_t>(j + 1) * h, h);
    }
    float acc[kTM][kTN];
    tile_gemm<kTM, kTN, true>(acc, X, 1, kRS, fc2s, h, 1, kRows, h, h, ty, tx, offj);
#pragma unroll
    for (int jn = 0; jn < kTN; ++jn) {
      const int n = tx + kTX * jn;
      if (n < h) {
        const float bb = b2s[n];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          Y[n * kRS + ty + kTY * i] = fmaxf(acc[i][jn] + bb, 0.0f);
        }
      }
    }
    __syncthreads();

    tile_gemm<kTM, kTN, false>(acc, Y, 1, kRS, fc3s, h, 1, kRows, h, h, ty, tx,
                               nullptr);
    float part[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) part[i] = 0.0f;
#pragma unroll
    for (int jn = 0; jn < kTN; ++jn) {
      const int n = tx + kTX * jn;
      if (n < h) {
        const float bb = b3s[n];
        const float w = fc4s[n];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          part[i] = fmaf(fmaxf(acc[i][jn] + bb, 0.0f), w, part[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) red[tx * kRedS + ty + kTY * i] = part[i];
    __syncthreads();

    if (tid < kRows && p0 + tid < HW) {
      float y = bias4;
      for (int t = 0; t < kTX; ++t) y += red[t * kRedS + tid];
      out[static_cast<size_t>(j) * HW + p0 + tid] = y;
    }
  }
}

}  // namespace

// phi (HW, h), off (J, h), fc2/fc3 (h, h) as (in, out), b2/b3/fc4 (h,), b4 one
// float, out (J, HW); all float32, contiguous, on the device. 1 <= h <= 104.
// Returns a cudaError_t.
extern "C" int p2i_dk_mlp_tail(const float* phi, const float* off, const float* fc2,
                               const float* b2, const float* fc3, const float* b3,
                               const float* fc4, const float* b4, float* out,
                               int HW, int J, int h, void* stream) {
  if (h < 1 || h > kMaxHidden || HW < 1 || J < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(2) * h * h + 2 * h * kRS + kTX * kRedS + 5 * h);
  cudaError_t err = cudaFuncSetAttribute(dk_mlp_tail_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (HW + kRows - 1) / kRows;
  dk_mlp_tail_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      phi, off, fc2, b2, fc3, b3, fc4, b4, out, HW, J, h);
  return static_cast<int>(cudaGetLastError());
}
