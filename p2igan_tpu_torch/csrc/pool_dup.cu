// 2x2 max pool followed by consecutive channel duplication, NCHW.
//
// Replaces p2igan_tpu/ops/pallas/pool_dup.py::maxpool2_duplicate_pallas
// (_pool_dup_kernel). out[n, 2c + j, y, x] = max of x[n, c, 2y:2y+2, 2x:2x+2]
// for j in {0, 1}: the reference DownsampleDuplicateChannels.
//
// The TPU kernel interleaves the duplicated channels with a (C, 2C) one-hot
// matmul on the MXU because a lane-dim interleave does not lower there. In NCHW
// a duplicated channel is a whole output plane, so each thread writes its max to
// two planes with plain stores.
//
// Bound on the H100: memory bandwidth -- every input element is read once
// (two 8-byte loads per thread, neighbouring threads on neighbouring
// addresses) and half as many elements are written; there is no arithmetic
// beyond three compares.
//
// The compares follow PyTorch's max_pool2d (window in row-major order, replace
// when greater or NaN, starting from -inf), so the output is bitwise equal to
// F.max_pool2d + repeat_interleave, including NaN and signed-zero cases.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float take_max(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

__global__ void pool_dup_kernel(const float* __restrict__ x, float* __restrict__ out,
                                int C, int H, int W, int64_t total) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int Ho = H / 2;
  const int Wo = W / 2;
  const int xo = static_cast<int>(i % Wo);
  const int64_t r = i / Wo;
  const int yo = static_cast<int>(r % Ho);
  const int64_t nc = r / Ho;  // n * C + c
  const float* src = x + (nc * H + 2 * yo) * static_cast<int64_t>(W) + 2 * xo;
  const float2 a = *reinterpret_cast<const float2*>(src);
  const float2 b = *reinterpret_cast<const float2*>(src + W);
  float m = -INFINITY;
  m = take_max(m, a.x);
  m = take_max(m, a.y);
  m = take_max(m, b.x);
  m = take_max(m, b.y);
  const int64_t n = nc / C;
  const int64_t c = nc - n * C;
  const int64_t hw = static_cast<int64_t>(Ho) * Wo;
  const int64_t o = ((n * 2 * C + 2 * c) * Ho + yo) * Wo + xo;
  out[o] = m;
  out[o + hw] = m;
}

}  // namespace

extern "C" int p2i_maxpool2_duplicate(const float* x, float* out, int N, int C,
                                      int H, int W, void* stream) {
  const int64_t total = static_cast<int64_t>(N) * C * (H / 2) * (W / 2);
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  pool_dup_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, out, C, H, W, total);
  return static_cast<int>(cudaGetLastError());
}
