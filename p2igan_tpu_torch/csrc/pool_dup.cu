// 2x2 max pool followed by consecutive channel duplication, NCHW.
//
// Replaces p2igan_tpu/ops/pallas/pool_dup.py::maxpool2_duplicate_pallas
// (_pool_dup_kernel). out[n, 2c + j, y, x] = max of x[n, c, 2y:2y+2, 2x:2x+2]
// for j in {0, 1}: the reference DownsampleDuplicateChannels.
//
// The TPU kernel interleaves the duplicated channels with a (C, 2C) one-hot
// matmul on the MXU because a lane-dim interleave does not lower there. In NCHW
// a duplicated channel is a whole output plane, so each thread writes its maxima
// to two planes with plain stores.
//
// Bound on the H100: memory bandwidth -- every input element is read once and
// half as many elements are written; there is no arithmetic beyond the
// compares. The design keeps the index arithmetic out of the way of the
// memory traffic: a 3-D grid (column groups on x, output rows on y, the (n, c)
// plane on z, split over x's spare range when N*C exceeds 65535) gives every
// thread its row and plane without a division, all offsets are 32-bit within a
// plane, and the plane's base is one 64-bit product. A block is 256 threads:
// up to 32 column groups by as many rows as the plane has, and, where planes
// are small, several planes (blockDim.z). Where the row allows it
// (W % 4 == 0 and a 16-byte aligned input), a thread reads a float4 from each
// of the two input rows and writes two outputs to each duplicated plane as a
// float2; otherwise it reads a float2 from each row and writes one output to
// each plane (the 8-byte form, same kernel).
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

__device__ __forceinline__ float window_max(float a, float b, float c, float d) {
  float m = -INFINITY;
  m = take_max(m, a);
  m = take_max(m, b);
  m = take_max(m, c);
  m = take_max(m, d);
  return m;
}

// grid: x = column-group blocks (times the plane split), y = output-row
// blocks, z = plane blocks / split. A thread covers 2 (with float4 loads) or 1
// output columns of one output row of one (n, c) plane.
template <bool kVec4>
__global__ void pool_dup_kernel(const float* __restrict__ x, float* __restrict__ out,
                                int C, int H, int W, int groups, int gx_blocks,
                                int NC) {
  const int gx = blockIdx.x % gx_blocks;  // 32-bit, once a block
  const int split = blockIdx.x / gx_blocks;
  const int nc = (split * gridDim.z + blockIdx.z) * blockDim.z + threadIdx.z;
  const int g = gx * blockDim.x + threadIdx.x;
  const int yo = blockIdx.y * blockDim.y + threadIdx.y;
  const int Ho = H >> 1;
  const int Wo = W >> 1;
  if (nc >= NC || g >= groups || yo >= Ho) return;
  const int n = nc / C;  // once a thread, 32-bit
  const int c = nc - n * C;
  const float* src = x + static_cast<size_t>(nc) * H * W + (2 * yo) * W;
  const size_t plane_out = static_cast<size_t>(Ho) * Wo;
  float* dst = out + (static_cast<size_t>(n) * 2 * C + 2 * c) * plane_out + yo * Wo;
  if (kVec4) {
    const float4 a = *reinterpret_cast<const float4*>(src + 4 * g);
    const float4 b = *reinterpret_cast<const float4*>(src + W + 4 * g);
    const float2 m = make_float2(window_max(a.x, a.y, b.x, b.y),
                                 window_max(a.z, a.w, b.z, b.w));
    *reinterpret_cast<float2*>(dst + 2 * g) = m;
    *reinterpret_cast<float2*>(dst + plane_out + 2 * g) = m;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(src + 2 * g);
    const float2 b = *reinterpret_cast<const float2*>(src + W + 2 * g);
    const float m = window_max(a.x, a.y, b.x, b.y);
    dst[g] = m;
    dst[plane_out + g] = m;
  }
}

}  // namespace

// x (N, C, H, W) float32, 8-byte aligned, H and W even; out (N, 2C, H/2, W/2),
// 8-byte aligned. Returns a cudaError_t.
extern "C" int p2i_maxpool2_duplicate(const float* x, float* out, int N, int C,
                                      int H, int W, void* stream) {
  if (N < 1 || C < 1 || H < 2 || W < 2 || (H | W) & 1 ||
      reinterpret_cast<uintptr_t>(x) % 8 || reinterpret_cast<uintptr_t>(out) % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int groups = vec4 ? W / 4 : W / 2;  // threads a row
  int bx = 1;
  while (bx < groups && bx < 32) bx <<= 1;
  const int Ho = H / 2;
  int by = 1;
  while (by < Ho && bx * by < 256) by <<= 1;
  const int bz = min(64, 256 / (bx * by));  // blockDim.z <= 64
  const int gx_blocks = (groups + bx - 1) / bx;
  const int NC = N * C;
  const int z_blocks = (NC + bz - 1) / bz;
  const int split = (z_blocks + 65534) / 65535;  // plane blocks beyond grid.z's limit
  const dim3 block(bx, by, bz);
  const dim3 grid(gx_blocks * split, (Ho + by - 1) / by, (z_blocks + split - 1) / split);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    pool_dup_kernel<true><<<grid, block, 0, s>>>(x, out, C, H, W, groups, gx_blocks, NC);
  } else {
    pool_dup_kernel<false><<<grid, block, 0, s>>>(x, out, C, H, W, groups, gx_blocks, NC);
  }
  return static_cast<int>(cudaGetLastError());
}
