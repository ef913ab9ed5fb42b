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
//
// The kernel is a template on the element type: float32, and bfloat16 for the
// generator's bf16 compute dtype (the JAX package sends a bf16 pyramid to
// XLA's max pool; here it stays on this kernel). As in PyTorch's own pool, a
// bf16 element is compared as the float it widens to exactly, and the element
// chosen is stored as it is, NaN payloads included (PyTorch 2.11 keeps them:
// measured on the H100), so a max stays exact in either type. The bf16 form
// moves half the bytes: its vector form reads 8 bytes (4 elements) from each
// of the two rows and writes 4 bytes (2 outputs) to each duplicated plane;
// its narrow form reads 4 bytes a row and writes one 2-byte output a plane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// n elements of T loaded or stored as one access of n * sizeof(T) bytes
template <typename T, int n>
struct alignas(sizeof(T) * n) Vec {
  T v[n];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T take_max(T m, T v) {
  const float fv = widen(v);
  return (fv > widen(m) || isnan(fv)) ? v : m;
}

template <typename T>
__device__ __forceinline__ T window_max(T a, T b, T c, T d) {
  // PyTorch starts from -inf and takes a unless it is -inf itself: the same
  // bits either way, so start from a
  T m = a;
  m = take_max(m, b);
  m = take_max(m, c);
  m = take_max(m, d);
  return m;
}

// grid: x = column-group blocks (times the plane split), y = output-row
// blocks, z = plane blocks / split. A thread covers 2 (with the 4-element
// loads) or 1 output columns of one output row of one (n, c) plane.
template <typename T, bool kVec4>
__global__ void pool_dup_kernel(const T* __restrict__ x, T* __restrict__ out,
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
  const T* src = x + static_cast<size_t>(nc) * H * W + (2 * yo) * W;
  const size_t plane_out = static_cast<size_t>(Ho) * Wo;
  T* dst = out + (static_cast<size_t>(n) * 2 * C + 2 * c) * plane_out + yo * Wo;
  if (kVec4) {
    const Vec<T, 4> a = *reinterpret_cast<const Vec<T, 4>*>(src + 4 * g);
    const Vec<T, 4> b = *reinterpret_cast<const Vec<T, 4>*>(src + W + 4 * g);
    Vec<T, 2> m;
    m.v[0] = window_max(a.v[0], a.v[1], b.v[0], b.v[1]);
    m.v[1] = window_max(a.v[2], a.v[3], b.v[2], b.v[3]);
    *reinterpret_cast<Vec<T, 2>*>(dst + 2 * g) = m;
    *reinterpret_cast<Vec<T, 2>*>(dst + plane_out + 2 * g) = m;
  } else {
    const Vec<T, 2> a = *reinterpret_cast<const Vec<T, 2>*>(src + 2 * g);
    const Vec<T, 2> b = *reinterpret_cast<const Vec<T, 2>*>(src + W + 2 * g);
    const T m = window_max(a.v[0], a.v[1], b.v[0], b.v[1]);
    dst[g] = m;
    dst[plane_out + g] = m;
  }
}

template <typename T>
int launch(const T* x, T* out, int N, int C, int H, int W, void* stream) {
  const uintptr_t pair = 2 * sizeof(T);  // the narrow form's access
  if (N < 1 || C < 1 || H < 2 || W < 2 || (H | W) & 1 ||
      reinterpret_cast<uintptr_t>(x) % pair || reinterpret_cast<uintptr_t>(out) % pair) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (2 * pair) == 0;
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
    pool_dup_kernel<T, true><<<grid, block, 0, s>>>(x, out, C, H, W, groups, gx_blocks, NC);
  } else {
    pool_dup_kernel<T, false><<<grid, block, 0, s>>>(x, out, C, H, W, groups, gx_blocks, NC);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, C, H, W) float32, 8-byte aligned, H and W even; out (N, 2C, H/2, W/2),
// 8-byte aligned. Returns a cudaError_t.
extern "C" int p2i_maxpool2_duplicate(const float* x, float* out, int N, int C,
                                      int H, int W, void* stream) {
  return launch(x, out, N, C, H, W, stream);
}

// The same on bfloat16: x and out 4-byte aligned.
extern "C" int p2i_maxpool2_duplicate_bf16(const void* x, void* out, int N, int C,
                                           int H, int W, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
                N, C, H, W, stream);
}
