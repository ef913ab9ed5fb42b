// Fused uint8 decode -> [0, 1] normalize -> mask multiply.
//
// Replaces p2igan_tpu/ops/pallas/decode_mask.py::decode_normalize_mask
// (_decode_kernel). frames (B, T, plane) uint8 and a mask that is either
// full-shape or frame-constant (B, 1, plane), uint8 or float32, become
// video = u8 / 255 and masked = video * mask, both float32. A frame-constant
// mask is read once per sample and broadcast over T here, never materialized,
// as the TPU kernel's block index map does.
//
// Bound on the H100: bytes. One byte in, eight out per element (3.1 MB read,
// 25 MB written for a (12, 16, 128, 128, 1) batch), so the kernel is a single
// pass with 4 elements a thread (a 4-byte load, two 16-byte stores) where the
// plane is a multiple of 4, and one element a thread otherwise.
//
// Rounding: the division is __fdiv_rn (correctly rounded) and the product
// __fmul_rn, so both outputs equal the host pipeline's numpy
// `u8.astype(np.float32) / 255.0` and `video * mask` bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename M>
struct Vec4;
template <>
struct Vec4<uint8_t> {
  using T = uchar4;
};
template <>
struct Vec4<float> {
  using T = float4;
};

__device__ __forceinline__ float decode(unsigned char u) {
  return __fdiv_rn(static_cast<float>(u), 255.0f);
}

// i: element index; plane: elements per frame; T: frames per sample.
template <bool kFrameConst>
__device__ __forceinline__ int64_t mask_index(int64_t i, int64_t plane, int T) {
  return kFrameConst ? (i / (T * plane)) * plane + i % plane : i;
}

template <typename M, bool kFrameConst>
__global__ void decode4_kernel(const uchar4* __restrict__ u8,
                               const M* __restrict__ mask,
                               float4* __restrict__ video,
                               float4* __restrict__ masked, int64_t n4,
                               int64_t plane4, int T) {
  using MV = typename Vec4<M>::T;
  const MV* mask4 = reinterpret_cast<const MV*>(mask);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const uchar4 u = u8[i];
    const MV m = mask4[mask_index<kFrameConst>(i, plane4, T)];
    float4 v, o;
    v.x = decode(u.x);
    v.y = decode(u.y);
    v.z = decode(u.z);
    v.w = decode(u.w);
    o.x = __fmul_rn(v.x, static_cast<float>(m.x));
    o.y = __fmul_rn(v.y, static_cast<float>(m.y));
    o.z = __fmul_rn(v.z, static_cast<float>(m.z));
    o.w = __fmul_rn(v.w, static_cast<float>(m.w));
    video[i] = v;
    masked[i] = o;
  }
}

template <typename M, bool kFrameConst>
__global__ void decode1_kernel(const uint8_t* __restrict__ u8,
                               const M* __restrict__ mask,
                               float* __restrict__ video,
                               float* __restrict__ masked, int64_t n,
                               int64_t plane, int T) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float v = decode(u8[i]);
    video[i] = v;
    masked[i] = __fmul_rn(v, static_cast<float>(mask[mask_index<kFrameConst>(i, plane, T)]));
  }
}

template <typename M, bool kFrameConst>
void launch(const void* u8, const void* mask, float* video, float* masked,
            int64_t n, int64_t plane, int T, int vec4, cudaStream_t s) {
  const int threads = 256;
  const int64_t items = vec4 ? n / 4 : n;
  const int64_t blocks64 = (items + threads - 1) / threads;
  const int blocks = static_cast<int>(blocks64 < 65535 ? blocks64 : 65535);
  if (vec4) {
    decode4_kernel<M, kFrameConst><<<blocks, threads, 0, s>>>(
        static_cast<const uchar4*>(u8), static_cast<const M*>(mask),
        reinterpret_cast<float4*>(video), reinterpret_cast<float4*>(masked),
        n / 4, plane / 4, T);
  } else {
    decode1_kernel<M, kFrameConst><<<blocks, threads, 0, s>>>(
        static_cast<const uint8_t*>(u8), static_cast<const M*>(mask), video,
        masked, n, plane, T);
  }
}

}  // namespace

// n: elements of frames; plane: elements per frame (H*W*C); T: frames per
// sample; mask_is_f32: float32 mask (else uint8); frame_const: mask is
// (B, 1, plane); vec4: n and plane are multiples of 4 and every pointer is
// aligned for the 4-element loads and stores. Returns a cudaError_t.
extern "C" int p2i_decode_normalize_mask(const void* u8, const void* mask,
                                         float* video, float* masked,
                                         long long n, long long plane, int T,
                                         int mask_is_f32, int frame_const,
                                         int vec4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask_is_f32) {
    if (frame_const) {
      launch<float, true>(u8, mask, video, masked, n, plane, T, vec4, s);
    } else {
      launch<float, false>(u8, mask, video, masked, n, plane, T, vec4, s);
    }
  } else {
    if (frame_const) {
      launch<uint8_t, true>(u8, mask, video, masked, n, plane, T, vec4, s);
    } else {
      launch<uint8_t, false>(u8, mask, video, masked, n, plane, T, vec4, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
