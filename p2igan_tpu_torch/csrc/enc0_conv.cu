// 3x3x3 SAME convolution from a few input channels to many, fused with the
// bias and LeakyReLU: the first block of the simple generator in serving,
// after its BatchNorm has been folded into the weights.
//
// Replaces p2igan_tpu/ops/pallas/enc0_conv.py::_enc0_pallas (enc0_conv3d_leaky).
//
//   out[b, co, t, h, w] = leaky( bias[co] + sum_{dt,dy,dx,ci}
//        x[b, t+dt-1, h+dy-1, w+dx-1, ci] * wgt[dt, dy, dx, ci, co] )
//
// with zeros outside [0,T) x [0,H) x [0,W): t is padded per window b, a
// neighbouring window's frame never enters. x is channels-last
// (B, T, H, W, CIN), as the concatenated (masked, mask) frames arrive; the
// output is channels-first (B, Cout, T, H, W), the layout in which cuDNN takes
// it for the next convolution without a copy.
//
// The TPU kernel builds a (27*Cin, HW) tap matrix from lane-shifted planes in
// VMEM and hands it to the MXU. Here the contraction is only 27*CIN = 54 deep,
// too shallow for tensor cores to pay, and float32 is wanted anyway, so it is
// a register-tiled FMA loop. A thread holds 2 rows x 4 pixels x 8 output
// channels; its pixels lie 32 columns apart (lane tx owns columns tx + 32 p),
// so a warp's load of one pixel's channels is one contiguous 8-byte-a-lane
// load and its stores are coalesced. Each tap and input channel costs a
// thread 8 words of x and 8 of weights from shared memory for 64 FMAs, which
// keeps the shared-memory pipe level with the FMA pipe (PERF.md, #14's stage
// table: a thread's words a tap set the kernel's speed).
//
// A block owns a 16x128 pixel tile of one window b and walks its frames t in
// order (a span of them where the batch has too few tiles for one block an
// SM). It loads the weights and the bias into shared memory once, and keeps a
// ring of kStages = 4 haloed input slices: slices t-1, t, t+1 in use while
// slice t+2 arrives by cp.async, so each slice is fetched once a tile instead
// of three times, and its copy hides under a frame's FMAs. The slices at
// t = -1 and t = T are zeros (cp.async zero-fill, nothing read), never a
// neighbouring window's frame. A slice is kept channels-last as it lies in
// memory: a haloed row is the contiguous floats of pixels w0-1 .. w0+128, so
// where W * CIN % 4 == 0 (and x is 16-byte aligned) a thread's copies are
// 16-byte chunks, with the parts outside the plane zero-filled; otherwise a
// 4-byte copy an element.
//
// Summation order, fixed for every layout of the work: acc = bias, then fmaf
// over dt, dy, dx, ci ascending, then the leaky relu; the earlier one-frame-a-
// block design summed so too, and the outputs are bitwise the same as its.
//
// Bound on the H100: operations at the serving width (CIN 2 -> 64: 6912 flops
// for every 256 output bytes), with the output write close behind (537 MB at
// the serving chunk: at the full FMA rate the kernel writes 2.5 TB/s).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;       // thread columns
constexpr int kPX = 4;           // pixels a thread along a row, kLanes columns apart
constexpr int kTW = kLanes * kPX;  // tile width
constexpr int kTY = 8;           // thread rows
constexpr int kTH = 2 * kTY;     // tile height: a thread owns rows ty and ty + 8
constexpr int kPH = kTH + 2;     // haloed rows
constexpr int kCC = 8;           // output channels a pass: 2 x kPX x kCC accumulators
constexpr int kCoutPad = 32;     // the weights' output channels are padded to this
constexpr int kThreads = kLanes * kTY;
constexpr int kStages = 4;       // ring slots: three slices in use, one arriving
constexpr int kCol0 = 4;         // float of a row's tile column 0 (chunk-aligned)

// A ring slot: kPH rows of the floats of global row offsets w0*CIN - 4 ..
// (w0 + kTW)*CIN + 4, so tile column j, channel ci is float kCol0 + j*CIN + ci
// (j = -1 .. kTW) and 16-byte chunks of the row are 16-byte chunks in memory.
template <int CIN>
struct Slot {
  static constexpr int kPitch = kTW * CIN + 8;        // floats a row
  static constexpr int kChunksRow = kPitch / 4;
  static constexpr int kChunks = kPH * kChunksRow;
  static constexpr int kRounds = (kChunks + kThreads - 1) / kThreads;
  static constexpr int kFloats = kPH * kPitch;
  static constexpr int kUsed = (kTW + 2) * CIN;       // floats of a row read, from j = -1
};

// Start the copy of one haloed slice into ``slot``: the slice's plane, or
// nullptr for a slice outside the window (zeros). kVec: W * CIN % 4 == 0 and
// x 16-byte aligned, so a row's floats are 16-byte chunks in memory; thread
// tid copies chunks tid, tid + 256, ..., each whole inside the plane or whole
// outside it (zero-filled). Otherwise a 4-byte copy an element. The plan is a
// few integer operations a copy, recomputed a slice so that it holds no
// registers across the frame's FMAs.
template <int CIN, bool kVec>
__device__ __forceinline__ void load_slice(float* slot, const float* __restrict__ x,
                                           const float* slice, int tid, int H, int W,
                                           int h0, int w0) {
  using S = Slot<CIN>;
  if (kVec) {
#pragma unroll
    for (int m = 0; m < S::kRounds; ++m) {
      const int c = tid + m * kThreads;
      if (c >= S::kChunks) break;
      const int row = c / S::kChunksRow, k = c - row * S::kChunksRow;
      const int h = h0 + row - 1, g = w0 * CIN - kCol0 + 4 * k;
      const bool in = slice != nullptr && h >= 0 && h < H && g >= 0 && g + 4 <= W * CIN;
      __pipeline_memcpy_async(slot + row * S::kPitch + 4 * k, in ? slice + h * W * CIN + g : x,
                              16, in ? 0 : 16);
    }
  } else {
    for (int e = tid; e < kPH * S::kUsed; e += kThreads) {
      const int row = e / S::kUsed, f = e - row * S::kUsed;
      const int h = h0 + row - 1, g = (w0 - 1) * CIN + f;
      const bool in = slice != nullptr && h >= 0 && h < H && g >= 0 && g < W * CIN;
      __pipeline_memcpy_async(slot + row * S::kPitch + kCol0 - CIN + f,
                              in ? slice + h * W * CIN + g : x, 4, in ? 0 : 4);
    }
  }
}

// The CIN channels of one pixel of a slot row.
template <int CIN>
__device__ __forceinline__ void load_pixel(const float* p, float* v) {
  if constexpr (CIN == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else if constexpr (CIN == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci) v[ci] = p[ci];
  }
}

// One block an SM: 255 registers a thread leave the 64 accumulators and the
// loads in flight room without spills.
template <int CIN, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
enc0_kernel(const float* __restrict__ x, const float* __restrict__ wgt,
            const float* __restrict__ bias, float* __restrict__ out, int T, int H,
            int W, int Cout, int coutPad, float slope, int tilesX, int tilesY,
            int splits, int span) {
  using S = Slot<CIN>;
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                       // [27 * CIN][coutPad]
  float* sb = sw + 27 * CIN * coutPad;    // [coutPad]
  float* ring = sb + coutPad;             // [kStages][kPH][kPitch]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kLanes + tx;
  int bid = blockIdx.x;
  const int part = bid % splits;
  bid /= splits;
  const int txi = bid % tilesX;
  bid /= tilesX;
  const int tyi = bid % tilesY;
  const int b = bid / tilesY;
  const int t_lo = part * span, t_hi = min(T, t_lo + span);  // never empty: see launch
  const int h0 = tyi * kTH, w0 = txi * kTW;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const float* xb = x + static_cast<int64_t>(b) * T * plane * CIN;
  auto load = [&](int s) {
    load_slice<CIN, kVec>(ring + ((s + kStages) & (kStages - 1)) * S::kFloats, x,
                          s >= 0 && s < T ? xb + s * plane * CIN : nullptr, tid, H, W, h0,
                          w0);
  };

  // the first frame's three slices, then the weights with plain loads
  for (int s = t_lo - 1; s <= t_lo + 1; ++s) load(s);
  __pipeline_commit();
  for (int i = tid; i < 27 * CIN * coutPad; i += kThreads) {
    const int row = i / coutPad, co = i - row * coutPad;
    sw[i] = co < Cout ? wgt[row * Cout + co] : 0.f;
  }
  for (int i = tid; i < coutPad; i += kThreads) sb[i] = i < Cout ? bias[i] : 0.f;

  const int h_a = h0 + ty, h_b = h_a + kTY, w_ = w0 + tx;  // pixel p: column w_ + 32 p
  for (int t = t_lo; t < t_hi; ++t) {
    // slice t + 1 has landed for every thread, and every thread is done with
    // frame t - 1, whose slot (slice t - 2) the next copy overwrites
    __pipeline_wait_prior(0);
    __syncthreads();
    if (t + 2 <= t_hi) load(t + 2);
    __pipeline_commit();

#pragma unroll 1
    for (int c0 = 0; c0 < Cout; c0 += kCC) {
      float acc[2][kPX][kCC];
#pragma unroll
      for (int k = 0; k < kCC; ++k) {
#pragma unroll
        for (int p = 0; p < kPX; ++p) acc[0][p][k] = acc[1][p][k] = sb[c0 + k];
      }
#pragma unroll 1
      for (int dt = 0; dt < 3; ++dt) {
        // row ty of slice t + dt - 1, tile column tx - 1
        const float* sl = ring + ((t + dt - 1 + kStages) & (kStages - 1)) * S::kFloats +
                          ty * S::kPitch + kCol0 + (tx - 1) * CIN;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            float xv[2][kPX * CIN];
#pragma unroll
            for (int p = 0; p < kPX; ++p) {
              load_pixel<CIN>(sl + dy * S::kPitch + (dx + kLanes * p) * CIN, xv[0] + p * CIN);
              load_pixel<CIN>(sl + (dy + kTY) * S::kPitch + (dx + kLanes * p) * CIN,
                              xv[1] + p * CIN);
            }
#pragma unroll
            for (int ci = 0; ci < CIN; ++ci) {
              const float4* w4 = reinterpret_cast<const float4*>(
                  sw + (((dt * 3 + dy) * 3 + dx) * CIN + ci) * coutPad + c0);
#pragma unroll
              for (int q = 0; q < kCC / 4; ++q) {
                const float4 w = w4[q];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
#pragma unroll
                  for (int p = 0; p < kPX; ++p) {
                    const float xr = xv[r][p * CIN + ci];
                    acc[r][p][4 * q + 0] = fmaf(xr, w.x, acc[r][p][4 * q + 0]);
                    acc[r][p][4 * q + 1] = fmaf(xr, w.y, acc[r][p][4 * q + 1]);
                    acc[r][p][4 * q + 2] = fmaf(xr, w.z, acc[r][p][4 * q + 2]);
                    acc[r][p][4 * q + 3] = fmaf(xr, w.w, acc[r][p][4 * q + 3]);
                  }
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kCC; ++k) {
        const int co = c0 + k;
        if (co >= Cout) break;
        float* po = out + ((static_cast<int64_t>(b) * Cout + co) * T + t) * plane + w_;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int h = r ? h_b : h_a;
          if (h >= H) continue;
          float* row = po + static_cast<int64_t>(h) * W;
#pragma unroll
          for (int p = 0; p < kPX; ++p) {
            const float y = acc[r][p][k];
            if (w_ + kLanes * p < W) row[kLanes * p] = fmaxf(y, slope * y);
          }
        }
      }
    }
  }
}

template <int CIN>
size_t shared_bytes(int coutPad) {
  return sizeof(float) * (static_cast<size_t>(27 * CIN + 1) * coutPad +
                          static_cast<size_t>(kStages) * Slot<CIN>::kFloats);
}

template <int CIN, bool kVec>
int launch(const float* x, const float* wgt, const float* bias, float* out, int B,
           int T, int H, int W, int Cout, float slope, cudaStream_t stream) {
  const int coutPad = (Cout + kCoutPad - 1) / kCoutPad * kCoutPad;
  const size_t shared = shared_bytes<CIN>(coutPad);
  if (shared > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(enc0_kernel<CIN, kVec>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(shared));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int device = 0, sms = 0;
  if ((rc = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(rc);
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int tilesX = (W + kTW - 1) / kTW, tilesY = (H + kTH - 1) / kTH;
  const int64_t tiles = static_cast<int64_t>(B) * tilesX * tilesY;
  // split each window's frames into spans only where the tiles alone leave
  // SMs without a block
  const int64_t want = static_cast<int64_t>(sms) / tiles;
  const int splits_max = static_cast<int>(want < 1 ? 1 : want < T ? want : T);
  const int span = (T + splits_max - 1) / splits_max;
  const int splits = (T + span - 1) / span;  // so (splits - 1) * span < T
  const int64_t blocks = tiles * splits;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  enc0_kernel<CIN, kVec><<<static_cast<unsigned>(blocks), dim3(kLanes, kTY), shared,
                           stream>>>(x, wgt, bias, out, T, H, W, Cout, coutPad, slope,
                                     tilesX, tilesY, splits, span);
  return static_cast<int>(cudaGetLastError());
}

template <int CIN>
int launch_cin(const float* x, const float* wgt, const float* bias, float* out, int B,
               int T, int H, int W, int Cout, float slope, cudaStream_t s) {
  if (W * CIN % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch<CIN, true>(x, wgt, bias, out, B, T, H, W, Cout, slope, s);
  return launch<CIN, false>(x, wgt, bias, out, B, T, H, W, Cout, slope, s);
}

}  // namespace

// x (B, T, H, W, Cin) channels-last, wgt (3, 3, 3, Cin, Cout), bias (Cout),
// out (B, Cout, T, H, W); Cin in 1..4.
extern "C" int p2i_enc0_conv3d_leaky(const float* x, const float* wgt, const float* bias,
                                     float* out, int B, int T, int H, int W, int Cin,
                                     int Cout, float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Cin) {
    case 1: return launch_cin<1>(x, wgt, bias, out, B, T, H, W, Cout, slope, s);
    case 2: return launch_cin<2>(x, wgt, bias, out, B, T, H, W, Cout, slope, s);
    case 3: return launch_cin<3>(x, wgt, bias, out, B, T, H, W, Cout, slope, s);
    case 4: return launch_cin<4>(x, wgt, bias, out, B, T, H, W, Cout, slope, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
