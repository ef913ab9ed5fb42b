// 3x3x3 SAME convolution from C channels to one, fused with the bias and the
// sigmoid: the last layer of the simple generator in serving.
//
// Replaces p2igan_tpu/ops/pallas/dec2_stencil.py::_dec2_pallas together with the
// shift-align, bias, sigmoid and un-pack epilogue of conv3d_cout1_sigmoid.
//
//   out[b, t, h, w] = sigmoid( bias + sum_{c,dt,dy,dx}
//        x[b, c, t+dt-1, h+dy-1, w+dx-1] * wgt[dt, dy, dx, c] )
//
// with zeros outside [0,T) x [0,H) x [0,W): t is padded per window b. x is
// channels-first (B, C, T, H, W), as cuDNN's transposed convolution leaves it.
//
// The TPU kernel contracts the channels on the MXU into 54 tap planes of
// packed pixel pairs, adds them under lane shifts and leaves the alignment
// over t to an XLA pass. With one output channel there is nothing for a
// matrix unit here; it is a reduction over 27*C = 1728 terms a voxel, done as
// a register-tiled stencil: a block owns a 32x64 output tile of one (b, t) and
// walks the channels; the haloed tile of the three input slices of the next
// channel is copied into shared memory with cp.async (two buffers, no
// registers in between, zeros filled in at the borders) while the current one
// is consumed; a thread keeps a 4x2 patch of outputs in registers, so each
// input value it loads (16 bytes of a row at a time) feeds up to 18 FMAs.
// Weights sit in shared memory, one padded row of 28 a channel, read as
// broadcast float4. The summation order is fixed: channel, dt, dy, dx.
//
// Bound on the H100: bytes -- the C-channel input read once (27 FMAs for every
// 4 bytes is near the card's float32 balance point, so the FMA pipe is close
// behind). Blocks are numbered with t fastest, so the three blocks that read
// one input slice run at about the same time and share it in L2.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;           // thread columns: a warp spans a tile row
constexpr int kTY = 8;               // thread rows
constexpr int kR = 4;                // output rows a thread
constexpr int kTW = 2 * kLanes;      // tile width: 2 columns a thread
constexpr int kTH = kR * kTY;        // tile height
constexpr int kPH = kTH + 2;
constexpr int kCols = kTW + 2;       // haloed row; index 0 holds column -1
constexpr int kPW = kCols + 2;       // row pitch, keeps rows 8-byte aligned
constexpr int kRows = 3 * kPH;       // haloed rows a channel: three slices
constexpr int kStage = kRows * kPW;  // floats a buffer
constexpr int kWRow = 28;            // 27 weights a channel, padded to float4s
constexpr int kThreads = kLanes * kTY;

// Start the copy of channel c's haloed tile (slices t-1, t, t+1) into buf.
// Warp ty takes rows ty, ty + 8, ...: two interior columns a lane, then the two
// halo columns of every row by the first 2 * kRows threads. Elements outside
// the volume (and slices outside the window) are zero-filled.
__device__ __forceinline__ void load_channel(float* buf, const float* __restrict__ x,
                                             const float* chan, int t, int T, int H, int W,
                                             int h0, int w0, int64_t plane, int tx, int ty) {
  for (int rr = ty; rr < kRows; rr += kTY) {
    const int dt = rr / kPH, row = rr - dt * kPH;
    const int ts = t + dt - 1, h = h0 + row - 1;
    const bool ok = ts >= 0 && ts < T && h >= 0 && h < H;
    const float* src = chan + ts * plane + static_cast<int64_t>(h) * W + w0;
    float* dst = buf + rr * kPW + 1;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = tx + q * kLanes;
      const bool in = ok && w0 + col < W;
      __pipeline_memcpy_async(dst + col, in ? src + col : x, 4, in ? 0 : 4);
    }
  }
  const int tid = ty * kLanes + tx;
  if (tid < 2 * kRows) {
    const int rr = tid >> 1, side = tid & 1;
    const int dt = rr / kPH, row = rr - dt * kPH;
    const int ts = t + dt - 1, h = h0 + row - 1, w = side ? w0 + kTW : w0 - 1;
    const bool in = ts >= 0 && ts < T && h >= 0 && h < H && w >= 0 && w < W;
    const float* src = chan + ts * plane + static_cast<int64_t>(h) * W + w;
    __pipeline_memcpy_async(buf + rr * kPW + (side ? kCols - 1 : 0), in ? src : x, 4,
                            in ? 0 : 4);
  }
}

__global__ void __launch_bounds__(kThreads)
dec2_kernel(const float* __restrict__ x, const float* __restrict__ wgt,
            const float* __restrict__ bias, float* __restrict__ out, int T, int H,
            int W, int C, int tilesX, int tilesY) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;                    // [2][3][kPH][kPW]
  float* sw = smem + 2 * kStage;       // [C][kWRow]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kLanes + tx;
  int bid = blockIdx.x;
  const int t = bid % T;
  bid /= T;
  const int txi = bid % tilesX;
  bid /= tilesX;
  const int tyi = bid % tilesY;
  const int64_t b = bid / tilesY;
  const int h0 = tyi * kTH, w0 = txi * kTW;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const float* xb = x + b * C * T * plane;

  load_channel(sx, x, xb, t, T, H, W, h0, w0, plane, tx, ty);
  __pipeline_commit();
  for (int i = tid; i < C * kWRow; i += kThreads) {
    const int c = i / kWRow, tap = i - c * kWRow;
    sw[i] = tap < 27 ? wgt[tap * C + c] : 0.f;
  }

  float acc[kR][2];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r][0] = acc[r][1] = 0.f;

  for (int c = 0; c < C; ++c) {
    __pipeline_wait_prior(0);
    // channel c has landed for every thread, and every thread is done with
    // channel c - 1, whose buffer the next copy overwrites
    __syncthreads();
    if (c + 1 < C) {
      load_channel(sx + ((c + 1) & 1) * kStage, x, xb + (c + 1) * T * plane, t, T, H, W,
                   h0, w0, plane, tx, ty);
      __pipeline_commit();
    }
    const float* cur = sx + (c & 1) * kStage;
    float wr[kWRow];
    const float4* w4 = reinterpret_cast<const float4*>(sw + c * kWRow);
#pragma unroll
    for (int q = 0; q < kWRow / 4; ++q) {
      const float4 w = w4[q];
      wr[4 * q + 0] = w.x;
      wr[4 * q + 1] = w.y;
      wr[4 * q + 2] = w.z;
      wr[4 * q + 3] = w.w;
    }
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
      const int ts = t + dt - 1;
      if (ts < 0 || ts >= T) continue;  // the window's edge: zeros
      const float* base = cur + (dt * kPH + ty * kR) * kPW + 2 * tx;
#pragma unroll
      for (int i = 0; i < kR + 2; ++i) {
        const float2 lo = *reinterpret_cast<const float2*>(base + i * kPW);
        const float2 hi = *reinterpret_cast<const float2*>(base + i * kPW + 2);
        const float xr[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int r = i - dy;
          if (r < 0 || r >= kR) continue;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float w = wr[(dt * 3 + dy) * 3 + dx];
            acc[r][0] = fmaf(xr[dx], w, acc[r][0]);
            acc[r][1] = fmaf(xr[dx + 1], w, acc[r][1]);
          }
        }
      }
    }
  }

  const float b0 = bias[0];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int h = h0 + ty * kR + r;
    if (h >= H) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int w = w0 + 2 * tx + q;
      if (w < W) {
        const float y = acc[r][q] + b0;
        out[(b * T + t) * plane + static_cast<int64_t>(h) * W + w] = 1.f / (1.f + expf(-y));
      }
    }
  }
}

}  // namespace

// x (B, C, T, H, W) channels-first, wgt (3, 3, 3, C, 1), bias (1), out (B, T, H, W).
extern "C" int p2i_dec2_conv3d_sigmoid(const float* x, const float* wgt, const float* bias,
                                       float* out, int B, int T, int H, int W, int C,
                                       void* stream) {
  const size_t shared = sizeof(float) * (2 * kStage + static_cast<size_t>(C) * kWRow);
  if (C < 1 || shared > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(dec2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(shared));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int tilesX = (W + kTW - 1) / kTW, tilesY = (H + kTH - 1) / kTH;
  const int64_t blocks = static_cast<int64_t>(B) * T * tilesX * tilesY;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  dec2_kernel<<<static_cast<unsigned>(blocks), dim3(kLanes, kTY), shared,
                static_cast<cudaStream_t>(stream)>>>(x, wgt, bias, out, T, H, W, C, tilesX,
                                                     tilesY);
  return static_cast<int>(cudaGetLastError());
}
