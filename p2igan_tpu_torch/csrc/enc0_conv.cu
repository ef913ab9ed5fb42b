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
// a register-tiled FMA loop: a block owns a 16x32 pixel tile of one (b, t)
// slice; the three haloed input slices and the whole weight matrix sit in
// shared memory; a thread holds 2 pixels x 32 output channels in registers, so
// one 16-byte broadcast load of weights feeds 8 FMAs and one input load 32.
//
// Bound on the H100: operations at the serving width (CIN 2 -> 64: 6912 flops
// for every 256 output bytes), with the output write close behind; every
// output element is written once, coalesced (a warp writes 32 neighbouring
// pixels of one channel plane).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTW = 32;          // tile width: a warp spans a tile row
constexpr int kTY = 8;           // thread rows
constexpr int kTH = 2 * kTY;     // tile height: a thread owns rows ty and ty + 8
constexpr int kPW = kTW + 2;     // haloed row
constexpr int kPH = kTH + 2;
constexpr int kCC = 32;          // output channels a thread accumulates a pass
constexpr int kThreads = kTW * kTY;

template <int CIN>
__global__ void __launch_bounds__(kThreads, 2)
enc0_kernel(const float* __restrict__ x, const float* __restrict__ wgt,
            const float* __restrict__ bias, float* __restrict__ out, int T, int H,
            int W, int Cout, int coutPad, float slope, int tilesX, int tilesY) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                       // [27 * CIN][coutPad]
  float* sb = sw + 27 * CIN * coutPad;    // [coutPad]
  float* sx = sb + coutPad;               // [3][CIN][kPH][kPW]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  int bid = blockIdx.x;
  const int txi = bid % tilesX;
  bid /= tilesX;
  const int tyi = bid % tilesY;
  const int j = bid / tilesY;             // b * T + t
  const int t = j % T;
  const int h0 = tyi * kTH, w0 = txi * kTW;

  for (int i = tid; i < 27 * CIN * coutPad; i += kThreads) {
    const int row = i / coutPad, co = i - row * coutPad;
    sw[i] = co < Cout ? wgt[row * Cout + co] : 0.f;
  }
  for (int i = tid; i < coutPad; i += kThreads) sb[i] = i < Cout ? bias[i] : 0.f;
  for (int i = tid; i < 3 * kPH * kPW * CIN; i += kThreads) {
    const int ci = i % CIN;
    int r = i / CIN;
    const int c = r % kPW;
    r /= kPW;
    const int row = r % kPH;
    const int dt = r / kPH;
    const int ts = t + dt - 1, h = h0 + row - 1, w = w0 + c - 1;
    float v = 0.f;
    if (ts >= 0 && ts < T && h >= 0 && h < H && w >= 0 && w < W) {
      const int64_t slice = static_cast<int64_t>(j + dt - 1) * H + h;
      v = x[(slice * W + w) * CIN + ci];
    }
    sx[((dt * CIN + ci) * kPH + row) * kPW + c] = v;
  }
  __syncthreads();

  const int h_a = h0 + ty, h_b = h_a + kTY, w_ = w0 + tx;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t b = j / T;
  for (int c0 = 0; c0 < coutPad; c0 += kCC) {
    float acc_a[kCC], acc_b[kCC];
#pragma unroll
    for (int k = 0; k < kCC; ++k) acc_a[k] = acc_b[k] = sb[c0 + k];
#pragma unroll 1
    for (int dt = 0; dt < 3; ++dt) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci) {
            const float* px = sx + ((dt * CIN + ci) * kPH + ty + dy) * kPW + tx + dx;
            const float xa = px[0], xb = px[kTY * kPW];
            const float4* w4 = reinterpret_cast<const float4*>(
                sw + (((dt * 3 + dy) * 3 + dx) * CIN + ci) * coutPad + c0);
#pragma unroll
            for (int q = 0; q < kCC / 4; ++q) {
              const float4 w = w4[q];
              acc_a[4 * q + 0] = fmaf(xa, w.x, acc_a[4 * q + 0]);
              acc_a[4 * q + 1] = fmaf(xa, w.y, acc_a[4 * q + 1]);
              acc_a[4 * q + 2] = fmaf(xa, w.z, acc_a[4 * q + 2]);
              acc_a[4 * q + 3] = fmaf(xa, w.w, acc_a[4 * q + 3]);
              acc_b[4 * q + 0] = fmaf(xb, w.x, acc_b[4 * q + 0]);
              acc_b[4 * q + 1] = fmaf(xb, w.y, acc_b[4 * q + 1]);
              acc_b[4 * q + 2] = fmaf(xb, w.z, acc_b[4 * q + 2]);
              acc_b[4 * q + 3] = fmaf(xb, w.w, acc_b[4 * q + 3]);
            }
          }
        }
      }
    }
    if (w_ < W) {
#pragma unroll
      for (int k = 0; k < kCC; ++k) {
        const int co = c0 + k;
        if (co < Cout) {
          float* po = out + ((b * Cout + co) * T + t) * plane + w_;
          if (h_a < H) {
            const float y = acc_a[k];
            po[static_cast<int64_t>(h_a) * W] = fmaxf(y, slope * y);
          }
          if (h_b < H) {
            const float y = acc_b[k];
            po[static_cast<int64_t>(h_b) * W] = fmaxf(y, slope * y);
          }
        }
      }
    }
  }
}

template <int CIN>
int launch(const float* x, const float* wgt, const float* bias, float* out, int B,
           int T, int H, int W, int Cout, float slope, cudaStream_t stream) {
  const int coutPad = (Cout + kCC - 1) / kCC * kCC;
  const size_t shared =
      sizeof(float) * (static_cast<size_t>(27 * CIN + 1) * coutPad + 3 * CIN * kPH * kPW);
  if (shared > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(enc0_kernel<CIN>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(shared));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int tilesX = (W + kTW - 1) / kTW, tilesY = (H + kTH - 1) / kTH;
  const int64_t blocks = static_cast<int64_t>(B) * T * tilesX * tilesY;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  enc0_kernel<CIN><<<static_cast<unsigned>(blocks), dim3(kTW, kTY), shared, stream>>>(
      x, wgt, bias, out, T, H, W, Cout, coutPad, slope, tilesX, tilesY);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, T, H, W, Cin) channels-last, wgt (3, 3, 3, Cin, Cout), bias (Cout),
// out (B, Cout, T, H, W); Cin in 1..4.
extern "C" int p2i_enc0_conv3d_leaky(const float* x, const float* wgt, const float* bias,
                                     float* out, int B, int T, int H, int W, int Cin,
                                     int Cout, float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Cin) {
    case 1: return launch<1>(x, wgt, bias, out, B, T, H, W, Cout, slope, s);
    case 2: return launch<2>(x, wgt, bias, out, B, T, H, W, Cout, slope, s);
    case 3: return launch<3>(x, wgt, bias, out, B, T, H, W, Cout, slope, s);
    case 4: return launch<4>(x, wgt, bias, out, B, T, H, W, Cout, slope, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
