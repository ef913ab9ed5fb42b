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
// a register-tiled stencil. A block owns a 32x64 output tile of kTt
// consecutive frames of one window b and walks, channel by channel, the
// kTt + 2 input slices those frames read (fewer at the window's edges: a
// slice outside [0, T) is skipped, as its zeros add nothing). Each haloed
// slice is copied into a ring of kStages shared-memory buffers with cp.async
// (no registers in between, zeros filled in at the borders), kStages - 1
// slices ahead of the one consumed: where W % 4 == 0, three 16-byte copies
// and one halo element a thread, planned once a block (CopyPlan), else one
// 4-byte copy an element. A thread keeps a 4x2 patch of outputs of each of
// the kTt frames in registers; each input row it reads (three aligned 8-byte
// loads) feeds up to 54 FMAs: 3 rows x 3 columns x 2 outputs of each of the up
// to 3 frames the slice is a tap of. Weights sit in shared memory, one padded
// row of 28 a channel, read as broadcast float4 once a channel.
//
// Summation order, the parent kernel's, so the output is bitwise the same:
// for each output, channel outer, then dt, dy, dx ascending, by fmaf from 0,
// then + bias, then the sigmoid. Slices ascend within a channel, so dt ascends
// for each output frame; rows ascend, so dy does.
//
// Bound on the H100: bytes -- the C-channel input read once (27 FMAs for every
// 4 bytes is near the card's float32 balance point, so the FMA pipe is close
// behind). A slice is copied (kTt + 2) / kTt times a frame instead of the
// parent's 3 times, and a shared load serves up to 3 frames instead of one.
// What holds it now is the fill from L2 (PERF.md, #15's stage table: without the
// fill the kernel takes 0.72 of its time, without the FMAs all of it). Blocks
// are numbered with the frame group fastest, so the blocks that read one input
// slice run at about the same time and share it in L2.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;           // thread columns: a warp spans a tile row
constexpr int kTY = 8;               // thread rows
constexpr int kR = 4;                // output rows a thread
constexpr int kTW = 2 * kLanes;      // tile width: 2 columns a thread
constexpr int kTH = kR * kTY;        // tile height
constexpr int kPH = kTH + 2;         // haloed rows
constexpr int kCol0 = 4;             // buffer column of tile column 0 (16-byte aligned)
constexpr int kPW = kTW + 8;         // row pitch: columns -4 .. 67, rows 16-byte aligned
constexpr int kSlice = kPH * kPW;    // floats a buffer: one haloed slice
constexpr int kWRow = 28;            // 27 weights a channel, padded to float4s
constexpr int kThreads = kLanes * kTY;
constexpr int kTt = 4;               // output frames a block
constexpr int kStages = 4;           // ring buffers: slices in flight + 1
constexpr int kChunks = kPH * kTW / 4;  // 16-byte interior chunks a slice

// Where a thread copies from and to, the same for every slice of the block:
// offsets into a slice's plane and its buffer, and which copies lie inside.
struct CopyPlan {
  int src, dst;        // first interior copy (the others are rows apart)
  unsigned in;         // bit m: interior copy m lies inside the plane
  int hsrc, hdst;      // halo column copy (threads below 2 * kPH)
  bool hin;
};

// kVec: W % 4 == 0 and x 16-byte aligned, so a row's 64 interior columns are
// 16 chunks of 16 bytes; thread tid copies chunks tid, tid + 256, tid + 512
// (all of one column q = tid % 16, rows 16 apart), and threads below 2 * kPH
// one halo column each. Otherwise every element is a 4-byte copy (planned in
// the copy itself).
__device__ __forceinline__ CopyPlan plan_copies(int tid, int H, int W, int h0, int w0) {
  CopyPlan p{};
  const int q = tid & 15, row = tid >> 4;
  p.src = (h0 + row - 1) * W + w0 + 4 * q;
  p.dst = row * kPW + kCol0 + 4 * q;
  p.in = 0;
#pragma unroll
  for (int m = 0; m * kThreads < kChunks; ++m) {
    const int h = h0 + row + 16 * m - 1;
    if (tid + m * kThreads < kChunks && h >= 0 && h < H && w0 + 4 * q < W) p.in |= 1u << m;
  }
  const int hrow = tid >> 1, side = tid & 1;
  const int hh = h0 + hrow - 1, hw = side ? w0 + kTW : w0 - 1;
  p.hsrc = hh * W + hw;
  p.hdst = hrow * kPW + (side ? kCol0 + kTW : kCol0 - 1);
  p.hin = tid < 2 * kPH && hh >= 0 && hh < H && hw >= 0 && hw < W;
  return p;
}

// Start the copy of one channel's haloed slice (its plane ``slice``) into buf:
// buffer column kCol0 + j holds tile column j, for j = -1 .. kTW; elements
// outside the plane are zero-filled.
template <bool kVec>
__device__ __forceinline__ void load_slice(float* buf, const float* __restrict__ x,
                                           const float* slice, const CopyPlan& p, int tid,
                                           int H, int W, int h0, int w0) {
  if (kVec) {
#pragma unroll
    for (int m = 0; m * kThreads < kChunks; ++m) {
      if (tid + m * kThreads >= kChunks) break;
      const bool in = (p.in >> m) & 1u;
      __pipeline_memcpy_async(buf + p.dst + m * 16 * kPW,
                              in ? slice + p.src + m * 16 * W : x, 16, in ? 0 : 16);
    }
    if (tid < 2 * kPH)
      __pipeline_memcpy_async(buf + p.hdst, p.hin ? slice + p.hsrc : x, 4, p.hin ? 0 : 4);
  } else {
    for (int e = tid; e < kPH * (kTW + 2); e += kThreads) {
      const int row = e / (kTW + 2), col = e - row * (kTW + 2) - 1;
      const int h = h0 + row - 1, w = w0 + col;
      const bool in = h >= 0 && h < H && w >= 0 && w < W;
      __pipeline_memcpy_async(buf + row * kPW + kCol0 + col, in ? slice + h * W + w : x, 4,
                              in ? 0 : 4);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
dec2_kernel(const float* __restrict__ x, const float* __restrict__ wgt,
            const float* __restrict__ bias, float* __restrict__ out, int T, int H,
            int W, int C, int tilesX, int tilesY, int groups) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                    // [kStages][kPH][kPW]
  float* sw = smem + kStages * kSlice;   // [C][kWRow]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kLanes + tx;
  int bid = blockIdx.x;
  const int t0 = (bid % groups) * kTt;
  bid /= groups;
  const int txi = bid % tilesX;
  bid /= tilesX;
  const int tyi = bid % tilesY;
  const int64_t b = bid / tilesY;
  const int h0 = tyi * kTH, w0 = txi * kTW;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const float* xb = x + b * C * T * plane;
  const CopyPlan plan = plan_copies(tid, H, W, h0, w0);

  // the slices of the block's frames inside the window, each channel's in
  // ascending order: item j is channel j / ns, slice s_lo + j % ns
  const int s_lo = max(t0 - 1, 0), s_hi = min(t0 + kTt, T - 1);
  const int ns = s_hi - s_lo + 1;
  const int items = C * ns;
  int next = 0, next_c = 0, next_s = 0;  // the next item to copy
  auto copy_next = [&]() {
    if (next < items) {
      load_slice<kVec>(ring + (next % kStages) * kSlice, x,
                       xb + (static_cast<int64_t>(next_c) * T + s_lo + next_s) * plane, plan,
                       tid, H, W, h0, w0);
      if (++next_s == ns) {
        next_s = 0;
        ++next_c;
      }
    }
    ++next;
    __pipeline_commit();  // an empty group past the last item keeps the count
  };
  for (int i = 0; i < kStages - 1; ++i) copy_next();
  for (int i = tid; i < C * kWRow; i += kThreads) {
    const int c = i / kWRow, tap = i - c * kWRow;
    sw[i] = tap < 27 ? wgt[tap * C + c] : 0.f;
  }
  __syncthreads();

  float acc[kTt][kR][2];
#pragma unroll
  for (int u = 0; u < kTt; ++u)
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[u][r][0] = acc[u][r][1] = 0.f;

  int j = 0;  // the item consumed next
  for (int c = 0; c < C; ++c) {
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
    // sl = s - t0 + 1: slice s is tap dt of frame t0 + sl - dt
#pragma unroll
    for (int sl = 0; sl < kTt + 2; ++sl) {
      const int s = t0 + sl - 1;
      if (s < 0 || s >= T) continue;  // the window's edge: zeros
      __pipeline_wait_prior(kStages - 2);
      // item j has landed for every thread, and every thread is done with
      // item j - 1, whose buffer the next copy overwrites
      __syncthreads();
      copy_next();
      // the thread's columns 2tx - 1 .. 2tx + 2 as three aligned 8-byte loads
      // of columns 2tx - 2 .. 2tx + 3
      const float* base =
          ring + (j % kStages) * kSlice + (ty * kR) * kPW + kCol0 - 2 + 2 * tx;
      ++j;
#pragma unroll
      for (int i = 0; i < kR + 2; ++i) {
        const float2 lo = *reinterpret_cast<const float2*>(base + i * kPW);
        const float2 mid = *reinterpret_cast<const float2*>(base + i * kPW + 2);
        const float2 hi = *reinterpret_cast<const float2*>(base + i * kPW + 4);
        const float xr[4] = {lo.y, mid.x, mid.y, hi.x};
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int r = i - dy;
          if (r < 0 || r >= kR) continue;
#pragma unroll
          for (int dt = 0; dt < 3; ++dt) {
            const int u = sl - dt;
            if (u < 0 || u >= kTt) continue;
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const float w = wr[(dt * 3 + dy) * 3 + dx];
              acc[u][r][0] = fmaf(xr[dx], w, acc[u][r][0]);
              acc[u][r][1] = fmaf(xr[dx + 1], w, acc[u][r][1]);
            }
          }
        }
      }
    }
  }

  const float b0 = bias[0];
#pragma unroll
  for (int u = 0; u < kTt; ++u) {
    const int t = t0 + u;
    if (t >= T) break;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int h = h0 + ty * kR + r;
      if (h >= H) continue;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int w = w0 + 2 * tx + q;
        if (w < W) {
          const float y = acc[u][r][q] + b0;
          out[(b * T + t) * plane + static_cast<int64_t>(h) * W + w] = 1.f / (1.f + expf(-y));
        }
      }
    }
  }
}

template <bool kVec>
int launch(const float* x, const float* wgt, const float* bias, float* out, int B, int T,
           int H, int W, int C, cudaStream_t stream) {
  const size_t shared = sizeof(float) * (kStages * kSlice + static_cast<size_t>(C) * kWRow);
  if (C < 1 || shared > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(
      dec2_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int tilesX = (W + kTW - 1) / kTW, tilesY = (H + kTH - 1) / kTH;
  const int groups = (T + kTt - 1) / kTt;
  const int64_t blocks = static_cast<int64_t>(B) * groups * tilesX * tilesY;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  dec2_kernel<kVec><<<static_cast<unsigned>(blocks), dim3(kLanes, kTY), shared, stream>>>(
      x, wgt, bias, out, T, H, W, C, tilesX, tilesY, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, C, T, H, W) channels-first, wgt (3, 3, 3, C, 1), bias (1), out (B, T, H, W).
extern "C" int p2i_dec2_conv3d_sigmoid(const float* x, const float* wgt, const float* bias,
                                       float* out, int B, int T, int H, int W, int C,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch<true>(x, wgt, bias, out, B, T, H, W, C, s);
  return launch<false>(x, wgt, bias, out, B, T, H, W, C, s);
}
