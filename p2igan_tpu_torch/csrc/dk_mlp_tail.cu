// Fused DK/STDK MLP tail, forward:
//   out[j, p] = fc4 . relu(fc3^T relu(fc2^T relu(phi[p] + off[j]) + b2) + b3) + b4
// for every row j = (b, t) of the hidden offsets and every pixel p.
//
// Replaces p2igan_tpu/ops/pallas/dk_mlp_kernel.py::_mlp_tail_pallas (_kernel).
// The TPU kernel walks a grid (pixel tiles outer, j chunks inner) in order and
// relies on phi staying resident over the inner axis. Here one persistent
// block a streaming multiprocessor walks a contiguous range of the (tile, j)
// units, tile = 128 pixels: the block's phi tile is read from device memory
// when its range enters a tile (once or twice a block), and both (h, h)
// weight matrices stay in shared memory for the whole launch. Rows j are
// independent, so cutting the units into equal ranges keeps every sum's
// order and gives every SM the same work (within one unit). Nothing of size
// (J, HW, h) touches device memory.
//
// Per unit: h1 = relu(phi + off[j]) is formed once into a shared tile; the
// first product reads it, its relu output overwrites it; the second
// product's output never leaves registers: relu, the dot with fc4 and a
// fixed-order sum over 13 column owners give 128 outputs, stored coalesced.
//
// Arithmetic (the contract #13's recompute, dk_mlp_tail_bwd.cu, relies on):
//   - h1 = fmaxf(phi + off, 0);
//   - every pre-activation of layers 2 and 3 is the float32 fmaf sum over
//     k = 0 .. h-1 in ascending order from 0.0f, then + bias, then
//     fmaxf(., 0). k is padded to a multiple of 4 with zero rows of both
//     operands: fmaf(0, 0, acc) = acc, since acc is never -0;
//   - the fc4 dot: owner t = 0 .. 12 sums fmaf(h3[n], fc4[n], part) from 0.0f
//     over n = t, t + 13, ... < h in ascending n; out = b4 + part[0] + ...
//     + part[12] in t order.
// No product runs on the tensor cores, and the library's -fmad=false keeps
// every other add and multiply rounded on its own.
//
// Bound on the H100: operations. J * HW * (4 h^2 + 4 h) flops (1.27e11 at
// J = 192, HW = 16384, h = 100) against 67 TFLOP/s float32; the bytes (phi
// 6.6 MB in, out 12.6 MB) are negligible. Thread (ty, tx) of 16 x 13 owns
// pixel rows 8 ty .. + 7 and the 8 output columns n = tx + 13 i (i < 8) of
// the padded width 104: exactly the columns its fc4 partial sums. The
// weights are stored with their columns permuted so that those 8 lie in two
// float4 (columns 4 tx .. + 3 and 52 + 4 tx .. + 3), and the activation
// tiles are k-major, so a k step is four 16-byte shared loads for 64 fmaf,
// issued column by column, every other column's rows in reverse (row by row
// was 10% slower on the H100), eight k steps a loop iteration. The next
// unit's offsets are fetched into a register before the layer-2 product and
// stored after it. Shared memory: 205,296 bytes at every h, so one block of
// 6.5 warps an SM.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;             // pixels a tile
constexpr int kTY = 16;                // row owners
constexpr int kTX = 13;                // column owners (the fc4 partials)
constexpr int kThreads = kTY * kTX;    // 208
constexpr int kTM = kRows / kTY;       // 8 rows a thread
constexpr int kTN = 8;                 // columns a thread
constexpr int kHP = kTX * kTN;         // 104: padded hidden width
constexpr int kHalf = kHP / 2;         // where the second float4 of a thread's columns starts
constexpr int kRS = kRows + 4;         // row stride of the k-major (kHP, kRows) tiles

// Physical column of logical column n = t + 13 i of a permuted weight row.
__host__ __device__ constexpr int phys_col(int t, int i) {
  return i < 4 ? 4 * t + i : kHalf + 4 * t + (i - 4);
}

// acc[i][c] = sum over k < kpad, ascending, of A[k][8 ty + i] * W[k][col c of tx]
// (fmaf from 0.0f). A is a k-major (kHP, kRS) tile, W a permuted (kHP, kHP)
// weight; kpad is a multiple of 4.
__device__ __forceinline__ void tile_product(float (&acc)[kTM][kTN], const float* A,
                                             const float* W, int ty, int tx, int kpad) {
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[i][c] = 0.0f;
  }
  const float* ap = A + kTM * ty;
  const float* wp = W + 4 * tx;
#pragma unroll 2
  for (int k0 = 0; k0 < kpad; k0 += 4) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = k0 + kk;
      const float4 a0 = *reinterpret_cast<const float4*>(ap + k * kRS);
      const float4 a1 = *reinterpret_cast<const float4*>(ap + k * kRS + 4);
      const float4 w0 = *reinterpret_cast<const float4*>(wp + k * kHP);
      const float4 w1 = *reinterpret_cast<const float4*>(wp + k * kHP + kHalf);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float w[kTN] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int c = 0; c < kTN; ++c) {
#pragma unroll
        for (int ii = 0; ii < kTM; ++ii) {
          const int i = (c & 1) ? kTM - 1 - ii : ii;
          acc[i][c] = fmaf(a[i], w[c], acc[i][c]);
        }
      }
    }
  }
}

// Shared (kHP, kHP) copy of an (h, h) weight, rows k (zero for k >= h),
// columns permuted by phys_col (zero for n >= h).
__device__ __forceinline__ void load_weight(float* dst, const float* __restrict__ src,
                                            int h) {
  for (int e = threadIdx.x; e < kHP * kHP; e += kThreads) {
    const int k = e / kHP;
    const int c = e - k * kHP;
    const int half = c / kHalf;
    const int rem = c - half * kHalf;
    const int n = rem / 4 + kTX * (4 * half + rem % 4);
    dst[e] = k < h && n < h ? src[k * h + n] : 0.0f;
  }
}

// A vector of length h, permuted like a weight row (zero past h).
__device__ __forceinline__ void load_permuted(float* dst, const float* __restrict__ src,
                                              int h) {
  for (int c = threadIdx.x; c < kHP; c += kThreads) {
    const int half = c / kHalf;
    const int rem = c - half * kHalf;
    const int n = rem / 4 + kTX * (4 * half + rem % 4);
    dst[c] = n < h ? src[n] : 0.0f;
  }
}

// X[k][r] = phi[p0 + r][k] for k < h (zero past HW); rows k >= h stay zero.
__device__ __forceinline__ void load_phi_tile(float* X, const float* __restrict__ phi,
                                              int p0, int HW, int h) {
  for (int e = threadIdx.x; e < kRows * h; e += kThreads) {
    const int r = e / h;
    const int k = e - r * h;
    const int p = p0 + r;
    X[k * kRS + r] = p < HW ? phi[static_cast<size_t>(p) * h + k] : 0.0f;
  }
}

// The row's offsets, zero from h to kHP.
__device__ __forceinline__ void load_offsets(float* dst, const float* __restrict__ off,
                                             int h) {
  for (int k = threadIdx.x; k < kHP; k += kThreads) dst[k] = k < h ? off[k] : 0.0f;
}

// H[k][r] = relu(X[k][r] + o[k]) for k < kpad, every row of the tile.
__device__ __forceinline__ void form_h1(float* H, const float* X, const float* o,
                                        int kpad) {
#pragma unroll 4
  for (int e = threadIdx.x; e < kpad * (kRows / 4); e += kThreads) {
    const int k = e / (kRows / 4);
    const int r = 4 * (e - k * (kRows / 4));
    const float4 x = *reinterpret_cast<const float4*>(X + k * kRS + r);
    const float ok = o[k];
    *reinterpret_cast<float4*>(H + k * kRS + r) =
        make_float4(fmaxf(x.x + ok, 0.0f), fmaxf(x.y + ok, 0.0f),
                    fmaxf(x.z + ok, 0.0f), fmaxf(x.w + ok, 0.0f));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
dk_mlp_tail_kernel(const float* __restrict__ phi, const float* __restrict__ off,
                   const float* __restrict__ fc2, const float* __restrict__ b2,
                   const float* __restrict__ fc3, const float* __restrict__ b3,
                   const float* __restrict__ fc4, const float* __restrict__ b4,
                   float* __restrict__ out, int HW, int J, int h, long long units) {
  extern __shared__ float smem[];
  float* W2 = smem;                    // (kHP, kHP), permuted columns
  float* W3 = W2 + kHP * kHP;
  float* X = W3 + kHP * kHP;           // phi tile, X[k * kRS + r]
  float* HY = X + kHP * kRS;           // h1, then relu(layer 2), same layout
  float* red = HY + kHP * kRS;         // (kTX, kRS) fc4 partials
  float* b2s = red + kTX * kRS;        // permuted
  float* b3s = b2s + kHP;
  float* fc4s = b3s + kHP;
  float* offs = fc4s + kHP;            // (2, kHP): this unit's offsets, the next's

  const int tid = threadIdx.x;
  const int ty = tid / kTX;
  const int tx = tid - ty * kTX;
  const int kpad = (h + 3) & ~3;
  const long long u0 = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;

  load_weight(W2, fc2, h);
  load_weight(W3, fc3, h);
  load_permuted(b2s, b2, h);
  load_permuted(b3s, b3, h);
  load_permuted(fc4s, fc4, h);
  for (int e = tid; e < kHP * kRS; e += kThreads) X[e] = 0.0f;
  const float bias4 = b4[0];
  int tile = static_cast<int>(u0 / J);
  __syncthreads();
  load_phi_tile(X, phi, tile * kRows, HW, h);
  load_offsets(offs, off + static_cast<size_t>(u0 % J) * h, h);
  __syncthreads();
  form_h1(HY, X, offs, kpad);
  __syncthreads();

  for (long long u = u0, it = 0; u < u1; ++u, ++it) {
    const int j = static_cast<int>(u - static_cast<long long>(tile) * J);
    const int p0 = tile * kRows;
    const bool more = u + 1 < u1;
    // the next unit's offsets: fetched now, stored once layer 2 is done, so
    // no thread waits on the L2 before its product (the other half of offs
    // was last read by this unit's h1)
    float onext = 0.0f;
    if (more && tid < h) onext = off[static_cast<size_t>((u + 1) % J) * h + tid];

    float acc[kTM][kTN];
    tile_product(acc, HY, W2, ty, tx, kpad);
    if (tid < kHP) offs[((it + 1) & 1) * kHP + tid] = onext;
    __syncthreads();                   // every thread is done reading h1
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int n = tx + kTX * c;      // < kHP; zero past h (padded weights)
      const float bb = b2s[phys_col(tx, c)];
      float* y = HY + n * kRS + kTM * ty;
      *reinterpret_cast<float4*>(y) =
          make_float4(fmaxf(acc[0][c] + bb, 0.0f), fmaxf(acc[1][c] + bb, 0.0f),
                      fmaxf(acc[2][c] + bb, 0.0f), fmaxf(acc[3][c] + bb, 0.0f));
      *reinterpret_cast<float4*>(y + 4) =
          make_float4(fmaxf(acc[4][c] + bb, 0.0f), fmaxf(acc[5][c] + bb, 0.0f),
                      fmaxf(acc[6][c] + bb, 0.0f), fmaxf(acc[7][c] + bb, 0.0f));
    }
    __syncthreads();

    tile_product(acc, HY, W3, ty, tx, kpad);
    float part[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) part[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      if (tx + kTX * c < h) {
        const float bb = b3s[phys_col(tx, c)];
        const float w = fc4s[phys_col(tx, c)];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          part[i] = fmaf(fmaxf(acc[i][c] + bb, 0.0f), w, part[i]);
        }
      }
    }
    float* rp = red + tx * kRS + kTM * ty;
    *reinterpret_cast<float4*>(rp) = make_float4(part[0], part[1], part[2], part[3]);
    *reinterpret_cast<float4*>(rp + 4) = make_float4(part[4], part[5], part[6], part[7]);
    __syncthreads();                   // partials complete, layer-2 tile free

    if (tid < kRows && p0 + tid < HW) {
      float y = bias4;
      for (int t = 0; t < kTX; ++t) y += red[t * kRS + tid];
      out[static_cast<size_t>(j) * HW + p0 + tid] = y;
    }
    if (more) {
      if (j + 1 == J) {                // the range enters the next tile
        ++tile;
        load_phi_tile(X, phi, tile * kRows, HW, h);
        __syncthreads();
      }
      form_h1(HY, X, offs + ((it + 1) & 1) * kHP, kpad);
      __syncthreads();
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
  if (h < 1 || h > kHP || HW < 1 || J < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(2) * kHP * kHP + 2 * kHP * kRS + kTX * kRS + 5 * kHP);
  cudaError_t err = cudaFuncSetAttribute(dk_mlp_tail_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long units = static_cast<long long>((HW + kRows - 1) / kRows) * J;
  const int grid = static_cast<int>(units < sms ? units : sms);
  dk_mlp_tail_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      phi, off, fc2, b2, fc3, b3, fc4, b4, out, HW, J, h, units);
  return static_cast<int>(cudaGetLastError());
}
