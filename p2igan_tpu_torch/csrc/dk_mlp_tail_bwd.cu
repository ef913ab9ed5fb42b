// Fused DK/STDK MLP tail, backward: from the output cotangent g (J, HW) the
// gradients dphi (HW, h), doff (J, h), dfc2, dfc3 (h, h), dfc4, db2, db3 (h,)
// of   out[j, p] = fc4 . relu(fc3^T relu(fc2^T relu(phi[p] + off[j]) + b2) + b3) + b4.
// (db4 = sum g is left to the caller, as in the TPU kernel.)
//
// Replaces p2igan_tpu/ops/pallas/dk_mlp_kernel.py::_mlp_tail_bwd_pallas
// (_bwd_kernel). The TPU kernel accumulates dphi and the weight gradients
// across grid steps that run in order; blocks here run in no order, so a block
// owns one tile of 64 pixels and loops over j inside:
//   - the forward is recomputed (h1, h2, h3 never reach device memory); the
//     relu masks come from the recomputed outputs (h > 0, zero at zero);
//   - dphi accumulates in registers over the whole j loop, no atomics;
//   - dfc2 and dfc3 accumulate in shared memory, every element owned by one
//     thread; dfc4, db2, db3 in registers; at the end the block writes them as
//     its partial, and doff[j] is written as a per-block partial every j;
//   - a second kernel sums the partials over the blocks in block order, so a
//     training run repeats bit for bit.
// Shared memory holds fc2, fc3, the two (h, h) accumulators (160 KB at
// h = 100) and two (h, 64) activation tiles; that leaves no room for the phi
// tile, so relu(phi + off[j]) is rebuilt from device memory (the L2 holds all
// of phi) twice per j. Per j the block runs six tile products
// (dk_mlp_tile.cuh), each operand stored once and read through strides:
//   X = h1                      ; Y = h2 = relu(X fc2 + b2)
//   a3 = Y fc3 + b3, h3 = relu  ; dfc4 += h3^T g ; X = da3 = g fc4 [h3 > 0]
//   dfc3 += Y^T X               ; dh2 = X fc3^T  ; da2 = dh2 [h2 > 0]
//   X = da2, Y = h1             ; dfc2 += Y^T X  ; dh1 = X fc2^T
//   da1 = dh1 [h1 > 0]          ; dphi += da1    ; doff[j] = column sums of da1
//
// Bound on the H100: operations, six products of 2 h^2 flops per (j, pixel):
// J * HW * (12 h^2 + 10 h), 3.8e11 at J = 192, HW = 16384, h = 100, against
// 67 TFLOP/s float32. Bytes: phi, g and dphi once (25.7 MB) plus the partials
// (20 MB each way at 256 blocks).

#include <cuda_runtime.h>

#include "dk_mlp_tile.cuh"

namespace {

using namespace dkmlp;

constexpr int kRows = 64;                         // pixels per block
constexpr int kRS = kRows + 4;                    // row stride of the (h, kRows) tiles
constexpr int kTM = kRows / kTY;                  // 4 rows a thread
constexpr int kTW = (kMaxHidden + kTY - 1) / kTY;  // 7 weight-gradient rows a thread

// dst[k * kRS + r] = relu(phi[p0 + r, k] + offj[k]); rows past HW are zero.
__device__ __forceinline__ void load_h1(float* dst, const float* __restrict__ phi,
                                        const float* __restrict__ offj, int p0,
                                        int HW, int h) {
  for (int e = threadIdx.x; e < kRows * h; e += kThreads) {
    const int r = e / h;
    const int k = e - r * h;
    const int p = p0 + r;
    dst[k * kRS + r] =
        p < HW ? fmaxf(phi[static_cast<size_t>(p) * h + k] + offj[k], 0.0f) : 0.0f;
  }
}

// W[m * h + n] += sum_r Y[m * kRS + r] * X[n * kRS + r]  (activations^T times
// cotangents over the block's rows); every element has one owner thread.
__device__ __forceinline__ void weight_grad(float* W, const float* Y, const float* X,
                                            int h, int ty, int tx) {
  float acc[kTW][kTN];
  tile_gemm<kTW, kTN, false>(acc, Y, kRS, 1, X, 1, kRS, h, h, kRows, ty, tx, nullptr);
#pragma unroll
  for (int i = 0; i < kTW; ++i) {
    const int m = ty + kTY * i;
    if (m < h) {
#pragma unroll
      for (int jn = 0; jn < kTN; ++jn) {
        const int n = tx + kTX * jn;
        if (n < h) W[m * h + n] += acc[i][jn];
      }
    }
  }
}

// dst[n] = sum over the kTY row owners, in order, of their column sums.
__device__ __forceinline__ void reduce_columns(float* red, const float (&v)[kTN],
                                               float* __restrict__ dst, int h,
                                               int ty, int tx) {
  __syncthreads();
#pragma unroll
  for (int jn = 0; jn < kTN; ++jn) {
    const int n = tx + kTX * jn;
    if (n < h) red[ty * h + n] = v[jn];
  }
  __syncthreads();
  if (threadIdx.x < h) {
    float s = 0.0f;
    for (int t = 0; t < kTY; ++t) s += red[t * h + threadIdx.x];
    dst[threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
dk_mlp_tail_bwd_kernel(const float* __restrict__ phi, const float* __restrict__ off,
                       const float* __restrict__ g, const float* __restrict__ fc2,
                       const float* __restrict__ b2, const float* __restrict__ fc3,
                       const float* __restrict__ b3, const float* __restrict__ fc4,
                       float* __restrict__ dphi, float* __restrict__ doff_parts,
                       float* __restrict__ w_parts, int HW, int J, int h) {
  extern __shared__ float smem[];
  const int hh = h * h;
  float* fc2s = smem;                  // (h, h) as (in, out)
  float* fc3s = fc2s + hh;
  float* d2s = fc3s + hh;              // dfc2 accumulator
  float* d3s = d2s + hh;               // dfc3 accumulator
  float* X = d3s + hh;                 // (h, kRS) tiles, [column * kRS + row]
  float* Y = X + h * kRS;
  float* red = Y + h * kRS;            // (kTY, h) column sums
  float* b2s = red + kTY * h;
  float* b3s = b2s + h;
  float* fc4s = b3s + h;
  float* gs = fc4s + h;                // (kRows,) this row's cotangent

  const int tid = threadIdx.x;
  const int ty = tid / kTX;
  const int tx = tid - ty * kTX;
  const int p0 = blockIdx.x * kRows;

  load_vec(fc2s, fc2, hh);
  load_vec(fc3s, fc3, hh);
  load_vec(b2s, b2, h);
  load_vec(b3s, b3, h);
  load_vec(fc4s, fc4, h);
  for (int i = tid; i < 2 * hh; i += kThreads) d2s[i] = 0.0f;  // d2s and d3s

  float dphi_acc[kTM][kTN];
  float dfc4_acc[kTN], db3_acc[kTN], db2_acc[kTN];
#pragma unroll
  for (int jn = 0; jn < kTN; ++jn) {
    dfc4_acc[jn] = db3_acc[jn] = db2_acc[jn] = 0.0f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) dphi_acc[i][jn] = 0.0f;
  }

  for (int j = 0; j < J; ++j) {
    const float* offj = off + static_cast<size_t>(j) * h;
    load_h1(X, phi, offj, p0, HW, h);
    if (tid < kRows) {
      gs[tid] = p0 + tid < HW ? g[static_cast<size_t>(j) * HW + p0 + tid] : 0.0f;
    }
    __syncthreads();

    // Y = h2 = relu(h1 fc2 + b2)
    float acc[kTM][kTN];
    tile_gemm<kTM, kTN, false>(acc, X, 1, kRS, fc2s, h, 1, kRows, h, h, ty, tx, nullptr);
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

    // h3 = relu(h2 fc3 + b3); dfc4 += h3^T g; X = da3 = g fc4 [h3 > 0]
    tile_gemm<kTM, kTN, false>(acc, Y, 1, kRS, fc3s, h, 1, kRows, h, h, ty, tx, nullptr);
#pragma unroll
    for (int jn = 0; jn < kTN; ++jn) {
      const int n = tx + kTX * jn;
      if (n < h) {
        const float bb = b3s[n];
        const float w = fc4s[n];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const int r = ty + kTY * i;
          const float gr = gs[r];
          const float h3 = fmaxf(acc[i][jn] + bb, 0.0f);
          const float d = h3 > 0.0f ? gr * w : 0.0f;
          dfc4_acc[jn] = fmaf(h3, gr, dfc4_acc[jn]);
          db3_acc[jn] += d;
          X[n * kRS + r] = d;
        }
      }
    }
    __syncthreads();

    // dfc3 += h2^T da3; da2 = (da3 fc3^T) [h2 > 0]
    weight_grad(d3s, Y, X, h, ty, tx);
    tile_gemm<kTM, kTN, false>(acc, X, 1, kRS, fc3s, 1, h, kRows, h, h, ty, tx, nullptr);
#pragma unroll
    for (int jn = 0; jn < kTN; ++jn) {
      const int n = tx + kTX * jn;
      if (n < h) {
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float d = Y[n * kRS + ty + kTY * i] > 0.0f ? acc[i][jn] : 0.0f;
          acc[i][jn] = d;
          db2_acc[jn] += d;
        }
      }
    }
    __syncthreads();  // every read of da3 and h2 is done

    // X = da2, Y = h1 again
#pragma unroll
    for (int jn = 0; jn < kTN; ++jn) {
      const int n = tx + kTX * jn;
      if (n < h) {
#pragma unroll
        for (int i = 0; i < kTM; ++i) X[n * kRS + ty + kTY * i] = acc[i][jn];
      }
    }
    load_h1(Y, phi, offj, p0, HW, h);
    __syncthreads();

    // dfc2 += h1^T da2; da1 = (da2 fc2^T) [h1 > 0]; dphi += da1; doff[j] partial
    weight_grad(d2s, Y, X, h, ty, tx);
    tile_gemm<kTM, kTN, false>(acc, X, 1, kRS, fc2s, 1, h, kRows, h, h, ty, tx, nullptr);
    float col[kTN];
#pragma unroll
    for (int jn = 0; jn < kTN; ++jn) {
      const int n = tx + kTX * jn;
      col[jn] = 0.0f;
      if (n < h) {
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float d = Y[n * kRS + ty + kTY * i] > 0.0f ? acc[i][jn] : 0.0f;
          dphi_acc[i][jn] += d;
          col[jn] += d;
        }
      }
    }
    // its first barrier also ends every read of X and Y before the next row
    // overwrites them; red is next written two barriers after this read
    reduce_columns(red, col,
                   doff_parts + (static_cast<size_t>(blockIdx.x) * J + j) * h, h, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int p = p0 + ty + kTY * i;
    if (p < HW) {
#pragma unroll
      for (int jn = 0; jn < kTN; ++jn) {
        const int n = tx + kTX * jn;
        if (n < h) dphi[static_cast<size_t>(p) * h + n] = dphi_acc[i][jn];
      }
    }
  }

  // this block's partial: dfc2 | dfc3 | dfc4 | db2 | db3
  float* wp = w_parts + static_cast<size_t>(blockIdx.x) * (2 * hh + 3 * h);
  __syncthreads();
  for (int i = tid; i < 2 * hh; i += kThreads) wp[i] = d2s[i];
  reduce_columns(red, dfc4_acc, wp + 2 * hh, h, ty, tx);
  reduce_columns(red, db2_acc, wp + 2 * hh + h, h, ty, tx);
  reduce_columns(red, db3_acc, wp + 2 * hh + 2 * h, h, ty, tx);
}

// out[i] = sum over blocks b, in order, of parts[b][i].
__global__ void sum_block_partials_kernel(const float* __restrict__ parts,
                                          float* __restrict__ out, int nblk,
                                          int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = 0.0f;
#pragma unroll 8
  for (int b = 0; b < nblk; ++b) acc += parts[static_cast<size_t>(b) * total + i];
  out[i] = acc;
}

}  // namespace

// phi (HW, h), off (J, h), g (J, HW), fc2/fc3 (h, h) as (in, out), b2/b3/fc4
// (h,) -> dphi (HW, h), doff (J, h), wgrad (2 h^2 + 3 h: dfc2 | dfc3 | dfc4 |
// db2 | db3). doff_parts (nblk, J, h) and w_parts (nblk, 2 h^2 + 3 h) are
// scratch the caller allocates, nblk = ceil(HW / 64). Returns a cudaError_t.
extern "C" int p2i_dk_mlp_tail_bwd(const float* phi, const float* off, const float* g,
                                   const float* fc2, const float* b2, const float* fc3,
                                   const float* b3, const float* fc4, float* dphi,
                                   float* doff_parts, float* w_parts, float* doff,
                                   float* wgrad, int HW, int J, int h, int nblk,
                                   void* stream) {
  if (h < 1 || h > kMaxHidden || HW < 1 || J < 1 ||
      nblk != (HW + kRows - 1) / kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(4) * h * h + 2 * h * kRS + kTY * h + 3 * h + kRows);
  cudaError_t err = cudaFuncSetAttribute(dk_mlp_tail_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dk_mlp_tail_bwd_kernel<<<nblk, kThreads, smem, s>>>(
      phi, off, g, fc2, b2, fc3, b3, fc4, dphi, doff_parts, w_parts, HW, J, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_off = J * h;
  sum_block_partials_kernel<<<(n_off + 127) / 128, 128, 0, s>>>(doff_parts, doff, nblk,
                                                               n_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_w = 2 * h * h + 3 * h;
  sum_block_partials_kernel<<<(n_w + 127) / 128, 128, 0, s>>>(w_parts, wgrad, nblk, n_w);
  return static_cast<int>(cudaGetLastError());
}
