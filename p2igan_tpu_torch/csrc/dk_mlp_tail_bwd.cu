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
// Per j the block runs six tile products, every operand stored once in a
// swizzled (rows, 104) tile and read plain or transposed:
//   X = h1                      ; Y = h2 = relu(X fc2 + b2)
//   a3 = Y fc3 + b3, h3 = relu  ; dfc4 += h3^T g ; X = da3 = g fc4 [h3 > 0]
//   dfc3 += Y^T X               ; dh2 = X fc3^T  ; da2 = dh2 [h2 > 0]
//   X = da2, Y = h1             ; dfc2 += Y^T X  ; dh1 = X fc2^T
//   da1 = dh1 [h1 > 0]          ; dphi += da1    ; doff[j] = column sums of da1
// Five run on the tensor cores in 3xTF32 (dk_mlp_mma.cuh: float32 accuracy,
// fixed order). The relu masks must be bit for bit those of the forward
// kernel (dk_mlp_tail.cu, sequential fmaf): of the 3e8 pre-activations a
// layer at the training shape a few lie within rounding of zero, and one
// flipped mask moves a pixel's dphi by a whole unit's share (1.5e-2 x
// max|plain| with every product on the tensor cores, against a tolerance of
// 1e-4). So h2 = relu(h1 fc2 + b2) stays on the CUDA cores in the forward's
// own order (forward_layer: h2 is then bitwise the forward's), and the mask
// of a3 is certified: where |a3| is below a bound on the gap between the two
// sums (kTau |h2 row| |fc3 column|), the element is recomputed in the
// forward's order (forward_dot); about 1e-3 of them at the training shape.
//
// Bound on the H100: operations, six products of 2 h^2 flops per (j, pixel):
// J * HW * (12 h^2 + 10 h), 3.8e11 at J = 192, HW = 16384, h = 100, 5.7 ms
// against 67 TFLOP/s float32; the three TF32 passes would take 2.3 ms at the
// 495 TFLOP/s of the tensor cores. Bytes: phi, g and dphi once (25.7 MB) plus
// the partials (20 MB each way at 256 blocks).
//
// Tiling. The hidden width is padded to 104 (13 n-tiles of 8) with zeros, so
// padded lanes add exact zeros. Shared memory (230,304 bytes at every h <=
// 104): fc2 and fc3 (86.5 KB), the dfc2 and dfc3 accumulators (86.5 KB), two
// (64, 104) activation tiles (53 KB), the column sums and five vectors; that
// is one block of 8 warps per SM (the registers are full too: 255 a thread),
// 256 blocks of 64 pixels at HW = 16384, 1.94 waves on 132 SMs. No room is
// left for a phi tile: each thread holds its 28 floats of the block's phi
// tile in registers for the whole j loop, h1 = relu(phi + off[j]) is rebuilt
// from them twice per j, and off and g of the next j are fetched at the top
// of a j and stored after their last read, so the j loop reads no device
// memory on its critical path. The (64, 104) tensor-core products give warp
// w rows 16 (w % 4) .. + 15 and n-tiles 0-6 (w < 4) or 7-12; the two
// (104, 104) weight-gradient products give warp w < 7 rows 16 w .. + 15, all
// 13 n-tiles (warp 7 waits), summed from zero each j and added to the shared
// accumulator once (the tensor cores' own float32 sums drift over 192 j).

#include <cuda_runtime.h>

#include <cstdint>

#include "dk_mlp_mma.cuh"

namespace {

using namespace dkmma;

constexpr int kRows = 64;                  // pixels per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMTiles = kRows / 16;        // 4 row tiles of the (64, 104) products
constexpr int kNT = 7;                     // n-tiles a warp of those owns (or 6)
constexpr int kWNT = kHP / 8;              // 13 n-tiles of a weight-gradient row tile
constexpr int kWMTiles = (kHP + 15) / 16;  // 7 row tiles of the weight gradients
constexpr int kSmemFloats =
    4 * kHP * kS + 2 * kRows * kS + kMTiles * kHP + 5 * kHP + kRows;
static_assert(kThreads / 32 == 2 * kMTiles, "two warps a row tile");
static_assert(kWMTiles <= kWarps, "a weight-gradient row tile a warp");

// This thread's share of the block's (kRows, kHP) phi tile, held in
// registers for the whole j loop: item q is the float4 (or float) number
// tid + kThreads q of the tile, row-major. Rows past HW hold -inf, so that
// relu(phi + off) is 0 there; columns past h hold 0 (as off does).
template <bool kVec4>
struct PhiRegs {
  static constexpr int kW = kVec4 ? 4 : 1;  // floats an item
  static constexpr int kPerRow = kHP / kW;
  static constexpr int kTotal = kRows * kPerRow;
  static constexpr int kItems = (kTotal + kThreads - 1) / kThreads;
  float v[kItems][kW];

  __device__ __forceinline__ void load(const float* __restrict__ phi, int p0, int HW, int h) {
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int e = threadIdx.x + kThreads * q;
      const int r = e / kPerRow;
      const int c = (e - r * kPerRow) * kW;
      const int p = p0 + r;
      const float* src = phi + static_cast<size_t>(p) * h + c;
      if (e < kTotal && p < HW && c < h) {
        if constexpr (kVec4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          v[q][0] = x.x;
          v[q][1] = x.y;
          v[q][2] = x.z;
          v[q][3] = x.w;
        } else {
          v[q][0] = src[0];
        }
      } else {
        const float fill = e < kTotal && p >= HW ? __int_as_float(0xff800000) : 0.0f;
#pragma unroll
        for (int w = 0; w < kW; ++w) v[q][w] = fill;
      }
    }
  }

  // dst (kRows, kS) swizzled = relu(phi + offs), offs (kHP,) zero past h
  __device__ __forceinline__ void build_h1(float* dst, const float* offs) const {
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int e = threadIdx.x + kThreads * q;
      if (e < kTotal) {
        const int r = e / kPerRow;
        const int c = (e - r * kPerRow) * kW;
        if constexpr (kVec4) {
          const float4 o = *reinterpret_cast<const float4*>(offs + c);
          *reinterpret_cast<float4*>(dst + sw(r, c)) =
              make_float4(fmaxf(v[q][0] + o.x, 0.0f), fmaxf(v[q][1] + o.y, 0.0f),
                          fmaxf(v[q][2] + o.z, 0.0f), fmaxf(v[q][3] + o.w, 0.0f));
        } else {
          dst[sw(r, c)] = fmaxf(v[q][0] + offs[c], 0.0f);
        }
      }
    }
  }
};

// D (kHP, kS) += Hs^T Ds over the block's kRows rows: warp w < kWMTiles owns
// accumulator rows 16 w .. 16 w + 15 (those below kHP) and all kWNT n-tiles.
__device__ __forceinline__ void weight_grad(float* D, const float* Hs, const float* Ds,
                                            int warp) {
  if (warp >= kWMTiles) return;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = 16 * warp;
  const bool rows_hi = m0 + 8 < kHP;
  // this j's product from zero, then one rounded add into the accumulator:
  // accumulating straight through the tensor cores drifted to 1.4e-4 x
  // max|dfc2| over J = 192 at the training shape (now 3.1e-6)
  float c[kWNT][4] = {};
  frag_mma<true, false, kWNT>(c, Hs, Ds, m0, 0, kWNT, kRows / 8, rows_hi);
#pragma unroll
  for (int i = 0; i < kWNT; ++i) {
#pragma unroll
    for (int dr = 0; dr < 2; ++dr) {
      if (dr == 0 || rows_hi) {
        float2* d = reinterpret_cast<float2*>(D + (m0 + g + 8 * dr) * kS + 8 * i + 2 * t);
        const float2 v = *d;
        *d = make_float2(v.x + c[i][2 * dr], v.y + c[i][2 * dr + 1]);
      }
    }
  }
}

// Y (kRows, kS) = relu(X W + bias) on the CUDA cores in the forward kernel's
// arithmetic (dk_mlp_tail.cu's tile_product and its header's contract): each
// output a float32 sum over k in ascending order, fmaf from zero (a padded k
// adds fmaf(0, 0, acc) = acc), then relu(acc + bias); so the result is bit
// for bit the forward's. Thread (ty, tx) < (8, 26) owns rows 8 ty .. + 7 and
// columns 4 tx .. + 3; four k a step read a float4 of each of its rows and of
// W's 4 columns a k: 12 shared loads for 128 fmaf. The last 48 threads wait.
__device__ __forceinline__ void forward_layer(float* Y, const float* X, const float* W,
                                              const float* bias, int ksteps) {
  constexpr int kRowsT = 8;
  constexpr int kColT = kHP / 4;  // 26 column groups
  static_assert(kRows / kRowsT * kColT <= kThreads, "a thread a block of 8 x 4");
  const int tid = threadIdx.x;
  if (tid >= kRows / kRowsT * kColT) return;
  const int ty = tid / kColT;
  const int c0 = 4 * (tid - ty * kColT);
  const float* xr = X + kRowsT * ty * kS;
  float acc[kRowsT][4] = {};
#pragma unroll 1
  for (int k = 0; k < 8 * ksteps; k += 4) {
    float4 a[kRowsT];
#pragma unroll
    for (int i = 0; i < kRowsT; ++i) {
      a[i] = *reinterpret_cast<const float4*>(xr + i * kS + (k ^ (i & 4)));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int kr = k + kk;
      const float4 b = *reinterpret_cast<const float4*>(W + kr * kS + (c0 ^ (kr & 4)));
#pragma unroll
      for (int i = 0; i < kRowsT; ++i) {
        const float x = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
        acc[i][0] = fmaf(x, b.x, acc[i][0]);
        acc[i][1] = fmaf(x, b.y, acc[i][1]);
        acc[i][2] = fmaf(x, b.z, acc[i][2]);
        acc[i][3] = fmaf(x, b.w, acc[i][3]);
      }
    }
  }
  const float4 bb = *reinterpret_cast<const float4*>(bias + c0);
#pragma unroll
  for (int i = 0; i < kRowsT; ++i) {
    *reinterpret_cast<float4*>(Y + (kRowsT * ty + i) * kS + (c0 ^ (i & 4))) =
        make_float4(fmaxf(acc[i][0] + bb.x, 0.0f), fmaxf(acc[i][1] + bb.y, 0.0f),
                    fmaxf(acc[i][2] + bb.z, 0.0f), fmaxf(acc[i][3] + bb.w, 0.0f));
  }
}

// Lane l < 16 of the result: |row l| of the 16 tile rows at T (the norm of
// the whole padded row), each summed in a fixed order.
__device__ __forceinline__ float row_norm(const float* T) {
  const int lane = threadIdx.x & 31;
  const int r = lane & 15;
  const int c0 = (lane >> 4) * (kHP / 2);
  float s = 0.0f;
#pragma unroll 4
  for (int c = c0; c < c0 + kHP / 2; ++c) {
    const float v = T[sw(r, c)];
    s = fmaf(v, v, s);
  }
  s += __shfl_xor_sync(0xffffffffu, s, 16);
  return sqrtf(s);
}

// The gap between a pre-activation from the tensor cores and the forward
// kernel's (sequential fmaf) is below kTau * sum_k |h[k] w[k]|, and that sum is
// at most |h| |w|: the dropped split terms (3 x 2^-22 a term), the 39 three-pass
// steps' float32 sums (which may truncate) and the forward's 104 rounded
// additions come to about 430 x 2^-24; kTau = 2^-13 is 4.8 times that. Where
// |a| <= kTau |h| |w| the sign of a is taken from forward_dot instead.
constexpr float kTau = 1.0f / 8192.0f;

// sum_k A[r, k] B[k, n] of two swizzled tiles in the forward kernel's order
// (fmaf from zero, k ascending; padded k add zeros exactly). Rare, so called
// rather than inlined at each of the 28 elements of a fragment row.
__device__ __noinline__ float forward_dot(const float* A, const float* B, int r, int n,
                                          int ksteps) {
  float s = 0.0f;
#pragma unroll 8
  for (int k = 0; k < 8 * ksteps; ++k) s = fmaf(A[sw(r, k)], B[sw(k, n)], s);
  return s;
}

// v[i][e]: this thread's sum for column 8 (nt0 + i) + 2 t + e. Sums over the
// warp's 8 row groups (a fixed butterfly), then red[mt][n] = the warp's sum.
__device__ __forceinline__ void column_sums(float* red, float (&v)[kNT][2], int mt,
                                            int nt0, int ntc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = v[i][e];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (i < ntc && lane < 4) red[mt * kHP + 8 * (nt0 + i) + 2 * lane + e] = s;
    }
  }
}

// dst[n] = red[0][n] + ... + red[kMTiles - 1][n], in that order, n < h. The
// caller has synchronized since red was written.
__device__ __forceinline__ void sum_rows(const float* red, float* __restrict__ dst, int h) {
  if (static_cast<int>(threadIdx.x) < h) {
    float s = red[threadIdx.x];
#pragma unroll
    for (int m = 1; m < kMTiles; ++m) s += red[m * kHP + threadIdx.x];
    dst[threadIdx.x] = s;
  }
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads, 1)
dk_mlp_tail_bwd_kernel(const float* __restrict__ phi, const float* __restrict__ off,
                       const float* __restrict__ g, const float* __restrict__ fc2,
                       const float* __restrict__ b2, const float* __restrict__ fc3,
                       const float* __restrict__ b3, const float* __restrict__ fc4,
                       float* __restrict__ dphi, float* __restrict__ doff_parts,
                       float* __restrict__ w_parts, int HW, int J, int h) {
  extern __shared__ float4 smem4[];
  float* W2 = reinterpret_cast<float*>(smem4);  // fc2 (in, out), swizzled
  float* W3 = W2 + kHP * kS;                    // fc3
  float* D2 = W3 + kHP * kS;                    // dfc2 accumulator, plain rows
  float* D3 = D2 + kHP * kS;                    // dfc3 accumulator
  float* X = D3 + kHP * kS;                     // (kRows, kS) tiles, swizzled
  float* Y = X + kRows * kS;
  float* red = Y + kRows * kS;                  // (kMTiles, kHP) column sums
  float* b2s = red + kMTiles * kHP;
  float* b3s = b2s + kHP;
  float* fc4s = b3s + kHP;
  float* offs = fc4s + kHP;                     // (kHP,) this j's off, zero past h
  float* w3n = offs + kHP;                      // (kHP,) |fc3[:, n]|
  float* gs = w3n + kHP;                        // (kRows,) this j's cotangent

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // the fragment's row group
  const int t = lane & 3;
  const int p0 = blockIdx.x * kRows;
  const int ksteps = (h + 7) / 8;
  // this warp's part of the (kRows, kHP) products
  const int mt = warp % kMTiles;
  const int m0 = 16 * mt;
  const int nt0 = warp < kMTiles ? 0 : kNT;
  const int ntc = warp < kMTiles ? kNT : kHP / 8 - kNT;
  const int sg = gq & 4;     // the swizzle of rows m0 + gq and m0 + gq + 8

  for (int i = tid; i < kHP * kHP; i += kThreads) {
    const int k = i / kHP;
    const int n = i - k * kHP;
    const bool in = k < h && n < h;
    W2[sw(k, n)] = in ? fc2[k * h + n] : 0.0f;
    W3[sw(k, n)] = in ? fc3[k * h + n] : 0.0f;
    D2[i] = 0.0f;
    D3[i] = 0.0f;
  }
  for (int i = tid; i < kHP; i += kThreads) {
    b2s[i] = i < h ? b2[i] : 0.0f;
    b3s[i] = i < h ? b3[i] : 0.0f;
    fc4s[i] = i < h ? fc4[i] : 0.0f;
    offs[i] = i < h ? off[i] : 0.0f;
  }
  if (tid < kRows) gs[tid] = p0 + tid < HW ? g[p0 + tid] : 0.0f;
  PhiRegs<kVec4> ph;
  ph.load(phi, p0, HW, h);
  __syncthreads();
  if (tid < kHP) {
    float s = 0.0f;
    for (int k = 0; k < kHP; ++k) s = fmaf(W3[sw(k, tid)], W3[sw(k, tid)], s);
    w3n[tid] = sqrtf(s);
  }

  float dphi_acc[kNT][4];
  float dfc4_acc[kNT][2], db3_acc[kNT][2], db2_acc[kNT][2];
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) dfc4_acc[i][e] = db3_acc[i][e] = db2_acc[i][e] = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) dphi_acc[i][e] = 0.0f;
  }
  // element (row m0 + gq + 8 (e >> 1), column 8 (nt0 + i) + 2 t + (e & 1)) of
  // a fragment; the float2 at columns 2 t, 2 t + 1 of row r of a tile is at
  const int row_a = (m0 + gq) * kS + 8 * nt0 + (2 * t ^ sg);
  const int row_b = row_a + 8 * kS;

  // the threads that fetch the next j's off (tid < kHP) and g (the next kRows)
  const int g_lane = tid - 128;
  static_assert(kHP <= 128 && 128 + kRows <= kThreads, "fetch lanes");

  for (int j = 0; j < J; ++j) {
    // fetched now, stored after the last read of offs and gs for this j
    float next = 0.0f;
    if (j + 1 < J) {
      if (tid < h) {
        next = off[static_cast<size_t>(j + 1) * h + tid];
      } else if (g_lane >= 0 && g_lane < kRows && p0 + g_lane < HW) {
        next = g[static_cast<size_t>(j + 1) * HW + p0 + g_lane];
      }
    }
    ph.build_h1(X, offs);
    __syncthreads();

    // Y = h2 = relu(h1 fc2 + b2), bit for bit the forward's
    forward_layer(Y, X, W2, b2s, ksteps);
    __syncthreads();

    // h3 = relu(h2 fc3 + b3); dfc4 += h3^T g; X = da3 = g fc4 [h3 > 0]
    float acc[kNT][4] = {};
    frag_mma<false, false, kNT>(acc, Y, W3, m0, nt0, ntc, ksteps, true);
    {
      const float ga = gs[m0 + gq];
      const float gb = gs[m0 + gq + 8];
      // where the sign of a3 is not certain, the forward's own a3
      const float nrm = row_norm(Y + m0 * kS);
      const float tau_a = kTau * __shfl_sync(0xffffffffu, nrm, gq);
      const float tau_b = kTau * __shfl_sync(0xffffffffu, nrm, gq + 8);
      const bool live_a = p0 + m0 + gq < HW;
      const bool live_b = p0 + m0 + gq + 8 < HW;
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        if (i < ntc) {
          const int n = 8 * (nt0 + i) + 2 * t;
          float d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float gr = e < 2 ? ga : gb;
            const int ne = n + (e & 1);
            float a3 = acc[i][e] + b3s[ne];
            if ((e < 2 ? live_a : live_b) && ne < h &&
                fabsf(a3) <= (e < 2 ? tau_a : tau_b) * w3n[ne]) {
              a3 = forward_dot(Y, W3, m0 + gq + 8 * (e >> 1), ne, ksteps) + b3s[ne];
            }
            const float h3 = fmaxf(a3, 0.0f);
            d[e] = h3 > 0.0f ? gr * fc4s[ne] : 0.0f;
            dfc4_acc[i][e & 1] = fmaf(h3, gr, dfc4_acc[i][e & 1]);
            db3_acc[i][e & 1] += d[e];
          }
          *reinterpret_cast<float2*>(X + row_a + 8 * i) = make_float2(d[0], d[1]);
          *reinterpret_cast<float2*>(X + row_b + 8 * i) = make_float2(d[2], d[3]);
        }
      }
    }
    __syncthreads();

    // dfc3 += h2^T da3; da2 = (da3 fc3^T) [h2 > 0]
    weight_grad(D3, Y, X, warp);
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
    }
    frag_mma<false, true, kNT>(acc, X, W3, m0, nt0, ntc, ksteps, true);
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      if (i < ntc) {
        const float2 ya = *reinterpret_cast<const float2*>(Y + row_a + 8 * i);
        const float2 yb = *reinterpret_cast<const float2*>(Y + row_b + 8 * i);
        acc[i][0] = ya.x > 0.0f ? acc[i][0] : 0.0f;
        acc[i][1] = ya.y > 0.0f ? acc[i][1] : 0.0f;
        acc[i][2] = yb.x > 0.0f ? acc[i][2] : 0.0f;
        acc[i][3] = yb.y > 0.0f ? acc[i][3] : 0.0f;
        db2_acc[i][0] += acc[i][0];
        db2_acc[i][1] += acc[i][1];
        db2_acc[i][0] += acc[i][2];
        db2_acc[i][1] += acc[i][3];
      }
    }
    __syncthreads();  // every read of da3 and h2 is done

    // X = da2, Y = h1 again
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      if (i < ntc) {
        *reinterpret_cast<float2*>(X + row_a + 8 * i) = make_float2(acc[i][0], acc[i][1]);
        *reinterpret_cast<float2*>(X + row_b + 8 * i) = make_float2(acc[i][2], acc[i][3]);
      }
    }
    ph.build_h1(Y, offs);
    __syncthreads();

    // dfc2 += h1^T da2; da1 = (da2 fc2^T) [h1 > 0]; dphi += da1; doff[j] partial
    weight_grad(D2, Y, X, warp);
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
    }
    frag_mma<false, true, kNT>(acc, X, W2, m0, nt0, ntc, ksteps, true);
    float col[kNT][2];
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      col[i][0] = col[i][1] = 0.0f;
      if (i < ntc) {
        const float2 ya = *reinterpret_cast<const float2*>(Y + row_a + 8 * i);
        const float2 yb = *reinterpret_cast<const float2*>(Y + row_b + 8 * i);
        const float d0 = ya.x > 0.0f ? acc[i][0] : 0.0f;
        const float d1 = ya.y > 0.0f ? acc[i][1] : 0.0f;
        const float d2 = yb.x > 0.0f ? acc[i][2] : 0.0f;
        const float d3 = yb.y > 0.0f ? acc[i][3] : 0.0f;
        dphi_acc[i][0] += d0;
        dphi_acc[i][1] += d1;
        dphi_acc[i][2] += d2;
        dphi_acc[i][3] += d3;
        col[i][0] = d0 + d2;
        col[i][1] = d1 + d3;
      }
    }
    column_sums(red, col, mt, nt0, ntc);
    if (j + 1 < J) {  // offs was last read before the barrier above, gs before that
      if (tid < kHP) {
        offs[tid] = next;
      } else if (g_lane >= 0 && g_lane < kRows) {
        gs[g_lane] = next;
      }
    }
    // also ends every read of X and Y before the next j overwrites them; red
    // is next written four barriers after this read
    __syncthreads();
    sum_rows(red, doff_parts + (static_cast<size_t>(blockIdx.x) * J + j) * h, h);
  }

#pragma unroll
  for (int i = 0; i < kNT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + m0 + gq + 8 * (e >> 1);
      const int n = 8 * (nt0 + i) + 2 * t + (e & 1);
      if (i < ntc && p < HW && n < h) dphi[static_cast<size_t>(p) * h + n] = dphi_acc[i][e];
    }
  }

  // this block's partial: dfc2 | dfc3 | dfc4 | db2 | db3
  const int hh = h * h;
  float* wp = w_parts + static_cast<size_t>(blockIdx.x) * (2 * hh + 3 * h);
  __syncthreads();
  for (int i = tid; i < hh; i += kThreads) {
    const int m = i / h;
    const int n = i - m * h;
    wp[i] = D2[m * kS + n];
    wp[hh + i] = D3[m * kS + n];
  }
  column_sums(red, dfc4_acc, mt, nt0, ntc);
  __syncthreads();
  sum_rows(red, wp + 2 * hh, h);
  __syncthreads();
  column_sums(red, db2_acc, mt, nt0, ntc);
  __syncthreads();
  sum_rows(red, wp + 2 * hh + h, h);
  __syncthreads();
  column_sums(red, db3_acc, mt, nt0, ntc);
  __syncthreads();
  sum_rows(red, wp + 2 * hh + 2 * h, h);
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
  if (h < 1 || h > kHP || HW < 1 || J < 1 || nblk != (HW + kRows - 1) / kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * kSmemFloats;
  const bool vec4 = h % 4 == 0 && reinterpret_cast<uintptr_t>(phi) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(off) % 16 == 0;
  auto kernel = vec4 ? dk_mlp_tail_bwd_kernel<true> : dk_mlp_tail_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<nblk, kThreads, smem, s>>>(phi, off, g, fc2, b2, fc3, b3, fc4, dphi, doff_parts,
                                      w_parts, HW, J, h);
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
