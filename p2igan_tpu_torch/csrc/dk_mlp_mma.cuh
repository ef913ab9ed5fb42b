// Warp-level tile products on the tensor cores at float32 accuracy (3xTF32),
// for the DK/STDK MLP tail backward (dk_mlp_tail_bwd.cu).
//
// Every operand lives in shared memory as a row-major tile of kS = 104 floats
// a row (the hidden width padded to a multiple of 8 with zeros), swizzled:
// element (r, c) sits at r * kS + (c ^ (r & 4)). kS is 8 mod 32, so a warp's
// fragment reads are conflict-free whether the row index varies with the
// thread's group (g = lane / 4) or with its index in the group (t = lane % 4):
// the first falls on banks 8 g + (t ^ (g & 4)), the second on 8 t + g. So one
// stored copy of a matrix serves plain or transposed, as A or as B, and the
// float2 stores of an output fragment (row g, columns 2 t, 2 t + 1) are
// conflict-free too.
//
// mma.sync.m16n8k8 takes TF32 operands (10 explicit mantissa bits). Each
// float32 operand is split on the fly, hi = rna(x), lo = rna(x - hi), and a
// product is lo*hi + hi*lo + hi*hi in three MMAs accumulated in float32; the
// dropped lo*lo term and the rounding of lo leave about 2^-21 of each
// product, where a single TF32 pass leaves 2^-11 (tests/test_torch_tf32x3.py
// holds the split to the tail's tolerances on the CPU). The order of the MMAs
// is fixed, so a product repeats bit for bit.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace dkmma {

constexpr int kHP = 104;   // hidden width padded to a multiple of 8
constexpr int kS = kHP;    // row stride of every tile, 8 mod 32
static_assert(kS % 32 == 8, "the swizzle needs a row stride of 8 mod 32");

// Offset of element (r, c) of a swizzled tile.
__device__ __forceinline__ int sw(int r, int c) { return r * kS + (c ^ (r & 4)); }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (what lo's rounding drops), both halves TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a b for one 16x8x8 step: a as (row g, col t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b as (k t, n g), (t + 4, g); d as (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[i] += A(m0 .. m0 + 15, 0 .. 8 ksteps) B(same k, n-tile nt0 + i), for
// i < ntc (warp-uniform, at most NT), in 3xTF32. A(m, k) is tile A at (m, k),
// or at (k, m) when kAT; B(k, n) is tile B at (k, n), or at (n, k) when kBT.
// Without rows_hi the rows m0 + 8 .. m0 + 15 of A are read as zeros (the last
// half tile of a 104-row operand).
template <bool kAT, bool kBT, int NT>
__device__ __forceinline__ void frag_mma(float (&acc)[NT][4], const float* A,
                                         const float* B, int m0, int nt0, int ntc,
                                         int ksteps, bool rows_hi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int sg = g & 4;
  // element offsets at k0 = 0: a[dr + 2 dc] at (m0 + g + 8 dr, t + 4 dc),
  // b[dc] at (t + 4 dc, 8 nt + g); a k step adds ka (kb)
  int ao[4];
#pragma unroll
  for (int dc = 0; dc < 2; ++dc) {
#pragma unroll
    for (int dr = 0; dr < 2; ++dr) {
      ao[dr + 2 * dc] = kAT ? (t + 4 * dc) * kS + m0 + 8 * dr + (g ^ (4 * dc))
                            : (m0 + g + 8 * dr) * kS + t + ((4 * dc) ^ sg);
    }
  }
  int bo[2];
#pragma unroll
  for (int dc = 0; dc < 2; ++dc) {
    bo[dc] = kBT ? (8 * nt0 + g) * kS + t + ((4 * dc) ^ sg)
                 : (t + 4 * dc) * kS + 8 * nt0 + (g ^ (4 * dc));
  }
  const int ka = kAT ? 8 * kS : 8;
  const int kb = kBT ? 8 : 8 * kS;
  const int nb = kBT ? 8 * kS : 8;  // the next n-tile of B
#pragma unroll 2
  for (int s = 0; s < ksteps; ++s) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool live = rows_hi || (e & 1) == 0;
      split(live ? A[ao[e] + s * ka] : 0.0f, ah[e], al[e]);
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (i < ntc) {
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int dc = 0; dc < 2; ++dc) split(B[bo[dc] + i * nb + s * kb], bh[dc], bl[dc]);
        mma_tf32(acc[i], al, bh);
        mma_tf32(acc[i], ah, bl);
        mma_tf32(acc[i], ah, bh);
      }
    }
  }
}

}  // namespace dkmma
