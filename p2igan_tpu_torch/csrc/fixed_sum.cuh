// Order-free float sums of the port's scatter kernels (#4
// combine_table_multi_bwd.cu, #6 combine_table_bwd.cu, #10 idw_scatter.cu).
//
// Every term is rounded once to a 64-bit fixed-point integer and the integers
// are added with atomics. Integer addition is associative, so a total does not
// depend on the order in which threads, warps or blocks add, nor on the launch
// shape; fixed_finish_kernel converts each total back to float32. Two runs on
// the same inputs give the same bits, as the TPU reference does.
//
// Scale. The terms of one row (a window, a sample) are w * g with 0 <= w <= 1
// (normalized IDW weights), and a target takes at most `terms` of them, so
// |total| < 2^L * M with L = bit length of `terms` and M at least the row's
// largest finite |term| (row_absmax_kernel, read by the kernels through a
// pointer: no host sync). #4 and #6 compute their terms inside the selection
// and take M = the largest |g|; #10 reads its terms' weights and takes the
// largest |w * g| itself, so that a sample whose every weight is tiny (no valid
// point: weights of ~1e-18) keeps its precision. With M < 2^e (frexp), a term
// is scaled by 2^s, s = 62 - L - e, so |total| * 2^s < 2^62 and the rounding of
// 2^L terms (half a unit each) keeps it below 2^63. A unit is 2^(L + e - 62),
// at most 2^-42 M at 2^18 terms: finer than the float32 rounding of the same
// sum. A term below half a unit rounds to 0. The scaling runs in double, whose
// range holds 2^s for any float32 M, subnormal included.
//
// Non-finite terms. A NaN or infinite term does not enter the integer sum; it
// sets a flag of its target (atomicOr, also order-free), and fixed_finish_kernel
// gives what the float sum gives: NaN for any NaN or for both infinities, else
// the infinity. So a non-finite cotangent reaches exactly the targets it
// touches.

#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace p2i {

using u64 = unsigned long long;

constexpr unsigned kFlagPosInf = 1u;
constexpr unsigned kFlagNegInf = 2u;
constexpr unsigned kFlagNaN = 4u;

// L of the scale: the bit length of the largest number of terms a target takes.
static inline int fixed_log2_terms(long long terms) {
  int bits = 0;
  while (terms > 0) {
    ++bits;
    terms >>= 1;
  }
  return bits;
}

// rowmax[r] = max |x| over the finite x of row r, as float bits: non-negative
// floats order as their bits, so atomicMax is exact and order-free. The n
// values of a row are g's (w null) or the terms w[i] * g[i / k] (w and g rows
// of n and n / k). rowmax is zeroed before; a row of zeros (or of non-finite
// values only) leaves 0. Grid (any, rows).
static __global__ void row_absmax_kernel(const float* __restrict__ g,
                                         const float* __restrict__ w, int k,
                                         unsigned* __restrict__ rowmax, long long n) {
  const size_t r = blockIdx.y;
  unsigned m = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float a = w == nullptr ? fabsf(g[r * n + i])
                                 : fabsf(__fmul_rn(w[r * n + i], g[r * (n / k) + i / k]));
    if (a <= FLT_MAX) m = max(m, __float_as_uint(a));  // NaN and inf fail the test
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0 && m != 0) atomicMax(rowmax + r, m);
}

// s of the scale for a row whose M has the bits max_bits.
__device__ __forceinline__ int fixed_shift(unsigned max_bits, int log2_terms) {
  int e = 0;
  frexpf(__uint_as_float(max_bits), &e);  // M = m 2^e, m in [0.5, 1); M = 0 gives e = 0
  return 62 - log2_terms - e;
}

// Adds term t into the fixed-point total acc (shared or global), or, when t is
// not finite, sets its flag in the global flag word.
__device__ __forceinline__ void fixed_add(u64* acc, unsigned* flag, float t, int shift) {
  if (fabsf(t) <= FLT_MAX) {
    const long long v = __double2ll_rn(ldexp(static_cast<double>(t), shift));
    if (v != 0) atomicAdd(acc, static_cast<u64>(v));
  } else {
    atomicOr(flag, t != t ? kFlagNaN : (t > 0.0f ? kFlagPosInf : kFlagNegInf));
  }
}

// fixed_add into a shared tile, for the per-sample combine's backward (#6):
// the scale 2^shift comes as a double formed once (ldexp(1.0, shift); the
// product of a float32 and a power of two within double's range is exact, so
// a term rounds to the same integer as through ldexp), and the 64-bit add is
// made of two 32-bit shared atomics: the low word's add returns the word's
// old value, from which its carry is known exactly and added to the high word
// with the high half. The total is the same sum modulo 2^64 in any order. A
// 64-bit shared atomicAdd took 1.7x as long in #6 on the H100 (PERF.md).
__device__ __forceinline__ void fixed_add_shared(u64* acc, unsigned* flag, float t,
                                                 double scale) {
  if (fabsf(t) <= FLT_MAX) {
    const u64 v = static_cast<u64>(__double2ll_rn(static_cast<double>(t) * scale));
    if (v != 0) {
      unsigned* word = reinterpret_cast<unsigned*>(acc);  // little-endian: low word first
      const unsigned lo = static_cast<unsigned>(v);
      const unsigned old = atomicAdd(word, lo);
      const unsigned carry = old + lo < old ? 1u : 0u;
      atomicAdd(word + 1, static_cast<unsigned>(v >> 32) + carry);
    }
  } else {
    atomicOr(flag, t != t ? kFlagNaN : (t > 0.0f ? kFlagPosInf : kFlagNegInf));
  }
}

// Adds a block's shared tile of n totals into the global totals; zeros are
// skipped (most of a tile stays untouched).
__device__ __forceinline__ void fixed_flush(const u64* tile, u64* acc, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (tile[i] != 0) atomicAdd(acc + i, tile[i]);
  }
}

// out[i]: total i as float32 (one rounding of the integer, then the exact
// power-of-two scaling; a subnormal result rounds twice), or the non-finite
// value its flags give. Row of i: i / per_row.
static __global__ void fixed_finish_kernel(const u64* __restrict__ acc,
                                           const unsigned* __restrict__ flags,
                                           const unsigned* __restrict__ rowmax,
                                           float* __restrict__ out, long long total,
                                           long long per_row, int log2_terms) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const unsigned f = flags[i];
  float r;
  if ((f & kFlagNaN) != 0 || (f & (kFlagPosInf | kFlagNegInf)) == (kFlagPosInf | kFlagNegInf)) {
    r = __int_as_float(0x7fc00000);
  } else if (f != 0) {
    r = __int_as_float(f == kFlagPosInf ? 0x7f800000 : 0xff800000);
  } else {
    const int shift = fixed_shift(rowmax[i / per_row], log2_terms);
    r = ldexpf(__ll2float_rn(static_cast<long long>(acc[i])), -shift);
  }
  out[i] = r;
}

// The scratch of one sum: `total` u64 totals, `total` flag words and one max a
// row, in one caller-allocated buffer of fixed_scratch_bytes (the kernels
// allocate nothing).
struct FixedScratch {
  u64* acc;
  unsigned* flags;
  unsigned* rowmax;
};

static inline size_t fixed_scratch_bytes(long long total, int rows) {
  return static_cast<size_t>(total) * (sizeof(u64) + sizeof(unsigned)) +
         static_cast<size_t>(rows) * sizeof(unsigned);
}

// Zeroes the scratch and takes each row's M: the max |g| (w null) or the max
// |w * g| (k weights a g), over rows of n values.
static inline cudaError_t fixed_begin(void* scratch, long long total, const float* g,
                                      const float* w, int k, int rows, long long n,
                                      cudaStream_t s, FixedScratch& fs) {
  fs.acc = static_cast<u64*>(scratch);
  fs.flags = reinterpret_cast<unsigned*>(fs.acc + total);
  fs.rowmax = fs.flags + total;
  cudaError_t err = cudaMemsetAsync(scratch, 0, fixed_scratch_bytes(total, rows), s);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + 255) / 256;
  const dim3 grid(static_cast<unsigned>(blocks < 64 ? blocks : 64), rows);
  row_absmax_kernel<<<grid, 256, 0, s>>>(g, w, k, fs.rowmax, n);
  return cudaGetLastError();
}

static inline cudaError_t fixed_end(const FixedScratch& fs, float* out, long long total,
                                    long long per_row, int log2_terms, cudaStream_t s) {
  fixed_finish_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      fs.acc, fs.flags, fs.rowmax, out, total, per_row, log2_terms);
  return cudaGetLastError();
}

}  // namespace p2i
