// Backward of the generic IDW k-NN (#8 and #9): d_values (B, Pp) from the
// forward's saved selection, sel_idx (B, Q, k) int32 and w_norm (B, Q, k), and
// the output cotangent g (B, Q): every query adds w_norm[q, r] * g[q] into its
// r-th selected point.
//
// Replaces p2igan_tpu/ops/pallas/idw_kernel.py::idw_3d_knn_bwd_pallas
// (_idw_bwd_kernel): the same function, d_values of the single pass (P <=
// 4096), computed from the forward's residuals as the JAX package's P > 4096
// backward does, not by re-running the selection; one kernel serves both
// ranges. The selection (the forward's work) is not repeated: the backward is
// a scatter of Q*k terms.
//
// Accumulation: the terms are summed as 64-bit fixed-point integers
// (fixed_sum.cuh), so the result does not depend on the order of the adds, on
// the grid or on the order of the queries: two runs agree bit for bit. Up to
// kTilePoints points a block sums its queries' terms into a (Pp,) tile in
// shared memory (32 KB at Pp = 4096) and adds the tile's non-zero totals into
// the global ones; above, the terms go straight into the global totals. A
// thread walks (query, rank) pairs in memory order, so the reads of sel_idx
// and w_norm are coalesced.
//
// Bound on the H100: bytes. sel_idx + w_norm + g are read once: 113 MB at
// B=12, Q=262144, k=4, 0.034 ms at 3.35 TB/s; the atomics are k a query. The
// scale's pass reads w_norm and g once more.
//
// Rounding: each term w * g is rounded once (round to nearest, as the plain
// version's product) to the fixed point, a unit of at most 2^-42 of the
// sample's largest |term|, and each total once back to float32; the plain
// version (index_add_ of the same float32 terms) agrees to a tolerance.

#include <cuda_runtime.h>

#include "fixed_sum.cuh"

namespace {

using p2i::u64;

constexpr int kThreads = 256;
constexpr int kTilePoints = 4096;   // the shared tile's limit
constexpr int kBlocksPerSample = 16;  // shared tiles flushed a sample
constexpr int kGlobalQueries = 2048;  // queries a block without a tile

template <bool kTile>
__global__ void idw_scatter_kernel(const int* __restrict__ sel,
                                   const float* __restrict__ w,
                                   const float* __restrict__ g, u64* __restrict__ acc,
                                   unsigned* __restrict__ flags,
                                   const unsigned* __restrict__ rowmax, int Pp, int Q,
                                   int k, int q_block, int log2_terms) {
  extern __shared__ u64 s_tile[];  // (Pp,) when kTile
  const size_t b = blockIdx.y;
  u64* acc_b = acc + b * Pp;
  unsigned* flags_b = flags + b * Pp;
  u64* target = kTile ? s_tile : acc_b;
  if (kTile) {
    for (int i = threadIdx.x; i < Pp; i += blockDim.x) s_tile[i] = 0;
    __syncthreads();
  }
  const int shift = p2i::fixed_shift(rowmax[b], log2_terms);
  const long long q0 = static_cast<long long>(blockIdx.x) * q_block;
  const long long q1 = min(static_cast<long long>(Q), q0 + q_block);
  const int* sel_b = sel + b * Q * k;
  const float* w_b = w + b * Q * k;
  const float* g_b = g + b * Q;
  for (long long i = q0 * k + threadIdx.x; i < q1 * k; i += blockDim.x) {
    const int p = sel_b[i];
    if (static_cast<unsigned>(p) < static_cast<unsigned>(Pp)) {
      p2i::fixed_add(target + p, flags_b + p, __fmul_rn(w_b[i], g_b[i / k]), shift);
    }
  }
  if (kTile) {
    __syncthreads();
    p2i::fixed_flush(s_tile, acc_b, Pp);
  }
}

}  // namespace

// sel: (B, Q, k) int32 indices into [0, Pp) (an index outside adds nothing);
// w: (B, Q, k) weights in [0, 1]; g: (B, Q); out: (B, Pp); scratch:
// p2i::fixed_scratch_bytes(B * Pp, B) bytes (the caller allocates it).
// Returns a cudaError_t.
extern "C" int p2i_idw_scatter(const int* sel, const float* w, const float* g,
                               void* scratch, float* out, int B, int Q, int k, int Pp,
                               void* stream) {
  if (B < 1 || Q < 1 || k < 1 || Pp < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(B) * Pp;
  p2i::FixedScratch fs;
  cudaError_t err = p2i::fixed_begin(scratch, total, g, w, k, B, static_cast<long long>(Q) * k, s, fs);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int log2_terms = p2i::fixed_log2_terms(Q);
  if (Pp <= kTilePoints) {
    const int nblk = min(kBlocksPerSample, (Q + kGlobalQueries - 1) / kGlobalQueries);
    const int q_block = (Q + nblk - 1) / nblk;
    const size_t smem = static_cast<size_t>(Pp) * sizeof(u64);
    idw_scatter_kernel<true><<<dim3(nblk, B), kThreads, smem, s>>>(
        sel, w, g, fs.acc, fs.flags, fs.rowmax, Pp, Q, k, q_block, log2_terms);
  } else {
    const int nblk = (Q + kGlobalQueries - 1) / kGlobalQueries;
    idw_scatter_kernel<false><<<dim3(nblk, B), kThreads, 0, s>>>(
        sel, w, g, fs.acc, fs.flags, fs.rowmax, Pp, Q, k, kGlobalQueries, log2_terms);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(p2i::fixed_end(fs, out, total, Pp, log2_terms, s));
}
