// Backward of the per-sample factored IDW combine: d_tables (B, D, G) from the
// output cotangent g (B, D, HW), every sample with its own gauge selection.
//
// Replaces p2igan_tpu/ops/pallas/idw_factored_kernel.py::
// factored_combine_table_bwd_pallas (_combine_table_bwd_kernel), which the JAX
// package vmaps over the batch; here the batch is grid.y of one launch. The
// forward is linear in the table and its selection depends only on the mask
// geometry, so no values are saved: for every (pixel, z) the forward's
// selection is re-run (csrc/idw_select.cuh, the same code) and each selected
// candidate r (frame f, gauge slot s) receives wnorm_r * g[b, z, p], with
// wnorm_r = w_r / (w_sum + 1e-12) as in the TPU kernel. Its (D, D, kf) route
// matmuls and one-hot scatter matmuls are MXU devices; here the route is
// sel[z][fi] and the scatter an atomic add.
//
// One thread per (sample, pixel) walks all D query frames, as the forward
// does (combine_table.cu). Its selection reads the pixel's table of the nv*k
// distinct candidate distances, built once (select_from_table), where the
// table's shared memory costs no block an SM (the 147 KB tile at G=1152
// leaves room for it), and otherwise computes each frame's kf*k distances
// into registers (select_candidates; at G=256 the 26.6 KB of tables beside
// the 32 KB tile cost more blocks than their square roots save). With k=4,
// kf=5 the rounds run on registers (idw_select.cuh select_rounds).
//
// Accumulation: HW pixels feed G slots (16384 into 256, or into 1152), so a
// block sums the contributions of its pixels, for all D query frames, into a
// (D, G) tile of 64-bit fixed-point totals in shared memory and adds the tile's
// non-zero totals into the global ones. Both adds are integer adds
// (fixed_sum.cuh): the result does not depend on their order or on the grid,
// and two runs agree bit for bit. A term goes into the tile as two 32-bit
// shared atomics with an exact carry (fixed_add_shared); a 64-bit shared
// atomic took most of the kernel's time. The tile is D*G*8 bytes: 32 KB at
// G=256, 144 KB at G=1152 (dynamic shared memory, opted in by the launcher);
// the wrapper refuses a block beyond the limit. A block walks `iters` strips
// of 128 pixels, so that a large tile is zeroed and flushed once for more
// pixels.
//
// Bound on the H100: the selection, as in the forward (not shared between
// samples: k rounds over kf*k candidates per (sample, z, pixel)), then the
// terms' rounding and adds; the cotangent read is B*D*HW*4 bytes (12.6 MB at
// B=12).
//
// Rounding: the weights are the forward's bit for bit; each term is rounded
// once to the fixed point (a unit of at most 2^-42 of the sample's largest
// |g|) and the total once back to float32: bit for bit the fixed-point sum of
// the plain selection's terms (combine_table_bwd_fixed_reference), and within
// a tolerance of the plain version (float32 sums in autograd's order).

#include <cuda_runtime.h>

#include "fixed_sum.cuh"
#include "idw_select.cuh"

namespace {

using p2i::kMaxK;
using p2i::u64;

constexpr int kThreads = 128;  // pixels per strip

// K, KF: k and kf at compile time (4, 5: D=16, k=4), or 0 for run time.
// kTable: the selection reads the pixel's table of distinct distances, built
// once (select_from_table), or computes each (z, pixel)'s kf*k distances from
// the pruned fd2 (select_candidates), which leaves the table's shared memory
// to more blocks an SM. The two give the same bits.
template <int K, int KF, bool kTable>
__global__ void combine_table_bwd_kernel(
    const float* __restrict__ gd2, const int* __restrict__ gsel,
    const float* __restrict__ g, const int* __restrict__ sel,
    const float* __restrict__ fd2, const float* __restrict__ vals,
    const int* __restrict__ vmap, u64* __restrict__ acc, unsigned* __restrict__ flags,
    const unsigned* __restrict__ rowmax, int D, int G, int HW, int k, int kf,
    int nv, float rho, float tau, int rho_is_2, int iters, int log2_terms) {
  extern __shared__ u64 smem_u[];
  const int plane = D * G;
  const int nsel = D * kf;
  const size_t b = blockIdx.y;
  u64* s_acc = smem_u;                                            // (D, G)
  int* s_sel = reinterpret_cast<int*>(s_acc + plane);             // (D, kf)
  int* s_vmap = s_sel + nsel;                                     // (D, kf)
  float* s_fd2 = reinterpret_cast<float*>(s_vmap + nsel);         // (D, kf*k)
  float* s_vals = s_fd2 + nsel * k;                               // (nv,)
  float* s_dist = s_vals + nv;                                    // (nv*k, kThreads)
  for (int i = threadIdx.x; i < plane; i += kThreads) s_acc[i] = 0;
  for (int i = threadIdx.x; i < nsel; i += kThreads) {
    s_sel[i] = sel[i];
    s_vmap[i] = vmap[i];
  }
  for (int i = threadIdx.x; i < nsel * k; i += kThreads) s_fd2[i] = fd2[i];
  for (int i = threadIdx.x; i < nv; i += kThreads) s_vals[i] = vals[i];
  __syncthreads();

  const float* gd2_b = gd2 + b * k * HW;
  const int* gsel_b = gsel + b * k * HW;
  const float* g_b = g + b * D * HW;
  unsigned* flags_b = flags + b * plane;
  const double scale = ldexp(1.0, p2i::fixed_shift(rowmax[b], log2_terms));
  float* t = s_dist + threadIdx.x;
  for (int it = 0; it < iters; ++it) {
    const int p = (blockIdx.x * iters + it) * kThreads + threadIdx.x;
    if (p >= HW) break;
    float g2[kMaxK];
    int gs[kMaxK];
    p2i::load_gauges(gd2_b, gsel_b, p, HW, k, g2, gs);
    if constexpr (kTable) p2i::distance_table(g2, s_vals, nv, k, t, kThreads);
    for (int z = 0; z < D; ++z) {
      float wr[kMaxK];
      int off[kMaxK];
      float denom;
      if constexpr (kTable) {
        denom = p2i::select_from_table<K, KF>(t, kThreads, s_vmap + z * kf, gs,
                                              s_sel + z * kf, G, k, kf, rho, tau, rho_is_2,
                                              wr, off);
      } else {
        denom = p2i::select_candidates<K, KF>(g2, gs, s_fd2 + z * kf * k, s_sel + z * kf, G,
                                              k, kf, rho, tau, rho_is_2, wr, off);
      }
      const float gv = g_b[static_cast<size_t>(z) * HW + p];
#pragma unroll
      for (int r = 0; r < kMaxK; ++r) {
        if (r < k) {
          p2i::fixed_add_shared(s_acc + off[r], flags_b + off[r],
                                __fmul_rn(__fdiv_rn(wr[r], denom), gv), scale);
        }
      }
    }
  }
  __syncthreads();
  p2i::fixed_flush(s_acc, acc + b * plane, plane);
}

using Kernel = void (*)(const float*, const int*, const float*, const int*, const float*,
                        const float*, const int*, u64*, unsigned*, const unsigned*, int, int,
                        int, int, int, int, float, float, int, int, int);

template <bool kTable>
Kernel pick(int k, int kf) {
  return k == 4 && kf == 5 ? combine_table_bwd_kernel<4, 5, kTable>
                           : combine_table_bwd_kernel<0, 0, kTable>;
}

// Blocks an SM of `kernel` at `smem` bytes of shared memory (0 if it cannot
// launch at all).
int blocks_per_sm(Kernel kernel, size_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    cudaGetLastError();  // clear it: the other variant may still fit
    return 0;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

}  // namespace

// scratch: p2i::fixed_scratch_bytes(B * D * G, B) bytes (the caller allocates
// it). Takes the pixels' distance tables where they cost no block an SM.
// Returns a cudaError_t.
extern "C" int p2i_combine_table_bwd(const float* gd2, const int* gsel,
                                     const float* g, const int* sel, const float* fd2,
                                     const float* vals, const int* vmap,
                                     void* scratch, float* out, int B, int D, int G,
                                     int HW, int k, int kf, int nv, float rho, float tau,
                                     int rho_is_2, int iters, void* stream) {
  if (iters < 1 || B < 1 || D < 1 || G < 1 || HW < 1 || k < 1 || k > kMaxK || kf < 1 ||
      nv < 1 || kf * k > p2i::kMaxCand) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the (D, G) tile, sel, the map, fd2 and the distinct values; with the
  // table, the tables of a strip's pixels
  const size_t smem = static_cast<size_t>(D) * G * sizeof(u64) +
                      (static_cast<size_t>(D) * kf * (2 + k) + nv) * 4;
  const size_t smem_table = smem + static_cast<size_t>(nv) * k * kThreads * 4;
  const Kernel table = pick<true>(k, kf);
  const Kernel direct = pick<false>(k, kf);
  const int n_direct = blocks_per_sm(direct, smem);
  if (n_direct == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool use_table = blocks_per_sm(table, smem_table) >= n_direct;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = static_cast<long long>(D) * G;
  const long long total = B * plane;
  p2i::FixedScratch fs;
  cudaError_t err = p2i::fixed_begin(scratch, total, g, nullptr, 1, B,
                                     static_cast<long long>(D) * HW, s, fs);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int log2_terms = p2i::fixed_log2_terms(static_cast<long long>(D) * HW);
  dim3 grid((HW + kThreads * iters - 1) / (kThreads * iters), B);
  (use_table ? table : direct)<<<grid, kThreads, use_table ? smem_table : smem, s>>>(
      gd2, gsel, g, sel, fd2, vals, vmap, fs.acc, fs.flags, fs.rowmax, D, G, HW, k, kf, nv,
      rho, tau, rho_is_2, iters, log2_terms);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(p2i::fixed_end(fs, out, total, plane, log2_terms, s));
}
