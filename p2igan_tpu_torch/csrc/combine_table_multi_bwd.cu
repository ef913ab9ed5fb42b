// Backward of the multi-window factored IDW combine: d_tables (N, D, G) from the
// output cotangent g (N, D, HW).
//
// Replaces p2igan_tpu/ops/pallas/idw_factored_kernel.py::
// factored_combine_table_multi_bwd_pallas (_combine_table_multi_bwd_kernel).
// The forward is linear in the tables, and its selection depends only on the
// mask geometry, so the backward needs no saved values: for every (pixel, z)
// it re-runs the forward's selection (csrc/idw_select.cuh, the same code the
// forward runs) and, for every window n and selected candidate r (frame f,
// gauge slot s), adds wnorm_r * g[n, z, p] to d_tables[n, f, s], with
// wnorm_r = w_r / (w_sum + 1e-12) as in the TPU kernel.
//
// One thread a (pixel, z): a block of kThreads threads takes kThreads / D
// pixels with all their D query frames, and a warp's lanes run over z first
// (2 pixels x 16 frames at D=16). The selection runs once a (pixel, z), for
// all N windows: with k=4, kf=5 its kf*k candidate distances are computed
// once into registers and the rounds run there (select_candidates<4, 5>),
// otherwise at run time. Its k normalized weights and targets stay in
// registers while the thread adds the terms of every window.
//
// Accumulation: HW pixels feed G slots, so a block first sums its terms in
// shared memory. Its pixels are neighbours and reach only a few gauge slots:
// the block marks the slots of its pixels' k nearest gauges and numbers them
// (gl of them), and its tile holds (windows, D, pitch) 64-bit fixed-point
// totals with pitch = gl rounded up to odd, so that the 16 query frames of a
// warp add into 16 different banks. The tile takes as many windows as the
// launcher's budget holds at the block's own gl (all 12 at the training shape);
// more windows take further rounds of zeroing, adding and flushing, with the
// selection kept in registers. A term goes into the tile as two 32-bit shared
// atomics with an exact carry (fixed_sum.cuh fixed_add_shared, each window's
// scale formed once as a double), and the tile's non-zero totals go into the
// global ones as 64-bit atomics. All adds are integer adds, so the result does
// not depend on their order, on the block's slot numbering, on the windows a
// tile takes or on the grid: two runs agree bit for bit. The TPU kernel writes
// one partial per pixel block and sums them outside; its one-hot MXU scatter
// becomes the atomics here.
//
// Bound on the H100: the cotangent read, N*D*HW*4 bytes (12.6 MB at N=12),
// twice (once for each window's largest |g|, fixed_begin); then the selection
// (once a (pixel, z)) and the N*D*HW*k terms' rounding and shared adds.
//
// Rounding: the weights are the forward's bit for bit; each term w * g is
// rounded once to the fixed point (a unit of at most 2^-42 of the window's
// largest |g|) and the total once back to float32: bit for bit the
// fixed-point sum of the plain selection's terms
// (combine_table_multi_bwd_fixed_reference), and within a tolerance of the
// plain version (float32 sums in autograd's order).

#include <cuda_runtime.h>

#include "fixed_sum.cuh"
#include "idw_select.cuh"

namespace {

using p2i::kMaxK;
using p2i::u64;

constexpr int kThreads = 512;  // (pixel, z) pairs a block

// Pixels a block at D query frames.
__host__ __device__ __forceinline__ int block_pixels(int D) { return kThreads / D; }

// The widest tile row a block may need: its pixels' k slots each, at most G,
// rounded up to odd.
__host__ __device__ __forceinline__ int widest_pitch(int D, int G, int k) {
  const int most = k * block_pixels(D);
  return (most < G ? most : G) | 1;
}

// K, KF: k and kf at compile time (4, 5: D=16, k=4), or 0 for run time.
// tile_cap: u64 entries of the tile (at least D * widest_pitch).
template <int K, int KF>
__global__ void __launch_bounds__(kThreads, 2) combine_table_multi_bwd_kernel(
    const float* __restrict__ gd2, const int* __restrict__ gsel,
    const float* __restrict__ g, const int* __restrict__ sel,
    const float* __restrict__ fd2, u64* __restrict__ acc,
    unsigned* __restrict__ flags, const unsigned* __restrict__ rowmax, int N,
    int D, int G, int HW, int k, int kf, float rho, float tau, int rho_is_2,
    int tile_cap, int log2_terms) {
  extern __shared__ u64 smem_u[];
  __shared__ int s_count;
  const int ncand = kf * k;
  u64* s_acc = smem_u;                                          // (tile_cap,)
  int* s_map = reinterpret_cast<int*>(s_acc + tile_cap);        // (G,) slot -> local
  int* s_slots = s_map + G;                                     // (G,) local -> slot
  float* s_fd2 = reinterpret_cast<float*>(s_slots + G);         // (D, kf*k)
  int* s_sel = reinterpret_cast<int*>(s_fd2 + D * ncand);       // (D, kf)
  for (int i = threadIdx.x; i < G; i += kThreads) s_map[i] = 0;
  for (int i = threadIdx.x; i < D * ncand; i += kThreads) s_fd2[i] = fd2[i];
  for (int i = threadIdx.x; i < D * kf; i += kThreads) s_sel[i] = sel[i];

  const int pl = threadIdx.x / D;
  const int z = threadIdx.x - pl * D;
  const int p = blockIdx.x * block_pixels(D) + pl;
  const bool active = pl < block_pixels(D) && p < HW;
  float g2[kMaxK];
  int gs[kMaxK];
  if (active) p2i::load_gauges(gd2, gsel, p, HW, k, g2, gs);
  __syncthreads();
  // the slots this block's pixels reach, numbered in ascending slot order
  if (active && z == 0) {
#pragma unroll
    for (int s = 0; s < kMaxK; ++s) {
      if (s < k) s_map[gs[s]] = 1;
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0;
    for (int c = 0; c < G; c += 32) {
      const int i = c + lane;
      const bool used = i < G && s_map[i] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, used);
      if (used) {
        const int local = base + __popc(m & ((1u << lane) - 1u));
        s_map[i] = local;
        s_slots[local] = i;
      }
      base += __popc(m);
    }
    if (lane == 0) s_count = base;
  }
  __syncthreads();
  const int pitch = s_count | 1;
  const int lplane = D * pitch;
  const int windows = tile_cap / lplane;  // >= 1: tile_cap >= D * widest_pitch

  // the selection, once for every window: normalized weights, global and
  // tile offsets of the k targets
  float wn[kMaxK];
  int off[kMaxK], loff[kMaxK];
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    wn[r] = 0.0f;
    off[r] = 0;
    loff[r] = 0;
  }
  if (active) {
    float wr[kMaxK];
    const float denom = p2i::select_candidates<K, KF>(
        g2, gs, s_fd2 + z * ncand, s_sel + z * kf, G, k, kf, rho, tau, rho_is_2, wr, off);
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      if (r < k) {
        wn[r] = __fdiv_rn(wr[r], denom);
        const int f = off[r] / G;
        loff[r] = f * pitch + s_map[off[r] - f * G];
      }
    }
  }

  const size_t plane = static_cast<size_t>(D) * G;
  for (int n0 = 0; n0 < N; n0 += windows) {
    const int nt = min(windows, N - n0);
    const int tile = nt * lplane;
    if (n0 > 0) __syncthreads();  // the previous round's flush has read the tile
    for (int i = threadIdx.x; i < tile; i += kThreads) s_acc[i] = 0;
    __syncthreads();
    if (active) {
      for (int n = 0; n < nt; ++n) {
        const size_t row = static_cast<size_t>(n0 + n);
        const float gv = g[(row * D + z) * HW + p];
        const double scale = ldexp(1.0, p2i::fixed_shift(rowmax[row], log2_terms));
        u64* t_acc = s_acc + n * lplane;
        unsigned* t_flags = flags + row * plane;
#pragma unroll
        for (int r = 0; r < kMaxK; ++r) {
          if (r < k) {
            p2i::fixed_add_shared(t_acc + loff[r], t_flags + off[r], __fmul_rn(wn[r], gv),
                                  scale);
          }
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tile; i += kThreads) {
      const u64 v = s_acc[i];
      if (v != 0) {
        const int n = i / lplane;
        const int rem = i - n * lplane;
        const int f = rem / pitch;
        const int slot = s_slots[rem - f * pitch];
        atomicAdd(acc + (static_cast<size_t>(n0 + n) * D + f) * G + slot, v);
      }
    }
  }
}

}  // namespace

// scratch: p2i::fixed_scratch_bytes(N * D * G, N) bytes (the caller allocates
// it). tile_bytes: the budget of a block's tile of window totals, of which it
// takes at least one window at the widest tile row (the wrapper checks that
// the block then fits in shared memory). Returns a cudaError_t.
extern "C" int p2i_combine_table_multi_bwd(const float* gd2, const int* gsel,
                                           const float* g, const int* sel,
                                           const float* fd2, void* scratch,
                                           float* out, int N, int D, int G,
                                           int HW, int k, int kf, float rho,
                                           float tau, int rho_is_2, int tile_bytes,
                                           void* stream) {
  if (N < 1 || D < 1 || D > kThreads || G < 1 || HW < 1 || k < 1 || k > kMaxK || kf < 1 ||
      kf * k > p2i::kMaxCand || tile_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long row = static_cast<long long>(D) * widest_pitch(D, G, k);
  long long windows = tile_bytes / (static_cast<long long>(sizeof(u64)) * row);
  windows = windows < 1 ? 1 : (windows > N ? N : windows);
  const long long tile_cap = windows * row;
  const size_t smem = static_cast<size_t>(tile_cap) * sizeof(u64) +
                      (2 * static_cast<size_t>(G) + static_cast<size_t>(D) * kf * (k + 1)) * 4;
  auto kernel = k == 4 && kf == 5 ? combine_table_multi_bwd_kernel<4, 5>
                                  : combine_table_multi_bwd_kernel<0, 0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = static_cast<long long>(D) * G;
  const long long total = N * plane;
  p2i::FixedScratch fs;
  err = p2i::fixed_begin(scratch, total, g, nullptr, 1, N, static_cast<long long>(D) * HW, s, fs);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int log2_terms = p2i::fixed_log2_terms(static_cast<long long>(D) * HW);
  const int bp = block_pixels(D);
  kernel<<<(HW + bp - 1) / bp, kThreads, smem, s>>>(
      gd2, gsel, g, sel, fd2, fs.acc, fs.flags, fs.rowmax, N, D, G, HW, k, kf, rho, tau,
      rho_is_2, static_cast<int>(tile_cap), log2_terms);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(p2i::fixed_end(fs, out, total, plane, log2_terms, s));
}
