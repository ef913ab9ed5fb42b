// Per-pixel k nearest gauge slots of the factored IDW.
//
// Replaces p2igan_tpu/ops/pallas/idw_factored_kernel.py::gauge_topk_pallas
// (_gauge_topk_kernel). For every pixel p: d2[g] = dx*dx + dy*dy + penalty[g]
// to every gauge slot g (padding slots carry a 1e30 penalty), then the result of
// k rounds of first-min extraction: each round writes the minimum and the LOWEST
// slot index attaining it, and sets that slot to 1e30. With fewer than k valid
// slots a later round picks an already-taken slot again (the lowest slot holding
// 1e30): that is the reference rule (p2igan_tpu/ops/idw.py:186-193) and gsel
// keeps it.
//
// One pass instead of k rounds: each distance is computed once, and a thread
// keeps its pixel's k best (distance, slot) sorted in registers while it walks
// the slots in ascending order, entering on a strict < so that among equal
// distances the lower slot stays ahead. That is the first k of the (distance,
// slot) order, which is what the rounds take while valid slots remain. With
// m < k valid slots every slot holds 1e30 after round m (a padding slot's
// d2 + 1e30 rounds to 1e30 exactly, a taken one is set to it), so each later
// round gives 1e30 and the lowest of the taken and padding slots; the list
// holds the m taken slots and the lowest padding slots, so every place at 1e30
// takes the lowest slot of the list (tests/test_torch_gauge_topk_model.py holds
// this rule against the rounds and the JAX package's selection). Distances
// above 1e30 (a penalty above it) are outside this rule; gauge_geometry makes
// none.
//
// Bound on the H100: neither bytes (20 B in, 32 B out per pixel at k=4) nor
// operations (G distances a pixel): the parent's k rounds re-evaluated every
// slot k times with a check against the taken ones, ~14 instructions a slot
// visit. Here a slot costs ~8 a pixel, and its entry runs only when it beats
// the k-th place. One thread a pixel, 128 a block: at the sti shapes (B = 8 or
// 12 masks of 16384 pixels) that is 1024-1536 blocks, and more resident warps
// beat more pixels a thread sharing one slot load (PERF.md, #1's stage table).
// The slots sit in shared memory as 16-byte (x, y, penalty) records, read as
// broadcasts, kU at a time: their distances are computed before any entry's
// branch, so the slot loop is not one dependent chain a slot.
//
// Rounding: d2 is computed with explicit round-to-nearest intrinsics (no FMA
// contraction), in the order ((dx*dx) + (dy*dy)) + penalty of the plain PyTorch
// version, so gd2 is bitwise equal to it and boundary ties resolve identically.
//
// Batch: masks that the samples of a batch do not share (sti) need one
// selection a sample. grid.y walks B masks (gx, gy, pen are (B, G), gd2 and
// gsel (B, k, HW)) in one launch; the pixel coordinates are common. B = 1 is
// the single-mask call, with the same arithmetic.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kThreads = 128;
constexpr int kU = 8;                // slots a step: their distances, then their entries

// ((dx*dx) + (dy*dy)) + penalty, each step rounded to nearest (no contraction)
__device__ __forceinline__ float distance(float px, float py, float4 s) {
  const float dx = __fsub_rn(px, s.x);
  const float dy = __fsub_rn(py, s.y);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), s.z);
}

// Enter (d, g) into the sorted places (bd, bi) if it is below the last one:
// strict <, so that among equal distances the earlier (lower) slot stays ahead.
template <int K>
__device__ __forceinline__ void enter(float d, int g, float (&bd)[K], int (&bi)[K]) {
  if (!(d < bd[K - 1])) return;
  // top down, so that place j reads place j - 1 before it changes
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const bool up = d < bd[j - 1];
    const bool here = !up && d < bd[j];
    bd[j] = up ? bd[j - 1] : (here ? d : bd[j]);
    bi[j] = up ? bi[j - 1] : (here ? g : bi[j]);
  }
  if (d < bd[0]) {
    bd[0] = d;
    bi[0] = g;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
gauge_topk_kernel(const float* __restrict__ qx, const float* __restrict__ qy,
                  const float* __restrict__ gx, const float* __restrict__ gy,
                  const float* __restrict__ pen, float* __restrict__ gd2,
                  int* __restrict__ gsel, int HW, int G) {
  extern __shared__ float4 slots[];  // (x, y, penalty, unused) a slot
  const size_t b = blockIdx.y;
  gx += b * G;
  gy += b * G;
  pen += b * G;
  gd2 += b * K * HW;
  gsel += b * K * HW;
  for (int g = threadIdx.x; g < G; g += kThreads)
    slots[g] = make_float4(gx[g], gy[g], pen[g], 0.f);
  __syncthreads();

  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const float px = qx[p], py = qy[p];
  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = INFINITY;  // every distance is <= 1e30: the first K slots enter
    bi[j] = 0;
  }

  // kU slots a step: their kU distances first (independent work between the
  // entries' branches), then their entries in slot order
  int g = 0;
  for (; g + kU <= G; g += kU) {
    float d[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) d[u] = distance(px, py, slots[g + u]);
#pragma unroll
    for (int u = 0; u < kU; ++u) enter<K>(d[u], g + u, bd, bi);
  }
  for (; g < G; ++g) enter<K>(distance(px, py, slots[g]), g, bd, bi);

  if (bd[K - 1] >= kBig) {  // fewer than K valid slots: the rounds' rule
    int low = bi[0];
#pragma unroll
    for (int j = 1; j < K; ++j) low = min(low, bi[j]);
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (bd[j] >= kBig) bi[j] = low;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    gd2[j * HW + p] = bd[j];
    gsel[j * HW + p] = bi[j];
  }
}

template <int K>
int launch(const float* qx, const float* qy, const float* gx, const float* gy,
           const float* pen, float* gd2, int* gsel, int B, int HW, int G,
           cudaStream_t stream) {
  const size_t smem = sizeof(float4) * static_cast<size_t>(G);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        gauge_topk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 blocks((HW + kThreads - 1) / kThreads, B);
  gauge_topk_kernel<K><<<blocks, kThreads, smem, stream>>>(qx, qy, gx, gy, pen, gd2, gsel,
                                                            HW, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int p2i_gauge_topk(const float* qx, const float* qy, const float* gx,
                              const float* gy, const float* pen, float* gd2,
                              int* gsel, int B, int HW, int G, int k,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(qx, qy, gx, gy, pen, gd2, gsel, B, HW, G, s);
    case 2: return launch<2>(qx, qy, gx, gy, pen, gd2, gsel, B, HW, G, s);
    case 3: return launch<3>(qx, qy, gx, gy, pen, gd2, gsel, B, HW, G, s);
    case 4: return launch<4>(qx, qy, gx, gy, pen, gd2, gsel, B, HW, G, s);
    case 5: return launch<5>(qx, qy, gx, gy, pen, gd2, gsel, B, HW, G, s);
    case 6: return launch<6>(qx, qy, gx, gy, pen, gd2, gsel, B, HW, G, s);
    case 7: return launch<7>(qx, qy, gx, gy, pen, gd2, gsel, B, HW, G, s);
    case 8: return launch<8>(qx, qy, gx, gy, pen, gd2, gsel, B, HW, G, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
