// Per-pixel k nearest gauge slots of the factored IDW.
//
// Replaces p2igan_tpu/ops/pallas/idw_factored_kernel.py::gauge_topk_pallas
// (_gauge_topk_kernel). For every pixel p: d2[g] = dx*dx + dy*dy + penalty[g]
// to every gauge slot g (padding slots carry a 1e30 penalty), then k rounds of
// first-min extraction; each round writes the minimum and the LOWEST slot index
// attaining it, and sets that slot to 1e30. With fewer than k valid slots a later
// round may pick an already-taken slot again (the lowest slot holding 1e30):
// that is the reference rule (p2igan_tpu/ops/idw.py:186-193) and gsel keeps it.
//
// Bound on the H100: neither bytes (20 B in, 32 B out per pixel at k=4) nor
// FLOPs (k*G distance evaluations per pixel, ~8.4 M at 128x128 and G=128);
// the kernel runs once per event mask (stis) or once per window batch and
// train step for all its masks (sti), so launch latency dominates. One thread
// per pixel with the G gauge coordinates in shared memory keeps it to one pass
// over global memory. The taken slots live in registers (k <= kMaxK) and a taken
// slot is re-evaluated as 1e30, which is the literal replacement rule without an
// (HW, G) working array.
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

namespace {

constexpr int kMaxK = 8;
constexpr float kBig = 1e30f;

__global__ void gauge_topk_kernel(const float* __restrict__ qx,
                                  const float* __restrict__ qy,
                                  const float* __restrict__ gx,
                                  const float* __restrict__ gy,
                                  const float* __restrict__ pen,
                                  float* __restrict__ gd2,
                                  int* __restrict__ gsel,
                                  int HW, int G, int k) {
  extern __shared__ float smem[];
  const size_t b = blockIdx.y;
  gx += b * G;
  gy += b * G;
  pen += b * G;
  gd2 += b * k * HW;
  gsel += b * k * HW;
  float* sx = smem;
  float* sy = smem + G;
  float* sp = smem + 2 * G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    sx[g] = gx[g];
    sy[g] = gy[g];
    sp[g] = pen[g];
  }
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const float px = qx[p];
  const float py = qy[p];

  int taken[kMaxK];
#pragma unroll
  for (int a = 0; a < kMaxK; ++a) {
    if (a >= k) break;
    float best = 0.0f;
    int bi = -1;
    for (int g = 0; g < G; ++g) {
      bool was_taken = false;
#pragma unroll
      for (int b = 0; b < a; ++b) was_taken |= (taken[b] == g);
      float d = kBig;
      if (!was_taken) {
        const float dx = __fsub_rn(px, sx[g]);
        const float dy = __fsub_rn(py, sy[g]);
        d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), sp[g]);
      }
      if (bi < 0 || d < best) {  // strict <: the lowest index wins a tie
        best = d;
        bi = g;
      }
    }
    taken[a] = bi;
    gd2[a * HW + p] = best;
    gsel[a * HW + p] = bi;
  }
}

}  // namespace

extern "C" int p2i_gauge_topk(const float* qx, const float* qy, const float* gx,
                              const float* gy, const float* pen, float* gd2,
                              int* gsel, int B, int HW, int G, int k,
                              void* stream) {
  const int threads = 128;
  const dim3 blocks((HW + threads - 1) / threads, B);
  const size_t smem = 3 * static_cast<size_t>(G) * sizeof(float);
  gauge_topk_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      qx, qy, gx, gy, pen, gd2, gsel, HW, G, k);
  return static_cast<int>(cudaGetLastError());
}
