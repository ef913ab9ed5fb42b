// Second pass of the two combine backwards (combine_table_multi_bwd.cu,
// combine_table_bwd.cu): every pixel block wrote one partial of the whole
// gradient; this sums them in block order, so the pass itself is repeatable.

#pragma once

#include <cuda_runtime.h>

namespace p2i {

// out[i] = sum over pixel blocks b, in order, of parts[b][i].
static __global__ void sum_partials_kernel(const float* __restrict__ parts,
                                           float* __restrict__ out, int nblk,
                                           int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = 0.0f;
  for (int b = 0; b < nblk; ++b) {
    acc = __fadd_rn(acc, parts[static_cast<size_t>(b) * total + i]);
  }
  out[i] = acc;
}

}  // namespace p2i
