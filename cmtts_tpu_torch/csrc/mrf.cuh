// Shared by the two MRF routes: mrf.cu (SIMT, the float32 path) and
// mrf_wg.cu (tensor cores, the bfloat16 path): the constants and the
// activation that both must apply identically.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mrf {

constexpr int kThreads = 256;
constexpr float kSlope = 0.1f;
constexpr float kPostSlope = 0.01f;

__device__ __forceinline__ float lrelu(float v, float s) {
  return fmaxf(v, v * s);
}

}  // namespace mrf
