// Shared by the two MRF stage kernels: mrf.cu (SIMT, the float32 path) and
// mrf_tc.cu (tensor cores, the bfloat16 path): the launch arguments and
// the constants and activation that both kernels must apply identically.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mrf {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 4;
constexpr int kMaxPairs = 4;
constexpr float kSlope = 0.1f;
constexpr float kPostSlope = 0.01f;

struct MrfArgs {
  const float* x;        // (B, C, L)
  float* out;            // (B, C, L), or (B, L) with the head
  const void* w;         // conv weights, per conv: float32 [k][C_in][C_out];
                         // bfloat16 in mma.sync B-fragment order
  const float* bias;     // [nblk][npair][2][C]
  const void* w_post;    // head weights, compute type, [post_k][C];
                         // null: no head
  const float* b_post;   // [1]
  void* scratch;         // per-block y/h buffers; null: shared memory
  int B, C, L;
  int tile, halo, W, pad;  // W = tile + 2 halo; pad = head radius
  int nblk, npair, post_k;
  int ks[kMaxBlocks];
  int ds[kMaxPairs];
};

// The bfloat16 stage on tensor cores (mrf_tc.cu).  Returns a cudaError_t.
int launch_tc(const MrfArgs& a, int smem_bytes, cudaStream_t stream);

__device__ __forceinline__ float lrelu(float v, float s) {
  return fmaxf(v, v * s);
}

}  // namespace mrf
