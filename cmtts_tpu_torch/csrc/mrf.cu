// Fused multi-receptive-field (MRF) stage of the HiFi-GAN generator, for
// sm_90a: the float32 path (SIMT) and the C entry point of both dtypes.
// The bfloat16 path runs on tensor cores in mrf_tc.cu.  Both serve the two
// Python entry points of cmtts_tpu_torch/ops/mrf.py:
//   fused_mrf_stage          <- cmtts_tpu/ops/mrf_pallas.py::fused_mrf_stage
//                               (C <= 128, optional fused generator head)
//   fused_mrf_stage_streamed <- cmtts_tpu/ops/mrf_pallas.py::fused_mrf_stage_streamed
//                               (C = 256, weights streamed from L2)
//
// What it computes, per batch row and per length tile of the (B, C, L)
// input x:  out = mean_j ResBlock_j(x), ResBlock_j = 3 pairs of
//   y += conv_k(lrelu(conv_{k,d}(lrelu(y))))   (lrelu slope 0.1, SAME convs)
// with every conv output zeroed outside [0, L), so that conv(0) = bias never
// leaks into the sequence through the next conv's taps.  With the head:
//   wav = tanh(conv_post_7(lrelu_0.01(out)))   written as (B, L).
//
// What bounds it on an H100: operations.  A stage is 252 C^2 L B FLOP
// (18 convs, 2 k C^2 each, k in {3, 7, 11}) over 2 C L B activations read
// and written, i.e. ~60 C FLOP per byte in f32: far above the ~20 FLOP/B
// at which the card's SIMT f32 rate meets its memory rate.
//
// Design of the float32 kernel (kept simple: it serves the tight float32
// check against the plain version, not the main path):
//  * one block per (length tile, batch row); the tile's window carries a
//    halo of H = receptive radius (+3 with the head) on each side, which is
//    recomputed rather than exchanged between blocks;
//  * two C x W activation buffers in shared memory: y (the running
//    residual) and h (the pair's inner activation, stored already passed
//    through lrelu).  Where 2 C W sizeof(float) does not fit in the 227 KB
//    a block may use (C = 256), the wrapper hands the kernel a per-block
//    scratch in global memory instead, which L2 holds; the code is the same
//    through generic pointers;
//  * each conv computes only the region later convs still need (the halo
//    shrinks by the conv's radius), which cuts the halo's overhead;
//  * weights are read from global memory (L2-resident), in a
//    [tap][c_in][c_out] layout so that a warp reads one broadcast 16-byte
//    vector per (tap, c_in);
//  * SIMT FMAs: a warp owns 8 output channels x 128 positions (4 per lane,
//    strided by 32 so that shared-memory reads are conflict-free);
//  * the sum over ResBlocks is kept in f32: in the output tensor itself
//    (each block owns its output tile) or, with the head, in shared memory.
//
// Numerics: float32 throughout, as the JAX kernel with a float32 compute
// type; the bfloat16 roundings are mrf_tc.cu's.

#include "mrf.cuh"

namespace mrf {
namespace {

constexpr int kCoT = 8;  // output channels per warp item
constexpr int kPT = 4;   // positions per lane per warp item

// Eight consecutive weights, one broadcast load per warp.
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// One SAME conv over window positions [lo, hi) of the C x W buffers.
// ACT_IN: apply lrelu(0.1) to the input on load (conv1 reads y).
// MODE 0 (conv1): dst = lrelu(mask(acc + bias))  -- h, pre-activated
// MODE 1 (conv2): dst = dst + mask(acc + bias)   -- y += conv2
template <bool ACT_IN, int MODE>
__device__ void conv_pass(const float* src, float* dst,
                          const float* __restrict__ w,
                          const float* __restrict__ bias, int C, int W, int k,
                          int d, int lo, int hi, int g0, int L) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = (k - 1) / 2;
  const int n_cog = C / kCoT;
  constexpr int chunk = 32 * kPT;
  const int n_items = n_cog * ((hi - lo + chunk - 1) / chunk);
  for (int item = warp; item < n_items; item += kWarps) {
    const int co0 = (item % n_cog) * kCoT;
    const int pbase = lo + (item / n_cog) * chunk + lane;
    int pidx[kPT];
#pragma unroll
    for (int j = 0; j < kPT; ++j) pidx[j] = min(pbase + 32 * j, hi - 1);
    float acc[kCoT][kPT];
#pragma unroll
    for (int i = 0; i < kCoT; ++i)
#pragma unroll
      for (int j = 0; j < kPT; ++j) acc[i][j] = 0.f;
    for (int t = 0; t < k; ++t) {
      const float* s = src + (t - half) * d;
      const float* wt = w + (size_t)t * C * C + co0;
#pragma unroll 4
      for (int ci = 0; ci < C; ++ci) {
        float xv[kPT];
#pragma unroll
        for (int j = 0; j < kPT; ++j) {
          const float v = s[(size_t)ci * W + pidx[j]];
          xv[j] = ACT_IN ? lrelu(v, kSlope) : v;
        }
        float wv[kCoT];
        load8(wt + (size_t)ci * C, wv);
#pragma unroll
        for (int i = 0; i < kCoT; ++i)
#pragma unroll
          for (int j = 0; j < kPT; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPT; ++j) {
      const int p = pbase + 32 * j;
      if (p >= hi) continue;
      const int g = g0 + p;
      const bool valid = g >= 0 && g < L;
#pragma unroll
      for (int i = 0; i < kCoT; ++i) {
        const int co = co0 + i;
        const float v = valid ? acc[i][j] + bias[co] : 0.f;
        float* o = dst + (size_t)co * W + p;
        *o = MODE == 0 ? lrelu(v, kSlope) : *o + v;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mrf_stage_kernel(const MrfArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, L = a.L, W = a.W, H = a.halo, P = a.pad;
  const int tile = a.tile;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;  // global position of the tile
  const int g0 = t0 - H;             // global position of window index 0
  const bool head = a.w_post != nullptr;
  const int acc_w = tile + 2 * P;

  float* ybuf;
  float* acc_s;  // head only: sum over ResBlocks, C x acc_w
  if (a.scratch != nullptr) {
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    ybuf = reinterpret_cast<float*>(a.scratch) + blk * 2 * (size_t)C * W;
    acc_s = reinterpret_cast<float*>(smem);
  } else {
    ybuf = reinterpret_cast<float*>(smem);
    acc_s = ybuf + 2 * (size_t)C * W;
  }
  float* hbuf = ybuf + (size_t)C * W;
  const float* xb = a.x + (size_t)b * C * L;
  float* ob = a.out + (size_t)b * C * L;

  const float* wconv = reinterpret_cast<const float*>(a.w);
  size_t woff = 0;
  for (int j = 0; j < a.nblk; ++j) {
    const int k = a.ks[j];
    const int half = (k - 1) / 2;
    // y = x over the whole window, zero outside [0, L)
    for (int idx = threadIdx.x; idx < C * W; idx += kThreads) {
      const int c = idx / W, p = idx - c * W;
      const int g = g0 + p;
      ybuf[idx] = g >= 0 && g < L ? xb[(size_t)c * L + g] : 0.f;
    }
    __syncthreads();
    // radius the later convs of this ResBlock still need
    int rem = P;
    for (int p = 0; p < a.npair; ++p) rem += half * a.ds[p] + half;
    for (int p = 0; p < a.npair; ++p) {
      const int d = a.ds[p];
      const size_t kcc = (size_t)k * C * C;
      const float* b1 = a.bias + ((size_t)(j * a.npair + p) * 2 + 0) * C;
      const float* b2 = b1 + C;
      rem -= half * d;
      conv_pass<true, 0>(ybuf, hbuf, wconv + woff, b1, C, W, k, d,
                         H - rem, H + tile + rem, g0, L);
      __syncthreads();
      rem -= half;
      conv_pass<false, 1>(hbuf, ybuf, wconv + woff + kcc, b2, C, W, k, 1,
                          H - rem, H + tile + rem, g0, L);
      __syncthreads();
      woff += 2 * kcc;
    }
    // sum over ResBlocks
    const bool first = j == 0, last = j == a.nblk - 1;
    if (head) {
      for (int idx = threadIdx.x; idx < C * acc_w; idx += kThreads) {
        const int c = idx / acc_w, u = idx - c * acc_w;
        const float v = ybuf[(size_t)c * W + H - P + u];
        const float s = first ? v : acc_s[idx] + v;
        acc_s[idx] = last ? s / a.nblk : s;
      }
    } else {
      for (int idx = threadIdx.x; idx < C * tile; idx += kThreads) {
        const int c = idx / tile, u = idx - c * tile;
        const int g = t0 + u;
        if (g >= L) continue;
        const float v = ybuf[(size_t)c * W + H + u];
        float* o = ob + (size_t)c * L + g;
        const float s = first ? v : *o + v;
        *o = last ? s / a.nblk : s;
      }
    }
    __syncthreads();
  }
  if (!head) return;
  // generator head: lrelu(0.01) -> conv_post (k = post_k, C -> 1) -> tanh
  const float* wp = reinterpret_cast<const float*>(a.w_post);
  for (int u = threadIdx.x; u < tile; u += kThreads) {
    const int g = t0 + u;
    if (g >= L) continue;
    float s = 0.f;
    for (int tap = 0; tap < a.post_k; ++tap) {
      const float* col = acc_s + u + tap;  // window position H + u + tap - P
      for (int ci = 0; ci < C; ++ci) {
        s = fmaf(wp[tap * C + ci], lrelu(col[(size_t)ci * acc_w], kPostSlope),
                 s);
      }
    }
    a.out[(size_t)b * L + g] = tanhf(s + a.b_post[0]);
  }
}

int launch(const MrfArgs& a, int smem_bytes, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      mrf_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.L + a.tile - 1) / a.tile, a.B);
  mrf_stage_kernel<<<grid, kThreads, smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mrf

// dtype: 0 = float32 (SIMT kernel above), 1 = bfloat16 (tensor-core kernel
// of mrf_tc.cu, w in B-fragment order).  Returns a cudaError_t; 0 means
// launched.
extern "C" int mrf_stage(int dtype, const float* x, float* out, const void* w,
                         const float* bias, const void* w_post,
                         const float* b_post, void* scratch, int B, int C,
                         int L, int tile, int halo, int pad, int nblk,
                         int npair, const int* ks, const int* ds, int post_k,
                         int smem_bytes, void* stream) {
  using namespace mrf;
  if (nblk > kMaxBlocks || npair > kMaxPairs || C % kCoT != 0) {
    return (int)cudaErrorInvalidValue;
  }
  MrfArgs a;
  a.x = x; a.out = out; a.w = w; a.bias = bias;
  a.w_post = w_post; a.b_post = b_post; a.scratch = scratch;
  a.B = B; a.C = C; a.L = L;
  a.tile = tile; a.halo = halo; a.W = tile + 2 * halo; a.pad = pad;
  a.nblk = nblk; a.npair = npair; a.post_k = post_k;
  for (int i = 0; i < kMaxBlocks; ++i) a.ks[i] = i < nblk ? ks[i] : 1;
  for (int i = 0; i < kMaxPairs; ++i) a.ds[i] = i < npair ? ds[i] : 1;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch(a, smem_bytes, s);
  if (dtype == 1) return launch_tc(a, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
