// Multi-receptive-field (MRF) stage of the HiFi-GAN generator, for sm_90a:
// the float32 path (SIMT, strict IEEE f32 FMAs: no TF32, no HMMA) and its C
// entry point.  The bfloat16 path runs on tensor cores in mrf_wg.cu.  Both
// serve the two Python entry points of
// cmtts_tpu_torch/ops/mrf.py:
//   fused_mrf_stage          <- cmtts_tpu/ops/mrf_pallas.py::fused_mrf_stage
//                               (C <= 128, optional fused generator head)
//   fused_mrf_stage_streamed <- cmtts_tpu/ops/mrf_pallas.py::fused_mrf_stage_streamed
//                               (C = 256, weights streamed from HBM)
// In float32 both run mrf_stage_f32 below, whatever the width.
//
// What it computes, per batch row of the (B, C, L) input x:
//   out = mean_j ResBlock_j(x), ResBlock_j = n pairs of
//   y += conv_k(lrelu(conv_{k,d}(lrelu(y))))   (lrelu slope 0.1, SAME convs)
// and with the head wav = tanh(conv_post_7(lrelu_0.01(out))), written as
// (B, L).
//
// What bounds it on an H100: operations on the CUDA cores.  A stage is
// 252 C^2 L B FLOP (18 convs of 2 k C^2 a position, k in {3, 7, 11}) and
// the port computes float32 strictly, so the peak is the SIMT f32 rate,
// 67 TFLOP/s (H100 SXM data sheet): 72.7 ms for the four stages of a
// batch-8, 1024-frame mel, against 0.2 ms of bytes a stage.
//
// Design: each conv is one launch, an implicit GEMM on the CUDA cores
// (M = positions, N = output channels, K = taps x input channels) with its
// epilogue fused; the stage is 18 such launches in one call (plus the head
// kernel), with the running y, the pair's inner h and the ResBlock sum in
// device memory (buffers the wrapper allocates).  Why not one launch a
// stage per length tile: its f32 y and h would take 221-230 KB of shared
// memory (one 8-warp block an SM), every tile would recompute a
// receptive-radius halo (1.46x the work at C = 128), and at C = 256 they
// would not fit at all.  Here:
//  * nothing is recomputed and no halo exists: a conv writes exactly [0, L)
//    and its loads outside [0, L) are zero (SAME padding).  The price is
//    bytes: each conv reads and writes whole (B, C, L) tensors, ~4 ms a
//    stage at B = 8 (C L B is the same at C = 32, 64 and 128), against
//    8-32 ms of operations;
//  * a block computes BM positions x BN output channels of one batch row,
//    256 threads each holding a register tile of kTM = 8 positions x
//    kTN = 8 channels (64 accumulators), so each k-step's 8 activation
//    loads (LDS.32, consecutive lanes on consecutive positions: conflict
//    free for any tap shift) and 2 weight loads (LDS.128, one or two
//    addresses a warp: broadcast) feed 64 FFMAs.  BN is the largest power
//    of two <= kMaxBN dividing C, BM = 8 * 256 / (BN / 8);
//  * K is walked in chunks of kBK input channels, each chunk carrying all
//    k taps: the chunk's activation window [kBK][BM + (k - 1) d] serves
//    every tap at a shift of t d, and its weights [k][kBK][BN] sit beside
//    it.  Chunks pass through a ring of kStages slots in shared memory,
//    filled by cp.async (the window by 4-byte copies with zero fill outside
//    [0, L), the weights by 16-byte .cg copies) while the previous chunk is
//    being consumed, so L2 and HBM latency stay out of the FMA loop;
//  * conv1 reads lrelu(y): each thread applies it in place to the window
//    elements it copied itself, once its copies have landed, before the
//    barrier (once a chunk, not once a use);
//  * the epilogue adds the bias and applies, per conv: h = lrelu(.) for
//    conv1; y = y + . for conv2; and on a ResBlock's last pair the f32 sum
//    over ResBlocks (the first writes it, the last divides by their
//    count), as the plain version orders it;
//  * __launch_bounds__(256, 2): two blocks (16 warps) an SM where shared
//    memory allows (up to 102 KB a block at BN >= 16).
// The head (14 C L B FLOP) is its own small kernel over the ResBlock sum:
// a block stages lrelu_0.01 of 32 channels x (256 + post_k - 1) positions
// in shared memory, then each thread sums its position's taps.

#include "mrf.cuh"

namespace mrf {
namespace {

// the float32 conv's work split (mirrored by ops/mrf.py::F32_*)
constexpr int kTM = 8;       // positions a thread (register tile rows)
constexpr int kTN = 8;       // output channels a thread
constexpr int kBK = 8;       // input channels a K-chunk (all taps)
constexpr int kStages = 2;   // K-chunks in flight in shared memory
constexpr int kMaxBN = 128;  // widest block in output channels
// the head kernel
constexpr int kHeadT = 256;  // positions a block
constexpr int kHeadC = 32;   // channels staged at a time
constexpr int kMaxPostK = 17;

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every group but the newest has landed (for this thread's copies)
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

struct ConvArgs {
  const float* src;   // conv input (B, C, L)
  const float* w;     // this conv's weights [k][C_in][C_out]
  const float* bias;  // [C]
  const float* yin;   // conv2: the residual y (B, C, L)
  float* dst;         // conv1: h; conv2: y, or the ResBlock sum
  int C, L, k, d;
  int wa;             // window row stride, >= BM + (k - 1) d, mult. of 4
  int to_sum, first, last, nblk;  // conv2 on a ResBlock's last pair
};

// Window length (positions) of a chunk's activation rows, padded so that
// the weight slot after the window rows stays 16-byte aligned.
int window_stride(int bm, int k, int d) {
  return (bm + (k - 1) * d + 3) & ~3;
}

// One SAME conv as an implicit GEMM.  MODE 0 (conv1): src = y, read
// through lrelu(0.1); dst = lrelu(conv + bias).  MODE 1 (conv2): src = h;
// y = yin + conv + bias goes to dst, or into the ResBlock sum.
template <int BN, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
mrf_conv_f32_kernel(const ConvArgs a) {
  constexpr int NT = BN / kTN;          // threads along output channels
  constexpr int MT = kThreads / NT;     // threads along positions
  constexpr int BM = MT * kTM;          // positions a block
  extern __shared__ __align__(16) float smem[];
  const int C = a.C, L = a.L, k = a.k, d = a.d, wa = a.wa;
  const int half = (k - 1) / 2;
  const int span = BM + (k - 1) * d;    // window positions actually used
  const int a_slot = kBK * wa;          // floats of one window slot
  const int w_slot = k * kBK * BN;      // floats of one weight slot
  float* As = smem;                     // [kStages][kBK][wa]
  float* Ws = smem + kStages * a_slot;  // [kStages][k][kBK][BN]
  const int tid = threadIdx.x;
  const int tx = tid % MT, ty = tid / MT;
  const int p0 = blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int g_lo = p0 - half * d;       // position of window index 0
  const float* src = a.src + (size_t)b * C * L;

  // cp.async of K-chunk c (input channels c kBK ..) into ring slot s
  auto load = [&](int c, int s) {
    const int ci0 = c * kBK;
    float* A = As + s * a_slot;
#pragma unroll
    for (int r = 0; r < kBK; ++r) {
      const float* row = src + (size_t)(ci0 + r) * L;
      for (int u = tid; u < span; u += kThreads) {
        const int g = g_lo + u;
        const bool ok = g >= 0 && g < L;
        cp_async4(A + r * wa + u, row + (ok ? g : 0), ok);
      }
    }
    float* Wt = Ws + s * w_slot;
    constexpr int V = BN / 4;           // 16-byte vectors a weight row
    for (int i = tid; i < k * kBK * V; i += kThreads) {
      const int row = i / V, v = i - row * V;
      const int t = row / kBK, r = row - t * kBK;
      cp_async16(Wt + row * BN + 4 * v,
                 a.w + ((size_t)t * C + ci0 + r) * C + co0 + 4 * v);
    }
  };
  // conv1: lrelu on the window elements this thread copied (the same
  // loop as load's), once its copies of chunk c have landed
  auto activate = [&](int s) {
    float* A = As + s * a_slot;
#pragma unroll
    for (int r = 0; r < kBK; ++r) {
      for (int u = tid; u < span; u += kThreads) {
        A[r * wa + u] = lrelu(A[r * wa + u], kSlope);
      }
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int j = 0; j < kTM; ++j)
#pragma unroll
    for (int i = 0; i < kTN; ++i) acc[j][i] = 0.f;

  const int nchunks = C / kBK;
  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % kStages;
    if (c + 1 < nchunks) load(c + 1, (c + 1) % kStages);
    cp_async_commit();                  // empty on the last chunk
    cp_async_wait_all_but_newest();     // chunk c has landed
    if (MODE == 0) activate(s);
    __syncthreads();
    const float* A = As + s * a_slot + tx;
    const float* Wt = Ws + s * w_slot + ty * kTN;
    for (int t = 0; t < k; ++t) {
#pragma unroll
      for (int r = 0; r < kBK; ++r) {
        const float* ap = A + r * wa + t * d;
        float av[kTM];
#pragma unroll
        for (int j = 0; j < kTM; ++j) av[j] = ap[j * MT];
        const float4* wp =
            reinterpret_cast<const float4*>(Wt + (t * kBK + r) * BN);
        const float4 w0 = wp[0], w1 = wp[1];
        const float wv[kTN] = {w0.x, w0.y, w0.z, w0.w,
                               w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int j = 0; j < kTM; ++j)
#pragma unroll
          for (int i = 0; i < kTN; ++i)
            acc[j][i] = fmaf(av[j], wv[i], acc[j][i]);
      }
    }
    __syncthreads();                    // slot s is free for chunk c + 2
  }

  // epilogue: positions p0 + tx + MT j, channels co0 + ty kTN + i
  float bias[kTN];
#pragma unroll
  for (int i = 0; i < kTN; ++i) bias[i] = a.bias[co0 + ty * kTN + i];
#pragma unroll
  for (int j = 0; j < kTM; ++j) {
    const int p = p0 + tx + MT * j;
    if (p >= L) continue;
#pragma unroll
    for (int i = 0; i < kTN; ++i) {
      const size_t idx = ((size_t)b * C + co0 + ty * kTN + i) * L + p;
      const float v = acc[j][i] + bias[i];
      if (MODE == 0) {
        a.dst[idx] = lrelu(v, kSlope);
      } else {
        const float y = a.yin[idx] + v;
        if (!a.to_sum) {
          a.dst[idx] = y;
        } else {
          const float sum = a.first ? y : a.dst[idx] + y;
          a.dst[idx] = a.last ? sum / a.nblk : sum;
        }
      }
    }
  }
}

// wav[b, p] = tanh(b_post + sum_{t, c} w_post[t][c] lrelu_0.01(s[b, c, p +
// t - half])), zero outside [0, L) as the SAME conv pads.
__global__ void __launch_bounds__(kHeadT)
mrf_head_f32_kernel(const float* s, const float* w_post, const float* b_post,
                    float* wav, int C, int L, int post_k) {
  __shared__ float hs[kHeadC][kHeadT + kMaxPostK - 1];
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kHeadT;
  const int p = p0 + threadIdx.x;
  const int half = (post_k - 1) / 2;
  const int span = kHeadT + post_k - 1;
  const float* sb = s + (size_t)b * C * L;
  float acc = 0.f;
  for (int c0 = 0; c0 < C; c0 += kHeadC) {
    const int nc = min(kHeadC, C - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < nc * span; i += kHeadT) {
      const int r = i / span, u = i - r * span;
      const int g = p0 - half + u;
      hs[r][u] = g >= 0 && g < L
                     ? lrelu(sb[(size_t)(c0 + r) * L + g], kPostSlope)
                     : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < post_k; ++t) {
      for (int r = 0; r < nc; ++r) {
        acc = fmaf(w_post[t * C + c0 + r], hs[r][threadIdx.x + t], acc);
      }
    }
  }
  if (p < L) wav[(size_t)b * L + p] = tanhf(acc + b_post[0]);
}

int conv_bn(int C) {
  int bn = kMaxBN;
  while (C % bn != 0) bn /= 2;
  return bn;
}

template <int BN, int MODE>
int launch_conv(const ConvArgs& a0, int B, cudaStream_t stream) {
  constexpr int BM = kThreads / (BN / kTN) * kTM;
  ConvArgs a = a0;
  a.wa = window_stride(BM, a.k, a.d);
  const int smem =
      (int)(sizeof(float) * kStages * (kBK * a.wa + a.k * kBK * BN));
  cudaError_t e = cudaFuncSetAttribute(
      mrf_conv_f32_kernel<BN, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.L + BM - 1) / BM, a.C / BN, B);
  mrf_conv_f32_kernel<BN, MODE><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_conv_bn(const ConvArgs& a, int B, cudaStream_t stream) {
  switch (conv_bn(a.C)) {
    case 128: return launch_conv<128, MODE>(a, B, stream);
    case 64: return launch_conv<64, MODE>(a, B, stream);
    case 32: return launch_conv<32, MODE>(a, B, stream);
    case 16: return launch_conv<16, MODE>(a, B, stream);
    case 8: return launch_conv<8, MODE>(a, B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mrf

// The float32 stage: 2 nblk npair conv launches, then the head when
// w_post is not null.  out is (B, C, L), or (B, L) with the head; h is a
// (B, C, L) buffer, y one too when npair > 1, and s one with the head (the
// ResBlock sum the head reads).  Returns a cudaError_t; 0 means launched.
extern "C" int mrf_stage_f32(const float* x, float* out, const float* w,
                             const float* bias, const float* w_post,
                             const float* b_post, float* y, float* h,
                             float* s, int B, int C, int L, int nblk,
                             int npair, const int* ks, const int* ds,
                             int post_k, void* stream) {
  using namespace mrf;
  const bool head = w_post != nullptr;
  if (C % kTN != 0 || C % kBK != 0 || nblk < 1 || npair < 1 ||
      (npair > 1 && y == nullptr) || (head && (s == nullptr ||
      post_k < 1 || post_k > kMaxPostK))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* sum = head ? s : out;
  size_t woff = 0;
  const float* bp = bias;
  for (int j = 0; j < nblk; ++j) {
    const int k = ks[j];
    const size_t kcc = (size_t)k * C * C;
    for (int p = 0; p < npair; ++p) {
      ConvArgs a = {};
      a.C = C; a.L = L; a.k = k; a.nblk = nblk;
      a.src = p == 0 ? x : y;
      a.w = w + woff; a.bias = bp; a.dst = h; a.d = ds[p];
      int err = launch_conv_bn<0>(a, B, st);
      if (err != 0) return err;
      const bool last_pair = p == npair - 1;
      a.src = h; a.yin = p == 0 ? x : y;
      a.w = w + woff + kcc; a.bias = bp + C; a.d = 1;
      a.dst = last_pair ? sum : y;
      a.to_sum = last_pair; a.first = j == 0; a.last = j == nblk - 1;
      err = launch_conv_bn<1>(a, B, st);
      if (err != 0) return err;
      woff += 2 * kcc;
      bp += 2 * C;
    }
  }
  if (!head) return 0;
  const dim3 grid((L + kHeadT - 1) / kHeadT, B);
  mrf_head_f32_kernel<<<grid, kHeadT, 0, st>>>(s, w_post, b_post, out, C, L,
                                               post_k);
  return (int)cudaGetLastError();
}
