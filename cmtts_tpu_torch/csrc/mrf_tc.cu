// The bfloat16 path of the fused MRF stage, on Hopper's tensor cores
// (warp-level mma.sync.m16n8k16, bf16 operands, f32 accumulation), for
// sm_90a.  It replaces, for compute_dtype = bfloat16, both Pallas kernels:
//   cmtts_tpu/ops/mrf_pallas.py::fused_mrf_stage           (C <= 128, head)
//   cmtts_tpu/ops/mrf_pallas.py::fused_mrf_stage_streamed  (C = 256)
// and computes exactly what mrf.cu's kernel computes (see its header): the
// same tiles, halo, shrinking conv regions, masks and roundings.  Only the
// conv loop and the activation layout differ.
//
// What bounds it on an H100: operations (252 C^2 L B FLOP per stage,
// ~60 C FLOP per byte of activations).  The TPU kernel does each conv as a
// matrix product on the MXU; here each conv is a matrix product on the
// tensor cores:
//  * an implicit GEMM per conv with positions as M, output channels as N,
//    input channels as K, summed over the k taps:
//      out[p, co] += sum_ci in[p + (t - half) d, ci] w[t][ci][co];
//  * activations live position-major in shared memory, y[W][C+8] and
//    h[W][C+8] in bf16.  A tap shift moves whole rows, so every ldmatrix row
//    address stays 16-byte aligned; the 8-element pad makes the row stride
//    an odd multiple of 16 bytes (80, 144, 272, 528 B at C = 32..256), so
//    the 8 rows of one ldmatrix phase fall in 8 different bank groups;
//  * A (activations) through ldmatrix.x4: each lane gives one row address,
//    its position clamped to the conv's region [lo, hi) so that the padding
//    rows of a warp pass read inside the buffer (their results are never
//    stored).  conv1 applies lrelu(0.1) to the A fragments in registers, in
//    f32 and rounded to bf16 as the plain version does;
//  * B (weights) straight from global memory, which L2 holds (126 C^2 bf16
//    per stage, 16.5 MB at C = 256): there is no room for them in shared
//    memory beside y and h.  The host packer
//    (ops/mrf.py::pack_mrf_fragments) puts them in B-fragment order, per
//    (conv, tap, 16-wide c_in step, pair of n8 tiles) 32 lanes x 8 bf16, so
//    a lane reads its fragments of two n8 tiles with one 16-byte ld.global.nc;
//    the next k-step's fragments are loaded before the current step's MMAs;
//  * a warp pass is up to 128 positions (8 m16 tiles) x 32 output channels
//    (4 n8 tiles; 16 at C = 16): 32 MMAs per k-step and 128 f32
//    accumulators per lane, so that each 16-byte weight load feeds 16 MMAs.
//    The weights' L2 traffic is what holds the kernel back, so a wider pass
//    (more MMAs per weight load) is faster: passes of 128 positions beat
//    passes of 64 on the card (PERF.md).  A conv's region, rounded up to 16
//    positions, is cut into (c_out group, m16 tile) units; each warp takes
//    an equal contiguous share of them, in passes of at most 8 tiles of
//    one c_out group.  A pass always runs all 8 tiles (a branch per tile
//    costs more than the few idle MMAs) and stores only those it owns;
//  * the accumulator's c0, c1 are two adjacent output channels of one
//    position, so the epilogue (bias, zero outside [0, L), round; then
//    lrelu -> h or y += .) stores one bf16x2 per pair;
//  * loading x ([C][L] f32) and writing the stage output are transposes
//    through shared memory, once per ResBlock; the ResBlock sum is f32; the
//    head (14 C L B FLOP, ~0.05% of the stage) stays SIMT.

#include "mrf.cuh"

namespace mrf {
namespace {

typedef __nv_bfloat16 bf16;

constexpr int kPadC = 8;  // bf16 pad of an activation row
constexpr int kMT = 8;    // m16 tiles per warp pass (ops/mrf.py::PASS_TILES)

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
// round to bf16 and back
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a * b for one m16n8k16 tile (row-major A, column-major B)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16(lrelu(v)) of the two bf16 values in v, computed in f32
__device__ __forceinline__ uint32_t lrelu2(uint32_t v) {
  const float lo = __uint_as_float(v << 16);
  const float hi = __uint_as_float(v & 0xffff0000u);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(lrelu(lo, kSlope), lrelu(hi, kSlope));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// One SAME conv over window positions [lo, hi) of the [W][C+8] buffers.
// NP: pairs of n8 tiles per warp pass (2: 32 output channels; 1: 16).
// ACT_IN: lrelu(0.1) on the A fragments (conv1 reads y).
// MODE 0 (conv1): dst = bf16(lrelu(bf16(mask(acc + bias))))  -- h
// MODE 1 (conv2): dst = bf16(dst + bf16(mask(acc + bias)))   -- y += conv2
template <int NP, bool ACT_IN, int MODE>
__device__ void conv_pass_tc(const bf16* src, bf16* dst,
                             const bf16* __restrict__ wf,
                             const float* __restrict__ bias, int C, int k,
                             int d, int lo, int hi, int g0, int L) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = (C + kPadC) * 2;   // bytes per position
  const int ksteps = C / 16;         // k-steps per tap
  const int steps = k * ksteps;
  const int half = (k - 1) / 2;
  const int n_cog = C / (16 * NP);
  const int tiles_m = (hi - lo + 15) >> 4;  // m16 tiles of the region
  const int src_s = (int)__cvta_generic_to_shared(src);
  // ldmatrix.x4: lanes 8m..8m+7 give the rows of matrix m = a-register m,
  // i.e. positions lane % 16 of the m16 tile, c_in half lane / 16
  const int lrow = lane & 15, lcol = (lane >> 4) * 16;
  const int gq = lane >> 2, tq = lane & 3;  // accumulator row / column pair
  // this warp's share of the (c_out group, m16 tile) units, taken in passes
  // of at most kMT tiles of one c_out group
  const int units = n_cog * tiles_m;
  const int u_end = (warp + 1) * units / kWarps;
  for (int u = warp * units / kWarps; u < u_end;) {
    const int cog = u / tiles_m;
    const int m0 = u - cog * tiles_m;
    const int mt = min(kMT, min(tiles_m - m0, u_end - u));  // tiles owned
    const int pos0 = lo + 16 * m0;
    u += mt;
    int abase[kMT];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int p = min(pos0 + 16 * i + lrow, hi - 1) - half * d;
      abase[i] = src_s + p * row + lcol;
    }
    // this lane's B fragments: one uint4 per (k-step, pair), a k-step of
    // all C / 16 pairs being 2 C uint4 long
    const uint4* wb =
        reinterpret_cast<const uint4*>(wf) + (size_t)cog * NP * 32 + lane;
    float acc[kMT][2 * NP][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    uint4 bcur[NP], bnxt[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) bnxt[j] = bcur[j] = __ldg(wb + j * 32);
    int aoff = 0, ks = 0;
    for (int s = 0; s < steps; ++s) {
      if (s + 1 < steps) {
#pragma unroll
        for (int j = 0; j < NP; ++j)
          bnxt[j] = __ldg(wb + (size_t)(s + 1) * 2 * C + j * 32);
      }
      uint32_t a[kMT][4];  // all kMT tiles, owned or not
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        ldmatrix_x4(a[i], (uint32_t)(abase[i] + aoff));
        if (ACT_IN) {
#pragma unroll
          for (int r = 0; r < 4; ++r) a[i][r] = lrelu2(a[i][r]);
        }
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          mma_bf16(acc[i][2 * j], a[i], bcur[j].x, bcur[j].y);
          mma_bf16(acc[i][2 * j + 1], a[i], bcur[j].z, bcur[j].w);
        }
      }
#pragma unroll
      for (int j = 0; j < NP; ++j) bcur[j] = bnxt[j];
      aoff += 32;  // next 16 input channels
      if (++ks == ksteps) {  // next tap: d positions on
        ks = 0;
        aoff += d * row - ksteps * 32;
      }
    }
    // epilogue: c0, c1 at (row gq, channels 2 tq, 2 tq + 1), c2, c3 at row
    // gq + 8 of each m16 x n8 tile
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) {
      const int co = (cog * 2 * NP + j) * 8 + 2 * tq;
      const float2 bv = *reinterpret_cast<const float2*>(bias + co);
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = pos0 + 16 * i + gq + 8 * r;
          if (i >= mt || p >= hi) continue;
          const int g = g0 + p;
          const bool valid = g >= 0 && g < L;
          const float v0 = valid ? rnd(acc[i][j][2 * r] + bv.x) : 0.f;
          const float v1 = valid ? rnd(acc[i][j][2 * r + 1] + bv.y) : 0.f;
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
              dst + (size_t)p * (C + kPadC) + co);
          if (MODE == 0) {
            *o = __floats2bfloat162_rn(lrelu(v0, kSlope), lrelu(v1, kSlope));
          } else {
            const float2 y = __bfloat1622float2(*o);
            *o = __floats2bfloat162_rn(y.x + v0, y.y + v1);
          }
        }
      }
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
mrf_stage_tc_kernel(const MrfArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, CP = C + kPadC, L = a.L, W = a.W, H = a.halo;
  const int P = a.pad, tile = a.tile;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;  // global position of the tile
  const int g0 = t0 - H;             // global position of window row 0
  const bool head = a.w_post != nullptr;
  const int acc_w = tile + 2 * P;

  bf16* ybuf = reinterpret_cast<bf16*>(smem);
  bf16* hbuf = ybuf + (size_t)W * CP;
  float* acc_s = reinterpret_cast<float*>(hbuf + (size_t)W * CP);  // C x acc_w
  const float* xb = a.x + (size_t)b * C * L;
  float* ob = a.out + (size_t)b * C * L;

  const bf16* wconv = reinterpret_cast<const bf16*>(a.w);
  size_t woff = 0;
  for (int j = 0; j < a.nblk; ++j) {
    const int k = a.ks[j];
    const int half = (k - 1) / 2;
    // y = x over the whole window, zero outside [0, L): a transpose,
    // coalesced along positions in global memory
    for (int idx = threadIdx.x; idx < C * W; idx += kThreads) {
      const int c = idx / W, p = idx - c * W;
      const int g = g0 + p;
      ybuf[(size_t)p * CP + c] =
          __float2bfloat16(g >= 0 && g < L ? xb[(size_t)c * L + g] : 0.f);
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
      conv_pass_tc<NP, true, 0>(ybuf, hbuf, wconv + woff, b1, C, k, d,
                                H - rem, H + tile + rem, g0, L);
      __syncthreads();
      rem -= half;
      conv_pass_tc<NP, false, 1>(hbuf, ybuf, wconv + woff + kcc, b2, C, k, 1,
                                 H - rem, H + tile + rem, g0, L);
      __syncthreads();
      woff += 2 * kcc;
    }
    // sum over ResBlocks, f32
    const bool first = j == 0, last = j == a.nblk - 1;
    if (head) {
      for (int idx = threadIdx.x; idx < C * acc_w; idx += kThreads) {
        const int c = idx / acc_w, u = idx - c * acc_w;
        const float v = to_f(ybuf[(size_t)(H - P + u) * CP + c]);
        const float s = first ? v : acc_s[idx] + v;
        acc_s[idx] = last ? s / a.nblk : s;
      }
    } else {
      for (int idx = threadIdx.x; idx < C * tile; idx += kThreads) {
        const int c = idx / tile, u = idx - c * tile;
        const int g = t0 + u;
        if (g >= L) continue;
        const float v = to_f(ybuf[(size_t)(H + u) * CP + c]);
        float* o = ob + (size_t)c * L + g;
        const float s = first ? v : *o + v;
        *o = last ? s / a.nblk : s;
      }
    }
    __syncthreads();
  }
  if (!head) return;
  // generator head: lrelu(0.01) -> conv_post (k = post_k, C -> 1) -> tanh
  const bf16* wp = reinterpret_cast<const bf16*>(a.w_post);
  for (int u = threadIdx.x; u < tile; u += kThreads) {
    const int g = t0 + u;
    if (g >= L) continue;
    float s = 0.f;
    for (int tap = 0; tap < a.post_k; ++tap) {
      const float* col = acc_s + u + tap;  // window position H + u + tap - P
      for (int ci = 0; ci < C; ++ci) {
        const float h =
            rnd(lrelu(rnd(col[(size_t)ci * acc_w]), kPostSlope));
        s = fmaf(to_f(wp[tap * C + ci]), h, s);
      }
    }
    a.out[(size_t)b * L + g] = tanhf(rnd(s + a.b_post[0]));
  }
}

template <int NP>
int launch_np(const MrfArgs& a, int smem_bytes, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      mrf_stage_tc_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.L + a.tile - 1) / a.tile, a.B);
  mrf_stage_tc_kernel<NP><<<grid, kThreads, smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

int launch_tc(const MrfArgs& a, int smem_bytes, cudaStream_t stream) {
  // activations in shared memory only; C a multiple of one k-step
  if (a.C % 16 != 0 || a.scratch != nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.C % 32 == 0) return launch_np<2>(a, smem_bytes, stream);
  return launch_np<1>(a, smem_bytes, stream);
}

}  // namespace mrf
