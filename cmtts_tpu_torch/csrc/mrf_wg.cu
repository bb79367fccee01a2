// The bfloat16 route of the fused MRF stage, for sm_90a: each of a
// stage's 18 SAME convs is one launch of a warpgroup implicit GEMM on
// Hopper's tensor cores (wgmma, bf16 operands, f32 accumulation), its
// weight tiles brought into a shared-memory ring by bulk async copies
// under mbarriers.  It replaces, for compute_dtype = bfloat16, both Pallas
// kernels:
//   cmtts_tpu/ops/mrf_pallas.py::fused_mrf_stage           (C <= 128, head)
//   cmtts_tpu/ops/mrf_pallas.py::fused_mrf_stage_streamed  (C = 256)
// and computes what ops/mrf.py::mrf_stage_plain computes in bfloat16, with
// its roundings (see the epilogue).
//
// What bounds it on an H100: with x read once and the output written
// once, operations at every width (252 C^2 L B FLOP a stage at 989
// TFLOP/s: 1.1 / 2.2 / 1.1 / 0.55 ms at B = 8, mel 1024, C = 256 / 128 /
// 64 / 32).  The layout below adds bytes: about 45 passes over a stage's
// bf16 tensor (134 MB at C <= 128, ~1.8 ms at 3.35 TB/s), more than the
// MMAs take at C <= 64.
//
// Design:
//  * layout: between convs the activations live in device memory,
//    position-major bf16 [B][L][Cp] (the JAX generator's channels-last
//    order), Cp = C rounded up to 16 with zero channels (HiFi-GAN V2's last
//    stage has C = 8).  mrf_to_rows_kernel casts and transposes x (B, C, L)
//    f32 into y0 once a stage; every ResBlock starts from it.  y, h and the
//    f32 ResBlock sum are buffers the wrapper allocates.  A conv writes
//    exactly [0, L) and reads zeros outside it (SAME padding): no halo, no
//    recomputation;
//  * one launch a conv, an implicit GEMM: M = positions of one batch row,
//    N = output channels, K = taps x input channels,
//      out[p, co] = sum_t sum_ci in[p + (t - half) d, ci] w[t][ci][co];
//    a position tile is BM = 128 MT positions x BN output channels,
//    computed by two consumer warpgroups (64 MT rows each: MT m64 tiles)
//    fed by one producer warp.  K is walked in k16 steps ordered
//    (input-channel chunk of cw = min(64, Cp) channels, tap, 16 channels),
//    so that the first chunk's MMAs start while the later chunks of the
//    window still load;
//  * the activation window [BM + (k - 1) d][Cp + 8] of a tile's rows is
//    loaded by the consumers with cp.async (16 bytes a copy, zero fill
//    outside [0, L)), one commit group an input-channel chunk, and serves
//    every tap at a row offset of t d.  The 8-element pad makes the row
//    stride an odd multiple of 16 bytes, so ldmatrix is conflict-free.
//    Where two window slots fit in shared memory (every conv at C <= 128;
//    at C = 256 the 6 conv1 with (k - 1) d <= 18 of the 9), a block is
//    persistent: it walks position tiles blockIdx.y, + gridDim.y, ... (as
//    many blocks as the SMs hold) and loads the next tile's window into
//    the other slot during this tile's MMAs.  conv2's residual rows come
//    into shared memory with the last chunk of the window;
//  * wgmma.m64nBNk16 takes A from registers and B from shared memory.  A
//    warp's 16 rows of A are the m16n8k16 A fragment, loaded by one
//    ldmatrix.x4 at the tap's row offset; conv1 applies lrelu(0.1) to them
//    in registers, in f32 and rounded to bf16, as the plain version does.
//    A is not read by descriptor because a tap shift of t d rows breaks the
//    8-row core-matrix and swizzle-atom alignment that a descriptor needs.
//    A warpgroup loads a weight tile's 4 steps of A into registers, then
//    issues their MMAs as one commit group and waits for it (ptxas
//    serialises wgmma if registers feeding one are written while another
//    is in flight); the two consumer warpgroups overlap each other's loads
//    and MMAs.  The steps' (chunk, tap, channels) advance by counters: a
//    division a step cost more than the step's MMAs;
//  * B: the host packer (ops/mrf.py::pack_wg_tiles) cuts each conv's
//    weights into tiles of 4 k16 steps (64 K values) x BN output channels,
//    stored in wgmma's K-major canonical layout with the 128-byte swizzle
//    (atoms of 8 channels x 128 bytes, the 16-byte chunks XORed with the
//    row), each tile contiguous in its final order.  So one 1-D bulk copy
//    (cp.async.bulk ... mbarrier::complete_tx::bytes, no tensor map) fetches
//    it into a ring of kStages slots: the producer warp waits on a slot's
//    empty barrier, arms its full barrier with the tile's bytes and issues
//    the copy; the consumers wait on the full barrier, and each consumer
//    warp arrives on the empty barrier once wgmma.wait_group has shown that
//    the MMAs reading the slot are done.  A step's B descriptor is the
//    slot's address + 32 bytes a step within the tile, SBO 1024 bytes;
//  * sizes: an m64 x BN tile costs BN / 2 f32 accumulator registers a
//    thread.  ptxas held these 288-thread kernels to 168 registers, and
//    at BN = 128 only MT = 1 left it the registers to keep a tile's MMAs
//    in flight (with MT = 2 it serialised them): BM = 128 at C >= 128 (two
//    blocks a position tile at C = 256), BM = 256 below.  A block does
//    2 BM BN K FLOP for 2 K BN bytes of weights from L2.  At C = 256,
//    k = 11, d = 5: a 93,984-byte window + 4 x 16,384-byte slots + 1,024
//    bytes of alignment + 64 of barriers = 160,608 of the 232,448 bytes a
//    block may use;
//  * the epilogue keeps the plain version's roundings: bias, then bf16;
//    conv1: h = bf16(lrelu(.)); conv2: y = bf16(y + bf16(.)), and on a
//    ResBlock's last pair the f32 sum over ResBlocks, (B, C, L): the first
//    ResBlock writes it, the last divides by their count.  Without the
//    head the sum is the output.  The values go through shared memory
//    over the window, so that h and y leave in 16-byte chunks of whole
//    rows and the sum along positions, both coalesced;
//  * the head (14 C L B FLOP) is a SIMT kernel over the f32 sum, with
//    bf16(lrelu_0.01(bf16(sum))) staged in shared memory as in mrf.cu.

#include <algorithm>

#include "mrf.cuh"

namespace mrf {
namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

// the bf16 conv's work split (mirrored by ops/mrf.py::WG_*)
constexpr int kConsumerWGs = 2;   // consumer warpgroups a block
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kWgThreads = kConsumers + 32;  // + the producer warp
constexpr int kTileK = 64;        // K values a weight tile (a swizzle row)
constexpr int kStages = 4;        // weight tiles in the ring
constexpr int kMaxBN = 128;       // widest block in output channels
constexpr int kRowPad = 8;        // bf16 pad of a window row
constexpr int kAlign = 1024;      // a swizzle atom's alignment
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use
// the head kernel
constexpr int kHeadT = 256;       // positions a block
constexpr int kHeadC = 32;        // channels staged at a time
constexpr int kMaxPostK = 17;

__host__ __device__ constexpr int tile_bytes(int bn) {
  return bn * kTileK * 2;
}

// m64 tiles a consumer warpgroup for a block of bn output channels
__host__ __device__ constexpr int wg_mt(int bn) {
  return bn == kMaxBN ? 1 : 2;
}

// Bytes of one window slot: the window [BM + (k - 1) d][cp + 8] and, for
// conv2, the residual rows [BM][bn + 8] beside it.
__host__ __device__ constexpr int slot_bytes(int bn, int cp, int k, int d,
                                             bool conv1) {
  return (64 * wg_mt(bn) * kConsumerWGs + (k - 1) * d) * (cp + kRowPad) * 2 +
         (conv1 ? 0 : 64 * wg_mt(bn) * kConsumerWGs * (bn + 8) * 2);
}

// Dynamic shared memory of one conv block: alignment slack, the ring,
// one window slot (two when persistent), the full and empty barriers
// (with one slot: ops/mrf.py::wg_smem_bytes).
int wg_smem_bytes(int bn, int cp, int k, int d, bool conv1, int persist) {
  return kAlign + kStages * tile_bytes(bn) +
         (persist ? 2 : 1) * slot_bytes(bn, cp, k, d, conv1) +
         2 * kStages * 8;
}

// round to bf16 and back
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// bf16(lrelu(v)) of the two bf16 values in v, computed in f32
__device__ __forceinline__ uint32_t lrelu2(uint32_t v) {
  const float lo = __uint_as_float(v << 16);
  const float hi = __uint_as_float(v & 0xffff0000u);
  const bf162 r = __floats2bfloat162_rn(lrelu(lo, kSlope), lrelu(hi, kSlope));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// at most n of this thread's newest commit groups still in flight: up to
// 2 nchunk - 1 = 7 at C = 256 with two window slots (a larger n waits for
// 7, more than it must)
template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: cp_async_wait_n<0>(); break;
    case 1: cp_async_wait_n<1>(); break;
    case 2: cp_async_wait_n<2>(); break;
    case 3: cp_async_wait_n<3>(); break;
    case 4: cp_async_wait_n<4>(); break;
    case 5: cp_async_wait_n<5>(); break;
    case 6: cp_async_wait_n<6>(); break;
    default: cp_async_wait_n<7>(); break;
  }
}

// the consumer warpgroups only (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the completion of the barrier's phase of the given parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// bytes from global memory into shared memory, completing on bar
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across the wgmma
// fence, commit and wait instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major B operand with the 128-byte swizzle: start
// address >> 4 (bits 0-13), LBO (unused by this layout: 1, bits 16-29),
// SBO = 1024 bytes between 8-row atoms (>> 4, bits 32-45), base offset 0
// (the atoms are 1024-byte aligned), swizzle mode 1 = 128 B (bits 62-63).
// ops/mrf.py::wg_desc mirrors it.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B K-major by descriptor.
// d[4 i + 2 r + e] is row 16 warp + lane / 4 + 8 r, column 8 i + 2 (lane %
// 4) + e of the m64 x N tile.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(1));
  }
};

struct WgConv {
  const bf16* src;    // conv input [B][L][Cp]
  const void* w;      // this conv's weight tiles [Cp / BN][tiles][BN * 64]
  const float* bias;  // [Cp], zero past C
  const bf16* yin;    // conv2: the residual y [B][L][Cp]
  bf16* dst;          // conv1: h; conv2: y, or null (not written)
  float* sum;         // conv2 on a ResBlock's last pair: the f32 ResBlock
                      // sum (B, C, L); else null
  int C, Cp, L, k, d;
  int cw;             // input channels a window chunk (a multiple of 16)
  int first, last, nblk;
  int n_m;            // position tiles a batch row
  int total;          // position tiles in all: n_m B
  int persist;        // 1: two window slots, the next tile's loading
                      // during this one's MMAs; 0: one slot
};

// The epilogue of one position tile, through shared memory over its
// window: the BM x BN values (conv1: h = bf16(lrelu(bf16(acc + bias)));
// conv2: bf16(acc + bias)) as bf16 rows of BN + 8 (an odd multiple of 16
// bytes: the accumulator layout's stores are conflict-free), then 16-byte
// chunks of rows, coalesced: conv1 stores h; conv2 takes its thread's
// residual chunks first (the rows that came with the window: y may be its
// own destination), then stores y = bf16(y + .) and keeps it in the
// tile for the ResBlock sum, (B, C, L) f32, written coalesced along
// positions: the first ResBlock writes it, the last divides by their
// count.
template <int BN, int MT, bool CONV1>
__device__ __forceinline__ void epilogue(const WgConv& a,
                                         const float (&acc)[MT][BN / 2],
                                         unsigned char* tile_mem,
                                         const unsigned char* y_mem, int b,
                                         int p0, int nb) {
  constexpr int BM = 64 * MT * kConsumerWGs;
  constexpr int TS = BN + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, g = lane >> 2, q = lane & 3;
  const int L = a.L, Cp = a.Cp;
  bf16* tile_s = reinterpret_cast<bf16*>(tile_mem);
  consumer_sync();                 // every warp is done with the window
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wg * 64 * MT + m * 64 + (warp & 3) * 16 + g + 8 * r;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = 8 * i + 2 * q;
        const float2 bv =
            *reinterpret_cast<const float2*>(a.bias + nb * BN + col);
        const float v0 = rnd(acc[m][4 * i + 2 * r] + bv.x);
        const float v1 = rnd(acc[m][4 * i + 2 * r + 1] + bv.y);
        *reinterpret_cast<bf162*>(tile_s + row * TS + col) =
            CONV1 ? __floats2bfloat162_rn(lrelu(v0, kSlope), lrelu(v1, kSlope))
                  : __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  consumer_sync();
  constexpr int CPR = BN / 8;                  // chunks a row
  constexpr int NCH = BM * CPR / kConsumers;   // chunks a thread (<= 16)
  uint4 yv[NCH];
  if (!CONV1) {
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      const int idx = threadIdx.x + u * kConsumers;
      const int row = idx / CPR, ch = idx - row * CPR;
      yv[u] = *reinterpret_cast<const uint4*>(y_mem + (row * TS + 8 * ch) * 2);
    }
  }
#pragma unroll
  for (int u = 0; u < NCH; ++u) {
    const int idx = threadIdx.x + u * kConsumers;
    const int row = idx / CPR, ch = idx - row * CPR;
    if (p0 + row >= L) continue;
    uint4* ts = reinterpret_cast<uint4*>(tile_s + row * TS + 8 * ch);
    uint4 v = *ts;
    if (!CONV1) {
      uint32_t* vw = reinterpret_cast<uint32_t*>(&v);
      const uint32_t* yw = reinterpret_cast<const uint32_t*>(&yv[u]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 y =
            __bfloat1622float2(*reinterpret_cast<const bf162*>(&yw[e]));
        const float2 h =
            __bfloat1622float2(*reinterpret_cast<const bf162*>(&vw[e]));
        const bf162 yn = __floats2bfloat162_rn(y.x + h.x, y.y + h.y);
        vw[e] = *reinterpret_cast<const uint32_t*>(&yn);
      }
      if (a.sum != nullptr) *ts = v;
    }
    if (a.dst != nullptr) {
      *reinterpret_cast<uint4*>(
          a.dst + ((size_t)b * L + p0 + row) * Cp + nb * BN + 8 * ch) = v;
    }
  }
  if (CONV1 || a.sum == nullptr) return;
  consumer_sync();
  // (channel, row) pairs idx = thread + kConsumers u, in batches of 8 a
  // thread: loads first, then the stores
  constexpr int NS = BM * BN / kConsumers;     // values a thread
  constexpr int SB = NS < 8 ? NS : 8;
#pragma unroll 1
  for (int u0 = 0; u0 < NS; u0 += SB) {
    float sv[SB];
    if (!a.first) {
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const int idx = threadIdx.x + (u0 + u) * kConsumers;
        const int col = idx / BM, row = idx - col * BM;
        const int co = nb * BN + col;
        if (p0 + row < L && co < a.C) {
          sv[u] = a.sum[((size_t)b * a.C + co) * L + p0 + row];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const int idx = threadIdx.x + (u0 + u) * kConsumers;
      const int col = idx / BM, row = idx - col * BM;
      const int co = nb * BN + col;
      if (p0 + row >= L || co >= a.C) continue;
      const float y = __bfloat162float(tile_s[row * TS + col]);
      const float s = a.first ? y : sv[u] + y;
      a.sum[((size_t)b * a.C + co) * L + p0 + row] = a.last ? s / a.nblk : s;
    }
  }
}

// One SAME conv as an implicit GEMM on the tensor cores.  CONV1: src = y,
// read through lrelu(0.1); dst = bf16(lrelu(bf16(conv + bias))).  Else:
// src = h; y = bf16(yin + bf16(conv + bias)) goes to dst and, when sum is
// set, into the ResBlock sum.  Grid: (Cp / BN, blocks, 1); block y takes
// position tiles y, y + gridDim.y, ... of the B n_m.
template <int BN, bool CONV1>
__global__ void __launch_bounds__(kWgThreads, 1)
mrf_conv_wg_kernel(const WgConv a) {
  constexpr int MT = wg_mt(BN);               // m64 tiles a warpgroup
  constexpr int BM = 64 * MT * kConsumerWGs;  // positions a tile
  constexpr int kTile = tile_bytes(BN);
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t ring = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const int Cp = a.Cp, L = a.L, k = a.k, d = a.d;
  const int rowb = (Cp + kRowPad) * 2;        // bytes a window row
  const int rows = BM + (k - 1) * d;
  const uint32_t win0 = ring + kStages * kTile;
  const int slot_b = slot_bytes(BN, Cp, k, d, CONV1);
  const uint32_t full = win0 + (a.persist ? 2 : 1) * slot_b;
  const uint32_t empty = full + 8 * kStages;  // kStages barriers each
  const int nb = blockIdx.x;
  const int spt = a.cw / 16;                  // k-steps a tap of a chunk
  const int spc = k * spt;                    // k-steps a chunk
  const int nchunk = Cp / a.cw;
  const int steps = nchunk * spc;
  const int tiles = (steps + 3) / 4;          // weight tiles a position tile
  const int iters = (a.total - blockIdx.y + gridDim.y - 1) / gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumerWGs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumerWGs) {
    // the producer: weight tile n = it tiles + i of this block's output
    // channels into slot n % kStages, once the consumers have released the
    // slot's last use
    if (lane == 0) {
      const unsigned char* w = static_cast<const unsigned char*>(a.w) +
                               (size_t)nb * tiles * kTile;
      for (int n = 0; n < iters * tiles; ++n) {
        const int s = n % kStages, i = n % tiles;
        mbar_wait(empty + 8 * s, ((n / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, kTile);
        bulk_g2s(ring + s * kTile, w + (size_t)i * kTile, kTile, full + 8 * s);
      }
    }
    return;
  }

  // the window slot of position tile t at wa: window row r is position
  // p0 - half d + r of its batch row, zero outside [0, L); one commit group
  // an input-channel chunk; for conv2, the residual rows [p0, p0 + BM) of
  // the block's channels ride in the last chunk's group
  const int vsh = a.cw == 64 ? 3 : a.cw == 32 ? 2 : 1;  // log2 copies a row
  auto load_window = [&](int t, uint32_t wa) {
    const int b = t / a.n_m;
    const int p0 = (t - b * a.n_m) * BM;
    const bf16* src = a.src + (size_t)b * L * Cp;
    const int g_lo = p0 - (k - 1) / 2 * d;
    for (int c = 0; c < nchunk; ++c) {
      for (int i = threadIdx.x; i < rows << vsh; i += kConsumers) {
        const int r = i >> vsh;
        const int ch = c * a.cw + 8 * (i - (r << vsh));
        const int g = g_lo + r;
        const bool ok = g >= 0 && g < L;
        cp_async16(wa + r * rowb + 2 * ch, src + (size_t)(ok ? g : 0) * Cp + ch,
                   ok);
      }
      if (!CONV1 && c == nchunk - 1) {
        const bf16* yin = a.yin + (size_t)b * L * Cp + nb * BN;
        const uint32_t ya = wa + rows * rowb;
        for (int i = threadIdx.x; i < BM * (BN / 8); i += kConsumers) {
          const int r = i / (BN / 8), v = i - r * (BN / 8);
          const bool ok = p0 + r < L;
          cp_async16(ya + r * (BN + 8) * 2 + 16 * v,
                     yin + (size_t)(ok ? p0 + r : 0) * Cp + 8 * v, ok);
        }
      }
      cp_async_commit();
    }
  };

  const int wg = warp >> 2;
  // this lane's ldmatrix.x4 row: lanes 0-15 rows 0-15 of the warp's m16
  // slice at channels +0, lanes 16-31 the same rows at +8
  const uint32_t a_row = (wg * 64 * MT + (warp & 3) * 16 + (lane & 15)) *
                         rowb + (lane >> 4) * 16;
  load_window(blockIdx.y, win0);
  for (int it = 0; it < iters; ++it) {
    const int t = blockIdx.y + it * gridDim.y;
    const int b = t / a.n_m;
    const int p0 = (t - b * a.n_m) * BM;
    const uint32_t win = win0 + (a.persist ? (it & 1) * slot_b : 0);
    if (a.persist) {              // the next tile's window: nchunk groups
      if (it + 1 < iters) {
        load_window(t + gridDim.y, win0 + ((it + 1) & 1) * slot_b);
      } else {
        for (int c = 0; c < nchunk; ++c) cp_async_commit();
      }
    } else if (it > 0) {
      load_window(t, win0);
    }
    float acc[MT][BN / 2];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.f;
      fence_regs(acc[m]);
    }
    // a weight tile at a time: its 4 steps' A fragments into registers (a
    // padding step past the last one re-reads that step's rows: its
    // weights are zero), then its 4 MT MMAs in one commit group.  ptxas
    // serialises wgmma when registers feeding one are written while an
    // earlier one is in flight, so a warpgroup waits for its group before
    // loading the next tile's A; the other consumer warpgroup's MMAs fill
    // the tensor cores meanwhile.
    // k-step s = 4 tile + jj walks chunk c, tap, 16 channels j in order,
    // by counters (a division a step would cost more than its MMAs)
    int c = 0, tap = 0, j = 0;
    for (int tile = 0; tile < tiles; ++tile) {
      const int n = it * tiles + tile, slot = n % kStages;
      uint32_t af[4][MT][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int s = 4 * tile + jj;
        if (s < steps && tap == 0 && j == 0) {  // chunk c has landed
          cp_async_wait(nchunk - 1 - c + (a.persist ? nchunk : 0));
          consumer_sync();
        }
        const uint32_t addr =
            win + a_row + tap * d * rowb + 2 * (c * a.cw + 16 * j);
        if (s + 1 < steps && ++j == spt) {  // else: padding steps re-read
          j = 0;
          if (++tap == k) {
            tap = 0;
            ++c;
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          ldmatrix_x4(af[jj][m], addr + m * 64 * rowb);
          if (CONV1) {
#pragma unroll
            for (int e = 0; e < 4; ++e) af[jj][m][e] = lrelu2(af[jj][m][e]);
          }
        }
      }
      mbar_wait(full + 8 * slot, (n / kStages) & 1);
      wg_fence();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const uint64_t desc = b_desc(ring + slot * kTile + 32 * jj);
#pragma unroll
        for (int m = 0; m < MT; ++m) Wgmma<BN>::mma(acc[m], af[jj][m], desc);
      }
      wg_commit();
      wg_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * slot);   // the slot is free
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
    epilogue<BN, MT, CONV1>(a, acc, smem + (win - raw),
                            smem + (win - raw) + rows * rowb, b, p0, nb);
    consumer_sync();              // the window is free for the next load
  }
}

// y0[b][p][c] = bf16(x[b][c][p]) for c < C, 0 for C <= c < Cp: 32 x 32
// tiles through shared memory, coalesced on both sides.
__global__ void __launch_bounds__(256)
mrf_to_rows_kernel(const float* x, bf16* y, int C, int Cp, int L) {
  __shared__ float t[32][33];
  const int b = blockIdx.z, c0 = blockIdx.y * 32, p0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8) {
    const int c = c0 + r, p = p0 + tx;
    t[r][tx] = c < C && p < L ? x[((size_t)b * C + c) * L + p] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int p = p0 + r, c = c0 + tx;
    if (p < L && c < Cp) {
      y[((size_t)b * L + p) * Cp + c] = __float2bfloat16(t[tx][r]);
    }
  }
}

// wav[b, p] = tanh(bf16(b_post + sum_{t, c} w_post[t][c] h[c, p + t -
// half])), h = bf16(lrelu_0.01(bf16(s))), zero outside [0, L) as the SAME
// conv pads: mrf.cu's head with the bf16 route's roundings.
__global__ void __launch_bounds__(kHeadT)
mrf_head_wg_kernel(const float* s, const bf16* w_post, const float* b_post,
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
                     ? rnd(lrelu(rnd(sb[(size_t)(c0 + r) * L + g]), kPostSlope))
                     : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < post_k; ++t) {
      for (int r = 0; r < nc; ++r) {
        acc = fmaf(__bfloat162float(w_post[t * C + c0 + r]),
                   hs[r][threadIdx.x + t], acc);
      }
    }
  }
  if (p < L) wav[(size_t)b * L + p] = tanhf(rnd(acc + b_post[0]));
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <int BN, bool CONV1>
int launch_wg(const WgConv& a0, int B, int sms, cudaStream_t stream) {
  constexpr int BM = 64 * wg_mt(BN) * kConsumerWGs;
  WgConv a = a0;
  a.n_m = (a.L + BM - 1) / BM;
  a.total = a.n_m * B;
  // two window slots where they fit, else one (ops/mrf.py::kernel_takes
  // refuses a stage where one does not, as cudaFuncSetAttribute would)
  a.persist = wg_smem_bytes(BN, a.Cp, a.k, a.d, CONV1, 1) <= kMaxSmem;
  const int smem = wg_smem_bytes(BN, a.Cp, a.k, a.d, CONV1, a.persist);
  cudaError_t e = cudaFuncSetAttribute(
      mrf_conv_wg_kernel<BN, CONV1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = std::min(a.total, 65535);
  if (a.persist) {                // as many blocks as the SMs hold at once
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mrf_conv_wg_kernel<BN, CONV1>, kWgThreads, smem);
    if (e != cudaSuccess) return (int)e;
    blocks = std::min(blocks, std::max(per_sm, 1) * sms);
  }
  const dim3 grid(a.Cp / BN, blocks, 1);
  mrf_conv_wg_kernel<BN, CONV1><<<grid, kWgThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The block for Cp channels: BN the widest of 128, 64, 32, 16 dividing Cp
// (ops/mrf.py::wg_tiling).
template <bool CONV1>
int launch_conv(const WgConv& a, int B, int sms, cudaStream_t stream) {
  if (a.Cp % kMaxBN == 0) return launch_wg<kMaxBN, CONV1>(a, B, sms, stream);
  if (a.Cp % 64 == 0) return launch_wg<64, CONV1>(a, B, sms, stream);
  if (a.Cp % 32 == 0) return launch_wg<32, CONV1>(a, B, sms, stream);
  return launch_wg<16, CONV1>(a, B, sms, stream);
}

}  // namespace
}  // namespace mrf

// The bfloat16 stage: the cast of x into y0, 2 nblk npair conv launches,
// then the head when w_post is not null.  x is (B, C, L) f32; out is (B, C,
// L), or (B, L) with the head; w is pack_wg_tiles' bf16 tiles; bias is
// [nblk][npair][2][Cp] f32 (zero past C); y0, h and (when npair > 1) y are
// [B][L][Cp] bf16 buffers, s a (B, C, L) f32 one with the head (the
// ResBlock sum it reads).  Returns a cudaError_t; 0 means launched.
extern "C" int mrf_stage_bf16(const float* x, float* out, const void* w,
                              const float* bias, const void* w_post,
                              const float* b_post, void* y0, void* y, void* h,
                              float* s, int B, int C, int L, int nblk,
                              int npair, const int* ks, const int* ds,
                              int post_k, void* stream) {
  using namespace mrf;
  const bool head = w_post != nullptr;
  const int Cp = (C + 15) / 16 * 16;
  if (C < 1 || C % 8 != 0 || nblk < 1 || npair < 1 || y0 == nullptr ||
      h == nullptr || (npair > 1 && y == nullptr) ||
      (head && (s == nullptr || post_k < 1 || post_k > kMaxPostK))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int sms = sm_count();
  bf16* rows0 = static_cast<bf16*>(y0);
  bf16* ry = static_cast<bf16*>(y);
  bf16* rh = static_cast<bf16*>(h);
  mrf_to_rows_kernel<<<dim3((L + 31) / 32, (Cp + 31) / 32, B), 256, 0, st>>>(
      x, rows0, C, Cp, L);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  float* sum = head ? s : out;
  const int cw = Cp % 64 == 0 ? 64 : Cp % 32 == 0 ? 32 : 16;
  const bf16* wp = static_cast<const bf16*>(w);
  const float* bp = bias;
  for (int j = 0; j < nblk; ++j) {
    const int k = ks[j];
    // bf16 elements of one conv's tiles: ceil(k Cp / 64) tiles x Cp x 64
    const size_t conv_elems = (size_t)((k * Cp / 16 + 3) / 4) * Cp * kTileK;
    for (int p = 0; p < npair; ++p) {
      const bool last_pair = p == npair - 1;
      WgConv a = {};
      a.C = C; a.Cp = Cp; a.L = L; a.k = k; a.cw = cw; a.nblk = nblk;
      a.src = p == 0 ? rows0 : ry;
      a.w = wp; a.bias = bp; a.dst = rh; a.d = ds[p];
      err = launch_conv<true>(a, B, sms, st);
      if (err != 0) return err;
      a.src = rh; a.yin = p == 0 ? rows0 : ry;
      a.w = wp + conv_elems; a.bias = bp + Cp; a.d = 1;
      a.dst = last_pair ? nullptr : ry;
      a.sum = last_pair ? sum : nullptr;
      a.first = j == 0; a.last = j == nblk - 1;
      err = launch_conv<false>(a, B, sms, st);
      if (err != 0) return err;
      wp += 2 * conv_elems;
      bp += 2 * Cp;
    }
  }
  if (!head) return 0;
  const dim3 grid((L + kHeadT - 1) / kHeadT, B);
  mrf_head_wg_kernel<<<grid, kHeadT, 0, st>>>(
      s, static_cast<const bf16*>(w_post), b_post, out, C, L, post_k);
  return (int)cudaGetLastError();
}
