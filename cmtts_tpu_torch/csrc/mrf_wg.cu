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
//  * the activation window of a tile's BM + (k - 1) d rows serves every
//    tap.  It is stored as planes of 8 channels, [Cp / 8][rows][8] bf16: a
//    plane holds 16 bytes a position, so the 8 x 8 core matrix of
//    positions p..p + 7 is 128 contiguous bytes at any p, and wgmma reads A
//    by a descriptor without swizzle (SBO 128 bytes between 8-position
//    groups, LBO the plane stride between a k16 step's two 8-channel
//    halves).  A tap's shift of t d rows is 16 t d bytes on the
//    descriptor's start: no copy a tap.  A plane is what a tensor copy
//    (TMA) of a box of 8 channels x rows positions writes, so a second
//    lane of the producer warp brings the window in, Cp / 8 planes of one
//    or two copies each, through a tensor map of the conv's input [B][L]
//    [Cp] that fills zeros outside [0, L) (SAME padding); each
//    input-channel chunk completes on a barrier of its own, and the
//    consumers issue no copies.  conv1's lrelu(0.1) is applied in place
//    once per element, in f32 and rounded to bf16 as the plain version
//    does, when its chunk has landed; then a proxy fence and a barrier
//    hand the chunk to the MMAs.  Where two window slots fit in shared
//    memory (every conv at C <= 128; at C = 256 the 8 conv1 with (k - 1) d
//    <= 30 of the 9), a block is persistent: it walks position tiles
//    blockIdx.y, + gridDim.y, ... (as many blocks as the SMs hold) and the
//    next tile's window loads into the other slot during this tile's MMAs.
//    conv2's residual rows come into shared memory beside the window, by
//    the consumers' cp.async, a tile ahead where the block is persistent;
//  * wgmma.m64nBNk16 takes both operands from shared memory, so no
//    register feeds an MMA but the accumulators: a warpgroup issues a
//    weight tile's 4 MT MMAs as one commit group and keeps kMmaGroups
//    groups in flight while it waits for the next tile and issues it,
//    releasing a ring slot once the group that read it has completed.  It
//    lets its MMAs finish only before a tile that reaches a chunk not yet
//    handed over (nchunk times a position tile), since ptxas serialises
//    wgmma across the divergent lrelu loop of that hand-over.  The steps'
//    (chunk, tap, channels) advance by counters: a division a step would
//    cost as much as the step's MMAs;
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
//    thread: BM = 128 at C >= 64 (MT = 1; two blocks a position tile at
//    C = 256), BM = 256 below.  A block does 2 BM BN K FLOP for 2 K BN
//    bytes of weights from L2.  At BN <= 64 an SM holds two blocks (every
//    conv at C <= 64 fits twice with two window slots): the registers that
//    A no longer takes leave a thread enough of the 112 that two blocks
//    allow, and one block's epilogue and window loads then overlap the
//    other's MMAs.  At C = 256, k = 11, d = 5: a 94,208-byte window (184
//    rows) + 4 x 16,384-byte slots + 1,024 bytes of alignment + 208 of
//    barriers = 160,976 of the 232,448 bytes a block may use.  The window
//    area is at least the epilogue's tile, which it holds later;
//  * the epilogue keeps the plain version's roundings: bias, then bf16;
//    conv1: h = bf16(lrelu(.)); conv2: y = bf16(y + bf16(.)), and on a
//    ResBlock's last pair the f32 sum over ResBlocks, (B, C, L): the first
//    ResBlock writes it, the last divides by their count.  Without the
//    head the sum is the output.  The values go through shared memory
//    over the window, so that h and y leave in 16-byte chunks of whole
//    rows and the sum along positions, both coalesced;
//  * the head (14 C L B FLOP) is a SIMT kernel over the f32 sum, with
//    bf16(lrelu_0.01(bf16(sum))) staged in shared memory as in mrf.cu.

#include <cuda.h>
#include <cudaTypedefs.h>

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
constexpr int kMmaGroups = 1;     // MMA commit groups kept in flight
constexpr int kMaxBN = 128;       // widest block in output channels
constexpr int kRowPad = 8;        // bf16 pad of an epilogue tile's row
constexpr int kMaxBox = 256;      // rows a tensor copy (TMA box) may have
constexpr int kMaxChunks = 8;     // window chunks a slot has barriers for
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
  return bn >= 64 ? 1 : 2;
}

// blocks an SM holds at once (the conv kernel's launch bound): two at bn <=
// 64, where ptxas fits a thread in the 112 registers that leave and the
// shared memory fits twice, so that one block's epilogue and window loads
// overlap the other's MMAs
__host__ __device__ constexpr int wg_min_blocks(int bn) {
  return bn <= 64 ? 2 : 1;
}

// positions a tile
__host__ __device__ constexpr int wg_bm(int bn) {
  return 64 * wg_mt(bn) * kConsumerWGs;
}

// input channels a window chunk (a commit group): the widest of 64, 32, 16
// dividing cp (ops/mrf.py::wg_chunk)
__host__ __device__ constexpr int wg_cw(int cp) {
  return cp % 64 == 0 ? 64 : cp % 32 == 0 ? 32 : 16;
}

// Rows of one tensor copy of a window plane: the BM + (k - 1) d positions
// in as few copies of at most kMaxBox rows as hold them, rounded up to 8
// rows so that every copy's shared address is 128-byte aligned.
__host__ __device__ constexpr int win_boxes(int bn, int k, int d) {
  return (wg_bm(bn) + (k - 1) * d + kMaxBox - 1) / kMaxBox;
}
__host__ __device__ constexpr int box_rows(int bn, int k, int d) {
  return ((wg_bm(bn) + (k - 1) * d + win_boxes(bn, k, d) - 1) /
              win_boxes(bn, k, d) +
          7) / 8 * 8;
}

// rows of a window plane: its copies'
__host__ __device__ constexpr int win_rows(int bn, int k, int d) {
  return win_boxes(bn, k, d) * box_rows(bn, k, d);
}

// bytes of the epilogue's tile [BM][BN + kRowPad] bf16, and of conv2's
// residual rows in the same layout
__host__ __device__ constexpr int tile_rows_bytes(int bn) {
  return wg_bm(bn) * (bn + kRowPad) * 2;
}

// Bytes of one window slot: the window [cp / 8][win_rows][8] (or the
// epilogue's tile, where that is larger) and, for conv2, the residual rows
// beside it.
__host__ __device__ constexpr int slot_bytes(int bn, int cp, int k, int d,
                                             bool conv1) {
  return (cp * win_rows(bn, k, d) * 2 > tile_rows_bytes(bn)
              ? cp * win_rows(bn, k, d) * 2
              : tile_rows_bytes(bn)) +
         (conv1 ? 0 : tile_rows_bytes(bn));
}

// Dynamic shared memory of one conv block: alignment slack, the ring,
// one window slot (two when persistent), the ring's full and empty
// barriers, each slot's chunk barriers and its empty barrier
// (ops/mrf.py::wg_smem_bytes).
int wg_smem_bytes(int bn, int cp, int k, int d, bool conv1, int persist) {
  return kAlign + kStages * tile_bytes(bn) +
         (persist ? 2 : 1) * slot_bytes(bn, cp, k, d, conv1) +
         (2 * kStages + 2 * kMaxChunks + 2) * 8;
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

// order this thread's generic-proxy accesses to shared memory (the lrelu
// pass's, the epilogue's) before the async proxy's: the MMAs' reads, the
// tensor copies' writes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// at most N of this thread's newest commit groups still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// arrive on the barrier where pred holds: a predicate inside the asm, not
// a branch, since ptxas serialises wgmma across a divergent branch taken
// while MMAs are in flight
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"((int)pred)
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

// the box of a 3-D tensor map at coordinates (x, y, z) into shared memory,
// completing on bar; the elements outside the tensor are zeros
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            int x, int y, int z,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          dst),
      "l"(map), "r"(x), "r"(y), "r"(z), "r"(bar)
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

// Descriptor of a K-major A operand without swizzle (mode 0, bits 62-63),
// a 64 x 16 slice of the window: start address >> 4 (bits 0-13), LBO =
// the plane stride between the step's two 8-channel halves (>> 4, bits
// 16-29), SBO = 128 bytes between 8-position core matrices (>> 4, bits
// 32-45).  ops/mrf.py::wg_a_desc mirrors it.
__device__ __forceinline__ uint64_t a_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, A and B K-major by
// descriptor.  d[4 i + 2 r + e] is row 16 warp + lane / 4 + 8 r, column
// 8 i + 2 (lane % 4) + e of the m64 x N tile.
#define MRF_WGMMA_OPEN(n, s) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #s ", 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n" #n "k16.f32.bf16.bf16 {"
#define MRF_WGMMA_CLOSE(a, b) "}, %" #a ", %" #b ", p, 1, 1, 0, 0;\n}\n"
#define MRF_R8(i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da,
                                             uint64_t db) {
    asm volatile(MRF_WGMMA_OPEN(16, 10)
                 "%0, %1, %2, %3, %4, %5, %6, %7"
                 MRF_WGMMA_CLOSE(8, 9)
                 : MRF_R8(0)
                 : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(MRF_WGMMA_OPEN(32, 18)
                 "%0, %1, %2, %3, %4, %5, %6, %7, "
                 "%8, %9, %10, %11, %12, %13, %14, %15"
                 MRF_WGMMA_CLOSE(16, 17)
                 : MRF_R8(0), MRF_R8(8)
                 : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(MRF_WGMMA_OPEN(64, 34)
                 "%0, %1, %2, %3, %4, %5, %6, %7, "
                 "%8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31"
                 MRF_WGMMA_CLOSE(32, 33)
                 : MRF_R8(0), MRF_R8(8), MRF_R8(16), MRF_R8(24)
                 : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(MRF_WGMMA_OPEN(128, 66)
                 "%0, %1, %2, %3, %4, %5, %6, %7, "
                 "%8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31, "
                 "%32, %33, %34, %35, %36, %37, %38, %39, "
                 "%40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, "
                 "%56, %57, %58, %59, %60, %61, %62, %63"
                 MRF_WGMMA_CLOSE(64, 65)
                 : MRF_R8(0), MRF_R8(8), MRF_R8(16), MRF_R8(24),
                   MRF_R8(32), MRF_R8(40), MRF_R8(48), MRF_R8(56)
                 : "l"(da), "l"(db), "r"(1));
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
  constexpr int BM = wg_bm(BN);
  constexpr int TS = BN + kRowPad;
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
__global__ void __launch_bounds__(kWgThreads, wg_min_blocks(BN))
mrf_conv_wg_kernel(const WgConv a, const __grid_constant__ CUtensorMap src) {
  constexpr int MT = wg_mt(BN);               // m64 tiles a warpgroup
  constexpr int BM = wg_bm(BN);               // positions a tile
  constexpr int kTile = tile_bytes(BN);
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t ring = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const int Cp = a.Cp, L = a.L, k = a.k, d = a.d;
  const int cw = wg_cw(Cp);
  const int ppc = cw / 8;                     // window planes a chunk
  const int box = box_rows(BN, k, d);         // rows a tensor copy
  const int nbox = win_boxes(BN, k, d);       // tensor copies a plane
  const int pstride = 16 * nbox * box;        // bytes a plane
  const uint32_t win0 = ring + kStages * kTile;
  const int slot_b = slot_bytes(BN, Cp, k, d, CONV1);
  const int area = slot_b - (CONV1 ? 0 : tile_rows_bytes(BN));
  const uint32_t full = win0 + (a.persist ? 2 : 1) * slot_b;
  const uint32_t empty = full + 8 * kStages;  // kStages barriers each
  // window slot s: chunk c lands on wfull + 8 (kMaxChunks s + c); the
  // consumers release the slot on wempty + 8 s
  const uint32_t wfull = empty + 8 * kStages;
  const uint32_t wempty = wfull + 8 * 2 * kMaxChunks;
  const int nb = blockIdx.x;
  const int spt = cw / 16;                    // k-steps a tap of a chunk
  const int spc = k * spt;                    // k-steps a chunk
  const int nchunk = Cp / cw;
  const int steps = nchunk * spc;
  const int tiles = (steps + 3) / 4;          // weight tiles a position tile
  const int iters = (a.total - blockIdx.y + gridDim.y - 1) / gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumerWGs);
    }
    for (int s = 0; s < 2; ++s) {
      for (int c = 0; c < kMaxChunks; ++c) {
        mbar_init(wfull + 8 * (kMaxChunks * s + c), 1);
      }
      mbar_init(wempty + 8 * s, 4 * kConsumerWGs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumerWGs) {
    if (lane == 0) {
      // weight tile n = it tiles + i of this block's output channels into
      // ring slot n % kStages, once the consumers have released the slot's
      // last use
      const unsigned char* w = static_cast<const unsigned char*>(a.w) +
                               (size_t)nb * tiles * kTile;
      for (int n = 0; n < iters * tiles; ++n) {
        const int s = n % kStages, i = n % tiles;
        mbar_wait(empty + 8 * s, ((n / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, kTile);
        bulk_g2s(ring + s * kTile, w + (size_t)i * kTile, kTile, full + 8 * s);
      }
    } else if (lane == 1) {
      // the window of position tile it into its slot, once the consumers
      // have released the slot's last use: each 8-channel plane of a chunk
      // as nbox tensor copies of box rows (window row r is position p0 -
      // half d + r of its batch row; the map fills zeros outside [0, L)),
      // the chunk's copies completing on its barrier
      for (int it = 0; it < iters; ++it) {
        const int s = a.persist ? it & 1 : 0;
        const int use = a.persist ? it >> 1 : it;  // the slot's earlier uses
        mbar_wait(wempty + 8 * s, (use & 1) ^ 1);
        const int t = blockIdx.y + it * gridDim.y;
        const int b = t / a.n_m;
        const int g_lo = (t - b * a.n_m) * BM - (k - 1) / 2 * d;
        const uint32_t wa = win0 + s * slot_b;
        for (int c = 0; c < nchunk; ++c) {
          const uint32_t bar = wfull + 8 * (kMaxChunks * s + c);
          mbar_expect_tx(bar, ppc * nbox * box * 16);
          for (int v = 0; v < ppc; ++v) {
            for (int q = 0; q < nbox; ++q) {
              tma_load_3d(wa + (c * ppc + v) * pstride + q * box * 16, &src,
                          c * cw + 8 * v, g_lo + q * box, b, bar);
            }
          }
        }
      }
    }
    return;
  }

  // conv2's residual rows [p0, p0 + BM) of the block's channels for
  // position tile t, beside the window of the slot at wa: one commit group
  auto load_residual = [&](int t, uint32_t wa) {
    if (!CONV1) {
      const int b = t / a.n_m;
      const int p0 = (t - b * a.n_m) * BM;
      const bf16* yin = a.yin + (size_t)b * L * Cp + nb * BN;
      for (int i = threadIdx.x; i < BM * (BN / 8); i += kConsumers) {
        const int r = i / (BN / 8), v = i - r * (BN / 8);
        const bool ok = p0 + r < L;
        cp_async16(wa + area + r * (BN + kRowPad) * 2 + 16 * v,
                   yin + (size_t)(ok ? p0 + r : 0) * Cp + 8 * v, ok);
      }
    }
    cp_async_commit();
  };
  // chunk c of the window at wa, for the MMAs: every consumer waits for the
  // chunk's copies (phase `parity` of its barrier); conv1 replaces each of
  // its elements by bf16(lrelu(.)) in place, a thread an element of 8 at a
  // time, and a proxy fence and the consumers' barrier hand the chunk to
  // the async proxy that wgmma reads through
  auto chunk_ready = [&](uint32_t wa, int c, uint32_t bar, int parity) {
    mbar_wait(bar, parity);
    if (CONV1) {
      const uint32_t base = wa + c * ppc * pstride;
      for (int i = threadIdx.x; i < ppc * nbox * box; i += kConsumers) {
        uint4* e = reinterpret_cast<uint4*>(smem + (base - raw) + 16 * i);
        uint4 u = *e;
        u.x = lrelu2(u.x);
        u.y = lrelu2(u.y);
        u.z = lrelu2(u.z);
        u.w = lrelu2(u.w);
        *e = u;
      }
      fence_proxy_async();
      consumer_sync();
    }
  };

  // this warpgroup's A: window rows wg 64 MT + 64 m + tap d on, for m64
  // tile m; the descriptor's fields but its start address
  const uint32_t a_row = 16 * (warp >> 2) * 64 * MT;
  const uint64_t a_fields = a_desc(0, pstride);
  if (a.persist) load_residual(blockIdx.y, win0);
  for (int it = 0; it < iters; ++it) {
    const int t = blockIdx.y + it * gridDim.y;
    const int b = t / a.n_m;
    const int p0 = (t - b * a.n_m) * BM;
    const int s = a.persist ? it & 1 : 0;
    const int parity = (a.persist ? it >> 1 : it) & 1;
    const uint32_t win = win0 + s * slot_b;
    // the residual rows: a persistent block's of the next tile, one
    // group a tile (empty past the last), else this tile's
    if (!a.persist) {
      load_residual(t, win0);
    } else if (it + 1 < iters) {
      load_residual(t + gridDim.y, win0 + ((it + 1) & 1) * slot_b);
    } else {
      cp_async_commit();
    }
    float acc[MT][BN / 2];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.f;
      fence_regs(acc[m]);
    }
    // a weight tile at a time: its 4 steps' 4 MT MMAs in one commit group
    // (a padding step past the last one re-reads that step's rows: its
    // weights are zero), then a wait until kMmaGroups groups are left in
    // flight, and the slots of the groups that completed go back to the
    // producer (rel: this position tile's tiles released).  Before a tile
    // whose steps reach a chunk not yet handed over, the warpgroup lets
    // its MMAs finish and readies the chunks (conv1's lrelu pass is a
    // divergent path, and ptxas serialises wgmma across one taken with
    // MMAs in flight).  k-step s = 4 tile + jj walks chunk c, tap, 16
    // channels j in order, by counters
    int c = 0, tap = 0, j = 0, ready = -1, rel = 0;
    for (int tile = 0; tile < tiles; ++tile) {
      const int n = it * tiles + tile, slot = n % kStages;
      const int last = min(4 * tile + 3, steps - 1);  // its last real step
      if (last >= (ready + 1) * spc) {
        wg_wait<0>();
        for (; rel < tile; ++rel) {
          mbar_arrive_if(empty + 8 * ((it * tiles + rel) % kStages),
                         lane == 0);
        }
        while (ready < last / spc) {
          ++ready;
          chunk_ready(win, ready, wfull + 8 * (kMaxChunks * s + ready),
                      parity);
        }
      }
      uint32_t addr[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        addr[jj] = win + (c * ppc + 2 * j) * pstride + a_row + 16 * tap * d;
        if (4 * tile + jj + 1 < steps && ++j == spt) {  // else: re-read
          j = 0;
          if (++tap == k) {
            tap = 0;
            ++c;
          }
        }
      }
      mbar_wait(full + 8 * slot, (n / kStages) & 1);
      wg_fence();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const uint64_t db = b_desc(ring + slot * kTile + 32 * jj);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint64_t da = a_fields | ((addr[jj] + 1024 * m) >> 4);
          Wgmma<BN>::mma(acc[m], da, db);
        }
      }
      wg_commit();
      wg_wait<kMmaGroups>();
      for (; rel <= tile - kMmaGroups; ++rel) {  // those groups are done
        mbar_arrive_if(empty + 8 * ((it * tiles + rel) % kStages), lane == 0);
      }
    }
    wg_wait<0>();
    for (; rel < tiles; ++rel) {
      mbar_arrive_if(empty + 8 * ((it * tiles + rel) % kStages), lane == 0);
    }
    if (a.persist) {              // this tile's residual rows
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
    epilogue<BN, MT, CONV1>(a, acc, smem + (win - raw),
                            smem + (win - raw) + area, b, p0, nb);
    fence_proxy_async();          // before the next window's copies
    consumer_sync();              // the window is free for the next load
    mbar_arrive_if(wempty + 8 * s, lane == 0);
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

// the driver's cuTensorMapEncodeTiled, found through the runtime once (the
// library links no driver library); null where the driver lacks it
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <int BN, bool CONV1>
int launch_wg(const WgConv& a0, int B, int sms, cudaStream_t stream) {
  constexpr int BM = wg_bm(BN);
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
  // the window's source [B][L][Cp] bf16 as a tensor map: boxes of 8
  // channels x box_rows positions x 1 batch row, zeros outside
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)a.Cp, (cuuint64_t)a.L,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)a.Cp * 2,
                                 (cuuint64_t)a.L * a.Cp * 2};
  const cuuint32_t box[3] = {8, (cuuint32_t)box_rows(BN, a.k, a.d), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<bf16*>(a.src), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(a.Cp / BN, blocks, 1);
  mrf_conv_wg_kernel<BN, CONV1><<<grid, kWgThreads, smem, stream>>>(a, map);
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
  if (C < 1 || C % 8 != 0 || Cp / wg_cw(Cp) > kMaxChunks || nblk < 1 ||
      npair < 1 || y0 == nullptr ||
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
  const bf16* wp = static_cast<const bf16*>(w);
  const float* bp = bias;
  for (int j = 0; j < nblk; ++j) {
    const int k = ks[j];
    // bf16 elements of one conv's tiles: ceil(k Cp / 64) tiles x Cp x 64
    const size_t conv_elems = (size_t)((k * Cp / 16 + 3) / 4) * Cp * kTileK;
    for (int p = 0; p < npair; ++p) {
      const bool last_pair = p == npair - 1;
      WgConv a = {};
      a.C = C; a.Cp = Cp; a.L = L; a.k = k; a.nblk = nblk;
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
