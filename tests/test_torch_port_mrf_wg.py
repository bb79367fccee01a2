"""The bf16 MRF route (cmtts_tpu_torch/csrc/mrf_wg.cu) on the CPU: its B-tile
packer, an emulation of the wgmma shared-memory descriptor reading the
tiles back, an emulation of one conv launch that follows the kernel's lane
-> (row, column) mappings exactly (ldmatrix.x4 rows at the tap's offset in
the zero-filled window, the m16n8k16 A fragment of each warp, the m64
accumulator layout, the fused epilogue), the whole stage through that
emulation with every buffer NaN where no launch has written it, the
padded V2 stage, the work-split constants, and the library build's
stale/fresh decision.  The kernel itself runs only on the card
(chip_smoke.py); these tests find layout and index faults without it."""

import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_port_mrf_wg_variants as mrf_wg_variants
from cmtts_tpu_torch.ops import mrf

KS, DS = (3, 7, 11), (1, 3, 5)
NAN = float("nan")
LANE = torch.arange(32)
G, Q = LANE // 4, LANE % 4
# the sum's order may flip the rounding of bf16(conv + bias), then lrelu or
# the residual add rounds again: two bf16 roundings apart
BF16_2ULP = dict(rtol=2 ** -6, atol=1e-6)
BF16_STAGE_TOL = dict(rtol=2 ** -6, atol=1e-2)      # chip_smoke.py's


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's pool slows these many small ops under the suite's
    workers: one thread while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rnd(v):
    return v.to(torch.bfloat16).float()


def lrelu(v, s=0.1):
    return torch.maximum(v, v * s)


# -- the kernel's operands, lane by lane --------------------------------------

# PTX's m16n8k16 A fragment, which is also a warp's 16 rows of wgmma's A in
# registers: register m of lane 4g + q holds (row, column) (g + 8 (m % 2),
# 2q + 8 (m // 2) + h), h = 0, 1
_R, _H = torch.arange(4)[None, :, None], torch.arange(2)[None, None, :]
A_ROW = (G[:, None, None] + 8 * (_R % 2)).expand(32, 4, 2)
A_COL = 2 * Q[:, None, None] + 8 * (_R // 2) + _H


def ldmatrix_x4(flat, addr):
    """ldmatrix.x4 on bf16 buffers ``flat`` (blocks, n): lane l gives the
    element offset ``addr[..., l]`` of an 8-element row; lanes 8m..8m+7
    give the rows of matrix m.  Returns regs (blocks, ..., 32, 4, 2): lane
    L's register m holds matrix m's row L // 4, elements 2 (L % 4) + h."""
    mats = flat[:, addr[..., None] + torch.arange(8)].unflatten(-2, (4, 8))
    return mats[..., _R, (LANE // 4)[:, None, None],
                (2 * (LANE % 4))[:, None, None] + _H]


def a_matrix(regs):
    """The 16 x 16 A tiles the registers (..., 32, 4, 2) stand for."""
    A = torch.full(regs.shape[:-3] + (16, 16), NAN)
    A[..., A_ROW, A_COL] = regs
    return A


def desc_read(smem, desc, n):
    """wgmma's B operand (16 x n, K x N) as the descriptor ``desc`` reads
    it from the bf16 shared memory ``smem``: K-major with the 128-byte
    swizzle, element (kk, col) at start + (col / 8) SBO + (col % 8) 128 +
    2 kk, its 16-byte chunk (address bits 4-6) XORed with bits 7-9."""
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    assert desc >> 62 == 1 and (desc >> 49) & 7 == 0   # 128 B, base 0
    kk, col = torch.meshgrid(torch.arange(16), torch.arange(n), indexing="ij")
    addr = start + (col // 8) * sbo + (col % 8) * 128 + 2 * kk
    addr = addr ^ (((addr >> 7) & 7) << 4)
    return smem[addr // 2]


RING = 3 * mrf.WG_ALIGN          # a slot's shared address in the emulation


def b_matrix(tiles, Cp, k, nb, s):
    """Step s's B (16 x BN) of output-channel block nb, read from its
    tile's ring slot through the step's descriptor."""
    bn = mrf.wg_block(Cp)
    tile = tiles.view(Cp // bn, mrf.wg_tile_count(Cp, k), bn * 64)[nb, s // 4]
    smem = torch.full((RING // 2 + bn * 64,), NAN)
    smem[RING // 2:] = tile.float()
    return desc_read(smem, mrf.wg_desc(RING + 32 * (s % 4)), bn)


def emulate_conv_wg(src, tiles, bias, C, L, k, d, conv1, dst, yin=None,
                    sum_=None, first=True, last=True, nblk=1):
    """``mrf_conv_wg_kernel`` on the CPU for every block of one launch:
    src [B][L][Cp] bf16, ``tiles`` this conv's packed B tiles, bias [Cp];
    writes ``dst`` ([B][L][Cp] bf16) and ``sum_`` ((B, C, L) f32) in place
    as the epilogue does: registers -> the [BM][BN + 8] tile over the
    window -> 16-byte chunks of rows (conv2 adds its residual rows, which
    the kernel fetches into shared memory beside the window) -> the sum by
    (channel, position).  The order in which blocks walk the position
    tiles does not change what they write."""
    B, _, Cp = src.shape
    bn, mt = mrf.wg_tiling(Cp)
    bm = 128 * mt
    half = (k - 1) // 2
    rows, rowp = bm + (k - 1) * d, Cp + mrf.WG_ROW_PAD
    steps = mrf.wg_steps(Cp, k)
    n_m = -(-L // bm)
    # the windows of every (batch row, position tile): zero outside [0, L),
    # NaN in the row pad (never read)
    g = torch.arange(n_m)[:, None] * bm - half * d + torch.arange(rows)
    ok = (g >= 0) & (g < L)
    win = torch.full((B, n_m, rows, rowp), NAN)
    win[..., :Cp] = torch.where(ok[None, :, :, None],
                                src.float()[:, g.clamp(0, L - 1)],
                                torch.zeros(()))
    flat = win.reshape(B * n_m, rows * rowp)
    # lane addresses of (warpgroup, m64 tile, warp): rows 16 warp + lane % 16,
    # columns 8 (lane / 16)
    wg, m, w = torch.meshgrid(torch.arange(2), torch.arange(mt),
                              torch.arange(4), indexing="ij")
    row0 = (wg * 64 * mt + m * 64 + w * 16)[..., None] + LANE % 16
    a_lane = row0 * rowp + (LANE // 16) * 8                 # (2, mt, 4, 32)
    # the accumulator registers' rows and columns: d[4i + 2r + e] at row
    # 16 warp + g + 8 r, column 8 i + 2 q + e
    reg = torch.arange(bn // 2)
    i_, r_, e_ = reg // 4, reg % 4 // 2, reg % 2
    # (2, mt, 4, 32, bn / 2)
    acc_row = (row0 - LANE % 16)[..., None] + G[:, None] + 8 * r_
    acc_col = (8 * i_ + e_)[None, :] + 2 * Q[:, None]
    for nb in range(Cp // bn):
        D = torch.zeros(B * n_m, bm, bn)
        # whole tiles of 4 steps: a padding step re-reads the last step's
        # rows, against zero weights
        for s in range(4 * mrf.wg_tile_count(Cp, k)):
            t, ci0 = steps[min(s, len(steps) - 1)]
            regs = ldmatrix_x4(flat, a_lane + t * d * rowp + ci0)
            if conv1:
                regs = rnd(lrelu(regs))
            A = a_matrix(regs).reshape(B * n_m, bm, 16)
            D += A @ b_matrix(tiles, Cp, k, nb, s)
        col = acc_col.expand_as(acc_row)
        acc = D[:, acc_row, col]                            # the registers
        # the epilogue's tile over the window, [BM][BN + 8] bf16, written
        # from the registers: conv1 h, conv2 bf16(acc + bias)
        v = rnd(acc + bias[nb * bn + col])
        if conv1:
            v = rnd(lrelu(v))
        tile = torch.full((B * n_m, bm, bn + 8), NAN)
        tile[:, acc_row, col] = v
        tile = tile.view(B, n_m, bm, bn + 8)
        # the chunk pass: 16-byte chunks idx = thread + 256 u of the rows
        idx = torch.arange(bm * bn // 8)
        assert idx.numel() % 256 == 0
        row, cols = idx // (bn // 8), 8 * (idx % (bn // 8))[:, None] + \
            torch.arange(8)
        for mb in range(n_m):
            p = mb * bm + row
            keep = p < L
            pr, cr = p[keep][:, None], cols[keep]
            vals = tile[:, mb, row[keep][:, None], cr]      # (B, n, 8)
            if not conv1:
                vals = rnd(yin[:, pr, nb * bn + cr].float() + vals)
                tile[:, mb, row[keep][:, None], cr] = vals
            if dst is not None:
                dst[:, pr, nb * bn + cr] = vals.to(dst.dtype)
            if conv1 or sum_ is None:
                continue
            # the sum pass: idx = thread + 256 u over (channel, row)
            sidx = torch.arange(bm * bn)
            c2, r2 = sidx // bm, sidx % bm
            ok2 = (mb * bm + r2 < L) & (nb * bn + c2 < C)
            c2, r2 = c2[ok2], r2[ok2]
            yv = tile[:, mb, r2, c2]
            co, p2 = nb * bn + c2, mb * bm + r2
            s = yv if first else sum_[:, co, p2] + yv
            sum_[:, co, p2] = s / nblk if last else s


def emulate_stage_wg(x, packed, post=None):
    """``mrf_stage_bf16`` on the CPU: the cast into y0 (its pad channels
    zero), the 18 conv launches through :func:`emulate_conv_wg` with h, y
    and the ResBlock sum NaN until a launch writes them, and the head
    kernel with its roundings."""
    w, b, tiles = packed
    B, C, L = x.shape
    Cp = mrf.padded_channels(C)
    y0 = torch.zeros(B, L, Cp)
    y0[..., :C] = x.transpose(1, 2)
    y0 = y0.to(torch.bfloat16)
    h = torch.full((B, L, Cp), NAN).to(torch.bfloat16)
    y = h.clone()
    s = torch.full((B, C, L), NAN)
    bias = F.pad(b.view(-1, C), (0, Cp - C))
    off = n = 0
    for j, k in enumerate(KS):
        ce = mrf.wg_tile_count(Cp, k) * Cp * mrf.WG_TILE_K
        for p, d in enumerate(DS):
            last_pair = p == len(DS) - 1
            emulate_conv_wg(y0 if p == 0 else y, tiles[off: off + ce],
                            bias[n], C, L, k, d, True, h)
            emulate_conv_wg(h, tiles[off + ce: off + 2 * ce], bias[n + 1], C,
                            L, k, 1, False, None if last_pair else y,
                            yin=y0 if p == 0 else y,
                            sum_=s if last_pair else None, first=j == 0,
                            last=j == len(KS) - 1, nblk=len(KS))
            off += 2 * ce
            n += 2
    if post is None:
        return s
    wp, bp = post
    half = (wp.shape[0] - 1) // 2
    hs = F.pad(rnd(lrelu(rnd(s), 0.01)), (half, half))
    acc = sum(wp[t].float() @ hs[..., t: t + L] for t in range(wp.shape[0]))
    return torch.tanh(rnd(acc + bp))


class _Gen(torch.nn.Module):
    """One MRF stage (+ conv_post) named like the generator's params."""

    def __init__(self, C, seed):
        super().__init__()
        from cmtts_tpu_torch.models.hifigan import ResBlock

        torch.manual_seed(seed)
        self.cfg = SimpleNamespace(resblock_kernel_sizes=KS)
        for j, k in enumerate(KS):
            self.add_module(f"res_0_{j}", ResBlock(C, k, DS))
        self.conv_post = torch.nn.Conv1d(C, 1, 7, padding=3)


# -- (a) the packer is a permutation ------------------------------------------

@pytest.mark.parametrize("C", [8, 16, 32, 64, 256])
def test_tile_packer_is_a_permutation(C):
    """Each weight of a conv lands in exactly one place of its tiles; every
    other place (padding steps, padded channels) holds zero."""
    Cp = mrf.padded_channels(C)
    for k in KS:
        order = mrf.wg_tile_order(Cp, k)
        assert order.numel() == mrf.wg_tile_count(Cp, k) * Cp * 64
        real = order[order < k * Cp * Cp]
        assert torch.equal(real.sort().values, torch.arange(k * Cp * Cp))
        assert int((order == k * Cp * Cp).sum()) == (
            order.numel() - k * Cp * Cp)
    g = torch.Generator().manual_seed(C)
    w = torch.randn(2 * len(DS) * sum(KS) * C * C,
                    generator=g).to(torch.bfloat16)
    tiles = mrf.pack_wg_tiles(w, C, KS, len(DS))
    assert tiles.dtype == torch.bfloat16
    off = toff = 0
    for k in KS:
        order = mrf.wg_tile_order(Cp, k)
        for _ in range(2 * len(DS)):
            t = tiles[toff: toff + order.numel()]
            wp = F.pad(w[off: off + k * C * C].view(k, C, C),
                       (0, Cp - C, 0, Cp - C)).reshape(-1)
            back = torch.zeros(k * Cp * Cp + 1, dtype=torch.bfloat16)
            back[order] = t
            assert torch.equal(back[:-1], wp)
            assert torch.equal(t[order == k * Cp * Cp],
                               torch.zeros(int((order == k * Cp * Cp).sum()),
                                           dtype=torch.bfloat16))
            off += k * C * C
            toff += order.numel()
    assert toff == tiles.numel()


@pytest.mark.parametrize("C,n", [(12, 2 * 3 * 21 * 144), (16, 100),
                                 (8, 2 * 3 * 21 * 64 + 1)])
def test_tile_packer_rejects_bad_shapes(C, n):
    with pytest.raises(ValueError):
        mrf.pack_wg_tiles(torch.zeros(n, dtype=torch.bfloat16), C)


def test_padded_stage_pack_is_the_zero_padded_pack():
    """V2's last stage (C = 8) packs as the 16-channel stage whose extra
    input and output channels are zero, and its kernel pack is bf16 B
    tiles, not None."""
    g = torch.Generator().manual_seed(8)
    w8 = torch.randn(2 * len(DS) * sum(KS) * 64, generator=g)
    w16, off = [], 0
    for k in KS:
        for _ in range(2 * len(DS)):
            w16.append(F.pad(w8[off: off + k * 64].view(k, 8, 8),
                             (0, 8, 0, 8)).reshape(-1))
            off += k * 64
    w16 = torch.cat(w16).to(torch.bfloat16)
    t8 = mrf.pack_wg_tiles(w8.to(torch.bfloat16), 8, KS, len(DS))
    assert torch.equal(t8, mrf.pack_wg_tiles(w16, 16, KS, len(DS)))
    _, _, tiles = mrf.pack_mrf_params(_Gen(8, 0), 0, torch.bfloat16)
    assert tiles is not None and tiles.dtype == torch.bfloat16


# -- (b) the descriptor reads the tiles back ----------------------------------

@pytest.mark.parametrize("C", [16, 32, 64, 128, 256])
def test_descriptor_reads_back_the_weights(C):
    """For every conv width, output-channel block, tile and step, the B
    operand read through the step's descriptor (start, SBO, the 128-byte
    swizzle XOR) is w[tap][ci0 + kk][nb BN + n] exactly, zero on padding
    steps."""
    k = 7
    g = torch.Generator().manual_seed(C)
    w = torch.randn(k, C, C, generator=g).to(torch.bfloat16)
    tiles = torch.cat([w.reshape(-1), w.new_zeros(1)])[
        mrf.wg_tile_order(C, k)]
    bn = mrf.wg_block(C)
    steps = mrf.wg_steps(C, k)
    for nb in range(C // bn):
        for s in range(4 * mrf.wg_tile_count(C, k)):
            B = b_matrix(tiles, C, k, nb, s)
            if s < len(steps):
                t, ci0 = steps[s]
                want = w[t, ci0: ci0 + 16, nb * bn: (nb + 1) * bn].float()
            else:
                want = torch.zeros(16, bn)
            assert torch.equal(B, want), (nb, s)


def test_descriptor_fields():
    """wg_desc: start >> 4, LBO 1, SBO 1024 >> 4, 128-byte swizzle; an
    address past 256 KB wraps in the 18-bit shared window."""
    d = mrf.wg_desc(0x12340)
    assert d & 0x3FFF == 0x1234
    assert (d >> 16) & 0x3FFF == 1
    assert (d >> 32) & 0x3FFF == 64
    assert (d >> 49) & 7 == 0 and d >> 62 == 1
    assert mrf.wg_desc(0x40000 + 0x400) & 0x3FFF == 0x40


# -- (c) one conv, lane by lane, against F.conv1d -----------------------------

def conv_case(C, k, d, L, conv1, seed):
    """A conv launch's inputs: src and yin random bf16 [2][L][C], the
    conv's weights [k][C][C] packed as tiles, a bias."""
    rng = np.random.RandomState(seed)
    src = torch.from_numpy(rng.randn(2, L, C).astype(np.float32)).to(
        torch.bfloat16)
    yin = torch.from_numpy(rng.randn(2, L, C).astype(np.float32)).to(
        torch.bfloat16)
    w = (torch.from_numpy(rng.randn(k, C, C).astype(np.float32))
         / np.sqrt(k * C)).to(torch.bfloat16)
    tiles = torch.cat([w.reshape(-1), w.new_zeros(1)])[
        mrf.wg_tile_order(C, k)]
    bias = torch.from_numpy(rng.randn(C).astype(np.float32) * 0.1)
    return src, yin, w, tiles, bias


@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("d", [1, 3, 5])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_conv_emulation_matches_conv1d(k, d, C):
    """One launch (conv1 with lrelu on A, or conv2 into y and the ResBlock
    sum) over L = 300 (a whole 256-position tile and a ragged one) against
    F.conv1d with SAME zero padding, within two bf16 roundings."""
    L = 300
    conv1 = (k + d + C // 16) % 2 == 0
    src, yin, w, tiles, bias = conv_case(C, k, d, L, conv1, k * d + C)
    half = (k - 1) // 2
    x = src.float().transpose(1, 2)
    if conv1:
        x = rnd(lrelu(x))
    ref = rnd(F.conv1d(x, w.float().permute(2, 1, 0), bias,
                       padding=half * d, dilation=d).transpose(1, 2))
    dst = torch.full((2, L, C), NAN).to(torch.bfloat16)
    if conv1:
        emulate_conv_wg(src, tiles, bias, C, L, k, d, True, dst)
        torch.testing.assert_close(dst.float(), rnd(lrelu(ref)), **BF16_2ULP)
        return
    sum_ = torch.full((2, C, L), NAN)
    emulate_conv_wg(src, tiles, bias, C, L, k, d, False, dst, yin=yin,
                    sum_=sum_, first=True, last=True, nblk=1)
    want = rnd(yin.float() + ref)
    torch.testing.assert_close(dst.float(), want, **BF16_2ULP)
    torch.testing.assert_close(sum_, want.transpose(1, 2), **BF16_2ULP)


# -- (d) the whole stage through the emulated launches ------------------------

@pytest.mark.parametrize("C,L,head", [
    (16, 40, True), (16, 300, False), (32, 50, False), (32, 300, True),
    (8, 77, True), (128, 90, False)])
def test_stage_emulation_matches_plain_bf16(C, L, head):
    """The emulated bf16 route (y0, 18 conv launches, NaN wherever no
    launch has written, the head kernel) against the plain bf16 stage at
    chip_smoke.py's kernel tolerance: L shorter than a block, a ragged
    last tile, with and without the head, V2's padded C = 8 and a
    C = 128 stage on m64 tiles of one a warpgroup (MT = 1)."""
    gen = _Gen(C, seed=C + L)
    packed = mrf.pack_mrf_params(gen, 0, torch.bfloat16)
    post = mrf.pack_post_params(gen, torch.bfloat16) if head else None
    x = torch.from_numpy(
        np.random.RandomState(L).randn(2, C, L).astype(np.float32) * 0.3)
    if C == 128:
        assert mrf.wg_tiling(C) == (128, 1)
    with torch.no_grad():
        ref = mrf.fused_mrf_stage(x, packed, KS, DS, torch.bfloat16, post)
        out = emulate_stage_wg(x, packed, post)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, **BF16_STAGE_TOL)


# -- the packs, shapes and constants the kernel is handed ---------------------

@pytest.mark.parametrize("C", [8, 12, 16, 32])
def test_stage_pack_carries_the_tiles(C):
    """pack_mrf_params hands each entry point one pack: the bf16 pack
    holds the B tiles beside [tap][c_in][c_out]; float32, and a width the
    bf16 kernel does not take (not a multiple of 8), hold none."""
    gen = _Gen(C, seed=C)
    w32, b32, t32 = mrf.pack_mrf_params(gen, 0)
    assert t32 is None and w32.dtype == torch.float32
    w, b, tiles = mrf.pack_mrf_params(gen, 0, torch.bfloat16)
    assert torch.equal(w, w32.to(torch.bfloat16)) and torch.equal(b, b32)
    if C % 8:
        assert tiles is None
    else:
        assert torch.equal(tiles, mrf.pack_wg_tiles(w, C, KS, len(DS)))


def test_kernel_takes_bfloat16_shapes():
    bf = torch.bfloat16
    assert mrf.kernel_takes(8, bf, post_k=7)            # V2's last stage
    assert not mrf.kernel_takes(12, bf)
    assert not mrf.kernel_takes(4, bf, post_k=7)
    assert all(mrf.kernel_takes(C, bf) for C in (16, 32, 64, 128, 256))
    assert not mrf.kernel_takes(32, bf, post_k=19)      # head taps staged
    assert not mrf.kernel_takes(256, bf, (11,), (40,))  # window too wide
    assert mrf.kernel_takes(64, bf, (11,), (40,))


def test_tiling_and_shared_memory_of_the_main_path():
    """BN, MT and a conv block's shared memory with one window slot (conv2
    with its residual rows beside the window) against the 232,448 bytes a
    block may use, as the source's header adds them up at C = 256, k = 11,
    d = 5; every conv of the main path's widths fits."""
    assert [mrf.wg_tiling(C) for C in (256, 128, 64, 32, 16)] == [
        (128, 1), (128, 1), (64, 2), (32, 2), (16, 2)]
    assert [mrf.wg_chunk(C) for C in (256, 128, 64, 32, 16)] == [
        64, 64, 64, 32, 16]
    assert mrf.wg_smem_bytes(256, 11, 5, True) == (
        1024 + 4 * 16384 + 93984 + 64)
    assert mrf.wg_smem_bytes(256, 11, 1, False) == (
        1024 + 4 * 16384 + 138 * 528 + 128 * 136 * 2 + 64)
    assert mrf.wg_smem_bytes(128, 11, 5, True) == (
        1024 + 4 * 16384 + 48416 + 64)
    assert mrf.wg_smem_bytes(64, 11, 5, True) == (
        1024 + 4 * 8192 + 44064 + 64)
    assert mrf.wg_smem_bytes(64, 3, 1, False) == (
        1024 + 4 * 8192 + 258 * 144 + 256 * 72 * 2 + 64)
    assert all(mrf.wg_smem_bytes(C, k, d, c1) <= mrf.SMEM_LIMIT
               for C in (256, 128, 64, 32, 16) for k in KS
               for d, c1 in ((1, True), (3, True), (5, True), (1, False)))
    # the widest stage the kernel takes: conv2's residual rows counted
    assert mrf.wg_smem_bytes(384, 11, 1, False) <= mrf.SMEM_LIMIT
    assert mrf.wg_smem_bytes(512, 11, 1, False) > mrf.SMEM_LIMIT
    assert not mrf.kernel_takes(512, torch.bfloat16)


def test_work_split_constants_match_the_source():
    """The consumer warpgroups, tile depth, ring slots, widest block, row
    pad and alignment that this file's emulation and ops/mrf.py use are
    the kernel's own constants, and its descriptor is wg_desc's."""
    with open(os.path.join(mrf._CSRC, "mrf_wg.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    assert (const("kConsumerWGs"), const("kTileK"), const("kStages"),
            const("kMaxBN"), const("kRowPad"), const("kAlign")) == (
        mrf.WG_CONSUMERS, mrf.WG_TILE_K, mrf.WG_STAGES, mrf.WG_MAX_BN,
        mrf.WG_ROW_PAD, mrf.WG_ALIGN)
    assert const("kMaxPostK") == mrf.F32_MAX_POST_K
    body = re.search(r"uint64_t b_desc\(uint32_t addr\) \{(.*?)\}", src,
                     re.S).group(1)
    assert "(1024 >> 4) << 32" in body and "1 << 62" in body
    assert "(uint64_t)1 << 16" in body and "(addr & 0x3FFFF) >> 4" in body


@pytest.mark.parametrize("name", list(mrf_wg_variants.VARIANTS))
def test_design_sweep_edits_match_the_source(name):
    """tests/torch_port_mrf_wg_variants.py builds each variant from the
    kernel's source with text edits: each edit's text is there exactly
    once, the edit changes the source (bar the base), and a second
    application finds nothing to edit."""
    with open(os.path.join(mrf._CSRC, "mrf_wg.cu")) as f:
        src = f.read()
    out = mrf_wg_variants.variant_source(name, src)
    assert (out == src) == (name == "base")
    if name == "prof":
        assert out.count("clock64()") == 14
        assert out.count("pr[") == 9 and "mrf_wg_prof" in out
        assert out.count("{") == out.count("}")
    if mrf_wg_variants.VARIANTS[name]:
        with pytest.raises(ValueError):
            mrf_wg_variants.variant_source(name, out)


# -- the library build's stale/fresh decision ---------------------------------

def test_library_name_tracks_sources_and_flags(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// kernel\n")
    (csrc / "a.cuh").write_text("// header\n")
    first = mrf.library_path(str(csrc))
    assert first == mrf.library_path(str(csrc))
    (csrc / "a.cuh").write_text("// header, changed\n")
    assert mrf.library_path(str(csrc)) != first
    (csrc / "a.cuh").write_text("// header\n")
    assert mrf.library_path(str(csrc)) == first
    (csrc / "b.cu").write_text("// second source\n")
    assert mrf.library_path(str(csrc)) != first
    assert (mrf.library_path(str(csrc), mrf.NVCC_FLAGS + ("-G",))
            != mrf.library_path(str(csrc)))


def test_build_skips_a_fresh_library_and_rebuilds_a_stale_one(
        tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    (csrc / "k_wg.cu").write_text("// second kernel\n")
    (csrc / "k.cuh").write_text("// header\n")
    monkeypatch.setattr(mrf, "_CSRC", str(csrc))
    monkeypatch.setattr(mrf, "_BUILD", str(build))
    monkeypatch.setattr(mrf.library_path, "__defaults__",
                        (str(csrc), mrf.NVCC_FLAGS))
    calls = []

    def fake_nvcc(cmd, capture_output, text):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("lib")
        return SimpleNamespace(returncode=0, stdout="ptxas info", stderr="")

    monkeypatch.setattr(mrf, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(mrf.subprocess, "run", fake_nvcc)
    mrf.build_kernels()                        # nothing built yet: stale
    # one nvcc per source (-c), then the link (-shared) of the objects
    assert len(calls) == 3
    compiled = sorted(c[c.index("-c") + 1] for c in calls[:2])
    assert compiled == [str(csrc / "k.cu"), str(csrc / "k_wg.cu")]
    objs = sorted(c[c.index("-o") + 1] for c in calls[:2])
    assert "-shared" in calls[2] and sorted(calls[2][-2:]) == objs
    assert os.path.exists(mrf.library_path())
    assert not any(os.path.exists(o) for o in objs)
    with open(mrf.library_path() + ".log") as f:
        assert f.read() == "ptxas info" * 3
    assert mrf.build_kernels() == 0.0          # fresh: no nvcc
    assert len(calls) == 3
    (csrc / "k.cuh").write_text("// header, changed\n")
    mrf.build_kernels()                        # a header changed: stale
    assert len(calls) == 6
    mrf.build_kernels(force=True)
    assert len(calls) == 9
