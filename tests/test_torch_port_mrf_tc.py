"""The bf16 tensor-core MRF kernel (cmtts_tpu_torch/csrc/mrf_tc.cu) on the
CPU: its weight packer, an emulation of one conv that follows the kernel's
lane -> (row, column) mappings exactly (ldmatrix.x4 rows with the clamp,
the m16n8k16 A/B/C fragment layouts, the packed B order, the masked
epilogue), that emulation driven through a whole stage, and the library
build's stale/fresh decision.  The kernel itself runs only on the card
(chip_smoke.py); these tests find index faults without it."""

import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cmtts_tpu_torch.ops import mrf

KS, DS = (3, 7, 11), (1, 3, 5)
PAD = mrf.ROW_PAD
LANE = torch.arange(32)
WARPS, MT = mrf.WARPS, mrf.PASS_TILES   # warps a block, m16 tiles a pass
BF16_ULP = dict(rtol=2 ** -7, atol=1e-6)  # one bf16 rounding apart


def rnd(v):
    return v.to(torch.bfloat16).float()


def lrelu(v, s=0.1):
    return torch.maximum(v, v * s)


# -- the kernel's fragments, lane by lane -------------------------------------

# PTX's m16n8k16 fragment layouts, as the (row, column) of each lane's
# register elements.  g = lane / 4, t = lane % 4.
G, T = LANE // 4, LANE % 4
_R, _H = torch.arange(4)[None, :, None], torch.arange(2)[None, None, :]
# A (16 x 16, [lane][a0..a3][lo, hi]): a0 (g, 2t), a1 (g + 8, 2t),
# a2 (g, 2t + 8), a3 (g + 8, 2t + 8), each two consecutive columns
A_ROW = (G[:, None, None] + 8 * (_R % 2)).expand(32, 4, 2)
A_COL = 2 * T[:, None, None] + 8 * (_R // 2) + _H
# B (16 x 8, [lane][b0.lo, b0.hi, b1.lo, b1.hi]): b0 (2t, g), b1 (2t + 8, g)
_E = torch.arange(4)[None, :]
B_ROW = 2 * T[:, None] + 8 * (_E // 2) + _E % 2
B_COL = G[:, None].expand(32, 4)
# C (16 x 8, [lane][c0..c3]): c0, c1 (g, 2t + (0, 1)), c2, c3 (g + 8, ...)
C_ROW = G[:, None] + 8 * (_E // 2)
C_COL = 2 * T[:, None] + _E % 2


def ldmatrix_x4(flat, addr):
    """ldmatrix.x4 on the bf16 buffer ``flat``: lane l gives the element
    offset ``addr[..., l]`` of an 8-element row; lanes 8m..8m+7 give the
    rows of matrix m.  Returns regs (..., 32, 4, 2): lane L's register m
    holds matrix m's row L // 4, elements 2 (L % 4) and 2 (L % 4) + 1."""
    mats = flat[addr[..., None] + torch.arange(8)].unflatten(-2, (4, 8))
    return mats[..., _R, (LANE // 4)[:, None, None],
                (2 * (LANE % 4))[:, None, None] + _H]


def a_matrix(regs):
    """The 16 x 16 A tiles the registers (..., 32, 4, 2) stand for."""
    A = torch.full(regs.shape[:-3] + (16, 16), float("nan"))
    A[..., A_ROW, A_COL] = regs
    return A


def b_matrix(vals):
    """The 16 x 8 (k x n) B tiles of lane values (..., 32, 4)."""
    B = torch.full(vals.shape[:-2] + (16, 8), float("nan"))
    B[..., B_ROW, B_COL] = vals
    return B


def c_regs(D):
    """The accumulator registers (..., 32, 4) of 16 x 8 tiles D."""
    return D[..., C_ROW, C_COL]


def warp_passes(n_cog, tiles_m):
    """(c_out group, first m16 tile, tiles owned) of every warp's passes:
    each warp an equal contiguous share of the (c_out group, m16 tile)
    units, in passes of at most MT tiles of one group."""
    units, passes = n_cog * tiles_m, []
    for warp in range(WARPS):
        u, u_end = warp * units // WARPS, (warp + 1) * units // WARPS
        while u < u_end:
            cog, m0 = divmod(u, tiles_m)
            mt = min(MT, tiles_m - m0, u_end - u)
            passes.append((cog, m0, mt))
            u += mt
    return passes


def emulate_conv_tc(src, dst, wf, bias, C, k, d, lo, hi, g0, L, act_in,
                    mode):
    """``conv_pass_tc`` of mrf_tc.cu for every warp pass and lane: reads
    the [W][C + 8] bf16 buffer ``src``, the fragment-ordered weights ``wf``
    of one conv, and writes rows [lo, hi) of ``dst`` in place."""
    NP = 2 if C % 32 == 0 else 1
    CP = C + PAD
    flat = src.reshape(-1)
    half = (k - 1) // 2
    ksteps = C // 16
    steps = k * ksteps
    n_cog = C // (16 * NP)
    tiles_m = -(-(hi - lo) // 16)
    lrow, lcol = LANE % 16, (LANE // 16) * 8
    # B tiles of every (k-step, pair, n8 tile): a pair's 8 values per lane
    # are b0, b1 of its first n8 tile, then of its second
    frags = wf.float().view(steps, C // 16, 32, 2, 4).transpose(2, 3)
    Bs = b_matrix(frags).flatten(1, 2)          # (steps, C / 8, 16, 8)
    passes = warp_passes(n_cog, tiles_m)
    assert sorted((c, m0 + i) for c, m0, mt in passes for i in range(mt)) \
        == [(c, m) for c in range(n_cog) for m in range(tiles_m)]
    i_, j_, r_, l_, h_ = torch.meshgrid(
        torch.arange(MT), torch.arange(2 * NP), torch.arange(2), LANE,
        torch.arange(2), indexing="ij")
    for cog, m0, mt in passes:
        pos0 = lo + 16 * m0
        # every tile of the pass, owned or not, rows clamped into [lo, hi)
        rows = torch.clamp(pos0 + 16 * torch.arange(MT)[:, None] + lrow,
                           max=hi - 1) - half * d
        abase = rows * CP + lcol                # (MT, 32)
        B = Bs[:, cog * 2 * NP: (cog + 1) * 2 * NP]
        D = torch.zeros(MT, 2 * NP, 16, 8)
        for s in range(steps):
            tap, ks = divmod(s, ksteps)
            regs = ldmatrix_x4(flat, abase + tap * d * CP + ks * 16).float()
            if act_in:
                regs = rnd(lrelu(regs))
            D += a_matrix(regs)[:, None] @ B[s][None]
        acc = c_regs(D)                         # (MT, 2 NP, 32, 4)
        # epilogue: the tiles it owns, rows < hi
        p = pos0 + 16 * i_ + l_ // 4 + 8 * r_
        co = (cog * 2 * NP + j_) * 8 + 2 * (l_ % 4) + h_
        v = acc[i_, j_, l_, 2 * r_ + h_] + bias[co]
        v = torch.where((g0 + p >= 0) & (g0 + p < L), rnd(v), torch.zeros(()))
        keep = (i_ < mt) & (p < hi)
        p, co, v = p[keep], co[keep], v[keep]
        if mode == 0:
            dst[p, co] = rnd(lrelu(v)).to(dst.dtype)
        else:
            dst[p, co] = rnd(dst[p, co].float() + v).to(dst.dtype)


# -- (a) the packer is a permutation ------------------------------------------

@pytest.mark.parametrize("C", [16, 32, 256])
def test_fragment_packer_is_a_permutation(C):
    for k in KS:
        order = mrf.fragment_order(C, k)
        assert torch.equal(order.sort().values, torch.arange(k * C * C))
    g = torch.Generator().manual_seed(C)
    n = 2 * len(DS) * sum(KS) * C * C
    w = torch.randn(n, generator=g).to(torch.bfloat16)
    wf = mrf.pack_mrf_fragments(w, C, KS, len(DS))
    assert wf.dtype == torch.bfloat16 and wf.shape == w.shape
    back, off = torch.empty_like(wf), 0
    for k in KS:
        inv = torch.empty_like(mrf.fragment_order(C, k))
        inv[mrf.fragment_order(C, k)] = torch.arange(k * C * C)
        for _ in range(2 * len(DS)):
            back[off: off + k * C * C] = wf[off: off + k * C * C][inv]
            off += k * C * C
    assert torch.equal(back, w)
    # lane 4g + t of (tap 0, step 0, pair 0) holds b0 = w[2t, 2t+1][g] first
    w3 = w[: 3 * C * C].view(3, C, C)
    lane5 = wf[5 * 8: 6 * 8]
    assert torch.equal(lane5[:2], w3[0, 2:4, 1])
    assert torch.equal(lane5[2:4], w3[0, 10:12, 1])
    assert torch.equal(lane5[4:6], w3[0, 2:4, 9])


def test_fragment_packer_rejects_bad_shapes():
    with pytest.raises(ValueError):
        mrf.pack_mrf_fragments(torch.zeros(2 * 3 * 21 * 64), 8)
    with pytest.raises(ValueError):
        mrf.pack_mrf_fragments(torch.zeros(100), 16)


# -- (b) one conv, lane by lane, against F.conv1d -----------------------------

def conv_case(C, k, d, n, mode, seed):
    """src/dst buffers as the kernel holds them: rows the conv may read are
    random bf16, every other row and the pad columns NaN; region [lo, hi)
    of n positions, part of it outside [0, L)."""
    half = (k - 1) // 2
    rng = np.random.RandomState(seed)
    lo = half * d + 3
    hi = lo + n
    W = hi + half * d + 5
    src = torch.full((W, C + PAD), float("nan"))
    rows = slice(lo - half * d, hi + half * d)
    src[rows, :C] = torch.from_numpy(
        rng.randn(hi - lo + 2 * half * d, C).astype(np.float32))
    src = src.to(torch.bfloat16)
    dst = torch.full((W, C + PAD), float("nan"))
    if mode == 1:
        dst[lo:hi, :C] = torch.from_numpy(
            rng.randn(n, C).astype(np.float32))
    dst = dst.to(torch.bfloat16)
    w = (torch.from_numpy(rng.randn(k, C, C).astype(np.float32))
         / np.sqrt(k * C)).to(torch.bfloat16)
    bias = torch.from_numpy(rng.randn(C).astype(np.float32) * 0.1)
    g0 = -lo - 4            # the first 4 positions lie before the sequence
    L = n - 10              # and the last 6 after it
    return src, dst, w, bias, lo, hi, g0, L


@pytest.mark.parametrize("C", [16, 32])
@pytest.mark.parametrize("d", [1, 3, 5])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_conv_fragment_emulation_matches_conv1d(k, d, C):
    n = {3: 37, 7: 70, 11: 83}[k]          # not multiples of 16
    mode = (k + d) % 2                      # conv1 (lrelu in, h) or conv2
    src, dst, w, bias, lo, hi, g0, L = conv_case(C, k, d, n, mode, k * d + C)
    half = (k - 1) // 2
    wf = w.reshape(-1)[mrf.fragment_order(C, k)]
    before = dst.clone()
    emulate_conv_tc(src, dst, wf, bias, C, k, d, lo, hi, g0, L,
                    act_in=mode == 0, mode=mode)
    x = src[lo - half * d: hi + half * d, :C].float()
    if mode == 0:
        x = rnd(lrelu(x))
    ref = F.conv1d(x.t()[None], w.float().permute(2, 1, 0), bias,
                   dilation=d)[0].t()                       # (n, C)
    g = torch.arange(lo, hi) + g0
    ref = torch.where(((g >= 0) & (g < L))[:, None], rnd(ref),
                      torch.zeros(()))
    ref = (rnd(lrelu(ref)) if mode == 0
           else rnd(before[lo:hi, :C].float() + ref))
    torch.testing.assert_close(dst[lo:hi, :C].float(), ref, **BF16_ULP)
    # the epilogue stores rows [lo, hi) and channels [0, C) only
    rest = torch.ones_like(dst, dtype=torch.bool)
    rest[lo:hi, :C] = False
    assert torch.equal(dst[rest].isnan(), before[rest].isnan())


# -- the whole bf16 stage through the emulated conv -------------------

def emulate_stage_tc(x, w, b, wf, tile, halo, post=None):
    """mrf_stage_tc_kernel on the CPU: per length tile the [W][C + 8] y/h
    buffers (NaN where the kernel never writes), the shrinking regions,
    every conv through :func:`emulate_conv_tc`, the f32 ResBlock sum and
    the SIMT head, with the kernel's bf16 roundings."""
    B, C, L = x.shape
    pad = 0 if post is None else (post[0].shape[0] - 1) // 2
    W = tile + 2 * halo
    out = torch.zeros((B, L) if post is not None else (B, C, L))
    for bi in range(B):
        for t0 in range(0, L, tile):
            g0 = t0 - halo
            g = torch.arange(W) + g0
            valid = (g >= 0) & (g < L)
            acc = None
            woff = boff = 0
            for k in KS:
                half = (k - 1) // 2
                y = torch.full((W, C + PAD), float("nan"))
                y[:, :C] = 0.0
                y[valid, :C] = x[bi][:, g[valid]].t()
                y = y.to(torch.bfloat16)
                h = torch.full((W, C + PAD), float("nan")).to(torch.bfloat16)
                rem = pad + sum(half * d + half for d in DS)
                for d in DS:
                    kcc = k * C * C
                    rem -= half * d
                    emulate_conv_tc(y, h, wf[woff: woff + kcc],
                                    b[boff: boff + C], C, k, d, halo - rem,
                                    halo + tile + rem, g0, L, True, 0)
                    rem -= half
                    emulate_conv_tc(h, y, wf[woff + kcc: woff + 2 * kcc],
                                    b[boff + C: boff + 2 * C], C, k, 1,
                                    halo - rem, halo + tile + rem, g0, L,
                                    False, 1)
                    woff += 2 * kcc
                    boff += 2 * C
                s = y[halo - pad: halo + tile + pad, :C].float().t()
                acc = s if acc is None else acc + s
            acc = acc / len(KS)
            n = min(tile, L - t0)
            if post is None:
                out[bi, :, t0:t0 + n] = acc[:, pad:pad + n]
            else:
                wp, bp = post
                u = torch.arange(n)
                h = rnd(lrelu(rnd(acc), 0.01))
                s = sum(wp[tap].float() @ h[:, u + tap]
                        for tap in range(wp.shape[0]))
                out[bi, t0:t0 + n] = torch.tanh(rnd(s + bp))
    return out


class _Gen(torch.nn.Module):
    def __init__(self, C, seed):
        super().__init__()
        from cmtts_tpu_torch.models.hifigan import ResBlock

        torch.manual_seed(seed)
        self.cfg = SimpleNamespace(resblock_kernel_sizes=KS)
        for j, k in enumerate(KS):
            self.add_module(f"res_0_{j}", ResBlock(C, k, DS))
        self.conv_post = torch.nn.Conv1d(C, 1, 7, padding=3)


@pytest.mark.parametrize("C,L,tile,head", [
    (16, 40, 64, True), (32, 90, 64, False), (16, 77, 32, False)])
def test_stage_emulation_matches_plain_bf16(C, L, tile, head):
    """The emulated bf16 kernel (fragments, clamps, regions rounded up to
    16 positions, NaN outside what the kernel writes) against the plain
    bf16 stage at the card's bf16 tolerance: short L, ragged tiles, with
    and without the head."""
    gen = _Gen(C, seed=C + L)
    packed = w, b, wf = mrf.pack_mrf_params(gen, 0, torch.bfloat16)
    post = mrf.pack_post_params(gen, torch.bfloat16) if head else None
    x = torch.from_numpy(
        np.random.RandomState(L).randn(2, C, L).astype(np.float32) * 0.3)
    halo = mrf.receptive_radius(KS, DS) + (3 if head else 0)
    with torch.no_grad():
        ref = mrf.fused_mrf_stage(x, packed, KS, DS, torch.bfloat16, post)
        out = emulate_stage_tc(x, w, b, wf, tile, halo, post)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0.1, atol=0.05)


# -- the packs and constants the kernel is handed ----------------------------

@pytest.mark.parametrize("C", [8, 16, 32])
def test_stage_pack_carries_both_layouts(C):
    """pack_mrf_params hands each entry point one pack: the bf16 pack holds
    the fragment order beside [tap][c_in][c_out]; float32, and a width the
    bf16 kernel does not take, hold none."""
    gen = _Gen(C, seed=C)
    w32, b32, wf32 = mrf.pack_mrf_params(gen, 0)
    assert wf32 is None and w32.dtype == torch.float32
    w, b, wf = mrf.pack_mrf_params(gen, 0, torch.bfloat16)
    assert torch.equal(w, w32.to(torch.bfloat16)) and torch.equal(b, b32)
    if C % 16:
        assert wf is None
    else:
        assert torch.equal(wf, mrf.pack_mrf_fragments(w, C, KS, len(DS)))


def test_work_split_constants_match_the_sources():
    """The warps a block and m16 tiles a pass that chip_smoke.py's issued
    work and this file's emulation use are the kernel's own constants."""
    def const(name, fname):
        with open(os.path.join(mrf._CSRC, fname)) as f:
            return int(re.search(rf"constexpr int {name} = (\d+);",
                                 f.read()).group(1))

    assert const("kThreads", "mrf.cuh") // 32 == mrf.WARPS
    assert const("kMT", "mrf_tc.cu") == mrf.PASS_TILES


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
    (csrc / "k_tc.cu").write_text("// second kernel\n")
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
    assert compiled == [str(csrc / "k.cu"), str(csrc / "k_tc.cu")]
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
