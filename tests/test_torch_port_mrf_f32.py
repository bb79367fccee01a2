"""The float32 MRF route (cmtts_tpu_torch/csrc/mrf.cu) on the CPU: an
emulation of its work split in plain torch -- one implicit-GEMM launch a
conv, blocks of BM positions x BN output channels, each thread's register
tile of positions tx + MT j and channels ty TN + i, K-chunks of all taps x
F32_CHUNK input channels passing through the ring's slots in order, the
zero-filled window, lrelu applied to conv1's window, the fused epilogues
and the ResBlock sum, and the head kernel's staged channel chunks --
held to ``mrf_stage_plain`` in float32.  Every buffer starts as NaN where
the kernel has not written it yet (the device buffers, the ring slots and
their padding), so a read of anything the kernel does not write shows in
the result.  The kernel itself runs only on the card (chip_smoke.py)."""

import os
import re

import numpy as np
import pytest
import torch

from cmtts_tpu_torch.ops import mrf

KS, DS = (3, 7, 11), (1, 3, 5)
THREADS = mrf.WARPS * 32
TM, TN, CHUNK, STAGES = (mrf.F32_TM, mrf.F32_TN, mrf.F32_CHUNK,
                         mrf.F32_STAGES)
NAN = float("nan")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's pool slows these many small ops under the suite's
    workers: one thread while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lrelu(v, s=0.1):
    return torch.maximum(v, v * s)


def thread_map(C):
    """(BM, BN, MT, positions (256, TM), channels (256, TN)): the block of
    the kernel for C channels and each thread's register tile: thread tid
    = ty MT + tx holds positions tx + MT j and channels ty TN + i."""
    bm, bn = mrf.conv_block(C)
    mt = THREADS // (bn // TN)
    tid = torch.arange(THREADS)
    tx, ty = tid % mt, tid // mt
    pos = tx[:, None] + mt * torch.arange(TM)[None]
    ch = ty[:, None] * TN + torch.arange(TN)[None]
    return bm, bn, mt, pos, ch


def emulate_conv(src, w, bias, k, d, mode, dst, yin=None, to_sum=False,
                 first=False, last=False, nblk=1):
    """``mrf_conv_f32_kernel`` over every block: src (B, C, L) the conv's
    input, w its [k][C][C] weights; writes ``dst`` in place as the
    epilogue does (mode 0: lrelu(conv + b); mode 1: yin + conv + b, or
    into the ResBlock sum)."""
    B, C, L = src.shape
    bm, bn, mt, pos, ch = thread_map(C)
    half = (k - 1) // 2
    span = bm + (k - 1) * d
    wa = mrf.window_stride(bm, k, d)
    n_m = -(-L // bm)
    p0 = torch.arange(n_m) * bm
    g = p0[:, None] - half * d + torch.arange(span)          # (n_m, span)
    valid = (g >= 0) & (g < L)
    gi = g.clamp(0, L - 1)
    for b in range(B):
        for co0 in range(0, C, bn):
            def load(c):
                """a ring slot as cp.async fills it with chunk c: the
                window rows (zero outside [0, L), NaN in the padding past
                the span) and the weights [k][CHUNK][BN]"""
                ci = slice(c * CHUNK, (c + 1) * CHUNK)
                A = torch.full((n_m, CHUNK, wa), NAN)
                rows = src[b, ci][:, gi].transpose(0, 1)     # (n_m, CHUNK, span)
                A[..., :span] = torch.where(valid[:, None], rows,
                                            torch.zeros(()))
                return A, w[:, ci, co0:co0 + bn]
            acc = torch.zeros(n_m, THREADS, TM, TN)
            slots = [None] * STAGES
            slots[0] = load(0)
            for c in range(C // CHUNK):
                if c + 1 < C // CHUNK:
                    slots[(c + 1) % STAGES] = load(c + 1)
                A, Wt = slots[c % STAGES]
                if mode == 0:                  # conv1 reads lrelu(y)
                    A = A.clone()
                    A[..., :span] = lrelu(A[..., :span])
                for t in range(k):
                    a = A[:, :, pos + t * d]       # (n_m, CHUNK, 256, TM)
                    wv = Wt[t][:, ch]              # (CHUNK, 256, TN)
                    acc += torch.einsum("mrsj,rsi->msji", a, wv)
                slots[c % STAGES] = None           # freed for chunk c + 2
            assert torch.isfinite(acc).all()
            # epilogue: rows past L are computed and not stored
            p = p0[:, None, None] + pos[None]                 # (n_m, 256, TM)
            co = co0 + ch                                     # (256, TN)
            keep = (p < L)[..., None].expand(-1, -1, -1, TN)
            pp = p[..., None].expand(-1, -1, -1, TN)[keep]
            cc = co[None, :, None, :].expand(n_m, -1, TM, -1)[keep]
            v = (acc + bias[co][None, :, None, :])[keep]
            if mode == 0:
                dst[b, cc, pp] = lrelu(v)
            else:
                y = yin[b, cc, pp] + v
                if to_sum:
                    s = y if first else dst[b, cc, pp] + y
                    y = s / nblk if last else s
                dst[b, cc, pp] = y


def emulate_head(s, w_post, b_post):
    """``mrf_head_f32_kernel``: blocks of F32_HEAD_T positions, channels
    staged F32_HEAD_C at a time through lrelu(0.01), zero outside [0, L)."""
    B, C, L = s.shape
    post_k = w_post.shape[0]
    half = (post_k - 1) // 2
    T = mrf.F32_HEAD_T
    span = T + post_k - 1
    wav = torch.full((B, L), NAN)
    for b in range(B):
        for p0 in range(0, L, T):
            g = p0 - half + torch.arange(span)
            ok = (g >= 0) & (g < L)
            acc = torch.zeros(T)
            for c0 in range(0, C, mrf.F32_HEAD_C):
                nc = min(mrf.F32_HEAD_C, C - c0)
                hs = torch.where(ok, lrelu(s[b, c0:c0 + nc][:, g.clamp(0, L - 1)],
                                           0.01), torch.zeros(()))
                for t in range(post_k):
                    acc += w_post[t, c0:c0 + nc] @ hs[:, t:t + T]
            n = min(T, L - p0)
            wav[b, p0:p0 + n] = torch.tanh(acc[:n] + b_post[0])
    return wav


def emulate_stage(x, w, b, kernel_sizes=KS, dilations=DS, post=None):
    """``mrf_stage_f32``'s launches in order, with its device buffers
    (h, y, the ResBlock sum, the output) NaN until written."""
    B, C, L = x.shape
    h = torch.full_like(x, NAN)
    y = torch.full_like(x, NAN)
    out = torch.full_like(x, NAN)              # the sum, or the output
    woff = boff = 0
    nblk, npair = len(kernel_sizes), len(dilations)
    for j, k in enumerate(kernel_sizes):
        kcc = k * C * C
        for p, d in enumerate(dilations):
            emulate_conv(x if p == 0 else y, w[woff:woff + kcc].view(k, C, C),
                         b[boff:boff + C], k, d, 0, h)
            last_pair = p == npair - 1
            emulate_conv(h, w[woff + kcc:woff + 2 * kcc].view(k, C, C),
                         b[boff + C:boff + 2 * C], k, 1, 1,
                         out if last_pair else y, yin=x if p == 0 else y,
                         to_sum=last_pair, first=j == 0, last=j == nblk - 1,
                         nblk=nblk)
            woff += 2 * kcc
            boff += 2 * C
    return out if post is None else emulate_head(out, *post)


def stage_params(C, seed, kernel_sizes=KS, n_pairs=len(DS)):
    """Packed stage weights [conv][tap][c_in][c_out], biases and a head,
    from a numpy seed."""
    rng = np.random.RandomState(seed)
    ws = [(rng.randn(k * C * C) / np.sqrt(k * C)).astype(np.float32)
          for k in kernel_sizes for _ in range(2 * n_pairs)]
    b = rng.randn(2 * n_pairs * len(kernel_sizes) * C).astype(np.float32)
    wp = rng.randn(7, C).astype(np.float32) * 0.1
    return (torch.from_numpy(np.concatenate(ws)),
            torch.from_numpy(b * 0.1),
            (torch.from_numpy(wp), torch.full((1,), 0.05)))


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("L", [40, 50, 300, 1237])
@pytest.mark.parametrize("C", [32, 128, 256])
def test_stage_emulation_matches_plain_f32(C, L, head):
    """The emulated float32 route against the plain stage: L below the
    receptive radius, ragged last blocks, one and several blocks, C = 256
    in two channel blocks, with and without the head."""
    w, b, post = stage_params(C, seed=C + L)
    post = post if head else None
    x = torch.from_numpy(
        np.random.RandomState(L).randn(1, C, L).astype(np.float32) * 0.3)
    with torch.no_grad():
        ref = mrf.mrf_stage_plain(x, w, b, KS, DS, torch.float32, post)
        out = emulate_stage(x, w, b, post=post)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("C", [8, 16, 24])
def test_narrow_and_odd_widths(C):
    """C = 8 and 16 (a V2 generator's last stages) and C = 24, whose block
    is 8 channels wide; one ResBlock of two pairs, B = 2."""
    ks, ds = (5,), (1, 2)
    w, b, post = stage_params(C, seed=C, kernel_sizes=ks, n_pairs=len(ds))
    x = torch.from_numpy(
        np.random.RandomState(C).randn(2, C, 333).astype(np.float32) * 0.3)
    with torch.no_grad():
        ref = mrf.mrf_stage_plain(x, w, b, ks, ds, torch.float32, post)
        out = emulate_stage(x, w, b, ks, ds, post)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("C", [8, 16, 32, 64, 128, 256, 24, 200])
def test_thread_map_covers_each_output_once(C):
    """Each block's threads cover its BM x BN outputs once, the warps'
    lanes on consecutive positions (conflict-free window loads); the
    window holds every position a tap reaches; the weight slot after the
    window rows stays 16-byte aligned."""
    bm, bn, mt, pos, ch = thread_map(C)
    assert C % bn == 0 and bn <= mrf.F32_MAX_BN
    cells = (pos[:, :, None] * bn + ch[:, None, :]).reshape(-1)
    assert torch.equal(cells.sort().values, torch.arange(bm * bn))
    lanes = pos[:, 0].view(-1, 32)
    assert torch.equal(lanes - lanes[:, :1],
                       (torch.arange(32) % min(32, mt)).expand_as(lanes))
    for k, d in ((3, 1), (11, 5), (7, 3)):
        wa = mrf.window_stride(bm, k, d)
        assert wa % 4 == 0 and int(pos.max()) + (k - 1) * d < wa
        assert mrf.conv_smem_bytes(C, k, d) == 4 * STAGES * CHUNK * (
            wa + k * bn)


def test_f32_conv_blocks_fit_shared_memory():
    """Float32 plans no length tile: every width runs one launch a conv,
    whose block (BM positions x BN channels, two ring slots of a K-chunk)
    fits twice in an SM's shared memory from BN = 32 on."""
    assert [mrf.conv_block(C) for C in (256, 128, 64, 32, 16, 8)] == [
        (128, 128), (128, 128), (256, 64), (512, 32), (1024, 16), (2048, 8)]
    for C in (256, 128, 64, 32):
        worst = mrf.conv_smem_bytes(C, 11, 5)
        assert worst == 4 * 2 * 8 * (mrf.conv_block(C)[0] + 52 + 11
                                     * mrf.conv_block(C)[1])
        assert 2 * (worst + 1024) <= 233472      # the SM's shared memory


def test_kernel_takes_float32_shapes():
    """Float32 takes C a multiple of 8 with a head of up to 17 taps, and
    refuses a conv whose block does not fit in shared memory."""
    assert mrf.kernel_takes(8, torch.float32, post_k=7)
    assert not mrf.kernel_takes(12, torch.float32)
    assert not mrf.kernel_takes(32, torch.float32, post_k=19)
    assert mrf.kernel_takes(256, torch.float32)
    assert mrf.kernel_takes(256, torch.float32, (3,), (1000,))
    assert not mrf.kernel_takes(256, torch.float32, (3,), (2000,))


def test_work_split_constants_match_the_source():
    """The register tile, K-chunk, ring depth, widest block and the head's
    split that this file's emulation and ops/mrf.py use are mrf.cu's."""
    with open(os.path.join(mrf._CSRC, "mrf.cu")) as f:
        src = f.read()
    with open(os.path.join(mrf._CSRC, "mrf.cuh")) as f:
        header = f.read()

    def const(name, text=src):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             text).group(1))

    assert const("kThreads", header) == THREADS
    assert (const("kTM"), const("kTN"), const("kBK"), const("kStages"),
            const("kMaxBN")) == (mrf.F32_TM, mrf.F32_TN, mrf.F32_CHUNK,
                                 mrf.F32_STAGES, mrf.F32_MAX_BN)
    assert (const("kHeadT"), const("kHeadC"), const("kMaxPostK")) == (
        mrf.F32_HEAD_T, mrf.F32_HEAD_C, mrf.F32_MAX_POST_K)
    # the kernel dispatches each power-of-two block width up to kMaxBN
    cases = sorted(int(n) for n in re.findall(
        r"case (\d+): return launch_conv<", src))
    assert cases == [8, 16, 32, 64, 128]
