"""The frozen operation counts against hand counts and against the
reference modules' own layers, and the traffic generator's determinism
and length distribution."""

from __future__ import annotations

import json
import os
from statistics import NormalDist

import numpy as np
import pytest
import torch
from torch import nn

from perfbench import flops
from perfbench.reference.config import read_config
from perfbench.reference.synth import modules
from perfbench.tests import tinybench
from perfbench.traffic import make_calls, make_voices, truncnorm_quantiles

V1 = {"upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
      "upsample_initial_channel": 512, "resblock_kernel_sizes": [3, 7, 11],
      "resblock_dilation_sizes": [[1, 3, 5]] * 3, "num_mels": 80,
      "sampling_rate": 22050}


def test_mrf_stages_b8_mel1024():
    """The four B=8, mel-1024 stages: 4.87e12 FLOP and a 4.93 ms bound
    (PERF.md §6, 4.926 ms)."""
    stages = flops.vocoder_stages(V1, 1024)
    assert [(c, l) for c, l, _ in stages] == [(256, 8192), (128, 65536),
                                              (64, 131072), (32, 262144)]
    total = sum(flops.mrf_stage_flop(8, c, l, h) for c, l, h in stages)
    assert total == 252 * 8 * (256 ** 2 * 8192 + 128 ** 2 * 65536
                               + 64 ** 2 * 131072 + 32 ** 2 * 262144) \
        + 14 * 32 * 262144 * 8
    assert total == pytest.approx(4.87e12, rel=1e-3)
    assert flops.mrf_bound_s(V1, 8, 1024) * 1e3 == pytest.approx(4.926,
                                                                 abs=0.002)


def _hook_flop(module, *inputs, call=None):
    """2 x multiply-adds of every Linear, Conv and transposed conv that a
    forward runs, counted from the tensors that reach them."""
    total = 0

    def hook(m, inp, out):
        nonlocal total
        x = inp[0]
        if isinstance(m, nn.Linear):
            total += 2 * x.numel() // x.shape[-1] * m.weight.numel()
        elif isinstance(m, nn.ConvTranspose1d):
            total += 2 * x.numel() // x.shape[1] * m.weight.numel()
        elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
            total += 2 * out.numel() // out.shape[1] * m.weight.numel()

    hs = [m.register_forward_hook(hook) for m in module.modules()]
    with torch.no_grad():
        (call or module)(*inputs)
    for h in hs:
        h.remove()
    return total


@pytest.fixture(scope="module")
def tiny():
    with open(os.path.join(tinybench.BENCH, "configs",
                           "vctk_zeroshot.json")) as f:
        cfg = tinybench.tiny_config(json.load(f))
    c = read_config(cfg)
    return cfg, c, modules(c, cfg["vocoder"], "cpu")


def test_counts_match_the_modules(tiny):
    cfg, c, (model, voc, emb) = tiny
    B, T, L = 2, 13, 40
    cond = torch.zeros(B, L, c.hidden)
    spk = torch.zeros(B, c.hidden)
    got = _hook_flop(model.denoiser, torch.zeros(B, L, c.n_mels),
                     torch.zeros(B), cond, spk)
    assert got == flops.denoiser_flop(c, B, L)
    assert _hook_flop(voc, torch.zeros(B, L, c.n_mels)) == \
        flops.vocoder_flop(cfg["vocoder"], B, L)
    assert _hook_flop(emb, torch.zeros(B, 160, 64)) == flops.rescnn_flop(B)
    # the conditioning's layers, and its attention's two matmuls by hand
    got = _hook_flop(model, torch.full((B, T), 70), torch.full((B,), T), L,
                     torch.zeros(B, c.external_speaker_dim),
                     call=model.condition)
    attn = c.layers * 4 * T * T * c.hidden * B
    assert got + attn == flops.condition_flop(c, B, T, L)


LJ = {"batch": 8, "block": 16, "pool": 64, "token_ids": [64, 148],
      "phonemes": {"mean": 95, "sd": 32, "min": 16, "max": 145}}


def test_calls_deterministic_per_seed():
    a, b = make_calls(LJ, 2 ** 31 + 5), make_calls(LJ, 2 ** 31 + 5)
    assert all(x.noise_seed == y.noise_seed and all(
        np.array_equal(p, q) for p, q in zip(x.tokens, y.tokens))
        for x, y in zip(a, b))
    c = make_calls(LJ, 2 ** 31 + 6)
    assert any(not np.array_equal(x.tokens[0], y.tokens[0])
               for x, y in zip(a, c))


def test_every_block_the_same_lengths():
    """Each block of each seed holds the same multiset of lengths."""
    want = np.sort(truncnorm_quantiles(16 * 8, 95, 32, 16, 145))
    for seed in (1, 2 ** 31 + 9):
        calls = make_calls(LJ, seed)
        for b in range(0, len(calls), 16):
            got = np.sort([len(t) for c in calls[b:b + 16] for t in c.tokens])
            assert np.array_equal(got, want)
            assert all(64 <= t.min() and t.max() < 148
                       for c in calls[b:b + 16] for t in c.tokens)


def test_lengths_follow_the_stated_distribution():
    q = truncnorm_quantiles(4096, 95, 32, 16, 145)
    assert q.min() >= 16 and q.max() <= 145
    # moments of N(95, 32) truncated to [15.5, 145.5]
    nd = NormalDist(95, 32)
    a, b = (15.5 - 95) / 32, (145.5 - 95) / 32
    z = NormalDist()
    Z = z.cdf(b) - z.cdf(a)
    mean = 95 + 32 * (z.pdf(a) - z.pdf(b)) / Z
    var = 32 ** 2 * (1 + (a * z.pdf(a) - b * z.pdf(b)) / Z
                     - ((z.pdf(a) - z.pdf(b)) / Z) ** 2)
    assert q.mean() == pytest.approx(mean, rel=0.005)
    assert q.std() == pytest.approx(var ** 0.5, rel=0.01)
    assert nd.mean == 95


def test_voices():
    mix = {"batch": 1, "block": 8, "pool": 16, "token_ids": [64, 148],
           "phonemes": {"mean": 43, "sd": 14, "min": 20, "max": 90},
           "voices": 8, "reference_seconds": 0.5}
    calls = make_calls(mix, 3)
    for b in range(0, 16, 8):
        assert sorted(c.voices[0] for c in calls[b:b + 8]) == list(range(8))
    v1, v2 = make_voices(mix, 3, 22050), make_voices(mix, 3, 22050)
    assert v1.shape == (8, 11025) and np.array_equal(v1, v2)
    assert np.abs(v1).max() == pytest.approx(0.5, rel=1e-5)


def test_batch_order_is_the_feeds(tmp_path):
    """The warm-up's batch shapes come from ``corpus.batch_order``, which
    has to pick the rows the program's feed picks; the reference's feed
    (``reference/train.py::Feed``) has to give the program's batches."""
    from cmtts_tpu_torch.core.config import config_from_dicts
    from cmtts_tpu_torch.data.dataset import FeatureDataset, batch_iterator
    from perfbench import corpus
    from perfbench.reference.train import Feed

    with open(os.path.join(tinybench.BENCH, "traffic",
                           "lj_ct_corpus.json")) as f:
        mix = dict(json.load(f), utterances=48)
    with open(os.path.join(tinybench.BENCH, "configs",
                           "ljspeech.json")) as f:
        config = json.load(f)
    root = str(tmp_path / "corpus")
    meta = corpus.write(root, mix, 2 ** 31 + 21)
    assert os.path.exists(os.path.join(root, corpus.DONE))
    again = corpus.write(root, mix, 2 ** 31 + 21, write=False)
    assert all(a["basename"] == b["basename"] and a["frames"] == b["frames"]
               and np.array_equal(a["phonemes"], b["phonemes"])
               for a, b in zip(meta, again))
    pre = dict(config["preprocess"], path={"preprocessed_path": root})
    config["train"]["optimizer"]["batch_size"] = 4
    cfg = config_from_dicts(pre, config["model"], config["train"], {})
    feed = batch_iterator(FeatureDataset("train.txt", cfg), 4, 4, seed=77)
    want = [next(feed) for _ in range(7)]
    got = corpus.batch_order(meta, 4, 4, 77, 7)
    ref = Feed(root, meta, config, 77, 7)
    for i, (rows, batch) in enumerate(zip(got, want)):
        assert [meta[j]["basename"] for j in rows] == batch["ids"]
        assert batch["mels"].shape[1] >= max(meta[j]["frames"] for j in rows)
        assert [len(meta[j]["phonemes"]) for j in rows] == \
            batch["src_lens"].tolist()
        b = ref.batch(i)
        assert b["rows"] == batch["ids"]
        for k, a in b["arrays"].items():
            top, _, sub = k.partition(".")
            p = batch[top][sub] if sub else batch[top]
            assert p.shape == a.shape and np.array_equal(p, a), k
