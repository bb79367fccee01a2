"""The port's audio front-end and long-form path: ``audio/stft.py`` against
``cmtts_tpu.audio.stft`` (filterbank, host STFT, mel front-end, Griffin-Lim
at 4 iterations), ``text/segment.py`` on the JAX suite's cases, and
``synthesize_long`` against the batched call it splices."""

import numpy as np
import pytest
import torch

from torch_port_helpers import both_configs, tokens

# float32: FFTs and the mel matmul summed in other orders by XLA and ATen
MEL_TOL = dict(rtol=1e-5, atol=1e-5)
GL_ATOL = 1e-4


def test_mel_filterbank_and_stft_magnitudes_exact():
    from cmtts_tpu.audio import stft as js
    from cmtts_tpu_torch.audio import stft as ts

    for args in ((22050, 1024, 80, 0.0, 8000.0), (22050, 551, 40, 0.0, None),
                 (16000, 512, 64, 50.0, 7600.0)):
        np.testing.assert_array_equal(ts.mel_filterbank(*args),
                                      js.mel_filterbank(*args))
    wav = np.random.RandomState(0).randn(3001).astype(np.float32) * 0.1
    for kw in (dict(n_fft=1024, win_length=551, hop_length=220),
               dict(n_fft=551, win_length=551, hop_length=220, center=False),
               dict(n_fft=4096, win_length=4096, hop_length=256)):
        np.testing.assert_array_equal(ts.stft_magnitudes(wav, **kw),
                                      js.stft_magnitudes(wav, **kw))


def test_mel_spectrogram():
    from cmtts_tpu.audio.stft import MelSpectrogram as J
    from cmtts_tpu_torch.audio.stft import MelSpectrogram as T

    rs = np.random.RandomState(1)
    tt = np.arange(22050) / 22050
    wav = (0.5 * np.sin(2 * np.pi * 220 * tt) + 0.05 * rs.randn(22050)
           ).astype(np.float32)
    for kw in ({}, dict(win_length=800, n_mel_channels=16)):
        mel_r, en_r = J(**kw)(wav)
        mel, en = T(**kw, device="cpu")(wav)
        assert mel.shape == mel_r.shape and en.shape == en_r.shape
        np.testing.assert_allclose(mel, mel_r, **MEL_TOL)
        np.testing.assert_allclose(en, en_r, rtol=1e-5, atol=1e-4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T()


def test_griffin_lim_4_iterations():
    from cmtts_tpu.audio.stft import GriffinLim as JG, MelSpectrogram as JM
    from cmtts_tpu_torch.audio.stft import GriffinLim as TG
    from cmtts_tpu_torch.audio.stft import MelSpectrogram as TM

    # a noise-like mel: every bin carries energy.  (A pure tone's mel
    # leaves bins whose re-analysed spectrum sits at rounding level; their
    # phase is rounding noise in either FFT library, and both packages then
    # stray from a float64 Griffin-Lim by a few 1e-3 within 4 iterations.)
    log_mel = (np.random.RandomState(2).randn(60, 80) - 3).astype(np.float32)
    ref = JG(JM(), n_iters=4)(log_mel)
    out = TG(TM(device="cpu"), n_iters=4)(log_mel)
    assert out.shape == ref.shape == (log_mel.shape[0] * 256,)
    np.testing.assert_allclose(out, ref, rtol=0, atol=GL_ATOL)


# -- text/segment.py: the cases of tests/test_segment.py -------------------
def test_sentences():
    from cmtts_tpu.text import segment as js
    from cmtts_tpu_torch.text.segment import sentences

    cases = {
        "Hello world. How are you? Fine!": [
            "Hello world.", "How are you?", "Fine!"],
        "Dr. Smith arrived. He sat down.": [
            "Dr. Smith arrived.", "He sat down."],
        "你好。很高兴认识你！": ["你好。", "很高兴认识你！"],
        "   ": [],
    }
    for text, want in cases.items():
        assert sentences(text) == want == js.sentences(text)


def test_pack_chunks_and_chunk_text():
    from cmtts_tpu_torch.text.segment import chunk_text, pack_chunks

    toks = [np.arange(3), np.arange(4), np.arange(5)]
    chunks = pack_chunks(toks, budget=8, sep_token=99)
    # 3 + sep + 4 = 8 fits; 5 starts a new chunk
    assert [list(c) for c in chunks] == [[0, 1, 2, 99, 0, 1, 2, 3],
                                         [0, 1, 2, 3, 4]]
    chunks = pack_chunks([np.arange(2), np.arange(2)], budget=4)
    assert len(chunks) == 1 and len(chunks[0]) == 4
    chunks = pack_chunks([np.arange(10)], budget=4)   # hard split
    assert [len(c) for c in chunks] == [4, 4, 2]
    assert list(np.concatenate(chunks)) == list(range(10))
    assert len(pack_chunks([np.asarray([], np.int32), np.arange(2)],
                           budget=4)) == 1

    def tok(s):
        return np.arange(len(s.split()), dtype=np.int32)

    chunks = chunk_text("One two three. Four five.", tok, budget=10,
                        sep_token=7)
    assert len(chunks) == 1 and 7 in chunks[0]


# -- synthesize_long --------------------------------------------------------
@pytest.fixture(scope="module")
def long_synth():
    """A tiny external-embedder (DeepSpeaker, 8 features) model with a
    width-32 HiFi-GAN, random weights from a seed, on the CPU."""
    from cmtts_tpu_torch.cli.synthesize import random_cmtts
    from cmtts_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
    from cmtts_tpu_torch.pipeline import Synthesizer

    _, cfg = both_configs(speaker_embedder="DeepSpeaker")
    torch.manual_seed(1)
    voc = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=32,
                                         num_mels=16))
    kw = dict(T=1, text_buckets=(8, 16), mel_buckets=(32, 64),
              compute_dtype=torch.float32, device="cpu")
    model = random_cmtts(cfg, seed=2)
    return Synthesizer(cfg, model, voc, **kw), Synthesizer(cfg, model, **kw)


def test_synthesize_long_splices_the_batched_call(long_synth):
    from cmtts_tpu_torch.pipeline import synthesize_long

    synth, mel_only = long_synth
    chunks = tokens(np.random.RandomState(8), [6, 8, 4])
    embed = np.random.RandomState(9).randn(8).astype(np.float32)
    gap_ms = 100.0
    wav, mels, lens = synthesize_long(synth, chunks, spker_embed=embed,
                                      gap_ms=gap_ms, seed=5)
    mel_b, lens_b, wav_b = synth(chunks, spker_embeds=np.tile(embed, (3, 1)),
                                 seed=5)
    np.testing.assert_array_equal(lens, lens_b)
    assert lens.min() > 0 and len(mels) == 3
    gap = np.zeros(int(22050 * gap_ms / 1000.0), np.float32)
    pieces = synth.trim_wavs(wav_b, lens_b)
    np.testing.assert_array_equal(
        wav, np.concatenate([pieces[0], gap, pieces[1], gap, pieces[2]]))
    for m, mb, n in zip(mels, mel_b, lens_b):
        np.testing.assert_array_equal(m, mb[: int(n)])

    wav4, mels4, lens4 = synthesize_long(synth, chunks, spker_embed=embed,
                                         gap_ms=gap_ms, pad_pow2=True)
    assert len(mels4) == len(lens4) == 3
    assert len(wav4) == int(lens4.sum()) * 256 + 2 * len(gap)

    wav_n, mels_n, _ = synthesize_long(mel_only, chunks[:2], spker_embed=embed)
    assert wav_n is None and len(mels_n) == 2
    with pytest.raises(ValueError, match="no token chunks"):
        synthesize_long(synth, [], spker_embed=embed)
    with pytest.raises(ValueError, match="spker_embeds required"):
        synthesize_long(synth, chunks)
