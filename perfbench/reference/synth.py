"""Plain reference of one T=1 synthesis call: bucketing, conditioning, one
consistency step at sigma_max with the boundary scalings, and the
vocoder, in float32; and the speaker embedding of a reference clip.

The semantics are CM-TTS's (``pipeline.py::Synthesizer``): tokens padded
to the smallest text bucket that holds the longest, the mel bucket the
smallest that holds 10 frames a phoneme (at most ``max_seq_len``), x_T
drawn as N(0, 1) * sigma_max from a ``torch.Generator`` on the device
seeded with the call's noise seed, the denoiser fed c_in x_T and
250 ln(sigma), and mel = c_out D + c_skip x_T.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from perfbench.reference.acoustic import AcousticModel
from perfbench.reference.speaker import ResCNN, fbank_slice
from perfbench.reference.vocoder import Generator


def pick_bucket(n: int, buckets) -> int:
    i = bisect.bisect_left(buckets, n)
    return buckets[min(i, len(buckets) - 1)]


def modules(c, vocoder_cfg: dict, device: str = "meta"):
    """(acoustic model, vocoder, speaker embedder or None) on ``device``."""
    with torch.device(device):
        model = AcousticModel(c)
        voc = Generator(vocoder_cfg)
        emb = ResCNN() if c.speaker_embedder == "DeepSpeaker" else None
    return model, voc, emb


def boundary_scalings(sigma, c):
    sd2 = c.sigma_data ** 2
    if not c.distillation:
        return (sd2 / (sigma ** 2 + sd2),
                sigma * c.sigma_data / torch.sqrt(sigma ** 2 + sd2),
                1.0 / torch.sqrt(sigma ** 2 + sd2))
    return (sd2 / ((sigma - c.sigma_min) ** 2 + sd2),
            (sigma - c.sigma_min) * c.sigma_data / torch.sqrt(sigma ** 2 + sd2),
            1.0 / torch.sqrt(sigma ** 2 + sd2))


@torch.no_grad()
def embed(embedder, wav: np.ndarray, sr: int, device) -> torch.Tensor:
    x = torch.as_tensor(fbank_slice(wav, sr)[None], device=device)
    return embedder(x)[0]


@torch.no_grad()
def synthesize(model, vocoder, c, tokens, spker_embeds, noise_seed: int,
               buckets: dict, device, mel=None):
    """-> (mel (B, t_mel, n_mels), mel_lens (B,), wav (B, t_mel * hop)).
    Given ``mel``, only vocodes it."""
    if mel is not None:
        return mel, None, vocoder(mel)
    B = len(tokens)
    max_txt = max(len(t) for t in tokens)
    t_txt = pick_bucket(max_txt, buckets["text"])
    t_mel = pick_bucket(min(max_txt * 10, c.max_seq_len), buckets["mel"])
    texts = np.zeros((B, t_txt), np.int64)
    for i, t in enumerate(tokens):
        texts[i, :len(t)] = t
    texts = torch.as_tensor(texts, device=device)
    src_lens = torch.as_tensor([len(t) for t in tokens], device=device)
    cond, spk, mel_lens = model.condition(texts, src_lens, t_mel,
                                          spker_embeds)
    gen = torch.Generator(device=device).manual_seed(noise_seed)
    x_T = torch.randn((B, t_mel, c.n_mels), generator=gen,
                      dtype=torch.float32, device=device) * c.sigma_max
    sigma = torch.full((B,), c.sigma_max, device=device)
    c_skip, c_out, c_in = boundary_scalings(sigma, c)
    out = model.denoiser(c_in[:, None, None] * x_T,
                         1000.0 * 0.25 * torch.log(sigma + 1e-44), cond, spk)
    mel = c_out[:, None, None] * out + c_skip[:, None, None] * x_T
    return mel, mel_lens, vocoder(mel)
