"""Text -> mel -> waveform inference pipeline (port of
``cmtts_tpu/pipeline.py``).

The conditioning network runs once, the consistency sampler drives only the
bare denoiser (a bf16 copy of it by default, as the JAX pipeline casts the
denoiser to bf16), and HiFi-GAN vocodes the padded mel through the port's
MRF kernels.  Token batches are padded to the same text and mel buckets as
the JAX pipeline: the padded inverse-CWT standardisation depends on them.
Sampler math and outputs stay float32; public layouts are JAX's: mel
(B, L, n_mels), wav (B, L * hop).  ``synthesize_long`` runs the chunks of a
long text as one batch and splices their waveforms.
"""

from __future__ import annotations

import copy
import warnings
from typing import Sequence

import numpy as np
import torch

from cmtts_tpu_torch.cm.karras import schedule_from_config
from cmtts_tpu_torch.cm.sampling import default_ts, sample_mel
from cmtts_tpu_torch.core.config import Config
from cmtts_tpu_torch.core.device import resolve_device
from cmtts_tpu_torch.core.masks import (
    DEFAULT_MEL_BUCKETS,
    DEFAULT_TEXT_BUCKETS,
    pad_to,
    pick_bucket,
)
from cmtts_tpu_torch.models.cmtts import CMTTS
from cmtts_tpu_torch.models.hifigan import (
    HiFiGANGenerator,
    hifigan_apply_fused,
    pack_generator,
)


def warn_if_bucket_saturated(mel_lens: np.ndarray, mel_bucket: int) -> bool:
    """Predicted durations are clamped to the mel bucket, which silently
    clips audio in batch synthesis; say so.  Returns True when saturated."""
    sat = np.asarray(mel_lens) >= mel_bucket
    if sat.any():
        warnings.warn(
            f"{int(sat.sum())}/{sat.size} utterances saturated the mel "
            f"bucket ({mel_bucket} frames) — audio may be truncated; "
            "pass a larger mel_bucket= or raise model.max_seq_len")
        return True
    return False


class Synthesizer:
    """Bucketed synthesis on one device: call with host token sequences.

    ``device`` defaults to ``cuda`` and raises when CUDA is absent; tests
    pass ``device="cpu"``.  ``model`` and ``vocoder`` are moved to the
    device; the denoiser runs as a ``compute_dtype`` copy, and the vocoder's
    MRF stages compute in ``compute_dtype`` with float32 accumulation.
    """

    def __init__(self, cfg: Config, model: CMTTS,
                 vocoder: HiFiGANGenerator | None = None, T: int = 1,
                 sampler: str | None = None, sample_steps: int = 2,
                 text_buckets: Sequence[int] = DEFAULT_TEXT_BUCKETS,
                 mel_buckets: Sequence[int] = DEFAULT_MEL_BUCKETS,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        self.denoiser = self.model.denoiser
        if compute_dtype != torch.float32:
            self.denoiser = copy.deepcopy(self.denoiser).to(compute_dtype)
        self.vocoder = None if vocoder is None else vocoder.to(self.device).eval()
        self.vocoder_packed = (None if vocoder is None
                               else pack_generator(self.vocoder, compute_dtype))
        self.T = T
        self.sampler = sampler or ("onestep" if T == 1 else "multistep")
        self.sample_steps = sample_steps
        self.sched = schedule_from_config(cfg)
        self.text_buckets = tuple(text_buckets)
        self.mel_buckets = tuple(mel_buckets)
        self.compute_dtype = compute_dtype

    @torch.no_grad()
    def synthesize(self, texts: torch.Tensor, src_lens: torch.Tensor,
                   t_mel: int, speakers: torch.Tensor | None = None,
                   spker_embeds: torch.Tensor | None = None,
                   d_control: float = 1.0, p_control: float = 1.0,
                   e_control: float = 1.0, x_T: torch.Tensor | None = None,
                   noise: Sequence[torch.Tensor] | None = None,
                   generator: torch.Generator | None = None):
        """Device-side core: padded ids (B, T_txt), lengths and the
        speakers (ids (B,) or embeddings (B, D), for a multi-speaker model)
        on the device -> (mel (B, t_mel, n_mels), mel_lens (B,),
        wav (B, t_mel * hop) or None), all tensors on the device."""
        sched = self.sched
        cdt = self.compute_dtype
        cond_out = self.model.condition(texts, src_lens, t_mel,
                                        speakers=speakers,
                                        spker_embeds=spker_embeds,
                                        p_control=p_control,
                                        e_control=e_control,
                                        d_control=d_control)
        cond, spk = cond_out["cond"], cond_out["speaker_emb"]

        def denoise(x_t, sigma):
            c_skip, c_out, c_in = sched.active_scalings(sigma)
            out = self.denoiser((c_in[:, None, None] * x_t).to(cdt),
                                sched.rescale_t(sigma), cond, spk).float()
            return c_out[:, None, None] * out + c_skip[:, None, None] * x_t

        shape = (texts.shape[0], t_mel, self.cfg.stft.n_mel_channels)
        mel = sample_mel(
            denoise, shape, sched, self.sampler, T=self.T,
            steps=self.sample_steps,
            ts=default_ts(self.T) if self.sampler == "multistep" else None,
            x_T=x_T, noise=noise, generator=generator, device=self.device)
        wav = None
        if self.vocoder is not None:
            wav = hifigan_apply_fused(self.vocoder, mel, self.vocoder_packed,
                                      cdt)
        return mel, cond_out["mel_lens"], wav

    def __call__(self, token_seqs: Sequence[np.ndarray],
                 speakers: np.ndarray | None = None,
                 spker_embeds: np.ndarray | None = None, seed: int = 42,
                 d_control: float = 1.0, p_control: float = 1.0,
                 e_control: float = 1.0, mel_bucket: int | None = None,
                 x_T: torch.Tensor | None = None,
                 noise: Sequence[torch.Tensor] | None = None):
        """Returns (mel (B, L, n_mels) np, mel_lens np, wav np or None).

        Sequences are padded to a text bucket; the mel bucket is given or
        estimated as 10 frames per phoneme, clamped to max_seq_len.
        ``speakers`` (ids) defaults to 0; ``spker_embeds`` (B, D) is
        required by a model with an external speaker embedder and
        defaults to zeros otherwise.  The noise is drawn from a generator
        seeded with ``seed`` unless ``x_T`` (scaled by sigma_max) and the
        sampler's later draws, ``noise``, are given.
        """
        B = len(token_seqs)
        max_txt = max(len(t) for t in token_seqs)
        t_txt = pick_bucket(max_txt, self.text_buckets)
        texts = np.stack([pad_to(np.asarray(t, np.int64), t_txt)
                          for t in token_seqs])
        src_lens = np.asarray([len(t) for t in token_seqs], np.int64)
        if mel_bucket is None:
            est = min(int(max_txt * 10), self.cfg.model.max_seq_len)
            mel_bucket = pick_bucket(est, self.mel_buckets)
        mc = self.cfg.model
        if speakers is None:
            speakers = np.zeros(B, np.int64)
        if spker_embeds is None:
            if mc.multi_speaker and mc.speaker_embedder != "none":
                raise ValueError(
                    "spker_embeds required for external-embedder models")
            spker_embeds = np.zeros((B, mc.external_speaker_dim), np.float32)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        if x_T is not None:
            x_T = x_T.to(self.device, torch.float32)
        mel, mel_lens, wav = self.synthesize(
            torch.from_numpy(texts).to(self.device),
            torch.from_numpy(src_lens).to(self.device), mel_bucket,
            speakers=torch.as_tensor(np.asarray(speakers, np.int64),
                                     device=self.device),
            spker_embeds=torch.as_tensor(
                np.asarray(spker_embeds, np.float32), device=self.device),
            d_control=d_control, p_control=p_control, e_control=e_control,
            x_T=x_T, noise=noise, generator=generator)
        mel_lens = mel_lens.cpu().numpy()
        warn_if_bucket_saturated(mel_lens, mel_bucket)
        return (mel.cpu().numpy(), mel_lens,
                None if wav is None else wav.cpu().numpy())

    def trim_wavs(self, wav: np.ndarray, mel_lens: np.ndarray):
        """Per-sample waveform trim to mel_len * hop."""
        hop = self.cfg.stft.hop_length
        return [w[: int(n) * hop] for w, n in zip(wav, mel_lens)]


def synthesize_long(synth: Synthesizer, token_chunks, speaker: int = 0,
                    spker_embed: np.ndarray | None = None,
                    gap_ms: float = 150.0, seed: int = 42,
                    d_control: float = 1.0, p_control: float = 1.0,
                    e_control: float = 1.0, pad_pow2: bool = False):
    """Long-form synthesis: run all pre-packed chunks (see
    ``cmtts_tpu_torch.text.segment.chunk_text``) as ONE batched call, then
    splice the trimmed per-chunk waveforms with ``gap_ms`` of silence.

    ``pad_pow2`` pads the batch to the next power of two by repeating the
    last chunk (padding rows are discarded), so that a server sees a
    bounded set of batch shapes.

    Returns ``(wav, mels, mel_lens)``: the spliced waveform (or None for a
    mel-only synthesizer) and the per-chunk trimmed mels.
    """
    if not token_chunks:
        raise ValueError("no token chunks to synthesize")
    B = len(token_chunks)
    token_chunks = list(token_chunks)
    if pad_pow2:
        token_chunks += [token_chunks[-1]] * ((1 << (B - 1).bit_length()) - B)
    n = len(token_chunks)
    embeds = (None if spker_embed is None
              else np.tile(np.asarray(spker_embed, np.float32)[None], (n, 1)))
    mel, mel_lens, wav = synth(
        token_chunks, speakers=np.full(n, speaker, np.int64),
        spker_embeds=embeds, seed=seed, d_control=d_control,
        p_control=p_control, e_control=e_control)
    mel_lens = mel_lens[:B]
    mels = [mel[i, : int(mel_lens[i])] for i in range(B)]
    if wav is None:
        return None, mels, mel_lens
    gap = np.zeros(int(synth.cfg.stft.sampling_rate * gap_ms / 1000.0),
                   np.float32)
    pieces = []
    for i, p in enumerate(synth.trim_wavs(wav, mel_lens)):
        pieces += [np.asarray(p, np.float32)] + ([gap] if i < B - 1 else [])
    return np.concatenate(pieces), mels, mel_lens
