"""Text -> mel -> waveform inference pipeline (port of
``cmtts_tpu/pipeline.py``).

The conditioning network runs once, the consistency sampler drives only the
bare denoiser (a bf16 copy of it by default, as the JAX pipeline casts the
denoiser to bf16), and HiFi-GAN vocodes the padded mel through the port's
MRF kernels (a ``MelGANGenerator`` takes ``mel / ln 10`` in float32
instead, as the JAX pipeline feeds MelGAN).  Token batches are padded to
the same text and mel buckets as the JAX pipeline: the padded inverse-CWT
standardisation depends on them.
Sampler math and outputs stay float32; public layouts are JAX's: mel
(B, L, n_mels), wav (B, L * hop).  ``synthesize_long`` runs the chunks of a
long text as one batch and splices their waveforms.

Across ranks, ``Synthesizer(dp_group=)`` splits a batch over the data
group and ``tp_group=`` splits the denoiser's blocks (JAX's
``Synthesizer(mesh=)``).  Unlike the JAX pipeline, which vocodes with plain
XLA on a mesh of more than one device because its Pallas kernels have no
partitioning rule, every rank here owns a whole card and vocodes its rows
through the MRF kernels.
"""

from __future__ import annotations

import copy
import itertools
import math
import threading
import warnings
from dataclasses import dataclass
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
from cmtts_tpu_torch.core.trace import count, span
from cmtts_tpu_torch.models.cmtts import CMTTS
from cmtts_tpu_torch.models.hifigan import (
    HiFiGANGenerator,
    hifigan_apply_fused,
    pack_generator,
)
from cmtts_tpu_torch.models.melgan import MelGANGenerator
from cmtts_tpu_torch.parallel.distributed import (
    all_gather_cat,
    group_rank,
    group_size,
    shard_module,
)


# captured graphs a Synthesizer keeps; a key past them runs eagerly, so that
# callers choosing many distinct controls cannot grow memory without bound.
# Besides the shared pool, each graph holds its own inputs, noise and
# outputs: 5.4 MB allocated a graph at B=8 and mel bucket 1024 on an H100
# (0.3 MB at B=1), so 64 of them hold about 0.35 GB.
MAX_GRAPHS = 64

# the always-on counters of the synthesis call: every ``synthesize``, the
# calls a graph replay served, and the captures
GRAPH_COUNTERS = ("synth.calls", "synth.graph_replays",
                  "synth.graph_captures")


def replays_graphs(device: torch.device, dp_group=None,
                   tp_group=None) -> bool:
    """Whether a call's conditioning and sampler replay a CUDA graph: on a
    CUDA device with no data or tensor group (whose collectives stay
    outside any capture)."""
    return device.type == "cuda" and dp_group is None and tp_group is None


def graph_key(texts: torch.Tensor, t_mel: int, speakers, spker_embeds,
              sampler: str, T: int, sample_steps: int,
              controls: tuple) -> tuple:
    """Everything a captured call depends on besides its inputs' values:
    B and the text bucket (``texts``' shape), the mel bucket, the sampler
    with T (and its grid size and ts where they apply), the three controls
    and the speaker input's kind (ids or embeddings, by shape and type)."""
    def kind(x):
        return None if x is None else (tuple(x.shape), x.dtype)

    steps = None if sampler in ("onestep", "our_multistep") else sample_steps
    ts = default_ts(T) if sampler == "multistep" else None
    return (tuple(texts.shape), t_mel, sampler, T, steps, ts,
            tuple(float(c) for c in controls), kind(speakers),
            kind(spker_embeds))


@dataclass
class _Graph:
    """One captured call: its graph, the static inputs it reads and the
    static outputs it writes."""
    graph: torch.cuda.CUDAGraph
    inputs: tuple          # texts, src_lens, speakers, spker_embeds
    x_T: torch.Tensor
    noise: list            # the sampler's later unit normals
    mel: torch.Tensor
    mel_lens: torch.Tensor


def draw_into(x_T_buf: torch.Tensor, noise_bufs: Sequence[torch.Tensor],
              sigma_max: float, x_T: torch.Tensor | None = None,
              noise=None, generator: torch.Generator | None = None) -> None:
    """Fill a graph's noise inputs as the eager sampler draws them from
    ``generator``: x_T as ``sample_mel`` draws it (unit normals times
    sigma_max), then each later unit normal in order, as ``_Draws`` does;
    a given ``x_T`` or ``noise`` is copied in instead."""
    if x_T is None:
        x_T_buf.normal_(generator=generator).mul_(sigma_max)
    else:
        x_T_buf.copy_(x_T)
    if noise is None:
        for buf in noise_bufs:
            buf.normal_(generator=generator)
        return
    given = list(itertools.islice(noise, len(noise_bufs)))
    if len(given) < len(noise_bufs):
        raise ValueError("the sampler draws more noise than was given")
    for buf, z in zip(noise_bufs, given):
        buf.copy_(z)


class _CountedZeros:
    """The sampler's later draws during a warm-up: zeros, counted."""

    def __init__(self, shape, device):
        self.shape, self.device, self.n = shape, device, 0

    def __iter__(self):
        return self

    def __next__(self):
        self.n += 1
        return torch.zeros(self.shape, device=self.device)


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
    device; the denoiser runs as a ``compute_dtype`` copy, and a HiFi-GAN
    vocoder's MRF stages compute in ``compute_dtype`` with float32
    accumulation.  ``shapes_run`` holds the (mel bucket, vocode) shapes it
    has run, the keys of the JAX pipeline's compiled graphs.

    ``dp_group``: a call pads the batch to a multiple of the group's size
    (repeating the last row), synthesizes this rank's contiguous rows on
    its own device, and all-gathers the results in row order, padding
    dropped; every rank of the group makes the same call and gets the
    whole result.  The text and mel buckets are the whole batch's and each
    row's noise is the row's draw of the one-device call, so that the
    result is the one-device call's.  ``tp_group``: the denoiser copy
    keeps this rank's Megatron shards of its blocks and sums their partial
    outputs over the group (``parallel.distributed.shard_module``); every
    rank of the group makes the same call on the same rows.

    On a CUDA device with neither group, a call's conditioning and sampler
    run as one replay of a ``torch.cuda.CUDAGraph``, captured at the first
    call of each :func:`graph_key` (after an eager warm-up; both on one
    side stream), at most ``MAX_GRAPHS`` of them; the vocoder runs eagerly
    after it.  That first call costs about two eager calls (a warm-up, a
    capture, a replay), and each later call of the key saves the eager
    launches.  The noise is drawn outside the graph, from the call's
    generator in the eager sampler's order, into the graph's input
    buffers, so a replay computes what the eager call computes.  On the
    CPU, with a group, and past ``MAX_GRAPHS``, a call stays eager.  What
    ``synthesize`` and ``__call__`` return is the caller's own (the graph's
    outputs are copied out on the device).  The graphs replay one at a
    time and share one memory pool for their intermediates, which the
    largest bounds; each graph also keeps its own static inputs, noise
    buffers and outputs, so memory grows by those with each key, up to
    ``MAX_GRAPHS`` keys.
    """

    def __init__(self, cfg: Config, model: CMTTS,
                 vocoder: HiFiGANGenerator | MelGANGenerator | None = None,
                 T: int = 1,
                 sampler: str | None = None, sample_steps: int = 2,
                 text_buckets: Sequence[int] = DEFAULT_TEXT_BUCKETS,
                 mel_buckets: Sequence[int] = DEFAULT_MEL_BUCKETS,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None,
                 dp_group=None, tp_group=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        self.denoiser = self.model.denoiser
        if compute_dtype != torch.float32 or tp_group is not None:
            self.denoiser = copy.deepcopy(self.denoiser).to(compute_dtype)
        if tp_group is not None:
            shard_module(self.denoiser, tp_group)
        self.dp_group = dp_group
        self.vocoder = None if vocoder is None else vocoder.to(self.device).eval()
        self.vocoder_packed = (pack_generator(self.vocoder, compute_dtype)
                               if isinstance(vocoder, HiFiGANGenerator)
                               else None)
        self.T = T
        self.sampler = sampler or ("onestep" if T == 1 else "multistep")
        self.sample_steps = sample_steps
        self.sched = schedule_from_config(cfg)
        self.text_buckets = tuple(text_buckets)
        self.mel_buckets = tuple(mel_buckets)
        self.compute_dtype = compute_dtype
        self.shapes_run: set[tuple[int, bool]] = set()
        self._graphs = ({} if replays_graphs(self.device, dp_group, tp_group)
                        else None)
        self._graph_pool = self._graph_stream = None
        self._graph_lock = threading.Lock()
        self._graph_done = None     # the last replay's copies out, recorded

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
        count("synth.calls")
        inputs = (texts, src_lens, speakers, spker_embeds)
        controls = (d_control, p_control, e_control)
        key = None
        if self._graphs is not None:
            key = graph_key(texts, t_mel, speakers, spker_embeds,
                            self.sampler, self.T, self.sample_steps,
                            controls)
            if key not in self._graphs and len(self._graphs) >= MAX_GRAPHS:
                key = None
        if key is None:
            mel, mel_lens = self._sample(inputs, t_mel, controls, x_T, noise,
                                         generator)
        else:
            mel, mel_lens = self._replay(key, inputs, t_mel, controls, x_T,
                                         noise, generator)
        wav = None
        if self.vocoder is not None:
            with span("synth.vocode"):
                if isinstance(self.vocoder, MelGANGenerator):
                    # ln-mel -> log10-mel
                    wav = self.vocoder(mel / math.log(10.0))
                else:
                    wav = hifigan_apply_fused(self.vocoder, mel,
                                              self.vocoder_packed,
                                              self.compute_dtype)
        return mel, mel_lens, wav

    def _sample(self, inputs, t_mel: int, controls, x_T, noise, generator):
        """The eager conditioning and sampler -> (mel, mel_lens): the
        fallback, and what a graph captures."""
        texts, src_lens, speakers, spker_embeds = inputs
        d_control, p_control, e_control = controls
        sched = self.sched
        cdt = self.compute_dtype
        with span("synth.condition"):
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
        with span("synth.denoise"):
            mel = sample_mel(
                denoise, shape, sched, self.sampler, T=self.T,
                steps=self.sample_steps,
                ts=default_ts(self.T) if self.sampler == "multistep" else None,
                x_T=x_T, noise=noise, generator=generator, device=self.device)
        return mel, cond_out["mel_lens"]

    def _capture(self, inputs, t_mel: int, controls) -> _Graph:
        """Warm the call up eagerly on a side stream (counting the
        sampler's draws), then capture it into the shared pool."""
        shape = (inputs[0].shape[0], t_mel, self.cfg.stft.n_mel_channels)
        static = tuple(None if x is None else x.clone() for x in inputs)
        x_T = torch.zeros(shape, device=self.device)
        draws = _CountedZeros(shape, self.device)
        if self._graph_pool is None:
            # one side stream for every warm-up: the caching allocator
            # reuses a freed block only on its own stream
            self._graph_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        side = self._graph_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._sample(static, t_mel, controls, x_T, draws, None)
        torch.cuda.current_stream(self.device).wait_stream(side)
        noise = [torch.zeros(shape, device=self.device)
                 for _ in range(draws.n)]
        graph = torch.cuda.CUDAGraph()
        # captured on the side stream too, without ``torch.cuda.graph``'s
        # entry, which empties the allocator's cache (and may collect
        # garbage): every later eager allocation would pay cudaMalloc again
        with torch.cuda.stream(side):
            graph.capture_begin(self._graph_pool,
                                capture_error_mode="thread_local")
            try:
                mel, mel_lens = self._sample(static, t_mel, controls, x_T,
                                             noise, None)
            finally:
                graph.capture_end()
        count("synth.graph_captures")
        return _Graph(graph, static, x_T, noise, mel, mel_lens)

    def _replay(self, key, inputs, t_mel: int, controls, x_T, noise,
                generator):
        """Fill the key's graph's inputs (capturing it first if new), draw
        its noise from ``generator`` as the eager sampler would, replay it
        on the current stream and copy its outputs out."""
        with self._graph_lock:
            g = self._graphs.get(key)
            if g is None:
                g = self._graphs[key] = self._capture(inputs, t_mel, controls)
            with span("synth.replay"):
                stream = torch.cuda.current_stream(self.device)
                if self._graph_done is None:
                    self._graph_done = torch.cuda.Event()
                else:   # the last replay may have run on another stream
                    stream.wait_event(self._graph_done)
                for buf, x in zip(g.inputs, inputs):
                    if buf is not None:
                        buf.copy_(x)
                draw_into(g.x_T, g.noise, self.sched.sigma_max, x_T, noise,
                          generator)
                g.graph.replay()
                mel, mel_lens = g.mel.clone(), g.mel_lens.clone()
                self._graph_done.record(stream)
        count("synth.graph_replays")
        return mel, mel_lens

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
        with span("synth.prepare"):
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
                spker_embeds = np.zeros((B, mc.external_speaker_dim),
                                        np.float32)
            generator = torch.Generator(device=self.device).manual_seed(seed)
            if x_T is not None:
                x_T = x_T.to(self.device, torch.float32)
            rows = np.arange(B)
            dp = group_size(self.dp_group)
            if dp > 1:
                # this rank's rows of the batch padded to a multiple of dp;
                # a padded row repeats the last one
                n = -(-B // dp)
                r = group_rank(self.dp_group)
                rows = np.minimum(np.arange(r * n, (r + 1) * n), B - 1)
                shape = (B, mel_bucket, self.cfg.stft.n_mel_channels)
                if x_T is None:
                    x_T = self.sched.sigma_max * torch.randn(
                        shape, generator=generator, device=self.device)
                x_T = x_T[rows]
                noise = (_row_draws(shape, rows, generator, self.device)
                         if noise is None else [z[rows] for z in noise])
            texts = torch.from_numpy(texts[rows]).to(self.device)
            src_lens = torch.from_numpy(src_lens[rows]).to(self.device)
            speakers = torch.as_tensor(np.asarray(speakers, np.int64)[rows],
                                       device=self.device)
            spker_embeds = torch.as_tensor(
                np.asarray(spker_embeds, np.float32)[rows], device=self.device)
        mel, mel_lens, wav = self.synthesize(
            texts, src_lens, mel_bucket, speakers=speakers,
            spker_embeds=spker_embeds, d_control=d_control,
            p_control=p_control, e_control=e_control, x_T=x_T, noise=noise,
            generator=generator)
        if dp > 1:
            mel, mel_lens = (all_gather_cat(mel, self.dp_group)[:B],
                             all_gather_cat(mel_lens, self.dp_group)[:B])
            if wav is not None:
                wav = all_gather_cat(wav, self.dp_group)[:B]
        self.shapes_run.add((mel_bucket, self.vocoder is not None))
        with span("synth.fetch"):
            mel_lens = mel_lens.cpu().numpy()
            warn_if_bucket_saturated(mel_lens, mel_bucket)
            return (mel.cpu().numpy(), mel_lens,
                    None if wav is None else wav.cpu().numpy())

    def trim_wavs(self, wav: np.ndarray, mel_lens: np.ndarray):
        """Per-sample waveform trim to mel_len * hop."""
        hop = self.cfg.stft.hop_length
        return [w[: int(n) * hop] for w, n in zip(wav, mel_lens)]


def _row_draws(shape, rows, generator, device):
    """The sampler's later unit normals for ``rows``: each drawn for the
    whole batch, as the one-device call draws it, then cut to the rows."""
    while True:
        yield torch.randn(shape, generator=generator, device=device)[rows]


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
