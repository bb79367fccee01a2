"""The one general traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and makes the calls of a run from ``--seed``.

A mix draws utterance lengths (phonemes) from a truncated normal.  So that
every seed does the same work in another order, the lengths come in blocks
of ``block`` calls: each block holds the same lengths, the quantiles
(i + 1/2) / n of the distribution, shuffled by the seed into calls of
``batch``.  Token ids are drawn uniformly from ``token_ids`` [lo, hi).  A
mix with ``voices`` gives each call a reference voice, each block holding
every voice once in an order of its own.  Each call carries a noise seed
of its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


@dataclass
class Call:
    tokens: list          # ``batch`` int64 arrays of phoneme ids
    voices: list | None   # a voice index per row, or None
    noise_seed: int


def truncnorm_quantiles(n: int, mean: float, sd: float, lo: int,
                        hi: int) -> np.ndarray:
    """The n quantiles (i + 1/2) / n of N(mean, sd) truncated to
    [lo, hi], rounded to whole phonemes."""
    nd = NormalDist(mean, sd)
    a, b = nd.cdf(lo - 0.5), nd.cdf(hi + 0.5)
    q = [nd.inv_cdf(a + (i + 0.5) / n * (b - a)) for i in range(n)]
    return np.clip(np.rint(q), lo, hi).astype(np.int64)


def run_rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, salt])


def make_calls(mix: dict, seed: int) -> list[Call]:
    """The ``pool`` calls of a run, in order; a run cycles through them."""
    B, block, pool = mix["batch"], mix["block"], mix["pool"]
    if pool % block:
        raise ValueError("pool must hold whole blocks")
    ph = mix["phonemes"]
    lengths = truncnorm_quantiles(block * B, ph["mean"], ph["sd"], ph["min"],
                                  ph["max"])
    lo, hi = mix["token_ids"]
    voices = mix.get("voices")
    rng = run_rng(seed, 1)
    calls = []
    for _ in range(pool // block):
        order = rng.permutation(lengths).reshape(block, B)
        vperm = (None if voices is None else
                 rng.permutation(np.arange(block * B) % voices).reshape(
                     block, B))
        for j in range(block):
            toks = [rng.integers(lo, hi, size=int(n)).astype(np.int64)
                    for n in order[j]]
            calls.append(Call(toks, None if vperm is None
                              else [int(v) for v in vperm[j]],
                              int(rng.integers(0, 2 ** 62))))
    return calls


def make_voices(mix: dict, seed: int, sr: int) -> np.ndarray:
    """(voices, seconds * sr) float32 reference clips: a sawtooth source at
    the voice's f0 (85-255 Hz) with vibrato and drift, through three
    formant resonances of the voice, syllable-rate amplitude modulation
    and breath noise; peak 0.5."""
    n_voices, seconds = mix["voices"], mix["reference_seconds"]
    n = int(seconds * sr)
    rng = run_rng(seed, 2)
    t = np.arange(n) / sr
    out = np.empty((n_voices, n), np.float32)
    for v in range(n_voices):
        f0 = rng.uniform(85.0, 255.0)
        inst = f0 * (1.0 + 0.03 * np.sin(2 * np.pi * rng.uniform(3, 6) * t)
                     + 0.01 * rng.standard_normal(n).cumsum() / np.sqrt(n))
        src = (np.cumsum(inst) / sr) % 1.0 - 0.5
        spec = np.fft.rfft(src)
        freqs = np.fft.rfftfreq(n, 1.0 / sr)
        gain = np.zeros_like(freqs)
        for fc, bw in zip(rng.uniform([300, 900, 2200], [900, 2200, 3400]),
                          rng.uniform(60, 200, 3)):
            gain += 1.0 / (1.0 + ((freqs - fc) / bw) ** 2)
        x = np.fft.irfft(spec * gain, n)
        x *= 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(3, 5) * t) ** 2
        x += 0.02 * np.abs(x).max() * rng.standard_normal(n)
        out[v] = 0.5 * x / np.abs(x).max()
    return out
