# Copied from cmtts_tpu/data/synthcorpus.py (jax-free) so that the port imports nothing of cmtts_tpu.
"""Deterministic parametric speech corpus for end-to-end quality gating.

Real corpora (LJSpeech/VCTK) and trained reference checkpoints are absent
from this environment (reference ``.MISSING_LARGE_BLOBS``), so the
training loop's quality can only be proven on data we can regenerate
bit-for-bit.  This module formant-synthesizes utterances with KNOWN
phoneme durations, f0 contours and energy profiles, and writes them in
exactly the layout ``cli/prepare_align.py`` + MFA would produce:

    <raw>/<speaker>/<utt>.wav + .lab
    <pre>/TextGrid/LJSpeech/<utt>.TextGrid   (phones tier, frame-aligned)

so the standard pipeline (``cli/preprocess.py`` -> ``cli/train_cm.py`` ->
``cli/synthesize.py`` -> ``cli/all_metrics.py``) runs unmodified on it.

Synthesis model (host-side numpy, no assets):

- voiced source: harmonic additive synthesis with a continuous phase
  track (no frame-boundary clicks), harmonic amplitudes shaped by the
  phone's formant envelope (3 resonances + spectral tilt);
- unvoiced source: white noise FFT-shaped per frame by the phone's
  envelope, overlap-added;
- per-phone intensity + a sentence-level declination/accent f0 contour
  with deterministic per-utterance variation.

Phone intervals are quantized to mel-hop boundaries so TextGrid
durations are exact (the preprocessor's duration extraction introduces
no rounding error).
"""

from __future__ import annotations

import os

import numpy as np

from cmtts_tpu_torch.audio.wavio import write_wav

SR = 22050
HOP = 256
NFFT = 1024

# phone -> (formants Hz, voiced, noise_band (lo, hi) | None, level)
# Formant values follow the classic Peterson & Barney / Klatt tables.
PHONE_SPECS: dict[str, dict] = {
    # vowels
    "AA": dict(formants=(730, 1090, 2440), voiced=True, level=1.0),
    "AE": dict(formants=(660, 1720, 2410), voiced=True, level=1.0),
    "AH": dict(formants=(640, 1190, 2390), voiced=True, level=0.9),
    "AO": dict(formants=(570, 840, 2410), voiced=True, level=1.0),
    "EH": dict(formants=(530, 1840, 2480), voiced=True, level=0.95),
    "ER": dict(formants=(490, 1350, 1690), voiced=True, level=0.9),
    "IH": dict(formants=(390, 1990, 2550), voiced=True, level=0.85),
    "IY": dict(formants=(270, 2290, 3010), voiced=True, level=0.85),
    "OW": dict(formants=(450, 880, 2830), voiced=True, level=0.95),
    "UW": dict(formants=(300, 870, 2240), voiced=True, level=0.85),
    # liquids / glides / nasals (voiced, weaker)
    "L": dict(formants=(360, 1300, 2700), voiced=True, level=0.6),
    "R": dict(formants=(420, 1300, 1600), voiced=True, level=0.6),
    "W": dict(formants=(300, 700, 2200), voiced=True, level=0.55),
    "Y": dict(formants=(280, 2200, 2900), voiced=True, level=0.55),
    "M": dict(formants=(250, 1100, 2200), voiced=True, level=0.5),
    "N": dict(formants=(250, 1500, 2500), voiced=True, level=0.5),
    "NG": dict(formants=(250, 1300, 2100), voiced=True, level=0.5),
    # fricatives (noise)
    "S": dict(formants=(), voiced=False, noise_band=(4000, 9000), level=0.5),
    "SH": dict(formants=(), voiced=False, noise_band=(2000, 6500), level=0.55),
    "F": dict(formants=(), voiced=False, noise_band=(1500, 8500), level=0.3),
    "TH": dict(formants=(), voiced=False, noise_band=(1800, 8000), level=0.25),
    "HH": dict(formants=(600, 1500, 2500), voiced=False,
               noise_band=(300, 4000), level=0.3),
    "Z": dict(formants=(300,), voiced=True, noise_band=(4000, 9000),
              level=0.5),
    "V": dict(formants=(300,), voiced=True, noise_band=(1500, 7000),
              level=0.35),
    # stops: closure + burst handled specially
    "P": dict(formants=(), voiced=False, noise_band=(500, 3000), level=0.45,
              stop=True),
    "T": dict(formants=(), voiced=False, noise_band=(3000, 8000), level=0.5,
              stop=True),
    "K": dict(formants=(), voiced=False, noise_band=(1500, 4500), level=0.5,
              stop=True),
    "B": dict(formants=(300,), voiced=True, noise_band=(400, 2500),
              level=0.45, stop=True),
    "D": dict(formants=(300,), voiced=True, noise_band=(2500, 7000),
              level=0.5, stop=True),
    "G": dict(formants=(300,), voiced=True, noise_band=(1200, 4000),
              level=0.5, stop=True),
}

VOWELS = [p for p, s in PHONE_SPECS.items()
          if s["voiced"] and s.get("formants") and len(s["formants"]) == 3
          and p not in ("L", "R", "W", "Y", "M", "N", "NG")]
ONSETS = ["B", "D", "G", "P", "T", "K", "S", "SH", "F", "HH", "M", "N",
          "L", "R", "W", "Y", "Z", "V"]
CODAS = ["", "", "N", "M", "NG", "S", "Z", "T", "D", "K", "L", "R"]

# frame-duration ranges (mel frames @ 256/22050 ~ 11.6 ms) per class
_DUR_FRAMES = {"vowel": (7, 16), "cons": (4, 9), "stop": (5, 8),
               "sp": (4, 10), "sil": (6, 12)}


def _phone_class(p: str) -> str:
    if p in ("sil",):
        return "sil"
    if p in ("sp", "spn"):
        return "sp"
    if PHONE_SPECS.get(p, {}).get("stop"):
        return "stop"
    return "vowel" if p in VOWELS else "cons"


def _envelope(spec: dict, freqs: np.ndarray, formant_scale: float = 1.0,
              tilt: float = 3500.0) -> np.ndarray:
    """Spectral magnitude envelope at ``freqs`` for a phone spec.

    ``formant_scale`` models vocal-tract length (scales formant centers
    and noise bands); ``tilt`` is the glottal spectral-tilt corner (Hz).
    Defaults reproduce the single-speaker corpus bit-for-bit.
    """
    env = np.zeros_like(freqs)
    for i, f in enumerate(spec.get("formants", ())):
        f = f * formant_scale
        bw = 60.0 + 40.0 * i + 0.05 * f
        env += 1.0 / (1.0 + ((freqs - f) / bw) ** 2) * (0.8 ** i)
    band = spec.get("noise_band")
    if band is not None:
        lo, hi = band[0] * formant_scale, band[1] * formant_scale
        env += 0.8 * ((freqs >= lo) & (freqs <= hi)) * \
            np.exp(-0.5 * ((freqs - (lo + hi) / 2) / ((hi - lo) / 2.5)) ** 2)
    # glottal spectral tilt for voiced phones
    if spec.get("voiced"):
        env = env * (1.0 / (1.0 + (freqs / tilt) ** 2))
    return env * spec.get("level", 1.0)


def sample_utterance(rng: np.random.RandomState,
                     n_words: tuple[int, int] = (3, 7)):
    """Random phone sequence with frame-quantized durations.

    Returns (phones, durations_frames) including boundary silences —
    the ground-truth alignment.
    """
    phones, durs = ["sil"], [rng.randint(*_DUR_FRAMES["sil"])]
    for w in range(rng.randint(n_words[0], n_words[1] + 1)):
        if w > 0 and rng.rand() < 0.4:
            phones.append("sp")
            durs.append(rng.randint(*_DUR_FRAMES["sp"]))
        for _ in range(rng.randint(1, 4)):  # syllables per word
            if rng.rand() < 0.9:
                phones.append(ONSETS[rng.randint(len(ONSETS))])
                durs.append(rng.randint(*_DUR_FRAMES[_phone_class(phones[-1])]))
            phones.append(VOWELS[rng.randint(len(VOWELS))])
            durs.append(rng.randint(*_DUR_FRAMES["vowel"]))
            coda = CODAS[rng.randint(len(CODAS))]
            if coda:
                phones.append(coda)
                durs.append(rng.randint(*_DUR_FRAMES[_phone_class(coda)]))
    phones.append("sil")
    durs.append(rng.randint(*_DUR_FRAMES["sil"]))
    return phones, durs


def f0_contour(phones, durs, rng: np.random.RandomState,
               base: float = 170.0,
               deterministic: bool = False) -> np.ndarray:
    """Per-frame f0 (Hz): declination + per-syllable accents + jitter.
    Unvoiced/silent frames are 0.

    ``deterministic=True`` makes the contour a pure function of the
    phone sequence and its durations (round-4 VERDICT #6): accents land
    on EVERY vowel with an amplitude fixed by the vowel's identity and a
    width fixed by its duration, no jitter.  The default (False) keeps
    the original corpus bit-for-bit: random 60 %-per-vowel accents with
    random amplitude/width — prosody text CANNOT predict, which puts an
    ~162-cent aleatoric floor under the stats head
    (tools/diag_pitch.py round-4 decomposition)."""
    total = int(np.sum(durs))
    t = np.arange(total) / max(total - 1, 1)
    f0 = base * (1.12 - 0.25 * t)  # declination
    # accent bumps centered on voiced vowels
    pos = 0
    for p, d in zip(phones, durs):
        if p in VOWELS:
            if deterministic:
                # amplitude from the vowel identity (text-predictable),
                # width from its duration (duration-predictable)
                amp = 6.0 + 18.0 * VOWELS.index(p) / max(len(VOWELS) - 1, 1)
                width = max(d, 4) * 1.2
            elif rng.rand() < 0.6:
                amp = rng.uniform(5.0, 25.0)
                width = max(d, 4) * rng.uniform(0.8, 1.6)
            else:
                pos += d
                continue
            c = pos + d / 2
            f0 += amp * np.exp(-0.5 * ((np.arange(total) - c) / width) ** 2)
        pos += d
    if not deterministic:
        f0 *= 1.0 + 0.01 * rng.randn(total)  # jitter
    # zero out unvoiced frames
    voiced = np.zeros(total, bool)
    pos = 0
    for p, d in zip(phones, durs):
        if PHONE_SPECS.get(p, {}).get("voiced"):
            voiced[pos: pos + d] = True
        pos += d
    return np.where(voiced, f0, 0.0)


# sampling bounds for each speaker_profile dimension — also used to
# normalize profile-space distances (each dim mapped to [0, 1])
PROFILE_BOUNDS = dict(
    formant_scale=(0.84, 1.22),
    f0_base=(110.0, 280.0),
    tilt=(2300.0, 5200.0),
    breathiness=(0.6, 1.8),
)


def speaker_profile(rng: np.random.RandomState) -> dict:
    """Deterministic per-speaker voice parameters for the multi-speaker
    corpus: vocal-tract length (formant scale), f0 register, glottal
    tilt, and breathiness.  Ranges are wide enough that speakers are
    trivially separable by a speaker encoder but all remain
    speech-shaped."""
    return {k: float(rng.uniform(lo, hi))
            for k, (lo, hi) in PROFILE_BOUNDS.items()}


def profile_distance(a: dict, b: dict) -> float:
    """L2 distance between two speaker profiles in the normalized
    [0, 1]^4 profile cube."""
    d = 0.0
    for k, (lo, hi) in PROFILE_BOUNDS.items():
        d += ((a[k] - b[k]) / (hi - lo)) ** 2
    return float(np.sqrt(d))


def holdout_speaker_profile(rng: np.random.RandomState,
                            train_profiles: list,
                            min_dist: float = 0.3,
                            max_tries: int = 200) -> dict:
    """Sample a zero-shot holdout voice that is genuinely NOVEL: its
    normalized profile distance to every training voice must be at
    least ``min_dist``.

    Rationale (round 4): iid-uniform sampling let a holdout voice land
    at normalized distance ~0.1 from a training voice (v32 vs v09 in
    the 34-speaker corpus), so the GE2E ranking eval confused them at
    cos 0.94 even though the embedder generalized (self-cos 0.93) —
    the eval was ill-posed, not the encoder broken.  With 32 train
    points in the unit 4-cube the expected nearest-neighbour distance
    of a random draw is ~0.28, so ``min_dist=0.3`` needs only mild
    rejection.  Falls back to the max-min-distance candidate if no draw
    clears the threshold (then logs it).
    """
    best, best_d = None, -1.0
    for _ in range(max_tries):
        cand = speaker_profile(rng)
        d = min((profile_distance(cand, t) for t in train_profiles),
                default=float("inf"))
        if d > best_d:
            best, best_d = cand, d
        if d >= min_dist:
            return cand
    print(f"holdout_speaker_profile: no draw reached min_dist={min_dist} "
          f"after {max_tries} tries; using max-min-dist={best_d:.3f}")
    return best


def synthesize(phones, durs, f0_frames, rng: np.random.RandomState,
               n_harm: int = 40, profile: dict | None = None) -> np.ndarray:
    """Render the utterance to a waveform (float32, 22.05 kHz)."""
    total_frames = int(np.sum(durs))
    n = total_frames * HOP
    freqs = np.fft.rfftfreq(NFFT, 1.0 / SR)
    fscale = profile["formant_scale"] if profile else 1.0
    tilt = profile["tilt"] if profile else 3500.0
    breath = profile["breathiness"] if profile else 1.0

    # per-frame envelope + voicing + level
    env = np.zeros((total_frames, len(freqs)))
    voiced_amp = np.zeros(total_frames)
    noise_amp = np.zeros(total_frames)
    pos = 0
    for p, d in zip(phones, durs):
        spec = PHONE_SPECS.get(p)
        if spec is None:  # sil/sp
            pos += d
            continue
        e = _envelope(spec, freqs, formant_scale=fscale, tilt=tilt)
        sl = slice(pos, pos + d)
        if spec.get("stop"):
            # closure (first ~60%) silent, then burst
            nb = max(d - max(int(d * 0.6), 1), 1)
            env[pos + d - nb: pos + d] = e
            noise_amp[pos + d - nb: pos + d] = spec["level"]
            if spec.get("voiced"):
                voiced_amp[pos + d - nb: pos + d] = 0.3
        else:
            env[sl] = e
            if spec.get("voiced"):
                voiced_amp[sl] = 1.0
            if spec.get("noise_band") is not None:
                noise_amp[sl] = 0.6 if not spec.get("voiced") else 0.3 * breath
        pos += d

    # smooth coarticulation: 3-frame triangular smoothing of the envelope
    k = np.array([0.25, 0.5, 0.25])
    env = np.apply_along_axis(
        lambda c: np.convolve(c, k, mode="same"), 0, env)
    voiced_amp = np.convolve(voiced_amp, k, mode="same")
    noise_amp = np.convolve(noise_amp, k, mode="same")

    # --- voiced part: additive harmonics with continuous phase ----------
    f0_s = np.repeat(np.maximum(f0_frames, 1.0), HOP)[:n]  # per-sample f0
    phase = 2.0 * np.pi * np.cumsum(f0_s) / SR
    wav = np.zeros(n)
    vo = np.repeat(voiced_amp, HOP)[:n]
    f0_frame_safe = np.maximum(f0_frames, 1.0)
    for kh in range(1, n_harm + 1):
        hf = f0_frame_safe * kh
        valid = hf < SR / 2 - 200
        # harmonic amplitude from the frame envelope at k*f0
        idx = np.clip((hf / (SR / 2) * (len(freqs) - 1)).astype(int),
                      0, len(freqs) - 1)
        amp_f = env[np.arange(total_frames), idx] * valid
        amp = np.repeat(amp_f, HOP)[:n]
        wav += amp * np.sin(kh * phase)
    wav *= vo

    # --- noise part: FFT-shaped white noise, overlap-add ----------------
    noise = rng.randn(n + NFFT)
    shaped = np.zeros(n + NFFT)
    win = np.hanning(NFFT)
    for fi in range(total_frames):
        s = fi * HOP
        seg = noise[s: s + NFFT] * win
        spec_n = np.fft.rfft(seg)
        spec_n *= env[fi] * noise_amp[fi] * 4.0
        shaped[s: s + NFFT] += np.fft.irfft(spec_n, NFFT) * win
    wav += shaped[:n]

    peak = np.abs(wav).max()
    if peak > 0:
        wav = wav / peak * 0.7
    return wav.astype(np.float32)


def _write_textgrid(path: str, phones, durs):
    """Minimal MFA-style TextGrid with a frame-aligned phones tier."""
    times = np.concatenate([[0], np.cumsum(durs)]) * HOP / SR
    xmax = times[-1]
    lines = [
        'File type = "ooTextFile"', 'Object class = "TextGrid"', "",
        "xmin = 0", f"xmax = {xmax:.6f}", "tiers? <exists>", "size = 1",
        "item []:", "    item [1]:", '        class = "IntervalTier"',
        '        name = "phones"', "        xmin = 0",
        f"        xmax = {xmax:.6f}",
        f"        intervals: size = {len(phones)}",
    ]
    for i, p in enumerate(phones):
        lines += [
            f"        intervals [{i + 1}]:",
            f"            xmin = {times[i]:.6f}",
            f"            xmax = {times[i + 1]:.6f}",
            f'            text = "{p if p != "sil" else ""}"',
        ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _write_utterance(spk_dir: str, tg_path: str, base: str, rng,
                     n_words, f0_base: float,
                     profile: dict | None = None,
                     deterministic_prosody: bool = False) -> list[str]:
    """Render + write one utterance (wav, lab, TextGrid); returns phones."""
    phones, durs = sample_utterance(rng, n_words)
    f0 = f0_contour(phones, durs, rng, base=f0_base,
                    deterministic=deterministic_prosody)
    wav = synthesize(phones, durs, f0, rng, profile=profile)
    write_wav(os.path.join(spk_dir, f"{base}.wav"), wav, SR)
    with open(os.path.join(spk_dir, f"{base}.lab"), "w") as f:
        # pseudo-text: the phone string (metrics' text_lookup surface)
        f.write(" ".join(p for p in phones if p not in ("sil", "sp")))
    _write_textgrid(tg_path, phones, durs)
    return phones


def generate_corpus(raw_root: str, pre_root: str, n_utts: int = 200,
                    seed: int = 1234, speaker: str = "SYN",
                    n_words: tuple[int, int] = (3, 7),
                    base_f0_range: tuple[float, float] = (150.0, 210.0),
                    deterministic_prosody: bool = False):
    """Write the full corpus; returns the list of basenames.

    ``deterministic_prosody`` additionally pins the per-utterance base
    f0 to the midpoint of ``base_f0_range`` — the random per-utterance
    register (uniform over a ±~290-cent spread) is exactly the
    text-unpredictable component the round-4 pitch diagnosis attributed
    the stats-head error to."""
    spk_dir = os.path.join(raw_root, speaker)
    tg_dir = os.path.join(pre_root, "TextGrid", "LJSpeech")
    os.makedirs(spk_dir, exist_ok=True)
    os.makedirs(tg_dir, exist_ok=True)
    names = []
    for i in range(n_utts):
        rng = np.random.RandomState(seed + i)
        base = f"syn{i:04d}"
        f0_base = (0.5 * (base_f0_range[0] + base_f0_range[1])
                   if deterministic_prosody
                   else rng.uniform(*base_f0_range))
        _write_utterance(spk_dir, os.path.join(tg_dir, f"{base}.TextGrid"),
                         base, rng, n_words, f0_base,
                         deterministic_prosody=deterministic_prosody)
        names.append(base)
    return names


def generate_multispeaker_corpus(raw_root: str, pre_root: str,
                                 n_speakers: int = 12,
                                 utts_per_speaker: int = 40,
                                 seed: int = 7777,
                                 n_words: tuple[int, int] = (3, 7),
                                 holdout_speakers: int = 1,
                                 deterministic_prosody: bool = False):
    """VCTK-layout multi-speaker corpus with per-speaker voice profiles.

    Speakers ``v00 .. v{N-1}``; the LAST ``holdout_speakers`` are written
    under ``<raw_root>_holdout`` (wavs + labs + TextGrids under
    ``<pre_root>_holdout``) so the standard preprocess/train never sees
    them — they are the zero-shot targets.  TextGrids go to
    ``<pre_root>/TextGrid/<speaker>/<base>.TextGrid`` (the VCTK layout
    the preprocessor expects, data/preprocessor.py:106-108).

    Returns ``(train_speakers, holdout_speakers_list, phones_by_utt)``
    where ``phones_by_utt[(spk, base)]`` is the ground-truth phone
    sequence (for zero-shot token input without a lexicon round-trip).
    """
    names: dict[tuple[str, str], list[str]] = {}
    train_spk, hold_spk = [], []
    train_profiles: list[dict] = []
    for si in range(n_speakers):
        spk = f"v{si:02d}"
        held = si >= n_speakers - holdout_speakers
        rroot = raw_root + ("_holdout" if held else "")
        proot = pre_root + ("_holdout" if held else "")
        (hold_spk if held else train_spk).append(spk)
        spk_dir = os.path.join(rroot, spk)
        tg_dir = os.path.join(proot, "TextGrid", spk)
        os.makedirs(spk_dir, exist_ok=True)
        os.makedirs(tg_dir, exist_ok=True)
        prof_rng = np.random.RandomState(seed * 31 + si)
        if held:
            # zero-shot targets must be NOVEL voices: keep a minimum
            # normalized profile distance from every training speaker
            # (otherwise the ranking eval is ill-posed — see
            # holdout_speaker_profile)
            profile = holdout_speaker_profile(prof_rng, train_profiles)
        else:
            profile = speaker_profile(prof_rng)
            train_profiles.append(profile)
        for ui in range(utts_per_speaker):
            rng = np.random.RandomState(seed + si * 100003 + ui)
            base = f"{spk}_{ui:03d}"
            f0_base = (profile["f0_base"] if deterministic_prosody
                       else profile["f0_base"] * rng.uniform(0.95, 1.05))
            phones = _write_utterance(
                spk_dir, os.path.join(tg_dir, f"{base}.TextGrid"),
                base, rng, n_words, f0_base, profile=profile,
                deterministic_prosody=deterministic_prosody)
            names[(spk, base)] = phones
    return train_spk, hold_spk, names
