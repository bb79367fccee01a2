# Copied from cmtts_tpu/data/prepare.py (jax-free) so that the port imports nothing of cmtts_tpu.
"""Corpus normalization (``prepare_align`` stage): raw corpora ->
``raw_path/<speaker>/<basename>.{wav,lab}``.

Parity with the reference per-corpus preparers (``preprocessor/
{ljspeech,vctk,libritts}.py``): resample to the target rate,
peak-normalize to int16 range, write cleaned transcript .lab files.
"""

from __future__ import annotations

import os

import numpy as np

from cmtts_tpu_torch.audio.wavio import read_wav, resample_linear, write_wav
from cmtts_tpu_torch.core.config import Config
from cmtts_tpu_torch.text.cleaners import english_cleaners


def _write_pair(out_dir: str, speaker: str, base: str, wav: np.ndarray,
                sr: int, text: str, max_wav_value: float):
    spk_dir = os.path.join(out_dir, speaker)
    os.makedirs(spk_dir, exist_ok=True)
    peak = np.abs(wav).max() or 1.0
    wav = wav / peak * (max_wav_value - 1) / max_wav_value
    write_wav(os.path.join(spk_dir, f"{base}.wav"), wav, sr)
    with open(os.path.join(spk_dir, f"{base}.lab"), "w") as f:
        f.write(text)


def prepare_ljspeech(cfg: Config):
    """LJSpeech metadata.csv (reference preprocessor/ljspeech.py:11-39)."""
    in_dir, out_dir = cfg.data.corpus_path, cfg.data.raw_path
    sr, mwv = cfg.stft.sampling_rate, cfg.stft.max_wav_value
    speaker = "LJSpeech"
    n = 0
    with open(os.path.join(in_dir, "metadata.csv"), encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            base, text = parts[0], parts[2] if len(parts) > 2 else parts[1]
            wav_path = os.path.join(in_dir, "wavs", f"{base}.wav")
            if not os.path.exists(wav_path):
                continue
            wav, in_sr = read_wav(wav_path)
            wav = resample_linear(wav, in_sr, sr)
            _write_pair(out_dir, speaker, base, wav, sr,
                        english_cleaners(text), mwv)
            n += 1
    print(f"prepared {n} LJSpeech utterances -> {out_dir}")


def prepare_vctk(cfg: Config, wav_dir: str = "wav48_silence_trimmed",
                 txt_dir: str = "txt", wav_tag: str = "mic1"):
    """VCTK flac/wav mic1 (reference preprocessor/vctk.py:11-45).
    Expects wavs pre-converted to .wav (flac decode not available here)."""
    in_dir, out_dir = cfg.data.corpus_path, cfg.data.raw_path
    sr, mwv = cfg.stft.sampling_rate, cfg.stft.max_wav_value
    n = 0
    for speaker in sorted(os.listdir(os.path.join(in_dir, txt_dir))):
        spk_txt = os.path.join(in_dir, txt_dir, speaker)
        for txt_name in sorted(os.listdir(spk_txt)):
            if not txt_name.endswith(".txt"):
                continue
            base = txt_name[:-4]
            with open(os.path.join(spk_txt, txt_name)) as f:
                text = f.readline().strip("\n")
            wav_path = os.path.join(in_dir, wav_dir, speaker,
                                    f"{base}_{wav_tag}.wav")
            if not os.path.exists(wav_path):
                continue
            wav, in_sr = read_wav(wav_path)
            wav = resample_linear(wav, in_sr, sr)
            _write_pair(out_dir, speaker, base, wav, sr,
                        english_cleaners(text), mwv)
            n += 1
    print(f"prepared {n} VCTK utterances -> {out_dir}")


def prepare_libritts(cfg: Config):
    """LibriTTS .normalized.txt (reference preprocessor/libritts.py:11-45)."""
    in_dir, out_dir = cfg.data.corpus_path, cfg.data.raw_path
    sr, mwv = cfg.stft.sampling_rate, cfg.stft.max_wav_value
    n = 0
    for speaker in sorted(os.listdir(in_dir)):
        spk_dir = os.path.join(in_dir, speaker)
        if not os.path.isdir(spk_dir):
            continue
        for chapter in sorted(os.listdir(spk_dir)):
            ch_dir = os.path.join(spk_dir, chapter)
            if not os.path.isdir(ch_dir):
                continue
            for fn in sorted(os.listdir(ch_dir)):
                if not fn.endswith(".wav"):
                    continue
                base = fn[:-4]
                txt = os.path.join(ch_dir, f"{base}.normalized.txt")
                if not os.path.exists(txt):
                    continue
                with open(txt) as f:
                    text = f.readline().strip("\n")
                wav, in_sr = read_wav(os.path.join(ch_dir, fn))
                wav = resample_linear(wav, in_sr, sr)
                _write_pair(out_dir, speaker, base, wav, sr,
                            english_cleaners(text), mwv)
                n += 1
    print(f"prepared {n} LibriTTS utterances -> {out_dir}")


PREPARERS = {
    "LJSpeech": prepare_ljspeech,
    "VCTK": prepare_vctk,
    "LibriTTS": prepare_libritts,
}
