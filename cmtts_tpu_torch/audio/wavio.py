# Copied from cmtts_tpu/audio/wavio.py (jax-free) so that the port imports nothing of cmtts_tpu.
"""Minimal RIFF/WAV read-write (no soundfile/librosa in this environment).

Supports 16-bit PCM and 32-bit float mono/stereo, which covers the TTS
corpora and our own synthesis outputs (the reference writes int16 wavs,
``utils/model.py:187-205``).
"""

from __future__ import annotations

import struct
import wave

import numpy as np


def write_wav(path: str, wav: np.ndarray, sr: int):
    """Write mono int16 (or float in [-1,1]) samples to a WAV file."""
    wav = np.asarray(wav)
    if wav.dtype != np.int16:
        wav = np.clip(wav, -1.0, 1.0)
        wav = (wav * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(wav.tobytes())


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file to float32 in [-1, 1] (mono-mixed) + sample rate."""
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = None
        data = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                break
            cid, size = struct.unpack("<4sI", chunk)
            payload = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif cid == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"missing fmt/data chunk: {path}")
        audio_format, n_channels, sr, _, _, bits = fmt
        if audio_format == 1 and bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif audio_format == 1 and bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif audio_format == 1 and bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif audio_format == 3 and bits == 32:
            x = np.frombuffer(data, dtype="<f4").astype(np.float32)
        else:
            raise ValueError(f"unsupported WAV format {audio_format}/{bits}bit: {path}")
        if n_channels > 1:
            x = x.reshape(-1, n_channels).mean(axis=1)
        return x, sr


def resample_linear(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Cheap linear resampler for preprocessing (host-side)."""
    if sr_in == sr_out:
        return wav.astype(np.float32)
    n_out = int(round(len(wav) * sr_out / sr_in))
    t_out = np.arange(n_out) * (sr_in / sr_out)
    return np.interp(t_out, np.arange(len(wav)), wav).astype(np.float32)
