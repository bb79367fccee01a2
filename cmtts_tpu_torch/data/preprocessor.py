# Port of cmtts_tpu/data/preprocessor.py: the mel front-end runs with torch on the
# Preprocessor's device, the rest is the same host numpy, and the spawn-pool workers
# import no jax.
"""Corpus preprocessing: MFA alignments -> per-utterance feature npy files.

Behaviour parity with the reference ``Preprocessor``
(``preprocessor/preprocessor.py:77-470``):

- phones/durations/mel2ph from the TextGrid "phones" tier with
  leading/trailing-silence trimming (:358-402);
- wav trimmed to the aligned span (:281-285);
- mel + energy from the TacotronSTFT-compatible front-end (:292-294),
  here torch on the Preprocessor's ``device`` (cmtts_tpu_torch.audio.stft;
  ``cuda`` unless the caller asks for the CPU);
- phoneme-averaged energy (:296-305), z-normalized in place (:426-437);
- f0 via the native autocorrelation tracker + mel-length alignment;
- CWT of the normalized continuous log-f0 (:408-414);
- corpus stats.json / speakers.json / train.txt / val.txt (:192-249).

The f0 tracker, the CWT, the statistics and the npy writes are host numpy;
utterances stream sequentially, or over a spawn pool of ``workers``
processes, each with its own Preprocessor on the parent's device (N
workers on ``cuda`` open N CUDA contexts).
"""

from __future__ import annotations

import json
import os
import random
from typing import Callable

import numpy as np

from cmtts_tpu_torch.audio.pitch import (
    get_cont_lf0,
    get_lf0_cwt,
    get_pitch,
)
from cmtts_tpu_torch.audio.stft import MelSpectrogram
from cmtts_tpu_torch.audio.wavio import read_wav, resample_linear
from cmtts_tpu_torch.core.config import Config
from cmtts_tpu_torch.core.device import resolve_device
from cmtts_tpu_torch.data.textgrid import read_textgrid

# "" is modern MFA's silence label (older MFA wrote sil/sp/spn — the
# reference only handles those, preprocessor.py:359; empty-text intervals
# would otherwise survive as phantom phones that VANISH at tokenization,
# desynchronizing text vs duration/mel2ph for every utterance)
SIL_PHONES = ("sil", "sp", "spn", "")

FEATURE_DIRS = ("mel", "f0", "pitch", "cwt_spec", "cwt_scales",
                "f0cwt_mean_std", "energy", "duration", "mel2ph", "spker_embed")


class Preprocessor:
    def __init__(self, cfg: Config, dataset_type: str | None = None,
                 speaker_embedder: Callable | None = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.in_dir = cfg.data.raw_path
        self.out_dir = cfg.data.preprocessed_path
        self.dataset_type = dataset_type or cfg.data.dataset
        self.sr = cfg.stft.sampling_rate
        self.hop = cfg.stft.hop_length
        self.val_size = cfg.data.val_size
        self.stft = MelSpectrogram(
            cfg.stft.sampling_rate, cfg.stft.filter_length, cfg.stft.hop_length,
            cfg.stft.win_length, cfg.stft.n_mel_channels, cfg.stft.mel_fmin,
            cfg.stft.mel_fmax, device=self.device)
        self.with_f0 = cfg.pitch.with_f0
        self.with_f0cwt = cfg.pitch.with_f0cwt
        self.energy_phoneme_averaging = cfg.energy.feature == "phoneme_level"
        self.energy_normalization = cfg.energy.normalization
        self.speaker_embedder = speaker_embedder

    # -- alignment ---------------------------------------------------------
    def get_alignment(self, intervals):
        """(phones, durations, mel2ph, start, end) with silence trimming
        (reference :358-402)."""
        phones, durations = [], []
        start_time = end_time = 0.0
        end_idx = 0
        for iv in intervals:
            s, e, p = iv.start_time, iv.end_time, iv.text
            if not phones:
                if p in SIL_PHONES:
                    continue
                start_time = s
            if p not in SIL_PHONES:
                phones.append(p)
                end_time = e
                end_idx = len(phones)
            else:
                # interior silence: keep it, but give MFA's "" a symbol
                # that survives text_to_sequence round-trips
                phones.append(p if p else "sp")
            durations.append(int(
                np.round(e * self.sr / self.hop) - np.round(s * self.sr / self.hop)))
        phones = phones[:end_idx]
        durations = durations[:end_idx]
        mel2ph = np.repeat(np.arange(1, len(phones) + 1), durations)
        assert sum(durations) == len(mel2ph)
        return phones, durations, mel2ph, start_time, end_time

    def _tg_path(self, speaker: str, basename: str) -> str:
        tgdir = os.path.join(self.out_dir, "TextGrid")
        if self.dataset_type == "LibriTTS":
            a, b = basename.split("_")[0], basename.split("_")[1]
            return os.path.join(tgdir, a, b, f"{basename}.TextGrid")
        if self.dataset_type == "VCTK":
            return os.path.join(tgdir, speaker,
                                f"{basename.replace('-', '_')}.TextGrid")
        return os.path.join(tgdir, "LJSpeech", f"{basename}.TextGrid")

    # -- per-utterance -----------------------------------------------------
    def process_utterance(self, speaker: str, basename: str,
                          save_speaker_emb: bool = False):
        wav_path = os.path.join(self.in_dir, speaker, f"{basename}.wav")
        lab_path = os.path.join(self.in_dir, speaker, f"{basename}.lab")
        tg_path = self._tg_path(speaker, basename)
        tiers = read_textgrid(tg_path)
        phones, durations, mel2ph, start, end = self.get_alignment(
            tiers["phones"].intervals)
        if start >= end or not phones:
            return None
        text = "{" + " ".join(phones) + "}"

        wav, sr = read_wav(wav_path)
        if sr != self.sr:
            wav = resample_linear(wav, sr, self.sr)
        spker_embed = (self.speaker_embedder(wav)
                       if save_speaker_emb and self.speaker_embedder else None)
        wav = wav[int(self.sr * start): int(self.sr * end)].astype(np.float32)

        raw_text = ""
        if os.path.exists(lab_path):
            with open(lab_path) as f:
                raw_text = f.readline().strip("\n")

        mel, energy = self.stft(wav)  # (n_mels, T), (T,)
        n_frames = sum(durations)
        mel = mel[:, :n_frames]
        energy = np.asarray(energy[:n_frames]).copy()
        if mel.shape[1] < n_frames:
            return None  # alignment ran past the audio

        if self.energy_phoneme_averaging:
            pos = 0
            for i, d in enumerate(durations):
                energy[i] = np.mean(energy[pos: pos + d]) if d > 0 else 0.0
                pos += d
            energy = energy[: len(durations)]

        f0 = pitch = cwt_spec = cwt_scales = f0cwt_mean_std = None
        if self.with_f0:
            f0, pitch = get_pitch(wav, mel.shape[1], self.sr, self.hop)
            if f0 is None or f0.sum() == 0:
                return None
            if self.with_f0cwt:
                cwt_spec, cwt_scales, f0cwt_mean_std = self.get_f0cwt(f0)
                if np.any(np.isnan(cwt_spec)):
                    return None

        def save(kind, arr):
            np.save(os.path.join(self.out_dir, kind,
                                 f"{speaker}-{kind}-{basename}.npy"), arr)

        save("duration", np.asarray(durations))
        save("mel2ph", mel2ph)
        save("mel", mel.T)  # stored (T, n_mels)
        save("energy", energy)
        if self.with_f0:
            save("f0", f0)
            save("pitch", pitch)
            if self.with_f0cwt:
                save("cwt_spec", cwt_spec)
                save("cwt_scales", cwt_scales)
                save("f0cwt_mean_std", f0cwt_mean_std)

        return {
            "info": "|".join([basename, speaker, text, raw_text]),
            "f0": f0 if f0 is not None else np.zeros(0),
            "energy": remove_outlier(energy),
            "n_frames": mel.shape[1],
            "mel_min": mel.min(axis=1),
            "mel_max": mel.max(axis=1),
            "spker_embed": spker_embed,
        }

    def get_f0cwt(self, f0):
        """Per-utterance normalized log-f0 CWT (reference :404-414)."""
        _, cont_lf0 = get_cont_lf0(f0)
        mean, std = np.mean(cont_lf0), np.std(cont_lf0)
        cwt, scales = get_lf0_cwt((cont_lf0 - mean) / std)
        return cwt, scales, np.array([mean, std])

    # -- corpus ------------------------------------------------------------
    def _list_tasks(self):
        """Deterministic (speaker_idx, speaker, basename) work list."""
        speakers: dict[str, int] = {}
        tasks: list[tuple[str, str]] = []
        for i, speaker in enumerate(sorted(os.listdir(self.in_dir))):
            spk_dir = os.path.join(self.in_dir, speaker)
            if not os.path.isdir(spk_dir):
                continue
            speakers[speaker] = i
            for wav_name in sorted(os.listdir(spk_dir)):
                if not wav_name.endswith(".wav"):
                    continue
                basename = wav_name[:-4]
                if os.path.exists(self._tg_path(speaker, basename)):
                    tasks.append((speaker, basename))
        return speakers, tasks

    def _iter_results(self, tasks, save_emb: bool, workers: int):
        """Yield (speaker, basename, ret-or-None) in deterministic task
        order; ``workers > 1`` fans the per-utterance feature extraction
        over a spawn-based process pool (each worker builds its own
        Preprocessor on this one's device; spawn is CUDA-safe, and every
        worker on ``cuda`` opens a CUDA context of its own).
        The reference's loop is serial (preprocessor.py:108-131);
        per-utterance work is embarrassingly parallel (SURVEY §3.4)."""
        if workers <= 1 or self.speaker_embedder is not None:
            if workers > 1:
                print("preprocess: --workers ignored with a speaker "
                      "embedder (the embedder model is not fork-safe); "
                      "running serial")
            for speaker, basename in tasks:
                try:
                    ret = self.process_utterance(speaker, basename, save_emb)
                except (AssertionError, ValueError, KeyError):
                    ret = None
                yield speaker, basename, ret
            return
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        ctx = mp.get_context("spawn")
        with ProcessPoolExecutor(
                max_workers=workers, mp_context=ctx,
                initializer=_init_pp_worker,
                initargs=(self.cfg, self.dataset_type,
                          str(self.device))) as ex:
            for (speaker, basename), ret in zip(
                    tasks, ex.map(_pp_worker_run, tasks, chunksize=8)):
                yield speaker, basename, ret

    def build_from_path(self, workers: int = 1):
        for d in FEATURE_DIRS:
            os.makedirs(os.path.join(self.out_dir, d), exist_ok=True)

        val_prior = self._val_prior_names()
        out, train, val = [], [], []
        filtered = []
        f0s = []
        energy_sum = energy_sq = 0.0
        energy_n = 0
        mel_min = np.full(self.cfg.stft.n_mel_channels, np.inf)
        mel_max = np.full(self.cfg.stft.n_mel_channels, -np.inf)
        max_seq_len = 0
        n_frames_total = 0
        emb_acc: dict[str, list] = {}

        speakers, tasks = self._list_tasks()
        save_emb = self.speaker_embedder is not None
        for speaker, basename, ret in self._iter_results(
                tasks, save_emb, workers):
            if ret is None:
                filtered.append(basename)
                continue
            if val_prior is not None:
                (val if basename in val_prior else train).append(ret["info"])
            else:
                out.append(ret["info"])
            if ret["f0"] is not None and len(ret["f0"]):
                f0s.append(ret["f0"])
            e = ret["energy"]
            if len(e):
                energy_sum += e.sum()
                energy_sq += (e ** 2).sum()
                energy_n += len(e)
            if save_emb and ret["spker_embed"] is not None:
                emb_acc.setdefault(speaker, []).append(ret["spker_embed"])
            mel_min = np.minimum(mel_min, ret["mel_min"])
            mel_max = np.maximum(mel_max, ret["mel_max"])
            max_seq_len = max(max_seq_len, ret["n_frames"])
            n_frames_total += ret["n_frames"]
        for speaker, embs in emb_acc.items():
            np.save(os.path.join(self.out_dir, "spker_embed",
                                 f"{speaker}-spker_embed.npy"),
                    np.mean(embs, axis=0))

        f0_mean = f0_std = 0.0
        if f0s:
            allf0 = np.concatenate(f0s)
            allf0 = allf0[allf0 != 0]
            f0_mean, f0_std = float(allf0.mean()), float(allf0.std())

        if self.energy_normalization and energy_n > 0:
            e_mean = energy_sum / energy_n
            e_std = float(np.sqrt(max(energy_sq / energy_n - e_mean ** 2, 1e-12)))
        else:
            e_mean, e_std = 0.0, 1.0
        e_min, e_max = self._normalize_dir(
            os.path.join(self.out_dir, "energy"), e_mean, e_std)

        with open(os.path.join(self.out_dir, "speakers.json"), "w") as f:
            json.dump(speakers, f)
        with open(os.path.join(self.out_dir, "stats.json"), "w") as f:
            json.dump({
                "f0": [f0_mean, f0_std],
                "energy": [float(e_min), float(e_max), float(e_mean), float(e_std)],
                "spec_min": mel_min.tolist(),
                "spec_max": mel_max.tolist(),
                "max_seq_len": int(max_seq_len),
            }, f)

        if val_prior is not None:
            random.shuffle(train)
        else:
            random.shuffle(out)
            train, val = out[self.val_size:], out[: self.val_size]
        for name, rows in (("train.txt", train), ("val.txt", val),
                           ("filtered_out.txt", sorted(filtered))):
            with open(os.path.join(self.out_dir, name), "w", encoding="utf-8") as f:
                for m in rows:
                    f.write(str(m) + "\n")
        hours = n_frames_total * self.hop / self.sr / 3600
        print(f"preprocessed {len(train)} train / {len(val)} val utterances, "
              f"{hours:.2f} hours")

        if self.speaker_embedder is not None:
            # t-SNE speaker-embedding scatter (reference
            # preprocessor.py:220-225 + utils/tools.py:630-648)
            try:
                from cmtts_tpu_torch.utils_plot import (
                    load_speaker_embeddings, plot_embedding,
                    speaker_gender_map)

                emb, ids = load_speaker_embeddings(
                    os.path.join(self.out_dir, "spker_embed"))
                genders = speaker_gender_map(self.cfg.data.corpus_path,
                                             self.dataset_type)
                p = plot_embedding(self.out_dir, emb, ids, genders)
                if p:
                    print(f"speaker-embedding t-SNE plot -> {p}")
            except Exception as e:  # plotting must never fail the corpus
                print(f"speaker-embedding plot skipped: {e}")
        return train, val

    def _val_prior_names(self):
        path = os.path.join(self.out_dir, "val.txt")
        if os.path.isfile(path):
            with open(path, encoding="utf-8") as f:
                return {line.split("|")[0] for line in f if line.strip()}
        return None

    @staticmethod
    def _normalize_dir(dirname: str, mean: float, std: float):
        vmin, vmax = np.inf, -np.inf
        for fn in os.listdir(dirname):
            p = os.path.join(dirname, fn)
            vals = (np.load(p) - mean) / std
            np.save(p, vals)
            if len(vals):
                vmin = min(vmin, vals.min())
                vmax = max(vmax, vals.max())
        if not np.isfinite(vmin):
            vmin, vmax = 0.0, 1.0
        return vmin, vmax


# -- multiprocessing workers (spawn context) --------------------------------
_PP_WORKER: Preprocessor | None = None


def _init_pp_worker(cfg, dataset_type, device):
    """Pool initializer: a per-process Preprocessor on the parent's
    device."""
    global _PP_WORKER
    _PP_WORKER = Preprocessor(cfg, dataset_type, device=device)


def _pp_worker_run(task):
    speaker, basename = task
    try:
        return _PP_WORKER.process_utterance(speaker, basename, False)
    except (AssertionError, ValueError, KeyError):
        return None


def remove_outlier(values: np.ndarray) -> np.ndarray:
    """IQR outlier filter (reference :416-424)."""
    values = np.asarray(values)
    if values.size == 0:
        return values
    p25, p75 = np.percentile(values, 25), np.percentile(values, 75)
    lower = p25 - 1.5 * (p75 - p25)
    upper = p75 + 1.5 * (p75 - p25)
    return values[(values > lower) & (values < upper)]
