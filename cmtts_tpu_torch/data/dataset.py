# Copied from cmtts_tpu/data/dataset.py (jax-free) so that the port imports nothing of cmtts_tpu;
# get_many loads through the port's native npy loader (data/native_loader.py), and
# prefetch_iterator follows cmtts_tpu/data/native_loader.py and also hands the
# producer's exception to the consumer.
"""Training/inference datasets over preprocessed per-utterance npy features.

Feature layout parity with the reference preprocessor output
(``dataset.py:47-137``): ``<root>/{mel,pitch,f0,energy,duration,mel2ph,
cwt_spec,f0cwt_mean_std,spker_embed}/<speaker>-<kind>-<basename>.npy`` and
metadata lines ``basename|speaker|{phones}|raw_text``.

TPU-first batching: the reference's length-sorted mega-batch collate
(``dataset.py:215-234``, group_size=4) is reproduced, but every emitted
batch is padded to static (text-bucket, mel-bucket) shapes so XLA
compiles a handful of graphs instead of one per unique length.
"""

from __future__ import annotations

import json
import os
import threading
from queue import Full, Queue
from typing import Iterator, Sequence

import numpy as np

from cmtts_tpu_torch.core.config import Config
from cmtts_tpu_torch.core.masks import (
    DEFAULT_MEL_BUCKETS,
    DEFAULT_TEXT_BUCKETS,
    pad_to,
    pick_bucket,
)
from cmtts_tpu_torch.audio.pitch import norm_interp_f0
from cmtts_tpu_torch.text import text_to_sequence


class FeatureDataset:
    def __init__(self, filename: str, cfg: Config, sort: bool = True,
                 drop_last: bool = True, cache_in_ram: bool | None = None):
        """``cache_in_ram`` keeps assembled samples (post np.load /
        text_to_sequence / f0-interp) in memory after first access — the
        training loop re-reads the whole corpus every epoch, and on a
        host with few cores the per-epoch reload becomes the train-step
        feed bottleneck (device idles).  Safe because collate_batch never
        mutates sample arrays (pad_to/np.stack copy).  Default: auto —
        on when the corpus is at most CMTTS_DATA_CACHE_MAX samples
        (16384 ≈ 4 GB for LJSpeech-scale features), off otherwise.
        The reference has no equivalent (its DataLoader re-reads npy
        files per epoch, reference dataset.py:47-137)."""
        self.cfg = cfg
        self.root = cfg.data.preprocessed_path
        self.cleaners = list(cfg.data.text_cleaners)
        self.sort = sort
        self.drop_last = drop_last
        self.load_spker_embed = (
            cfg.model.multi_speaker and cfg.model.speaker_embedder != "none")
        self.pitch_type = cfg.pitch.pitch_type

        self.basename, self.speaker, self.text, self.raw_text = \
            self._process_meta(os.path.join(self.root, filename))
        with open(os.path.join(self.root, "speakers.json")) as f:
            self.speaker_map = json.load(f)

        if cache_in_ram is None:
            cache_in_ram = len(self.text) <= int(
                os.environ.get("CMTTS_DATA_CACHE_MAX", "16384"))
        self._ram: dict[int, dict] | None = {} if cache_in_ram else None

    @staticmethod
    def _process_meta(path: str):
        names, speakers, texts, raws = [], [], [], []
        with open(path, encoding="utf-8") as f:
            for line in f:
                n, s, t, r = line.rstrip("\n").split("|")
                names.append(n)
                speakers.append(s)
                texts.append(t)
                raws.append(r)
        return names, speakers, texts, raws

    def __len__(self) -> int:
        return len(self.text)

    def _feat_path(self, kind: str, idx: int) -> str:
        return os.path.join(self.root, kind,
                            f"{self.speaker[idx]}-{kind}-{self.basename[idx]}.npy")

    _BULK_KINDS = ("mel", "pitch", "f0", "energy", "duration", "mel2ph")

    def _kinds(self) -> list[str]:
        kinds = list(self._BULK_KINDS)
        if self.pitch_type == "cwt":
            kinds += ["cwt_spec", "f0cwt_mean_std"]
        return kinds

    def get_many(self, indices) -> list[dict]:
        """Load several samples with the native parallel npy loader
        (serial np.load when it cannot be built); RAM-cached when
        enabled."""
        if self._ram is not None:
            missing = [i for i in indices if i not in self._ram]
            if missing:
                for i, s in zip(missing, self._load_many(missing)):
                    self._ram[i] = s
            # shallow dict copy: callers may add keys, arrays are shared
            # and never mutated downstream (collate_batch copies)
            return [dict(self._ram[i]) for i in indices]
        return self._load_many(indices)

    def _load_many(self, indices) -> list[dict]:
        from cmtts_tpu_torch.data.native_loader import (
            NativeNpyLoader,
            native_available,
        )

        if not native_available():
            return [self._load_one(i) for i in indices]
        if not hasattr(self, "_native"):
            self._native = NativeNpyLoader()
        kinds = self._kinds()
        paths = [self._feat_path(k, i) for i in indices for k in kinds]
        arrays = self._native.load(paths)
        return [self._assemble(idx, dict(zip(
            kinds, arrays[si * len(kinds):(si + 1) * len(kinds)])))
            for si, idx in enumerate(indices)]

    def __getitem__(self, idx: int) -> dict:
        if self._ram is not None:
            if idx not in self._ram:
                self._ram[idx] = self._load_one(idx)
            return dict(self._ram[idx])
        return self._load_one(idx)

    def _load_one(self, idx: int) -> dict:
        return self._assemble(idx, {k: np.load(self._feat_path(k, idx))
                                    for k in self._kinds()})

    def _assemble(self, idx: int, feats: dict) -> dict:
        basename = self.basename[idx]
        speaker = self.speaker[idx]
        phone = np.asarray(
            text_to_sequence(self.text[idx], self.cleaners), dtype=np.int32)
        mel = feats["mel"].astype(np.float32)
        if mel.shape[0] == self.cfg.stft.n_mel_channels and \
                mel.shape[0] != mel.shape[1]:
            mel = mel.T  # stored (n_mels, T) -> (T, n_mels)
        f0, uv = norm_interp_f0(feats["f0"], self.cfg.pitch)
        duration = feats["duration"].astype(np.int32)
        mel2ph = feats["mel2ph"].astype(np.int32)

        if len(phone) != len(duration) or (len(mel2ph) and
                                           mel2ph.max() > len(phone)):
            # a tokenized-text / alignment length mismatch poisons the
            # mel2ph gather for the WHOLE batch (out-of-bounds indices) —
            # fail loudly naming the utterance instead
            raise ValueError(
                f"{basename}: tokenized text has {len(phone)} phones but "
                f"duration has {len(duration)} (mel2ph max "
                f"{int(mel2ph.max()) if len(mel2ph) else 0}) — the metadata "
                "text and the alignment features are out of sync; "
                "re-run preprocessing")

        sample = {
            "id": basename,
            "speaker": self.speaker_map[speaker],
            "text": phone,
            "raw_text": self.raw_text[idx],
            "mel": mel,
            "pitch": feats["pitch"].astype(np.int32),
            "f0": f0.astype(np.float32),
            "uv": uv.astype(np.float32),
            "energy": feats["energy"].astype(np.float32),
            "duration": duration,
            "mel2ph": mel2ph,
        }
        if self.pitch_type == "cwt":
            sample["cwt_spec"] = feats["cwt_spec"].astype(np.float32)
            ms = feats["f0cwt_mean_std"]
            sample["f0_mean"] = float(ms[0])
            sample["f0_std"] = float(ms[1])
        if self.load_spker_embed:
            sample["spker_embed"] = np.load(os.path.join(
                self.root, "spker_embed", f"{speaker}-spker_embed.npy"
            )).astype(np.float32).reshape(-1)
        return sample


def collate_batch(samples: Sequence[dict], cfg: Config,
                  text_buckets=DEFAULT_TEXT_BUCKETS,
                  mel_buckets=DEFAULT_MEL_BUCKETS) -> dict:
    """Pad a list of samples to static bucket shapes -> model batch dict."""
    t_txt = pick_bucket(max(len(s["text"]) for s in samples), text_buckets)
    t_mel = pick_bucket(max(s["mel"].shape[0] for s in samples), mel_buckets)
    B = len(samples)

    def stack1(key, dtype, target):
        return np.stack([pad_to(np.asarray(s[key], dtype), target) for s in samples])

    batch = {
        "ids": [s["id"] for s in samples],
        "raw_texts": [s["raw_text"] for s in samples],
        "speakers": np.asarray([s["speaker"] for s in samples], np.int32),
        "texts": stack1("text", np.int32, t_txt),
        "src_lens": np.asarray([len(s["text"]) for s in samples], np.int32),
        "mels": np.stack([pad_to(s["mel"], t_mel) for s in samples]),
        "mel_lens": np.asarray([s["mel"].shape[0] for s in samples], np.int32),
        "d_targets": stack1("duration", np.int32, t_txt),
        "e_targets": stack1("energy", np.float32, t_txt)
        if cfg.energy.feature == "phoneme_level" else stack1("energy", np.float32, t_mel),
        "mel2ph": stack1("mel2ph", np.int32, t_mel),
    }
    p_targets = {
        "pitch": stack1("pitch", np.int32, t_mel),
        "f0": stack1("f0", np.float32, t_mel),
        "uv": stack1("uv", np.float32, t_mel),
    }
    if cfg.pitch.pitch_type == "cwt":
        p_targets["cwt_spec"] = np.stack(
            [pad_to(s["cwt_spec"], t_mel) for s in samples])
        p_targets["f0_mean"] = np.asarray([s["f0_mean"] for s in samples], np.float32)
        p_targets["f0_std"] = np.asarray([s["f0_std"] for s in samples], np.float32)
    batch["p_targets"] = p_targets
    if "spker_embed" in samples[0]:
        batch["spker_embeds"] = np.stack([s["spker_embed"] for s in samples])
    return batch


def batch_iterator(
    dataset: FeatureDataset,
    batch_size: int,
    group_size: int = 4,
    shuffle: bool = True,
    seed: int = 0,
    text_buckets=DEFAULT_TEXT_BUCKETS,
    mel_buckets=DEFAULT_MEL_BUCKETS,
    epochs: int | None = None,
) -> Iterator[dict]:
    """Length-sorted mega-batch iterator (reference train_cm.py:31-39 +
    dataset.py:215-234): draw batch_size*group_size samples, sort by text
    length, split into group_size real batches, bucket-pad each."""
    rng = np.random.RandomState(seed)
    n = len(dataset)
    mega = batch_size * group_size
    if mega > n:
        # reference guards this with an assert (train_cm.py:33); without it
        # the drop_last loop would yield nothing and spin forever
        raise ValueError(
            f"batch_size*group_size = {mega} exceeds dataset size {n}")
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, n - mega + 1, mega):
            chunk = order[start : start + mega]
            samples = dataset.get_many(list(chunk))
            lens = np.asarray([len(s["text"]) for s in samples])
            sorted_idx = np.argsort(-lens)
            for g in range(group_size):
                part = sorted_idx[g * batch_size : (g + 1) * batch_size]
                yield collate_batch([samples[i] for i in part], dataset.cfg,
                                    text_buckets, mel_buckets)
        epoch += 1


class TextMetaDataset:
    """Inference-only dataset: metadata lines -> (id, speaker, phones,
    raw, spker_embed) (reference TextDataset, dataset.py:237-296)."""

    def __init__(self, filepath: str, cfg: Config):
        self.cfg = cfg
        self.cleaners = list(cfg.data.text_cleaners)
        self.root = cfg.data.preprocessed_path
        self.load_spker_embed = (
            cfg.model.multi_speaker and cfg.model.speaker_embedder != "none")
        self.basename, self.speaker, self.text, self.raw_text = \
            FeatureDataset._process_meta(filepath)
        with open(os.path.join(self.root, "speakers.json")) as f:
            self.speaker_map = json.load(f)

    def __len__(self):
        return len(self.text)

    def __getitem__(self, idx: int):
        phone = np.asarray(
            text_to_sequence(self.text[idx], self.cleaners), dtype=np.int32)
        spker_embed = None
        if self.load_spker_embed:
            spker_embed = np.load(os.path.join(
                self.root, "spker_embed",
                f"{self.speaker[idx]}-spker_embed.npy"
            )).astype(np.float32).reshape(-1)
        return (self.basename[idx], self.speaker_map[self.speaker[idx]],
                phone, self.raw_text[idx], spker_embed)

    def batches(self, batch_size: int):
        for start in range(0, len(self), batch_size):
            items = [self[i] for i in range(start, min(start + batch_size, len(self)))]
            yield {
                "ids": [x[0] for x in items],
                "speakers": np.asarray([x[1] for x in items], np.int32),
                "tokens": [x[2] for x in items],
                "raw_texts": [x[3] for x in items],
                "spker_embeds": (np.stack([x[4] for x in items])
                                 if items[0][4] is not None else None),
            }


def prefetch_iterator(make_iterator, depth: int = 2):
    """Run a batch iterator on a background thread with a bounded queue —
    overlaps host-side file IO/collation with device steps (the
    reference's DataLoader(num_workers) role).  An exception in the
    producer is raised to the consumer; closing the consumer stops the
    producer."""
    q: Queue = Queue(maxsize=depth)
    end = object()
    stop = threading.Event()
    errors: list[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except Full:
                pass
        return False

    def producer():
        try:
            for item in make_iterator():
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
            errors.append(e)
        put(end)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if errors:
                    raise errors[0]
                return
            yield item
    finally:
        stop.set()
        t.join(timeout=10)
