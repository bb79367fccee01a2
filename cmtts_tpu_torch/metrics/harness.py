# Copied from cmtts_tpu/metrics/harness.py with the port's imports; speaker_cos and the
# predicted-MOS nets run on the harness's device, and wer needs a transcriber passed in
# (none is probed or downloaded).
"""Metric harness: ``Cal`` (one results folder) and ``CalOneModel``
(iterate checkpoint-step folders, CSV accumulation) — reference
``all_metrics.py:34-846``.
"""

from __future__ import annotations

import csv
import os
import os.path as osp
import re

import numpy as np

from cmtts_tpu_torch.metrics import core
from cmtts_tpu_torch.metrics.features import SR, load_wav


class Cal:
    """Per-results-folder metric calculator.

    Matches synthesized wavs to raw references by basename: VCTK-style
    ``<speaker>-...wav`` files live under ``raw_folder/<speaker>/``,
    LJSpeech-style files directly under ``raw_folder``
    (all_metrics.py:129-145).
    """

    def __init__(self, syn_folder: str, data_type: str = "VCTK",
                 raw_folder: str = "", sampling_rate: int = SR,
                 speaker_embedder=None, transcriber=None,
                 text_lookup=None, meta_txt=None,
                 max_pairs: int | None = None,
                 mos_ckpt: str | None = None, ld_ckpt: str | None = None,
                 ld_config: str | None = None, device=None):
        self.syn_folder = syn_folder
        self.raw_folder = raw_folder
        self.data_type = data_type
        self.sr = sampling_rate
        self.speaker_embedder = speaker_embedder
        self.device = device
        # transcriber: callable, or a local whisper-weights path (str)
        self.transcriber = core.make_transcriber(transcriber)
        self.text_lookup = dict(text_lookup or {})
        # reference fill_base_name2text (all_metrics.py:233-254):
        # train/val.txt lines `basename|speaker|{phones}|raw_text`
        for path in (meta_txt or []):
            with open(path) as f:
                for line in f:
                    # maxsplit keeps raw_text intact when it contains '|'
                    parts = line.strip().split("|", 3)
                    if len(parts) >= 4:
                        self.text_lookup.setdefault(parts[0], parts[3])
        self.mos_ckpt = mos_ckpt
        self.ld_ckpt = ld_ckpt
        self.ld_config = ld_config
        self._mos_tool = None
        self.syn2label = self._init_file_match()
        if max_pairs:
            self.syn2label = dict(list(self.syn2label.items())[:max_pairs])
        self._wav_cache: dict[str, np.ndarray] = {}

    def _init_file_match(self) -> dict[str, str]:
        match = {}
        names = [f for f in sorted(os.listdir(self.syn_folder))
                 if f.endswith(".wav") and not f.endswith("_16000.wav")]
        for name in names:
            syn = osp.join(self.syn_folder, name)
            if self.data_type in ("VCTK", "LibriTTS"):
                # speaker-subdir layouts: VCTK `p225_001.wav` -> p225,
                # LibriTTS `84_121123_000007_000001.wav` -> 84
                spk = name.split("-")[0].split("_")[0]
                raw = osp.join(self.raw_folder, spk, name)
            elif self.data_type == "LJSpeech":
                raw = osp.join(self.raw_folder, name)
            else:
                raise NotImplementedError(self.data_type)
            if osp.exists(raw):
                match[syn] = raw
        return match

    def _wav(self, path: str) -> np.ndarray:
        if path not in self._wav_cache:
            self._wav_cache[path] = load_wav(path, self.sr)
        return self._wav_cache[path]

    def _pair_mean(self, fn) -> float:
        vals = [fn(self._wav(s), self._wav(r))
                for s, r in self.syn2label.items()]
        return float(np.nanmean(np.asarray(vals, dtype=np.float64)))

    # -- metric entry points (compute_<name> dispatch) ----------------------
    def compute_mcd(self):
        return self._pair_mean(lambda s, r: core.mcd_dtw(s, r, self.sr))

    def compute_mcd_dctmel(self):
        return self._pair_mean(lambda s, r: core.mcd_dctmel(s, r, self.sr))

    def compute_mcd24(self):
        tot_cost, tot_frames = 0.0, 0
        for s, r in self.syn2label.items():
            cost, frames = core.mcd24(self._wav(s), self._wav(r), self.sr)
            tot_cost += cost
            tot_frames += frames
        return tot_cost / max(tot_frames, 1)

    def compute_f0_rmse(self):
        return self._pair_mean(lambda s, r: core.f0_rmse(s, r, self.sr))

    def compute_f0_corr(self):
        return self._pair_mean(lambda s, r: core.f0_corr(s, r, self.sr))

    def compute_log_f0(self):
        return self._pair_mean(lambda s, r: core.log_f0_mcep(s, r, self.sr))

    def compute_ffe(self):
        return self._pair_mean(lambda s, r: core.ffe(r, s, self.sr))

    def compute_ssim(self):
        pairs, maxs, mins = [], [], []
        for s, r in self.syn2label.items():
            a1, a2 = core.aligned_norm_mfcc(self._wav(s), self._wav(r), self.sr)
            pairs.append((a1, a2))
            maxs.append(max(a1.max(), a2.max()))
            mins.append(min(a1.min(), a2.min()))
        data_range = max(maxs) - min(mins)
        return float(np.mean([core.ssim_2d(a, b, data_range)
                              for a, b in pairs]))

    def compute_si_sdr(self):
        vals = [core.si_sdr(self._wav(s), self._wav(r))
                for s, r in list(self.syn2label.items())[:10]]
        return float(np.mean(vals))

    def compute_mfcc_cos(self):
        return self._pair_mean(lambda s, r: core.mfcc_cos(s, r, self.sr))

    def compute_mfcc_gmm_kl(self):
        from cmtts_tpu_torch.metrics.features import mfcc

        def pair_kl(s, r):
            ft = mfcc(r, self.sr).T
            fp = mfcc(s, self.sr).T
            ft = ft / (np.linalg.norm(ft, axis=0, keepdims=True) + 1e-12)
            fp = fp / (np.linalg.norm(fp, axis=0, keepdims=True) + 1e-12)
            return core.gmm_kl(ft, fp)

        return self._pair_mean(pair_kl)

    def compute_speaker_cos(self):
        return self._pair_mean(
            lambda s, r: core.speaker_cos(s, r, self.speaker_embedder,
                                          self.device))

    def _fid(self, feature_type: str):
        gen = core.frame_features(list(self.syn2label.keys()), feature_type,
                                  self.sr)
        ref = core.frame_features(list(self.syn2label.values()), feature_type,
                                  self.sr)
        return core.frechet_distance(gen, ref)

    def compute_fid_mel(self):
        return self._fid("mel")

    def compute_fid_mfcc(self):
        return self._fid("mfcc")

    def compute_fid_mfcc_un_norm(self):
        return self._fid("mfcc_un_norm")

    def _precision_recall(self, feature_type: str):
        gen = core.frame_features(list(self.syn2label.keys()), feature_type,
                                  self.sr, max_frames_per_file=100)
        ref = core.frame_features(list(self.syn2label.values()), feature_type,
                                  self.sr, max_frames_per_file=100)
        return core.manifold_precision_recall(gen, ref)

    def compute_precision_mel(self):
        return self._precision_recall("mel")[0]

    def compute_precision_mfcc(self):
        return self._precision_recall("mfcc")[0]

    def compute_recall_mel(self):
        return self._precision_recall("mel")[1]

    def compute_recall_mfcc(self):
        return self._precision_recall("mfcc")[1]

    def compute_wer(self):
        """Corpus-level WER (sum edits / sum ref words, matching
        jiwer.wer over lists, all_metrics.py:275-280); also writes the
        reference's ``Awer_output.txt`` transcript dump next to the
        synthesized wavs (all_metrics.py:271-274)."""
        if self.transcriber is None:
            raise RuntimeError(
                "no ASR given: pass transcriber=<callable or local "
                "whisper-weights directory> to Cal (core.make_transcriber)")
        total_edits, total_ref = 0, 0
        lines = []
        for syn in self.syn2label:
            base = osp.splitext(osp.basename(syn))[0]
            ref_text = self.text_lookup.get(base)
            if ref_text is None:
                continue
            hyp = self.transcriber(self._wav(syn), self.sr)
            edits, n_ref = core.wer_counts(ref_text, hyp)
            total_edits += edits
            total_ref += n_ref
            lines += [f"ref {ref_text}", f"hyp {hyp}"]
        if total_ref == 0:
            raise RuntimeError("no reference transcripts matched; pass "
                               "text_lookup={basename: text} or "
                               "meta_txt= paths")
        with open(osp.join(self.syn_folder, "Awer_output.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        return total_edits / total_ref

    compute_wer_un_comma = compute_wer

    # -- predicted MOS (all_metrics.py:506-532) ------------------------------
    def _mos(self):
        if self._mos_tool is None:
            from cmtts_tpu_torch.metrics.mos import MOSCal

            self._mos_tool = MOSCal(sample_rate=self.sr,
                                    mb_ckpt=self.mos_ckpt,
                                    ld_ckpt=self.ld_ckpt,
                                    ld_config=self.ld_config,
                                    device=self.device)
        return self._mos_tool

    def compute_mb_mos(self):
        tool = self._mos()
        return float(np.mean([tool.get_mb_mos(self._wav(s))
                              for s in self.syn2label]))

    def compute_ld_mos(self):
        tool = self._mos()
        return float(np.mean([tool.get_ld_mos(self._wav(s))
                              for s in self.syn2label]))

    def get_target_mos(self, mos_type: str = "mb"):
        tool = self._mos()
        fn = tool.get_mb_mos if mos_type == "mb" else tool.get_ld_mos
        return float(np.mean([fn(self._wav(r))
                              for r in self.syn2label.values()]))

    # -- list dispatch (all_metrics.py:735-739) ------------------------------
    def get_metrics_by_list(self, names: list[str]) -> list[float]:
        return [getattr(self, "compute_" + n)() for n in names]


class CalOneModel:
    """Iterate checkpoint-step result subfolders and accumulate a CSV
    (all_metrics.py:745-824)."""

    def __init__(self, folder_path: str, raw_folder: str = "",
                 data_type: str = "VCTK", file_find_type: str | None = None,
                 key_steps=(100000, 200000, 300000), **cal_kwargs):
        self.folder_path = folder_path
        self.raw_folder = raw_folder
        self.data_type = data_type
        self.cal_kwargs = cal_kwargs
        if file_find_type is None:
            # accept both the reference's bare numeric step dirs and this
            # framework's `step_<n>_T<k>` synthesis dirs
            subs = [osp.join(folder_path, d) for d in os.listdir(folder_path)
                    if osp.isdir(osp.join(folder_path, d))
                    and self._dir_key(d) is not None]
        elif file_find_type == "key_step":
            subs = [osp.join(folder_path, str(s)) for s in key_steps]
        elif file_find_type == "only_end":
            subs = [osp.join(folder_path, str(key_steps[-1]))]
        else:
            raise NotImplementedError(file_find_type)
        self.subdirectories = sorted(
            subs, key=lambda p: self._dir_key(osp.basename(p)) or (0, 0))

    @staticmethod
    def _dir_key(name: str):
        """(step, T) sort key for `300000` / `step_300000_T1` dir names;
        None when the name is neither layout."""
        if name.isdigit():
            return (int(name), 0)
        m = re.fullmatch(r"step_(\d+)_T(\d+)", name)
        return (int(m.group(1)), int(m.group(2))) if m else None

    def get_model_metrics_by_list(self, names: list[str]) -> str:
        rows = []
        csv_path = osp.join(self.folder_path,
                            "metrics_" + "_".join(names) + ".csv")
        kwargs = dict(self.cal_kwargs)
        mos_tool = None
        for sub in self.subdirectories:
            cal = Cal(syn_folder=sub, data_type=self.data_type,
                      raw_folder=self.raw_folder, **kwargs)
            # share the expensive lazily-built tools across step dirs:
            # the resolved ASR callable and the jitted/converted MOS
            # models load once, not once per subdirectory
            kwargs["transcriber"] = cal.transcriber
            if mos_tool is not None:
                cal._mos_tool = mos_tool
            rows.append([osp.basename(sub)] + cal.get_metrics_by_list(names))
            mos_tool = cal._mos_tool or mos_tool
            # write after every step so a crash keeps partial results
            with open(csv_path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["train_step"] + names)
                for row in sorted(rows, key=lambda r: CalOneModel._dir_key(str(r[0])) or (0, 0)):
                    w.writerow(row)
        return csv_path
