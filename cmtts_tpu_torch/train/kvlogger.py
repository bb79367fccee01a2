# Copied from cmtts_tpu/train/kvlogger.py (jax-free) so that the port imports nothing of cmtts_tpu.
"""Key-value training logger (reference ``model/cm_tool/logger.py`` semantics).

Supports logkv / logkv_mean accumulation and multi-sink dumping
(stdout table, CSV, JSONL); sink selection via ``CMTTS_LOG_FORMAT``
(comma list, default "stdout,csv") and directory via configure().
TensorBoard is attached when the package is importable.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any


class KVLogger:
    def __init__(self, log_dir: str | None = None, formats: list[str] | None = None):
        self.log_dir = log_dir
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        if formats is None:
            formats = os.environ.get("CMTTS_LOG_FORMAT", "stdout,csv").split(",")
        self.formats = [f.strip() for f in formats if f.strip()]
        self._kv: dict[str, float] = {}
        self._counts: dict[str, int] = defaultdict(int)
        self._csv_file = None
        self._csv_keys: list[str] = []
        self._jsonl_file = None
        self._tb = None
        self._profile_starts: dict[str, float] = {}
        if log_dir and "csv" in self.formats:
            self._csv_path = os.path.join(log_dir, "progress.csv")
        if log_dir and "jsonl" in self.formats:
            self._jsonl_file = open(os.path.join(log_dir, "progress.jsonl"), "a")
        if log_dir and "tensorboard" in self.formats:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    # -- accumulation (logger.py:36-209 semantics) --------------------------
    def logkv(self, key: str, val: Any) -> None:
        self._kv[key] = float(val)
        self._counts[key] = 1

    def logkv_mean(self, key: str, val: Any) -> None:
        cnt = self._counts[key]
        if key in self._kv and cnt > 0:
            self._kv[key] = (self._kv[key] * cnt + float(val)) / (cnt + 1)
        else:
            self._kv[key] = float(val)
        self._counts[key] = cnt + 1

    @contextmanager
    def profile(self, scope: str):
        """Wall-time scope accumulated as wait_<scope>
        (logger.py:292-316)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.logkv_mean(f"wait_{scope}", time.perf_counter() - t0)

    # -- dumping ------------------------------------------------------------
    def dumpkvs(self) -> dict[str, float]:
        kv = dict(self._kv)
        if not kv:
            return kv
        step = int(kv.get("step", 0))
        if "stdout" in self.formats:
            keys = sorted(kv)
            width = max(len(k) for k in keys)
            lines = ["-" * (width + 16)]
            for k in keys:
                lines.append(f"| {k:<{width}} | {kv[k]:<10.5g} |")
            lines.append("-" * (width + 16))
            print("\n".join(lines), flush=True)
        if self.log_dir and "csv" in self.formats:
            self._write_csv(kv)
        if self._jsonl_file is not None:
            self._jsonl_file.write(json.dumps(
                {"time": datetime.datetime.now().isoformat(), **kv}) + "\n")
            self._jsonl_file.flush()
        if self._tb is not None:
            for k, v in kv.items():
                self._tb.add_scalar(k, v, step)
        self._kv.clear()
        self._counts.clear()
        return kv

    def _write_csv(self, kv: dict) -> None:
        new_keys = [k for k in kv if k not in self._csv_keys]
        if new_keys:
            self._csv_keys.extend(sorted(new_keys))
            # rewrite with extended header
            rows = []
            if os.path.exists(self._csv_path):
                with open(self._csv_path) as f:
                    lines = f.read().splitlines()
                if lines:
                    old_keys = lines[0].split(",")
                    for line in lines[1:]:
                        vals = line.split(",")
                        rows.append(dict(zip(old_keys, vals)))
            with open(self._csv_path, "w") as f:
                f.write(",".join(self._csv_keys) + "\n")
                for row in rows:
                    f.write(",".join(row.get(k, "") for k in self._csv_keys) + "\n")
        with open(self._csv_path, "a") as f:
            f.write(",".join(str(kv.get(k, "")) for k in self._csv_keys) + "\n")

    # -- rich summaries (reference utils/tools.py:610-687 figure/audio
    # logging; no-ops unless the tensorboard sink is active) ----------------
    @property
    def has_tb(self) -> bool:
        return self._tb is not None

    def log_figure(self, tag: str, fig, step: int) -> None:
        """Log a matplotlib figure (closes it)."""
        if self._tb is not None:
            self._tb.add_figure(tag, fig, step, close=True)

    def log_audio(self, tag: str, wav, sample_rate: int, step: int) -> None:
        """Log a mono waveform (float array in [-1, 1])."""
        if self._tb is not None:
            import numpy as _np

            w = _np.asarray(wav, _np.float32).reshape(1, -1)
            self._tb.add_audio(tag, w, step, sample_rate=sample_rate)

    def close(self):
        if self._jsonl_file:
            self._jsonl_file.close()
        if self._tb:
            self._tb.close()


_GLOBAL: KVLogger | None = None


def configure(log_dir: str | None = None, formats: list[str] | None = None) -> KVLogger:
    global _GLOBAL
    _GLOBAL = KVLogger(log_dir, formats)
    return _GLOBAL


def get_logger() -> KVLogger:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = KVLogger()
    return _GLOBAL
