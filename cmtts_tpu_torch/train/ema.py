# Copied from cmtts_tpu/train/ema.py (jax-free) so that the port imports nothing of cmtts_tpu.
"""Target-EMA and scale schedules (reference ``script_util.py:186-246``)."""

from __future__ import annotations

import numpy as np


def create_ema_and_scales_fn(
    target_ema_mode: str,
    start_ema: float,
    scale_mode: str,
    start_scales: int,
    end_scales: int,
    total_steps: int,
    distill_steps_per_iter: int,
):
    """Returns step -> (target_ema, num_scales)."""

    def ema_and_scales_fn(step: int) -> tuple[float, int]:
        if target_ema_mode == "fixed" and scale_mode == "fixed":
            return float(start_ema), int(start_scales)
        if target_ema_mode == "fixed" and scale_mode == "progressive":
            scales = np.ceil(
                np.sqrt((step / total_steps) * ((end_scales + 1) ** 2 - start_scales ** 2)
                        + start_scales ** 2) - 1
            ).astype(np.int64)
            scales = int(np.maximum(scales, 1)) + 1
            return float(start_ema), scales
        if target_ema_mode == "adaptive" and scale_mode == "progressive":
            scales = np.ceil(
                np.sqrt((step / total_steps) * ((end_scales + 1) ** 2 - start_scales ** 2)
                        + start_scales ** 2) - 1
            ).astype(np.int64)
            scales = int(np.maximum(scales, 1))
            c = -np.log(start_ema) * start_scales
            target_ema = float(np.exp(-c / scales))
            return target_ema, scales + 1
        if target_ema_mode == "fixed" and scale_mode == "progdist":
            distill_stage = step // distill_steps_per_iter
            scales = start_scales // (2 ** distill_stage)
            scales = int(np.maximum(scales, 2))
            sub_stage = np.maximum(
                step - distill_steps_per_iter * (np.log2(start_scales) - 1), 0)
            sub_stage = sub_stage // (distill_steps_per_iter * 2)
            sub_scales = 2 // (2 ** int(sub_stage))
            sub_scales = int(np.maximum(sub_scales, 1))
            if scales == 2:
                scales = sub_scales
            return 1.0, scales
        raise NotImplementedError(f"{target_ema_mode}/{scale_mode}")

    return ema_and_scales_fn
