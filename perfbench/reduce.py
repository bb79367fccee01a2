"""Reductions that several metric readers share (each reader in
``metrics/`` names its own unit, source, layer and the end-to-end metric it
moves)."""

from __future__ import annotations

import numpy as np

from perfbench.flops import PEAK_FLOPS


def latencies_ms(run) -> np.ndarray:
    return np.array([(c["t1"] - c["t0"]) * 1e3 for c in run.calls])


def mrf_roofline_pct(run):
    """The MRF stages' least time (their bound from shapes, every call of
    the window) over the device time of the MRF kernels in the trace."""
    if run.trace is None or "mrf_bound_s" not in run.extra:
        return None
    t = run.trace.device_s(lambda n: "mrf_" in n)
    return None if t <= 0 else 100.0 * run.extra["mrf_bound_s"] / t


def mfu_pct(run, dtype: str = "bfloat16"):
    """Every FLOP of the window's calls over the window's wall time at the
    card's peak, summed over the cards used; nothing where the trace saw
    no device work (a run on the CPU)."""
    if run.trace is None or "flop" not in run.extra or run.trace.busy_s <= 0:
        return None
    return 100.0 * run.extra["flop"] / (run.window_s * PEAK_FLOPS[dtype]
                                        * run.chips)


def idle_pct(run):
    """Share of the traced window in which no operation ran on the
    device."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def device_ms_per(run, unit: str = "calls"):
    """Device-busy milliseconds in the traced window per timed call
    (``unit="calls"``) or per training step (``"steps"``): a statistic of
    the device's work that the host clock's noise does not reach."""
    if run.trace is None or run.trace.busy_s <= 0 or not run.calls:
        return None
    n = (sum(c["steps"] for c in run.calls) if unit == "steps"
         else len(run.calls))
    return 1e3 * run.trace.busy_s / n
