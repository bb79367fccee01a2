"""What the program recorded about itself while the traced window's
profiler ran: :func:`cmtts_tpu_torch.core.trace.traced`, its spans' number
and host nanoseconds (``<span>``, ``<span>.ns``) and its counts.  The
profiler runs over the window alone, so these are the window's.  A program
without that registry gives nothing, and its readers read nothing.

The host milliseconds are those of the traced run, which carry the
profiler's cost of each op launched inside the span (a traced CT step
takes about 2.2 times its untraced host time, at about 4,600 ops a step).
So they follow the number of ops a part launches more than its Python
work: a change that cuts Python work but not ops barely moves them.
``device_ms_per_step.train`` and the untraced end-to-end rate confirm a
host-side gain."""

from __future__ import annotations


def traced() -> dict | None:
    try:
        from cmtts_tpu_torch.core import trace
    except ImportError:
        return None
    return trace.traced()


def span_ms_per(run, name: str, unit: str = "calls"):
    """Host milliseconds inside the program's span ``name`` a timed call
    (``unit="calls"``) or a training step (``"steps"``) of the window."""
    rec = traced() if run.trace is not None and run.calls else None
    if not rec or not rec.get(name):
        return None
    n = (sum(c["steps"] for c in run.calls) if unit == "steps"
         else len(run.calls))
    return rec[name + ".ns"] / 1e6 / n


def mean_span_ms(run, name: str):
    """Mean host milliseconds of one of the window's ``name`` spans."""
    rec = traced() if run.trace is not None else None
    if not rec or not rec.get(name):
        return None
    return rec[name + ".ns"] / 1e6 / rec[name]


def count_pct(run, part: str, whole: str):
    """100 x the window's count ``part`` over its count ``whole``."""
    rec = traced() if run.trace is not None else None
    if not rec or not rec.get(whole):
        return None
    return 100.0 * rec.get(part, 0) / rec[whole]
