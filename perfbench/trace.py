"""The traced window: ``torch.profiler`` (CUPTI) over the window, with the
benchmark's own spans as ``record_function`` annotations named
``bench.<span>``, reduced to device busy time, device time by kernel name
and the idle gaps by the span the host was in."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np

SPAN_PREFIX = "bench."


@dataclass
class Trace:
    names: list          # device operation names
    start: np.ndarray    # ns
    dur: np.ndarray      # ns
    spans: list          # (name, start_ns, end_ns) of the benchmark's spans
    window_s: float
    steps: int = 0

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union of
        the device operations' intervals."""
        if not len(self.start):
            return 0.0
        order = np.argsort(self.start)
        s, e = self.start[order], (self.start + self.dur)[order]
        ends = np.maximum.accumulate(e)
        gaps = np.maximum(s[1:] - ends[:-1], 0)
        return float((ends[-1] - s[0] - gaps.sum()) / 1e9)

    def device_s(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        sel = np.fromiter((bool(match(n)) for n in self.names), bool,
                          len(self.names))
        return float(self.dur[sel].sum() / 1e9)

    def count(self, match) -> int:
        return sum(1 for n in self.names if match(n))

    def by_name(self):
        tot = {}
        for n, d in zip(self.names, self.dur):
            tot[n] = tot.get(n, 0) + int(d)
        return sorted(tot.items(), key=lambda kv: -kv[1])

    def idle_gaps(self):
        """[(span the host was in, gap ns)] of every gap between device
        operations inside the first and last span, longest first."""
        if len(self.start) < 2:
            return []
        order = np.argsort(self.start)
        s, e = self.start[order], (self.start + self.dur)[order]
        ends = np.maximum.accumulate(e)
        gap = s[1:] - ends[:-1]
        idx = np.nonzero(gap > 0)[0]
        spans = sorted(self.spans, key=lambda t: t[1])
        starts = np.array([t[1] for t in spans], dtype=np.int64)
        out = []
        for i in idx[np.argsort(-gap[idx])][:200]:
            mid = ends[i] + gap[i] // 2
            j = np.searchsorted(starts, mid, side="right") - 1
            name = "outside spans"
            if j >= 0 and spans[j][2] >= mid:
                name = spans[j][0]
            elif j >= 0:
                name = f"after {spans[j][0]}"
            out.append((name, int(gap[i])))
        return out

    def breakdown(self) -> dict:
        ops = [[n[:120], d / 1e9] for n, d in self.by_name()[:10]]
        gaps = [[n, g / 1e9] for n, g in self.idle_gaps()[:10]]
        return {"device_ops": ops, "idle_gaps": gaps}


class Tracer:
    """``with Tracer(on) as tr: ... tr.span(name)`` -- spans cost nothing
    when ``on`` is false; ``tr.result(window_s)`` reduces the trace."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(SPAN_PREFIX + name)

    def result(self, window_s: float) -> Trace:
        names, start, dur, spans = [], [], [], []
        for ev in self.prof.profiler.kineto_results.events():
            name = ev.name()
            if str(ev.device_type()).endswith("CPU"):
                if name.startswith(SPAN_PREFIX):
                    s = ev.start_ns()
                    spans.append((name[len(SPAN_PREFIX):], s,
                                  s + ev.duration_ns()))
                continue
            if getattr(ev, "is_user_annotation", lambda: False)() or \
                    name.startswith(SPAN_PREFIX):
                continue
            names.append(name)
            start.append(ev.start_ns())
            dur.append(ev.duration_ns())
        return Trace(names, np.asarray(start, np.int64),
                     np.asarray(dur, np.int64), spans, window_s)
