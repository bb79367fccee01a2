"""The port's spans and counters.

``span(name)`` marks a layer's work as ``cmtts.<name>`` in whatever
``torch.profiler`` records (a traced benchmark run, ``cli.train_cm
--profile_dir``, an operator's own profiler): a kineto range on the clock
of the device activity, so that device time and idle gaps can be charged
to the host code that caused them.  While a profiler records, a span also
adds its count and its host nanoseconds to :func:`traced`; with none it is
one flag check and a shared null context.  Spans never synchronise with
the device.

``count(name, n)`` adds to :func:`counters`, always on (``cli.serve``'s
``/healthz`` reads the MRF launches, ``cli.train_cm`` the data feed's
pulls); while a profiler records, to :func:`traced` as well.

"A profiler records" is torch's process-wide flag for fast Python checks,
not the calling thread's profiler state: the data feed's producer thread,
started before any profiler, times its spans too.
"""

from __future__ import annotations

import contextlib
import threading
import time

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

PREFIX = "cmtts."
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_counts: dict[str, int] = {}
_traced: dict[str, int] = {}


def _add(registry: dict, name: str, n: int) -> None:
    registry[name] = registry.get(name, 0) + n


def count(name: str, n: int = 1) -> None:
    with _lock:
        _add(_counts, name, n)
        if _profiler._is_profiler_enabled:
            _add(_traced, name, n)


def counters() -> dict[str, int]:
    """Every count since the process began (a copy)."""
    with _lock:
        return dict(_counts)


def traced() -> dict[str, int]:
    """What was recorded while a profiler recorded, since the process
    began (a copy): the counts, and for each span ``<name>`` its number
    and ``<name>.ns`` its host nanoseconds."""
    with _lock:
        return dict(_traced)


class _Span:
    __slots__ = ("_name", "_range", "_t0")

    def __init__(self, name: str):
        self._name = name
        self._range = record_function(PREFIX + name)

    def __enter__(self):
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        self._range.__exit__(*exc)
        with _lock:
            _add(_traced, self._name, 1)
            _add(_traced, self._name + ".ns", ns)
        return False


def span(name: str):
    """A context marking ``name``'s work while a profiler records; the
    shared null context otherwise."""
    return _Span(name) if _profiler._is_profiler_enabled else _NULL
