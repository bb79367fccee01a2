"""Device-busy milliseconds a timed call: the traced window's busy time
(the profiler's kernels, copies and sets) over the window's calls."""

from perfbench.reduce import device_ms_per

UNIT, BETTER, SOURCE, LAYER, MOVES = ("ms", "lower", "device_trace",
                                      "device", "synth_latency_p95_ms")


def read(run):
    return device_ms_per(run, "calls")
