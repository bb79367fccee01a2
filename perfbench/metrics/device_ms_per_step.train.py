"""Device-busy milliseconds a training step: the traced window's busy time
(the profiler's kernels, copies and sets) over the window's steps."""

from perfbench.reduce import device_ms_per

UNIT, BETTER, SOURCE, LAYER, MOVES = ("ms", "lower", "device_trace",
                                      "device", "train_samples_per_s")


def read(run):
    if not run.calls or "steps" not in run.calls[0]:
        return None
    return device_ms_per(run, "steps")
