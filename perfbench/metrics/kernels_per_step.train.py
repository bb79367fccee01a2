"""Device kernels a training step: the profiler's kernel records
(not copies or sets) over the window's steps."""

UNIT, BETTER, SOURCE, LAYER, MOVES = ("kernels", "lower", "device_trace",
                                      "launch path", "train_samples_per_s")


def read(run):
    if run.trace is None or not run.trace.steps or run.trace.busy_s <= 0:
        return None
    n = run.trace.count(lambda name: not name.startswith(("Memcpy",
                                                          "Memset")))
    return n / run.trace.steps
