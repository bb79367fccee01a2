"""Share of the traced window in which no operation ran on the card (the
profiler's kernels, copies and sets)."""

from perfbench.reduce import idle_pct

UNIT, BETTER, SOURCE, LAYER, MOVES = ("%", "lower", "device_trace",
                                      "device", "train_samples_per_s")


def read(run):
    return idle_pct(run)
