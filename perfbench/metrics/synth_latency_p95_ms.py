"""95th percentile of every request of the window, from the caller
issuing it (the reference clip's embedding included) to the wav on the
host."""

import numpy as np

from perfbench.reduce import latencies_ms

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "host_clock", \
    "end to end", None


def read(run):
    return float(np.percentile(latencies_ms(run), 95)) if run.calls else None
