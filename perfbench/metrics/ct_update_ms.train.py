"""Host milliseconds a training step inside the program's ``ct.update``
span (``train/loop.py::make_train_step``): the microbatch mean, the
gradient all-reduce and norms, RAdam, the three EMAs and the target EMA,
and the metrics dict.

Traced host time: it follows the number of ops launched more than Python
work (see :mod:`perfbench.program_spans`)."""

from perfbench.program_spans import span_ms_per

UNIT, BETTER, SOURCE, LAYER, MOVES = ("ms", "lower", "program_span",
                                      "training step", "train_samples_per_s")


def read(run):
    return span_ms_per(run, "ct.update", "steps")
