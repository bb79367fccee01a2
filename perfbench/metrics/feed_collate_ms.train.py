"""Mean host milliseconds of one of the program's ``feed.collate`` spans
in the window: a ``next`` of the batch iterator on the prefetch producer's
thread (``data/dataset.py``: ``get_many``, the length sort, ``collate_batch``).
Beside a step's time it says whether the producer keeps up.

Traced host time (see :mod:`perfbench.program_spans`)."""

from perfbench.program_spans import mean_span_ms

UNIT, BETTER, SOURCE, LAYER, MOVES = ("ms", "lower", "program_span",
                                      "data feed", "train_samples_per_s")


def read(run):
    return mean_span_ms(run, "feed.collate")
