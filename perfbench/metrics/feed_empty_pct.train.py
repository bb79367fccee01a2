"""Share of the window's pulls from the prefetch queue that found it empty
(the program's ``feed.empty_pulls`` over ``feed.pulls`` counters,
``data/dataset.py::prefetch_iterator``): how often a step waited on the
producer."""

from perfbench.program_spans import count_pct

UNIT, BETTER, SOURCE, LAYER, MOVES = ("%", "lower", "program_counter",
                                      "data feed", "train_samples_per_s")


def read(run):
    return count_pct(run, "feed.empty_pulls", "feed.pulls")
