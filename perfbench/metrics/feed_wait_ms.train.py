"""Mean host-clock wait a step on the data feed (``data/dataset.py``:
``batch_iterator`` behind ``prefetch_iterator``), from the benchmark's
span around each ``next`` of the prefetch iterator."""

UNIT, BETTER, SOURCE, LAYER, MOVES = ("ms", "lower", "host_clock",
                                      "data feed", "train_samples_per_s")


def read(run):
    if run.trace is None or not run.calls or "feed_wait_s" not in run.calls[0]:
        return None
    steps = sum(c["steps"] for c in run.calls)
    return 1e3 * sum(c["feed_wait_s"] for c in run.calls) / steps
