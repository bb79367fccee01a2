"""Training samples that the steps completed in the window, over the wall
time from the window's start to the end of the last call that
completed."""

UNIT, BETTER, SOURCE, LAYER, MOVES = ("samples/s", "higher", "host_clock",
                                      "end to end", None)


def read(run):
    if not run.calls or "samples" not in run.calls[0]:
        return None
    return sum(c["samples"] for c in run.calls) / run.window_s
