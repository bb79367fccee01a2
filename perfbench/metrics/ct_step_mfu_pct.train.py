"""The whole CT step's share of the cards' bf16 peak: the step's FLOP from
the batch shapes (conditioning and denoiser, forward and backward of the
student and forward of the target), over the window's wall time x
989e12 x cards."""

from perfbench.reduce import mfu_pct

UNIT, BETTER, SOURCE, LAYER, MOVES = ("%", "higher", "host_clock",
                                      "training step", "train_samples_per_s")


def read(run):
    return mfu_pct(run)
