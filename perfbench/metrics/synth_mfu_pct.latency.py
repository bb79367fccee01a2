"""The whole call's share of the card's bf16 peak: every FLOP the window's
calls needed (conditioning, denoiser, vocoder convs and transposed convs,
the speaker embedder where a call embeds), counted from shapes, over the
window's wall time x 989e12."""

from perfbench.reduce import mfu_pct

UNIT, BETTER, SOURCE, LAYER, MOVES = ("%", "higher", "host_clock",
                                      "synthesis call", "synth_latency_p95_ms")


def read(run):
    return mfu_pct(run)
