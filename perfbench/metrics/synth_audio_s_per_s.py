"""Seconds of trimmed audio (mel_len x hop / sampling rate) that the
window's calls completed, over the window's wall time (``cli.p_rtf_cm``'s
total audio over total wall, inverted)."""

UNIT, BETTER, SOURCE, LAYER, MOVES = ("audio_s/s", "higher", "host_clock",
                                      "end to end", None)


def read(run):
    if not run.calls or "audio_s" not in run.calls[0]:
        return None
    return sum(c["audio_s"] for c in run.calls) / run.window_s
