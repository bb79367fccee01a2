"""Host milliseconds a call inside the program's ``synth.fetch`` span
(``pipeline.py::Synthesizer.__call__``): the copies of the mel lengths, the
mel and the wav to the host, which wait for the call's device work, and
the bucket-saturation check.

Traced host time, mostly the wait for the card: it moves with the call's
device work (see :mod:`perfbench.program_spans`)."""

from perfbench.program_spans import span_ms_per

UNIT, BETTER, SOURCE, LAYER, MOVES = ("ms", "lower", "program_span",
                                      "synthesis call", "synth_audio_s_per_s")


def read(run):
    return span_ms_per(run, "synth.fetch")
