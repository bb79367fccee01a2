"""Host milliseconds a training step inside the program's ``ct.forward``
span (``train/loop.py::make_train_step``): ``micro_loss``, the
conditioning and the student and target denoisers forward, with the apply
boundary's bf16 casts (``ct.cast``) inside.

Traced host time: it follows the number of ops launched more than Python
work (see :mod:`perfbench.program_spans`)."""

from perfbench.program_spans import span_ms_per

UNIT, BETTER, SOURCE, LAYER, MOVES = ("ms", "lower", "program_span",
                                      "training step", "train_samples_per_s")


def read(run):
    return span_ms_per(run, "ct.forward", "steps")
