"""Offline evaluation metric suite (port of ``cmtts_tpu/metrics``): the
numpy/scipy metrics and their harness, copied; the GE2E speaker-cos
embedder runs on the port's torch model.  The predicted-MOS nets are not
ported yet.
"""

from cmtts_tpu_torch.metrics.harness import Cal, CalOneModel  # noqa: F401
