"""Offline evaluation metric suite (port of ``cmtts_tpu/metrics``): the
numpy/scipy metrics and their harness, copied; the GE2E speaker-cos
embedder and the predicted-MOS nets (MBNet, LDNet) run on the port's torch
models.
"""

from cmtts_tpu_torch.metrics.harness import Cal, CalOneModel  # noqa: F401
