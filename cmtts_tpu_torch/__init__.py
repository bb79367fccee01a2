"""PyTorch/CUDA port of cmtts_tpu for one NVIDIA Hopper GPU.

The package mirrors ``cmtts_tpu``'s module names so that each module's
counterpart is easy to find.  It imports ``torch`` and never ``jax`` or
anything of ``cmtts_tpu``: jax-free host modules (config, text frontend,
wav io) are copied, not imported.  Plain tensor code is PyTorch; the two
Pallas TPU kernels of the vocoder are hand-written CUDA C++ for sm_90a in
``csrc/mrf.cu`` (see :mod:`cmtts_tpu_torch.ops.mrf`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
