"""The quality and bench tools of the JAX package's ``tools/``, ported:
each module is run as ``python -m cmtts_tpu_torch.tools.<name>`` with the
JAX tool's flags plus ``--device`` (``cuda`` unless asked otherwise), and
the ``*.sh`` scripts beside them drive the port's CLIs and tools with the
JAX scripts' stages, markers and defaults."""
