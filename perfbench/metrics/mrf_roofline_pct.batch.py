"""The bf16 MRF stages' share of their roofline (``ops/mrf.py`` ->
``csrc/mrf_wg.cu``): the bound of every stage the window ran, from
shapes (``perfbench/flops.py``), over the device time of the kernels
named ``mrf_*`` in the trace."""

from perfbench.reduce import mrf_roofline_pct

UNIT, BETTER, SOURCE, LAYER, MOVES = ("%", "higher", "device_trace",
                                      "kernels", "synth_audio_s_per_s")


def read(run):
    return mrf_roofline_pct(run)
