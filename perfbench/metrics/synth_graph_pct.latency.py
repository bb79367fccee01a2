"""Share of the window's synthesis calls served by a CUDA-graph replay (the
program's ``synth.graph_replays`` over ``synth.calls`` counters,
``pipeline.py::Synthesizer.synthesize``): how many calls ran their
conditioning and sampler as one graph launch rather than as eager
launches.  Nothing where the window ran no device operation (the CPU),
since no graph can replay there."""

from perfbench.program_spans import count_pct

UNIT, BETTER, SOURCE, LAYER, MOVES = ("%", "higher", "program_counter",
                                      "synthesis call", "synth_latency_p95_ms")


def read(run):
    if run.trace is None or not len(run.trace.names):
        return None
    return count_pct(run, "synth.graph_replays", "synth.calls")
