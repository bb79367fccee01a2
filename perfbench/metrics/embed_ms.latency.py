"""Mean host-clock time of the request's call into the speaker embedder
(``models/speaker.py::PreDefinedEmbedder``), ending when the embedding is
on the host."""

UNIT, BETTER, SOURCE, LAYER, MOVES = ("ms", "lower", "host_clock",
                                      "speaker embedder",
                                      "synth_latency_p95_ms")


def read(run):
    if not run.calls or "embed_s" not in run.calls[0] or \
            run.extra.get("voices") is None:
        return None
    return 1e3 * sum(c["embed_s"] for c in run.calls) / len(run.calls)
