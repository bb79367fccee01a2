"""The port's spans and counters (``cmtts_tpu_torch.core.trace``): off
without a profiler; under ``torch.profiler`` (CPU) a synthesis call, a CT
step and a speaker embedding record their parts in order and compute what
they compute untraced, bit for bit; the data feed's counters tell a slow
producer from a slow consumer; counts from many threads lose nothing."""

import contextlib
import sys
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from torch_port_helpers import (
    both_configs,
    config_dicts,
    flax_cm_params,
    tokens,
    torch_cm,
    train_batch,
)

from cmtts_tpu_torch.core import trace


def tiny_cfg():
    from cmtts_tpu_torch.core.config import config_from_dicts

    return config_from_dicts(*config_dicts())


def tiny_model(cfg, seed=0):
    from cmtts_tpu_torch.models.cmtts import CMTTS, init_like_flax

    return init_like_flax(CMTTS(cfg), torch.Generator().manual_seed(seed))


def recorded(fn):
    """(fn's result, [(span name, start ns, end ns)] of the port's spans
    the CPU profiler recorded, by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name()[len(trace.PREFIX):], e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(trace.PREFIX)]
    return out, sorted(spans, key=lambda s: s[1])


def test_span_without_a_profiler_is_the_shared_null_context():
    before = trace.traced()
    a, b = trace.span("synth.prepare"), trace.span("ct.update")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    assert trace.traced() == before


def test_counts_always_and_traced_only_under_a_profiler():
    trace.count("test.n", 2)
    c0, t0 = trace.counters(), trace.traced()
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("test.n", 3)
        with trace.span("test.span"):
            time.sleep(0.002)
    trace.count("test.n")
    c1, t1 = trace.counters(), trace.traced()
    assert c1["test.n"] - c0["test.n"] == 4
    assert t1["test.n"] - t0.get("test.n", 0) == 3
    assert t1["test.span"] - t0.get("test.span", 0) == 1
    assert t1["test.span.ns"] - t0.get("test.span.ns", 0) >= 2_000_000
    c1["test.n"] = -1                    # a copy
    assert trace.counters()["test.n"] != -1


def test_counts_from_many_threads_lose_nothing():
    n_threads, n = 16, 2000
    before = trace.counters().get("test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            trace.count("test.threads") for _ in range(n)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert trace.counters()["test.threads"] - before == n_threads * n


def test_synthesizer_spans_in_order_and_outputs_unchanged():
    from cmtts_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
    from cmtts_tpu_torch.pipeline import Synthesizer

    jcfg, cfg = both_configs()
    torch.manual_seed(0)
    voc = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=64,
                                         num_mels=cfg.stft.n_mel_channels))
    synth = Synthesizer(cfg, torch_cm(cfg, flax_cm_params(jcfg)), voc,
                        text_buckets=(8, 16), mel_buckets=(32,),
                        compute_dtype=torch.float32, device="cpu")
    seqs = tokens(np.random.RandomState(3), (9, 6))
    want = synth(seqs, seed=5)
    before = trace.traced()
    got, spans = recorded(lambda: synth(seqs, seed=5))
    assert [s[0] for s in spans] == ["synth.prepare", "synth.condition",
                                     "synth.denoise", "synth.vocode",
                                     "synth.fetch"]
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    after = trace.traced()
    for name in ("synth.prepare", "synth.fetch"):
        assert after[name] - before.get(name, 0) == 1
        assert after[name + ".ns"] > before.get(name + ".ns", 0)


def test_ct_step_spans_and_state_unchanged():
    from cmtts_tpu_torch.train.loop import batch_to_device, make_train_step
    from cmtts_tpu_torch.train.state import RAdam, create_train_state

    cfg = tiny_cfg()
    model = tiny_model(cfg)
    opt = RAdam(1e-3)
    state = create_train_state({k: v.detach() for k, v in
                                model.named_parameters()}, opt, 3)
    step = make_train_step(model, cfg, opt, 3, compute_dtype=torch.bfloat16)
    batch = batch_to_device(train_batch(0, (8, 5), 8, 32), "cpu")
    probs = torch.tensor([1 / 3, 2 / 3])

    def run():
        gen = torch.Generator().manual_seed(11)
        new, metrics = step(state, batch, probs, 0.95, gen)
        return new, metrics, gen.get_state()

    want = run()
    got, spans = recorded(run)
    names = [s[0] for s in spans]
    assert [n for n in names if n != "ct.cast"] == [
        "ct.draw", "ct.forward", "ct.backward", "ct.update"]
    fwd = spans[names.index("ct.forward")]
    casts = [s for s in spans if s[0] == "ct.cast"]
    assert casts and all(fwd[1] <= c[1] and c[2] <= fwd[2] for c in casts)
    assert torch.equal(got[2], want[2])          # the generator's state
    assert torch.equal(got[1]["loss"], want[1]["loss"])
    trees = {"params": lambda s: s.params,
             "mu": lambda s: s.opt_state["mu"],
             "nu": lambda s: s.opt_state["nu"],
             "target": lambda s: s.target_params}
    trees.update({f"ema{i}": (lambda s, i=i: s.ema_params[i])
                  for i in range(3)})
    for what, tree in trees.items():
        for k, v in tree(want[0]).items():
            assert torch.equal(tree(got[0])[k], v), (what, k)


def feed_counts():
    c = trace.counters()
    return np.array([c.get(k, 0) for k in
                     ("feed.pulls", "feed.empty_pulls", "feed.full_puts")])


def drain(n_items, produce_s, consume_s):
    """Pull ``n_items`` through ``prefetch_iterator`` (depth 2) with the
    producer and the consumer each sleeping as given an item: the rise of
    (pulls, empty pulls, full puts)."""
    from cmtts_tpu_torch.data.dataset import prefetch_iterator

    def items():
        for i in range(n_items):
            time.sleep(produce_s)
            yield i

    before = feed_counts()
    feed = prefetch_iterator(items)
    got = []
    for item in feed:
        got.append(item)
        time.sleep(consume_s)
    feed.close()
    assert got == list(range(n_items))
    return feed_counts() - before


def test_feed_counters_slow_producer():
    pulls, empty, _ = drain(8, 0.03, 0.0)
    assert pulls == 8 and empty >= pulls - 1


def test_feed_counters_slow_consumer():
    pulls, empty, full = drain(8, 0.0, 0.03)
    assert pulls == 8 and empty <= 1 and full > 0


def test_feed_collate_on_the_producer_thread():
    """The producer thread starts before the profiler: its spans are timed
    all the same, and a profiler of every thread (``cli.train_cm
    --profile_dir``) records them on that thread."""
    from torch.profiler import _ExperimentalConfig

    from cmtts_tpu_torch.data.dataset import prefetch_iterator

    gate = threading.Event()

    def items():
        gate.wait(timeout=30)
        for i in range(3):
            time.sleep(0.002)
            yield i

    feed = prefetch_iterator(items)
    before = trace.traced()
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        with trace.span("test.main"):
            gate.set()
            assert list(feed) == [0, 1, 2]
    after = trace.traced()
    assert after["feed.collate"] - before.get("feed.collate", 0) >= 3
    assert after["feed.pulls"] - before.get("feed.pulls", 0) == 3
    threads = {}
    for e in prof.profiler.kineto_results.events():
        threads.setdefault(e.name(), set()).add(e.start_thread_id())
    producer = threads[trace.PREFIX + "feed.collate"]
    assert producer.isdisjoint(threads[trace.PREFIX + "test.main"])


def test_deepspeaker_embedding_spans():
    from cmtts_tpu_torch.models.speaker import (
        DeepSpeakerInference,
        DeepSpeakerResCNN,
    )

    torch.manual_seed(0)
    ds = DeepSpeakerInference(DeepSpeakerResCNN(), "cpu")
    wav = np.sin(np.arange(22050) * 2 * np.pi * 180 / 22050).astype(
        np.float32) * 0.3
    want = ds.predict_embedding(wav)
    got, spans = recorded(lambda: ds.predict_embedding(wav))
    assert [s[0] for s in spans] == ["embed.fbank", "embed.rescnn"]
    np.testing.assert_array_equal(got, want)
