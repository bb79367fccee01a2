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
import pytest
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
    from cmtts_tpu_torch.pipeline import GRAPH_COUNTERS, Synthesizer

    jcfg, cfg = both_configs()
    torch.manual_seed(0)
    voc = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=64,
                                         num_mels=cfg.stft.n_mel_channels))
    synth = Synthesizer(cfg, torch_cm(cfg, flax_cm_params(jcfg)), voc,
                        text_buckets=(8, 16), mel_buckets=(32,),
                        compute_dtype=torch.float32, device="cpu")
    seqs = tokens(np.random.RandomState(3), (9, 6))
    counts = trace.counters()
    want = synth(seqs, seed=5)
    before = trace.traced()
    got, spans = recorded(lambda: synth(seqs, seed=5))
    # on the CPU every call stays eager: counted, never replayed
    assert synth._graphs is None
    after = trace.counters()
    assert {k: after.get(k, 0) - counts.get(k, 0)
            for k in GRAPH_COUNTERS} == {
        "synth.calls": 2, "synth.graph_replays": 0,
        "synth.graph_captures": 0}
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


@pytest.mark.parametrize("device,dp,tp,replays", [
    ("cuda", False, False, True), ("cuda", True, False, False),
    ("cuda", False, True, False), ("cpu", False, False, False),
    ("cpu", True, True, False)])
def test_graphs_only_on_a_cuda_device_without_groups(device, dp, tp,
                                                     replays):
    from cmtts_tpu_torch.pipeline import replays_graphs

    group = object()        # a group's identity is all the choice reads
    assert replays_graphs(torch.device(device), group if dp else None,
                          group if tp else None) is replays


def key_of(B=2, t_txt=16, t_mel=256, sampler="onestep", T=1, steps=2,
           controls=(1.0, 1.0, 1.0), speaker="embeds", fill=0):
    from cmtts_tpu_torch.pipeline import graph_key

    texts = torch.full((B, t_txt), 5 + fill, dtype=torch.int64)
    ids = torch.full((B,), fill, dtype=torch.int64)
    embeds = torch.full((B, 512), 0.5 + fill, dtype=torch.float32)
    return graph_key(texts, t_mel, ids if speaker != "embeds" else None,
                     embeds if speaker != "ids" else None, sampler, T, steps,
                     controls)


@pytest.mark.parametrize("a,b", [
    (dict(B=1), {}), (dict(t_txt=32), {}), (dict(t_mel=512), {}),
    (dict(sampler="multistep"), {}), (dict(sampler="multistep", T=2),
                                      dict(sampler="multistep", T=4)),
    (dict(sampler="our_multistep", T=2), dict(sampler="our_multistep")),
    (dict(controls=(1.1, 1.0, 1.0)), {}), (dict(controls=(1.0, 0.9, 1.0)), {}),
    (dict(controls=(1.0, 1.0, 1.2)), {}), (dict(speaker="ids"), {}),
    (dict(speaker="both"), {}),
    (dict(sampler="heun", steps=18), dict(sampler="heun", steps=4))])
def test_graph_key_separates_what_a_capture_depends_on(a, b):
    assert key_of(**a) != key_of(**b)


@pytest.mark.parametrize("a,b", [
    (dict(fill=1), {}), (dict(steps=4), {}),
    (dict(controls=(1, 1, 1)), {}),
    (dict(sampler="multistep", T=2, fill=3), dict(sampler="multistep", T=2)),
    (dict(speaker="ids", fill=2), dict(speaker="ids"))])
def test_graph_key_ignores_values_a_replay_reads(a, b):
    """Input values (ids, lengths, embeddings), a control's Python type and
    the grid size of a sampler that has none share one graph."""
    assert key_of(**a) == key_of(**b)


def host_bcast(sigma, batch):
    """The copy ``_bcast`` made before it became a device fill."""
    return torch.as_tensor(sigma, dtype=torch.float32).expand(batch)


@pytest.mark.parametrize("which", ["sigma_max", "ode_sigmas", "ts_grid",
                                   "python", "multistep_scale"])
def test_device_fills_give_the_host_copies_values(which):
    from cmtts_tpu_torch.cm.karras import KarrasSchedule
    from cmtts_tpu_torch.cm.sampling import _bcast, ode_sigmas

    sched = KarrasSchedule()
    if which == "multistep_scale":
        grid = sched.ts_grid((0, 0, 0, 0, 1), 18)
        for next_t in grid:
            want = torch.sqrt(torch.clamp(next_t ** 2 - sched.sigma_min ** 2,
                                          min=0.0))
            got = torch.full((), float(want))
            assert got.dtype == want.dtype and torch.equal(got, want)
        return
    values = {"sigma_max": [sched.sigma_max, sched.sigma_min],
              "ode_sigmas": list(ode_sigmas(sched, 18)),
              "ts_grid": list(sched.ts_grid((0, 3, 7, 17), 18)),
              "python": [0.1, 1 / 3, 2.0 ** 0.5, 1e-44, 79.999999]}[which]
    for v in values:
        got, want = _bcast(v, 3, "cpu"), host_bcast(v, 3)
        assert got.dtype == torch.float32 and torch.equal(got, want), v


@pytest.mark.parametrize("sampler,T,steps", [
    ("onestep", 1, 2), ("multistep", 2, 2), ("multistep", 4, 2),
    ("ancestral", 1, 4), ("heun", 1, 3)])
def test_draws_into_graph_buffers_match_the_eager_draws(sampler, T, steps):
    """The noise a replay reads: counted by a warm-up, drawn ahead from the
    call's generator into buffers (or copied from given noise), gives the
    eager sampler's result bit for bit."""
    from cmtts_tpu_torch.cm.karras import KarrasSchedule
    from cmtts_tpu_torch.cm.sampling import sample_mel
    from cmtts_tpu_torch.pipeline import _CountedZeros, draw_into

    sched = KarrasSchedule()
    shape = (2, 12, 4)

    def denoise(x, sigma):
        return torch.tanh(x * 0.1) + sigma[:, None, None] * 1e-3

    def run(**kw):
        return sample_mel(denoise, shape, sched, sampler, T=T, steps=steps,
                          **kw)

    counted = _CountedZeros(shape, "cpu")
    run(x_T=torch.zeros(shape), noise=counted)
    x_T, noise = torch.empty(shape), [torch.empty(shape)
                                      for _ in range(counted.n)]
    want = run(generator=torch.Generator().manual_seed(9))
    draw_into(x_T, noise, sched.sigma_max,
              generator=torch.Generator().manual_seed(9))
    assert torch.equal(run(x_T=x_T, noise=noise), want)
    # given noise is copied in, extra draws ignored, as _Draws ignores them
    g = torch.Generator().manual_seed(4)
    given = [torch.randn(shape, generator=g) for _ in range(counted.n + 2)]
    x_given = torch.randn(shape, generator=g)
    draw_into(x_T, noise, sched.sigma_max, x_given, iter(given))
    assert torch.equal(run(x_T=x_T, noise=noise),
                       run(x_T=x_given, noise=given))
    if counted.n:
        with pytest.raises(ValueError, match="more noise"):
            draw_into(x_T, noise, sched.sigma_max, x_given,
                      given[:counted.n - 1])


@pytest.fixture
def card():
    """The CUDA card, TF32 off as the CLIs compute float32; skips where
    there is none (the CPU suite)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest -o addopts='' "
                    "-m card tests/test_torch_port_trace.py")
    from cmtts_tpu_torch.core.device import cli_device

    return cli_device("cuda")


def card_case(device, case: str):
    """(Synthesizer, token sequences, call keywords, benchmark cell) at
    full width with seeded random weights: B=8 at mel 1024 (LJSpeech,
    ``lj_synth_b8``'s shape) or B=1 zero-shot with a 512-d embedding
    (VCTK, ``vctk_zs_b1``'s), at T=1 or T=2 multistep."""
    from cmtts_tpu_torch.cli.synthesize import random_cmtts
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.models.hifigan import HiFiGANGenerator
    from cmtts_tpu_torch.pipeline import Synthesizer

    name, B, T = {"lj_b8_onestep": ("LJSpeech", 8, 1),
                  "vctk_b1_onestep": ("VCTK", 1, 1),
                  "vctk_b1_multistep_T2": ("VCTK", 1, 2)}[case]
    cfg = load_configs(name)
    torch.manual_seed(2)
    synth = Synthesizer(cfg, random_cmtts(cfg, seed=1), HiFiGANGenerator(),
                        T=T, device=device)
    rs = np.random.RandomState(3)
    if B == 8:
        seqs = [rs.randint(13, 140, 96) for _ in range(B)]
        return synth, seqs, {"mel_bucket": 1024}, "lj_synth_b8"
    seqs = [rs.randint(13, 140, 43)]
    emb = rs.randn(1, cfg.model.external_speaker_dim).astype(np.float32)
    return synth, seqs, {"spker_embeds": emb / np.linalg.norm(emb)}, \
        "vctk_zs_b1"


@pytest.mark.card
@pytest.mark.parametrize("case", ["lj_b8_onestep", "vctk_b1_onestep",
                                  "vctk_b1_multistep_T2"])
def test_graph_replay_matches_the_eager_call_on_the_card(card, case):
    """Replays against the same calls made eagerly
    (``chip_smoke.graph_vs_eager``: bit for bit or within the cell's
    ``mel_err`` limit, held outputs, counters, eager and replay ms, and a
    first call with new controls against the same call made eagerly)."""
    import chip_smoke

    synth, seqs, kw, cell = card_case(card, case)
    res = chip_smoke.graph_vs_eager(synth, seqs, cell, reps=5, **kw)
    print(case, res)
    # the key, the other mel bucket, and five new duration controls
    assert res["counts"]["synth.graph_captures"] == 2 + 5


@pytest.mark.card
@pytest.mark.parametrize("case", ["lj_b8_onestep", "vctk_b1_onestep"])
def test_graph_memory_on_the_card(card, case):
    """Device memory after 1, 10 and 64 graphs of one shape, and the 65th
    key eager (``chip_smoke.graph_memory``): from the 10th graph on, each
    adds little more than its own buffers (the shared pool holds the
    intermediates, and warm-ups on one stream reuse one cache), within
    twice those and a 1 MB block of the allocator's rounding."""
    import chip_smoke

    synth, seqs, kw, _ = card_case(card, case)
    res = chip_smoke.graph_memory(synth, seqs, **kw)
    print(case, res)
    assert res["graphs_kept"] == 64
    assert res["reserved_mb_per_graph"] <= 2 * res["static_mb_per_graph"] + 1


@pytest.mark.card
def test_deepspeaker_front_end_on_the_card(card):
    """The DeepSpeaker front end on the card (cuFFT) against the numpy one
    over six seeded 3 s clips (``chip_smoke.ds_front_end_vs_numpy``): the
    features within 1e-4, the embedding within the ``vctk_zs_b1`` cell's
    ``embed_err`` limit of the ResCNN fed the numpy features, and every
    embedding's front end counted as run on the card."""
    import chip_smoke
    from cmtts_tpu_torch.models.speaker import (
        DeepSpeakerInference,
        DeepSpeakerResCNN,
    )

    torch.manual_seed(0)
    ds = DeepSpeakerInference(DeepSpeakerResCNN(), card)
    wavs = [chip_smoke.reference_wav(seed) for seed in range(6)]
    res = chip_smoke.ds_front_end_vs_numpy(ds, wavs, 22050)
    print(res)
    assert res["feat_err"] <= 1e-4
    assert res["embed_err"] < chip_smoke.cell_limit("vctk_zs_b1",
                                                    "embed_err")
    assert res["embed.fbank_device"] == res["embed.calls"] == len(wavs)


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
