"""The port's HTTP server (``cmtts_tpu_torch/cli/serve.py``) on the CPU: the
contract ``tests/test_serve.py`` holds the JAX server to, over a tiny
random model; the host logic against JAX's ``TTSService`` (the same
request stream must make the same synthesizer calls); the wav encoders
byte for byte; and ``cli.p_rtf_cm``."""

import io
import json
import os
import sys
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from torch_port_helpers import (
    both_configs,
    config_dicts,
    hifigan_reference_state_dict,
    write_config,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_serve():
    """The JAX package's ``cli/serve.py`` module."""
    sys.path.insert(0, os.path.join(ROOT, "cli"))
    import serve

    return serve


@pytest.fixture(scope="module")
def service():
    from cmtts_tpu_torch.cli.serve import TTSService
    from cmtts_tpu_torch.cli.synthesize import random_cmtts
    from cmtts_tpu_torch.core.config import config_from_dicts
    from cmtts_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
    from cmtts_tpu_torch.pipeline import Synthesizer

    cfg = config_from_dicts(*config_dicts())
    torch.manual_seed(1)
    voc = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=32,
                                         num_mels=16))
    synth = Synthesizer(cfg, random_cmtts(cfg), voc, T=1,
                        text_buckets=(8, 16), mel_buckets=(32,),
                        device="cpu")
    return TTSService(synth, cfg)


@pytest.fixture(scope="module")
def server_url(service):
    from cmtts_tpu_torch.cli.serve import serve

    httpd = serve(service, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)


def post(url, body):
    return urllib.request.Request(url + "/tts", data=json.dumps(body).encode(),
                                  headers={"Content-Type": "application/json"})


def test_wav_encoders_match_jax():
    from cmtts_tpu_torch.cli import serve

    js = jax_serve()
    sig = 0.7 * np.sin(np.linspace(0, 40, 2205)).astype(np.float32)
    sig[::97] = 1.5   # clipped
    assert serve.wav_bytes(sig, 22050) == js.wav_bytes(sig, 22050)
    assert serve.pcm16(sig) == js.pcm16(sig)
    assert serve.wav_stream_header(16000) == js.wav_stream_header(16000)
    with wave.open(io.BytesIO(serve.wav_bytes(sig, 22050))) as w:
        assert (w.getframerate(), w.getnchannels(), w.getnframes()) == (
            22050, 1, 2205)


def test_healthz(server_url, service):
    with urllib.request.urlopen(server_url + "/healthz", timeout=60) as r:
        body = json.loads(r.read())
    assert body["status"] == "ok" and body["device"] == "cpu"
    assert body["T"] == 1 and body["sampler"] == "onestep"
    assert body["text_buckets"] == [8, 16] and body["mel_buckets"] == [32]
    assert body["max_batch"] == 1 and isinstance(body["batch_hist"], dict)
    assert set(body["mrf_launches"]) == {"fused_mrf_stage",
                                         "fused_mrf_stage_streamed"}
    assert body["compiled_graphs"] == len(service.synth.shapes_run)


def test_tts_post_get_and_errors(server_url, service):
    """POST and GET return a wav with latency and RTF headers; a missing
    text is a 400, an unknown path a 404."""
    before = service.requests
    with urllib.request.urlopen(post(server_url, {"text": "hello world",
                                                  "seed": 3}),
                                timeout=300) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        assert float(r.headers["X-RTF"]) > 0
        assert float(r.headers["X-Latency-Ms"]) > 0
        data = r.read()
    with wave.open(io.BytesIO(data)) as w:
        assert w.getframerate() == service.cfg.stft.sampling_rate
        assert w.getnframes() > 0 and w.getnframes() % 256 == 0
    with urllib.request.urlopen(server_url + "/tts?text=ok&seed=1",
                                timeout=300) as r:
        assert r.headers["Content-Type"] == "audio/wav"
    assert service.requests == before + 2
    for req, code in ((urllib.request.Request(
            server_url + "/tts", data=b"{}",
            headers={"Content-Type": "application/json"}), 400),
            (post(server_url, {"text": "   ", "stream": 1}), 400),
            (server_url + "/nope", 404)):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == code


def test_warmup_counts_shapes(service):
    n = service.warmup(all_buckets=True, log=lambda *a: None)
    assert n == len(service.synth.text_buckets) * len(service.synth.mel_buckets)
    assert (32, True) in service.synth.shapes_run
    assert service.status()["compiled_graphs"] >= 1


@pytest.fixture(scope="module")
def batch_service(service):
    """The same Synthesizer, micro-batching dispatcher enabled."""
    from cmtts_tpu_torch.cli.serve import TTSService

    return TTSService(service.synth, service.cfg, max_batch=4,
                      batch_window_ms=200.0)


def test_microbatching_coalesces_and_a_lone_request_is_direct(
        service, batch_service):
    svc = batch_service
    results, errors = [None] * 4, []

    def one(i):
        try:
            results[i] = svc.synthesize("hello world", seed=7, speaker=0)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors and not any(t.is_alive() for t in threads)
    assert max(int(k) for k in svc.batch_hist) >= 2
    for out, rate, latency, rtf in results:
        assert rate == svc.cfg.stft.sampling_rate and latency > 0 and rtf > 0
    # a request alone in its window (B=1) gives the direct path's audio
    direct = service.synthesize("ok then", seed=11)
    via_queue = svc.synthesize("ok then", seed=11)
    np.testing.assert_allclose(direct[0], via_queue[0], atol=1e-5)


def test_long_text_routes_to_chunked_synthesis(service, monkeypatch):
    import dataclasses

    small = dataclasses.replace(service.cfg, model=dataclasses.replace(
        service.cfg.model, max_seq_len=100))  # budget = 10 tokens
    monkeypatch.setattr(service, "cfg", small)
    calls = []
    synth = service.synth

    class Spy:
        def __getattr__(self, name):
            return getattr(synth, name)

        def __call__(self, toks, **kw):
            calls.append(len(toks))
            return synth(toks, **kw)

    monkeypatch.setattr(service, "synth", Spy())
    out, sr, latency, rtf = service.synthesize(
        "the quick brown fox jumps. pack my box with jugs.", seed=5)
    # one call of the chunks, padded to a power of two
    assert len(calls) == 1 and calls[0] >= 2 and calls[0] & (calls[0] - 1) == 0
    assert sr == synth.cfg.stft.sampling_rate
    assert latency > 0 and rtf > 0 and out.ndim == 1
    assert len(out) > int(0.15 * sr)   # chunks and a gap


def test_tts_stream_chunked_wav(server_url):
    with urllib.request.urlopen(post(server_url, {
            "text": "hello world. goodbye world.", "seed": 4, "stream": 1}),
            timeout=600) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        body = r.read()  # urllib de-chunks
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    assert b"data" in body[:44]
    pcm = np.frombuffer(body[44:], "<i2")
    assert pcm.size > 0 and pcm.ndim == 1


def test_microbatching_delivers_errors(service):
    """A failed device call surfaces in the requesting thread, and the
    dispatcher keeps serving."""
    from cmtts_tpu_torch.cli.serve import TTSService

    svc = TTSService(service.synth, service.cfg, max_batch=4,
                     batch_window_ms=1.0)

    def boom(*a, **k):
        raise RuntimeError("device on fire")

    svc.synth = type("S", (), {"__call__": staticmethod(boom)})()
    with pytest.raises(RuntimeError, match="device on fire"):
        svc.synthesize("hello")
    svc.synth = service.synth
    out, sr, latency, rtf = svc.synthesize("hello again", seed=2)
    assert sr == service.cfg.stft.sampling_rate and out.size > 0


# -- host logic against JAX's TTSService ----------------------------------------

class StubSynth:
    """A synthesizer that records its calls and returns a deterministic
    function of them: mel_lens 2 frames a token, wav rows of their seed."""

    text_buckets, mel_buckets, T, sampler = (8, 16), (32,), 1, "onestep"
    device = "cpu"

    def __init__(self, cfg):
        self.cfg = cfg
        self.calls = []
        self._jitted = {}
        self.shapes_run = set()

    def __call__(self, toks, speakers=None, spker_embeds=None, seed=42,
                 d_control=1.0, p_control=1.0, e_control=1.0,
                 mel_bucket=None):
        self.calls.append({
            "tokens": [np.asarray(t).tolist() for t in toks],
            "speakers": None if speakers is None else np.asarray(
                speakers).tolist(),
            "seed": seed, "controls": (d_control, p_control, e_control),
            "mel_bucket": mel_bucket})
        B, hop = len(toks), self.cfg.stft.hop_length
        lens = np.asarray([min(2 * len(t), 32) for t in toks])
        rows = np.arange(32 * hop, dtype=np.float32)[None] / (32 * hop)
        wav = np.sin(rows * (seed + 1) + np.arange(B)[:, None]) * 0.5
        return (np.zeros((B, 32, self.cfg.stft.n_mel_channels), np.float32),
                lens, wav.astype(np.float32))

    def trim_wavs(self, wav, mel_lens):
        hop = self.cfg.stft.hop_length
        return [w[: int(n) * hop] for w, n in zip(wav, mel_lens)]


def test_host_logic_matches_jax_service():
    """The same stream (a direct request, a batch of 3 padded to 4, a long
    text chunked into one padded call, a streamed text) makes the same
    synthesizer calls in both services, with the same results."""
    import dataclasses

    from cmtts_tpu_torch.cli import serve

    js = jax_serve()
    jcfg, tcfg = both_configs()
    small = {}
    for name, cfg in (("jax", jcfg), ("port", tcfg)):
        small[name] = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, max_seq_len=120))   # budget 12 tokens
    results, calls = {}, {}
    for name, mod in (("jax", js), ("port", serve)):
        cfg = small[name]
        synth = StubSynth(cfg)
        svc = mod.TTSService(synth, cfg, max_batch=1)
        out = [svc.synthesize("hello world", seed=3, speaker=1,
                              d_control=1.1)]
        group = [mod._Pending(svc.tokens(t), s, (5, 1.0, 0.9, 1.2))
                 for t, s in (("one two", 0), ("three", 2), ("four five", 1))]
        svc._run_group(group)
        out += [r.result for r in group]
        out.append(svc.synthesize(
            "the quick brown fox jumps. pack my box with jugs. a b.", seed=9))
        out.append(b"".join(svc.synthesize_stream(
            "hello world. goodbye world.", seed=4, speaker=2)))
        results[name], calls[name] = out, synth.calls
        assert svc.batch_hist == {1: 1, 3: 1}
    # direct, the padded batch (a padding row), the long text's chunks in
    # one call, the stream's two sentences one call each
    assert len(calls["port"]) == 5
    assert calls["port"][1]["speakers"] == [0, 2, 1, 1]
    n_long = len(calls["port"][2]["tokens"])
    assert n_long >= 2 and n_long & (n_long - 1) == 0
    assert calls["port"] == calls["jax"]
    for a, b in zip(results["port"], results["jax"]):
        if isinstance(a, bytes):
            assert a == b
        else:
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]


# -- CLIs -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run_root(tmp_path_factory):
    """(config root, tmp dir) of a tiny config with a 3-utterance val set,
    a committed checkpoint (step 1) of a random model and a width-32
    HiFi-GAN in the reference's ``.pth.tar`` format."""
    from cmtts_tpu_torch.cli.synthesize import random_cmtts
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.data.feature_corpus import write_feature_corpus
    from cmtts_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
    from cmtts_tpu_torch.train.checkpoint import save_checkpoint
    from cmtts_tpu_torch.train.state import RAdam, create_train_state

    tmp = tmp_path_factory.mktemp("serve_run")
    pre, model, _, stats = config_dicts()
    train = {"path": {k: str(tmp / k) for k in
                      ("ckpt_path", "log_path", "result_path")}}
    root = write_config(tmp, "Tiny", (pre, model, train, stats))
    write_feature_corpus(str(tmp / "pre"), 4, 3, seed=0, n_mels=16,
                         phonemes=(5, 12), frames=(1, 4))
    cfg = load_configs("Tiny", root)
    state = create_train_state(
        {k: v.detach() for k, v in random_cmtts(cfg).named_parameters()},
        RAdam(1e-4), len(cfg.train.cm.ema_rate))
    state.step = 1
    save_checkpoint(cfg.train.ckpt_path, state)
    torch.manual_seed(0)
    torch.save({"generator": hifigan_reference_state_dict(HiFiGANGenerator(
        HiFiGANConfig(upsample_initial_channel=32, num_mels=16)))},
        tmp / "generator.pth.tar")
    return root, tmp


def test_p_rtf_cm_writes_its_json(run_root, capsys):
    from cmtts_tpu_torch.cli.p_rtf_cm import main

    root, tmp = run_root
    out = tmp / "rtf"
    res = main(["--dataset", "Tiny", "--config_root", root, "--source",
                str(tmp / "pre" / "val.txt"), "--batch_size", "2",
                "--vocoder_ckpt", str(tmp / "generator.pth.tar"),
                "--write_wavs", "--out", str(out), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res and res["batches"] == 2 and res["T"] == 1
    assert np.isfinite(res["mean_rtf"]) and res["audio_seconds"] > 0
    with open(out / f"rtf_{res['mean_rtf']:.6f}.json") as f:
        saved = json.load(f)
    assert len(saved["rtf_list"]) == 2 and saved["mean_rtf"] == res["mean_rtf"]
    assert len([p for p in os.listdir(out) if p.endswith(".wav")]) == 3


def test_build_service_from_checkpoint_griffin_lim(run_root):
    """``main``'s service from flags: the checkpoint restored, a mel-only
    model vocoded by Griffin-Lim on the service's device."""
    from cmtts_tpu_torch.cli.serve import build_service

    root, _ = run_root
    svc, args = build_service(["--dataset", "Tiny", "--config_root", root,
                               "--restore_step", "0", "--vocoder",
                               "griffinlim", "--max_batch", "1",
                               "--device", "cpu"])
    assert svc.synth.vocoder is None and args.port == 8080
    out, sr, latency, rtf = svc.synthesize("hello there", seed=1)
    assert out.ndim == 1 and out.size > 0 and np.isfinite(out).all()
