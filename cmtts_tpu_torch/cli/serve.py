"""TTS serving with the PyTorch port: a zero-dependency HTTP server over the
``Synthesizer`` (counterpart of ``cli/serve.py``).

    python -m cmtts_tpu_torch.cli.serve --dataset LJSpeech \\
        --restore_step 300000 --vocoder hifigan --vocoder_ckpt gen.npz \\
        --port 8080 [--max_batch 8 --batch_window_ms 5] [--device cuda]

    curl -X POST localhost:8080/tts -d '{"text": "hello world"}' \\
        -H 'Content-Type: application/json' -o out.wav
    curl 'localhost:8080/tts?text=hello&stream=1' -o out.wav
    curl localhost:8080/healthz

Endpoints:
- ``POST /tts``  JSON body: ``text`` (required), ``seed``, ``speaker``,
  ``d_control`` / ``p_control`` / ``e_control``, ``gap_ms``, ``stream``.
  Returns audio/wav (16-bit PCM) with ``X-Latency-Ms`` / ``X-RTF`` headers;
  with ``stream`` a chunked-transfer WAV whose bytes leave chunk by chunk.
- ``GET /tts?text=...``  the same as a query string.
- ``GET /healthz``  JSON status: device, shapes run, MRF kernel launches,
  batch histogram, config.

The model loads once and stays on the device.  Every device call holds one
lock (one card, one call at a time); the HTTP layer is threaded so health
checks never queue behind synthesis.  Concurrent /tts requests coalesce
into batched device calls (``--max_batch`` / ``--batch_window_ms``): a
dispatcher thread drains the queue for a few ms and runs all compatible
requests (same seed and controls) as one call padded to a power-of-two
batch.  Text over the frame budget (max_seq_len / 10 phonemes) is split
into sentence chunks and synthesised as one batched call, spliced with
``gap_ms`` of silence.  The port compiles nothing, but the warm-up still
runs every batch shape once before the first request, so that cuDNN's
algorithm choice and the caching allocator's growth happen then.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import struct
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from cmtts_tpu_torch.cli.synthesize import token_budget, tokenizer
from cmtts_tpu_torch.core.trace import counters


def wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    """float waveform [-1, 1] -> 16-bit PCM WAV file bytes."""
    pcm = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def pcm16(wav: np.ndarray) -> bytes:
    return (np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
            * 32767.0).astype("<i2").tobytes()


def wav_stream_header(sr: int) -> bytes:
    """RIFF/WAVE header with the unknown-length (0xFFFFFFFF) streaming
    convention: players treat the data chunk as open-ended."""
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))


class _Pending:
    """One enqueued /tts request awaiting a batched device call."""

    __slots__ = ("toks", "speaker", "key", "event", "result", "error")

    def __init__(self, toks, speaker, key):
        self.toks = toks
        self.speaker = speaker
        self.key = key  # (seed, d_control, p_control, e_control)
        self.event = threading.Event()
        self.result = None
        self.error = None


class TTSService:
    """Owns the Synthesizer and the text front-end; thread-safe synthesis.

    With ``max_batch > 1``, concurrent requests coalesce: a dispatcher
    thread drains the queue for up to ``batch_window_ms`` and runs all
    compatible requests (same seed and controls; speakers may differ) as
    ONE batched call, padded to the next power-of-two batch size so that
    the set of shapes stays bounded.  Under batching a request's noise
    depends on its row in the coalesced batch, so byte-exact
    reproducibility for a seed needs ``max_batch=1`` (or a request alone in
    its window).  Every call of ``synth`` and of Griffin-Lim holds
    ``lock``; grad mode is per thread, and the synthesis runs inside the
    ``torch.no_grad`` of ``Synthesizer.synthesize``.
    """

    def __init__(self, synth, cfg, lexicon_path: str | None = None,
                 lang: str = "en", max_batch: int = 1,
                 batch_window_ms: float = 5.0):
        self.synth = synth
        self.cfg = cfg
        self.lexicon_path = lexicon_path or getattr(
            cfg.data, "lexicon_path", "") or "/nonexistent"
        self.lang = lang
        self._tokenize = tokenizer(cfg, lang, self.lexicon_path)
        self.lock = threading.Lock()
        self.requests = 0
        self.max_batch = max(1, int(max_batch))
        self.batch_window_s = batch_window_ms / 1000.0
        self.batch_hist: dict[int, int] = {}
        self._gl = None
        self._queue: list[_Pending] = []
        self._qcond = threading.Condition()
        self._dispatcher = None
        if self.max_batch > 1:
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, daemon=True)
            self._dispatcher.start()

    def tokens(self, text: str) -> np.ndarray:
        return self._tokenize(text)

    def synthesize(self, text: str, seed: int = 42, speaker: int = 0,
                   d_control: float = 1.0, p_control: float = 1.0,
                   e_control: float = 1.0, gap_ms: float = 150.0):
        """(wav, sample rate, latency s, RTF) of one request."""
        toks = self.tokens(text)
        if len(toks) == 0:
            raise ValueError("text produced no phonemes")
        budget = token_budget(self.cfg, d_control)
        if len(toks) > budget:
            # long-form: one utterance would truncate at max_seq_len; chunk
            # and splice instead (one batched call, outside the queue)
            return self._synthesize_long(
                text, budget, seed, speaker, d_control, p_control,
                e_control, gap_ms)
        req = _Pending(toks, int(speaker),
                       (int(seed), float(d_control), float(p_control),
                        float(e_control)))
        if self._dispatcher is None:
            self._run_group([req])
        else:
            with self._qcond:
                self._queue.append(req)
                self._qcond.notify()
            req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def synthesize_stream(self, text: str, seed: int = 42, speaker: int = 0,
                          d_control: float = 1.0, p_control: float = 1.0,
                          e_control: float = 1.0, gap_ms: float = 150.0):
        """Generator of PCM-16 byte chunks: the text is chunked and each
        chunk synthesises as its own device call, so the first audio bytes
        leave after ONE chunk's latency.  The lock is released between
        chunks, so health checks and other requests interleave."""
        from cmtts_tpu_torch.text import text_to_sequence
        from cmtts_tpu_torch.text.segment import chunk_text

        sp_id = text_to_sequence("{sp}", [])[0]
        chunks = chunk_text(text, self.tokens, token_budget(self.cfg,
                                                            d_control),
                            sep_token=sp_id)
        if not chunks:
            raise ValueError("text produced no phonemes")
        sr = self.cfg.stft.sampling_rate
        hop = self.cfg.stft.hop_length
        gap = np.zeros(int(sr * gap_ms / 1000.0), np.float32)
        for i, toks in enumerate(chunks):
            with self.lock:
                mel, mel_lens, wav = self.synth(
                    [toks], speakers=np.asarray([int(speaker)], np.int32),
                    seed=int(seed), d_control=d_control,
                    p_control=p_control, e_control=e_control)
                self.requests += 1
            n = int(mel_lens[0])
            if wav is not None:
                piece = np.asarray(wav[0][: n * hop])
            else:
                piece = np.asarray(self._griffin(mel[0, :n]))
            if i > 0 and len(gap):
                yield pcm16(gap)
            yield pcm16(piece)

    def _synthesize_long(self, text, budget, seed, speaker,
                         d_control, p_control, e_control, gap_ms):
        from cmtts_tpu_torch.pipeline import synthesize_long
        from cmtts_tpu_torch.text import text_to_sequence
        from cmtts_tpu_torch.text.segment import chunk_text

        sp_id = text_to_sequence("{sp}", [])[0]
        chunks = chunk_text(text, self.tokens, budget, sep_token=sp_id)
        if not chunks:
            raise ValueError("text produced no phonemes")
        t0 = time.perf_counter()
        with self.lock:
            wav, mels, mel_lens = synthesize_long(
                self.synth, chunks, speaker=int(speaker), gap_ms=gap_ms,
                seed=int(seed), d_control=d_control, p_control=p_control,
                e_control=e_control, pad_pow2=True)
            self.requests += 1
        latency = time.perf_counter() - t0
        sr = self.cfg.stft.sampling_rate
        if wav is None:  # mel-only model: Griffin-Lim each chunk
            gap = np.zeros(int(sr * gap_ms / 1000.0), np.float32)
            pieces = []
            for i, m in enumerate(mels):
                pieces.append(np.asarray(self._griffin(m), np.float32))
                if i < len(mels) - 1:
                    pieces.append(gap)
            wav = np.concatenate(pieces)
        audio_sec = max(len(wav) / sr, 1e-9)
        return np.asarray(wav), sr, latency, latency / audio_sec

    def _dispatch_loop(self):
        while True:
            with self._qcond:
                while not self._queue:
                    self._qcond.wait()
                first = self._queue.pop(0)
            deadline = time.perf_counter() + self.batch_window_s
            group = [first]
            while len(group) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                with self._qcond:
                    if not self._queue:
                        self._qcond.wait(remaining)
                    # drain only requests batch-compatible with `first`
                    keep, take = [], []
                    for r in self._queue:
                        (take if (r.key == first.key and
                                  len(group) + len(take) < self.max_batch)
                         else keep).append(r)
                    self._queue[:] = keep
                group.extend(take)
            try:
                self._run_group(group)
            except Exception as e:  # noqa: BLE001 — deliver, don't die
                for r in group:
                    r.error = e
                    r.event.set()

    def _run_group(self, group: list[_Pending]):
        """One batched device call for ``group``: the batch is padded to
        the next power of two by repeating the last request, and each
        request gets its row."""
        seed, d_control, p_control, e_control = group[0].key
        b0 = len(group)
        b = 1 << (b0 - 1).bit_length()
        toks = [r.toks for r in group] + [group[-1].toks] * (b - b0)
        speakers = np.asarray([r.speaker for r in group] +
                              [group[-1].speaker] * (b - b0), np.int32)
        t0 = time.perf_counter()
        try:
            with self.lock:
                mel, mel_lens, wav = self.synth(
                    toks, speakers=speakers, seed=seed,
                    d_control=d_control, p_control=p_control,
                    e_control=e_control)
                self.requests += b0
                self.batch_hist[b0] = self.batch_hist.get(b0, 0) + 1
        except Exception as e:  # noqa: BLE001 — delivered to each requester
            for r in group:
                r.error = e
                r.event.set()
            return
        latency = time.perf_counter() - t0
        hop = self.cfg.stft.hop_length
        sr = self.cfg.stft.sampling_rate
        for i, r in enumerate(group):
            n = int(mel_lens[i])
            if wav is not None:
                out = np.asarray(wav[i][: n * hop])
            else:  # mel-only model (--vocoder none): Griffin-Lim
                out = np.asarray(self._griffin(mel[i, :n]))
            audio_sec = max(len(out) / sr, 1e-9)
            r.result = (out, sr, latency, latency / audio_sec)
            r.event.set()

    def _griffin(self, mel):
        """Griffin-Lim of one trimmed mel on the synthesizer's device."""
        from cmtts_tpu_torch.audio.stft import GriffinLim, MelSpectrogram

        with self.lock:
            if self._gl is None:
                st = self.cfg.stft
                self._gl = GriffinLim(MelSpectrogram(
                    st.sampling_rate, st.filter_length, st.hop_length,
                    st.win_length, st.n_mel_channels, st.mel_fmin,
                    st.mel_fmax, device=self.synth.device))
            return self._gl(mel)

    def warmup(self, all_buckets: bool = False, log=print):
        """Run every batch shape the dispatcher can emit once: the smallest
        bucket pair by default, every (text, mel) bucket pair with
        ``all_buckets``.  Returns the number of calls."""
        texts = [8] if not all_buckets else list(self.synth.text_buckets)
        batches = [1]
        while batches[-1] < self.max_batch:  # pow2 batch shapes the
            batches.append(batches[-1] * 2)  # dispatcher can emit
        n = 0
        for tb in texts:
            toks = np.ones(min(tb, 4), np.int32) * 13
            mels = ([None] if not all_buckets
                    else list(self.synth.mel_buckets))
            for mb in mels:
                for B in batches:
                    t0 = time.perf_counter()
                    with self.lock:
                        self.synth([np.resize(toks, tb)] * B, mel_bucket=mb)
                    n += 1
                    log(f"warmup: B={B} text_bucket={tb} mel_bucket={mb} "
                        f"({time.perf_counter() - t0:.1f}s)")
        return n

    def status(self) -> dict:
        launches = counters()
        dev = torch.device(self.synth.device)
        return {
            "status": "ok",
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else dev.type),
            # the (mel bucket, vocode) shapes run: the keys of the JAX
            # pipeline's compiled graphs
            "compiled_graphs": len(self.synth.shapes_run),
            "mrf_launches": {name: launches.get("mrf." + name, 0) for name in
                             ("fused_mrf_stage", "fused_mrf_stage_streamed")},
            "requests_served": self.requests,
            "T": self.synth.T,
            "sampler": self.synth.sampler,
            "text_buckets": list(self.synth.text_buckets),
            "mel_buckets": list(self.synth.mel_buckets),
            "max_batch": self.max_batch,
            "batch_hist": {str(k): v
                           for k, v in sorted(self.batch_hist.items())},
        }


def build_handler(service: TTSService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet by default
            if os.environ.get("CMTTS_SERVE_VERBOSE"):
                super().log_message(fmt, *a)

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _tts_stream(self, params: dict):
            """Chunked-transfer WAV: bytes flow as chunks synthesize."""
            text = params.get("text", "")
            if not isinstance(text, str) or not text.strip():
                return self._json(400, {"error": "missing 'text'"})
            try:
                gen = service.synthesize_stream(
                    text,
                    seed=int(params.get("seed", 42)),
                    speaker=int(params.get("speaker", 0)),
                    d_control=float(params.get("d_control", 1.0)),
                    p_control=float(params.get("p_control", 1.0)),
                    e_control=float(params.get("e_control", 1.0)),
                    gap_ms=float(params.get("gap_ms", 150.0)))
                first = next(gen)  # chunk 1 before the headers, so that a
                # bad request still gets a clean JSON error
            except (ValueError, StopIteration) as e:
                return self._json(400, {"error": str(e) or "empty stream"})
            self.protocol_version = "HTTP/1.1"
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: bytes):
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data)
                self.wfile.write(b"\r\n")

            sr = service.cfg.stft.sampling_rate
            chunk(wav_stream_header(sr) + first)
            for piece in gen:
                chunk(piece)
            self.wfile.write(b"0\r\n\r\n")
            self.close_connection = True

        def _tts(self, params: dict):
            text = params.get("text", "")
            if not isinstance(text, str) or not text.strip():
                return self._json(400, {"error": "missing 'text'"})
            if str(params.get("stream", "")).lower() in ("1", "true", "yes"):
                return self._tts_stream(params)
            try:
                out, sr, latency, rtf = service.synthesize(
                    text,
                    seed=int(params.get("seed", 42)),
                    speaker=int(params.get("speaker", 0)),
                    d_control=float(params.get("d_control", 1.0)),
                    p_control=float(params.get("p_control", 1.0)),
                    e_control=float(params.get("e_control", 1.0)),
                    gap_ms=float(params.get("gap_ms", 150.0)))
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            body = wav_bytes(out, sr)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Latency-Ms", f"{latency * 1000:.1f}")
            self.send_header("X-RTF", f"{rtf:.5f}")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/healthz":
                return self._json(200, service.status())
            if u.path == "/tts":
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                return self._tts(q)
            self._json(404, {"error": f"unknown path {u.path}"})

        def do_POST(self):
            u = urlparse(self.path)
            if u.path != "/tts":
                return self._json(404, {"error": f"unknown path {u.path}"})
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n else b"{}"
            try:
                params = json.loads(raw.decode() or "{}")
            except ValueError:
                return self._json(400, {"error": "invalid JSON body"})
            self._tts(params)

    return Handler


def serve(service: TTSService, host: str, port: int):
    return ThreadingHTTPServer((host, port), build_handler(service))


def build_service(argv=None) -> tuple[TTSService, argparse.Namespace]:
    """The service ``main`` serves: flags parsed, the checkpoint restored,
    the vocoder loaded, the ``Synthesizer`` on the device."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="LJSpeech")
    parser.add_argument("--config_root", type=str, default=None)
    parser.add_argument("--restore_step", type=int, required=True,
                        help="checkpoint of the port's trainer (0: the "
                             "latest committed one)")
    parser.add_argument("--params_role", type=str, default="model")
    parser.add_argument("--T", type=int, default=1, choices=(1, 2, 4))
    parser.add_argument("--vocoder", type=str, default="hifigan",
                        choices=("hifigan", "melgan", "griffinlim", "none"))
    parser.add_argument("--vocoder_ckpt", type=str, default=None)
    parser.add_argument("--lang", type=str, default="en",
                        choices=("en", "zh"))
    parser.add_argument("--lexicon_path", type=str, default=None)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--warmup_all", action="store_true",
                        help="run EVERY (text, mel) bucket pair at boot")
    parser.add_argument("--max_batch", type=int, default=8,
                        help="dynamic micro-batching: coalesce up to N "
                             "concurrent requests into one device call "
                             "(1 disables)")
    parser.add_argument("--batch_window_ms", type=float, default=5.0,
                        help="how long a request waits for co-batchable "
                             "traffic before dispatching")
    parser.add_argument("--bf16", action="store_true", default=True,
                        help="bfloat16 denoiser and MRF stages (always on, "
                             "as in the JAX server)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from cmtts_tpu_torch.cli.synthesize import load_vocoder, restore_cmtts
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.core.device import cli_device
    from cmtts_tpu_torch.pipeline import Synthesizer

    device = cli_device(args.device)
    cfg = load_configs(args.dataset, args.config_root)
    model = restore_cmtts(cfg, args.restore_step, args.params_role)
    vocoder, _ = load_vocoder(cfg, args.vocoder, args.vocoder_ckpt, device)
    synth = Synthesizer(cfg, model, vocoder, T=args.T, device=device)
    return TTSService(synth, cfg, args.lexicon_path, args.lang,
                      max_batch=args.max_batch,
                      batch_window_ms=args.batch_window_ms), args


def main(argv=None):
    service, args = build_service(argv)
    print(f"warming up ({'all buckets' if args.warmup_all else 'smallest'})…",
          flush=True)
    service.warmup(all_buckets=args.warmup_all)
    httpd = serve(service, args.host, args.port)
    print(f"serving on http://{args.host}:{args.port}  "
          f"(POST /tts, GET /healthz)", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
