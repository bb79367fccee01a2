"""Serving throughput/latency benchmark: offered-load sweep against a
running ``cmtts_tpu_torch.cli.serve`` (or an in-process ``TTSService``).
Port of ``tools/bench_serve.py``; the JSON rows keep its keys.

Measures what dynamic micro-batching actually buys: requests/sec and
latency percentiles at increasing concurrency, batching on vs off.

    # terminal 1 (card): python -m cmtts_tpu_torch.cli.serve ... --port 8080
    # terminal 2:
    python -m cmtts_tpu_torch.tools.bench_serve --url http://127.0.0.1:8080 \
        --concurrency 1 2 4 8 --requests 32

In-process mode (no HTTP overhead; builds a tiny random-init model at
``cli/gen_corpus.py --tiny``'s widths, with Griffin-Lim stubbed out; good
for a smoke of the harness only):

    python -m cmtts_tpu_torch.tools.bench_serve --inprocess --concurrency 1 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "Pack my box with five dozen liquor jugs.",
    "How vexingly quick daft zebras jump.",
    "Sphinx of black quartz, judge my vow.",
]


def _percentiles(xs):
    xs = sorted(xs)
    pick = lambda q: xs[min(len(xs) - 1, int(q * len(xs)))]  # noqa: E731
    return {"p50": pick(0.50), "p90": pick(0.90), "p99": pick(0.99)}


def run_http(url: str, concurrency: int, n_requests: int, timeout: float):
    import urllib.request

    latencies, errors = [], []
    lock = threading.Lock()
    idx = [0]

    def worker():
        while True:
            with lock:
                if idx[0] >= n_requests:
                    return
                i = idx[0]
                idx[0] += 1
            body = json.dumps({"text": TEXTS[i % len(TEXTS)],
                               "seed": 42}).encode()
            req = urllib.request.Request(
                url.rstrip("/") + "/tts", data=body,
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=timeout) as r:
                    r.read()
                with lock:
                    latencies.append(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001
                with lock:
                    errors.append(str(e))

    t_start = time.perf_counter()
    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    return latencies, errors, wall


def fetch_batch_hist(url: str) -> dict | None:
    """Server-side coalescing evidence: GET /healthz batch_hist."""
    import urllib.request

    try:
        with urllib.request.urlopen(url.rstrip("/") + "/healthz",
                                    timeout=30) as r:
            return json.load(r).get("batch_hist")
    except Exception:
        return None


def run_inprocess(service, concurrency: int, n_requests: int):
    latencies, errors = [], []
    lock = threading.Lock()
    idx = [0]

    def worker():
        while True:
            with lock:
                if idx[0] >= n_requests:
                    return
                i = idx[0]
                idx[0] += 1
            t0 = time.perf_counter()
            try:
                service.synthesize(TEXTS[i % len(TEXTS)], seed=42)
                with lock:
                    latencies.append(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001
                with lock:
                    errors.append(str(e))

    t_start = time.perf_counter()
    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return latencies, errors, time.perf_counter() - t_start


def build_tiny_service(max_batch: int, device):
    """Random-init tiny model for a smoke of the harness itself: the
    LJSpeech config at ``cli/gen_corpus.py --tiny``'s widths."""
    import torch

    from cmtts_tpu_torch.cli.gen_corpus import apply_tiny_widths
    from cmtts_tpu_torch.cli.serve import TTSService
    from cmtts_tpu_torch.core.config import config_from_dicts, load_yaml_configs
    from cmtts_tpu_torch.models.cmtts import CMTTS, init_like_flax
    from cmtts_tpu_torch.pipeline import Synthesizer

    pre, model_yaml, train = load_yaml_configs("LJSpeech")
    apply_tiny_widths(model_yaml)
    # keep the smoke texts on the micro-batched short path (the tiny
    # config's max_seq_len would otherwise trip the long-form route)
    model_yaml["max_seq_len"] = 2000
    cfg = config_from_dicts(pre, model_yaml, train, {})
    model = init_like_flax(CMTTS(cfg), torch.Generator().manual_seed(0))
    synth = Synthesizer(cfg, model, None, T=1, text_buckets=(16, 32),
                        mel_buckets=(64,), device=device)
    svc = TTSService(synth, cfg, max_batch=max_batch, batch_window_ms=8.0)
    svc._griffin = lambda mel: np.zeros(  # noqa: SLF001 — skip GL in smoke
        int(mel.shape[0]) * cfg.stft.hop_length, np.float32)
    return svc


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", type=str, default=None)
    ap.add_argument("--inprocess", action="store_true")
    ap.add_argument("--max_batch", type=int, default=8,
                    help="in-process mode: service max_batch")
    ap.add_argument("--concurrency", type=int, nargs="+", default=[1, 4, 8])
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", type=str, default=None,
                    help="write the result rows as JSON")
    ap.add_argument("--device", type=str, default="cuda",
                    help="in-process mode: the service's device")
    args = ap.parse_args(argv)
    if not args.url and not args.inprocess:
        ap.error("need --url or --inprocess")

    service = None
    if args.inprocess:
        from cmtts_tpu_torch.core.device import cli_device

        service = build_tiny_service(args.max_batch, cli_device(args.device))
    if service is not None:  # warm the graphs out of the timed region
        service.synthesize(TEXTS[0])

    rows = []
    for c in args.concurrency:
        hist_before = fetch_batch_hist(args.url) if args.url else None
        if args.inprocess:
            lat, errs, wall = run_inprocess(service, c, args.requests)
        else:
            lat, errs, wall = run_http(args.url, c, args.requests,
                                       args.timeout)
        row = {
            "concurrency": c,
            "requests": args.requests,
            "errors": len(errs),
            "req_per_s": round(len(lat) / wall, 3) if wall else 0.0,
            **{k: round(v * 1000, 1)
               for k, v in _percentiles(lat or [0]).items()},
        }
        if service is not None:
            # str keys to match the HTTP (JSON) path's histograms
            row["batch_hist"] = {str(k): v
                                 for k, v in service.batch_hist.items()}
            service.batch_hist.clear()
        elif args.url:
            # per-sweep delta of the server's cumulative histogram —
            # proves the coalescing happened during THIS sweep
            hist_after = fetch_batch_hist(args.url)
            if hist_after is not None:
                before = hist_before or {}
                delta = {k: v - before.get(k, 0)
                         for k, v in sorted(hist_after.items())
                         if v - before.get(k, 0) > 0}
                if not delta and hist_after != before:
                    # counters went backwards: server restarted mid-run
                    row["batch_hist_error"] = "server hist reset mid-sweep"
                row["batch_hist"] = delta
        rows.append(row)
        print(json.dumps(row))
    if errs := [r for r in rows if r["errors"]]:
        print(f"WARNING: {sum(r['errors'] for r in errs)} errors",
              file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
