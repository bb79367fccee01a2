#!/usr/bin/env bash
# Port of tools/run_serve_bench.sh: start cmtts_tpu_torch.cli.serve against
# the quality-run checkpoint, sweep concurrency with
# cmtts_tpu_torch.tools.bench_serve, write $OUT (latency percentiles,
# throughput, and the /healthz batch-histogram delta proving micro-batch
# coalescing), then shut the server down.
#
#   CORPUS=/tmp/qcorp STEP=20000 OUT=SERVE_r04.json \
#       bash cmtts_tpu_torch/tools/run_serve_bench.sh
#
# CONCURRENCY, REQUESTS and PRIME_REQUESTS set the sweep (defaults: the JAX
# script's 1 2 4 8, 32 and 16); the server runs with --device "$DEVICE"
# (default cuda); its log and the sweeps' rows go under $TMPDIR.
set -uo pipefail
cd "$(dirname "$0")/../.."

CORPUS=${CORPUS:-/tmp/qcorp}
STEP=${STEP:-20000}
PORT=${PORT:-18321}
OUT=${OUT:-SERVE_r04.json}
VOC=${VOC:-griffinlim}            # or: hifigan + VOC_CKPT=<npz>
DEVICE=${DEVICE:-cuda}
CONCURRENCY=${CONCURRENCY:-1 2 4 8}
REQUESTS=${REQUESTS:-32}
PRIME_REQUESTS=${PRIME_REQUESTS:-16}
TMP=${TMPDIR:-/tmp}
LOG=$TMP/serve_bench.log

# Lazy warmup + the priming sweep below run only the handful of buckets the
# benchmark texts actually hit; the priming pass is discarded.
args=(--dataset LJSpeech --config_root "$CORPUS/config" \
      --restore_step "$STEP" --params_role target_model \
      --vocoder "$VOC" --port "$PORT" \
      --max_batch 8 --batch_window_ms 20 --device "$DEVICE")
[ -n "${VOC_CKPT:-}" ] && args+=(--vocoder_ckpt "$VOC_CKPT")

python -m cmtts_tpu_torch.cli.serve "${args[@]}" > "$LOG" 2>&1 &
SRV=$!
trap 'kill $SRV 2>/dev/null' EXIT

# Wait up to 40 min and ABORT if the server never listens — benching a
# non-listening server records 100% errors, not latencies.
echo "== waiting for server (pid $SRV) to warm up =="
UP=0
for i in $(seq 1 2400); do
  if python -c "import sys, urllib.request; urllib.request.urlopen(sys.argv[1], timeout=2)" \
      "http://127.0.0.1:$PORT/healthz" >/dev/null 2>&1; then
    echo "== server up after ~${i}s =="
    UP=1
    break
  fi
  if ! kill -0 $SRV 2>/dev/null; then
    echo "server died; log tail:"; tail -20 "$LOG"; exit 1
  fi
  sleep 1
done
if [ "$UP" != 1 ]; then
  echo "server never came up; warmup log tail:"; tail -5 "$LOG"; exit 1
fi

# priming sweep: drives every benchmark text through every batch size
# so the lazily-built buckets exist before the timed sweeps
echo "== priming (runs the needed buckets; discarded) =="
python -m cmtts_tpu_torch.tools.bench_serve --url "http://127.0.0.1:$PORT" \
    --concurrency $CONCURRENCY --requests "$PRIME_REQUESTS" --timeout 300 \
    --out "$TMP/serve_prime.json" --device "$DEVICE" || exit 1
cat "$TMP/serve_prime.json"

python -m cmtts_tpu_torch.tools.bench_serve --url "http://127.0.0.1:$PORT" \
    --concurrency $CONCURRENCY --requests "$REQUESTS" \
    --out "$TMP/serve_rows.json" --device "$DEVICE" || exit 1

DEVICE_NAME=$DEVICE
if [ "$DEVICE" != cpu ]; then
  DEVICE_NAME=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | head -1)
fi
python - "$OUT" "${ROUND:-5}" "$VOC" "$TMP/serve_rows.json" "$DEVICE_NAME" \
    "$REQUESTS" <<'PY'
import json, sys
out, rnd, voc, rows_path, device, n = sys.argv[1:7]
rows = json.load(open(rows_path))
json.dump({
  "round": int(rnd),
  "protocol": ("cmtts_tpu_torch.cli.serve (target_model role of the "
               "quality checkpoint, T=1, batch_window_ms=20, max_batch=8, "
               f"vocoder={voc}) driven by cmtts_tpu_torch.tools.bench_serve: "
               f"{n} requests per concurrency level over live HTTP after a "
               "discarded priming sweep over every concurrency level; "
               "batch_hist is the server-reported per-sweep coalescing "
               "histogram"),
  "device": device,
  "sweep": rows,
}, open(out, "w"), indent=1)
print("wrote", out)
PY

kill $SRV 2>/dev/null
wait $SRV 2>/dev/null
echo "== serve bench done =="
