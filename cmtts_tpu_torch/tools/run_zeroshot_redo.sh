#!/usr/bin/env bash
# Port of tools/run_zeroshot_redo.sh (round-4 zero-shot REDO) on the
# PyTorch port: a 34-voice corpus (32 train, 3 of them GE2E validation
# voices, 2 zero-shot holdouts), GE2E with unseen-speaker EER validation
# and early stopping, the holdout generalization gate, preprocessing with
# the trained GE2E, then cmtts_tpu_torch/tools/run_zeroshot_quality.sh.
# Every CLI and tool runs with --device "$DEVICE" (default cuda).
#
# Stages are resumable: each writes a .done marker under $WORK.
set -euo pipefail
cd "$(dirname "$0")/../.."

ZS=${ZS:-/tmp/zscorp2}
WORK=${WORK:-/tmp/zs_redo}
STEPS=${STEPS:-8000}
SPEAKERS=${SPEAKERS:-34}     # total voices (last HOLDOUT are zero-shot targets)
UTTS=${UTTS:-40}
HOLDOUT=${HOLDOUT:-2}
VAL_SPK=${VAL_SPK:-3}        # GE2E unseen-speaker EER validation voices
DEVICE=${DEVICE:-cuda}
mkdir -p "$WORK"

run() {
  local name=$1; shift
  if [ -f "$WORK/$name.done" ]; then echo "== [$name] cached =="; return; fi
  echo "== [$name] start $(date +%T) =="
  "$@" 2>&1 | tee "$WORK/$name.log" | tail -4
  touch "$WORK/$name.done"
  echo "== [$name] done  $(date +%T) =="
}

# 34 voices in the 4-D profile space: 32 train (3 of them GE2E-val),
# 2 zero-shot holdout
run corpus python -m cmtts_tpu_torch.cli.gen_corpus --out "$ZS" \
    --speakers "$SPEAKERS" --utts_per_speaker "$UTTS" --holdout "$HOLDOUT" \
    --val_size 16

run ge2e python -m cmtts_tpu_torch.cli.train_ge2e --wav_root "$ZS/raw" \
    --work_dir "$ZS/ge2e" --total_steps 12000 --val_speakers "$VAL_SPK" \
    --eval_every 500 --patience 4 --device "$DEVICE"

# generalization gate: abort before the long run if the encoder still
# cannot separate truly-unseen voices (the holdout pair)
run ge2e_gate python -m cmtts_tpu_torch.tools.check_ge2e_holdout \
    --embedder_ckpt "$ZS/ge2e/ge2e_params.npy" \
    --holdout_root "$ZS/raw_holdout" --train_root "$ZS/raw" \
    --min_top1 0.75 --min_margin 0.0 \
    --out "$WORK/ge2e_gate.json" --device "$DEVICE"

run preprocess python -m cmtts_tpu_torch.cli.preprocess --dataset VCTK \
    --config_root "$ZS/config" \
    --embedder_ckpt "$ZS/ge2e/ge2e_params.npy" --workers 1 --device "$DEVICE"

run chip env CORPUS="$ZS" STEPS="$STEPS" OUT="$WORK" DEVICE="$DEVICE" \
    bash cmtts_tpu_torch/tools/run_zeroshot_quality.sh

echo "== zero-shot redo complete: $(ls "$WORK"/zs_eval_*.json 2>/dev/null | tr '\n' ' ')=="
