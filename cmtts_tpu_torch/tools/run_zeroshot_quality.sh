#!/usr/bin/env bash
# Port of tools/run_zeroshot_quality.sh: the device half of the zero-shot
# quality protocol (docs/ROUND3_NOTES.md) on the PyTorch port.
#
# Expects the corpus stages already done under $CORPUS (defaults to
# /tmp/zscorp, produced by:
#   python -m cmtts_tpu_torch.cli.gen_corpus --out /tmp/zscorp --speakers 12 \
#       --utts_per_speaker 50 --holdout 2
#   python -m cmtts_tpu_torch.cli.train_ge2e --wav_root /tmp/zscorp/raw \
#       --work_dir /tmp/zscorp/ge2e
#   python -m cmtts_tpu_torch.cli.preprocess --dataset VCTK \
#       --config_root /tmp/zscorp/config \
#       --embedder_ckpt /tmp/zscorp/ge2e/ge2e_params.npy
# ), then runs on --device "$DEVICE" (default cuda):
#   CT training (multi-speaker, bf16, K-step loop) ->
#   zero-shot batch synthesis for each held-out speaker (GE2E ref-wav
#   conditioning, reference synthesize_zeroshot_vctk.py journey) ->
#   cmtts_tpu_torch.tools.zeroshot_eval identity-transfer scoring, on the
#   CPU in the background (two processes do not share the card).
set -euo pipefail
cd "$(dirname "$0")/../.."

CORPUS=${CORPUS:-/tmp/zscorp}
STEPS=${STEPS:-8000}
EMB=$CORPUS/ge2e/ge2e_params.npy
OUT=${OUT:-/tmp/zs_run}
DEVICE=${DEVICE:-cuda}
mkdir -p "$OUT"

echo "== train CT ($STEPS steps, bf16, K=8) =="
python -m cmtts_tpu_torch.cli.train_cm --model consistency_training \
    --dataset VCTK --config_root "$CORPUS/config" --bf16 --steps_per_call 8 \
    --total_step "$STEPS" --restore_step -1 --device "$DEVICE" \
    2>&1 | tee "$OUT/train.log" | grep -E "==>|loss" | tail -40

# the K-step loop finishes at the end of the window containing
# total_step — restore whatever step was actually saved
CKPT_DIR=$(ls -d "$CORPUS"/output/ckpt/VCTK/* | head -1)
STEP=$(ls "$CKPT_DIR" | grep -o 'step_[0-9]*' | sort -t_ -k2 -n | tail -1 | cut -d_ -f2 | sed 's/^0*//')
echo "== restoring step $STEP from $CKPT_DIR =="

# holdout speakers = whatever gen_corpus held out, not a hardcoded pair
for SPK in $(ls "$CORPUS/raw_holdout"); do
  grep "^${SPK}_" "$CORPUS/zeroshot_source.txt" > "$OUT/source_$SPK.txt"
  echo "== zero-shot synthesis: $SPK (T=1) =="
  python -m cmtts_tpu_torch.cli.synthesize_zeroshot --mode batch \
      --source "$OUT/source_$SPK.txt" --dataset VCTK \
      --config_root "$CORPUS/config" --restore_step "$STEP" --T 1 \
      --ref_wav "$CORPUS/raw_holdout/$SPK/${SPK}_000.wav" \
      --embedder_ckpt "$EMB" --tag "zs_$SPK" --device "$DEVICE" 2>&1 | tail -3
  SYN="$CORPUS/output/result/VCTK_cm/step_${STEP}_T1_zs_${SPK}"
  # the eval runs on the CPU in the background, so that the next
  # speaker's synthesis starts at once and no two processes share the card
  echo "== identity-transfer eval (backgrounded): $SPK (syn dir: $SYN) =="
  python -m cmtts_tpu_torch.tools.zeroshot_eval \
      --syn_dir "$SYN" --target_raw "$CORPUS/raw_holdout/$SPK" \
      --others_root "$CORPUS/raw" --embedder_ckpt "$EMB" \
      --out "$OUT/zs_eval_$SPK.json" --device cpu > "$OUT/eval_$SPK.log" 2>&1 &
done
wait
echo "== done: $(ls "$OUT"/zs_eval_*.json 2>/dev/null | tr '\n' ' ')=="
