#!/usr/bin/env bash
# Port of tools/run_vocoder_quality.sh: train HiFi-GAN from scratch on the
# parametric quality corpus with the PyTorch port, then re-vocode the SAME
# CM-predicted mels that produced the Griffin-Lim numbers -- the metric
# delta is attributable to the vocoder alone.
#
# Expects the quality-loop working dir (default /tmp/qcorp, produced by
# cmtts_tpu_torch/tools/run_quality_pipeline.sh: cli.gen_corpus ->
# cli.preprocess -> cli.train_cm -> cli.synthesize per checkpoint).
# Every CLI and tool runs with --device "$DEVICE" (default cuda).
set -euo pipefail
cd "$(dirname "$0")/../.."

CORPUS=${CORPUS:-/tmp/qcorp}
OUT=${OUT:-/tmp/voc_run}
STEPS=${STEPS:-10000}
CT_STEPS=${CT_STEPS:-6000}
DEVICE=${DEVICE:-cuda}
mkdir -p "$OUT"

echo "== train HiFi-GAN ($STEPS steps, batch 16, paper-scale) =="
python -m cmtts_tpu_torch.cli.train_hifigan --wav_root "$CORPUS/raw" \
    --work_dir "$OUT/hifigan" --total_steps "$STEPS" --resume \
    --save_every 5000 --log_every 200 --device "$DEVICE" 2>&1 \
    | tee "$OUT/train_hifigan.log" | tail -20
GEN=$(ls "$OUT"/hifigan/hifigan_gen_*.npz | tail -1)
echo "== generator: $GEN =="

RESULT="$CORPUS/output/result/LJSpeech_cm"
for SRC in step_${CT_STEPS}_T1 step_${CT_STEPS}_T2 step_${CT_STEPS}_T4; do
  echo "== vocode CM mels: $SRC =="
  python -m cmtts_tpu_torch.tools.vocode_dir --mel_dir "$RESULT/$SRC" \
      --ckpt "$GEN" --out "$OUT/hifigan_$SRC" --device "$DEVICE"
done

echo "== vocoder floor: GT mels through the trained HiFi-GAN =="
mkdir -p "$OUT/gtmel"
python - "$CORPUS" "$OUT" <<'PY'
import os, shutil, sys
corpus, out = sys.argv[1], sys.argv[2]
# GT mels of the val utterances, preprocessor layout SYN-mel-<base>.npy
val = [l.split("|")[0] for l in open(os.path.join(corpus, "pre", "val.txt"))]
for b in val:
    src = os.path.join(corpus, "pre", "mel", f"SYN-mel-{b}.npy")
    shutil.copy(src, os.path.join(out, "gtmel", f"SYN-mel-{b}.npy"))
PY
python -m cmtts_tpu_torch.tools.vocode_dir --mel_dir "$OUT/gtmel" \
    --ckpt "$GEN" --out "$OUT/hifigan_gtmel" --device "$DEVICE"

echo "== metrics (syn vs raw) =="
for D in hifigan_step_${CT_STEPS}_T1 hifigan_step_${CT_STEPS}_T2 hifigan_step_${CT_STEPS}_T4 hifigan_gtmel; do
  echo "-- $D --" | tee -a "$OUT/metrics.txt"
  python -m cmtts_tpu_torch.cli.all_metrics --single --syn_root "$OUT/$D" \
      --raw_folder "$CORPUS/raw/SYN" --data_type LJSpeech \
      --metrics mcd mcd_dctmel ffe ssim f0_rmse --device "$DEVICE" 2>&1 \
      | tail -6 | tee -a "$OUT/metrics.txt"
done
echo "== done; metrics in $OUT/metrics.txt =="
