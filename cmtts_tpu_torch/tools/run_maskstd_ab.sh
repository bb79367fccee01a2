#!/usr/bin/env bash
# Port of tools/run_maskstd_ab.sh. A/B: padded (reference-parity) vs
# masked (padding-invariant) inverse-CWT standardization, on the SAME CT
# checkpoint — inference-graph change only.
#
# The A side is the pipeline's existing step_<N>_T{1,2,4} results +
# metrics_ct_gl.txt; this script produces the B side (--cwt_masked_std,
# --tag maskstd), Griffin-Lim metrics, and (if a trained HiFi-GAN
# generator exists under $VOC_OUT) the neural-vocoded B-side metrics.
# Every CLI and tool runs with --device "$DEVICE" (default cuda).
#
#   CORPUS=/tmp/qcorp CT_STEPS=20000 VOC_OUT=/tmp/voc_run \
#       bash cmtts_tpu_torch/tools/run_maskstd_ab.sh
set -euo pipefail
cd "$(dirname "$0")/../.."

CORPUS=${CORPUS:-/tmp/qcorp}
CT_STEPS=${CT_STEPS:-20000}
VOC_OUT=${VOC_OUT:-/tmp/voc_run}
DEVICE=${DEVICE:-cuda}

for T in 1 2 4; do
  python -m cmtts_tpu_torch.cli.synthesize --mode batch \
      --source "$CORPUS/pre/val.txt" \
      --dataset LJSpeech --config_root "$CORPUS/config" --T "$T" \
      --restore_step "$CT_STEPS" --vocoder griffinlim \
      --params_role target_model --cwt_masked_std --tag maskstd \
      --device "$DEVICE"
done

: > "$CORPUS/metrics_ct_gl_maskstd.txt"
for T in 1 2 4; do
  echo "-- step_${CT_STEPS}_T${T}_maskstd (griffinlim) --" \
      | tee -a "$CORPUS/metrics_ct_gl_maskstd.txt"
  python -m cmtts_tpu_torch.cli.all_metrics --single \
      --syn_root "$CORPUS/output/result/LJSpeech_cm/step_${CT_STEPS}_T${T}_maskstd" \
      --raw_folder "$CORPUS/raw/SYN" --data_type LJSpeech \
      --metrics mcd mcd_dctmel ffe ssim f0_rmse --device "$DEVICE" 2>&1 \
      | tail -6 | tee -a "$CORPUS/metrics_ct_gl_maskstd.txt"
done

GEN=$(ls "$VOC_OUT"/hifigan/hifigan_gen_*.npz 2>/dev/null | tail -1 || true)
if [ -n "$GEN" ]; then
  : > "$VOC_OUT/metrics_maskstd.txt"
  for T in 1 2 4; do
    SRC="step_${CT_STEPS}_T${T}_maskstd"
    python -m cmtts_tpu_torch.tools.vocode_dir \
        --mel_dir "$CORPUS/output/result/LJSpeech_cm/$SRC" \
        --ckpt "$GEN" --out "$VOC_OUT/hifigan_$SRC" --device "$DEVICE"
    echo "-- hifigan_$SRC --" | tee -a "$VOC_OUT/metrics_maskstd.txt"
    python -m cmtts_tpu_torch.cli.all_metrics --single \
        --syn_root "$VOC_OUT/hifigan_$SRC" \
        --raw_folder "$CORPUS/raw/SYN" --data_type LJSpeech \
        --metrics mcd mcd_dctmel ffe ssim f0_rmse --device "$DEVICE" 2>&1 \
        | tail -6 | tee -a "$VOC_OUT/metrics_maskstd.txt"
  done
fi
echo "== maskstd A/B done =="
