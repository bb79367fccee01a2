#!/usr/bin/env bash
# Port of tools/run_quality_pipeline.sh: the quality pipeline (the
# QUALITY_r03 protocol, end to end, from a bare repo) on the PyTorch port:
# parametric corpus -> preprocess -> CT training -> T=1/2/4 synthesis of
# the held-out val set -> Griffin-Lim metrics. Optionally chains the
# vocoder-isolation protocol (cmtts_tpu_torch/tools/run_vocoder_quality.sh)
# and a consistency-distillation run that uses the CT checkpoint as teacher.
#
# Every CLI and tool runs with --device "$DEVICE" (default cuda; DEVICE=cpu
# rehearses the script on the CPU, e.g. with GEN_ARGS=--tiny).
# Stages are resumable: each writes a .done marker under $CORPUS. CT_STEPS
# should be a multiple of --steps_per_call 8: the K-step loop saves at the
# end of the window that contains total_step, and synthesis restores
# step CT_STEPS (as the JAX script does).
set -euo pipefail
cd "$(dirname "$0")/../.."

CORPUS=${CORPUS:-/tmp/qcorp}
N=${N:-400}
VAL=${VAL:-16}
BATCH=${BATCH:-32}
CT_STEPS=${CT_STEPS:-6000}
CD_STEPS=${CD_STEPS:-4000}
RUN_VOCODER=${RUN_VOCODER:-1}
RUN_CD=${RUN_CD:-1}
GEN_ARGS=${GEN_ARGS:-}      # extra cli.gen_corpus args (e.g. --det_prosody)
CT_ARGS=${CT_ARGS:-}        # extra cli.train_cm args (e.g. --cwt_masked_std)
DEVICE=${DEVICE:-cuda}
export DEVICE

stage() { # stage <name> <cmd...>
  local name=$1; shift
  local marker="$CORPUS/.stage_$name.done"
  if [ -f "$marker" ]; then echo "== [$name] already done =="; return 0; fi
  echo "== [$name] start $(date -u +%H:%M:%S) =="
  "$@"
  touch "$marker"
  echo "== [$name] done  $(date -u +%H:%M:%S) =="
}

mkdir -p "$CORPUS"

stage corpus python -m cmtts_tpu_torch.cli.gen_corpus --out "$CORPUS" \
    --n "$N" --val_size "$VAL" --batch_size "$BATCH" \
    --save_step 2000 --log_step 200 $GEN_ARGS

stage preprocess python -m cmtts_tpu_torch.cli.preprocess \
    --dataset LJSpeech --config_root "$CORPUS/config" \
    --workers 8 --device "$DEVICE"

stage train_ct python -m cmtts_tpu_torch.cli.train_cm \
    --model consistency_training \
    --dataset LJSpeech --config_root "$CORPUS/config" \
    --total_step "$CT_STEPS" --bf16 --steps_per_call 8 \
    --restore_step -1 --device "$DEVICE" $CT_ARGS

synth_all_T() {
  for T in 1 2 4; do
    python -m cmtts_tpu_torch.cli.synthesize --mode batch \
        --source "$CORPUS/pre/val.txt" \
        --dataset LJSpeech --config_root "$CORPUS/config" --T "$T" \
        --restore_step "$CT_STEPS" --vocoder griffinlim \
        --params_role target_model --device "$DEVICE" "$@"
  done
}
stage synth_ct synth_all_T

metrics_dir() { # metrics_dir <syn_dir> <out_txt>
  python -m cmtts_tpu_torch.cli.all_metrics --single --syn_root "$1" \
      --raw_folder "$CORPUS/raw/SYN" --data_type LJSpeech \
      --metrics mcd mcd_dctmel ffe ssim f0_rmse --device "$DEVICE" 2>&1 \
      | tail -6 | tee -a "$2"
}
gl_metrics() {
  : > "$CORPUS/metrics_ct_gl.txt"
  for T in 1 2 4; do
    echo "-- step_${CT_STEPS}_T${T} (griffinlim) --" | tee -a "$CORPUS/metrics_ct_gl.txt"
    metrics_dir "$CORPUS/output/result/LJSpeech_cm/step_${CT_STEPS}_T${T}" \
        "$CORPUS/metrics_ct_gl.txt"
  done
}
stage metrics_ct gl_metrics

if [ "$RUN_VOCODER" = "1" ]; then
  stage vocoder env CORPUS="$CORPUS" OUT="${VOC_OUT:-/tmp/voc_run}" \
      CT_STEPS="$CT_STEPS" bash cmtts_tpu_torch/tools/run_vocoder_quality.sh
fi

if [ "$RUN_CD" = "1" ]; then
  TEACHER="$CORPUS/output/ckpt/LJSpeech/CMDenoiserTTS/step_$(printf %08d "$CT_STEPS")"
  stage train_cd python -m cmtts_tpu_torch.cli.train_cm \
      --model consistency_distillation \
      --teacher_path "$TEACHER" --path_tag cd \
      --dataset LJSpeech --config_root "$CORPUS/config" \
      --total_step "$CD_STEPS" --bf16 --steps_per_call 8 --restore_step -1 \
      --device "$DEVICE"

  cd_synth() {
    for T in 1 2 4; do
      python -m cmtts_tpu_torch.cli.synthesize --mode batch \
          --source "$CORPUS/pre/val.txt" \
          --dataset LJSpeech --config_root "$CORPUS/config" --T "$T" \
          --restore_step "$CD_STEPS" --vocoder griffinlim \
          --params_role target_model --path_tag cd --device "$DEVICE"
    done
  }
  stage synth_cd cd_synth

  cd_metrics() {
    : > "$CORPUS/metrics_cd_gl.txt"
    for T in 1 2 4; do
      echo "-- cd step_${CD_STEPS}_T${T} (griffinlim) --" | tee -a "$CORPUS/metrics_cd_gl.txt"
      metrics_dir "$CORPUS/output/result/LJSpeech_cm_cd/step_${CD_STEPS}_T${T}" \
          "$CORPUS/metrics_cd_gl.txt"
    done
  }
  stage metrics_cd cd_metrics
fi

echo "== pipeline complete =="
