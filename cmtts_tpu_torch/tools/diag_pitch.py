"""Pitch-path diagnostic: where do the F0 errors come from?  Port of
``tools/diag_pitch.py`` (the model on ``--device`` through the port's
``CMTTS.condition``, the inverse CWT and de-normalisation through the
port's ``audio/pitch.py::cwt2f0_norm`` / ``denorm_f0``, the checkpoint
through ``train/checkpoint.py``).

The end-to-end metric path is
  model pitch head -> mel -> vocoder -> YIN -> DTW -> cents RMSE
which mixes FIVE error sources.  This tool isolates the model's pitch
head alone: durations are teacher-forced so the predicted f0 contour is
frame-aligned with the ground truth, and the predicted CWT / stats / uv
components are swapped with their ground-truth counterparts one at a
time (reference decomposition: ``cwt2f0_norm`` utils/pitch_tools.py:274-279,
stats head ``model/modules.py`` cwt_stats_layers, uv gating
``denorm_f0`` utils/pitch_tools.py:64-78).

Variants (all teacher-forced durations):
  recon      GT cwt + GT stats + GT uv     -> inverse-CWT reconstruction
                                              ceiling (pipeline sanity)
  pred_cwt   pred cwt + GT stats + GT uv   -> CWT-shape error alone
  pred_stats pred cwt + pred stats + GT uv -> + stats-head error
  pred_all   pred cwt + pred stats + pred uv -> full model (still no
                                              vocoder/YIN/DTW noise)

Reported per variant: voiced-frame RMSE in cents, UV error rate, and
the per-utterance stats-head deltas.

Usage:
  python -m cmtts_tpu_torch.tools.diag_pitch --dataset LJSpeech \\
      --config_root /tmp/qcorp/config --restore_step 20000 [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="LJSpeech")
    ap.add_argument("--config_root", default="/tmp/qcorp/config")
    ap.add_argument("--restore_step", type=int, default=0)
    ap.add_argument("--params_role", default="target_model")
    ap.add_argument("--split", default="val.txt")
    ap.add_argument("--out", default=None, help="optional JSON output path")
    ap.add_argument("--cwt_masked_std", action="store_true",
                    help="diagnose with padding-invariant inverse-CWT "
                         "standardization (PitchConfig.cwt_masked_std)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from cmtts_tpu_torch.audio.pitch import cwt2f0_norm, denorm_f0
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.core.device import cli_device
    from cmtts_tpu_torch.data.dataset import FeatureDataset, batch_iterator
    from cmtts_tpu_torch.models.cmtts import CMTTS
    from cmtts_tpu_torch.train.checkpoint import restore_checkpoint
    from cmtts_tpu_torch.train.loop import batch_to_device

    device = cli_device(args.device)
    cfg = load_configs(args.dataset, args.config_root)
    if args.cwt_masked_std:
        import dataclasses

        cfg = dataclasses.replace(cfg, pitch=dataclasses.replace(
            cfg.pitch, cwt_masked_std=True))
    payload = restore_checkpoint(cfg.train.ckpt_path, args.restore_step or None)
    model = CMTTS(cfg)
    model.load_state_dict(payload[args.params_role], strict=True)
    model = model.to(device).eval()
    pc = cfg.pitch
    vp = cfg.model.variance_predictor

    @torch.no_grad()
    def run(batch):
        # teacher-forced durations (mel2ph + d_targets), PREDICTED pitch
        out = model.condition(
            batch["texts"], batch["src_lens"], batch["mels"].shape[1],
            speakers=batch["speakers"],
            spker_embeds=batch.get("spker_embeds"),
            mel2ph=batch["mel2ph"], d_targets=batch["d_targets"],
            p_targets=None, e_targets=batch["e_targets"], deterministic=True)
        return {k: v.cpu().numpy() for k, v in out["p_pred"].items()
                if v is not None}

    def f0_hz(norm_f0, uv):
        """normalized (log2) f0 + uv gate -> Hz, 0 where unvoiced."""
        return denorm_f0(torch.as_tensor(norm_f0, device=device),
                         torch.as_tensor(uv, device=device), pc.pitch_norm,
                         pc.f0_mean, pc.f0_std,
                         use_uv=pc.use_uv).cpu().numpy()

    variants = ["recon", "pred_cwt", "pred_stats", "pred_all"]
    sq_cents = {v: 0.0 for v in variants}
    n_cents = {v: 0 for v in variants}
    uv_err = {v: 0 for v in variants}
    n_frames = 0
    stat_rows = []

    dataset = FeatureDataset(args.split, cfg, sort=False, drop_last=False,
                             cache_in_ram=False)  # single pass
    bs = min(cfg.train.batch_size, len(dataset))
    for batch in batch_iterator(dataset, bs, group_size=1,
                                shuffle=False, epochs=1):
        clean = {k: v for k, v in batch.items()
                 if k not in ("ids", "raw_texts")}
        p_pred = run(batch_to_device(clean, device))
        t_mel = clean["mels"].shape[1]
        pt = clean["p_targets"]
        gt_uv = np.asarray(pt["uv"])             # (B, T) 1 = unvoiced
        gt_f0_hz = f0_hz(pt["f0"], gt_uv)

        gt_mean, gt_std = np.asarray(pt["f0_mean"]), np.asarray(pt["f0_std"])
        pr_mean, pr_std = p_pred["f0_mean"], p_pred["f0_std"]
        pr_cwt = p_pred["cwt"][..., :10]
        pr_uv = (p_pred["cwt"][..., -1] > 0).astype(np.float32)

        valid_mask = (np.arange(t_mel)[None, :]
                      < np.asarray(clean["mel_lens"])[:, None])

        def norm_from(cwt, mean, std):
            def dev(a):
                return torch.as_tensor(np.asarray(a, np.float32),
                                       device=device)

            mask = (torch.as_tensor(valid_mask, device=device)
                    if args.cwt_masked_std else None)
            return cwt2f0_norm(
                dev(cwt), dev(mean), dev(std), t_mel, pc.pitch_norm,
                pc.f0_mean, pc.f0_std, pc.pitch_norm_eps,
                mask=mask).cpu().numpy()

        hz = {
            "recon": f0_hz(norm_from(pt["cwt_spec"], gt_mean, gt_std), gt_uv),
            "pred_cwt": f0_hz(norm_from(pr_cwt, gt_mean, gt_std), gt_uv),
            "pred_stats": f0_hz(
                norm_from(pr_cwt, pr_mean, pr_std * vp.cwt_std_scale), gt_uv),
            "pred_all": f0_hz(
                norm_from(pr_cwt, pr_mean, pr_std * vp.cwt_std_scale), pr_uv),
        }
        uv_of = {"recon": gt_uv, "pred_cwt": gt_uv,
                 "pred_stats": gt_uv, "pred_all": pr_uv}

        # valid frames: inside the true mel length
        valid = valid_mask
        n_frames += int(valid.sum())
        for v in variants:
            both = valid & (gt_f0_hz > 0) & (hz[v] > 0)
            d = 1200.0 * np.log2(hz[v][both] / gt_f0_hz[both])
            sq_cents[v] += float((d ** 2).sum())
            n_cents[v] += int(both.sum())
            uv_err[v] += int((valid & (uv_of[v] != gt_uv)).sum())

        for i in range(len(gt_mean)):
            stat_rows.append({
                "gt_mean": float(gt_mean[i]), "pr_mean": float(pr_mean[i]),
                "gt_std": float(gt_std[i]),
                "pr_std_scaled": float(pr_std[i] * vp.cwt_std_scale),
            })

    report = {"n_utts": len(stat_rows), "n_frames": n_frames, "variants": {}}
    for v in variants:
        report["variants"][v] = {
            "f0_rmse_cents_voiced": round(
                float(np.sqrt(sq_cents[v] / max(n_cents[v], 1))), 2),
            "voiced_frames": n_cents[v],
            "uv_err_rate": round(uv_err[v] / max(n_frames, 1), 4),
        }
    dm = np.array([r["pr_mean"] - r["gt_mean"] for r in stat_rows])
    rs = np.array([r["pr_std_scaled"] / max(r["gt_std"], 1e-6)
                   for r in stat_rows])
    report["stats_head"] = {
        # mean is on natural-log f0: 100*delta ~= cents/12 ... report both
        "mean_bias_lnf0": round(float(dm.mean()), 4),
        "mean_abs_err_lnf0": round(float(np.abs(dm).mean()), 4),
        "mean_abs_err_cents": round(float(np.abs(dm).mean())
                                    * 1200.0 / np.log(2.0), 1),
        "std_ratio_mean": round(float(rs.mean()), 3),
        "std_ratio_min_max": [round(float(rs.min()), 3),
                              round(float(rs.max()), 3)],
    }

    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
