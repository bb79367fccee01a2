"""Image-domain CM sampling harness (port of ``cli/image_sample.py``).

Parity with reference ``image_sample.py`` (duplicated verbatim at
``model/cm_tool/image_sample.py``): build the image UNet + EDM schedule
from the same flag surface, draw ``num_samples`` samples with the chosen
Karras sampler, and save a ``samples_{N}x{H}x{W}x3.npz`` of uint8 NHWC
images (+ labels when class-conditional).

    python -m cmtts_tpu_torch.cli.image_sample --image_size 64 \
        --num_channels 192 --num_res_blocks 3 --class_cond True \
        --training_mode consistency_distillation --sampler multistep \
        --ts 0,22,39 --steps 40 --model_path cd_imagenet64_l2.pt

``--model_path`` takes a reference ``.pt``/``.pth`` (converted on load),
a flattened flax ``.npz`` (``a/b/c`` keys), or nothing (random weights
drawn as flax draws them, with a warning).  Runs on ``--device`` (default
``cuda``, which must be present), in float32: ``--use_fp16``,
``--use_checkpoint`` and ``--loss_norm`` are accepted and ignored.
x_T, every later draw and the labels come from one generator seeded by
``--seed`` on the device.
"""

from __future__ import annotations

import argparse
import os
import warnings


def str2bool(v):  # reference script_util.py:262-271
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def create_argparser():
    """Same surface as reference image_sample.py:121-140 +
    model_and_diffusion_defaults (script_util.py:27-53), and ``--device``."""
    defaults = dict(
        training_mode="edm", generator="determ", clip_denoised=True,
        num_samples=64, batch_size=16, sampler="heun", s_churn=0.0,
        s_tmin=0.0, s_tmax=float("inf"), s_noise=1.0, steps=40,
        model_path="", seed=42, ts="",
        # model_and_diffusion_defaults
        sigma_min=0.002, sigma_max=80.0, image_size=64, num_channels=128,
        num_res_blocks=2, num_heads=4, num_heads_upsample=-1,
        num_head_channels=-1, attention_resolutions="32,16,8",
        channel_mult="", dropout=0.0, class_cond=False,
        use_scale_shift_norm=True, resblock_updown=False,
        use_new_attention_order=False, learn_sigma=False,
        weight_schedule="karras", out_dir="./image_samples",
        # accepted for reference-command-line compatibility; no-ops
        use_fp16=False, use_checkpoint=False, loss_norm="lpips",
        device="cuda",
    )
    p = argparse.ArgumentParser()
    for k, v in defaults.items():
        t = type(v)
        if t is bool:
            p.add_argument(f"--{k}", type=str2bool, default=v)
        else:
            p.add_argument(f"--{k}", type=t, default=v)
    return p


def load_unet_params(path: str, unet, seed: int):
    """Load ``path`` into ``unet`` (reference ``.pt``/``.pth`` through
    :func:`cmtts_tpu_torch.models.unet.convert_torch_unet`, or a flat flax
    ``.npz``), or draw random weights from ``seed`` when ``path`` is
    empty."""
    import torch

    from cmtts_tpu_torch.convert import load_flax_params
    from cmtts_tpu_torch.models.hifigan import unflatten_npz
    from cmtts_tpu_torch.models.unet import convert_torch_unet, init_like_flax

    if path and (path.endswith(".pt") or path.endswith(".pth")):
        sd = torch.load(path, map_location="cpu", weights_only=False)
        sd = sd.get("state_dict", sd) if isinstance(sd, dict) else sd
        sd = {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
        return load_flax_params(unet, convert_torch_unet(sd, unet.cfg))
    if path and path.endswith(".npz"):
        return load_flax_params(unet, unflatten_npz(path))
    warnings.warn("no --model_path given; sampling from a random-init UNet")
    return init_like_flax(unet, torch.Generator().manual_seed(seed))


def main(argv=None):
    args = create_argparser().parse_args(argv)
    import numpy as np
    import torch

    from cmtts_tpu_torch.cm.image import karras_sample_image, to_uint8
    from cmtts_tpu_torch.cm.karras import KarrasSchedule
    from cmtts_tpu_torch.core.device import resolve_device
    from cmtts_tpu_torch.models.unet import NUM_CLASSES, create_image_unet

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # float32 as the JAX CLI computes it, not TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    unet = create_image_unet(
        args.image_size, args.num_channels, args.num_res_blocks,
        channel_mult=args.channel_mult, learn_sigma=args.learn_sigma,
        class_cond=args.class_cond,
        attention_resolutions=args.attention_resolutions,
        num_heads=args.num_heads, num_head_channels=args.num_head_channels,
        num_heads_upsample=args.num_heads_upsample,
        use_scale_shift_norm=args.use_scale_shift_norm,
        dropout=args.dropout, resblock_updown=args.resblock_updown,
        use_new_attention_order=args.use_new_attention_order)
    sched = KarrasSchedule(
        sigma_min=args.sigma_min, sigma_max=args.sigma_max,
        distillation="consistency" in args.training_mode)
    unet = load_unet_params(args.model_path, unet, args.seed).to(dev).eval()

    ts = tuple(int(x) for x in args.ts.split(",")) if args.ts else None
    if args.sampler == "multistep":
        assert ts, "--ts required for the multistep sampler"

    gen = torch.Generator(dev).manual_seed(args.seed)
    all_images, all_labels = [], []
    n_done = 0
    while n_done < args.num_samples:
        y = (torch.randint(0, NUM_CLASSES, (args.batch_size,),
                           generator=gen, device=dev)
             if args.class_cond else None)
        sample = karras_sample_image(
            unet, (args.batch_size, 3, args.image_size, args.image_size),
            sched, sampler=args.sampler, steps=args.steps, ts=ts,
            clip_denoised=args.clip_denoised, s_churn=args.s_churn,
            s_tmin=args.s_tmin, s_tmax=args.s_tmax, s_noise=args.s_noise,
            model_kwargs=None if y is None else {"y": y}, generator=gen,
            device=dev)
        all_images.append(to_uint8(sample))
        if args.class_cond:
            all_labels.append(y.cpu().numpy())
        n_done += args.batch_size
        print(f"created {n_done} samples")

    arr = np.concatenate(all_images, axis=0)[: args.num_samples]
    os.makedirs(args.out_dir, exist_ok=True)
    shape_str = "x".join(str(x) for x in arr.shape)
    out_path = os.path.join(args.out_dir, f"samples_{shape_str}.npz")
    if args.class_cond:
        labels = np.concatenate(all_labels, axis=0)[: args.num_samples]
        np.savez(out_path, arr, labels)
    else:
        np.savez(out_path, arr)
    print(f"saved {out_path}")
    return out_path


if __name__ == "__main__":
    main()
