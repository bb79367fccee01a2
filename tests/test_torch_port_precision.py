"""Every command-line entry point of the port computes float32 in float32:
its device setup goes through ``core/device.py::cli_device``, which turns
TF32 off for cuDNN convolutions and CUDA matmuls.  The AST scan makes a new
CLI that takes ``--device`` without that call fail here; each CLI's main is
run up to its device setup (with ``--device cpu``) and stopped there."""

import ast
import importlib
import os

import pytest
import torch

import cmtts_tpu_torch.core.device as device_mod

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cmtts_tpu_torch")

# the least arguments that carry each CLI's main to its device setup
CLI_ARGS = {
    "all_metrics": ["--syn_root", "s", "--raw_folder", "r",
                    "--metrics", "mcd"],
    "evaluate": ["--dataset", "LJSpeech"],
    "get_mel_cache": ["--wav_dir", "w", "--out_dir", "o"],
    "image_sample": [],
    "p_rtf_cm": ["--source", "s", "--dataset", "LJSpeech"],
    "preprocess": ["--dataset", "LJSpeech"],
    "serve": ["--restore_step", "0"],
    "synthesize": ["--mode", "single", "--text", "a"],
    "synthesize_zeroshot": ["--text", "a", "--spker_embed", "e.npy"],
    "train_cm": ["--model", "consistency_training", "--dataset", "LJSpeech"],
    "train_ge2e": ["--wav_root", "r", "--work_dir", "w"],
    "train_hifigan": ["--wav_root", "r", "--work_dir", "w"],
}


def _calls(tree, name):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "id", getattr(n.func, "attr", None)) == name]


def _device_entry_points(capsys, sub):
    """{module name: AST} of every module of ``cmtts_tpu_torch/<sub>`` whose
    ``--help`` lists ``--device`` (some take it from a shared parser
    helper)."""
    out = {}
    for fname in sorted(os.listdir(os.path.join(PKG, sub))):
        if not fname.endswith(".py") or fname == "__init__.py":
            continue
        main = importlib.import_module(
            f"cmtts_tpu_torch.{sub}.{fname[:-3]}").main
        with pytest.raises(SystemExit):
            main(["--help"])
        if "--device" in capsys.readouterr().out:
            with open(os.path.join(PKG, sub, fname)) as f:
                out[fname[:-3]] = ast.parse(f.read())
    return out


@pytest.mark.parametrize("sub", ["cli", "tools"])
def test_every_entry_point_sets_up_its_device_through_the_policy(capsys,
                                                                 sub):
    found = _device_entry_points(capsys, sub)
    if sub == "cli":
        assert set(found) == set(CLI_ARGS), (
            "a CLI that takes --device needs an entry here: "
            f"{sorted(set(found) ^ set(CLI_ARGS))}")
    else:               # every tool but the host-only extend_holdout
        assert set(found) == {"vocode_dir", "check_ge2e_holdout",
                              "zeroshot_eval", "diag_pitch", "bench_train",
                              "bench_serve"}
    for name, tree in found.items():
        calls = _calls(tree, "cli_device")
        assert calls, f"{name} does not call core.device.cli_device"
        assert any(ast.unparse(c.args[0]) == "args.device" for c in calls
                   if c.args), f"{name}: cli_device is not given --device"


class _Reached(Exception):
    pass


@pytest.mark.parametrize("name", sorted(CLI_ARGS))
def test_cli_device_setup_turns_tf32_off(name, monkeypatch):
    real = device_mod.cli_device

    def stop_after(device=None):
        real(device)
        raise _Reached(device)

    monkeypatch.setattr(device_mod, "cli_device", stop_after)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        main = importlib.import_module(f"cmtts_tpu_torch.cli.{name}").main
        with pytest.raises(_Reached, match="cpu"):
            main(CLI_ARGS[name] + ["--device", "cpu"])
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
