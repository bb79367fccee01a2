"""The rank side of tests/test_torch_port_parallel.py: each of two gloo
ranks on the CPU runs every case on the inputs the test wrote and saves
what it computed; the test holds it against the single-process results.
Imports torch, numpy and the port only."""

import os
import traceback

import torch
import torch.distributed as dist


def _model(inp):
    from cmtts_tpu_torch.core.config import config_from_dicts
    from cmtts_tpu_torch.models.cmtts import CMTTS

    cfg = config_from_dicts(*inp["dicts"])
    model = CMTTS(cfg)
    model.load_state_dict(inp["params"])
    return cfg, model.eval()


def _state_arrays(state) -> dict:
    trees = {"params": state.params, "target": state.target_params,
             "mu": state.opt_state["mu"], "nu": state.opt_state["nu"],
             **{f"ema_{i}": e for i, e in enumerate(state.ema_params)}}
    return {name: {k: v.detach().clone() for k, v in t.items()}
            for name, t in trees.items()}


def _step(inp, batch, dp_group=None, tp_group=None, rank=0, dp=1,
          microbatch=0, draws="draws4"):
    """One CT step of this rank on its rows of ``batch`` with the global
    draws ``inp[draws]``; -> (gathered state arrays, scalar metrics,
    gathered indices, gathered per-sample losses)."""
    from cmtts_tpu_torch.parallel.distributed import (
        gather_per_sample,
        rank_rows,
        tp_gather_state,
        tp_shard_state,
    )
    from cmtts_tpu_torch.train.loop import batch_to_device, make_train_step
    from cmtts_tpu_torch.train.state import RAdam, create_train_state

    cfg, model = _model(inp)
    opt = RAdam(1e-3)
    state = create_train_state(dict(model.named_parameters()), opt, 3)
    if tp_group is not None:
        state = tp_shard_state(state, dist.get_rank(tp_group),
                               dist.get_world_size(tp_group))
    step = make_train_step(model, cfg, opt, 3, microbatch=microbatch,
                           dp_group=dp_group, tp_group=tp_group)
    idx, noise = inp[draws]
    local = batch_to_device(rank_rows(batch, rank, dp), "cpu")
    state, m = step(state, local, inp["probs"], 0.95, indices=idx,
                    noise=noise)
    state = tp_gather_state(state, tp_group)
    scalars = {k: float(v) for k, v in m.items() if v.ndim == 0}
    return (_state_arrays(state), scalars,
            gather_per_sample(m["indices"], dp_group),
            gather_per_sample(m["loss_per_sample"], dp_group))


def _synth(inp, counts, name, dp_group=None, tp_group=None, seqs="seqs"):
    """One synthesis call on this rank; ``counts[name]`` gets the rise of
    the synthesis-call counters over it."""
    from cmtts_tpu_torch.core.trace import counters
    from cmtts_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
    from cmtts_tpu_torch.pipeline import GRAPH_COUNTERS, Synthesizer

    cfg, model = _model(inp)
    voc = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=32,
                                         num_mels=16))
    voc.load_state_dict(inp["vocoder"])
    synth = Synthesizer(cfg, model, voc.eval(), text_buckets=(8,),
                        mel_buckets=(32,), compute_dtype=torch.float32,
                        device="cpu", dp_group=dp_group, tp_group=tp_group)
    before = counters()
    out = synth(inp[seqs], seed=7)
    after = counters()
    counts[name] = {k: after.get(k, 0) - before.get(k, 0)
                    for k in GRAPH_COUNTERS}
    return out


def _tp_denoiser(inp, tp_group):
    """The denoiser split over ``tp_group`` and whole, on one input."""
    import copy

    from cmtts_tpu_torch.parallel.distributed import shard_module

    _, model = _model(inp)
    whole = model.denoiser
    split = copy.deepcopy(whole)
    shard_module(split, tp_group)
    g = torch.Generator().manual_seed(0)
    C = whole.channels
    x = torch.randn(2, 12, 16, generator=g)
    t = torch.tensor([0.5, 2.0])
    cond = torch.randn(2, 12, whole.blocks[0].cond_proj.in_features,
                       generator=g)
    with torch.no_grad():
        return {"split": split(x, t, cond), "whole": whole(x, t, cond),
                "shard_rows": split.blocks[0].conv_gate.weight.shape[0],
                "channels": C}


def _cli(root, *extra):
    from cmtts_tpu_torch.cli.train_cm import main

    r = main(["--model", "consistency_training", "--dataset", "Tiny",
              "--config_root", root, "--device", "cpu", *extra])
    return {"state": _state_arrays(r["state"]), "losses": r["losses"],
            "sampler": r["sampler"].state_dict()}


def cases(inp, rank, world):
    from cmtts_tpu_torch.parallel.distributed import make_mesh

    dp_mesh = make_mesh(1)            # dp 2
    tp_mesh = make_mesh(2)            # dp 1 x tp 2
    counts = {}
    out = {
        "dp2": _step(inp, inp["batch4"], dp_mesh.data, rank=rank, dp=world),
        "dp2_padded": _step(inp, inp["batch3_padded"], dp_mesh.data,
                            rank=rank, dp=world, draws="draws3_padded"),
        "dp2_micro2": _step(inp, inp["batch4"], dp_mesh.data, rank=rank,
                            dp=world, microbatch=2),
        "tp2": _step(inp, inp["batch4"], tp_group=tp_mesh.model),
        "tp2_denoiser": _tp_denoiser(inp, tp_mesh.model),
        "dp2_synth": _synth(inp, counts, "dp2_synth",
                            dp_group=dp_mesh.data),
        "tp2_synth": _synth(inp, counts, "tp2_synth",
                            tp_group=tp_mesh.model, seqs="seqs2"),
        "cli_dp2": _cli(inp["roots"]["dp_ranks"], "--total_step", "3"),
        "cli_dp2_padded": _cli(inp["roots"]["padded_ranks"], "--total_step",
                               "2"),
        "cli_tp2": _cli(inp["roots"]["tp_ranks"], "--tp", "2",
                        "--total_step", "2"),
        "synth_counts": counts,
    }
    return out


def run(rank: int, world: int, port: int, root: str):
    """Join a gloo group of ``world`` ranks on the CPU, run the cases on
    ``root/inputs.pt`` and save ``root/out_<rank>.pt`` (or the traceback in
    ``root/err_<rank>.txt``)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
        torch.save(cases(inp, rank, world),
                   os.path.join(root, f"out_{rank}.pt"))
    except BaseException:
        with open(os.path.join(root, f"err_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
