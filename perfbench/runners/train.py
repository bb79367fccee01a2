"""CT training as the inner loop of ``cli.train_cm`` runs it: the port's
``make_train_step`` (bf16 at the apply boundary, float32 master params,
RAdam, three EMAs and the target network), K steps a call on one set of
schedule-sampler probabilities, each step's loss read on the host, fed by
``FeatureDataset`` -> ``batch_iterator`` (length-sorted mega-batches,
bucket-padded) -> ``prefetch_iterator`` over a corpus the benchmark writes
in the preprocessed layout (:mod:`perfbench.corpus`).

Set-up writes the corpus, builds the train state from the seed's weights
and runs the first call; its first ``CHECK_STEPS`` steps are compared
from the seed (the losses and batches, the first gradient from the
optimizer's state after step 1, the change of the params, the EMAs and
the target network after the last).  Then it warms up every batch shape
that later batches reach, on throwaway steps from a copy of the
generator's state.  The window runs calls until ``--seconds`` have
passed.  Before one of its first ``WIN_CALLS`` calls, drawn from the
seed, it copies the state and the generator's state on the card, and
after ``WIN_STEPS`` steps of that call the state again, with their losses
and batches.  The check, once the program is freed, runs the plain
reference (:mod:`perfbench.reference.train`) in float32: from the seed's
weights over the first steps, and from the copied state over the
window's steps.
"""

from __future__ import annotations

import copy
import gc
import json
import os
import shutil
import sys
import tempfile
import time

from perfbench import compare, corpus, flops
from perfbench.harness import Run
from perfbench.reference.config import read_config
from perfbench.reference.train import (Feed, changes, from_seed,
                                       from_state, gaps, leaf_norms)
from perfbench.trace import Tracer
from perfbench.traffic import run_rng
from perfbench.weights import seeded_state_dict

SALT_ACOUSTIC = 11
CHECK_STEPS = 3
WIN_CALLS = 3
WIN_STEPS = 2


def corpus_dir(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), f"perfbench_corpus_{name}")


def run_seeds(seed: int) -> dict:
    """The step generator's seed, the feed's shuffle seed and the window
    call that the check copies (from 0)."""
    rng = run_rng(seed, 6)
    return {"generator": int(rng.integers(0, 2 ** 62)),
            "feed": int(rng.integers(0, 2 ** 32)),
            "window_call": int(rng.integers(0, WIN_CALLS))}


def acoustic_weights(config: dict, seed: int, device: str) -> dict:
    from perfbench.reference.synth import modules

    c = read_config(config)
    model = modules(c, config["vocoder"], "meta")[0]
    ov = {k: tuple(v) for k, v in config.get("weight_overrides", {}).items()}
    return seeded_state_dict(model, seed, SALT_ACOUSTIC, device, ov)


def with_corpus(config: dict, root: str) -> dict:
    config = copy.deepcopy(config)
    config["preprocess"].setdefault("path", {})["preprocessed_path"] = root
    return config


def host_arrays(batch: dict, prefix: str = "") -> dict:
    """The numeric arrays of a collated host batch, flat by key."""
    import numpy as np

    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out.update(host_arrays(v, f"{prefix}{k}."))
        elif isinstance(v, np.ndarray):
            out[prefix + k] = v
    return out


def layout(state) -> dict:
    """The program's train state as the reference lays a state out (the
    same tensors)."""
    return {"count": state.opt_state["count"], "params": state.params,
            "mu": state.opt_state["mu"], "nu": state.opt_state["nu"],
            "ema": list(state.ema_params), "target": state.target_params}


def snapshot(torch, state) -> dict:
    """A copy on the card of the program's state, in the reference's
    layout (a few fused launches a tree)."""
    def copy_tree(tree):
        names = list(tree)
        return dict(zip(names, torch._foreach_mul([tree[k] for k in names],
                                                  1.0)))

    s = layout(state)
    return {"count": s["count"], "params": copy_tree(s["params"]),
            "mu": copy_tree(s["mu"]), "nu": copy_tree(s["nu"]),
            "ema": [copy_tree(e) for e in s["ema"]],
            "target": copy_tree(s["target"])}


class Program:
    """The program's training loop as ``cli.train_cm`` builds it: the
    state, the step, the sampler, the generator and the feed."""

    def __init__(self, config: dict, seed: int, device: str, setup: dict):
        t = time.perf_counter()
        import torch

        from cmtts_tpu_torch.core.config import config_from_dicts
        from cmtts_tpu_torch.core.device import cli_device
        from cmtts_tpu_torch.data.dataset import (FeatureDataset,
                                                  batch_iterator,
                                                  prefetch_iterator)
        from cmtts_tpu_torch.models.cmtts import CMTTS
        from cmtts_tpu_torch.train.ema import create_ema_and_scales_fn
        from cmtts_tpu_torch.train.loop import (batch_to_device,
                                                make_train_step)
        from cmtts_tpu_torch.train.resample import create_schedule_sampler
        from cmtts_tpu_torch.train.state import (create_train_state,
                                                 make_optimizer)

        setup["imports"] = time.perf_counter() - t
        t = time.perf_counter()
        self.torch, self.dev = torch, cli_device(device)
        if self.dev.type == "cuda":
            torch.zeros(1, device=self.dev)
            torch.cuda.synchronize()
        setup["cuda_init"] = time.perf_counter() - t
        t = time.perf_counter()
        cfg = config_from_dicts(config["preprocess"], config["model"],
                                config["train"], config.get("stats", {}))
        self.cfg, cm = cfg, cfg.train.cm
        with torch.device(self.dev):
            model = CMTTS(cfg)
        model.to(self.dev)      # buffers made from numpy start on the host
        model.load_state_dict(acoustic_weights(config, seed, self.dev.type),
                              strict=True)
        opt = make_optimizer(cm.lr, cm.weight_decay)
        self.ema_scale = create_ema_and_scales_fn(
            cm.target_ema_mode, cm.start_ema, cm.scale_mode, cm.start_scales,
            cm.end_scales, cm.total_training_steps, cm.distill_steps_per_iter)
        num_scales = self.ema_scale(0)[1]
        self.step_fn = make_train_step(model, cfg, opt, num_scales,
                                       compute_dtype=torch.bfloat16)
        self.sampler = create_schedule_sampler(cm.schedule_sampler,
                                               num_scales)
        self.state = create_train_state(
            {k: v.detach() for k, v in model.named_parameters()}, opt,
            len(cm.ema_rate))
        seeds = run_seeds(seed)
        self.generator = torch.Generator(device=self.dev).manual_seed(
            seeds["generator"])
        self.dataset = FeatureDataset("train.txt", cfg, sort=True,
                                      drop_last=True)
        # the RAM cache a long run holds after its first epoch
        self.dataset.get_many(list(range(len(self.dataset))))
        self.feed = prefetch_iterator(lambda: batch_iterator(
            self.dataset, cfg.train.batch_size, cfg.train.group_size,
            seed=seeds["feed"]))
        self.to_device = batch_to_device
        self.step = 0
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        setup["weights"] = time.perf_counter() - t

    def call(self, K: int, span, on_step=None):
        """K steps on one set of probabilities; returns (seconds waited on
        the feed, [(t_txt, t_mel, rows)] of the steps)."""
        wait, hosts = 0.0, []
        for _ in range(K):
            t = time.perf_counter()
            with span("feed_wait"):
                hosts.append(next(self.feed))
            wait += time.perf_counter() - t
        probs = self.sampler.probs()
        shapes = []
        for host in hosts:
            with span("step"):
                self.step += 1
                batch = self.to_device(host, self.dev)
                self.state, metrics = self.step_fn(
                    self.state, batch, probs,
                    self.ema_scale(self.step)[0], self.generator)
                loss = float(metrics["loss"])
            shapes.append((host["texts"].shape[1], host["mels"].shape[1],
                           len(host["ids"])))
            if on_step is not None:
                on_step(self.step, host, loss, self.state)
        return wait, shapes

    def throwaway_step(self, rows):
        """A step on the corpus rows ``rows`` whose new state and draws are
        thrown away: it warms the step up at their batch shape."""
        from cmtts_tpu_torch.data.dataset import collate_batch

        gstate = self.generator.get_state()
        host = collate_batch(self.dataset.get_many(rows), self.cfg)
        self.step_fn(self.state, self.to_device(host, self.dev),
                     self.sampler.probs(), self.ema_scale(1)[0],
                     self.generator)
        self.generator.set_state(gstate)

    def free(self):
        """Close the feed and drop the state (the check runs after)."""
        self.feed.close()
        self.state = self.step_fn = None
        gc.collect()
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()


def shape_of(meta, rows, cfg: dict) -> tuple:
    from perfbench.reference.synth import pick_bucket

    b = cfg["buckets"]
    return (pick_bucket(max(len(meta[i]["phonemes"]) for i in rows),
                        b["text"]),
            pick_bucket(max(meta[i]["frames"] for i in rows), b["mel"]))


def start(name: str, config: dict, mix: dict, seed: int, device: str,
          setup: dict):
    """Write the corpus, build the program, run the first call(s) through
    step ``CHECK_STEPS``: (program, what the check keeps)."""
    root = corpus_dir(name)
    t = time.perf_counter()
    meta = corpus.write(root, mix, seed)
    setup["corpus"] = time.perf_counter() - t
    config = with_corpus(config, root)
    prog = Program(config, seed, device, setup)
    seen = {"losses": [], "rows": [], "batches": []}
    kept = {"corpus": root, "config": config, "meta": meta,
            "from_seed": seen}
    state0 = layout(prog.state)

    def keep(step, host, loss, state):
        if step <= CHECK_STEPS:
            seen["losses"].append(loss)
            seen["rows"].append(list(host["ids"]))
            seen["batches"].append(host_arrays(host))
        if step == 1:
            # the first gradient as the optimizer got it: mu = (1 - b1) g
            seen["grad"] = {k: v / 0.1 for k, v in leaf_norms(
                state.opt_state["mu"]).items()}
        if step == CHECK_STEPS:
            seen["change"] = changes(state0, layout(state))

    t = time.perf_counter()
    nop = Tracer(False).span
    while prog.step < CHECK_STEPS:
        prog.call(mix["steps_per_call"], nop, keep)
    if prog.dev.type == "cuda":
        prog.torch.cuda.synchronize()
    setup["first call"] = time.perf_counter() - t
    return prog, kept


def train_window(ctx, prog, kept):
    """Warm-up of the later batch shapes, then the window: (records,
    window, set-up seconds, trace or None).  The window runs on past
    ``--seconds`` until the window check's call is done."""
    torch, mix, meta = prog.torch, ctx.traffic, kept["meta"]
    sync = (torch.cuda.synchronize if prog.dev.type == "cuda"
            else (lambda: None))
    seen = set()
    seeds = run_seeds(ctx.seed)
    order = corpus.batch_order(meta, prog.cfg.train.batch_size,
                               prog.cfg.train.group_size, seeds["feed"],
                               mix["warm_batches"])
    for i, rows in enumerate(order):
        shape = shape_of(meta, rows, ctx.config)
        if i < prog.step or shape in seen:
            seen.add(shape)
            continue
        seen.add(shape)
        t = time.perf_counter()
        prog.throwaway_step(rows)
        sync()
        ctx.setup[f"warmup {shape[0]}x{shape[1]}"] = time.perf_counter() - t
    if prog.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    win = {"losses": [], "rows": [], "batches": []}
    kept["window"] = win

    def keep(step, host, loss, state):
        if step <= win["first"] + WIN_STEPS:
            win["losses"].append(loss)
            win["rows"].append(list(host["ids"]))
            win["batches"].append(host_arrays(host))
        if step == win["first"] + WIN_STEPS:
            win["after"] = snapshot(torch, state)

    records = []
    tracer = Tracer(ctx.trace)
    gc.collect()
    gc.freeze()             # set-up's objects out of the collector's scans
    with tracer:
        sync()
        t0 = time.perf_counter()
        setup_s = t0 - ctx.t_start
        while True:
            on_step = None
            if len(records) == seeds["window_call"]:
                win["first"] = prog.step
                win["state"] = snapshot(torch, prog.state)
                win["gen"] = prog.generator.get_state()
                on_step = keep
            ts = time.perf_counter()
            wait, shapes = prog.call(mix["steps_per_call"], tracer.span,
                                     on_step)
            t1 = time.perf_counter()
            records.append({"t0": ts, "t1": t1, "feed_wait_s": wait,
                            "steps": len(shapes),
                            "samples": sum(s[2] for s in shapes),
                            "shapes": shapes})
            if t1 - t0 >= ctx.seconds and "after" in win:
                break
        sync()
    gc.unfreeze()
    window = (t0, records[-1]["t1"])
    trace = tracer.result(window[1] - window[0]) if ctx.trace else None
    if trace is not None:
        trace.steps = sum(r["steps"] for r in records)
    return records, window, setup_s, trace


def run(ctx) -> Run:
    prog, kept = start(ctx.name, ctx.config, ctx.traffic, ctx.seed,
                       ctx.device, ctx.setup)
    records, window, setup_s, trace = train_window(ctx, prog, kept)
    c = read_config(ctx.config)
    extra = {"program": prog, "kept": kept,
             "flop": sum(step_flop(c, B, tt, tm) for r in records
                         for tt, tm, B in r["shapes"]),
             "notes": [f"steps {sum(r['steps'] for r in records)}, shapes "
                       f"{sorted(set(s[:2] for r in records for s in r['shapes']))}"
                       f", window check from step {kept['window']['first']}"]}
    return Run(records, window, setup_s, 1, trace, extra=extra)


def step_flop(c, B: int, t_txt: int, t_mel: int) -> float:
    """One CT step over B rows: the conditioning and the denoiser each run
    forward for the student (and backward, twice a forward) and forward
    for the target: 4 forwards' worth each."""
    return 4.0 * (flops.condition_flop(c, B, t_txt, t_mel)
                  + flops.denoiser_flop(c, B, t_mel))


def program_side(prog, kept) -> list:
    """The program's two compared stretches; frees the program and the
    window's later copy."""
    win = kept["window"]
    win["change"] = changes(win["state"], win.pop("after"))
    prog.free()
    return [kept["from_seed"], win]


def reference(config: dict, kept: dict, seed: int, device: str,
              fmt: str = "f32") -> list:
    """The reference's two stretches: from the seed's weights, and from
    the window's copied state."""
    c = read_config(config)
    win, seeds = kept["window"], run_seeds(seed)
    feed = Feed(kept["corpus"], kept["meta"], kept["config"], seeds["feed"],
                win["first"] + WIN_STEPS)
    weights = acoustic_weights(config, seed, device)
    return [from_seed(kept["config"], c, feed, weights, seeds["generator"],
                      CHECK_STEPS, device, fmt),
            from_state(kept["config"], c, feed, weights, win["state"],
                       win["gen"], win["first"], WIN_STEPS, device, fmt)]


def check(ctx, run: Run):
    kept = run.extra["kept"]
    prog = program_side(run.extra.pop("program"), kept)
    ref = reference(ctx.config, kept, ctx.seed, ctx.device)
    shutil.rmtree(kept["corpus"], ignore_errors=True)
    leaves = {}
    g = gaps(prog, ref, leaves)
    print("perfbench: worst leaves " + json.dumps(leaves), file=sys.stderr)
    # the numbers without a limit are read (calibrate.py), not compared
    return compare.judge([{k: v for k, v in g.items()
                           if k in ctx.cell["limits"]}], ctx.cell["limits"])


# -- calibration (perfbench/calibrate.py) -----------------------------------

SIDES = ("control", "half_batch", "token", "frozen_ema")


def readings(cell, config, traffic, seed: int, device: str, control: bool,
             witness: bool = False):
    """[(side, numbers)]: the program's compared stretches against the
    reference (a run with a window that ends with the check's call); with
    ``control`` the control's and each planted fault's, the reference put
    in the program's place on the same inputs.  (``witness``: training
    has none; the reference is float32 only.)"""
    from types import SimpleNamespace

    ctx = SimpleNamespace(name=cell["name"], seed=seed, seconds=0.0,
                          trace=False, config=config, traffic=traffic,
                          setup={}, t_start=time.perf_counter())
    prog, kept = start("calibrate", config, traffic, seed, device, {})
    train_window(ctx, prog, kept)
    dev = str(prog.dev)
    ours = program_side(prog, kept)
    ref = reference(config, kept, seed, dev)
    leaves = {}
    out = [("program", dict(gaps(ours, ref, leaves), leaves=leaves))]
    for fmt in SIDES if control else ():
        leaves = {}
        out.append((fmt, dict(gaps(reference(config, kept, seed, dev, fmt),
                                   ref, leaves), leaves=leaves)))
    shutil.rmtree(kept["corpus"], ignore_errors=True)
    return out
