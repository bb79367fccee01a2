"""The port's data and tensor parallelism on two gloo ranks on the CPU,
spawned once for the module (``tests/torch_port_dist_cases.py``), held
against one process: a dp=2 CT step against JAX's single-device step on
the same global batch and injected draws, with the ranks' rows of
different lengths (a per-rank average of masked means would fail it); a
B=3 batch padded to 4 against the unpadded step; microbatches under dp;
the gathered LSM history; the tp=2 denoiser and a dp=1 x tp=2 step; dp=2
and tp=2 synthesis; the training CLI at dp=2 (with and without padding)
and tp=2, whose checkpoint resumes at tp=1.  Beside them, without ranks:
``--steps_per_call 2`` against single steps, ``--profile_dir``, the
TensorBoard figures and the messages when their packages are absent."""

import json
import multiprocessing
import os
import socket
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train_step import (
    METRIC_TOL,
    MOMENT_TOL,
    PARAM_TOL,
    PROBS,
    jax_step_draws,
)
from torch_port_helpers import (
    config_dicts,
    configs_from,
    flax_cm_params,
    jax_tree,
    torch_cm,
    train_batch,
    write_config,
    zero_dropout,
)

WORLD = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def step_dicts():
    """The tiny configuration of the step parity tests (dropout off)."""
    dicts = zero_dropout(config_dicts())
    dicts[1].update(transformer=dict(dicts[1]["transformer"],
                                     encoder_layer=1),
                    denoiser=dict(residual_channels=32, residual_layers=2))
    dicts[2]["cm"] = dict(lr=1e-3)
    return dicts


def cli_root(tmp, name, batch_size, log_step=1):
    """A config root with its own 20 + 2 utterance corpus, checkpoints and
    logs under ``tmp/name``: dropout off, the LSM sampler, a save every 2
    steps, a log (and with tensorboard on, the figures) every
    ``log_step``."""
    from cmtts_tpu_torch.data.feature_corpus import write_feature_corpus

    sub = tmp / name
    sub.mkdir()
    pre, model, _, stats = zero_dropout(config_dicts())
    train = {"path": {k: str(sub / k) for k in
                      ("ckpt_path", "log_path", "result_path")},
             "optimizer": {"batch_size": batch_size},
             "step": {"save_step": 2, "log_step": log_step,
                      "synth_step": 1},
             "cm": {"schedule_sampler": "loss-second-moment"}}
    root = write_config(sub, "Tiny", (pre, model, train, stats))
    write_feature_corpus(str(sub / "pre"), 20, 2, seed=0, n_mels=16,
                         phonemes=(5, 12), frames=(1, 4))
    return root


def train(root, *extra):
    from cmtts_tpu_torch.cli.train_cm import main

    return main(["--model", "consistency_training", "--dataset", "Tiny",
                 "--config_root", root, "--device", "cpu", *extra])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the ranks on the inputs, compute the single-process results
    while they run, and return (inputs, single results, rank outputs)."""
    from cmtts_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
    from cmtts_tpu_torch.parallel.distributed import pad_batch_to_multiple

    tmp = tmp_path_factory.mktemp("ranks")
    dicts = step_dicts()
    jcfg, tcfg = configs_from(dicts)
    params = flax_cm_params(jcfg)
    model = torch_cm(tcfg, params)
    torch.manual_seed(3)
    voc = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=32,
                                         num_mels=16)).eval()
    # rank 0 holds the two long rows, rank 1 the two short ones
    batch4 = train_batch(0, (8, 7, 3, 2), 8, 32)
    batch3 = train_batch(1, (8, 5, 3), 8, 32)
    draws3 = jax_step_draws(4, PROBS, batch3["mels"].shape)
    rs = np.random.RandomState(5)
    roots = {name: cli_root(tmp, name, bs) for name, bs in (
        ("dp_single", 4), ("dp_ranks", 4), ("padded_ranks", 3),
        ("tp_single", 2), ("tp_ranks", 2))}
    inp = {
        "dicts": dicts, "params": model.state_dict(), "probs": PROBS,
        "batch4": batch4,
        "draws4": jax_step_draws(3, PROBS, batch4["mels"].shape),
        "batch3_padded": pad_batch_to_multiple(dict(batch3), WORLD)[0],
        # the padded row's draws repeat the last row's
        "draws3_padded": tuple(torch.cat([d, d[-1:]]) for d in draws3),
        "vocoder": voc.state_dict(),
        "seqs": [rs.randint(13, 140, n) for n in (7, 5, 3)],
        "seqs2": [rs.randint(13, 140, n) for n in (6, 4)],
        "roots": roots,
    }
    torch.save(inp, tmp / "inputs.pt")

    import torch_port_dist_cases

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=torch_port_dist_cases.run,
                         args=(r, WORLD, port, str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        single = single_results(inp, jcfg, tcfg, params, model, voc, batch3,
                                draws3)
    finally:
        # as soon as a rank fails (or the time is up) stop the other, which
        # would wait for it in a collective
        end = time.monotonic() + 300
        while any(p.is_alive() for p in procs):
            if time.monotonic() > end or any(
                    p.exitcode not in (None, 0) for p in procs):
                for p in procs:
                    if p.is_alive():
                        p.terminate()
                break
            time.sleep(0.2)
        for p in procs:
            p.join()
    errs = [f.read_text() for f in sorted(tmp.glob("err_*.txt"))]
    assert not errs and all(p.exitcode == 0 for p in procs), \
        "\n".join(errs) or [p.exitcode for p in procs]
    outs = [torch.load(tmp / f"out_{r}.pt", weights_only=False)
            for r in range(WORLD)]
    return inp, single, outs


def single_results(inp, jcfg, tcfg, params, model, voc, batch3, draws3):
    """JAX's one-device step on the global batch, the port's one-process
    steps, synthesis calls and CLI runs."""
    from cmtts_tpu.models.cmtts import CMTTS as JCMTTS
    from cmtts_tpu.train.loop import make_train_step as jmake
    from cmtts_tpu.train.state import create_train_state as jcreate
    from cmtts_tpu.train.state import make_optimizer as jopt
    from cmtts_tpu_torch.pipeline import Synthesizer
    from cmtts_tpu_torch.train.loop import batch_to_device, make_train_step
    from cmtts_tpu_torch.train.state import RAdam, create_train_state

    out = {}
    tx = jopt(1e-3)
    jstate = jcreate(jax.tree_util.tree_map(jnp.asarray, params), tx, 3)
    out["jax"] = jmake(JCMTTS(jcfg), jcfg, tx, 3, donate=False)(
        jstate, jax_tree(inp["batch4"]), jnp.asarray(PROBS),
        jax.random.PRNGKey(3), jnp.asarray(0.95))

    def port_step(batch, draws, microbatch=0):
        opt = RAdam(1e-3)
        state = create_train_state(dict(model.named_parameters()), opt, 3)
        step = make_train_step(model, tcfg, opt, 3, microbatch=microbatch)
        return step(state, batch_to_device(batch, "cpu"), PROBS, 0.95,
                    indices=draws[0], noise=draws[1])

    out["step4"] = port_step(inp["batch4"], inp["draws4"])
    out["step4_micro2"] = port_step(inp["batch4"], inp["draws4"], 2)
    out["step3"] = port_step(batch3, draws3)
    synth = Synthesizer(tcfg, model, voc, text_buckets=(8,),
                        mel_buckets=(32,), compute_dtype=torch.float32,
                        device="cpu")
    out["synth"] = synth(inp["seqs"], seed=7)
    out["synth2"] = synth(inp["seqs2"], seed=7)
    out["cli_dp"] = train(inp["roots"]["dp_single"], "--total_step", "3")
    out["cli_tp"] = train(inp["roots"]["tp_single"], "--total_step", "2")
    return out


def trees_of(state):
    return {"params": state.params, "target": state.target_params,
            "mu": state.opt_state["mu"], "nu": state.opt_state["nu"],
            **{f"ema_{i}": e for i, e in enumerate(state.ema_params)}}


def assert_trees_close(got: dict, ref: dict, what: str):
    for name, tree in ref.items():
        tol = MOMENT_TOL if name in ("mu", "nu") else PARAM_TOL
        assert set(got[name]) == set(tree), name
        for k, v in tree.items():
            np.testing.assert_allclose(got[name][k].numpy(), v.numpy(),
                                       err_msg=f"{what} {name} {k}", **tol)


def test_dp2_step_matches_jax_single_device(runs):
    """Two ranks holding rows of different lengths take the one-device
    step over the global batch: loss, every metric, params, target, EMAs
    and moments against JAX's step, on both ranks."""
    from cmtts_tpu_torch.convert import flax_to_state_dict

    inp, single, outs = runs
    js, jm = single["jax"]
    model = torch_cm(configs_from(inp["dicts"])[1],
                     flax_cm_params(configs_from(inp["dicts"])[0]))
    adam = [s for s in jax.tree_util.tree_leaves(
        js.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")][0]
    ref = {name: flax_to_state_dict(jax.tree_util.tree_map(np.asarray, t),
                                    model)
           for name, t in (("params", js.params),
                           ("target", js.target_params),
                           ("mu", adam.mu), ("nu", adam.nu),
                           *((f"ema_{i}", e)
                             for i, e in enumerate(js.ema_params)))}
    for rank, out in enumerate(outs):
        trees, scalars, idx, lps = out["dp2"]
        assert_trees_close(trees, ref, f"rank {rank}")
        assert set(scalars) | {"indices", "loss_per_sample"} == set(jm)
        for k, v in scalars.items():
            np.testing.assert_allclose(v, float(jm[k]), err_msg=k,
                                       **METRIC_TOL)
        np.testing.assert_array_equal(idx, np.asarray(jm["indices"]))
        np.testing.assert_allclose(lps, np.asarray(jm["loss_per_sample"]),
                                   **METRIC_TOL)


def test_gathered_lsm_history_equals_single_run(runs):
    """The LSM sampler fed the rows gathered from the ranks holds the
    history of one run over the global batch."""
    from cmtts_tpu_torch.train.resample import LossSecondMomentSampler

    _, single, outs = runs
    jm = single["jax"][1]
    one = LossSecondMomentSampler(3, history_per_term=4)
    one.update(np.asarray(jm["indices"]), np.asarray(jm["loss_per_sample"]))
    for out in outs:
        _, _, idx, lps = out["dp2"]
        many = LossSecondMomentSampler(3, history_per_term=4)
        many.update(idx, lps)
        np.testing.assert_array_equal(many._counts, one._counts)
        np.testing.assert_allclose(many._history, one._history, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("case,ref", [("dp2_padded", "step3"),
                                      ("dp2_micro2", "step4_micro2"),
                                      ("tp2", "step4")])
def test_ranks_match_one_process_step(runs, case, ref):
    """A B=3 batch padded to 4 over dp=2 (the duplicate row contributes
    nothing) against the unpadded step; two interleaved microbatches under
    dp=2 against the one-process microbatch step; dp=1 x tp=2 (the
    denoiser's blocks split, the state gathered from its shards) against
    the one-process step.  The per-noise-level sums and counts count the
    padded row, as the JAX step's do, so they are compared unpadded only."""
    _, single, outs = runs
    s_ref, m_ref = single[ref]
    for rank, out in enumerate(outs):
        trees, scalars, _, lps = out[case]
        assert_trees_close(trees, trees_of(s_ref), f"{case} rank {rank}")
        for k, v in scalars.items():
            if case == "dp2_padded" and k.startswith("cm_i"):
                continue
            np.testing.assert_allclose(v, float(m_ref[k]), err_msg=k,
                                       **METRIC_TOL)
        n = m_ref["loss_per_sample"].shape[0]
        np.testing.assert_allclose(lps[:n], m_ref["loss_per_sample"].numpy(),
                                   **METRIC_TOL)


def test_tp2_denoiser_forward_matches_whole(runs):
    for out in runs[2]:
        r = out["tp2_denoiser"]
        assert r["shard_rows"] == r["channels"] // WORLD
        np.testing.assert_allclose(r["split"].numpy(), r["whole"].numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case,ref", [("dp2_synth", "synth"),
                                      ("tp2_synth", "synth2")])
def test_parallel_synthesis_matches_one_process(runs, case, ref):
    """dp=2 synthesis of 3 rows (padded to 4, the rows gathered on every
    rank) and tp=2 synthesis of 2 rows, through the vocoder's MRF stages,
    against the one-process call on the same seed."""
    _, single, outs = runs
    mel1, lens1, wav1 = single[ref]
    for out in outs:
        mel, lens, wav = out[case]
        np.testing.assert_array_equal(lens, lens1)
        np.testing.assert_allclose(mel, mel1, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(wav, wav1, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["dp2_synth", "tp2_synth"])
def test_parallel_synthesis_stays_eager(runs, case):
    """A call with a data or tensor group replays no CUDA graph, whatever
    its device: one call counted, no replay, no capture on each rank."""
    for out in runs[2]:
        assert out["synth_counts"][case] == {
            "synth.calls": 1, "synth.graph_replays": 0,
            "synth.graph_captures": 0}


def test_cli_dp2_matches_one_process_run(runs):
    """Three CLI steps on two ranks (batch 4, LSM sampler, a log each
    step): the losses, the LSM history and the final state of the
    one-process run."""
    _, single, outs = runs
    ref = single["cli_dp"]
    for out in outs:
        got = out["cli_dp2"]
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   **METRIC_TOL)
        for k, v in ref["sampler"].state_dict().items():
            np.testing.assert_allclose(got["sampler"][k], v, rtol=1e-5,
                                       atol=1e-6)
        assert_trees_close(got["state"], trees_of(ref["state"]), "cli dp2")


def test_cli_dp2_drops_padded_rows_from_lsm(runs):
    """Batches of 3 padded to 4 over two ranks: the LSM history takes the
    3 real rows of each of the 2 steps."""
    inp, _, outs = runs
    from cmtts_tpu_torch.train.checkpoint import list_checkpoint_steps

    for out in outs:
        got = out["cli_dp2_padded"]
        assert got["sampler"]["counts"].sum() == 2 * 3
        assert np.isfinite(got["losses"]).all()
    ckpt = os.path.join(os.path.dirname(inp["roots"]["padded_ranks"]),
                        "ckpt_path")
    assert list_checkpoint_steps(ckpt) == [2]


def test_cli_tp2_matches_one_process_and_resumes_at_tp1(runs):
    """Two CLI steps at tp=2: the one-process run's state; the checkpoint
    rank 0 wrote from the gathered shards resumes in one process, restored
    equal to the tp=2 run's state."""
    inp, single, outs = runs
    ref = single["cli_tp"]
    for out in outs:
        assert_trees_close(out["cli_tp2"]["state"], trees_of(ref["state"]),
                           "cli tp2")
    r = train(inp["roots"]["tp_ranks"], "--total_step", "3",
              "--restore_step", "-1")
    assert r["start_step"] == 2 and r["state"].step == 3
    restored = trees_of(r["restored"])
    for name, tree in outs[0]["cli_tp2"]["state"].items():
        for k, v in tree.items():
            assert torch.equal(restored[name][k], v), (name, k)


def test_steps_per_call_and_profile(tmp_path):
    """``--steps_per_call 2`` takes the steps of K=1 on the same feed and
    draws (a log every 2 steps, whose one-step synthesis draws from the
    generator, comes between the same steps in both; the LSM history is
    still warming up, so its probabilities stay uniform either way) and
    saves at the same steps; ``--profile_dir`` traces steps 5-6 with the
    port's spans and writes the trace at the end."""
    from cmtts_tpu_torch.train.checkpoint import list_checkpoint_steps

    roots = [cli_root(tmp_path, n, 2, log_step=2) for n in ("k1", "k2")]
    r1 = train(roots[0], "--total_step", "6")
    prof = tmp_path / "prof"
    r2 = train(roots[1], "--total_step", "6", "--steps_per_call", "2",
               "--profile_dir", str(prof))
    np.testing.assert_allclose(r2["losses"], r1["losses"], rtol=1e-6)
    for k, v in r1["sampler"].state_dict().items():
        np.testing.assert_array_equal(r2["sampler"].state_dict()[k], v)
    for name, tree in trees_of(r1["state"]).items():
        for k, v in tree.items():
            np.testing.assert_allclose(trees_of(r2["state"])[name][k], v,
                                       rtol=1e-6, atol=1e-8)
    for root in roots:
        ckpt = os.path.join(os.path.dirname(root), "ckpt_path")
        assert list_checkpoint_steps(ckpt) == [2, 4, 6]
    with open(prof / "trace_rank0.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"cmtts.ct.draw", "cmtts.ct.forward", "cmtts.ct.backward",
            "cmtts.ct.update"} <= names


def test_tensorboard_figures_and_missing_packages(tmp_path, monkeypatch):
    """With tensorboard in CMTTS_LOG_FORMAT the CLI writes the event file
    with the figures and the Griffin-Lim audio; without tensorboard or
    matplotlib importable, asking for them fails with a message."""
    root = cli_root(tmp_path, "tb", 2)
    monkeypatch.setenv("CMTTS_LOG_FORMAT", "csv,tensorboard")
    train(root, "--total_step", "1")
    events = list((tmp_path / "tb" / "log_path_cm" / "train").glob(
        "events.out.tfevents.*"))
    assert events and events[0].stat().st_size > 10_000
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="need matplotlib"):
        train(root, "--total_step", "1")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(RuntimeError, match="asks for tensorboard"):
        train(root, "--total_step", "1")
