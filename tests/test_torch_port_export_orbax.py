"""``port_tools/export_orbax.py``: a JAX CT run saves step 2 with the JAX
package's Orbax ``save_checkpoint``; the exporter writes the port's step
directory; the port restores it bit-equal to the Orbax payload, and one
port step from it matches JAX's step 3 at ``test_ct_step_matches_jax``'s
tolerances.  Both optimizer shapes: RAdam alone, and
``add_decayed_weights`` chained before it."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train_step import PROBS, Pair, check_metrics
from torch_port_helpers import write_config


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """weight decay -> a Pair whose JAX side took two CT steps and saved
    them with an LSM sampler's state and run_config.json, with its step
    functions, step dir, config root, sampler state and run config (each
    made once)."""
    runs = {}

    def get(weight_decay):
        if weight_decay not in runs:
            runs[weight_decay] = _jax_run(
                tmp_path_factory.mktemp(f"wd{weight_decay}"), weight_decay)
        return runs[weight_decay]
    return get


def _jax_run(tmp_path, weight_decay):
    from cmtts_tpu.train.checkpoint import save_checkpoint, write_run_config
    from cmtts_tpu.train.resample import create_schedule_sampler

    pair = Pair(port_init=True, weight_decay=weight_decay)
    steps = pair.steps()
    jf = steps[0]
    for seed in (1, 2):
        pair.jstate, _ = jf(pair.jstate, pair.jb, jnp.asarray(PROBS),
                            jax.random.PRNGKey(seed), jnp.asarray(0.95))
    sampler = create_schedule_sampler("loss-second-moment", 3)
    rs = np.random.RandomState(0)
    sampler.update(rs.randint(0, 2, 40), rs.rand(40))
    base = str(tmp_path / "jax_ckpt")
    run_config = {"training_mode": "consistency_training",
                  "cwt_masked_std": False,
                  "schedule_sampler": "loss-second-moment",
                  "weight_schedule": "uniform", "seed": 1234,
                  "dataset": "Tiny"}
    write_run_config(base, run_config)
    step_dir = save_checkpoint(base, pair.jstate, sampler.state_dict())
    root = write_config(tmp_path, "Tiny", pair.dicts)
    return pair, steps, step_dir, root, sampler.state_dict(), run_config


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_export_restores_bit_equal_and_steps_as_jax(tmp_path, jax_run,
                                                   weight_decay):
    from cmtts_tpu.train.checkpoint import restore_payload_from_dir
    from cmtts_tpu_torch.convert import flax_to_state_dict
    from cmtts_tpu_torch.train.checkpoint import (
        load_step_dir,
        read_run_config,
        sampler_state_from_payload,
        state_from_payload,
    )
    from port_tools.export_orbax import main

    pair, steps, step_dir, root, sampler, run_config = jax_run(weight_decay)
    out = str(tmp_path / "port_ckpt")
    path = main(["--step_dir", step_dir, "--out", out,
                 "--config_root", root])
    assert os.path.basename(path) == "step_00000002"
    assert read_run_config(out) == run_config

    # bit-equal to the Orbax payload, every role
    payload = restore_payload_from_dir(step_dir)
    exported = load_step_dir(path)
    assert int(exported["step"]) == 2

    def equal(tree, got, what):
        ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, tree),
                                 pair.model)
        assert set(ref) == set(got), what
        for k in ref:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(),
                                          err_msg=f"{what} {k}")

    for role in ("model", "target_model", "ema_0", "ema_1", "ema_2"):
        equal(payload[role], exported[role], role)
    adam = [s for s in jax.tree_util.tree_leaves(
        pair.jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")][0]
    assert exported["opt"]["count"] == int(adam.count) == 2
    equal(adam.mu, exported["opt"]["mu"], "mu")
    equal(adam.nu, exported["opt"]["nu"], "nu")
    got = sampler_state_from_payload(exported)
    for k, v in sampler.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)

    # the port's step 3 from the export against JAX's step 3
    pair.tstate = state_from_payload(exported, 3)
    jm, tm = pair.run(*steps, seed=3)
    check_metrics(jm, tm)
    pair.check_state()


def test_exporter_refuses_the_hifigan_train_state(tmp_path):
    from port_tools.export_orbax import main

    (tmp_path / "hifigan_train_state.npy").write_bytes(b"")
    with pytest.raises(SystemExit, match="init_gen_npz"):
        main(["--step_dir", str(tmp_path), "--out", str(tmp_path / "o")])


def test_exporter_refuses_another_runs_flags(tmp_path, jax_run):
    """An export into a port run recorded with other graph flags is
    refused, as a resume of that run would be."""
    from cmtts_tpu_torch.train.checkpoint import write_run_config
    from port_tools.export_orbax import main

    _, _, step_dir, root, _, run_config = jax_run(0.0)
    out = str(tmp_path / "port_ckpt")
    write_run_config(out, dict(run_config, training_mode="edm"))
    with pytest.raises(ValueError, match="training_mode"):
        main(["--step_dir", step_dir, "--out", out, "--config_root", root])
    with open(os.path.join(out, "CMDenoiserTTS", "run_config.json")) as f:
        assert json.load(f)["training_mode"] == "edm"
