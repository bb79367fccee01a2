"""The plain references held to the JAX package, an implementation
independent of the program: the CT step (loss, params, EMAs, target and
moments) against ``cmtts_tpu.train.loop.make_train_step`` at a tiny size on
the CPU (dropout off, JAX's draws given to both), RAdam against
``optax.radam`` across its rectification, the reference's feed against
``cmtts_tpu.data.dataset``'s, and the DeepSpeaker embedder against
``cmtts_tpu.models.speaker``'s.  The benchmark does not run these; they
make a fault that the program and the reference shared show."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

from perfbench import corpus
from perfbench.reference.acoustic import AcousticModel
from perfbench.reference.config import read_config
from perfbench.reference.train import (Feed, ct_step, fresh_state, radam,
                                       to_device)
from perfbench.tests import tinybench

sys.path.insert(0, os.path.join(tinybench.ROOT, "tests"))
PROBS = np.asarray([1 / 3, 2 / 3], np.float32)
TOL = dict(rtol=1e-5, atol=1e-6)
MOMENT_TOL = dict(rtol=1e-3, atol=1e-5)


def _ljspeech() -> dict:
    with open(os.path.join(tinybench.BENCH, "configs",
                           "ljspeech.json")) as f:
        return json.load(f)


def _flat(batch: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_ct_step_matches_the_jax_package():
    import jax
    import jax.numpy as jnp
    from cmtts_tpu.models.cmtts import CMTTS as JCMTTS
    from cmtts_tpu.train.loop import make_train_step as jmake
    from cmtts_tpu.train.state import create_train_state as jcreate
    from cmtts_tpu.train.state import make_optimizer as jopt
    from cmtts_tpu_torch.convert import flax_to_state_dict
    from torch_port_helpers import (config_dicts, configs_from,
                                    flax_cm_params, jax_tree, torch_cm,
                                    train_batch, zero_dropout)

    pre, model_d, _, stats = zero_dropout(config_dicts())
    train = dict(_ljspeech()["train"])
    train["cm"] = dict(train["cm"], lr=1e-3)
    jcfg, tcfg = configs_from((pre, model_d, train, stats))
    params = flax_cm_params(jcfg)
    tx = jopt(1e-3, 0.0)
    jstate = jcreate(jax.tree_util.tree_map(jnp.asarray, params), tx, 3)
    jf = jmake(JCMTTS(jcfg), jcfg, tx, 3, donate=False)
    port = torch_cm(tcfg, params)

    config = {"vocab_size": port.encoder.tok_embed.num_embeddings,
              "preprocess": pre, "model": model_d, "train": train,
              "stats": stats}
    c = read_config(config)
    ref = AcousticModel(c)
    ref.load_state_dict(port.state_dict(), strict=True)
    state = fresh_state(ref, config)
    batch = train_batch(3, (8, 5), 8, 32)
    tb = to_device(_flat({k: v for k, v in batch.items()
                          if k != "speakers"}), "cpu")
    for seed in (3, 4):
        ri, rn, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
        idx = jax.random.categorical(ri, jnp.log(jnp.asarray(PROBS))[None],
                                     shape=(2,))
        noise = jax.random.normal(rn, batch["mels"].shape, jnp.float32)
        jstate, jm = jf(jstate, jax_tree(batch), jnp.asarray(PROBS),
                        jax.random.PRNGKey(seed), jnp.asarray(0.95))
        state, loss, _ = ct_step(
            ref, state, tb, torch.Generator(), config, c,
            draws=(torch.from_numpy(np.array(idx)),
                   torch.from_numpy(np.array(noise))))
        np.testing.assert_allclose(loss, float(jm["loss"]), rtol=2e-4)

    def close(jtree, ttree, tol, what):
        want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jtree),
                                  port)
        assert set(want) == set(ttree), what
        for k in want:
            np.testing.assert_allclose(ttree[k].numpy(), want[k].numpy(),
                                       err_msg=f"{what} {k}", **tol)

    close(jstate.params, state["params"], TOL, "params")
    close(jstate.target_params, state["target"], TOL, "target")
    for i, (je, te) in enumerate(zip(jstate.ema_params, state["ema"])):
        close(je, te, TOL, f"ema{i}")
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")][0]
    assert state["count"] == int(adam.count) == 2
    close(adam.mu, state["mu"], MOMENT_TOL, "mu")
    close(adam.nu, state["nu"], MOMENT_TOL, "nu")


def test_radam_matches_optax_across_rectification():
    """Twelve steps (rectified from the fifth or sixth) of RAdam on a few
    leaves against ``optax.radam``, with and without weight decay."""
    import jax.numpy as jnp
    import optax

    rs = np.random.RandomState(0)
    p0 = {"a": rs.randn(7, 5).astype(np.float32),
          "b": rs.randn(3).astype(np.float32)}
    for wd in (0.0, 1e-2):
        tx = optax.radam(1e-3) if not wd else optax.chain(
            optax.add_decayed_weights(wd), optax.radam(1e-3))
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        js = tx.init(jp)
        ts = {"count": 0, "params": {k: torch.from_numpy(v.copy())
                                     for k, v in p0.items()},
              "mu": {k: torch.zeros(v.shape) for k, v in p0.items()},
              "nu": {k: torch.zeros(v.shape) for k, v in p0.items()}}
        for _ in range(12):
            g = {k: rs.randn(*v.shape).astype(np.float32)
                 for k, v in p0.items()}
            u, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                              jp)
            jp = optax.apply_updates(jp, u)
            ts = radam(ts, {k: torch.from_numpy(v) for k, v in g.items()},
                       1e-3, wd)
            for k in p0:
                np.testing.assert_allclose(ts["params"][k].numpy(),
                                           np.asarray(jp[k]), rtol=1e-6,
                                           atol=1e-7)


@pytest.mark.parametrize("seed", [2 ** 31 + 21, 5])
def test_feed_matches_the_jax_package(tmp_path, seed):
    from cmtts_tpu.core.config import config_from_dicts
    from cmtts_tpu.data.dataset import FeatureDataset, batch_iterator

    with open(os.path.join(tinybench.BENCH, "traffic",
                           "lj_ct_corpus.json")) as f:
        mix = dict(json.load(f), utterances=48)
    config = _ljspeech()
    config["train"]["optimizer"]["batch_size"] = 4
    root = str(tmp_path / "corpus")
    meta = corpus.write(root, mix, seed)
    pre = dict(config["preprocess"], path={"preprocessed_path": root})
    cfg = config_from_dicts(pre, config["model"], config["train"], {})
    want = batch_iterator(FeatureDataset("train.txt", cfg), 4, 4, seed=77)
    ref = Feed(root, meta, config, 77, 10)
    for i in range(10):
        batch, b = next(want), ref.batch(i)
        assert b["rows"] == batch["ids"]
        for k, a in b["arrays"].items():
            top, _, sub = k.partition(".")
            p = np.asarray(batch[top][sub] if sub else batch[top])
            assert p.shape == a.shape and np.array_equal(p, a), k


def test_speaker_embedder_matches_the_jax_package():
    """The reference's fbank slice and ResCNN against the JAX package's
    DeepSpeaker (flax-initialised, BatchNorms perturbed) on a 3 s clip and
    a short one that tiles."""
    import jax
    import jax.numpy as jnp
    from cmtts_tpu.models import speaker as js
    from cmtts_tpu_torch.convert import load_flax_params
    from cmtts_tpu_torch.models.speaker import DeepSpeakerResCNN
    from perfbench.reference.speaker import ResCNN, fbank_slice
    from test_torch_port_speaker import perturb_bn, speech_like

    v = jax.jit(js.DeepSpeakerResCNN().init)(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 160, 64, 1)))
    v = jax.tree_util.tree_map(np.array, dict(v))
    perturb_bn(v["params"], v["batch_stats"], np.random.RandomState(1))
    port = load_flax_params(DeepSpeakerResCNN(), v["params"],
                            v["batch_stats"])
    ref = ResCNN().eval()
    ref.load_state_dict(port.state_dict(), strict=True)
    for seconds in (3.0, 0.8):
        wav = speech_like(seconds, seed=7)
        frames = js.ds_sample_frames(js.ds_fbank_frames(wav))
        x = fbank_slice(wav, 22050)
        np.testing.assert_allclose(x, frames, rtol=1e-5, atol=1e-5)
        want = np.asarray(js.DeepSpeakerResCNN().apply(
            v, jnp.asarray(frames[None, :, :, None]), train=False))
        with torch.no_grad():
            got = ref(torch.from_numpy(x[None])).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
