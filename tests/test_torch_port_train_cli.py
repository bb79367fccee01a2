"""The port's training CLI and checkpoints on the CPU at a tiny config: CT
with the loss-second-moment sampler, save, auto-resume (the restored state
equal to the saved one), synthesis from the checkpoint, distillation from
it; the checkpoint round trip; the two resume faults that must raise; and
the flax-like initialisation a fresh run starts from."""

import json
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import config_dicts, train_batch, write_config


@pytest.fixture
def run_root(tmp_path):
    """(config root, tmp dir): a tiny config whose corpus (10 train, 2 val
    utterances), checkpoints and logs live under tmp; batch 2 (group 4),
    loss-second-moment sampler, save every 2 steps, log every step."""
    from cmtts_tpu_torch.data.feature_corpus import write_feature_corpus

    pre, model, _, stats = config_dicts()
    train = {"path": {k: str(tmp_path / k) for k in
                      ("ckpt_path", "log_path", "result_path")},
             "optimizer": {"batch_size": 2},
             "step": {"save_step": 2, "log_step": 1},
             "cm": {"schedule_sampler": "loss-second-moment"}}
    root = write_config(tmp_path, "Tiny", (pre, model, train, stats))
    write_feature_corpus(str(tmp_path / "pre"), 10, 2, seed=0, n_mels=16,
                         phonemes=(5, 12), frames=(1, 4))
    return root, tmp_path


def train(root, *extra):
    from cmtts_tpu_torch.cli.train_cm import main

    return main(["--model", "consistency_training", "--dataset", "Tiny",
                 "--config_root", root, "--device", "cpu", *extra])


def assert_states_equal(a, b):
    assert a.step == b.step and a.opt_state["count"] == b.opt_state["count"]
    for ta, tb in ((a.params, b.params), (a.target_params, b.target_params),
                   (a.opt_state["mu"], b.opt_state["mu"]),
                   (a.opt_state["nu"], b.opt_state["nu"]),
                   *zip(a.ema_params, b.ema_params)):
        assert set(ta) == set(tb)
        for k in ta:
            assert torch.equal(ta[k], tb[k]), k


def test_cli_journey_cpu(run_root, capsys, monkeypatch):
    """CT to step 4 (saves 2 and 4), auto-resume to 6 from exactly the
    saved state and LSM history, one-step synthesis from the checkpoint,
    CD from it (the student starts as the teacher), and the stop after the
    first save under DIFFUSION_TRAINING_TEST."""
    from cmtts_tpu_torch.audio.wavio import read_wav
    from cmtts_tpu_torch.cli.synthesize import main as synthesize
    from cmtts_tpu_torch.train.checkpoint import list_checkpoint_steps

    root, tmp = run_root
    r1 = train(root, "--total_step", "4")
    ckpt = str(tmp / "ckpt_path")
    assert list_checkpoint_steps(ckpt) == [2, 4]
    assert r1["state"].step == 4 and len(r1["losses"]) == 4
    assert np.isfinite(r1["losses"]).all()
    r2 = train(root, "--total_step", "6", "--restore_step", "-1")
    out = capsys.readouterr().out
    assert "auto-resume: step 4" in out and "restored step 4" in out
    assert r2["start_step"] == 4 and r2["state"].step == 6
    assert_states_equal(r2["restored"], r1["state"])
    for k, v in r1["sampler"].state_dict().items():
        np.testing.assert_array_equal(r2["restored_sampler"][k], v)
    assert list_checkpoint_steps(ckpt) == [2, 4, 6]
    with open(tmp / "log_path_cm" / "train" / "progress.csv") as f:
        rows = f.read().splitlines()
    head = rows[0].split(",")
    last = dict(zip(head, rows[-1].split(",")))
    assert {"loss", "mel_loss_onestep", "grad_norm", "cm_i0_sum",
            "feed_empty_frac", "feed_full_frac"} <= set(head)
    assert float(last["step"]) == 6 and np.isfinite(float(last["loss"]))
    assert 0 <= float(last["feed_empty_frac"]) <= 1
    assert float(last["feed_full_frac"]) >= 0
    with open(os.path.join(ckpt, "CMDenoiserTTS", "run_config.json")) as f:
        assert json.load(f)["schedule_sampler"] == "loss-second-moment"

    synthesize(["--mode", "single", "--text", "Hello world.", "--dataset",
                "Tiny", "--config_root", root, "--restore_step", "6",
                "--params_role", "target_model", "--vocoder", "griffinlim",
                "--device", "cpu", "--out_dir", str(tmp / "out")])
    mel = np.load(tmp / "out" / "single-mel.npy")
    wav, _ = read_wav(str(tmp / "out" / "single.wav"))
    assert mel.shape[1] == 16 and len(wav) == len(mel) * 256
    assert np.isfinite(mel).all() and np.isfinite(wav).all()

    teacher = os.path.join(ckpt, "CMDenoiserTTS", "step_00000006")
    from cmtts_tpu_torch.cli.train_cm import main

    r3 = main(["--model", "consistency_distillation", "--teacher_path",
               teacher, "--teacher_role", "ema_0", "--dataset", "Tiny",
               "--config_root", root, "--device", "cpu", "--total_step", "2",
               "--path_tag", "cd"])
    assert "loaded teacher" in capsys.readouterr().out
    assert r3["state"].step == 2 and np.isfinite(r3["losses"]).all()
    assert list_checkpoint_steps(ckpt + "_cd") == [2]

    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    r4 = train(root, "--total_step", "6", "--path_tag", "dt")
    assert r4["state"].step == 2
    assert "stopping after first save" in capsys.readouterr().out


def test_checkpoint_round_trip_resume_equals_uninterrupted(tmp_path):
    """Save after one step, restore, take the second step: the state equals
    two uninterrupted steps' bit for bit, and the LSM history round-trips."""
    from cmtts_tpu_torch.core.config import config_from_dicts
    from cmtts_tpu_torch.models.cmtts import CMTTS, init_like_flax
    from cmtts_tpu_torch.train.checkpoint import (
        restore_checkpoint,
        sampler_state_from_payload,
        save_checkpoint,
        state_from_payload,
    )
    from cmtts_tpu_torch.train.loop import batch_to_device, make_train_step
    from cmtts_tpu_torch.train.resample import LossSecondMomentSampler
    from cmtts_tpu_torch.train.state import RAdam, create_train_state

    cfg = config_from_dicts(*config_dicts())
    model = init_like_flax(CMTTS(cfg), torch.Generator().manual_seed(0))
    opt = RAdam(1e-3)
    step = make_train_step(model, cfg, opt, 3)
    batch = batch_to_device(train_batch(0, (8, 5), 8, 32), "cpu")
    probs = np.asarray([0.5, 0.5], np.float32)
    s0 = create_train_state(
        {k: v.detach() for k, v in model.named_parameters()}, opt, 3)

    def two_steps(state, between=lambda s: s):
        for i in range(2):
            state, m = step(state, batch, probs, 0.95,
                            torch.Generator().manual_seed(i))
            if i == 0:
                state = between(state)
        return state

    sampler = LossSecondMomentSampler(3, history_per_term=2)
    sampler.update(np.asarray([0, 1, 1]), np.asarray([1.0, 2.0, 3.0]))

    def save_restore(state):
        save_checkpoint(str(tmp_path), state, sampler.state_dict())
        payload = restore_checkpoint(str(tmp_path))
        back = sampler_state_from_payload(payload)
        for k, v in sampler.state_dict().items():
            np.testing.assert_array_equal(back[k], v)
        return state_from_payload(payload, 3)

    assert_states_equal(two_steps(s0, save_restore), two_steps(s0))


def test_latest_complete_step_fails_closed(tmp_path):
    """Auto-resume reads only committed steps, and raises when step
    directories exist but none is committed (a fresh start would overwrite
    the run); an uncommitted step cannot be restored."""
    from cmtts_tpu_torch.train.checkpoint import (
        MARKER,
        latest_complete_step,
        restore_checkpoint,
        save_checkpoint,
        step_dir,
    )
    from cmtts_tpu_torch.train.state import CMTrainState, RAdam

    base = str(tmp_path)
    assert latest_complete_step(base) == 0
    params = {"w": torch.ones(2)}
    for s in (2, 4):
        save_checkpoint(base, CMTrainState(s, params, RAdam(1e-3).init(params),
                                           (params,), params))
    assert latest_complete_step(base) == 4
    os.remove(os.path.join(step_dir(base, 4), MARKER))
    assert latest_complete_step(base) == 2
    with pytest.raises(FileNotFoundError, match=MARKER):
        restore_checkpoint(base, 4)
    os.remove(os.path.join(step_dir(base, 2), MARKER))
    with pytest.raises(RuntimeError, match="none carries"):
        latest_complete_step(base)


@pytest.mark.parametrize("flag", [["--cwt_masked_std"],
                                  ["--schedule_sampler", "uniform"]])
def test_resume_refuses_other_graph_flags(run_root, monkeypatch, flag):
    """A resume whose graph-affecting flags differ from the recorded run's
    raises before anything is written; the sidecar keeps the run's."""
    root, tmp = run_root
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    train(root, "--total_step", "2")
    sidecar = tmp / "ckpt_path" / "CMDenoiserTTS" / "run_config.json"
    before = sidecar.read_text()
    with pytest.raises(ValueError, match="other flags"):
        train(root, "--total_step", "4", "--restore_step", "-1", *flag)
    assert sidecar.read_text() == before


def test_train_cli_needs_cuda_by_default(run_root, monkeypatch):
    from cmtts_tpu_torch.cli.train_cm import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--model", "consistency_training", "--dataset", "Tiny",
              "--config_root", run_root[0]])


def test_init_like_flax_matches_flax_init():
    """Every parameter of a fresh run is drawn as flax's CMTTS.init draws
    it: zero where flax is zero (biases, the denoiser's output head,
    embedding row 0 of pitch and energy), ones for LayerNorm scales, and a
    standard deviation within 20% of flax's for every tensor of 256 or
    more entries (same shapes through the bridge).  Two configurations: the
    single-speaker one, and a multi-speaker one whose speaker table (8
    speakers x H 64 = 512 entries) flax draws from normal(H^-0.5)."""
    import jax
    import jax.numpy as jnp

    from cmtts_tpu.models.cmtts import CMTTS as JCMTTS
    from cmtts_tpu_torch.convert import flax_to_state_dict
    from cmtts_tpu_torch.models.cmtts import init_like_flax
    from torch_port_helpers import configs_from, torch_cm

    for speaker_embedder in (None, "none"):
        dicts = config_dicts(speaker_embedder=speaker_embedder)
        dicts[1]["transformer"] = dict(dicts[1]["transformer"],
                                       encoder_hidden=64)
        dicts[1]["denoiser"] = dict(residual_channels=64, residual_layers=2)
        if speaker_embedder is not None:
            dicts[3]["n_speakers"] = 8
        jcfg, tcfg = configs_from(dicts)
        B = 1
        variables = jax.jit(JCMTTS(jcfg).init,
                            static_argnames="deterministic")(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(0)},
            jnp.zeros((B, 32, 16)), jnp.zeros(B),
            speakers=jnp.zeros(B, jnp.int32),
            texts=jnp.ones((B, 8), jnp.int32),
            src_lens=jnp.full((B,), 8, jnp.int32),
            spker_embeds=jnp.zeros((B, jcfg.model.external_speaker_dim)),
            deterministic=True)
        flax = jax.tree_util.tree_map(np.asarray, variables["params"])

        model = torch_cm(tcfg, flax)
        ref = flax_to_state_dict(flax, model)
        init_like_flax(model, torch.Generator().manual_seed(1))
        if speaker_embedder is not None:
            assert model.speaker_emb.weight.numel() >= 256
        for k, v in model.named_parameters():
            r = ref[k]
            if not r.any():
                assert not v.any(), (speaker_embedder, k)
            elif (r == 1).all():
                assert (v == 1).all(), (speaker_embedder, k)
            elif r.numel() >= 256:
                ratio = float(v.detach().std() / r.std())
                assert 0.8 < ratio < 1.25, (speaker_embedder, k, ratio)
        for name in ("pitch_embed", "energy_embed"):
            assert not getattr(model.variance_adaptor, name).weight[0].any()


def test_init_like_flax_matches_flax_init_of_trainers():
    """The vocoder and speaker-encoder trainers' fresh runs draw as flax
    does: for the HiFi-GAN generator (one upsample stage, every kind of
    its layers), the discriminators (MPD and MSD, grouped WNConvs) and the
    GE2E encoder, zeros where flax has zeros and a standard deviation
    within 20% of flax's for every tensor of 256 or more entries (through
    the bridge); each WNConv's g is ||v||; and each gate's hidden kernel is
    orthogonal, which flax's OptimizedLSTMCell draws it as (a std cannot
    tell it from LeCun-normal: both give 1/sqrt(H))."""
    import jax
    import jax.numpy as jnp

    from cmtts_tpu.models.hifigan import HiFiGANConfig as JGC
    from cmtts_tpu.models.hifigan import HiFiGANGenerator as JG
    from cmtts_tpu.models.hifigan_disc import HiFiGANDiscConfig as JDC
    from cmtts_tpu.models.hifigan_disc import HiFiGANDiscriminators as JD
    from cmtts_tpu.models.speaker import GE2EEncoder as JE
    from cmtts_tpu_torch.convert import flax_to_state_dict
    from cmtts_tpu_torch.models import hifigan, hifigan_disc
    from cmtts_tpu_torch.models.speaker import (
        GE2EEncoder,
        init_ge2e_like_flax,
    )

    gen_cfg = dict(upsample_rates=(8,), upsample_kernel_sizes=(16,),
                   upsample_initial_channel=64, num_mels=80)
    disc_cfg = dict(periods=(2, 3), mpd_channels=(16, 32),
                    msd_channels=(16, 32, 16), msd_groups=(1, 4, 1),
                    msd_kernels=(15, 41, 5), msd_strides=(1, 2, 1),
                    n_scales=2)
    key = jax.random.PRNGKey(0)
    cases = [
        (jax.jit(JG(JGC(**gen_cfg)).init)(key, jnp.zeros((1, 4, 80))),
         hifigan.HiFiGANGenerator(hifigan.HiFiGANConfig(**gen_cfg)),
         hifigan.init_like_flax),
        (jax.jit(JD(JDC(**disc_cfg)).init)(key, jnp.zeros((1, 256))),
         hifigan_disc.HiFiGANDiscriminators(
             hifigan_disc.HiFiGANDiscConfig(**disc_cfg)),
         hifigan_disc.init_like_flax),
        (jax.jit(JE().init)(key, jnp.zeros((1, 4, 40))), GE2EEncoder(),
         init_ge2e_like_flax),
    ]
    for variables, model, init in cases:
        flax = jax.tree_util.tree_map(np.asarray, variables["params"])
        ref = flax_to_state_dict(flax, model)
        init(model, torch.Generator().manual_seed(1))
        name = type(model).__name__
        for k, v in model.named_parameters():
            r = ref[k]
            if not r.any():
                assert not v.any(), (name, k)
            elif r.numel() >= 256:
                ratio = float(v.detach().std() / r.std())
                assert 0.8 < ratio < 1.25, (name, k, ratio)
        for m in model.modules():
            if isinstance(m, hifigan_disc.WNConv):
                torch.testing.assert_close(m.g, m.v.flatten(1).norm(dim=1))
    enc = cases[-1][1]
    H = enc.lstm.hidden_size
    for k in range(enc.lstm.num_layers):
        w = getattr(enc.lstm, f"weight_hh_l{k}").detach()
        for gate in range(4):
            q = w[gate * H:(gate + 1) * H]
            torch.testing.assert_close(q.T @ q, torch.eye(H), atol=1e-5,
                                       rtol=0)
        w = getattr(enc.lstm, f"weight_ih_l{k}").detach()
        assert not torch.allclose(w[:H].T @ w[:H], torch.eye(w.shape[1]),
                                  atol=1e-2)
