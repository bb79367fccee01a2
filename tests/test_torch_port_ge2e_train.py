"""The port's GE2E trainer against the JAX package's: the similarity matrix
and the loss, three steps of the scaled, clipped Adam update from the same
weights and batches (through the param bridge), the summed LSTM bias
against flax's, the verification EER, the toy partials' batches, the
``ge2e_params.npy`` format, and the CLI on the CPU.  The partials are the
JAX suite's toy set (``tests/test_ge2e_trainer.py``): 4 speakers x 6
partials of 160 x 40."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmtts_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from cmtts_tpu_torch.models.speaker import GE2EEncoder, init_ge2e_like_flax
from torch_port_helpers import assert_adam_params_close, formant_corpus

S, U, LR = 4, 4, 3e-3     # the JAX suite's
# float32 on both sides: loss and grad norm to the JAX suite's f32
# tolerance; params after Adam steps in terms of lr
# (torch_port_helpers.assert_adam_params_close)
METRIC_TOL = dict(rtol=2e-4, atol=2e-4)



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: its CPU work is many small
    ops in sequence (an LSTM's 160 steps, a GAN step's convolutions), which
    torch's thread pool slows to a crawl when the suite's parallel workers
    already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def toy_partials(tmp_path_factory):
    root = tmp_path_factory.mktemp("partials")
    rng = np.random.RandomState(0)
    for s in range(4):
        d = root / f"spk{s}"
        d.mkdir()
        base = rng.rand(160, 40).astype(np.float32) * (s + 1)
        for u in range(6):
            part = base + 0.05 * rng.rand(160, 40).astype(np.float32)
            np.save(str(d / f"utt{u}.npy"), part)
    return str(root)


@pytest.fixture(scope="module")
def weights():
    """The port's encoder drawn as flax draws it, and its flax tree."""
    enc = init_ge2e_like_flax(GE2EEncoder(), torch.Generator().manual_seed(0))
    return enc, state_dict_to_flax(enc)


def test_similarity_and_loss_match_jax():
    from cmtts_tpu.models import speaker as J
    from cmtts_tpu_torch.models import speaker as P

    e = np.random.RandomState(0).randn(5, 3, 16).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    sim, loss = jax.jit(J.ge2e_similarity_matrix), jax.jit(J.ge2e_loss)
    for w, b in ((10.0, -5.0), (3.5, 0.25)):
        np.testing.assert_allclose(
            P.ge2e_similarity_matrix(torch.from_numpy(e), w, b).numpy(),
            np.asarray(sim(jnp.asarray(e), w, b)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            float(P.ge2e_loss(torch.from_numpy(e), w, b)),
            float(loss(jnp.asarray(e), w, b)), rtol=1e-5)


@pytest.fixture(scope="module")
def three_steps(toy_partials, weights):
    """Three steps on both sides from the same weights and batches: ->
    [(JAX params, loss, gnorm, port params, loss, gnorm)]."""
    import optax

    from cmtts_tpu.models.speaker import GE2EEncoder as JE
    from cmtts_tpu.train.ge2e_trainer import (
        GE2ETrainConfig as JCfg,
        SpeakerVerificationDataset,
        make_ge2e_train_step as jmake,
    )
    from cmtts_tpu_torch.train.ge2e_trainer import (
        GE2ETrainConfig,
        init_ge2e_train,
        make_ge2e_train_step,
    )

    enc, tree = weights
    ds = SpeakerVerificationDataset(toy_partials)
    rng = np.random.RandomState(0)
    batches = [ds.sample_batch(rng, S, U)[0] for _ in range(3)]

    jparams = {"encoder": jax.tree_util.tree_map(jnp.asarray, tree),
               "sim_weight": jnp.asarray(10.0), "sim_bias": jnp.asarray(-5.0)}
    tx = optax.adam(LR)
    jopt = tx.init(jparams)
    jstep = jmake(JE(), tx, S, U, JCfg(learning_rate=LR))

    model, params, ttx, topt = init_ge2e_train(0, LR, "cpu")
    model.load_state_dict(enc.state_dict())
    params = {k: (torch.tensor(10.0) if k == "sim_weight" else
                  torch.tensor(-5.0) if k == "sim_bias" else
                  enc.get_parameter(k[len("encoder."):]).detach())
              for k in params}
    tstep = make_ge2e_train_step(model, ttx, S, U,
                                 GE2ETrainConfig(learning_rate=LR))
    out = []
    for mels in batches:
        jparams, jopt, jl, jg = jstep(jparams, jopt, jnp.asarray(mels))
        params, topt, tl, tg = tstep(params, topt, torch.from_numpy(mels))
        out.append((jax.tree_util.tree_map(np.asarray, jparams), float(jl),
                    float(jg), params, float(tl), float(tg)))
    return model, out


def test_three_steps_match_jax(three_steps):
    """Loss and grad norm (before the clip) of each step, then every param
    after three steps: the x0.01 similarity grads, the clip at norm 3 and
    Adam, held to JAX's ``make_ge2e_train_step``."""
    model, out = three_steps
    for i, (_, jl, jg, _, tl, tg) in enumerate(out):
        np.testing.assert_allclose(tl, jl, **METRIC_TOL, err_msg=f"loss {i}")
        np.testing.assert_allclose(tg, jg, **METRIC_TOL, err_msg=f"gnorm {i}")
    assert max(g for *_, g in out) > 3.0      # the clip acted
    jp, *_, tp, _, _ = out[-1]
    ref = flax_to_state_dict(jp["encoder"], model)
    for k, v in tp.items():
        if k.startswith("encoder."):
            assert_adam_params_close(ref[k[8:]].numpy(), v.numpy(), LR, 3, k)
    for k in ("sim_weight", "sim_bias"):
        assert_adam_params_close(np.asarray(jp[k]), tp[k].numpy(), LR, 3, k)
        assert abs(float(tp[k]) - {"sim_weight": 10.0,
                                   "sim_bias": -5.0}[k]) > 0


def test_lstm_bias_sums_to_flax_bias(three_steps):
    """``bias_hh`` stays 0 and out of the params, so bias_ih + bias_hh is
    flax's one bias per gate after the steps (two trained biases would
    move it at twice flax's rate)."""
    model, out = three_steps
    jp, *_, tp, _, _ = out[-1]
    H = model.lstm.hidden_size
    for k in range(model.lstm.num_layers):
        assert f"encoder.lstm.bias_hh_l{k}" not in tp
        hh = getattr(model.lstm, f"bias_hh_l{k}")
        assert not hh.requires_grad and not hh.any()
        summed = (tp[f"encoder.lstm.bias_ih_l{k}"] + hh).numpy()
        flax = np.concatenate([jp["encoder"][f"lstm_{k}"][f"h{g}"]["bias"]
                               for g in "ifgo"])
        assert np.abs(flax).max() > LR        # the biases moved
        assert_adam_params_close(flax, summed, LR, 3, f"bias layer {k}")
        assert summed.shape == (4 * H,)


def test_eer_matches_jax(toy_partials, three_steps):
    """The verification EER of the stepped encoder on the toy speakers,
    the JAX function scoring the same embeddings (its model's ``apply``
    is the port's encoder): the same partials drawn, the same score."""
    from cmtts_tpu.train.ge2e_trainer import ge2e_verification_eer as jeer
    from cmtts_tpu.train.ge2e_trainer import (
        SpeakerVerificationDataset as JDS,
    )
    from cmtts_tpu_torch.train.ge2e_trainer import (
        SpeakerVerificationDataset,
        encoder_params,
        eer_of,
        ge2e_verification_eer,
    )

    model, out = three_steps
    tp = out[-1][3]

    class PortEncoder:
        @staticmethod
        @torch.no_grad()
        def apply(_, mels):
            return torch.func.functional_call(
                model, encoder_params(tp),
                (torch.from_numpy(np.asarray(mels)),)).numpy()

    ref = jeer(PortEncoder(), {"encoder": None}, JDS(toy_partials))
    got = ge2e_verification_eer(model, tp,
                                SpeakerVerificationDataset(toy_partials))
    assert got == ref
    e = np.random.RandomState(1).randn(12, 8)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    assert eer_of(e, np.repeat(np.arange(3), 4)) > 0.0
    assert eer_of(np.repeat(np.eye(3), 4, axis=0),
                  np.repeat(np.arange(3), 4)) == 0.0


def test_dataset_copies_match_jax(toy_partials, tmp_path):
    """``sample_batch`` and ``prepare_from_wavs`` give the JAX package's
    arrays and files."""
    from cmtts_tpu.train.ge2e_trainer import SpeakerVerificationDataset as J
    from cmtts_tpu_torch.audio.wavio import write_wav
    from cmtts_tpu_torch.train.ge2e_trainer import (
        SpeakerVerificationDataset as P,
    )

    for spk in (None, ["spk1", "spk3"]):
        a = J(toy_partials, spk).sample_batch(np.random.RandomState(4), 3, 8)
        b = P(toy_partials, spk).sample_batch(np.random.RandomState(4), 3, 8)
        np.testing.assert_array_equal(b[0], a[0])
        assert b[1:] == a[1:]
    wav_root = tmp_path / "wavs"
    for s in range(2):
        (wav_root / f"s{s}").mkdir(parents=True)
        t = np.arange(80000) / 22050
        write_wav(str(wav_root / f"s{s}" / "a.wav"),
                  (0.3 * np.sin(2 * np.pi * 150 * (s + 1) * t)).astype(
                      np.float32), 22050)
    na = J.prepare_from_wavs(str(wav_root), str(tmp_path / "ja"))
    nb = P.prepare_from_wavs(str(wav_root), str(tmp_path / "pt"))
    assert na == nb > 2
    for s in ("s0", "s1"):
        names = sorted(os.listdir(tmp_path / "ja" / s))
        assert names == sorted(os.listdir(tmp_path / "pt" / s))
        for n in names:
            np.testing.assert_allclose(np.load(tmp_path / "pt" / s / n),
                                       np.load(tmp_path / "ja" / s / n),
                                       rtol=1e-5, atol=1e-6)


def test_params_file_loads_in_both_packages(three_steps, tmp_path):
    """``ge2e_params.npy`` as the port writes it (the JAX trainer's
    format) embeds the same in the JAX encoder (``load_ge2e_params``),
    through ``ge2e_from_checkpoint`` and with the trained params."""
    from cmtts_tpu.models.speaker import GE2EEncoder as JE
    from cmtts_tpu.models.speaker import load_ge2e_params
    from cmtts_tpu_torch.models.speaker import ge2e_from_checkpoint
    from cmtts_tpu_torch.train.ge2e_trainer import (
        encoder_params,
        save_ge2e_params,
    )

    model, out = three_steps
    tp = out[-1][3]
    path = str(tmp_path / "ge2e_params.npy")
    save_ge2e_params(model, tp, path)
    blob = np.load(path, allow_pickle=True)[0]
    assert set(blob) == {"encoder", "sim_weight", "sim_bias"}
    assert float(blob["sim_weight"]) == float(tp["sim_weight"])
    mels = np.random.RandomState(3).rand(2, 50, 40).astype(np.float32)
    ref = np.asarray(jax.jit(JE().apply)(
        {"params": jax.tree_util.tree_map(jnp.asarray,
                                          load_ge2e_params(path))},
        jnp.asarray(mels)))
    with torch.no_grad():
        got = ge2e_from_checkpoint(path)(torch.from_numpy(mels)).numpy()
        own = torch.func.functional_call(model, encoder_params(tp),
                                         (torch.from_numpy(mels),)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, own, rtol=0, atol=1e-7)


def test_cli_trains_with_validation_on_cpu(tmp_path, capsys):
    """``cli.train_ge2e --device cpu`` from a tiny formant corpus's wavs
    (4 speakers x 3 utterances): slices partials, trains
    with 2 held-out speakers and an EER every step, writes
    ``ge2e_params.npy`` that ``ge2e_from_checkpoint`` reads; the two data
    flags exclude each other."""
    from cmtts_tpu_torch.cli.train_ge2e import main
    from cmtts_tpu_torch.models.speaker import ge2e_from_checkpoint

    root = formant_corpus(tmp_path / "corpus")
    work = str(tmp_path / "run")
    main(["--wav_root", root, "--work_dir", work, "--total_steps", "2",
          "--speakers_per_batch", "2", "--utterances_per_speaker", "2",
          "--val_speakers", "2", "--eval_every", "1", "--log_every", "1",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "==> sliced" in out and "val_eer=" in out
    assert "ge2e step 2: loss=" in out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if "loss=" in line]
    assert len(losses) == 2 and np.isfinite(losses).all()
    path = os.path.join(work, "ge2e_params.npy")
    enc = ge2e_from_checkpoint(path)
    with torch.no_grad():
        e = enc(torch.rand(1, 160, 40))
    assert torch.isfinite(e).all()
    with pytest.raises(SystemExit):
        main(["--wav_root", root, "--partials_root", root, "--work_dir",
              work, "--device", "cpu"])


def test_cli_needs_cuda_by_default(tmp_path, monkeypatch):
    from cmtts_tpu_torch.cli.train_ge2e import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--partials_root", str(tmp_path), "--work_dir",
              str(tmp_path)])
