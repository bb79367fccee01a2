"""The ported quality and bench tools (``cmtts_tpu_torch/tools/``) against
the JAX package's (``tools/``): each JAX tool's ``main()`` runs in-process
with ``sys.argv`` patched, the port's with ``--device cpu``, on the same
seeded inputs."""

import filecmp
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import config_dicts, write_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reports round cosines to 4 decimals: one unit of that rounding on
# top of the cosines' own float32 agreement
COS_TOL = dict(rtol=0, atol=1e-4 + 1e-5)
F32_TOL = dict(rtol=2e-4, atol=2e-4)     # tests/test_mrf_pallas.py:45-46
# Griffin-Lim: tests/test_torch_port_audio.py holds 4 iterations to 1e-4;
# over the tool's 60 iterations each float32 implementation strays from a
# float64 run of the same algorithm (the witness below) by up to 1.8e-4 on
# the fixture's mels, and the two from each other by up to 2.3e-4 (6.6e-4
# on other 50-frame noise-like mels, amplitude ~0.7): FFT rounding, grown
# over the iterations.  Each wav is held to the other and to the float64
# run by its relative RMS error and its max error.
GL_REL_RMS, GL_MAX = 5e-4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tool(name):
    """The JAX package's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(monkeypatch, name, argv, **patch):
    """``tools/<name>.py``'s main() under ``argv``, with the module's
    attributes in ``patch`` replaced."""
    monkeypatch.setenv("CMTTS_XLA_CACHE", "0")
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    mod = jax_tool(name)
    for k, v in patch.items():
        monkeypatch.setattr(mod, k, v)
    return mod.main()


def port_tool(name):
    return importlib.import_module(f"cmtts_tpu_torch.tools.{name}").main


@pytest.fixture(scope="module")
def zs_corpus(tmp_path_factory):
    """A 5-voice multi-speaker corpus (3 train, 2 held out, 3 utterances
    each) and a seeded GE2E in the GE2E trainer's ``ge2e_params.npy``."""
    from cmtts_tpu_torch.data.synthcorpus import generate_multispeaker_corpus
    from cmtts_tpu_torch.models.speaker import GE2EEncoder, init_ge2e_like_flax
    from cmtts_tpu_torch.train.ge2e_trainer import save_ge2e_params

    root = tmp_path_factory.mktemp("zs")
    generate_multispeaker_corpus(str(root / "raw"), str(root / "pre"),
                                 n_speakers=5, utts_per_speaker=3,
                                 holdout_speakers=2)
    enc = init_ge2e_like_flax(GE2EEncoder(), torch.Generator().manual_seed(0))
    params = {k: v.detach() for k, v in enc.named_parameters()}
    params["sim_weight"] = torch.tensor(10.0)
    params["sim_bias"] = torch.tensor(-5.0)
    emb = str(root / "ge2e_params.npy")
    save_ge2e_params(enc, params, emb)
    return root, emb


def test_extend_holdout_trees_byte_identical(tmp_path, zs_corpus, monkeypatch):
    src, _ = zs_corpus
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    for d in (jroot, troot):
        for sub in ("raw_holdout", "pre_holdout"):
            shutil.copytree(src / sub, d / sub)
    args = ["--speakers", "5", "--holdout", "2", "--utts_per_speaker", "3",
            "--extend_utts_to", "4", "--extra_speakers", "1"]
    run_jax(monkeypatch, "extend_holdout", ["--out", str(jroot)] + args)
    port_tool("extend_holdout")(["--out", str(troot)] + args)

    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    assert files(jroot) == files(troot)
    assert "raw_holdout/v05/v05_000.wav" in files(troot)
    for f in files(jroot):
        assert filecmp.cmp(jroot / f, troot / f, shallow=False), f

    # the determinism self-check refuses a corpus it cannot replay
    wav = troot / "raw_holdout" / "v03" / "v03_000.wav"
    wav.write_bytes(wav.read_bytes()[:-2] + b"\x00\x01")
    with pytest.raises(SystemExit, match="determinism check FAILED"):
        port_tool("extend_holdout")(["--out", str(troot)] + args)


def _assert_report_close(ref, got, path=""):
    assert type(ref) is type(got) or {type(ref), type(got)} <= {int, float}, path
    if isinstance(ref, dict):
        assert set(ref) == set(got), path
        for k in ref:
            _assert_report_close(ref[k], got[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(ref) == len(got), path
        for i, (r, g) in enumerate(zip(ref, got)):
            _assert_report_close(r, g, f"{path}/{i}")
    elif isinstance(ref, float):
        np.testing.assert_allclose(got, ref, err_msg=path, **COS_TOL)
    else:                       # names, counts and pass flags: equal
        assert ref == got, path


def test_check_ge2e_holdout_matches_jax(tmp_path, zs_corpus, monkeypatch):
    root, emb = zs_corpus
    args = ["--embedder_ckpt", emb, "--holdout_root", str(root / "raw_holdout"),
            "--train_root", str(root / "raw"), "--train_limit", "2",
            "--holdout_limit", "3", "--min_top1", "0", "--min_margin", "-2"]
    run_jax(monkeypatch, "check_ge2e_holdout",
            args + ["--out", str(tmp_path / "j.json")])
    got = port_tool("check_ge2e_holdout")(
        args + ["--out", str(tmp_path / "t.json"), "--device", "cpu"])
    ref = json.loads((tmp_path / "j.json").read_text())
    assert json.loads((tmp_path / "t.json").read_text()) == got
    assert set(ref["speakers"]) == {"v03", "v04"}
    _assert_report_close(ref, got)
    # the unrounded embeddings, whose dot products the report rounds
    from cmtts_tpu.models.speaker import GE2EInference as JInference
    from cmtts_tpu.models.speaker import load_ge2e_params as jload
    from cmtts_tpu_torch.audio.wavio import read_wav
    from cmtts_tpu_torch.models.speaker import (
        GE2EInference,
        ge2e_from_checkpoint,
    )

    jinf = JInference(jload(emb))
    tinf = GE2EInference(ge2e_from_checkpoint(emb), "cpu")
    for wav in ("raw_holdout/v03/v03_000.wav", "raw/v00/v00_001.wav"):
        w, _ = read_wav(str(root / wav))
        np.testing.assert_allclose(tinf.embed_utterance(w),
                                   jinf.embed_utterance(w), rtol=0,
                                   atol=1e-5, err_msg=wav)

    # the gate fails closed on both sides
    strict = [a if a != "0" else "1.01" for a in args]
    with pytest.raises(SystemExit, match="gate FAILED"):
        run_jax(monkeypatch, "check_ge2e_holdout", strict)
    with pytest.raises(SystemExit, match="gate FAILED"):
        port_tool("check_ge2e_holdout")(strict + ["--device", "cpu"])


def test_zeroshot_eval_matches_jax(tmp_path, zs_corpus, monkeypatch):
    root, emb = zs_corpus
    # the "synthesized" wavs: two of the target's recordings under the
    # names the target has, so MCD and FFE are computed too
    syn = tmp_path / "syn"
    syn.mkdir()
    for name in ("v03_000.wav", "v03_001.wav"):
        shutil.copy(root / "raw_holdout" / "v03" / name, syn / name)
    args = ["--syn_dir", str(syn), "--target_raw",
            str(root / "raw_holdout" / "v03"), "--others_root",
            str(root / "raw"), "--embedder_ckpt", emb,
            "--ref_utts_per_speaker", "2"]
    run_jax(monkeypatch, "zeroshot_eval",
            args + ["--out", str(tmp_path / "j.json")])
    got = port_tool("zeroshot_eval")(
        args + ["--out", str(tmp_path / "t.json"), "--device", "cpu"])
    ref = json.loads((tmp_path / "j.json").read_text())
    assert json.loads((tmp_path / "t.json").read_text()) == got
    assert ref["n_synth"] == 2 and ref["mcd_vs_target_gt"] is not None
    _assert_report_close(ref, got)


@pytest.fixture(scope="module")
def mel_dir(tmp_path_factory):
    """Noise-like ln-mels under the names vocode_dir must accept, map and
    skip: ``SYN-mel-<base>``, ``<base>-mel``, (80, T), 1-D, no 'mel'."""
    d = tmp_path_factory.mktemp("mels")
    rs = np.random.RandomState(2)
    np.save(d / "SYN-mel-a1.npy", (rs.randn(40, 80) - 3).astype(np.float32))
    np.save(d / "b2-mel.npy", (rs.randn(80, 50) - 3).astype(np.float32))
    np.save(d / "c3-mel-skip.npy", np.zeros(80, np.float32))
    np.save(d / "energy.npy", np.zeros((40, 80), np.float32))
    return d


def _wavs(d):
    from cmtts_tpu_torch.audio.wavio import read_wav

    return {n: read_wav(os.path.join(d, n))[0] for n in sorted(os.listdir(d))}


def test_vocode_dir_hifigan_matches_jax(tmp_path, mel_dir, monkeypatch):
    from cmtts_tpu_torch.convert import state_dict_to_flax
    from cmtts_tpu_torch.models.hifigan import (
        HiFiGANConfig,
        HiFiGANGenerator,
        init_like_flax,
    )
    from torch_port_helpers import save_flat_npz

    gen = init_like_flax(HiFiGANGenerator(HiFiGANConfig(
        upsample_initial_channel=32)), torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "hifigan_gen_00000001.npz")
    save_flat_npz(ckpt, state_dict_to_flax(gen))
    args = ["--mel_dir", str(mel_dir), "--ckpt", ckpt]
    run_jax(monkeypatch, "vocode_dir", args + ["--out", str(tmp_path / "j")])
    n = port_tool("vocode_dir")(args + ["--out", str(tmp_path / "t"),
                                        "--device", "cpu"])
    ref, got = _wavs(tmp_path / "j"), _wavs(tmp_path / "t")
    assert n == 2 and set(ref) == set(got) == {"a1.wav", "b2.wav"}
    for k in ref:
        assert got[k].shape == ref[k].shape == ({"a1.wav": 40,
                                                 "b2.wav": 50}[k] * 256,)
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **F32_TOL)


def _griffin_lim_f64(log_mel, n_iters=60):
    """The Griffin-Lim of ``audio/stft.py`` (pseudo-inverse mel basis, zero
    phase, centered Hann OLA, trim, peak cap) in float64 numpy."""
    from cmtts_tpu_torch.audio.stft import MelSpectrogram

    st = MelSpectrogram(device="cpu")
    inv = np.linalg.pinv(st.mel_basis.astype(np.float64), rcond=1e-8)
    mag = np.maximum(inv @ np.exp(np.asarray(log_mel, np.float64)).T, 0.0)
    nfft, hop, T = st.filter_length, st.hop_length, mag.shape[1]
    n = (T - 1) * hop + nfft
    idx = np.arange(T)[:, None] * hop + np.arange(nfft)[None, :]
    w = np.asarray(st.window.cpu(), np.float64)
    wsum = np.zeros(n)
    np.add.at(wsum, idx, np.broadcast_to(w * w, idx.shape))
    norm = np.maximum(wsum, 1e-8)

    def wav_of(spec):
        out = np.zeros(n)
        np.add.at(out, idx, np.fft.irfft(spec.T, n=nfft) * w)
        return out / norm

    spec = mag.astype(np.complex128)
    for _ in range(n_iters):
        s = np.fft.rfft(wav_of(spec)[idx] * w, n=nfft, axis=-1).T
        spec = mag * (s / np.maximum(np.abs(s), 1e-8))
    wav = wav_of(spec)[nfft // 2: nfft // 2 + T * hop]
    peak = np.abs(wav).max()
    return wav / peak * 0.95 if peak > 1.0 else wav


def test_vocode_dir_griffinlim_matches_jax(tmp_path, mel_dir, monkeypatch):
    args = ["--mel_dir", str(mel_dir), "--griffinlim"]
    run_jax(monkeypatch, "vocode_dir", args + ["--out", str(tmp_path / "j")])
    port_tool("vocode_dir")(args + ["--out", str(tmp_path / "t"),
                                    "--device", "cpu"])
    ref, got = _wavs(tmp_path / "j"), _wavs(tmp_path / "t")
    assert set(ref) == set(got) == {"a1.wav", "b2.wav"}
    mels = {"a1.wav": np.load(mel_dir / "SYN-mel-a1.npy"),
            "b2.wav": np.load(mel_dir / "b2-mel.npy").T}
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        f64 = _griffin_lim_f64(mels[k])
        for a, b, what in ((got[k], ref[k], "port vs JAX"),
                           (got[k], f64, "port vs float64"),
                           (ref[k], f64, "JAX vs float64")):
            err = a - b
            assert np.sqrt(np.mean(err ** 2) / np.mean(b ** 2)) < GL_REL_RMS, \
                (k, what)
            assert np.abs(err).max() < GL_MAX, (k, what)


def test_diag_pitch_matches_jax_on_the_exported_checkpoint(tmp_path,
                                                           monkeypatch):
    """A JAX checkpoint of seeded weights, exported to the port by
    ``port_tools/export_orbax.py``; both tools teacher-force the same
    feature corpus."""
    import jax
    import jax.numpy as jnp

    from cmtts_tpu.train.checkpoint import save_checkpoint
    from cmtts_tpu.train.state import create_train_state, make_optimizer
    from cmtts_tpu_torch.convert import state_dict_to_flax
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.data.feature_corpus import write_feature_corpus
    from cmtts_tpu_torch.models.cmtts import CMTTS, init_like_flax
    from port_tools.export_orbax import export_step_dir

    dicts = config_dicts()
    stats = write_feature_corpus(str(tmp_path / "pre"), 4, 4, seed=5,
                                 n_mels=16, phonemes=(6, 12), frames=(1, 4))
    roots = {}
    for side in ("jax", "port"):
        train = {"path": {"ckpt_path": str(tmp_path / side / "ckpt")},
                 "optimizer": {"batch_size": 2}}
        roots[side] = write_config(tmp_path / side, "Tiny",
                                   (dicts[0], dicts[1], train,
                                    dict(dicts[3], **stats)))
        # write_config points preprocessed_path at <side>/pre: use the corpus
        shutil.rmtree(tmp_path / side / "pre")
        os.symlink(tmp_path / "pre", tmp_path / side / "pre")
    tcfg = load_configs("Tiny", roots["port"])
    params = state_dict_to_flax(init_like_flax(
        CMTTS(tcfg), torch.Generator().manual_seed(3)))
    jstate = create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                                make_optimizer(1e-4), 3)
    step_dir = save_checkpoint(str(tmp_path / "jax" / "ckpt"),
                               jstate.replace(step=jnp.asarray(5, jnp.int32)))
    export_step_dir(step_dir, tcfg.train.ckpt_path, tcfg)

    def args(side):
        return ["--dataset", "Tiny", "--config_root", roots[side],
                "--out", str(tmp_path / f"{side}.json")]

    run_jax(monkeypatch, "diag_pitch", args("jax"))
    got = port_tool("diag_pitch")(args("port") + ["--device", "cpu"])
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert ref["n_utts"] == got["n_utts"] == 4
    assert ref["n_frames"] == got["n_frames"]
    assert set(ref["variants"]) == set(got["variants"]) == {
        "recon", "pred_cwt", "pred_stats", "pred_all"}
    for v, r in ref["variants"].items():
        g = got["variants"][v]
        assert g["voiced_frames"] == r["voiced_frames"], v
        for k in ("f0_rmse_cents_voiced", "uv_err_rate"):
            np.testing.assert_allclose(g[k], r[k], rtol=1e-4, atol=0,
                                       err_msg=f"{v} {k}")
    assert set(ref["stats_head"]) == set(got["stats_head"])


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def test_bench_train_json_keys_match_jax(monkeypatch, capsys):
    """A tiny CPU smoke: the LJSpeech config swapped for a tiny one (80
    mels, as the bench's batch has) on both sides.  For time, the JAX tool
    runs the K-step config alone, from the port's init through the bridge
    (flax's op-by-op init takes ~20 s here), with XLA's cost analysis (a
    second compile) standing in as a constant."""
    import jax
    import jax.numpy as jnp

    import cmtts_tpu.core.config as jconfig
    import cmtts_tpu_torch.core.config as tconfig
    from cmtts_tpu.models.cmtts import CMTTS as JCMTTS
    from cmtts_tpu_torch.convert import state_dict_to_flax
    from cmtts_tpu_torch.models.cmtts import CMTTS, init_like_flax
    from torch_port_helpers import configs_from

    jcfg, tcfg = configs_from(config_dicts(n_mels=80))
    monkeypatch.setattr(jconfig, "load_configs", lambda *a, **k: jcfg)
    monkeypatch.setattr(tconfig, "load_configs", lambda *a, **k: tcfg)
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(
        init_like_flax(CMTTS(tcfg), torch.Generator().manual_seed(0))))
    monkeypatch.setattr(JCMTTS, "init",
                        lambda self, *a, **k: {"params": params})
    argv = ["--K", "2", "--iters", "2", "--batch", "2", "--t_mel", "24",
            "--t_txt", "6"]
    capsys.readouterr()
    run_jax(monkeypatch, "bench_train", argv + ["--skip_k1"],
            compiled_flops=lambda *a: 1.0)
    ref = _json_lines(capsys.readouterr().out)
    port_tool("bench_train")(argv + ["--skip_k1", "--device", "cpu"])
    assert [set(g) for g in _json_lines(capsys.readouterr().out)] == \
        [set(r) for r in ref]
    assert [r["config"] for r in ref] == ["K=2"]
    # both configs and the K-step gain, as the JAX tool prints them
    port_tool("bench_train")(argv + ["--device", "cpu"])
    got = _json_lines(capsys.readouterr().out)
    assert [set(g) for g in got] == [set(ref[0])] * 2 + [{"speedup_scan"}]
    assert [g.get("config") for g in got] == ["K=1", "K=2", None]
    for g in got[:2]:
        assert np.isfinite(g["loss"]) and g["steps_per_sec"] > 0


class _StubService:
    """What the JAX tool's main() reads of its in-process service."""

    def __init__(self):
        self.batch_hist = {}

    def synthesize(self, text, seed=42):
        self.batch_hist[1] = self.batch_hist.get(1, 0) + 1


def test_bench_serve_inprocess_json_keys_match_jax(tmp_path, monkeypatch):
    """The port's tiny service (cli/gen_corpus.py --tiny's widths) against
    the JAX tool's rows; the JAX tool's service is a stub, since only the
    rows' keys are compared."""
    argv = ["--inprocess", "--concurrency", "1", "2", "--requests", "2",
            "--max_batch", "2"]
    run_jax(monkeypatch, "bench_serve",
            argv + ["--out", str(tmp_path / "j.json")],
            build_tiny_service=lambda max_batch: _StubService())
    rows = port_tool("bench_serve")(argv + ["--out", str(tmp_path / "t.json"),
                                            "--device", "cpu"])
    ref = json.loads((tmp_path / "j.json").read_text())
    assert json.loads((tmp_path / "t.json").read_text()) == rows
    assert [set(r) for r in ref] == [set(r) for r in rows]
    assert [r["concurrency"] for r in rows] == [1, 2]
    assert all(r["errors"] == 0 for r in rows)
    assert sum(sum(r["batch_hist"].values()) for r in rows) >= 2
