"""The port's metric suite against the JAX package's: the copied numpy
metrics, feature extractors, YIN and DTW must give exactly what the JAX
modules give on the same seeded inputs (the same numpy code), and so must
the harness (``Cal`` values, ``CalOneModel``'s CSV rows, the WER dump) over
one results tree.  ``speaker_cos`` is held to JAX through the GE2E of both
packages on the same flax weights; the optional dependencies fail closed."""

import os
import sys

import numpy as np
import pytest

SR = 22050
# two GE2E embeddings, each within the speaker tests' GE2E_ATOL of JAX's
# (tests/test_torch_port_speaker.py), give cosines within twice it
COS_ATOL = 2e-5


def _utterances(n_words, seed):
    """Formant-synthesized utterances (host numpy, seeded)."""
    from cmtts_tpu_torch.data import synthcorpus as sc

    rng = np.random.RandomState(seed)
    phones, durs = sc.sample_utterance(rng, n_words)
    f0 = sc.f0_contour(phones, durs, rng, base=160.0)
    return sc.synthesize(phones, durs, f0, rng)


@pytest.fixture(scope="module")
def wavs():
    """(reference, a noisy copy of it, another utterance), 0.5 s each."""
    a = _utterances((1, 2), 11)[:11025]
    rs = np.random.RandomState(5)
    noisy = (a + 0.02 * rs.randn(len(a))).astype(np.float32)
    b = _utterances((1, 2), 12)[:11025]
    return a, noisy, b


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [a for item in x for a in _flat(item)]
    return [np.asarray(x)]


def _core_cases(wavs, tmp):
    a, noisy, b = wavs
    rs = np.random.RandomState(0)
    short = (a[:2205], noisy[:2000])      # waveform DTW stays quick
    feats = (rs.randn(120, 4), rs.randn(90, 4) * 1.3 + 0.2)
    img = rs.rand(30, 20), rs.rand(30, 20)
    from cmtts_tpu_torch.audio.wavio import write_wav
    paths = []
    for i, (w, sr) in enumerate(((a, SR), (b, 16000))):
        p = os.path.join(tmp, f"w{i}.wav")
        write_wav(p, w, sr)
        paths.append(p)
    pair = (noisy, a)
    return {
        "extract_f0": (a,),
        "aligned_voiced_f0": pair,
        "f0_rmse": pair,
        "f0_corr": (b, a),
        "ffe": (a, b),
        "mcd24": pair,
        "mcd_dtw": (b, a),
        "mcd_dctmel": pair,
        "log_f0_mcep": (b, a),
        "ssim_2d": (img[0], img[1], 1.0),
        "aligned_norm_mfcc": (b, a),
        "mfcc_cos": pair,
        "si_sdr": short,
        "mel_sdr": (rs.randn(40, 8), rs.randn(35, 8)),
        "gmm_kl": (feats[0], feats[1], 4),
        "edit_distance": ("a b c d".split(), "a x c d e".split()),
        "wer_counts": ("Hello, world! It's me.", "hello word its me"),
        "wer": ("", "something"),
        "frechet_distance": feats,
        "manifold_precision_recall": (feats[0], feats[1]),
        "frame_features:mel": (paths, "mel"),
        "frame_features:mfcc": (paths, "mfcc", SR, 30),
        "frame_features:mfcc_un_norm": (paths, "mfcc_un_norm"),
        "features.load_wav": (paths[1],),
        "features.mel_power": (b,),
        "features.mfcc": (a,),
        "features.mcep_dctmel": (a,),
        "features.cheaptrick_envelope": (b,),
        "features.sptk_mcep_from_spectrum": (np.abs(rs.randn(20, 257)) + 0.1,),
        "features.freqt": (rs.randn(6, 9), 5, 0.3),
        "features.mcep": (a,),
        "features.mfcc_normalized": (paths[0],),
        "features.trim_silence": (np.concatenate([np.zeros(3000, np.float32),
                                                  a, np.zeros(2000)]),),
        "yin.compute_yin": (a, SR),
        "dtw.dtw_path:banded": (rs.randn(700, 2), rs.randn(650, 2)),
        "dtw.dtw_cost": (rs.randn(3, 40), rs.randn(3, 30),
                         lambda x, y: float(np.abs(x - y).sum())),
        # quantized samples: many equal costs, so the tie order shows
        "dtw.dtw_path:ties": (rs.randint(0, 4, (3000, 1)) / 4.0,
                              rs.randint(0, 4, (2800, 1)) / 4.0),
        "dtw.dtw_path:wide": (rs.randn(700, 13), rs.randn(760, 13)),
    }


CORE_CASES = [
    "extract_f0", "aligned_voiced_f0", "f0_rmse", "f0_corr", "ffe", "mcd24",
    "mcd_dtw", "mcd_dctmel", "log_f0_mcep", "ssim_2d", "aligned_norm_mfcc",
    "mfcc_cos", "si_sdr", "mel_sdr", "gmm_kl", "edit_distance", "wer_counts",
    "wer", "frechet_distance", "manifold_precision_recall",
    "frame_features:mel", "frame_features:mfcc",
    "frame_features:mfcc_un_norm", "features.load_wav", "features.mel_power",
    "features.mfcc", "features.mcep_dctmel", "features.cheaptrick_envelope",
    "features.sptk_mcep_from_spectrum", "features.freqt", "features.mcep",
    "features.mfcc_normalized", "features.trim_silence", "yin.compute_yin",
    "dtw.dtw_path:banded", "dtw.dtw_cost", "dtw.dtw_path:ties",
    "dtw.dtw_path:wide",
]


@pytest.mark.parametrize("name", CORE_CASES)
def test_numpy_metric_exact(name, wavs, tmp_path):
    """Each copied function returns JAX's values exactly."""
    import importlib

    if name == "gmm_kl":
        pytest.importorskip("sklearn")
    cases = _core_cases(wavs, str(tmp_path))
    assert sorted(cases) == sorted(CORE_CASES)
    args = cases[name]
    mod, _, fn = name.split(":")[0].rpartition(".")
    mod = mod or "core"
    tmod = importlib.import_module(f"cmtts_tpu_torch.metrics.{mod}")
    jmod = importlib.import_module(f"cmtts_tpu.metrics.{mod}")
    out = _flat(getattr(tmod, fn)(*args))
    ref = _flat(getattr(jmod, fn)(*args))
    assert len(out) == len(ref)
    for x, y in zip(out, ref):
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert any(np.isfinite(np.asarray(x, np.float64)).all() for x in out)


@pytest.fixture(scope="module")
def results_tree(tmp_path_factory, wavs):
    """<root>/results/step_{2,4}_T1/u{0,1}.wav (+ a 16 kHz copy that the
    harness skips) and <root>/raw/u{0,1}.wav in the LJSpeech layout."""
    from cmtts_tpu_torch.audio.wavio import write_wav

    a, noisy, b = wavs
    root = tmp_path_factory.mktemp("metrics")
    for d in ("raw", "results/step_2_T1", "results/step_4_T1",
              "results/notastep"):
        os.makedirs(root / d)
    rs = np.random.RandomState(9)
    for i, ref in enumerate((a, b)):
        write_wav(str(root / "raw" / f"u{i}.wav"), ref, SR)
        for step, scale in (("2", 0.05), ("4", 0.01)):
            syn = ref + scale * rs.randn(len(ref))
            write_wav(str(root / f"results/step_{step}_T1/u{i}.wav"),
                      syn.astype(np.float32), SR)
    write_wav(str(root / "results/step_2_T1/u0_16000.wav"), a, 16000)
    return root


HARNESS_METRICS = ["mcd", "mcd24", "mcd_dctmel", "f0_rmse", "f0_corr",
                   "log_f0", "ffe", "ssim", "mfcc_cos", "fid_mel",
                   "fid_mfcc", "precision_mel", "recall_mfcc"]


def test_harness_matches_jax(results_tree):
    """Cal values over one results dir, CalOneModel's CSV over the step
    dirs, and the WER path with a callable transcriber and its dump."""
    from cmtts_tpu.metrics import Cal as JCal
    from cmtts_tpu.metrics import CalOneModel as JOne
    from cmtts_tpu_torch.metrics import Cal, CalOneModel

    raw = str(results_tree / "raw")
    one = str(results_tree / "results" / "step_2_T1")
    cal = Cal(one, data_type="LJSpeech", raw_folder=raw, device="cpu")
    jcal = JCal(one, data_type="LJSpeech", raw_folder=raw)
    assert sorted(map(os.path.basename, cal.syn2label)) == ["u0.wav", "u1.wav"]
    vals = cal.get_metrics_by_list(HARNESS_METRICS)
    assert vals == jcal.get_metrics_by_list(HARNESS_METRICS)
    assert np.isfinite(vals).all()

    hyp = {"u0": "the cat sat", "u1": "a dog"}

    u0 = cal._wav(os.path.join(one, "u0.wav"))

    def transcribe(wav, sr):
        return hyp["u0" if np.array_equal(wav, u0) else "u1"]

    meta = results_tree / "meta.txt"
    meta.write_text("u0|SYN|{DH AH}|The cat sat down.\n"
                    "u1|SYN|{D AO G}|A dog|barked\n")
    wers = []
    for cls in (Cal, JCal):
        c = cls(one, data_type="LJSpeech", raw_folder=raw,
                transcriber=transcribe, meta_txt=[str(meta)])
        wers.append((c.compute_wer(),
                     (results_tree / "results/step_2_T1/Awer_output.txt")
                     .read_text()))
    assert wers[0] == wers[1] and wers[0][0] == pytest.approx(2 / 7)

    rows = []
    for cls in (CalOneModel, JOne):
        path = cls(str(results_tree / "results"), raw_folder=raw,
                   data_type="LJSpeech").get_model_metrics_by_list(
            ["mcd", "ffe", "mfcc_cos"])
        with open(path) as f:
            rows.append(f.read())
    assert rows[0] == rows[1]
    assert [r.split(",")[0] for r in rows[0].splitlines()] == [
        "train_step", "step_2_T1", "step_4_T1"]


def test_speaker_cos_with_bridged_ge2e(wavs):
    """speaker_cos and Cal.compute_speaker_cos through the port's GE2E and
    JAX's on the same flax weights (non-zero gate biases)."""
    import jax
    import jax.numpy as jnp

    from cmtts_tpu.metrics import core as jcore
    from cmtts_tpu.models.speaker import GE2EEncoder as JE
    from cmtts_tpu.models.speaker import GE2EInference as JI
    from cmtts_tpu_torch.convert import load_flax_params
    from cmtts_tpu_torch.metrics import core
    from cmtts_tpu_torch.models.speaker import GE2EEncoder, GE2EInference

    params = jax.tree_util.tree_map(np.array, jax.jit(JE().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 160, 40)))["params"])
    rs = np.random.RandomState(3)
    for cell in ("lstm_0", "lstm_1", "lstm_2"):
        for g in "ifgo":
            b = params[cell][f"h{g}"]
            b["bias"] = (0.1 * rs.randn(*b["bias"].shape)).astype(np.float32)
    emb = GE2EInference(load_flax_params(GE2EEncoder(), params),
                        "cpu").embed_utterance
    jemb = JI(params).embed_utterance
    a, noisy, b = wavs
    for x, y in ((np.concatenate([a, b, a]), b),):
        out = core.speaker_cos(x, y, emb)
        ref = jcore.speaker_cos(x, y, jemb)
        assert abs(out - ref) < COS_ATOL, (out, ref)
    assert core.speaker_cos(a, a, emb) == pytest.approx(1.0, abs=1e-6)


def test_optional_dependencies_fail_closed(results_tree, monkeypatch,
                                           tmp_path):
    from cmtts_tpu_torch.metrics import Cal, core

    one = str(results_tree / "results" / "step_4_T1")
    cal = Cal(one, data_type="LJSpeech",
              raw_folder=str(results_tree / "raw"), device="cpu")
    for name, net in (("mb_mos", "MBNet"), ("ld_mos", "LDNet")):
        with pytest.raises(RuntimeError, match=f"{net} checkpoint "
                                               "unavailable"):
            cal.get_metrics_by_list([name])
    with pytest.raises(RuntimeError, match="MBNet checkpoint unavailable"):
        cal.get_target_mos()
    with pytest.raises(RuntimeError, match="no ASR given"):
        cal.compute_wer()
    with pytest.raises(FileNotFoundError, match="not downloaded"):
        core.make_transcriber("openai/whisper-base")
    with pytest.raises(TypeError):
        core.make_transcriber(3)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        core.make_transcriber(str(tmp_path))
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.mixture", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        core.gmm_kl(np.zeros((8, 2)), np.zeros((8, 2)))
