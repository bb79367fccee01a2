"""The port's data side against the JAX package's: the copied host modules
(TextGrid parser, pitch extraction, corpus preparers, the formant corpus)
must give exactly what the JAX modules give on the same seeded inputs, and
``Preprocessor(device="cpu")`` must give the JAX ``Preprocessor``'s
features, stats and split on one generated corpus at the LJSpeech STFT
settings."""

import json
import os
import random
import types

import numpy as np
import pytest

from torch_port_helpers import assert_mel_close

# energy is an L2 norm of 513 magnitudes summed in another order; the mel
# is held by ``assert_mel_close``; every other feature is host numpy on the
# same samples and must be equal
ENERGY_TOL = dict(rtol=1e-5, atol=1e-4)
N_UTTS = 12


def _tree_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = p
    return out


def _assert_same_tree(a, b):
    fa, fb = _tree_files(a), _tree_files(b)
    assert sorted(fa) == sorted(fb)
    for rel in fa:
        with open(fa[rel], "rb") as x, open(fb[rel], "rb") as y:
            assert x.read() == y.read(), rel


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The formant corpus written by each package (same seed) under its own
    root: <root>/{raw,pre}."""
    from cmtts_tpu.data.synthcorpus import generate_corpus as jgen
    from cmtts_tpu_torch.data.synthcorpus import generate_corpus

    roots = {}
    for name, gen in (("jax", jgen), ("port", generate_corpus)):
        root = tmp_path_factory.mktemp(name)
        gen(str(root / "raw"), str(root / "pre"), n_utts=N_UTTS, seed=1234,
            n_words=(2, 4))
        roots[name] = root
    return roots


def test_generate_corpus_byte_identical(corpora):
    _assert_same_tree(corpora["jax"], corpora["port"])
    assert len(_tree_files(corpora["port"] / "raw")) == 2 * N_UTTS


def test_generate_multispeaker_corpus_byte_identical(tmp_path):
    from cmtts_tpu.data.synthcorpus import generate_multispeaker_corpus as jgen
    from cmtts_tpu_torch.data.synthcorpus import generate_multispeaker_corpus

    outs = []
    for name, gen in (("jax", jgen), ("port", generate_multispeaker_corpus)):
        root = tmp_path / name
        outs.append(gen(str(root / "raw"), str(root / "pre"), n_speakers=3,
                        utts_per_speaker=2, seed=7, n_words=(1, 2),
                        holdout_speakers=1, deterministic_prosody=True))
    assert outs[0] == outs[1]
    _assert_same_tree(tmp_path / "jax", tmp_path / "port")
    assert os.path.isdir(tmp_path / "port" / "raw_holdout" / "v02")


_SHORT_TG = '''File type = "ooTextFile short"
"TextGrid"
0
1.5
<exists>
2
"IntervalTier"
"words"
0
1.5
1
0
1.5
"a ""quoted"" word"
"IntervalTier"
"phones"
0
1.5
4
0
0.25
""
0.25
0.75
"HH"
0.75
1.0
"sp"
1.0
1.5
""
'''


def _tiers(tiers):
    """{name: (tier name, [(start, end, text), ...])}: the two packages'
    dataclasses are different classes."""
    return {k: (v.name, [(iv.start_time, iv.end_time, iv.text)
                         for iv in v.intervals]) for k, v in tiers.items()}


def test_textgrid_parser_matches(corpora, tmp_path):
    """Long format (MFA's empty silence labels included) and short format."""
    from cmtts_tpu.data.textgrid import read_textgrid as jread
    from cmtts_tpu_torch.data.textgrid import read_textgrid

    short = tmp_path / "short.TextGrid"
    short.write_text(_SHORT_TG)
    tg_dir = corpora["port"] / "pre" / "TextGrid" / "LJSpeech"
    paths = [str(short)] + sorted(str(p) for p in tg_dir.iterdir())
    for p in paths:
        assert _tiers(read_textgrid(p)) == _tiers(jread(p)), p
    phones = read_textgrid(str(short))["phones"].intervals
    assert [iv.text for iv in phones] == ["", "HH", "sp", ""]
    assert read_textgrid(str(short))["words"].intervals[0].text == \
        'a "quoted" word'
    assert any(iv.text == "" for iv in read_textgrid(paths[1])["phones"].intervals)
    bad = tmp_path / "bad.TextGrid"
    bad.write_text("no tiers")
    for fn in (read_textgrid, jread):
        with pytest.raises(ValueError, match="no interval tiers"):
            fn(str(bad))


def _pitch_cases():
    """(name, args) of every extraction function on seeded inputs."""
    rs = np.random.RandomState(0)
    sr, hop = 22050, 256
    t = np.arange(int(0.6 * sr)) / sr
    f0_track = 140 + 30 * np.sin(2 * np.pi * 1.5 * t)
    wav = (0.5 * np.sin(2 * np.pi * np.cumsum(f0_track) / sr)
           + 0.01 * rs.randn(len(t))).astype(np.float32)
    wav[: sr // 10] = 0.0                      # a silent, unvoiced head
    f0 = np.abs(150 + 20 * rs.randn(90))
    f0[[0, 1, 2, 40, 41, 88, 89]] = 0.0        # gaps at both ends and inside
    lf0 = np.log(np.abs(f0) + 1.0)
    return [
        ("get_cont_lf0", (f0,)),
        ("get_cont_lf0", (np.zeros(8),)),
        ("cwt_mexican_hat", (lf0,)),
        ("cwt_mexican_hat", (lf0[:37], 0.01, 0.5, 0.02, 5)),
        ("get_lf0_cwt", (lf0 - lf0.mean(),)),
        ("norm_scale", (rs.randn(50, 10),)),
        ("get_lf0_cwt_norm", ([f0, f0[::-1][:60]], 5.0, 0.3)),
        ("estimate_f0_acf", (wav, sr, hop)),
        ("estimate_f0_acf", (wav[:1000], sr, hop)),
        ("get_pitch", (wav, 55, sr, hop)),
        ("get_pitch", (wav, 55, 24000, 300)),
        ("get_pitch", (wav[:2000], 12, sr, hop)),
    ]


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [a for item in x for a in _flat(item)]
    return [np.asarray(x)]


@pytest.mark.parametrize("case", range(len(_pitch_cases())))
def test_pitch_extraction_exact(case):
    from cmtts_tpu.audio import pitch as jp
    from cmtts_tpu_torch.audio import pitch as tp

    name, args = _pitch_cases()[case]
    out, ref = _flat(getattr(tp, name)(*args)), _flat(getattr(jp, name)(*args))
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b, err_msg=name)


def _prep_cfg(corpus, raw, dataset):
    ns = types.SimpleNamespace
    return ns(data=ns(corpus_path=str(corpus), raw_path=str(raw),
                      dataset=dataset),
              stft=ns(sampling_rate=22050, max_wav_value=32768.0))


def _raw_corpora(root):
    """A few-utterance raw corpus in each layout the preparers read, at
    16 kHz so that the resampler runs."""
    from cmtts_tpu_torch.audio.wavio import write_wav

    rs = np.random.RandomState(3)

    def wav(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_wav(path, (0.3 * rs.randn(4000)).astype(np.float32), 16000)

    lj = root / "LJSpeech"
    os.makedirs(lj / "wavs")
    with open(lj / "metadata.csv", "w") as f:
        f.write("LJ001-0001|Dr. Smith paid $5.|Doctor Smith paid five "
                "dollars.\nLJ001-0002|It's 10 o'clock\nLJ001-0003|missing|"
                "no wav\n")
    wav(str(lj / "wavs" / "LJ001-0001.wav"))
    wav(str(lj / "wavs" / "LJ001-0002.wav"))
    vctk = root / "VCTK"
    for spk in ("p225", "p226"):
        for i in (1, 2):
            os.makedirs(vctk / "txt" / spk, exist_ok=True)
            (vctk / "txt" / spk / f"{spk}_00{i}.txt").write_text(
                f"Please call Stella, number {i}.\n")
            if (spk, i) != ("p226", 2):
                wav(str(vctk / "wav48_silence_trimmed" / spk
                        / f"{spk}_00{i}_mic1.wav"))
    libri = root / "LibriTTS"
    for spk, ch in (("84", "121123"), ("19", "198")):
        d = libri / spk / ch
        os.makedirs(d)
        for u in ("000001", "000002"):
            base = f"{spk}_{ch}_{u}"
            wav(str(d / f"{base}.wav"))
            if u == "000001":
                (d / f"{base}.normalized.txt").write_text("Mr. Brown won!\n")
    (libri / "README.txt").write_text("not a speaker")
    return {"LJSpeech": lj, "VCTK": vctk, "LibriTTS": libri}


@pytest.mark.parametrize("dataset", ["LJSpeech", "VCTK", "LibriTTS"])
def test_preparers_byte_identical(tmp_path, dataset, capsys):
    from cmtts_tpu.data.prepare import PREPARERS as JP
    from cmtts_tpu_torch.data.prepare import PREPARERS

    corpus = _raw_corpora(tmp_path / "in")[dataset]
    JP[dataset](_prep_cfg(corpus, tmp_path / "jax", dataset))
    PREPARERS[dataset](_prep_cfg(corpus, tmp_path / "port", dataset))
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("jax", "port") == out[1]
    _assert_same_tree(tmp_path / "jax", tmp_path / "port")
    n_utts = {"LJSpeech": 2, "VCTK": 3, "LibriTTS": 2}[dataset]
    assert len(_tree_files(tmp_path / "port")) == 2 * n_utts


def _pre_cfgs(root, val_size=2):
    """(JAX config, port config) of the repo's LJSpeech config pointed at
    the corpus under ``root``."""
    from cmtts_tpu.core.config import config_from_dicts as jcfg
    from cmtts_tpu.core.config import load_yaml_configs
    from cmtts_tpu_torch.core.config import config_from_dicts as tcfg

    pre, model, train = load_yaml_configs("LJSpeech")
    pre["path"]["raw_path"] = str(root / "raw")
    pre["path"]["preprocessed_path"] = str(root / "pre")
    pre["preprocessing"]["val_size"] = val_size
    return jcfg(pre, model, train), tcfg(pre, model, train)


@pytest.fixture(scope="module")
def preprocessed(corpora):
    """Both preprocessors over their package's copy of the corpus, each
    after random.seed(0) (build_from_path shuffles with the global random)."""
    from cmtts_tpu.data.preprocessor import Preprocessor as J
    from cmtts_tpu_torch.data.preprocessor import Preprocessor as T

    out = {}
    for name, cls, kw in (("jax", J, {}), ("port", T, {"device": "cpu"})):
        cfg = _pre_cfgs(corpora[name])[0 if name == "jax" else 1]
        random.seed(0)
        out[name] = cls(cfg, **kw).build_from_path()
    return out


def test_preprocessor_matches_jax(corpora, preprocessed):
    """Every feature file, stats.json, speakers.json and the split: mel
    as ``assert_mel_close`` holds it, energy (normalised with the corpus
    statistics) within ENERGY_TOL, the rest equal."""
    from cmtts_tpu_torch.data.preprocessor import FEATURE_DIRS

    jpre, tpre = corpora["jax"] / "pre", corpora["port"] / "pre"
    assert preprocessed["port"] == preprocessed["jax"]
    train, val = preprocessed["port"]
    assert len(train) + len(val) == N_UTTS and len(val) == 2
    for name in ("train.txt", "val.txt", "filtered_out.txt",
                 "speakers.json"):
        assert (tpre / name).read_text() == (jpre / name).read_text(), name
    n_files = 0
    for kind in FEATURE_DIRS:
        names = sorted(os.listdir(jpre / kind))
        assert sorted(os.listdir(tpre / kind)) == names, kind
        for fn in names:
            a, b = np.load(tpre / kind / fn), np.load(jpre / kind / fn)
            assert a.shape == b.shape and a.dtype == b.dtype, fn
            if kind == "mel":
                assert_mel_close(a, b, fn)
            elif kind == "energy":
                np.testing.assert_allclose(a, b, **ENERGY_TOL, err_msg=fn)
            else:
                np.testing.assert_array_equal(a, b, err_msg=fn)
            n_files += 1
    assert n_files == 9 * N_UTTS
    with open(tpre / "stats.json") as f:
        st = json.load(f)
    with open(jpre / "stats.json") as f:
        sj = json.load(f)
    assert st.keys() == sj.keys() and st["max_seq_len"] == sj["max_seq_len"]
    assert st["f0"] == sj["f0"]
    np.testing.assert_allclose(st["energy"], sj["energy"], **ENERGY_TOL)
    for k in ("spec_min", "spec_max"):
        assert_mel_close(st[k], sj[k], k)


def test_alignment_and_cwt_match_jax(corpora):
    """get_alignment (MFA's empty silences kept as sp inside, trimmed at the
    ends) and get_f0cwt on the corpus's own TextGrids and f0."""
    from cmtts_tpu.data.preprocessor import Preprocessor as J
    from cmtts_tpu.data.textgrid import read_textgrid
    from cmtts_tpu_torch.data.preprocessor import Preprocessor as T

    jcfg, tcfg = _pre_cfgs(corpora["port"])
    jp, tp = J(jcfg), T(tcfg, device="cpu")
    tg_dir = corpora["port"] / "pre" / "TextGrid" / "LJSpeech"
    for p in sorted(tg_dir.iterdir())[:4]:
        ivs = read_textgrid(str(p))["phones"].intervals
        for a, b in zip(tp.get_alignment(ivs), jp.get_alignment(ivs)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    f0 = np.load(sorted((corpora["port"] / "pre" / "f0").iterdir())[0])
    for a, b in zip(tp.get_f0cwt(f0), jp.get_f0cwt(f0)):
        np.testing.assert_array_equal(a, b)


def test_preprocessor_needs_cuda_by_default(corpora, monkeypatch):
    import torch

    from cmtts_tpu_torch.data.preprocessor import Preprocessor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Preprocessor(_pre_cfgs(corpora["port"])[1])
