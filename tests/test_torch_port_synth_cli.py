"""The rest of the port's synthesis surface on the CPU: the pinyin front-end
copy and ``--lang zh`` against the JAX package, the graph flags' precedence
of ``cli/synthesize.py:164-194``, ``--tag`` and ``--save_plots``, and the
zero-shot CLI's batch mode from a checkpoint."""

import itertools
import os
import sys

import numpy as np
import pytest

from torch_port_helpers import config_dicts, write_config


def test_pinyin_copy_matches_jax():
    """The cases ``tests/test_text.py`` checks, and every initial x final x
    tone syllable (with the y/w, u-umlaut and er-hua spellings) decomposes
    as in the JAX module."""
    from cmtts_tpu.text import pinyin as jp
    from cmtts_tpu.text.symbols import _PINYIN_FINALS, _PINYIN_INITIALS

    from cmtts_tpu_torch.text import pinyin as tp
    from cmtts_tpu_torch.text import text_to_sequence
    from cmtts_tpu_torch.text.symbols import symbol_to_id

    assert tp.syllable_to_phones("zhuang1") == ["zh", "uang1"]
    assert tp.syllable_to_phones("lüe4") == ["l", "ve4"]
    assert tp.syllable_to_phones("huar2") == ["h", "ua2", "rr"]
    assert tp.syllable_to_phones("xyzzy") is None
    phones = tp.preprocess_mandarin("ni3 hao3 shi4 jie4")
    assert phones == "{n i3 h ao3 sh iii4 j ie4}"
    assert len(text_to_sequence(phones, [])) == 8
    assert all("@" + p in symbol_to_id for p in phones.strip("{}").split())
    bases = {i + f for i, f in itertools.product(
        ("",) + tuple(_PINYIN_INITIALS), _PINYIN_FINALS)}
    bases |= {"yu", "yue", "yuan", "wo", "weng", "lv", "nve", "qu", "jun",
              "er", "zi", "chi", "ri", "huar", "cer", "yongr"}
    cases = [b + t for b in sorted(bases) for t in "12345"]
    assert [tp.syllable_to_phones(c) for c in cases] == [
        jp.syllable_to_phones(c) for c in cases]
    text = "ni3 hao3, shi4 jie4! xyzzy huar2 lüe4 ."
    assert tp.preprocess_mandarin(text) == jp.preprocess_mandarin(text)


def test_lang_zh_tokens_match_jax():
    from cmtts_tpu.text import text_to_sequence as jseq
    from cmtts_tpu.text.pinyin import preprocess_mandarin

    from cmtts_tpu_torch.cli.synthesize import tokenizer
    from cmtts_tpu_torch.core.config import config_from_dicts

    text = "ni3 hao3 shi4 jie4, zhong1 guo2 huar2"
    want = np.asarray(jseq(preprocess_mandarin(text), []), np.int32)
    got = tokenizer(config_from_dicts(*config_dicts()), "zh")(text)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


def jax_flags(cfg, run_cfg, model, masked, no_masked):
    """``cli/synthesize.py:164-194``'s resolution, as (training mode,
    cwt_masked_std)."""
    cwt = masked
    if not cwt and run_cfg.get("cwt_masked_std"):
        cwt = True
    if no_masked:
        cwt = False
    mode = model or run_cfg.get("training_mode") or cfg.train.cm.training_mode
    return mode, cwt or cfg.pitch.cwt_masked_std


@pytest.mark.parametrize("config_masked", [False, True])
def test_model_and_masked_std_precedence(config_masked, capsys):
    """Case by case: an explicit ``--model`` beats the run's record, which
    beats the config; ``--cwt_masked_std`` or the run's record turns the
    masked standardisation on.  ``--no_cwt_masked_std`` turns it off even
    where the config file turns it on, which the JAX code leaves on (its
    help promises to force the padded standardisation)."""
    from cmtts_tpu_torch.cli.synthesize import adopt_run_flags
    from cmtts_tpu_torch.core.config import config_from_dicts

    cfg = config_from_dicts(*config_dicts(cwt_masked_std=config_masked))
    runs = ({}, {"training_mode": "progdist"}, {"cwt_masked_std": True},
            {"training_mode": "edm", "cwt_masked_std": False})
    for run, model, masked, no_masked in itertools.product(
            runs, (None, "consistency_distillation", "edm"),
            (False, True), (False, True)):
        out = adopt_run_flags(cfg, run, model, masked, no_masked)
        mode, cwt = jax_flags(cfg, run, model, masked, no_masked)
        if config_masked and no_masked:
            cwt = False
        case = (run, model, masked, no_masked)
        assert out.train.cm.training_mode == mode, case
        assert out.pitch.cwt_masked_std == cwt, case
        assert cfg.train.cm.training_mode == "consistency_training"
    adopt_run_flags(cfg, {"cwt_masked_std": True})
    assert "adopting it" in capsys.readouterr().out


@pytest.fixture
def ckpt_root(tmp_path):
    """(config root, tmp dir): a tiny LJSpeech-like config with a 3-line
    val set and a committed checkpoint (step 2) of a random model whose run
    recorded the masked standardisation."""
    from cmtts_tpu_torch.cli.synthesize import random_cmtts
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.data.feature_corpus import write_feature_corpus
    from cmtts_tpu_torch.train.checkpoint import (
        save_checkpoint,
        write_run_config,
    )
    from cmtts_tpu_torch.train.state import RAdam, create_train_state

    def make(name, dicts):
        pre, model, _, stats = dicts
        train = {"path": {k: str(tmp_path / k) for k in
                          ("ckpt_path", "log_path", "result_path")}}
        root = write_config(tmp_path, name, (pre, model, train, stats))
        write_feature_corpus(str(tmp_path / "pre"), 2, 3, seed=0, n_mels=16,
                             phonemes=(5, 12), frames=(1, 4))
        cfg = load_configs(name, root)
        state = create_train_state(
            {k: v.detach() for k, v in random_cmtts(cfg).named_parameters()},
            RAdam(1e-4), len(cfg.train.cm.ema_rate))
        state.step = 2
        save_checkpoint(cfg.train.ckpt_path, state)
        write_run_config(cfg.train.ckpt_path,
                         {"training_mode": "consistency_training",
                          "cwt_masked_std": True})
        return root
    return make, tmp_path


def test_tag_and_save_plots(ckpt_root, tmp_path, monkeypatch, capsys):
    """``--tag`` names the result dir (from a checkpoint and without one),
    the run's masked standardisation is adopted, ``--save_plots`` writes a
    png per utterance and fails closed, with a message, without
    matplotlib; ``--lang zh`` runs."""
    from cmtts_tpu_torch.cli.synthesize import main

    make, tmp = ckpt_root
    root = make("Tiny", config_dicts())
    monkeypatch.chdir(tmp)
    base = ["--dataset", "Tiny", "--config_root", root, "--vocoder", "none",
            "--device", "cpu"]
    out = main(["--mode", "batch", "--source", str(tmp / "pre" / "val.txt"),
                "--restore_step", "2", "--tag", "ab", "--save_plots"] + base)
    assert out == os.path.join(str(tmp / "result_path") + "_cm",
                               "step_2_T1_ab")
    assert "adopting it" in capsys.readouterr().out
    names = sorted(os.listdir(out))
    assert len([n for n in names if n.endswith(".png")]) == 3
    assert len([n for n in names if n.endswith("-mel.npy")]) == 3
    out = main(["--mode", "single", "--lang", "zh", "--text",
                "ni3 hao3 shi4 jie4", "--tag", "zh"] + base)
    assert out == "output/result_torch_zh"
    assert np.load(tmp / out / "single-mel.npy").shape[1] == 16
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="needs matplotlib"):
        main(["--mode", "single", "--text", "hi", "--save_plots"] + base)


def test_zeroshot_batch_from_checkpoint(ckpt_root, capsys):
    """The zero-shot CLI in batch mode (batch size 1) from
    ``--restore_step``: the run's masked standardisation adopted,
    Griffin-Lim by default, the result dir ``step_{N}_T{T}_{tag}``, one
    wav and mel a metadata line; the embedding width is checked."""
    from cmtts_tpu_torch.cli.synthesize_zeroshot import main

    make, tmp = ckpt_root
    dicts = config_dicts(speaker_embedder="GE2E")
    dicts[1]["external_speaker_dim"] = 256
    root = make("TinyZS", dicts)
    os.makedirs(tmp / "pre" / "spker_embed")
    rs = np.random.RandomState(0)
    np.save(tmp / "pre" / "spker_embed" / "LJSpeech-spker_embed.npy",
            rs.randn(256).astype(np.float32))
    np.save(tmp / "emb.npy", rs.randn(256).astype(np.float32))
    base = ["--dataset", "TinyZS", "--config_root", root, "--device", "cpu",
            "--spker_embed", str(tmp / "emb.npy")]
    out = main(["--mode", "batch", "--source", str(tmp / "pre" / "val.txt"),
                "--restore_step", "0", "--T", "2"] + base)
    printed = capsys.readouterr().out
    assert "adopting" in printed and "Griffin-Lim" in printed
    assert printed.count("synthesized 1 ->") == 3
    assert out == os.path.join(str(tmp / "result_path") + "_cm",
                               "step_0_T2_zeroshot")
    with open(tmp / "pre" / "val.txt") as f:
        ids = [line.split("|")[0] for line in f]
    from cmtts_tpu_torch.audio.wavio import read_wav

    for name in ids:
        mel = np.load(os.path.join(out, f"{name}-mel.npy"))
        wav, _ = read_wav(os.path.join(out, f"{name}.wav"))
        assert mel.shape[1] == 16 and len(wav) == len(mel) * 256
    np.save(tmp / "bad.npy", np.zeros(8, np.float32))
    with pytest.raises(SystemExit, match="external_speaker_dim 256"):
        main(base[:-1] + [str(tmp / "bad.npy"), "--mode", "batch",
                          "--source", str(tmp / "pre" / "val.txt")])
