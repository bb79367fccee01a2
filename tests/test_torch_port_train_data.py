"""The port's data feed and host-side training helpers against the JAX
package's: batches from one seeded feature corpus (written once for the
module), the timestep samplers, the EMA/scale schedules, the host pitch
helpers and the key-value logger."""

import os

import numpy as np
import pytest

from torch_port_helpers import config_dicts, write_config


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A config root over a 14-utterance corpus (12 train, 2 val) of 10-60
    phonemes at 1-6 frames each, so that batches fall in several text and
    mel buckets."""
    from cmtts_tpu_torch.data.feature_corpus import write_feature_corpus

    tmp = tmp_path_factory.mktemp("corpus")
    root = write_config(tmp, "Tiny", config_dicts())
    write_feature_corpus(str(tmp / "pre"), 12, 2, seed=0, n_mels=16,
                         phonemes=(10, 60), frames=(1, 6))
    return root


def test_batches_identical_to_jax(corpus):
    """Two epochs of length-sorted bucketed batches (batch 2, group 4):
    every array, its dtype and the ids equal the JAX feed's."""
    from cmtts_tpu.core.config import load_configs as jload
    from cmtts_tpu.data.dataset import FeatureDataset as JDataset
    from cmtts_tpu.data.dataset import batch_iterator as jiter
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.data.dataset import FeatureDataset, batch_iterator

    jds = JDataset("train.txt", jload("Tiny", corpus))
    ds = FeatureDataset("train.txt", load_configs("Tiny", corpus))
    shapes = set()
    for jb, b in zip(jiter(jds, 2, 4, seed=7, epochs=2),
                     batch_iterator(ds, 2, 4, seed=7, epochs=2)):
        assert set(b) == set(jb) and set(b["p_targets"]) == set(
            jb["p_targets"])
        arrays = {k: v for k, v in b.items() if k != "p_targets"}
        arrays.update({f"p_targets/{k}": v for k, v in b["p_targets"].items()})
        for k, v in arrays.items():
            ref = jb[k] if "/" not in k else jb["p_targets"][k.split("/")[1]]
            if k in ("ids", "raw_texts"):
                assert v == ref
                continue
            assert v.dtype == ref.dtype, k
            np.testing.assert_array_equal(v, ref, err_msg=k)
        shapes.add((b["texts"].shape[1], b["mels"].shape[1]))
    assert len(shapes) > 1, shapes


def test_misaligned_utterance_raises(corpus, tmp_path):
    """A duration file out of step with the tokenized text fails loudly,
    naming the utterance."""
    import dataclasses
    import shutil

    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.data.dataset import FeatureDataset

    cfg = load_configs("Tiny", corpus)
    pre = tmp_path / "pre"
    shutil.copytree(cfg.data.preprocessed_path, pre)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, preprocessed_path=str(pre)))
    ds = FeatureDataset("train.txt", cfg)
    path = os.path.join(pre, "duration",
                        f"LJSpeech-duration-{ds.basename[3]}.npy")
    np.save(path, np.load(path)[:-1])
    with pytest.raises(ValueError, match=ds.basename[3]):
        ds[3]


def test_prefetch_iterator_errors_and_close():
    """The producer's exception reaches the consumer; closing the consumer
    early stops the producer thread."""
    import threading

    from cmtts_tpu_torch.data.dataset import prefetch_iterator

    def failing():
        yield 1
        raise RuntimeError("bad batch")

    with pytest.raises(RuntimeError, match="bad batch"):
        list(prefetch_iterator(failing))
    before = set(threading.enumerate())
    it = prefetch_iterator(lambda: iter(range(10 ** 6)))
    assert next(it) == 0
    it.close()
    assert not [t for t in threading.enumerate()
                if t not in before and t.is_alive()]


@pytest.mark.parametrize("name", ["uniform", "linear12", "linear21",
                                  "loss-second-moment"])
def test_schedule_samplers_match_jax(name):
    """The same sequence of per-sample loss updates (the LSM history warms
    up after 10 a term, then rolls): probs and state equal exactly."""
    from cmtts_tpu.train.resample import create_schedule_sampler as jmake
    from cmtts_tpu_torch.train.resample import create_schedule_sampler

    rs = np.random.RandomState(1)
    js, ts = jmake(name, 5), create_schedule_sampler(name, 5)
    assert ts.needs_update == js.needs_update
    for _ in range(30):
        idx, loss = rs.randint(0, 4, 8), rs.rand(8) * 3
        js.update(idx, loss)
        ts.update(idx, loss)
        np.testing.assert_array_equal(ts.probs(), js.probs())
    if hasattr(js, "state_dict"):
        for k, v in js.state_dict().items():
            np.testing.assert_array_equal(ts.state_dict()[k], v)
        assert (ts.probs() != ts.probs()[0]).any()


def test_lognormal_sampler_matches_jax():
    from cmtts_tpu.train.resample import LogNormalSampler as JLN
    from cmtts_tpu_torch.train.resample import LogNormalSampler

    ref = JLN(-1.0, 1.5).sample_sigmas(np.random.RandomState(3), 6)
    out = LogNormalSampler(-1.0, 1.5).sample_sigmas(np.random.RandomState(3),
                                                    6)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ema_mode,scale_mode", [
    ("fixed", "fixed"), ("fixed", "progressive"),
    ("adaptive", "progressive"), ("fixed", "progdist")])
def test_ema_and_scales_fn_matches_jax(ema_mode, scale_mode):
    from cmtts_tpu.train.ema import create_ema_and_scales_fn as jmake
    from cmtts_tpu_torch.train.ema import create_ema_and_scales_fn

    args = (ema_mode, 0.95, scale_mode, 64 if scale_mode == "progdist"
            else 2, 150, 1000, 10)
    jf, tf = jmake(*args), create_ema_and_scales_fn(*args)
    for step in list(range(0, 200, 7)) + [999, 1000, 5000]:
        assert tf(step) == jf(step), step


def test_host_pitch_helpers_match_jax():
    from cmtts_tpu.audio import pitch as jp
    from cmtts_tpu_torch.audio import pitch as tp
    from cmtts_tpu_torch.core.config import PitchConfig

    rs = np.random.RandomState(2)
    f0 = rs.uniform(80, 300, 50)
    f0[rs.rand(50) < 0.3] = 0.0
    f0[:3] = 0.0
    np.testing.assert_array_equal(tp.f0_to_coarse_np(f0.copy()),
                                  jp.f0_to_coarse_np(f0.copy()))
    for norm in ("log", "standard"):
        pc = PitchConfig(pitch_norm=norm, f0_mean=150.0, f0_std=40.0)
        for a, b in zip(tp.norm_interp_f0(f0, pc), jp.norm_interp_f0(f0, pc)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tp.convert_continuous_f0(f0),
                    jp.convert_continuous_f0(f0)):
        np.testing.assert_array_equal(a, b)


def test_kvlogger_matches_jax(tmp_path):
    """The copied logger writes the same progress.csv (a header widened
    when new keys appear) and stdout table."""
    from cmtts_tpu.train.kvlogger import KVLogger as JLogger
    from cmtts_tpu_torch.train.kvlogger import KVLogger

    rows = [{"step": 1, "loss": 2.5}, {"step": 2, "loss": 1.5, "C": 0.25}]
    for cls, d in ((JLogger, tmp_path / "j"), (KVLogger, tmp_path / "t")):
        log = cls(str(d), formats=["csv", "stdout"])
        for row in rows:
            for k, v in row.items():
                log.logkv_mean(k, v)
            log.dumpkvs()
        log.close()
    assert (tmp_path / "t" / "progress.csv").read_text() == \
        (tmp_path / "j" / "progress.csv").read_text()
