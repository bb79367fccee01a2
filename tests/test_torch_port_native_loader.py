"""The port's native npy loader (``cmtts_tpu_torch/native/featloader.cc``
built with g++ into ``build/``) against the JAX package's on the same
files: every dtype and a Fortran-ordered array round trip, a missing file
raises, the port's ``FeatureDataset.get_many`` (which loads through it,
CWT kinds included) equals ``__getitem__`` and the JAX dataset, the
native counter rises, a failed build warns once and falls back to
``np.load``, and ``prefetch_iterator`` keeps the order."""

import json
import os

import numpy as np
import pytest

from cmtts_tpu_torch.data import native_loader as nl


def _arrays():
    return [
        np.random.RandomState(0).randn(100, 80).astype(np.float32),
        np.arange(50, dtype=np.int32),
        np.random.RandomState(1).randn(7, 3, 2),
        np.asarray(3.25, dtype=np.float32).reshape(()),
        np.random.RandomState(2).randint(0, 9, (64,), dtype=np.int64),
        np.asarray([1, -2, 3], dtype=np.int16),
        np.arange(10, dtype=np.uint8),
        np.asfortranarray(np.random.RandomState(3).randn(5, 4)
                          .astype(np.float32)),
    ]


def test_roundtrip_matches_jax_loader(tmp_path):
    from cmtts_tpu.data.native_loader import NativeNpyLoader as JLoader
    from cmtts_tpu.data.native_loader import native_available as jok

    arrays = _arrays()
    paths = []
    for i, a in enumerate(arrays):
        paths.append(str(tmp_path / f"a{i}.npy"))
        np.save(paths[-1], a)
    before = nl.native_loads
    loader = nl.NativeNpyLoader(4)
    out = loader.load(paths)
    loader.close()
    assert nl.native_loads == before + len(paths)
    want = JLoader(4).load(paths) if jok() else [np.load(p) for p in paths]
    for a, b, w in zip(arrays, out, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert b.flags.f_contiguous == w.flags.f_contiguous
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, w)


def test_missing_file_raises(tmp_path):
    loader = nl.NativeNpyLoader(2)
    with pytest.raises(IOError):
        loader.load([str(tmp_path / "nope.npy")])
    loader.close()


def test_library_is_named_by_its_source_and_flags():
    path = nl.library_path()
    assert os.path.dirname(path) == nl._BUILD
    assert os.path.basename(path).startswith("libfeatloader-")
    assert nl.native_available() and os.path.exists(path)


def _corpus(root, n=3):
    rng = np.random.RandomState(0)
    lines = []
    for i in range(n):
        base, spk = f"utt{i}", "LJSpeech"
        T_mel, T_ph = 20 + i, 4
        feats = {
            "mel": rng.randn(T_mel, 8).astype(np.float32),
            "pitch": rng.randint(1, 255, T_mel).astype(np.int64),
            "f0": (rng.rand(T_mel) * 200).astype(np.float64),
            "energy": rng.rand(T_ph).astype(np.float32),
            "duration": np.full(T_ph, T_mel // T_ph, np.int64),
            "mel2ph": rng.randint(1, T_ph + 1, T_mel).astype(np.int64),
            "cwt_spec": rng.randn(T_mel, 10).astype(np.float32),
            "f0cwt_mean_std": np.asarray([5.0, 0.4]),
        }
        for kind, arr in feats.items():
            os.makedirs(root / kind, exist_ok=True)
            np.save(str(root / kind / f"{spk}-{kind}-{base}.npy"), arr)
        lines.append(f"{base}|{spk}|{{HH AH0 L OW1}}|hello")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    (root / "speakers.json").write_text(json.dumps({"LJSpeech": 0}))


def _datasets(root, pitch_type):
    """The port's and the JAX package's FeatureDataset over ``root`` (one
    config parsed by both packages; no RAM cache, so every call loads)."""
    from cmtts_tpu.data.dataset import FeatureDataset as JDataset
    from cmtts_tpu_torch.data.dataset import FeatureDataset
    from torch_port_helpers import config_dicts, configs_from

    p, m, t, stats = config_dicts(n_mels=8, pitch_type=pitch_type)
    p["path"] = {"preprocessed_path": str(root)}
    jcfg, cfg = configs_from((p, m, t, stats))
    return (FeatureDataset("train.txt", cfg, cache_in_ram=False),
            JDataset("train.txt", jcfg, cache_in_ram=False))


def _assert_samples_equal(got, want):
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("pitch_type", ["cwt", "frame"])
def test_dataset_get_many_matches_getitem_and_jax(tmp_path, pitch_type):
    """The bulk native load assembles the samples ``__getitem__`` (np.load)
    does and the JAX dataset's ``get_many`` does, the CWT kinds with
    ``pitch_type: cwt``, and loads through the library."""
    _corpus(tmp_path)
    ds, jds = _datasets(tmp_path, pitch_type)
    before = nl.native_loads
    bulk = ds.get_many([0, 1, 2])
    kinds = 8 if pitch_type == "cwt" else 6
    assert nl.native_loads == before + 3 * kinds
    assert ("cwt_spec" in bulk[0]) == (pitch_type == "cwt")
    for i, (b, w) in enumerate(zip(bulk, jds.get_many([0, 1, 2]))):
        _assert_samples_equal(b, ds[i])
        _assert_samples_equal(b, w)


def test_failed_build_warns_once_and_falls_back(tmp_path, monkeypatch,
                                                capsys):
    """A compiler that fails: one warning on stderr naming it, then
    ``get_many`` loads with np.load (same samples), the native counter
    unchanged, and ``NativeNpyLoader`` refuses."""
    _corpus(tmp_path)
    ds, _ = _datasets(tmp_path, "cwt")
    want = [ds[i] for i in range(3)]
    monkeypatch.setattr(nl, "_lib", None)
    monkeypatch.setattr(nl, "_lib_error", None)
    monkeypatch.setenv("CXX", "false")
    before = nl.native_loads
    got = ds.get_many([0, 1, 2]) + ds.get_many([2])
    err = capsys.readouterr().err
    assert err.count("native npy loader is unavailable") == 1
    assert "false failed" in err
    assert nl.native_loads == before
    for g, w in zip(got, want + [want[2]]):
        _assert_samples_equal(g, w)
    with pytest.raises(RuntimeError, match="unavailable"):
        nl.NativeNpyLoader()
    assert not os.path.exists(nl.library_path())


def test_prefetch_iterator_order():
    from cmtts_tpu_torch.data.dataset import prefetch_iterator

    assert list(prefetch_iterator(lambda: iter(range(10)), depth=3)) == \
        list(range(10))
