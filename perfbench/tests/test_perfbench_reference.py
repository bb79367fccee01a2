"""The plain reference agrees with the program at a tiny size on the CPU
when both compute in float32, on the same seeded weights; the control and
planted faults fail the committed limits."""

from __future__ import annotations

import pytest
import torch

from perfbench import compare
from perfbench.harness import find_cell, load_runner
from perfbench.reference.config import read_config
from perfbench.tests import tinybench
from perfbench.traffic import make_calls, make_voices


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tinybench.make(str(tmp_path_factory.mktemp("tb")))


SYNTH = ("lj_synth_b8", "vctk_zs_b1")


@pytest.mark.parametrize("cell", SYNTH)
def test_reference_matches_program_in_float32(bench, cell):
    from cmtts_tpu_torch.pipeline import Synthesizer

    w, config, traffic = find_cell(f"tiny_{cell}", bench)
    drv = load_runner(w, bench)
    c = read_config(config)
    seed = 2 ** 31 + 3
    prog = drv.build_program(config, seed, "cpu", {})
    s = prog["synth"]
    prog["synth"] = Synthesizer(s.cfg, s.model, s.vocoder, T=1,
                                text_buckets=s.text_buckets,
                                mel_buckets=s.mel_buckets,
                                compute_dtype=torch.float32, device="cpu")
    ref = drv.build_reference(config, seed, "cpu")
    calls = make_calls(traffic, seed)
    voices = (make_voices(traffic, seed, c.sampling_rate)
              if traffic.get("voices") else None)
    for call in calls:
        got, _ = drv.program_call(prog, call, voices)
        g = drv.gaps(ref, got, call, voices, c.sampling_rate, c.hop)
        assert g["len_mismatch"] == 0
        assert max(v for k, v in g.items() if k != "len_mismatch") < 1e-4, g


def test_weights_load_strictly_into_both(bench):
    """One state dict a module, every key of the program's modules."""
    w, config, _ = find_cell("tiny_vctk_zs_b1", bench)
    prog = load_runner(w, bench).build_program(config, 5, "cpu", {})
    assert prog["embedder"] is not None     # loaded with strict=True


def _limits(cell):
    return find_cell(cell)[0]["limits"]


@pytest.mark.parametrize("cell", tinybench.CELLS)
def test_control_fails_the_limits(bench, cell):
    """The reference one precision lower in the program's place."""
    from perfbench.calibrate import readings

    limits = _limits(cell)
    lines = readings(f"tiny_{cell}", 2 ** 31 + 11, True, "cpu", bench)
    control = [ln for ln in lines if ln["side"] == "control"][0]["numbers"]
    ok, _ = compare.judge([{k: v for k, v in control.items()
                            if k in limits}], limits)
    assert not ok, control


F32_STEP = """
import cmtts_tpu_torch.train.loop as L
_f = L.make_train_step
def _make(*a, **k):
    k["compute_dtype"] = None
    return _f(*a, **k)
L.make_train_step = _make
"""


@pytest.mark.parametrize("seed", [2 ** 31 + 13, 2 ** 33 + 5])
def test_training_reference_matches_program_in_float32(bench, seed):
    """The program's step in float32 against the plain reference: the
    same batches, losses and changes of the params, EMAs and target, from
    the seed and from the window's copied state."""
    rc, res, err = tinybench.run(bench, "tiny_lj_ct_b32", seed=seed,
                                 prelude=F32_STEP)
    assert rc == 0, err
    got = {k: v["value"] for k, v in res["compared"].items()}
    assert got["feed_mismatch"] == 0
    assert got["loss_gap"] < 1e-6 and got["change_gap"] < 1e-5, got


FAULTS = {
    # a row's waveform one sample late where the vocoder produces it
    "wav_shifted": """
import torch, cmtts_tpu_torch.pipeline as p
_f = p.hifigan_apply_fused
def _bad(*a, **k):
    w = _f(*a, **k)
    w[0] = torch.roll(w[0], 1)
    return w
p.hifigan_apply_fused = _bad
""",
    # the denoiser's answer for row 0 off by 10% where it is produced
    "mel_scaled": """
import cmtts_tpu_torch.models.denoiser as d
_f = d.Denoiser.forward
def _bad(self, *a, **k):
    out = _f(self, *a, **k)
    out[0] = out[0] * 0.9
    return out
d.Denoiser.forward = _bad
""",
    # a duration token one frame long where the conditioning makes it
    "duration_token": """
import cmtts_tpu_torch.models.variance as v
_f = v.VarianceAdaptor.forward
def _bad(self, *a, **k):
    out = _f(self, *a, **k)
    out["mel_lens"] = out["mel_lens"] + 1
    return out
v.VarianceAdaptor.forward = _bad
""",
}


TRAIN_FAULTS = {
    # a step that returns its state unchanged
    "state_unchanged": """
import cmtts_tpu_torch.train.loop as L
_f = L.make_train_step
def _make(*a, **k):
    step = _f(*a, **k)
    def bad(state, *b, **kw):
        return state, step(state, *b, **kw)[1]
    return bad
L.make_train_step = _make
""",
    # half of the batch left out, the mean taken over the rest
    "half_batch": """
import cmtts_tpu_torch.train.loop as L
_f = L.make_train_step
def _half(t, n):
    return {k: _half(v, n) for k, v in t.items()} if isinstance(t, dict) \
        else t[:n]
def _make(*a, **k):
    step = _f(*a, **k)
    def bad(state, batch, *b, **kw):
        return step(state, _half(batch, batch["mels"].shape[0] // 2), *b, **kw)
    return bad
L.make_train_step = _make
""",
    # the EMAs and the target network returned as they were
    "frozen_ema": """
import cmtts_tpu_torch.train.loop as L
_f = L.make_train_step
def _make(*a, **k):
    step = _f(*a, **k)
    def bad(state, *b, **kw):
        new, m = step(state, *b, **kw)
        new.ema_params, new.target_params = (state.ema_params,
                                             state.target_params)
        return new, m
    return bad
L.make_train_step = _make
""",
    # the same, only inside the window (after set-up's first calls)
    "frozen_ema_in_window": """
import cmtts_tpu_torch.train.loop as L
_f = L.make_train_step
def _make(*a, **k):
    step = _f(*a, **k)
    def bad(state, *b, **kw):
        new, m = step(state, *b, **kw)
        if state.step >= 4:
            new.ema_params, new.target_params = (state.ema_params,
                                                 state.target_params)
        return new, m
    return bad
L.make_train_step = _make
""",
    # a phoneme altered where the feed produces the batch
    "token": """
import cmtts_tpu_torch.data.dataset as D
_f = D.collate_batch
def _bad(*a, **k):
    out = _f(*a, **k)
    out["texts"][0, 0] = out["texts"][0, 0] % 83 + 64
    return out
D.collate_batch = _bad
""",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", SYNTH)
def test_planted_fault_is_not_correct(bench, cell, fault):
    rc, res, err = tinybench.run(bench, f"tiny_{cell}",
                                 prelude=FAULTS[fault])
    assert rc == 0, err
    assert res["correct"] is False, res["compared"]


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_planted_training_fault_is_not_correct(bench, fault):
    rc, res, err = tinybench.run(bench, "tiny_lj_ct_b32",
                                 prelude=TRAIN_FAULTS[fault])
    assert rc == 0, err
    assert res["correct"] is False, res["compared"]


@pytest.mark.parametrize("cell", tinybench.CELLS)
def test_sound_run_is_correct(bench, cell):
    rc, res, err = tinybench.run(bench, f"tiny_{cell}")
    assert rc == 0, err
    assert res["correct"] is True, res["compared"]
