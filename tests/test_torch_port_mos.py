"""The port's MOS metric nets against the JAX package's: MBNet's MeanNet and
LDNet (both test configurations of tests/test_ldnet.py) against the flax
modules on the same params (through the bridge), ``MOSCal`` from
reference-format checkpoint files written by inverting the converters
against JAX's ``MOSCal`` on the same files, and ``mb_mos`` / ``ld_mos``
through the harness and ``cli.all_metrics``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_port_helpers import (
    LDNET_V2_FFN,
    LDNET_V3_RNN,
    flax_trees,
    ldnet_reference_state_dict,
    mbnet_reference_state_dict,
    seeded_module,
)

# float32 on both sides, convolutions and LSTMs summed in another order
NET_TOL = dict(rtol=1e-5, atol=1e-5)
CONFIGS = {
    "v3_rnn_meannet": LDNET_V3_RNN, "v2_ffn_categorical": LDNET_V2_FFN,
    # a dilated depthwise conv (pad 2 * 2, and its stride 3 dropped, as
    # mobilenetv3.py does under dilation)
    "v3_dilated": dict(LDNET_V3_RNN, encoder_bneck_configs=[
        *LDNET_V3_RNN["encoder_bneck_configs"][:3],
        [40, 5, 120, 40, True, "HS", 3, 2]]),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small convs: torch's thread pool only slows them under the
    suite's parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def bridged(make, seed):
    """(a fresh ``make()`` loaded through the bridge, flax variables) from
    the flax trees of a ``make()`` seeded with ``seed``."""
    from cmtts_tpu_torch.convert import load_flax_params

    params, stats = flax_trees(seeded_module(make(), seed))
    fresh = load_flax_params(make(), params, stats).eval()
    return fresh, {"params": params, "batch_stats": stats}


def mbnet_pair(seed=0):
    from cmtts_tpu_torch.metrics.mos import MBNetMeanNet

    return bridged(MBNetMeanNet, seed)


def ldnet_pair(config, seed=0):
    from cmtts_tpu_torch.metrics.ldnet import LDNet

    return bridged(lambda: LDNet(config), seed)


def test_mbnet_matches_flax():
    """Per-frame scores at 257 bins (the strided convs' XLA "SAME" pads:
    257 -> 86 -> 29 -> 10 -> 4 bins) and 13 frames."""
    from cmtts_tpu.metrics.mos import MBNetMeanNet as JMB

    port, variables = mbnet_pair()
    spec = np.random.RandomState(0).rand(2, 13, 257).astype(np.float32) * 3
    want = np.asarray(JMB().apply(variables, jnp.asarray(spec)))
    with torch.no_grad():
        got = port(torch.from_numpy(spec)).numpy()
    assert got.shape == (2, 13)
    np.testing.assert_allclose(got, want, **NET_TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ldnet_matches_flax(name):
    """forward (mean and listener scores), average_inference (scores and
    posteriors; the categorical head's softmax expectation) and
    mean_listener_inference where the config has a mean listener."""
    from cmtts_tpu.metrics.ldnet import LDNet as JLD

    config = CONFIGS[name]
    port, variables = ldnet_pair(config, seed=1)
    flax = JLD(config)
    rs = np.random.RandomState(1)
    spec = rs.rand(2, 9, 65).astype(np.float32) * 3
    judge = rs.randint(0, config["num_judges"], size=2)
    t_spec = torch.from_numpy(spec)
    with torch.no_grad():
        mean_t, ld_t = port(t_spec, torch.from_numpy(judge))
        avg_t, post_t = port.average_inference(t_spec)
    mean_j, ld_j = flax.apply(variables, spec, judge)
    avg_j, post_j = flax.apply(variables, spec, include_meanspk=False,
                               method=JLD.average_inference)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), **NET_TOL)
    np.testing.assert_allclose(avg_t.numpy(), np.asarray(avg_j), **NET_TOL)
    np.testing.assert_allclose(post_t.numpy(), np.asarray(post_j), **NET_TOL)
    if config["use_mean_net"]:
        np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j),
                                   **NET_TOL)
    else:
        assert mean_t is None and mean_j is None
    if config["use_mean_listener"]:
        with torch.no_grad():
            ml_t = port.mean_listener_inference(t_spec)
        ml_j = flax.apply(variables, spec,
                          method=JLD.mean_listener_inference)
        np.testing.assert_allclose(ml_t.numpy(), np.asarray(ml_j),
                                   **NET_TOL)


def test_bidirectional_lstm_bridge_round_trip():
    """flax -> port -> flax is exact for the bidirectional cells
    (``<name>_fwd`` / ``<name>_bwd``) and every other leaf."""
    import jax

    from cmtts_tpu_torch.convert import state_dict_to_flax

    port, variables = ldnet_pair(LDNET_V3_RNN, seed=2)
    back = state_dict_to_flax(port)
    flat = jax.tree_util.tree_leaves_with_path(variables["params"])
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf, err_msg=str(path))


def test_hamming_spectrum_is_jax_copy():
    from cmtts_tpu.metrics.mos import hamming_spectrum as jspec
    from cmtts_tpu_torch.metrics.mos import hamming_spectrum

    wav = np.random.RandomState(0).randn(22500).astype(np.float32) * 0.1
    np.testing.assert_array_equal(hamming_spectrum(wav), jspec(wav))


@pytest.fixture(scope="module")
def reference_files(tmp_path_factory):
    """(MBNet .pt, LDNet .pt, LDNet config.yml) in the reference's formats,
    from seeded modules."""
    root = tmp_path_factory.mktemp("mos")
    _, mb = mbnet_pair(seed=3)
    _, ld = ldnet_pair(LDNET_V3_RNN, seed=4)
    paths = (str(root / "model-50000.pt"), str(root / "model-27000.pt"),
             str(root / "config.yml"))
    torch.save(mbnet_reference_state_dict(mb["params"], mb["batch_stats"]),
               paths[0])
    torch.save(ldnet_reference_state_dict(ld["params"], ld["batch_stats"],
                                          LDNET_V3_RNN), paths[1])
    with open(paths[2], "w") as f:
        yaml.safe_dump(LDNET_V3_RNN, f)
    return paths


def test_moscal_from_reference_files_matches_jax(reference_files):
    """The port's MOSCal and the JAX package's read the same reference
    files and score the same waveform alike; without checkpoints both
    raise the same messages."""
    from cmtts_tpu.metrics.mos import MOSCal as JMOSCal
    from cmtts_tpu_torch.metrics.mos import MOSCal

    mb, ld, cfg = reference_files
    wav = np.random.RandomState(5).randn(22500).astype(np.float32) * 0.2
    port = MOSCal(mb_ckpt=mb, ld_ckpt=ld, ld_config=cfg, device="cpu")
    ref = JMOSCal(mb_ckpt=mb, ld_ckpt=ld, ld_config=cfg)
    for fn in ("get_mb_mos", "get_ld_mos"):
        np.testing.assert_allclose(getattr(port, fn)(wav),
                                   getattr(ref, fn)(wav), **NET_TOL)
    bare = MOSCal(device="cpu")
    with pytest.raises(RuntimeError, match="missing large blob"):
        bare.get_mb_mos(wav)
    with pytest.raises(RuntimeError, match="LDNet checkpoint unavailable"):
        bare.get_ld_mos(wav)


def test_harness_and_cli_mos(reference_files, tmp_path, capsys):
    """mb_mos, ld_mos and get_target_mos through the port's Cal against
    the JAX package's Cal on one results folder; ``cli.all_metrics
    --metrics mb_mos ld_mos`` prints the harness's values."""
    from cmtts_tpu.metrics import Cal as JCal
    from cmtts_tpu_torch.audio.wavio import write_wav
    from cmtts_tpu_torch.cli.all_metrics import main as all_metrics
    from cmtts_tpu_torch.metrics import Cal

    mb, ld, cfg = reference_files
    raw, syn = tmp_path / "raw", tmp_path / "syn"
    raw.mkdir()
    syn.mkdir()
    rs = np.random.RandomState(6)
    for i in range(2):
        write_wav(str(raw / f"utt{i}.wav"),
                  (rs.randn(22050) * 0.1).astype(np.float32), 22050)
        write_wav(str(syn / f"utt{i}.wav"),
                  (rs.randn(22050) * 0.1).astype(np.float32), 22050)
    kw = dict(data_type="LJSpeech", raw_folder=str(raw), mos_ckpt=mb,
              ld_ckpt=ld, ld_config=cfg)
    port = Cal(str(syn), device="cpu", **kw)
    ref = JCal(str(syn), **kw)
    got = port.get_metrics_by_list(["mb_mos", "ld_mos"])
    np.testing.assert_allclose(got, ref.get_metrics_by_list(
        ["mb_mos", "ld_mos"]), **NET_TOL)
    np.testing.assert_allclose(port.get_target_mos("ld"),
                               ref.get_target_mos("ld"), **NET_TOL)
    out = all_metrics(["--single", "--syn_root", str(syn), "--raw_folder",
                       str(raw), "--metrics", "mb_mos", "ld_mos",
                       "--mos_ckpt", mb, "--ld_ckpt", ld, "--ld_config", cfg,
                       "--device", "cpu"])
    np.testing.assert_allclose([out["mb_mos"], out["ld_mos"]], got,
                               rtol=1e-6)
    assert "mb_mos:" in capsys.readouterr().out
