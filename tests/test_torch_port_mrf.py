"""The port's MRF stage (its plain PyTorch version, which the kernel
wrappers run for CPU tensors) and HiFi-GAN against the JAX package: the
Pallas kernels in interpret mode at small shapes, the flax ResBlock stack
and HiFiGANGenerator at the others.  float32; tolerances as in
tests/test_mrf_pallas.py."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from cmtts_tpu.models.hifigan import ResBlock as FlaxResBlock
from cmtts_tpu.ops import mrf_pallas
from cmtts_tpu_torch.convert import load_flax_params
from cmtts_tpu_torch.models.hifigan import ResBlock
from cmtts_tpu_torch.ops import mrf

KS, DS = (3, 7, 11), (1, 3, 5)


class Stage(nn.Module):
    """One MRF stage (+ conv_post) named like the generator's params."""

    def __init__(self, C):
        super().__init__()
        self.cfg = types.SimpleNamespace(resblock_kernel_sizes=KS)
        for j, k in enumerate(KS):
            self.add_module(f"res_0_{j}", ResBlock(C, k, DS))
        self.conv_post = nn.Conv1d(C, 1, 7, padding=3)


def flax_stage(C, seed=0):
    rng = jax.random.PRNGKey(seed)
    params = {}
    for j, k in enumerate(KS):
        rng, sub = jax.random.split(rng)
        params[f"res_0_{j}"] = FlaxResBlock(C, k, DS).init(
            sub, jnp.zeros((1, 32, C)))["params"]
    rng, sub = jax.random.split(rng)
    params["conv_post"] = {
        "kernel": jax.random.normal(sub, (7, C, 1)) * 0.2,
        "bias": jnp.full((1,), 0.05)}
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, load_flax_params(Stage(C), params)


def flax_mrf(params, x):
    acc = None
    for j, k in enumerate(KS):
        h = FlaxResBlock(x.shape[-1], k, DS).apply(
            {"params": params[f"res_0_{j}"]}, x)
        acc = h if acc is None else acc + h
    return acc / len(KS)


def to_torch(x):  # (B, L, C) -> (B, C, L)
    return torch.from_numpy(np.asarray(x)).transpose(1, 2).contiguous()


@pytest.mark.parametrize("C,L,tile,head", [
    (32, 300, 128, False), (32, 300, 128, True),
    (32, 50, None, False), (32, 50, None, True)])
def test_fused_stage_matches_pallas_interpret(C, L, tile, head):
    params, stage = flax_stage(C)
    x = np.random.RandomState(0).randn(2, L, C).astype(np.float32) * 0.3
    post = mrf_pallas.pack_post_params(params, C) if head else None
    ref = mrf_pallas.fused_mrf_stage(
        jnp.asarray(x), mrf_pallas.pack_mrf_params(params, 0, C), tile=tile,
        interpret=True, post_params=post)
    out = mrf.fused_mrf_stage(
        to_torch(x), mrf.pack_mrf_params(stage, 0), KS, DS,
        post=mrf.pack_post_params(stage) if head else None)
    if not head:
        out = out.transpose(1, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)
    assert mrf.fused_mrf_stage.launches == 0  # CPU tensors: plain version


def test_fused_stage_matches_flax_resblocks():
    C, L = 128, 260
    params, stage = flax_stage(C, seed=1)
    x = np.random.RandomState(1).randn(2, L, C).astype(np.float32) * 0.3
    ref = flax_mrf(params, jnp.asarray(x))
    out = mrf.fused_mrf_stage(to_torch(x), mrf.pack_mrf_params(stage, 0))
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


def test_streamed_stage_matches_pallas_interpret():
    C, L = 256, 300
    params, stage = flax_stage(C, seed=2)
    x = np.random.RandomState(2).randn(2, L, C).astype(np.float32) * 0.3
    w, b = mrf_pallas.pack_mrf_params_streamed(params, 0, C,
                                               weight_dtype=jnp.float32)
    ref = mrf_pallas.fused_mrf_stage_streamed(
        jnp.asarray(x), w, b, tile=256, interpret=True,
        compute_dtype=jnp.float32, dot_dtype=jnp.float32)
    out = mrf.fused_mrf_stage_streamed(
        to_torch(x), mrf.pack_mrf_params(stage, 0), compute_dtype=torch.float32)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), np.asarray(ref),
                               rtol=5e-4, atol=5e-4)
    assert mrf.fused_mrf_stage_streamed.launches == 0


def test_plain_bf16_stays_near_f32():
    """The bf16 plain version (the reference the kernel is held to on the
    card) is within the JAX suite's bf16 tolerance of the f32 result."""
    C, L = 64, 200
    _, stage = flax_stage(C, seed=3)
    x = torch.from_numpy(
        np.random.RandomState(3).randn(1, C, L).astype(np.float32) * 0.3)
    ref = mrf.fused_mrf_stage(x, mrf.pack_mrf_params(stage, 0))
    out = mrf.fused_mrf_stage(x, mrf.pack_mrf_params(stage, 0, torch.bfloat16),
                              compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0.1, atol=0.05)


@pytest.fixture(scope="module")
def flax_generator():
    """A width-64 flax HiFiGANGenerator (16 mels) and its params."""
    from cmtts_tpu.models.hifigan import HiFiGANConfig, HiFiGANGenerator

    jgen = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=64,
                                          num_mels=16))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jgen.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)))["params"])
    return jgen, params


def port_generator(params):
    from cmtts_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator

    return load_flax_params(HiFiGANGenerator(HiFiGANConfig(
        upsample_initial_channel=64, num_mels=16)), params).eval()


def test_hifigan_matches_flax_generator(flax_generator):
    from cmtts_tpu_torch.models.hifigan import hifigan_apply_fused

    jgen, params = flax_generator
    mel = np.random.RandomState(0).randn(2, 24, 16).astype(np.float32)
    ref = np.asarray(jax.jit(jgen.apply)({"params": params}, jnp.asarray(mel)))
    gen = port_generator(params)
    with torch.no_grad():
        plain = gen(torch.from_numpy(mel))
    np.testing.assert_allclose(plain.numpy(), ref, rtol=2e-4, atol=2e-4)
    fused = hifigan_apply_fused(gen, torch.from_numpy(mel),
                                compute_dtype=torch.float32)
    np.testing.assert_allclose(fused.numpy(), ref, rtol=2e-4, atol=2e-4)
    fused_bf = hifigan_apply_fused(gen, torch.from_numpy(mel))
    np.testing.assert_allclose(fused_bf.numpy(), ref, rtol=0.1, atol=0.05)


def test_bridge_conv_transpose_matches_flax_same():
    """flax ConvTranspose 'SAME' == torch ConvTranspose1d(padding=(k-u)//2)
    after the bridge's transpose and tap flip, for both HiFi-GAN shapes."""
    import flax.linen as fnn

    for k, u in ((16, 8), (4, 2)):
        layer = fnn.ConvTranspose(6, (k,), strides=(u,), padding="SAME")
        x = np.random.RandomState(k).randn(2, 11, 5).astype(np.float32)
        params = jax.tree_util.tree_map(
            np.asarray,
            layer.init(jax.random.PRNGKey(k), jnp.asarray(x))["params"])
        ref = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
        holder = nn.Module()
        holder.up = nn.ConvTranspose1d(5, 6, k, stride=u, padding=(k - u) // 2)
        load_flax_params(holder, {"up": params})
        with torch.no_grad():
            out = holder.up(to_torch(x)).transpose(1, 2)
        assert out.shape == ref.shape == (2, 11 * u, 6)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_bridge_hifigan_strict_roundtrip(flax_generator):
    params = flax_generator[1]
    sd = port_generator(params).state_dict()
    assert (sum(v.size for v in jax.tree_util.tree_leaves(params))
            == sum(v.numel() for v in sd.values()))
    np.testing.assert_array_equal(
        sd["up_1.weight"].numpy(),
        np.transpose(params["up_1"]["kernel"][::-1], (1, 2, 0)))
    np.testing.assert_array_equal(
        sd["res_2_1.conv1_2.weight"].numpy(),
        np.transpose(params["res_2_1"]["conv1_2"]["kernel"], (2, 1, 0)))


def test_launch_rejects_malformed_inputs():
    """The kernel wrapper checks shapes and types before it hands pointers
    to the library (checked on CPU tensors: every case fails first)."""
    C, L = 16, 40
    _, stage = flax_stage(C, seed=5)
    w, b, _ = mrf.pack_mrf_params(stage, 0)
    x = torch.zeros(1, C, L)
    post = mrf.pack_post_params(stage)
    bad = [
        (x.double(), w, b, torch.float32, None),            # x not f32
        (x[:, :12], w[: 2 * 3 * 21 * 144], b[:216], torch.float32, None),
        (x, w[:-1], b, torch.float32, None),                 # short weights
        (x, w, b, torch.bfloat16, None),                     # w not bf16
        (x, w, b[:-1], torch.float32, None),                 # short biases
        (x, w, b.double(), torch.float32, None),
        (x, w, b, torch.float16, None),                      # no such kernel
        (x.transpose(1, 2).contiguous().transpose(1, 2), w, b, torch.float32,
         None),                                              # not contiguous
        (x, w, b, torch.float32, (post[0][:, :8], post[1])),  # head width
        (x, w, b, torch.float32, (post[0], post[1].double())),
    ]
    for xx, ww, bb, dt, pp in bad:
        with pytest.raises(ValueError):
            mrf._launch(xx, (ww, bb, None), KS, DS, dt, pp)
    # bf16: the wgmma kernel reads the weights as B tiles
    wb, _, wt = mrf.pack_mrf_params(stage, 0, torch.bfloat16)
    for tiles in (None, wt[:-1], wt.float(), wt.view(2, -1).t()):
        with pytest.raises(ValueError):
            mrf._launch(x, (wb, b, tiles), KS, DS, torch.bfloat16, None)
    with pytest.raises(ValueError):                          # C % 8
        mrf._launch(torch.zeros(1, 12, L), (wb[: 2 * 3 * 21 * 144],
                    b[:216], wt), KS, DS, torch.bfloat16, None)
