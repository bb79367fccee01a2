"""The port's image-domain consistency model against the JAX package's: the
ADM UNet (two configurations, with the zero-init ``out_conv``,
``proj_out`` and ``out_conv_f`` redrawn nonzero so that the attention and
each ResBlock's second conv are seen), the bridge's round trip, the
flax-like init, every sampler and the three editors on JAX's draws, one
CT and one CD step, the per-sample RNG, the reference ``.pt`` converter
and ``cli.image_sample`` on the CPU.  Sizes are tiny: 16 x 16 images, 32
channels, mult (1, 2), one res block, attention at ds 2."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmtts_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from torch_port_helpers import redraw_zero_layers, unet_reference_state_dict

# float32 on both sides, as tests/test_mrf_pallas.py:45-46
F32_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_RTOL = 1e-5
TRAIN_PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
B, S = 2, 16
BASE = dict(image_size=S, in_channels=3, model_channels=32, out_channels=3,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2))
CASES = {
    "legacy_2heads": dict(num_heads=2),
    "film_updown_classes": dict(num_head_channels=16,
                                use_scale_shift_norm=True,
                                resblock_updown=True, num_classes=10),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small ops: torch's thread pool only slows them under the
    suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pair:
    """One UNet configuration in both packages on the same weights."""

    def __init__(self, name):
        from cmtts_tpu.models.unet import ImageUNet as JU
        from cmtts_tpu.models.unet import UNetConfig as JC
        from cmtts_tpu_torch.models.unet import (
            ImageUNet,
            UNetConfig,
            init_like_flax,
        )

        kw = dict(BASE, **CASES[name])
        self.cfg = UNetConfig(**kw)
        self.unet = redraw_zero_layers(init_like_flax(
            ImageUNet(self.cfg), torch.Generator().manual_seed(0)), 1).eval()
        self.tree = state_dict_to_flax(self.unet)
        self.jparams = jax.tree_util.tree_map(jnp.asarray, self.tree)
        self.jmodel = JU(JC(**kw))
        self.japply = jax.jit(lambda p, x, t, y=None: self.jmodel.apply(
            {"params": p}, x, t, y))
        self.classes = self.cfg.num_classes

    def labels(self, n=B):
        return np.arange(n) % self.classes + 3 if self.classes else None


@functools.lru_cache(maxsize=None)
def _pair(name):
    return Pair(name)


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    return _pair(request.param)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_unet_matches_jax(pair):
    """One forward, NHWC after the transpose, with the zero-init layers
    redrawn nonzero (so the flax qkv layout at 2 heads is held)."""
    for name in ("out_conv_f", "middle__1.proj_out", "input_1_0.out_conv"):
        assert pair.unet.get_submodule(name).weight.abs().min() > 0
    rs = np.random.RandomState(0)
    x = rs.randn(B, S, S, 3).astype(np.float32)
    t = rs.uniform(-600, 1000, B).astype(np.float32)
    y = pair.labels()
    want = np.asarray(pair.japply(pair.jparams, jnp.asarray(x),
                                  jnp.asarray(t),
                                  None if y is None else jnp.asarray(y)))
    with torch.no_grad():
        got = pair.unet(nchw(x), torch.from_numpy(t),
                        None if y is None else torch.from_numpy(y))
    np.testing.assert_allclose(nhwc(got), want, **F32_TOL)


def test_unet_bridge_round_trip_is_bit_exact(pair):
    """flax -> torch -> flax gives back every leaf bit for bit, and every
    flax leaf (as ``jax.eval_shape`` of the flax init lists them) has a
    torch parameter."""
    sd = flax_to_state_dict(pair.tree, pair.unet)
    assert set(sd) == set(pair.unet.state_dict())
    back = state_dict_to_flax(pair.unet, dict(sd))
    flat = dict(jax.tree_util.tree_flatten_with_path(pair.tree)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for k in flat:
        np.testing.assert_array_equal(flat[k], flat_back[k])
    y0 = jnp.zeros((1,), jnp.int32) if pair.classes else None
    shapes = jax.eval_shape(pair.jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, S, S, 3)), jnp.zeros((1,)),
                            y0)["params"]
    shape_leaves = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    assert shape_leaves.keys() == flat.keys()
    for k, v in shape_leaves.items():
        assert v.shape == flat[k].shape, k


@pytest.mark.parametrize("widths", [
    dict(image_size=16, num_channels=32, num_res_blocks=1,
         channel_mult="1,2", attention_resolutions="8", class_cond=True,
         num_head_channels=16, use_scale_shift_norm=True,
         resblock_updown=True),
    dict(image_size=16, num_channels=32, num_res_blocks=2,
         channel_mult="1,2,2", attention_resolutions="8,4")])
def test_unet_flop_counts_what_torch_counts(widths):
    """``chip_smoke.py::unet_flop``, which the card's TFLOP/s divides by,
    equals torch's FLOP counter over one forward (convolutions, matmuls,
    attention) for the up/down ResBlocks and for the conv resamplers."""
    from torch.utils.flop_counter import FlopCounterMode

    import chip_smoke
    from cmtts_tpu_torch.models.unet import create_image_unet

    unet = create_image_unet(**widths).eval()
    y = torch.zeros(2, dtype=torch.long) if widths.get("class_cond") else None
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        unet(torch.zeros(2, 3, S, S), torch.ones(2), y)
    assert chip_smoke.unet_flop(unet.cfg, 2) == counter.get_total_flops()


def test_init_like_flax_matches_flax_init_of_unet_and_jcu():
    """A fresh UNet and JCU discriminator draw as flax does: zeros where
    flax has zeros (the three zero-init layers, biases), ones for the
    GroupNorm scales, and a standard deviation within 20% of flax's for
    every tensor of 256 or more entries (the class table's too)."""
    from cmtts_tpu.core.config import config_from_dicts as jcfg_from
    from cmtts_tpu.models.discriminator import JCUDiscriminator as JD
    from cmtts_tpu.models.unet import ImageUNet as JU
    from cmtts_tpu.models.unet import UNetConfig as JC
    from cmtts_tpu_torch.core.config import config_from_dicts, load_yaml_configs
    from cmtts_tpu_torch.models import discriminator, unet

    kw = dict(BASE, **CASES["film_updown_classes"])
    key = jax.random.PRNGKey(0)
    dicts = load_yaml_configs("LJSpeech")
    T = 32
    cases = [
        (jax.jit(JU(JC(**kw)).init)(key, jnp.zeros((1, S, S, 3)),
                                    jnp.zeros((1,)),
                                    jnp.zeros((1,), jnp.int32)),
         unet.ImageUNet(unet.UNetConfig(**kw)), unet.init_like_flax),
        (jax.jit(JD(jcfg_from(*dicts)).init)(
            key, jnp.zeros((1, T, 80)), jnp.zeros((1, T, 80)), None,
            jnp.zeros((1,), jnp.int32)),
         discriminator.JCUDiscriminator(config_from_dicts(*dicts)),
         discriminator.init_like_flax),
    ]
    for variables, model, init in cases:
        flax = jax.tree_util.tree_map(np.asarray, variables["params"])
        ref = flax_to_state_dict(flax, model)
        init(model, torch.Generator().manual_seed(1))
        name = type(model).__name__
        for k, v in model.named_parameters():
            r = ref[k]
            if not r.any():
                assert not v.any(), (name, k)
            elif (r == 1).all():
                assert (v == 1).all(), (name, k)
            elif r.numel() >= 256:
                ratio = float(v.detach().std() / r.std())
                assert 0.8 < ratio < 1.25, (name, k, ratio)


# -- sampling ------------------------------------------------------------------

SAMPLERS = {
    "onestep": dict(),
    "our_multistep": dict(ts=(0, 0, 1)),
    "multistep": dict(ts=(0, 2, 4), steps=5),
    "euler": dict(steps=3),
    "heun": dict(steps=3),
    "heun_churn": dict(sampler="heun", steps=3, s_churn=1.0),
    "dpm": dict(steps=3),
    "ancestral": dict(steps=3),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
@pytest.mark.parametrize("mode", ["consistency_distillation", "edm"])
def test_karras_sample_image_matches_jax(name, mode):
    """Every sampler family on the class-conditional UNet, on JAX's x_T
    and later draws, with the boundary (consistency) or plain EDM
    scalings; the image entry's clamps included."""
    from cmtts_tpu.cm.image import karras_sample_image as jsample
    from cmtts_tpu.cm.karras import KarrasSchedule as JS
    from cmtts_tpu_torch.cm.image import karras_sample_image
    from cmtts_tpu_torch.cm.karras import KarrasSchedule
    from torch_port_helpers import jax_draws

    pair = _pair("film_updown_classes")
    kw = dict(SAMPLERS[name])
    sampler = kw.pop("sampler", name)
    distill = mode.startswith("consistency")
    sched, jsched = KarrasSchedule(distillation=distill), JS(
        distillation=distill)
    y = pair.labels()
    want = np.asarray(jsample(
        pair.japply, pair.jparams, (B, S, S, 3), jax.random.PRNGKey(5),
        jsched, sampler=sampler, model_kwargs={"y": jnp.asarray(y)}, **kw))
    x_T, noise = jax_draws(5, (B, S, S, 3), sched.sigma_max, 6)
    got = karras_sample_image(
        pair.unet, (B, 3, S, S), sched, sampler=sampler,
        model_kwargs={"y": torch.from_numpy(y)},
        x_T=x_T.permute(0, 3, 1, 2),
        noise=[n.permute(0, 3, 1, 2) for n in noise], **kw)
    assert float(got.abs().max()) <= 1.0
    np.testing.assert_allclose(nhwc(got), want, **F32_TOL)


def test_to_uint8_is_nhwc():
    from cmtts_tpu.cm.image import to_uint8 as jto
    from cmtts_tpu_torch.cm.image import to_uint8

    x = np.random.RandomState(0).uniform(-1.1, 1.1, (2, 5, 4, 3)).astype(
        np.float32)
    got = to_uint8(nchw(x))
    assert got.dtype == np.uint8 and got.shape == (2, 5, 4, 3)
    np.testing.assert_array_equal(got, jto(jnp.asarray(x)))


# -- editing -------------------------------------------------------------------

def _edit_draws(seed, n, shape):
    """The renoise draws of the JAX editors' loop from PRNGKey(seed)."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        out.append(nchw(jax.random.normal(sub, shape, jnp.float32)))
    return out


@pytest.mark.parametrize("editor", ["colorization", "inpainting",
                                    "superres"])
def test_editors_match_jax(editor):
    """The three editors on the same images, start point, JAX's renoise
    draws and an explicit mask, ts (0, 2, 4) of 5 steps: the last sigma is
    sigma_min, so the output satisfies its measurement exactly."""
    import cmtts_tpu.cm.image as jimage
    import cmtts_tpu_torch.cm.image as image
    from cmtts_tpu.cm.image import make_image_denoise_fn as jdenoise
    from cmtts_tpu.cm.karras import KarrasSchedule as JS
    from cmtts_tpu_torch.cm.karras import KarrasSchedule

    pair = _pair("legacy_2heads")
    sched, jsched = KarrasSchedule(), JS()
    ts, steps = (0, 2, 4), 5
    rs = np.random.RandomState(3)
    images = rs.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    x = (images + rs.randn(B, S, S, 3) * 2.0).astype(np.float32)
    extra, jextra = {}, {}
    if editor == "inpainting":
        mask = (rs.rand(S, S) > 0.5).astype(np.float32)
        extra, jextra = dict(mask=mask), dict(mask=jnp.asarray(mask))
    elif editor == "superres":
        extra = jextra = dict(patch_size=4)
    jfn = getattr(jimage, f"iterative_{editor}")
    fn = getattr(image, f"iterative_{editor}")
    want, want_meas = jfn(jdenoise(pair.japply, pair.jparams, jsched),
                          jnp.asarray(images), jnp.asarray(x), ts, jsched,
                          jax.random.PRNGKey(9), steps=steps, **jextra)
    got, meas = fn(image.make_image_denoise_fn(pair.unet, sched),
                   nchw(images), nchw(x), ts, sched, steps=steps,
                   noise=_edit_draws(9, len(ts) - 1, (B, S, S, 3)), **extra)
    np.testing.assert_allclose(nhwc(meas), np.asarray(want_meas), atol=1e-6)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **F32_TOL)
    # the projection keeps the measured component of the output
    replaced = {"colorization": lambda z: torch.einsum(
        "bchw,c->bhw", z, torch.as_tensor(
            image._gray_orthogonal_matrix()[:, 0], dtype=torch.float32)),
        "inpainting": lambda z: z * (meas != -1).float(),
        "superres": lambda z: image._to_patches(z, 4).mean(-1)}[editor]
    torch.testing.assert_close(replaced(got), replaced(meas), rtol=0,
                               atol=1e-5)


def test_letter_mask_and_bases_equal_jax():
    import cmtts_tpu.cm.image as jimage
    import cmtts_tpu_torch.cm.image as image

    np.testing.assert_array_equal(image._gray_orthogonal_matrix(),
                                  jimage._gray_orthogonal_matrix())
    for p in (2, 4, 8):
        np.testing.assert_array_equal(image._patch_orthogonal_matrix(p),
                                      jimage._patch_orthogonal_matrix(p))
    for kw in (dict(), dict(font_size=40, xy=(12, 4), letter="A")):
        want = jimage.letter_mask(64, **kw)
        got = image.letter_mask(64, **kw)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    x = torch.arange(2 * 3 * 8 * 8, dtype=torch.float32).reshape(2, 3, 8, 8)
    np.testing.assert_array_equal(
        image._to_patches(x, 4).numpy(),
        np.asarray(jimage._to_patches(jnp.asarray(nhwc(x)), 4)))
    torch.testing.assert_close(
        image._from_patches(image._to_patches(x, 4), 4, 8, 8), x)


# -- training ------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["ct", "cd"])
def test_image_train_step_matches_jax(mode):
    """One CT step (Euler toward t2 from the data, l2) of the
    class-conditional UNet and one CD step (Heun with a frozen teacher, l1,
    karras weights) of the unconditional one against
    ``make_image_train_step`` with ``optax.radam``, on JAX's indices and
    noise: the loss, the gradient norm, and the params, EMA and target
    after the update.  (The JAX package's CD teacher takes no labels, so
    its CD step fails for a class-conditional model.)"""
    import optax

    from cmtts_tpu.cm.image_train import make_image_train_step as jmake
    from cmtts_tpu.cm.karras import KarrasSchedule as JS
    from cmtts_tpu.train.state import create_train_state as jcreate
    from cmtts_tpu_torch.cm.image_train import make_image_train_step
    from cmtts_tpu_torch.cm.karras import KarrasSchedule
    from cmtts_tpu_torch.train.state import RAdam, create_train_state

    pair = _pair("film_updown_classes" if mode == "ct" else "legacy_2heads")
    cond = mode == "ct"
    lr, scales, target_ema = 1e-3, 4, 0.9
    kw = (dict(loss_norm="l2", weight_schedule="uniform") if mode == "ct"
          else dict(loss_norm="l1", weight_schedule="karras"))
    teacher = None
    if mode == "cd":
        g = torch.Generator().manual_seed(7)
        teacher = {k: v.detach() + 0.01 * torch.randn(v.shape, generator=g)
                   for k, v in pair.unet.named_parameters()}
    rs = np.random.RandomState(11)
    images = rs.uniform(-1, 1, (4, S, S, 3)).astype(np.float32)
    labels = np.asarray([1, 4, 7, 9])
    jbatch = {"images": jnp.asarray(images)}
    batch = {"images": nchw(images)}
    if cond:
        jbatch["labels"] = jnp.asarray(labels)
        batch["labels"] = torch.from_numpy(labels)

    jstep = jmake(pair.jmodel, JS(), scales, optax.radam(lr),
                  ema_rates=(0.99,), class_cond=cond, donate=False,
                  teacher_params=None if teacher is None else
                  jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(
                      pair.unet, teacher)), **kw)
    jstate = jcreate(pair.jparams, optax.radam(lr), n_ema=1)
    key = jax.random.PRNGKey(2)
    jstate, jm = jstep(jstate, jbatch, key, jnp.asarray(target_ema))
    k_idx, k_noise = jax.random.split(key)
    indices = np.array(jax.random.randint(k_idx, (4,), 0, scales - 1))
    noise = nchw(jax.random.normal(k_noise, images.shape, jnp.float32))

    opt = RAdam(lr)
    state = create_train_state(dict(pair.unet.named_parameters()), opt, 1)
    step = make_image_train_step(pair.unet, KarrasSchedule(), scales, opt,
                                 ema_rates=(0.99,), class_cond=cond,
                                 teacher_params=teacher, **kw)
    state, m = step(state, batch, target_ema,
                    indices=torch.from_numpy(indices), noise=noise)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    for got, want in ((state.params, jstate.params),
                      (state.ema_params[0], jstate.ema_params[0]),
                      (state.target_params, jstate.target_params)):
        ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, want),
                                 pair.unet)
        for k, v in got.items():
            np.testing.assert_allclose(v.detach().numpy(), ref[k].numpy(),
                                       err_msg=k, **TRAIN_PARAM_TOL)
    assert state.step == 1


def test_image_train_step_draws_from_its_generator():
    """Without injected draws the step takes its indices and noise from
    the generator: the same seed gives the same step, and the loss is
    finite."""
    from cmtts_tpu_torch.cm.image_train import make_image_train_step
    from cmtts_tpu_torch.cm.karras import KarrasSchedule
    from cmtts_tpu_torch.train.state import RAdam, create_train_state

    pair = _pair("legacy_2heads")
    opt = RAdam(1e-3)
    state = create_train_state(dict(pair.unet.named_parameters()), opt, 1)
    step = make_image_train_step(pair.unet, KarrasSchedule(), 3, opt)
    batch = {"images": torch.rand(2, 3, S, S) * 2 - 1}
    out = [step(state, batch, 0.95, torch.Generator().manual_seed(4))
           for _ in range(2)]
    assert np.isfinite(float(out[0][1]["loss"]))
    for k in state.params:
        torch.testing.assert_close(out[0][0].params[k], out[1][0].params[k],
                                   rtol=0, atol=0)
    with pytest.raises(ValueError):
        step(state, batch, 0.95)


# -- per-sample RNG --------------------------------------------------------------

def test_rng_batch_size_invariance():
    from cmtts_tpu_torch.core.rng import DeterministicGenerator

    full = DeterministicGenerator(seed=42).randn(8, 4, 3)
    g2 = DeterministicGenerator(seed=42)
    parts = []
    for start in (0, 3, 6):
        g2.set_offset(start)
        parts.append(g2.randn(min(3, 8 - start), 4, 3))
    torch.testing.assert_close(torch.cat(parts), full, rtol=0, atol=0)
    g3 = DeterministicGenerator(seed=42)
    g3.randint(0, 10, (3,))
    g3.advance(3)
    torch.testing.assert_close(g3.randint(0, 1000, (5, 2)),
                               DeterministicGenerator(seed=42).randint(
                                   0, 1000, (8, 2))[3:], rtol=0, atol=0)


def test_rng_world_size_invariance():
    """1 host with batch 4 == 2 "hosts" with batch 2 interleaved."""
    from cmtts_tpu_torch.core.rng import DeterministicGenerator

    full = DeterministicGenerator(seed=7, rank=0, world_size=1).randn(4, 5)
    a = DeterministicGenerator(seed=7, rank=0, world_size=2).randn(2, 5)
    b = DeterministicGenerator(seed=7, rank=1, world_size=2).randn(2, 5)
    for got, want in ((a[0], full[0]), (b[0], full[1]), (a[1], full[2]),
                      (b[1], full[3])):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    r1 = DeterministicGenerator(seed=7, rank=1, world_size=2)
    r1.advance(2)
    torch.testing.assert_close(
        r1.randn(1, 5)[0],
        DeterministicGenerator(seed=7).randn(6, 5)[5], rtol=0, atol=0)


def test_rng_factory_and_dummy():
    from cmtts_tpu_torch.core.rng import (
        DeterministicGenerator,
        DummyGenerator,
        get_generator,
    )

    g = get_generator("dummy", seed=1)
    assert isinstance(g, DummyGenerator)
    x, y = g.randn(2, 3), g.randn(2, 3)
    assert x.shape == (2, 3) and not torch.equal(x, y)
    assert g.randint(0, 5, (4,)).shape == (4,)
    for name in ("determ", "determ-indiv"):
        assert isinstance(get_generator(name, seed=42),
                          DeterministicGenerator)
    d = DeterministicGenerator(seed=3)
    # neighbouring samples draw unrelated streams
    s = d.randn(2, 1000)
    assert abs(float(torch.corrcoef(s)[0, 1])) < 0.1
    with pytest.raises(NotImplementedError):
        get_generator("bogus")


# -- the reference .pt and the CLI --------------------------------------------------

def test_reference_pt_loads_equal_to_jax_converter(tmp_path):
    """A reference-format UNet state dict (``convert_torch_unet``
    inverted) converts to the same flax tree through the port's numpy copy
    as through the JAX package's converter, and ``cli.image_sample``'s
    loader puts exactly those weights into the port's UNet."""
    from cmtts_tpu.models.unet import convert_torch_unet as jconvert
    from cmtts_tpu_torch.cli.image_sample import load_unet_params
    from cmtts_tpu_torch.models.unet import ImageUNet, convert_torch_unet

    pair = _pair("film_updown_classes")
    sd = unet_reference_state_dict(pair.tree)
    assert "input_blocks.3.1.qkv.weight" in sd and \
        sd["input_blocks.3.1.qkv.weight"].ndim == 3
    np_sd = {k: v.numpy() for k, v in sd.items()}
    mine, theirs = convert_torch_unet(np_sd, pair.cfg), jconvert(np_sd, None)
    flat = dict(jax.tree_util.tree_flatten_with_path(mine)[0])
    jflat = dict(jax.tree_util.tree_flatten_with_path(theirs)[0])
    orig = dict(jax.tree_util.tree_flatten_with_path(pair.tree)[0])
    assert flat.keys() == jflat.keys() == orig.keys()
    for k in flat:
        np.testing.assert_array_equal(flat[k], jflat[k])
        np.testing.assert_array_equal(flat[k], orig[k])
    torch.save({"state_dict": sd}, tmp_path / "model.pt")
    loaded = load_unet_params(str(tmp_path / "model.pt"),
                              ImageUNet(pair.cfg), 0)
    for k, v in pair.unet.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)


def test_image_sample_cli_end_to_end(tmp_path):
    """``cli.image_sample --device cpu`` with a random-init UNet writes the
    JAX CLI's file: ``samples_2x64x64x3.npz`` of uint8 NHWC images."""
    from cmtts_tpu_torch.cli.image_sample import main

    out = tmp_path / "samples"
    with pytest.warns(UserWarning, match="random-init"):
        main(["--image_size", "64", "--num_channels", "32",
              "--num_res_blocks", "1", "--attention_resolutions", "32",
              "--num_samples", "2", "--batch_size", "2", "--sampler",
              "onestep", "--training_mode", "consistency_training",
              "--use_fp16", "False", "--device", "cpu",
              "--out_dir", str(out)])
    files = list(out.glob("samples_*.npz"))
    assert [f.name for f in files] == ["samples_2x64x64x3.npz"]
    with np.load(files[0]) as f:
        assert f.files == ["arr_0"]
        arr = f["arr_0"]
    assert arr.shape == (2, 64, 64, 3) and arr.dtype == np.uint8


def test_image_sample_cli_npz_and_pt_agree(tmp_path):
    """Class-conditional multistep sampling from a flat flax ``.npz`` and
    from a reference ``.pt`` of the same weights: the same images and
    labels (a second array), 5 samples in batches of 2."""
    from cmtts_tpu_torch.cli.image_sample import main
    from cmtts_tpu_torch.models.unet import create_image_unet, init_like_flax
    from torch_port_helpers import save_flat_npz

    unet = redraw_zero_layers(init_like_flax(create_image_unet(
        16, 32, 1, channel_mult="1,2", class_cond=True,
        attention_resolutions="8", num_head_channels=16,
        use_scale_shift_norm=True, resblock_updown=True),
        torch.Generator().manual_seed(0)), 2)
    tree = state_dict_to_flax(unet)
    save_flat_npz(tmp_path / "w.npz", tree)
    torch.save(unet_reference_state_dict(tree), tmp_path / "w.pt")
    outs = []
    for src in ("w.npz", "w.pt"):
        path = main(["--image_size", "16", "--num_channels", "32",
                     "--num_res_blocks", "1", "--channel_mult", "1,2",
                     "--attention_resolutions", "8", "--num_head_channels",
                     "16", "--resblock_updown", "True", "--class_cond",
                     "True", "--training_mode", "consistency_distillation",
                     "--sampler", "multistep", "--ts", "0,2,4", "--steps",
                     "5", "--num_samples", "5", "--batch_size", "2",
                     "--model_path", str(tmp_path / src), "--device", "cpu",
                     "--out_dir", str(tmp_path / src[2:])])
        with np.load(path) as f:
            outs.append((f["arr_0"], f["arr_1"]))
    (a, la), (b, lb) = outs
    assert a.shape == (5, 16, 16, 3) and a.dtype == np.uint8
    assert la.shape == (5,) and la.max() < 1000
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    assert len(np.unique(a.reshape(5, -1), axis=0)) == 5
