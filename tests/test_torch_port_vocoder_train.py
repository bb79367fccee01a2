"""The port's HiFi-GAN trainer against the JAX package's: the discriminators
(``WNConv`` with XLA's "SAME" padding, every sub-discriminator, the LSGAN
losses), the batched log-mel, AdamW and Adam against optax, one and three
unpaired steps and one paired step of the fused D-then-G update from the
same flax-init weights and crops (through the param bridge), the crop
samplers, the generator export read by both packages, the bridge's round
trip, and the CLI on the CPU.  Sizes are the JAX suite's
(``tests/test_hifigan_train.py``): a width-32 generator, the tiny
discriminators, B=2 and 2048-sample crops."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from cmtts_tpu.models.hifigan import HiFiGANConfig as JGenConfig
from cmtts_tpu.models.hifigan_disc import HiFiGANDiscConfig as JDiscConfig
from cmtts_tpu_torch.convert import flax_to_state_dict, load_flax_params
from cmtts_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from cmtts_tpu_torch.models.hifigan_disc import (
    HiFiGANDiscConfig,
    HiFiGANDiscriminators,
)
from torch_port_helpers import assert_adam_params_close, formant_corpus

TINY_DISC = dict(periods=(2, 3), mpd_channels=(4, 8),
                 msd_channels=(8, 8, 8), msd_groups=(1, 4, 1),
                 msd_kernels=(15, 41, 5), msd_strides=(1, 2, 1), n_scales=2)
WIDTH, SEGMENT, B = 32, 2048, 2
LR = 2e-4

# float32 on both sides: the losses to the JAX suite's f32 tolerance; the
# first step's AdamW moments (0.2 x the gradient and 0.01 x its square)
# to 2e-3 of each entry or 1e-5 of the tensor's largest (a gradient entry
# is a sum over the whole batch, rounded in another order); params after
# AdamW steps in terms of lr (torch_port_helpers.assert_adam_params_close)
METRIC_TOL = dict(rtol=2e-4, atol=2e-4)
MOMENT_RTOL, MOMENT_ATOL = 2e-3, 1e-5
OPT_TOL = dict(rtol=1e-6, atol=1e-7)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _torch(tree, model):
    return {k: v.numpy() for k, v in flax_to_state_dict(tree, model).items()}


def random_tree(init, rs, *args, **kwargs):
    """A flax module's param tree (from ``jax.eval_shape`` of its
    ``init``, nothing compiled) with normal(0, 0.2) float32 values."""
    shapes = jax.eval_shape(init, *args, **kwargs)["params"]
    return jax.tree_util.tree_map(
        lambda a: np.asarray(rs.randn(*a.shape) * 0.2, np.float32), shapes)


def _wavs(seed, n=B, length=SEGMENT):
    rs = np.random.RandomState(seed)
    t = np.arange(length) / 22050.0
    f0 = rs.uniform(100, 300, (n, 1))
    return np.asarray(0.5 * np.sin(2 * np.pi * f0 * t)
                      + 0.05 * rs.randn(n, length), np.float32)


def tiny_modules(seed=0):
    """The port's tiny generator and discriminators, drawn as flax draws
    them, and their params as the flax trees (through the bridge's
    inverse) that the JAX side takes."""
    from cmtts_tpu_torch.convert import state_dict_to_flax
    from cmtts_tpu_torch.models import hifigan, hifigan_disc

    g = torch.Generator().manual_seed(seed)
    gen = hifigan.init_like_flax(HiFiGANGenerator(HiFiGANConfig(
        upsample_initial_channel=WIDTH)), g)
    disc = hifigan_disc.init_like_flax(
        HiFiGANDiscriminators(HiFiGANDiscConfig(**TINY_DISC)), g)
    return gen, disc, state_dict_to_flax(gen), state_dict_to_flax(disc)


class Pair:
    """Both packages' tiny trainers on the same weights."""

    def __init__(self):
        from cmtts_tpu.audio.stft import MelSpectrogram as JMel
        from cmtts_tpu.models.hifigan import HiFiGANGenerator as JG
        from cmtts_tpu.models.hifigan_disc import HiFiGANDiscriminators as JD
        from cmtts_tpu.train.hifigan_trainer import (
            HiFiGANTrainConfig as JCfg,
            _make_optims,
            make_hifigan_train_step as jmake,
        )
        from cmtts_tpu_torch.audio.stft import MelSpectrogram
        from cmtts_tpu_torch.train.hifigan_trainer import (
            HiFiGANTrainConfig,
            make_hifigan_train_step,
            make_optims,
        )

        self.gen, self.disc, gp, dp = tiny_modules()
        self.init = {"gen": gp, "disc": dp}
        jcfg = JCfg(segment_size=SEGMENT, batch_size=B)
        jgen = JG(JGenConfig(upsample_initial_channel=WIDTH))
        jdisc = JD(JDiscConfig(**TINY_DISC))
        jgp = jax.tree_util.tree_map(jnp.asarray, gp)
        jdp = jax.tree_util.tree_map(jnp.asarray, dp)
        jtx_g, jtx_d = _make_optims(jcfg)
        self.jstate = {"gen": jgp, "disc": jdp, "opt_g": jtx_g.init(jgp),
                       "opt_d": jtx_d.init(jdp),
                       "step": jnp.zeros((), jnp.int32)}
        self.jsteps = {p: jmake(jgen, jdisc, JMel(), jcfg, paired=p)
                       for p in (False, True)}
        cfg = HiFiGANTrainConfig(segment_size=SEGMENT, batch_size=B)
        stft = MelSpectrogram(device="cpu")
        self.steps = {p: make_hifigan_train_step(self.gen, self.disc, stft,
                                                 cfg, paired=p)
                      for p in (False, True)}
        gp = {k: v.detach() for k, v in self.gen.named_parameters()}
        dp = {k: v.detach() for k, v in self.disc.named_parameters()}
        tx_g, tx_d = make_optims(cfg)
        self.tstate = {"gen": gp, "disc": dp, "opt_g": tx_g.init(gp),
                       "opt_d": tx_d.init(dp), "step": 0}

    def run(self, batches, paired=False):
        """Both sides through ``batches``: -> [(JAX state, JAX metrics,
        port state, port metrics)] after each step, as numpy."""
        js = jax.tree_util.tree_map(jnp.array, self.jstate)  # donated
        ts, out = self.tstate, []
        for wavs, mels in batches:
            args = (jnp.asarray(wavs),) + ((jnp.asarray(mels),)
                                           if paired else ())
            js, jm = self.jsteps[paired](js, *args)
            targs = (torch.from_numpy(wavs),) + (
                (torch.from_numpy(mels),) if paired else ())
            ts, tm = self.steps[paired](ts, *targs)
            out.append((_np(js), {k: float(v) for k, v in jm.items()},
                        ts, {k: float(v) for k, v in tm.items()}))
        return out

    def module(self, which):
        return self.gen if which == "gen" else self.disc



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: its CPU work is many small
    ops in sequence (an LSTM's 160 steps, a GAN step's convolutions), which
    torch's thread pool slows to a crawl when the suite's parallel workers
    already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def unpaired(pair):
    return pair.run([(_wavs(i), None) for i in range(3)])


def _check_state(pair, jstate, tstate, n_steps, moments=True):
    for which in ("gen", "disc"):
        model = pair.module(which)
        jp = _torch(jstate[which], model)
        for k, v in tstate[which].items():
            assert_adam_params_close(jp[k], v.numpy(), LR, n_steps,
                                     f"{which} {k}")
        if not moments:
            continue
        opt = f"opt_{which[0]}"
        adam = jstate[opt][0]
        assert int(adam.count) == tstate[opt]["count"] == n_steps
        for name in ("mu", "nu"):
            ref = _torch(getattr(adam, name), model)
            for k, v in tstate[opt][name].items():
                np.testing.assert_allclose(
                    v.numpy(), ref[k], rtol=MOMENT_RTOL,
                    atol=MOMENT_ATOL * np.abs(ref[k]).max(),
                    err_msg=f"{which} {name} {k}")


def test_wnconv_matches_jax_and_pads_as_xla():
    """WNConv at strides 1, 3 and 4, grouped, 1-D and 2-D, on odd lengths,
    against the flax WNConv with the same v, g and bias; a symmetric pad
    (torch's own padding) is off by a sample at each of these strides >
    1."""
    from cmtts_tpu.models.hifigan_disc import WNConv as JWNConv
    from cmtts_tpu_torch.models.hifigan_disc import WNConv, same_pads

    rs = np.random.RandomState(0)
    cases = [((5,), (1,), 1, 8, 12, 37), ((41,), (4,), 4, 8, 16, 102),
             ((15,), (3,), 1, 4, 8, 50), ((41,), (3,), 2, 4, 6, 98),
             ((5, 1), (3, 1), 1, 1, 4, 47)]
    for k, s, groups, cin, cout, n in cases:
        shape = (2, n, 3, cin) if len(k) == 2 else (2, n, cin)
        x = np.asarray(rs.randn(*shape), np.float32)
        jm = JWNConv(cout, k, s, feature_group_count=groups)
        params = random_tree(jm.init, rs, jax.random.PRNGKey(1),
                             jnp.asarray(x))
        assert params["v"].shape == (*k, cin // groups, cout)
        ref = np.asarray(jax.jit(jm.apply)({"params": params},
                                           jnp.asarray(x)))
        tm = WNConv(cin, cout, k, s, groups)
        tm.load_state_dict(flax_to_state_dict(params, tm))
        xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
        with torch.no_grad():
            got = np.moveaxis(tm(xt).numpy(), 1, -1)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=str((k, s, groups, n)))
        if s[0] > 1:
            # torch's symmetric padding=(k - 1) // 2 gives as many frames
            # here, each one sample off
            sym = (k[0] - 1) // 2
            assert same_pads(n, k[0], s[0])[0] != sym
            pad = (0, 0, sym, sym) if len(k) == 2 else (sym, sym)
            conv = F.conv2d if len(k) == 2 else F.conv1d
            with torch.no_grad():
                off = conv(F.pad(xt, pad), tm.weight(), tm.bias, s,
                           groups=groups)
            off = np.moveaxis(off.numpy(), 1, -1)
            assert off.shape == ref.shape
            assert not np.allclose(off, ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("T", [1001, 1024])
def test_discriminators_match_jax(pair, T):
    """Every sub-discriminator's features and logits, MPD (period 3 and,
    at T = 1001, period 2 reflect-padded) and MSD (both scales), against
    the JAX discriminators on the same params."""
    from cmtts_tpu.models.hifigan_disc import HiFiGANDiscriminators as JD

    wav = _wavs(7, length=T)
    ref = jax.jit(JD(JDiscConfig(**TINY_DISC)).apply)(
        {"params": pair.init["disc"]}, jnp.asarray(wav))
    with torch.no_grad():
        got = pair.disc(torch.from_numpy(wav))
    assert len(got) == len(ref) == 4
    for (tf, tl), (jf, jl) in zip(got, ref):
        assert len(tf) == len(jf)
        for a, b in zip(tf, jf):
            np.testing.assert_allclose(np.moveaxis(a.numpy(), 1, -1),
                                       np.asarray(b), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-5)


def test_losses_match_jax():
    from cmtts_tpu.models import hifigan_disc as J
    from cmtts_tpu_torch.models import hifigan_disc as P

    rs = np.random.RandomState(0)

    def outs():
        return [([rs.randn(2, 3, 5).astype(np.float32),
                  rs.randn(2, 4).astype(np.float32)],
                 rs.randn(2, 7).astype(np.float32)) for _ in range(3)]

    real, fake = outs(), outs()

    def as_(f, o):
        return [([f(x) for x in fs], f(lg)) for fs, lg in o]

    jr, jf = as_(jnp.asarray, real), as_(jnp.asarray, fake)
    tr, tf = as_(torch.from_numpy, real), as_(torch.from_numpy, fake)
    for name in ("discriminator_loss", "feature_matching_loss"):
        np.testing.assert_allclose(float(getattr(P, name)(tr, tf)),
                                   float(getattr(J, name)(jr, jf)),
                                   rtol=1e-6)
    np.testing.assert_allclose(float(P.generator_adv_loss(tf)),
                               float(J.generator_adv_loss(jf)), rtol=1e-6)


def test_batched_mel_matches_jax():
    """``MelSpectrogram.mel_frames`` against the JAX trainer's vmapped
    ``make_mel_fn`` (both cropped to T // hop frames)."""
    from cmtts_tpu.audio.stft import MelSpectrogram as JMel
    from cmtts_tpu.train.hifigan_trainer import make_mel_fn
    from cmtts_tpu_torch.audio.stft import MelSpectrogram
    from torch_port_helpers import assert_mel_close

    wavs = _wavs(3, 3, 2300)
    ref = np.asarray(make_mel_fn(JMel(), 256)(jnp.asarray(wavs)))
    got = MelSpectrogram(device="cpu").mel_frames(torch.from_numpy(wavs),
                                                  2300 // 256)
    assert got.shape == ref.shape == (3, 8, 80)
    assert_mel_close(got.numpy(), ref)


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_optimizers_match_optax(name):
    """8 steps of the port's AdamW (the vocoder's, with a decay schedule
    of 3 steps a transition so that it decays within them) and Adam (the
    GE2E trainer's) against optax on random grads of 1e-6 to 1."""
    from cmtts_tpu_torch.train.state import Adam, AdamW, exponential_decay

    rs = np.random.RandomState(0)
    shapes = {"w": (7, 5), "b": (3,), "s": ()}
    params = {k: np.asarray(rs.randn(*s), np.float32)
              for k, s in shapes.items()}
    if name == "adamw":
        jtx = optax.adamw(optax.exponential_decay(2e-4, 3, 0.9), b1=0.8,
                          b2=0.99, weight_decay=0.01)
        ttx = AdamW(exponential_decay(2e-4, 3, 0.9), 0.8, 0.99,
                    weight_decay=0.01)
    else:
        jtx, ttx = optax.adam(1e-4), Adam(1e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = ttx.init(tp)
    for _ in range(8):
        g = {k: np.asarray(rs.randn(*s) * 10.0 ** rs.randint(-6, 1),
                           np.float32) for k, s in shapes.items()}
        u, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        tp, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       **OPT_TOL)
            np.testing.assert_allclose(ts["mu"][k].numpy(),
                                       np.asarray(js[0].mu[k]), **OPT_TOL)
            np.testing.assert_allclose(ts["nu"][k].numpy(),
                                       np.asarray(js[0].nu[k]), **OPT_TOL)


def test_exponential_decay_matches_optax():
    from cmtts_tpu_torch.train.state import exponential_decay

    ref = optax.exponential_decay(2e-4, 500, 0.999)
    got = exponential_decay(2e-4, 500, 0.999)
    for count in (0, 1, 7, 499, 500, 501, 12345):
        np.testing.assert_allclose(got(count), np.asarray(ref(count)),
                                   rtol=1e-7)


def test_one_unpaired_step_matches_jax(pair, unpaired):
    """The five metrics, the gradients (through the first moments, mu =
    (1 - b1) g, and nu = (1 - b2) g^2) and the params after one step."""
    js, jm, ts, tm = unpaired[0]
    assert set(tm) == set(jm) == {"d_loss", "g_loss", "g_adv", "g_fm",
                                  "mel_l1"}
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], **METRIC_TOL, err_msg=k)
    _check_state(pair, js, ts, 1)
    assert ts["step"] == 1


def test_three_unpaired_steps_match_jax(pair, unpaired):
    for i, (js, jm, ts, tm) in enumerate(unpaired):
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], **METRIC_TOL,
                                       err_msg=f"step {i + 1} {k}")
    js, _, ts, _ = unpaired[-1]
    _check_state(pair, js, ts, 3, moments=False)


def test_paired_step_matches_jax(pair):
    """Paired fine-tuning: external mels in, the mel loss against the
    ground-truth crop's mel."""
    mels = np.asarray(np.random.RandomState(5).randn(B, SEGMENT // 256, 80)
                      - 4.0, np.float32)
    (js, jm, ts, tm), = pair.run([(_wavs(11), mels)], paired=True)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], **METRIC_TOL, err_msg=k)
    _check_state(pair, js, ts, 1)


def test_generator_export_loads_in_both_packages(pair, unpaired, tmp_path):
    """``hifigan_gen_<step>.npz`` written by the port (flax layout through
    ``state_dict_to_flax``) vocodes the same in the JAX generator, the
    port's ``load_hifigan`` and the port's trained params."""
    from cmtts_tpu.models.hifigan import HiFiGANGenerator as JG
    from cmtts_tpu.models.hifigan import load_hifigan_params
    from cmtts_tpu_torch.models.hifigan import load_hifigan
    from cmtts_tpu_torch.train.hifigan_trainer import save_hifigan

    ts = unpaired[-1][2]
    path = save_hifigan(ts, pair.gen, str(tmp_path), 3,
                        np.random.RandomState(0))
    assert os.path.basename(path) == "hifigan_gen_00000003.npz"
    mel = np.asarray(np.random.RandomState(2).randn(1, 12, 80) - 4,
                     np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, load_hifigan_params(path))
    ref = np.asarray(jax.jit(JG(JGenConfig(
        upsample_initial_channel=WIDTH)).apply)({"params": jparams},
                                                jnp.asarray(mel)))
    with torch.no_grad():
        got = load_hifigan(path)(torch.from_numpy(mel)).numpy()
        own = torch.func.functional_call(pair.gen, ts["gen"],
                                         (torch.from_numpy(mel),)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)
    np.testing.assert_allclose(got, own, rtol=0, atol=1e-7)


def test_bridge_round_trip_is_exact():
    """flax -> torch -> flax gives back every leaf bit for bit (random
    values on each flax module's own tree): the generator (ConvTranspose
    tap flip), the discriminators (WNConv), the GE2E encoder (LSTM gate
    split and bias fold) and the CM (qkv split, the scanned denoiser
    stack, LayerNorm and Embed)."""
    from cmtts_tpu.models.hifigan import HiFiGANGenerator as JG
    from cmtts_tpu.models.hifigan_disc import HiFiGANDiscriminators as JD
    from cmtts_tpu.models.speaker import GE2EEncoder as JE
    from cmtts_tpu_torch.convert import state_dict_to_flax
    from cmtts_tpu_torch.models.speaker import GE2EEncoder
    from cmtts_tpu.models.cmtts import CMTTS as JCMTTS
    from cmtts_tpu_torch.models.cmtts import CMTTS
    from torch_port_helpers import config_dicts, configs_from, flat_tree

    rs = np.random.RandomState(3)
    key = jax.random.PRNGKey(3)
    jcfg, tcfg = configs_from(config_dicts())
    B, t_txt = 1, 8
    cases = [
        (random_tree(JG(JGenConfig(upsample_initial_channel=WIDTH)).init, rs,
                     key, jnp.zeros((1, 8, 80))),
         HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=WIDTH))),
        (random_tree(JD(JDiscConfig(**TINY_DISC)).init, rs, key,
                     jnp.zeros((1, 512))),
         HiFiGANDiscriminators(HiFiGANDiscConfig(**TINY_DISC))),
        (random_tree(JE(hidden=16, embedding=8).init, rs, key,
                     jnp.zeros((1, 5, 40))), GE2EEncoder(16, 8)),
        (random_tree(
            functools.partial(JCMTTS(jcfg).init, deterministic=True), rs,
            {"params": key, "dropout": key},
            jnp.zeros((B, 32, jcfg.stft.n_mel_channels)), jnp.zeros(B),
            speakers=jnp.zeros(B, jnp.int32),
            texts=jnp.ones((B, t_txt), jnp.int32),
            src_lens=jnp.full((B,), t_txt, jnp.int32),
            spker_embeds=jnp.zeros((B, jcfg.model.external_speaker_dim))),
         CMTTS(tcfg)),
    ]
    for tree, model in cases:
        back = state_dict_to_flax(load_flax_params(model, tree))
        a, b = dict(flat_tree(tree)), dict(flat_tree(back))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _corpus(root, n=3, length=6000, sr=22050):
    from cmtts_tpu_torch.audio.wavio import write_wav

    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "sub"), exist_ok=True)
    for i in range(n):
        t = np.arange(length + 900 * i) / sr
        wav = 0.4 * np.sin(2 * np.pi * (120 + 40 * i) * t) \
            + 0.05 * rng.randn(len(t))
        write_wav(os.path.join(root, "sub" if i % 2 else "", f"u{i}.wav"),
                  wav.astype(np.float32), sr)
    return root


def test_samplers_match_jax(tmp_path):
    """Both crop samplers, copies of the JAX package's, give the same
    arrays from the same RandomState (the short-file tiling, the mel
    layouts and the skipped files too)."""
    from cmtts_tpu.train import hifigan_trainer as J
    from cmtts_tpu_torch.train import hifigan_trainer as P

    root = _corpus(str(tmp_path / "wavs"))
    for seg in (2048, 8192):
        a = J.WaveSegmentSampler(root, seg).sample(np.random.RandomState(0), 5)
        b = P.WaveSegmentSampler(root, seg).sample(np.random.RandomState(0), 5)
        np.testing.assert_array_equal(b, a)
    mel_dir = tmp_path / "mels"
    mel_dir.mkdir()
    rs = np.random.RandomState(1)
    np.save(mel_dir / "u0-mel.npy", rs.randn(23, 80).astype(np.float32))
    np.save(mel_dir / "spk-mel-u1.npy", rs.randn(80, 26).astype(np.float32))
    np.save(mel_dir / "u2.npy", rs.randn(30, 80).astype(np.float32))
    np.save(mel_dir / "nowav-mel.npy", rs.randn(30, 80).astype(np.float32))
    with pytest.warns(UserWarning, match="skipped 1"):
        js = J.MelWavPairSampler(str(mel_dir), root, 8)
    with pytest.warns(UserWarning, match="skipped 1"):
        ps = P.MelWavPairSampler(str(mel_dir), root, 8)
    for a, b in zip(js.sample(np.random.RandomState(2), 6),
                    ps.sample(np.random.RandomState(2), 6)):
        np.testing.assert_array_equal(b, a)


CLI_FLAGS = ["--upsample_initial_channel", "16", "--disc_scale", "64",
             "--segment_size", "1024", "--batch_size", "2", "--log_every",
             "1"]


def test_cli_trains_resumes_and_finetunes_on_cpu(tmp_path, capsys):
    """``cli.train_hifigan --device cpu`` on a tiny formant corpus: 2 steps
    saving at 1, a resume to 3 from the saved state (params, moments,
    counts and the crop RNG equal to the run's own at step 2), then one
    paired fine-tuning step from the exported generator on
    ``<base>-mel.npy`` mels; the JAX trainer's resume file is refused."""
    from cmtts_tpu_torch.audio.stft import MelSpectrogram
    from cmtts_tpu_torch.audio.wavio import read_wav
    from cmtts_tpu_torch.cli.train_hifigan import main
    from cmtts_tpu_torch.train.hifigan_trainer import (
        load_hifigan_train_state,
    )

    root = formant_corpus(tmp_path / "corpus")
    work = str(tmp_path / "run")
    base = ["--wav_root", root, "--work_dir", work, "--device", "cpu",
            *CLI_FLAGS]
    s2 = main(base + ["--total_steps", "2", "--save_every", "1"])
    assert sorted(f for f in os.listdir(work) if f.endswith(".npz")) == [
        "hifigan_gen_00000001.npz", "hifigan_gen_00000002.npz"]
    restored, rng = load_hifigan_train_state(work, "cpu")
    assert restored["step"] == s2["step"] == 2
    for which in ("gen", "disc"):
        for k, v in s2[which].items():
            assert torch.equal(restored[which][k], v)
        opt = f"opt_{which[0]}"
        for name in ("mu", "nu"):
            for k, v in s2[opt][name].items():
                assert torch.equal(restored[opt][name][k], v)
        assert restored[opt]["count"] == 2
    from cmtts_tpu_torch.train.hifigan_trainer import WaveSegmentSampler

    own = np.random.RandomState(0)
    for _ in range(2):
        WaveSegmentSampler(root, 1024).sample(own, 2)
    np.testing.assert_array_equal(rng.get_state()[1], own.get_state()[1])
    assert rng.get_state()[2:] == own.get_state()[2:]
    capsys.readouterr()
    s3 = main(base + ["--total_steps", "3", "--resume"])
    out = capsys.readouterr().out
    assert "resumed hifigan trainer at step 2" in out
    assert s3["step"] == 3 and "hifigan step 3:" in out
    assert "hifigan step 1:" not in out

    mel_dir = tmp_path / "mels"
    mel_dir.mkdir()
    stft = MelSpectrogram(device="cpu")
    for name in ("v00/v00_000", "v01/v01_002"):
        wav, _ = read_wav(os.path.join(root, f"{name}.wav"))
        mel, _ = stft(wav)
        np.save(mel_dir / f"{os.path.basename(name)}-mel.npy", mel.T)
    ft = str(tmp_path / "ft")
    s_ft = main(["--wav_root", root, "--work_dir", ft, "--device", "cpu",
                 *CLI_FLAGS, "--total_steps", "1", "--finetune_mel_dir",
                 str(mel_dir), "--init_gen_npz",
                 os.path.join(work, "hifigan_gen_00000003.npz")])
    out = capsys.readouterr().out
    assert "generator warm-started from" in out
    assert s_ft["step"] == 1
    assert os.path.exists(os.path.join(ft, "hifigan_gen_00000001.npz"))

    jax_dir = tmp_path / "jax_run"
    jax_dir.mkdir()
    np.save(jax_dir / "hifigan_train_state.npy", np.zeros(1))
    with pytest.raises(ValueError, match="JAX trainer"):
        main(["--wav_root", root, "--work_dir", str(jax_dir), "--device",
              "cpu", *CLI_FLAGS, "--total_steps", "1", "--resume"])


def test_cli_needs_cuda_by_default(tmp_path, monkeypatch):
    from cmtts_tpu_torch.cli.train_hifigan import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--wav_root", str(tmp_path), "--work_dir", str(tmp_path),
              "--total_steps", "1"])
