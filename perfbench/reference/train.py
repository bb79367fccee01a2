"""The reference of the CT training cells, written from the configuration's
semantics and independent of the program:

- the feed (:class:`Feed`): the corpus's files read with numpy; a
  permutation an epoch, mega-batches of batch x group sorted by phoneme
  count, longest first (CM-TTS ``train_cm.py`` and ``dataset.py``,
  :func:`perfbench.corpus.batch_order`); each batch zero-padded to the
  smallest text and mel buckets of the configuration that hold it;
- the step (:func:`ct_step`): consistency training (openai/consistency_models
  ``consistency_losses``, CM-TTS ``train.yaml``): noise levels drawn from
  the schedule sampler with importance weights 1 / (K p_i), the student at
  t_n and the target network at t_{n+1} on the Euler step with the data
  as its denoiser, the two forward passes sharing their dropout masks,
  boundary scalings, the ``loss_norm`` distance x 10 plus the FastSpeech2
  variance losses (duration, CWT pitch with uv and its moments, energy);
- RAdam as ``optax.radam`` computes it (CM-TTS's trainer takes RAdam and
  clips nothing: ``grad_clip_thresh`` is FastSpeech2's optimizer's), the
  three EMAs and the target network (``target_ema`` of the fixed
  schedule), all from the float32 master params after the update.

The model is :class:`perfbench.reference.acoustic.AcousticModel`.  The
step's draws (the noise levels, the noise, then the dropout masks in the
order of the forward pass) come from a generator seeded as the run seeds
the program's.  ``fmt="control"`` is one precision below what the
configuration states: every param rounded to float8 e4m3 at the apply
boundary (where the program casts to bfloat16), the denoiser's matmul and
conv inputs in float8 too, straight-through gradients, and the float32
parts in TF32.
Faults, planted in the reference put in the program's place to set the
limits: ``"half_batch"`` (half of each batch's rows left out, the mean
over the rest), ``"token"`` (one phoneme of each batch altered where the
feed produces it) and ``"frozen_ema"`` (the EMAs and the target network
left as they were).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.func import functional_call

from perfbench.corpus import SPEAKER, batch_order
from perfbench.reference.acoustic import AcousticModel
from perfbench.reference.quant import round_inputs, round_ste
from perfbench.reference.synth import boundary_scalings, pick_bucket

# the CMUdict ARPAbet inventory (15 vowels with stress marks '', 0, 1, 2
# and 24 consonants, sorted) follows pad, "-", 10 punctuation marks and 52
# letters in CM-TTS's text/symbols.py
ARPABET = sorted([v + s for v in "AA AE AH AO AW AY EH ER EY IH IY OW OY UH "
                  "UW".split() for s in ("", "0", "1", "2")]
                 + "B CH D DH F G HH JH K L M N NG P R S SH T TH V W Y Z "
                 "ZH".split())
TOKEN_BASE = 64
B1, B2, EPS, RHO_THRESHOLD = 0.9, 0.999, 1e-8, 5.0


# -- the feed ---------------------------------------------------------------

class Feed:
    """The batches of the corpus under ``root`` in the order a run's feed
    seed gives them; :meth:`batch` ``i`` is the i-th batch (from 0)."""

    def __init__(self, root: str, meta: list, config: dict, seed: int,
                 n_batches: int):
        tr = config["train"]
        self.root, self.meta = root, meta
        self.buckets = config["buckets"]
        self.order = batch_order(
            meta, int(tr.get("optimizer", {}).get("batch_size", 32)),
            int(tr.get("optimizer", {}).get("group_size", 4)), seed,
            n_batches)
        with open(os.path.join(root, "train.txt")) as f:
            self.text = [ln.split("|")[2] for ln in f.read().splitlines()]

    def _load(self, kind: str, i: int) -> np.ndarray:
        name = self.meta[i]["basename"]
        return np.load(os.path.join(self.root, kind,
                                    f"{SPEAKER}-{kind}-{name}.npy"))

    def tokens(self, i: int) -> np.ndarray:
        return np.asarray([TOKEN_BASE + ARPABET.index(p)
                           for p in self.text[i].strip("{}").split()])

    def batch(self, i: int) -> dict:
        """{"rows": basenames, "arrays": {key: array}} of batch ``i``; the
        keys are the program's (``p_targets.<key>`` for the pitch)."""
        rows = self.order[i]
        toks = [self.tokens(r) for r in rows]
        mels = [self._load("mel", r) for r in rows]
        t_txt = pick_bucket(max(len(t) for t in toks), self.buckets["text"])
        t_mel = pick_bucket(max(len(m) for m in mels), self.buckets["mel"])

        def pad(xs, n):
            out = np.zeros((len(xs), n) + xs[0].shape[1:], xs[0].dtype)
            for j, x in enumerate(xs):
                out[j, :len(x)] = x
            return out

        f0s = [self._load("f0", r) for r in rows]
        stats = np.stack([self._load("f0cwt_mean_std", r) for r in rows])
        arrays = {
            "texts": pad(toks, t_txt),
            "src_lens": np.asarray([len(t) for t in toks]),
            "mels": pad(mels, t_mel),
            "mel_lens": np.asarray([len(m) for m in mels]),
            "d_targets": pad([self._load("duration", r) for r in rows],
                             t_txt),
            "e_targets": pad([self._load("energy", r) for r in rows], t_txt),
            "mel2ph": pad([self._load("mel2ph", r) for r in rows], t_mel),
            "p_targets.cwt_spec": pad([self._load("cwt_spec", r)
                                       for r in rows], t_mel),
            "p_targets.f0_mean": stats[:, 0],
            "p_targets.f0_std": stats[:, 1],
            "p_targets.uv": pad([(f == 0).astype(np.float32) for f in f0s],
                                t_mel),
        }
        return {"rows": [self.meta[r]["basename"] for r in rows],
                "arrays": arrays}


def to_device(arrays: dict, device) -> dict:
    """The flat arrays as the nested tensors the step reads (integers
    int64, floats float32)."""
    out = {}
    for k, a in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(a).astype(
            np.int64 if a.dtype.kind in "iu" else np.float32)).to(device)
        if "." in k:
            top, sub = k.split(".", 1)
            out.setdefault(top, {})[sub] = t
        else:
            out[k] = t
    return out


# -- the step ---------------------------------------------------------------

def sampler_probs(name: str, num_scales: int) -> np.ndarray:
    n = num_scales - 1
    w = {"uniform": np.ones(n),
         "linear12": np.arange(1, n + 1, dtype=np.float64)}[name]
    return (w / w.sum()).astype(np.float32)


def sigma_of(idx, num_scales: int, c):
    lo, hi = c.sigma_min ** (1.0 / c.rho), c.sigma_max ** (1.0 / c.rho)
    return (hi + idx.float() / (num_scales - 1) * (lo - hi)) ** c.rho


def weighting(name: str, sigma):
    """The loss weight a noise level: the configuration's ``uniform``."""
    if name != "uniform":
        raise NotImplementedError(f"weight schedule {name}")
    return torch.ones_like(sigma)


def masked_mean(x, m):
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def variance_losses(pred: dict, batch: dict, loss: dict) -> torch.Tensor:
    """FastSpeech2's duration (phone and sentence, MSE of log(d + 1)), the
    CWT pitch head's L1 on the spectrogram, BCE on uv over the frames and
    L1 on the f0 moments, and phoneme energy L1."""
    if float(loss.get("lambda_word_dur", 0.0)):
        raise NotImplementedError("word durations")
    src = (~pred["src_pad"]).float()
    t_mel = batch["mels"].shape[1]
    mel = (torch.arange(t_mel, device=src.device)[None, :]
           < pred["mel_lens"][:, None]).float()
    d = batch["d_targets"].float() * src
    log_d = pred["log_d"]
    terms = [masked_mean((log_d - torch.log(d + 1.0)) ** 2, src)
             * float(loss.get("lambda_ph_dur", 1.0))]
    d_pred = torch.clamp(torch.exp(log_d) - 1.0, min=0.0)
    terms.append(((torch.log(d_pred.sum(-1) + 1.0)
                   - torch.log(d.sum(-1) + 1.0)) ** 2).mean()
                 * float(loss.get("lambda_sent_dur", 1.0)))
    p, lam_f0 = batch["p_targets"], float(loss.get("lambda_f0", 1.0))
    err = pred["cwt"][..., :10] - p["cwt_spec"]
    terms.append((err.abs() if loss.get("cwt_loss", "l1") == "l1"
                  else err ** 2).mean() * lam_f0)
    logit, y = pred["cwt"][..., -1], p["uv"]
    bce = (torch.clamp(logit, min=0) - logit * y
           + torch.log1p(torch.exp(-logit.abs())))
    terms.append(masked_mean(bce, mel) * float(loss.get("lambda_uv", 1.0)))
    terms.append((pred["f0_mean"] - p["f0_mean"]).abs().mean() * lam_f0)
    terms.append((pred["f0_std"] - p["f0_std"]).abs().mean() * lam_f0)
    terms.append(masked_mean((pred["e_pred"] - batch["e_targets"]).abs(),
                             src))
    return sum(terms)


def ct_loss(model, params: dict, target: dict, batch: dict, probs, gen,
            num_scales: int, c, cm: dict, loss: dict, draws=None,
            lower: bool = False):
    """The batch's loss, ``gen`` left as the step leaves it; ``draws``
    (noise level indices, noise) replace the first two draws; ``lower``
    rounds the params to float8 at the apply boundary (the control)."""
    x0 = batch["mels"]
    B, dev = x0.shape[0], x0.device
    probs = torch.as_tensor(probs, dtype=torch.float32, device=dev)
    if draws is None:
        idx = torch.multinomial(probs, B, replacement=True, generator=gen)
        noise = torch.randn(x0.shape, generator=gen, device=dev)
    else:
        idx, noise = draws
    w = 1.0 / (probs.shape[0] * probs[idx])
    t, t2 = sigma_of(idx, num_scales, c), sigma_of(idx + 1, num_scales, c)
    x_t = x0 + noise * t[:, None, None]
    x_t2 = x_t + (x_t - x0) / t[:, None, None] * (t2 - t)[:, None, None]

    def denoise(p, x, sigma):
        if lower:
            p = {k: round_ste(v, "fp8") for k, v in p.items()}
        c_skip, c_out, c_in = boundary_scalings(sigma, c)
        out, pred = functional_call(
            model, p, (c_in[:, None, None] * x,
                       250.0 * torch.log(sigma + 1e-44), batch, gen))
        return c_out[:, None, None] * out + c_skip[:, None, None] * x, pred

    masks = gen.get_state()
    student, pred = denoise(params, x_t, t)
    with torch.no_grad():
        gen.set_state(masks)        # the target draws the student's masks
        teacher, _ = denoise(target, x_t2, t2)
    diff = student - teacher
    norm = cm.get("loss_norm", "l1")
    dist = {"l1": diff.abs(), "l2": diff ** 2}[norm].mean(dim=(1, 2))
    cm_loss = dist * weighting(cm.get("weight_schedule", "uniform"), t)
    total = 10.0 * cm_loss + variance_losses(pred, batch, loss)
    return (total * w).mean()


def pow_f32(x: float, n: int) -> np.float32:
    """x ** n in float32 by binary squaring, as XLA raises a float to an
    integer power (optax's b2 ** count): rho_t cancels, so the last bit
    moves r by a percent in the first steps after rectification."""
    x, r = np.float32(x), np.float32(1.0)
    while n:
        if n & 1:
            r = np.float32(r * x)
        x = np.float32(x * x)
        n >>= 1
    return r


def radam(state: dict, grads: dict, lr: float, weight_decay: float):
    """``optax.radam`` (after ``add_decayed_weights`` where the decay is
    not 0), its scalars in float32 as optax computes them: m, v the
    moments' EMAs, the update lr r m_hat / (sqrt(v_hat) + eps) once
    rho_t >= 5, lr m_hat before; returns the new state."""
    count = state["count"] + 1
    f32 = np.float32
    b1t, b2t = pow_f32(B1, count), pow_f32(B2, count)
    rho_inf = f32(2.0 / (1.0 - B2) - 1.0)
    rho = rho_inf - f32(2 * count) * b2t / (f32(1.0) - b2t)
    out = {"count": count, "params": {}, "mu": {}, "nu": {}}
    for k, p in state["params"].items():
        g = grads[k] + weight_decay * p if weight_decay else grads[k]
        mu = B1 * state["mu"][k] + (1.0 - B1) * g
        nu = B2 * state["nu"][k] + (1.0 - B2) * g * g
        u = mu / float(f32(1.0) - b1t)
        if rho >= RHO_THRESHOLD:
            r = float(np.sqrt((rho - f32(4.0)) * (rho - f32(2.0)) * rho_inf
                              / ((rho_inf - f32(4.0)) * (rho_inf - f32(2.0))
                                 * rho)))
            u = r * u / (torch.sqrt(nu / float(f32(1.0) - b2t)) + EPS)
        out["params"][k] = p - lr * u
        out["mu"][k], out["nu"][k] = mu, nu
    return out


def ct_step(model, state: dict, batch: dict, gen, config: dict, c,
            fmt: str | None = None, draws=None):
    """One step from ``state`` ({params, mu, nu, count, ema (a list),
    target}): (new state, loss, the gradient's leaf norms)."""
    tr = config["train"]
    cm, loss_cfg = tr["cm"], tr["loss"]
    if (cm.get("target_ema_mode"), cm.get("scale_mode")) != ("fixed",
                                                             "fixed"):
        raise NotImplementedError("the fixed EMA and scale schedule")
    num_scales = int(cm["start_scales"])
    if fmt == "half_batch":
        half = batch["mels"].shape[0] // 2
        batch = {k: ({s: x[:half] for s, x in v.items()}
                     if isinstance(v, dict) else v[:half])
                 for k, v in batch.items()}
    params = {k: v.detach().requires_grad_(True)
              for k, v in state["params"].items()}
    loss = ct_loss(model, params, state["target"], batch,
                   sampler_probs(cm.get("schedule_sampler", "uniform"),
                                 num_scales),
                   gen, num_scales, c, cm, loss_cfg, draws,
                   lower=fmt == "control")
    names = list(params)
    g = torch.autograd.grad(loss, [params[k] for k in names],
                            allow_unused=True)
    grads = {k: (torch.zeros_like(params[k]) if gi is None else gi)
             for k, gi in zip(names, g)}
    with torch.no_grad():
        new = radam(state, grads, float(cm["lr"]),
                    float(cm.get("weight_decay", 0.0)))
        rates = [float(r) for r in str(cm["ema_rate"]).split(",")]
        mu_t = float(cm["start_ema"])
        if fmt == "frozen_ema":
            new["ema"], new["target"] = state["ema"], state["target"]
        else:
            new["ema"] = [{k: r * e[k] + (1.0 - r) * new["params"][k]
                           for k in e} for e, r in zip(state["ema"], rates)]
            new["target"] = {k: mu_t * v + (1.0 - mu_t) * new["params"][k]
                             for k, v in state["target"].items()}
    return new, float(loss.detach()), leaf_norms(grads)


# -- runs of the reference --------------------------------------------------

def build(config: dict, c, state_dict: dict, device: str, fmt: str):
    """The model with ``state_dict`` loaded, in ``fmt``; returns (model,
    hooks to remove)."""
    tf32 = fmt == "control"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    with torch.device(device):
        model = AcousticModel(c)
    model.to(device)        # tables made from numpy start on the host
    model.load_state_dict(state_dict, strict=True)
    hooks = round_inputs([model.denoiser], "fp8") if fmt == "control" else []
    return model, hooks


def fresh_state(model, config: dict) -> dict:
    """Step 0: the moments zero, the EMAs and the target copies of the
    params."""
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    n_ema = len(str(config["train"]["cm"]["ema_rate"]).split(","))
    return {"count": 0, "params": params,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
            "ema": [{k: v.clone() for k, v in params.items()}
                    for _ in range(n_ema)],
            "target": {k: v.clone() for k, v in params.items()}}


def run_steps(config: dict, c, feed: Feed, state: dict, first: int,
              n_steps: int, gen, model, fmt: str = "f32") -> dict:
    """Steps ``first`` .. ``first + n_steps - 1`` (feed batches of those
    indices) from ``state``: {"losses", "rows", "batches" (the host
    arrays a step), "grad" (the first step's gradient leaf norms),
    "change" (per tree, the leaf norms of the change after the steps)}."""
    out = {"losses": [], "rows": [], "batches": []}
    s = state
    for i in range(first, first + n_steps):
        b = feed.batch(i)
        arrays = dict(b["arrays"])
        if fmt == "token":
            arrays["texts"] = arrays["texts"].copy()
            arrays["texts"][0, 0] = (arrays["texts"][0, 0] - TOKEN_BASE + 1) \
                % len(ARPABET) + TOKEN_BASE
        out["rows"].append(b["rows"])
        out["batches"].append(arrays)
        s, loss, grad = ct_step(model, s, to_device(arrays, device_of(s)),
                                gen, config, c,
                                fmt)
        out["losses"].append(loss)
        if i == first:
            out["grad"] = grad
    out["change"] = changes(state, s)
    return out


def device_of(state: dict):
    return next(iter(state["params"].values())).device


def leaf_norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tree.items()}


def trees(state: dict) -> dict:
    """The state's trees by name: params, ema0.., target."""
    out = {"params": state["params"], "target": state["target"]}
    out.update({f"ema{i}": e for i, e in enumerate(state["ema"])})
    return out


def changes(before: dict, after: dict) -> dict:
    """Per tree, the leaf norms of after - before."""
    a = trees(after)
    return {name: leaf_norms({k: a[name][k] - v for k, v in t.items()})
            for name, t in trees(before).items()}


def from_seed(config: dict, c, feed: Feed, state_dict: dict, seed: int,
              n_steps: int, device: str, fmt: str = "f32") -> dict:
    """The first ``n_steps`` steps from the seed's weights, the draws from
    a generator seeded with ``seed`` (the program's)."""
    model, hooks = build(config, c, state_dict, device, fmt)
    gen = torch.Generator(device=device).manual_seed(seed)
    try:
        return run_steps(config, c, feed, fresh_state(model, config), 0,
                         n_steps, gen, model, fmt)
    finally:
        finish(hooks)


def from_state(config: dict, c, feed: Feed, state_dict: dict, state: dict,
               gen_state, first: int, n_steps: int, device: str,
               fmt: str = "f32") -> dict:
    """``n_steps`` steps from feed batch ``first`` on, from ``state`` (the
    program's, taken in the window) and the generator's state then."""
    model, hooks = build(config, c, state_dict, device, fmt)
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    try:
        return run_steps(config, c, feed, state, first, n_steps, gen, model,
                         fmt)
    finally:
        finish(hooks)


def finish(hooks) -> None:
    for h in hooks:
        h.remove()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# -- the numbers compared ---------------------------------------------------

def feed_mismatch(prog: dict, ref: dict) -> int:
    """Rows and values of the program's batches that differ from the
    reference feed's, exactly; a key the program lacks counts whole."""
    bad = 0
    for rows_p, rows_r in zip(prog["rows"], ref["rows"]):
        bad += sum(x != y for x, y in zip(rows_p, rows_r)) + abs(
            len(rows_p) - len(rows_r))
    for bp, br in zip(prog["batches"], ref["batches"]):
        for k, b in br.items():
            a = bp.get(k)
            if a is None or np.shape(a) != b.shape:
                bad += b.size
            else:
                bad += int(np.count_nonzero(np.asarray(a) != b))
    return bad


def leaf_gaps(p: dict, r: dict, keys) -> dict:
    """Each leaf's gap of norms, |n - n_ref| / max(n_ref, the median
    leaf's n_ref)."""
    med = float(np.median([r[k] for k in keys]))
    return {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in keys}


def gaps(prog: list, ref: list, leaves: dict | None = None) -> dict:
    """The training numbers over the compared stretches (the first steps
    from the seed, the window's steps from the program's state), each a
    pair of the program's readings and the reference's:

    - ``loss_gap``: the worst step's |L - L_ref| / |L_ref|;
    - ``grad_gap``, ``grad_med_gap``: the first stretch's first gradient,
      the worst leaf's gap and the median leaf's;
    - ``change_gap``, ``change_med_gap``: the change over a stretch in the
      params, each EMA and the target network, the worst leaf's gap and
      the median leaf's, the largest over the stretches and trees, over
      the leaves whose reference gradient at the stretch's first step is
      at least a thousandth of the median leaf's (the others move by
      round-off);
    - ``feed_mismatch``: the batches' rows and values that differ from the
      reference feed's.

    ``leaves`` (a dict) gets the worst leaf of each stretch and tree."""
    loss, change, change_med, fm = 0.0, 0.0, 0.0, 0
    for i, (p, r) in enumerate(zip(prog, ref)):
        loss = max([loss] + [abs(a - b) / max(abs(b), 1e-30)
                             for a, b in zip(p["losses"], r["losses"])])
        gmed = float(np.median(list(r["grad"].values())))
        moved = [k for k, v in r["grad"].items() if v >= 1e-3 * gmed]
        for t in r["change"]:
            g = leaf_gaps(p["change"][t], r["change"][t], moved)
            k = max(g, key=g.get)
            change = max(change, g[k])
            change_med = max(change_med, float(np.median(list(g.values()))))
            if leaves is not None:
                leaves[f"change {i} {t}"] = (k, g[k])
        fm += feed_mismatch(p, r)
    out = {"loss_gap": loss, "change_gap": change,
           "change_med_gap": change_med, "feed_mismatch": fm}
    if "grad" in prog[0]:
        g = leaf_gaps(prog[0]["grad"], ref[0]["grad"], list(ref[0]["grad"]))
        k = max(g, key=g.get)
        out["grad_gap"] = g[k]
        out["grad_med_gap"] = float(np.median(list(g.values())))
        if leaves is not None:
            leaves["grad"] = (k, g[k])
    return out
