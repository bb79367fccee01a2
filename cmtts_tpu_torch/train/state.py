"""Train state (port of ``cmtts_tpu/train/state.py``): master params, the
optimizer state, three EMA snapshots and the target network, each a dict
``{parameter name: tensor}`` in the order of ``model.named_parameters()``,
and an RAdam that computes what ``optax.radam`` computes; beside it the
AdamW and Adam of the vocoder and speaker-encoder trainers, as
``optax.adamw`` and ``optax.adam`` compute them.

``torch.optim.RAdam`` is not used: it adds ``eps`` to sqrt(v) before the
bias correction, where optax adds it to sqrt(v_hat), and it rectifies when
rho_t > 5, where optax rectifies when rho_t >= 5.  Updates are out of place,
so a state passed to a step stays as it was.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Params = dict[str, torch.Tensor]


@dataclasses.dataclass
class CMTrainState:
    step: int
    params: Params
    opt_state: dict            # {"count": int, "mu": Params, "nu": Params}
    ema_params: tuple          # one Params per ema rate
    target_params: Params


def _pow_f32(x: float, n: int) -> np.float32:
    """x ** n in float32 by binary squaring, as XLA computes a float raised
    to an integer power: 1 - b2 ** t cancels, so the last bit counts."""
    x, r = np.float32(x), np.float32(1.0)
    while n:
        if n & 1:
            r = np.float32(r * x)
        x = np.float32(x * x)
        n >>= 1
    return r


class RAdam:
    """``optax.radam(lr, b1, b2, eps, eps_root=0, threshold)``, chained
    after ``optax.add_decayed_weights(weight_decay)`` when weight_decay is
    not 0, as ``cmtts_tpu.train.state.make_optimizer`` builds it.

    With count t, m = EMA_b1(g), v = EMA_b2(g^2), m_hat = m / (1 - b1^t),
    v_hat = v / (1 - b2^t), rho = rho_inf - 2 t b2^t / (1 - b2^t): the
    update is -lr * r * m_hat / (sqrt(v_hat) + eps) when rho >= threshold,
    else -lr * m_hat.  The scalars are float32, as optax computes them."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, threshold: float = 5.0,
                 weight_decay: float = 0.0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.threshold = threshold
        self.weight_decay = weight_decay

    def init(self, params: Params) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def scalars(self, count: int):
        """(rectify, r, 1 - b1^t, 1 - b2^t) for step count ``count``, in
        float32 as optax computes them."""
        f32 = np.float32
        b2t = _pow_f32(self.b2, count)
        ro_inf = f32(2.0 / (1.0 - self.b2) - 1.0)
        ro = ro_inf - f32(2 * count) * b2t / (f32(1.0) - b2t)
        with np.errstate(invalid="ignore"):
            r = np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * ro_inf
                        / ((ro_inf - f32(4.0)) * (ro_inf - f32(2.0)) * ro))
        return (bool(ro >= self.threshold), float(r),
                float(f32(1.0) - _pow_f32(self.b1, count)),
                float(f32(1.0) - b2t))

    def update(self, grads: Params, opt_state: dict, params: Params):
        """-> (new params, new opt_state)."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        if self.weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul(p, self.weight_decay))
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1),
                                torch._foreach_mul([opt_state["mu"][k]
                                                    for k in names], self.b1))
        g2 = torch._foreach_mul(g, g)
        nu = torch._foreach_add(torch._foreach_mul(g2, 1 - self.b2),
                                torch._foreach_mul([opt_state["nu"][k]
                                                    for k in names], self.b2))
        count = opt_state["count"] + 1
        rectify, r, bc1, bc2 = self.scalars(count)
        u = torch._foreach_div(mu, bc1)
        if rectify:
            torch._foreach_mul_(u, r)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            torch._foreach_div_(u, den)
        torch._foreach_mul_(u, -self.lr)
        new_p = torch._foreach_add(p, u)
        return (dict(zip(names, new_p)),
                {"count": count, "mu": dict(zip(names, mu)),
                 "nu": dict(zip(names, nu))})


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float):
    """``optax.exponential_decay(init_value, transition_steps, decay_rate)``
    (not staircased): count -> init_value * decay_rate^(count /
    transition_steps) in float32, init_value itself at count 0."""
    f32 = np.float32

    def schedule(count: int) -> np.float32:
        if count <= 0:
            return f32(init_value)
        p = f32(count) / f32(transition_steps)
        return f32(init_value) * np.power(f32(decay_rate), p)

    return schedule


class AdamW:
    """``optax.adamw(lr, b1, b2, eps, weight_decay)``, or ``optax.adam(lr,
    b1, b2, eps)`` at weight_decay 0; ``lr`` is a float or a schedule of
    the step count (which starts at 0).

    With count t (from 1), m = EMA_b1(g), v = EMA_b2(g^2), m_hat = m /
    (1 - b1^t), v_hat = v / (1 - b2^t): the update is -lr(t - 1) *
    (m_hat / (sqrt(v_hat) + eps) + weight_decay * p), the bias corrections
    and the rate in float32, as optax computes them.  ``torch.optim.AdamW``
    is not used: it decays the params apart from the Adam step and adds
    ``eps`` before the second bias correction."""

    def __init__(self, lr, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.lr = lr if callable(lr) else (lambda count: np.float32(lr))
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    init = RAdam.init

    def update(self, grads: Params, opt_state: dict, params: Params):
        """-> (new params, new opt_state)."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1),
                                torch._foreach_mul([opt_state["mu"][k]
                                                    for k in names], self.b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2),
            torch._foreach_mul([opt_state["nu"][k] for k in names], self.b2))
        lr = self.lr(opt_state["count"])
        count = opt_state["count"] + 1
        f32 = np.float32
        bc1 = float(f32(1.0) - _pow_f32(self.b1, count))
        bc2 = float(f32(1.0) - _pow_f32(self.b2, count))
        u = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(u, den)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(u, float(-f32(lr)))
        new_p = torch._foreach_add(p, u)
        return (dict(zip(names, new_p)),
                {"count": count, "mu": dict(zip(names, mu)),
                 "nu": dict(zip(names, nu))})


def Adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> AdamW:
    """``optax.adam(lr, b1, b2, eps)``."""
    return AdamW(lr, b1, b2, eps)


def make_optimizer(lr: float, weight_decay: float = 0.0) -> RAdam:
    return RAdam(lr, weight_decay=weight_decay)


def clone_params(params: Params) -> Params:
    return {k: v.detach().clone() for k, v in params.items()}


def create_train_state(params: Params, opt: RAdam,
                       n_ema: int) -> CMTrainState:
    """Step 0: the EMA snapshots and the target start as copies of the
    params."""
    params = clone_params(params)
    return CMTrainState(
        step=0, params=params, opt_state=opt.init(params),
        ema_params=tuple(clone_params(params) for _ in range(n_ema)),
        target_params=clone_params(params))


def tree_ema(old: Params, new: Params, rate: float) -> Params:
    """old * rate + new * (1 - rate)."""
    names = list(old)
    out = torch._foreach_add(
        torch._foreach_mul([old[k] for k in names], rate),
        torch._foreach_mul([new[k] for k in names], 1.0 - rate))
    return dict(zip(names, out))
