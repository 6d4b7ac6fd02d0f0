"""Train state and the two optimizers (mirrors devc_tpu/train/state.py and
devc_tpu/train/flat_opt.py).

The reference's optimisation setup (train.py:308-319, 477-479):
  generator  AMSGrad, b1 0.5, b2 0.999, eps 1e-5, per-module learning
             rates: warpnet 1e-5, colorvid 2e-4
  critic     Adam, lr 2e-4, b1 0.5, b2 0.999
  schedule   StepLR(step_size, gamma 0.1), stepped per iteration

`FlatAdam` is devc_tpu's `flat_adam`: optax's Adam / AMSGrad on one
concatenated fp32 vector per moment. Its AMSGrad keeps the running max of
the *bias-corrected* second moment (nu_max = max(nu_max, nu_hat), optax's
rule); `torch.optim.Adam(amsgrad=True)` keeps the max of the raw moment and
corrects after, which agrees at step 1 and differs from step 2, so it is
not used. The StepLR factor is evaluated at the pre-increment count, as
optax's scale_by_schedule.

Parameters live in the modules and are updated in place (the state holds
the modules, not copies of their weights).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from devc_tpu_torch.models.discriminator import Discriminator


class FlatAdamState(NamedTuple):
    count: int              # steps taken (the schedule reads it before +1)
    mu: torch.Tensor        # first moment, flat fp32
    nu: torch.Tensor        # second moment, flat fp32
    nu_max: torch.Tensor | None  # running max of bias-corrected nu (amsgrad)


def param_groups(module: nn.Module) -> dict:
    """{top-level child name: its parameters in registration order} for a
    ModuleDict such as params_g ({"warpnet", "colorvid"}), else
    {"": all parameters}. The optimizer's flat order follows it."""
    if isinstance(module, nn.ModuleDict):
        return {k: list(m.parameters()) for k, m in module.items()}
    return {"": list(module.parameters())}


class FlatAdam:
    """Adam / AMSGrad with optax's update rule on one flat vector.

    lr: a float, or {group: float} for per-module rates (groups as
    `param_groups`). lr_step: StepLR's step size (None: no schedule).
    `init(groups)` makes the state; `update(grads, state)` returns the
    per-tensor updates (to add to the parameters) and the new state.
    """

    def __init__(self, lr, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, amsgrad: bool = False,
                 lr_step: int | None = None, lr_gamma: float = 0.1):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.amsgrad, self.lr_step, self.lr_gamma = amsgrad, lr_step, lr_gamma

    def _lr_vector(self, groups: dict):
        parts = []
        for name, tensors in groups.items():
            lr = self.lr[name] if isinstance(self.lr, dict) else self.lr
            parts += [torch.full((t.numel(),), lr, dtype=torch.float32,
                                 device=t.device) for t in tensors]
        return torch.cat(parts)

    def schedule_factor(self, count: int) -> float:
        """StepLR's multiplier gamma ** floor(count / step), in fp32."""
        if self.lr_step is None:
            return 1.0
        return float(torch.tensor(self.lr_gamma, dtype=torch.float32)
                     ** (count // self.lr_step))

    def init(self, groups: dict) -> FlatAdamState:
        flat = torch.cat([t.detach().reshape(-1).float()
                          for ts in groups.values() for t in ts])
        zeros = lambda: torch.zeros_like(flat)
        return FlatAdamState(0, zeros(), zeros(),
                             zeros() if self.amsgrad else None)

    def update(self, grads: dict, state: FlatAdamState):
        g = torch.cat([t.reshape(-1).float()
                       for ts in grads.values() for t in ts])
        count_inc = state.count + 1
        mu = (1.0 - self.b1) * g + self.b1 * state.mu
        nu = (1.0 - self.b2) * (g * g) + self.b2 * state.nu
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=g.device)
        mu_hat = mu / (1 - f32(self.b1) ** count_inc)
        nu_hat = nu / (1 - f32(self.b2) ** count_inc)
        if self.amsgrad:
            nu_max = torch.maximum(state.nu_max, nu_hat)
            denom = nu_max
        else:
            nu_max, denom = None, nu_hat
        step_size = self._lr_vector(grads) * self.schedule_factor(state.count)
        upd = -step_size * (mu_hat / (torch.sqrt(denom) + self.eps))
        out, off = {}, 0
        for name, ts in grads.items():
            out[name] = []
            for t in ts:
                out[name].append(upd[off:off + t.numel()].view_as(t))
                off += t.numel()
        return out, FlatAdamState(count_inc, mu, nu, nu_max)


def make_optimizers(lr_warpnet: float = 1e-5, lr_colorvid: float = 2e-4,
                    lr_d: float = 2e-4, lr_step: int | None = 100,
                    lr_gamma: float = 0.1):
    """(tx_g, tx_d): the reference's two optimizers (devc_tpu's
    make_optimizers, fused form); lr_step None: no StepLR schedule."""
    tx_g = FlatAdam({"warpnet": lr_warpnet, "colorvid": lr_colorvid},
                    b1=0.5, b2=0.999, eps=1e-5, amsgrad=True, lr_step=lr_step,
                    lr_gamma=lr_gamma)
    tx_d = FlatAdam(lr_d, b1=0.5, b2=0.999, lr_step=lr_step,
                    lr_gamma=lr_gamma)
    return tx_g, tx_d


@dataclasses.dataclass
class TrainState:
    """devc_tpu's TrainState: step, the generator ({"warpnet", "colorvid"}
    ModuleDict), the critic, its spectral-norm vectors ({layer: {"u",
    "v"}}) and the two optimizer states."""
    step: int
    params_g: nn.ModuleDict
    params_d: Discriminator
    sn_state: dict
    opt_state_g: FlatAdamState
    opt_state_d: FlatAdamState


def apply_updates(module: nn.Module, updates: dict) -> None:
    """Add per-tensor updates to the module's parameters in place."""
    with torch.no_grad():
        for name, ps in param_groups(module).items():
            torch._foreach_add_(ps, updates[name])


def create_train_state(seed: int = 0, warpnet_sd: dict | None = None,
                       colorvid_sd: dict | None = None, in_ch: int = 7,
                       device="cuda", **opt_kwargs):
    """A fresh TrainState and its two optimizers: (state, tx_g, tx_d), as
    devc_tpu's create_train_state.

    The generator is warm-started from the reference's two .pth state
    dicts (train.py:467-471) where given, else drawn fresh; the critic is
    always drawn fresh. Fresh weights are the port's seeded host draws
    (utils/init.py: WarpNet at seed + 1, ColorVidNet at seed + 2, the
    critic at seed + 3). They cannot equal devc_tpu's, which come from
    jax.random splits of PRNGKey(seed): same distributions, other numbers.
    opt_kwargs go to `make_optimizers` (lr_step=, lr_gamma=, ...).
    """
    from devc_tpu_torch.utils import convert, init

    if warpnet_sd is None:
        warpnet_sd = convert.warpnet_state_dict(init.host_warpnet_init(
            seed + 1))
    if colorvid_sd is None:
        colorvid_sd = convert.colorvidnet_state_dict(
            init.host_colorvidnet_init(seed + 2, in_ch))
    critic_sd = convert.discriminator_state_dict(
        *init.host_discriminator_init(seed + 3))
    tx_g, tx_d = make_optimizers(**opt_kwargs)
    state = convert.train_state_from_state_dicts(
        warpnet_sd, colorvid_sd, critic_sd, tx_g, tx_d, device)
    return state, tx_g, tx_d
