"""Train state: the port of ``tqdne_tpu/train/state.py``.

The JAX ``TrainState`` is one pytree (step, params, EMA params, optax
state) that each jitted step replaces.  Here it is one object that the step
updates in place: the live module, an EMA copy of it, the optimizer and the
learning-rate schedule, which is evaluated in closed form at the count of
updates applied before this one, as optax evaluates a schedule at its
update count.

The non-finite guard (``skip_nonfinite=N``) is optax ``apply_if_finite(tx,
N)``: a step whose gradients hold a NaN or an inf applies no update and
leaves the optimizer's state, its count and so the schedule where they
were; after more than N consecutive such steps the update is applied all
the same.  ``step`` and the EMA advance on every step, as the JAX
``apply_updates`` advances them.  The guard stays on the device: one
multi-tensor finiteness check feeds the fused optimizer's ``found_inf``,
and nothing waits for the host.
"""

from __future__ import annotations

import copy
import math
from typing import Callable

import torch


class TrainState:
    """step + the live module + its EMA copy + the optimizer (and schedule),
    with the non-finite guard's count of consecutive non-finite steps."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 lr_schedule: Callable | None = None, skip_nonfinite: int = 0):
        self.step = 0
        self.model = model
        # a distinct copy: evaluation reads it while the live module trains
        self.ema = copy.deepcopy(model).eval().requires_grad_(False)
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.skip_nonfinite = skip_nonfinite
        self.notfinite_count = torch.zeros((), device=next(model.parameters()).device)

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "ema": self.ema.state_dict(), "optimizer": self.optimizer.state_dict(),
                "notfinite_count": self.notfinite_count}

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"])
        self.ema.load_state_dict(sd["ema"])
        self.optimizer.load_state_dict(sd["optimizer"])
        # checkpoints written before the guard existed hold no count
        self.notfinite_count.copy_(torch.as_tensor(sd.get("notfinite_count", 0)))


@torch.no_grad()
def ema_update(ema: torch.nn.Module, model: torch.nn.Module, decay: float) -> None:
    """EMA <- EMA + (1 - decay)(params - EMA) over every parameter, frozen
    ones (the Fourier projection's W) included, as the JAX tree-lerp does."""
    torch._foreach_lerp_(list(ema.parameters()), list(model.parameters()), 1.0 - decay)


def applied_updates(optimizer: torch.optim.Optimizer) -> torch.Tensor:
    """The updates the optimizer has applied, on its parameters' device: its
    own step count, which a rejected step leaves where it was."""
    for param_state in optimizer.state.values():
        return param_state["step"]
    return torch.zeros((), device=optimizer.param_groups[0]["params"][0].device)


@torch.no_grad()
def _reject_nonfinite(state: TrainState) -> torch.Tensor:
    """1.0 when this step's update is to be rejected, else 0.0, on the
    device: the gradients hold a non-finite value and at most
    ``skip_nonfinite`` consecutive steps have (this one included)."""
    grads = [p.grad for g in state.optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    found = torch.zeros((), device=state.notfinite_count.device)
    # AMP's multi-tensor check: sets ``found`` on a NaN or inf; the scale of 1 leaves grads as
    # they are
    torch._amp_foreach_non_finite_check_and_unscale_(grads, found, torch.ones_like(found))
    state.notfinite_count.add_(1).mul_(found)  # consecutive non-finite steps, 0 on a finite one
    return found * (state.notfinite_count <= state.skip_nonfinite)


def apply_updates(state: TrainState, ema_decay: float = 0.999) -> None:
    """One optimizer update from the gradients in ``.grad`` (rejected by the
    guard when it is armed and they are not finite), then the EMA."""
    optimizer = state.optimizer
    # the fused optimizer reads ``found_inf``; a guard disarmed later must not leave it set
    optimizer.found_inf = _reject_nonfinite(state) if state.skip_nonfinite else None
    if state.lr_schedule is not None:
        lr = state.lr_schedule(applied_updates(optimizer))
        for group in optimizer.param_groups:
            group["lr"] = lr
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    ema_update(state.ema, state.model, ema_decay)
    state.step += 1


def cosine_annealing(lr: float, max_steps: int, eta_min: float = 0.0) -> Callable:
    """optax ``cosine_decay_schedule`` in closed form:
    eta_min + (lr - eta_min)(1 + cos(pi min(t, T) / T)) / 2, in f32 on the
    device of ``t`` (the optimizer's count, which stays there)."""
    alpha = eta_min / lr if lr else 0.0

    def schedule(count):
        count = torch.as_tensor(count, dtype=torch.float32)
        cos = torch.cos(count.clamp(max=max_steps) * (math.pi / max_steps))
        return lr * ((1 - alpha) * 0.5 * (1 + cos) + alpha)

    return schedule


def make_optimizer(name: str, model: torch.nn.Module, learning_rate: float,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """optax's ``adam`` or ``adamw`` (its defaults) over the trainable
    parameters, fused (one multi-tensor kernel a step, and the guard's
    ``found_inf``).

    ``adamw`` decays decoupled from the gradient, as optax ``adamw`` does
    (``scale_by_adam``, then ``add_decayed_weights``, then the learning
    rate); ``weight_decay`` is passed explicitly, torch's default being
    1e-2.  The JAX mask keeps the frozen Fourier ``W`` out of the decay;
    here ``W`` is not in the optimizer at all, which gives the same update.
    ``radam`` comes with the recipes that use it."""
    params = [p for p in model.parameters() if p.requires_grad]
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate, fused=True)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate, weight_decay=weight_decay, fused=True)
    raise ValueError(f"optimizer {name!r} is not ported yet (have: 'adam', 'adamw')")
