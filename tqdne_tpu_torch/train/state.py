"""Train state: the port of ``tqdne_tpu/train/state.py``.

The JAX ``TrainState`` is one pytree (step, params, EMA params, optax
state) that each jitted step replaces.  Here it is one object that the step
updates in place: the live module, an EMA copy of it, the optimizer and the
learning-rate schedule, which is evaluated in closed form at the
pre-increment step, as optax evaluates a schedule at its update count.
"""

from __future__ import annotations

import copy
import math
from typing import Callable

import torch


class TrainState:
    """step + the live module + its EMA copy + the optimizer (and schedule)."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 lr_schedule: Callable[[int], float] | None = None):
        self.step = 0
        self.model = model
        # a distinct copy: evaluation reads it while the live module trains
        self.ema = copy.deepcopy(model).eval().requires_grad_(False)
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "ema": self.ema.state_dict(), "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"])
        self.ema.load_state_dict(sd["ema"])
        self.optimizer.load_state_dict(sd["optimizer"])


@torch.no_grad()
def ema_update(ema: torch.nn.Module, model: torch.nn.Module, decay: float) -> None:
    """EMA <- EMA + (1 - decay)(params - EMA) over every parameter, frozen
    ones (the Fourier projection's W) included, as the JAX tree-lerp does."""
    torch._foreach_lerp_(list(ema.parameters()), list(model.parameters()), 1.0 - decay)


def apply_updates(state: TrainState, ema_decay: float = 0.999) -> None:
    """One optimizer update from the gradients in ``.grad``, then the EMA."""
    if state.lr_schedule is not None:
        lr = state.lr_schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    ema_update(state.ema, state.model, ema_decay)
    state.step += 1


def cosine_annealing(lr: float, max_steps: int, eta_min: float = 0.0) -> Callable[[int], float]:
    """optax ``cosine_decay_schedule`` in closed form:
    eta_min + (lr - eta_min)(1 + cos(pi min(t, T) / T)) / 2."""
    alpha = eta_min / lr if lr else 0.0

    def schedule(count: int) -> float:
        frac = min(count, max_steps) / max_steps
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)

    return schedule


def make_optimizer(name: str, model: torch.nn.Module, learning_rate: float) -> torch.optim.Optimizer:
    """Adam over the trainable parameters (the flagship recipe's optimizer;
    optax ``adam``'s defaults).  ``adamw`` with its frozen-``W`` decay mask
    and ``radam`` come with the recipes that use them."""
    if name != "adam":
        raise ValueError(f"optimizer {name!r} is not ported yet (have: 'adam')")
    return torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=learning_rate)
