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
multi-tensor finiteness check feeds the optimizer's ``found_inf`` (the fused
Adam's and AdamW's, or the port's ``RAdam``), and nothing waits for the host.

Under a process group ``apply_updates`` first averages the gradients over
the world (``parallel.all_reduce_gradients_``), so every rank applies the
same update, the guard decides alike everywhere, and the optimizer, the
schedule and the EMA stay identical across ranks; every recipe's step ends
there.  Over an FSDP-sharded model (``parallel.fsdp``) the gradients are
DTensors that FSDP has averaged already, and the guard agrees over the
world on the shards each rank holds.
"""

from __future__ import annotations

import copy
import math
from typing import Callable

import torch

from tqdne_tpu_torch.parallel import all_reduce_gradients_, all_reduce_max_, spatial
from tqdne_tpu_torch.utils.tracing import span


class TrainState:
    """step + the live module + its EMA copy + the optimizer (and schedule),
    with the non-finite guard's count of consecutive non-finite steps.

    ``ema``: the EMA module, by default a frozen copy of ``model`` in eval
    mode (an FSDP-sharded model cannot be copied: ``parallel.fsdp.shard_with_ema``
    makes both)."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 lr_schedule: Callable | None = None, skip_nonfinite: int = 0,
                 ema: torch.nn.Module | None = None):
        self.step = 0
        self.model = model
        # a distinct copy: evaluation reads it while the live module trains
        self.ema = copy.deepcopy(model).eval().requires_grad_(False) if ema is None else ema
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
    sharded = [g for g in grads if hasattr(g, "to_local")]  # FSDP's DTensors
    if sharded:  # each rank checks the shards it holds
        grads = [g.to_local() if hasattr(g, "to_local") else g for g in grads]
    found = torch.zeros((), device=state.notfinite_count.device)
    # AMP's multi-tensor check: sets ``found`` on a NaN or inf; the scale of 1 leaves grads as
    # they are
    torch._amp_foreach_non_finite_check_and_unscale_(grads, found, torch.ones_like(found))
    if sharded:
        all_reduce_max_(found)
    state.notfinite_count.add_(1).mul_(found)  # consecutive non-finite steps, 0 on a finite one
    return found * (state.notfinite_count <= state.skip_nonfinite)


def apply_updates(state: TrainState, ema_decay: float = 0.999) -> None:
    """One optimizer update from the gradients in ``.grad`` (rejected by the
    guard when it is armed and they are not finite), then the EMA; under a
    process group the gradients are first averaged over the world (under
    ``spatial.spatial_scope`` summed over the model group and averaged over
    the data group)."""
    with span("update"):
        optimizer = state.optimizer
        scope = spatial.current()  # spatial: sum over the model group, average over data
        with span("allreduce"):
            all_reduce_gradients_([p for g in optimizer.param_groups for p in g["params"]],
                                  scope.data_size if scope is not None else None)
        # the optimizer reads ``found_inf``; a guard disarmed later must not leave it set
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


class RAdam(torch.optim.Optimizer):
    """optax ``radam`` (``scale_by_radam``, then the learning rate), over
    ``torch._foreach_*`` ops with no host sync:

        mu = b1 mu + (1 - b1) g,  nu = b2 nu + (1 - b2) g^2,  t = count + 1
        rho = rho_inf - 2 t b2^t / (1 - b2^t),  rho_inf = 2 / (1 - b2) - 1
        u = r mu_hat / (sqrt(nu_hat) + eps)  where rho >= 5, else u = mu_hat
        p = p - lr u

    with ``mu_hat``, ``nu_hat`` the bias-corrected moments and ``r`` the
    rectification.  eps sits where optax has it, on sqrt(nu_hat); torch's
    ``RAdam`` puts it on sqrt(nu), which at step 6 is 13x optax's eps.  The
    branch on rho is a pair of scalar coefficients on the device.

    Each parameter's state holds ``step`` (a float32 tensor on its device,
    which ``applied_updates`` reads), ``exp_avg`` and ``exp_avg_sq``, as
    torch's Adam keeps them.  ``found_inf`` (set by ``apply_updates`` when the
    guard is armed) is a 0-d tensor: where it is 1 no parameter, moment or
    count moves."""

    B1, B2, EPS, THRESHOLD = 0.9, 0.999, 1e-8, 5.0  # optax's defaults, which the JAX CLI uses

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RAdam takes no closure")
        found_inf = getattr(self, "found_inf", None)
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = self.B1, self.B2
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                elif state["step"].device != p.device:  # a count loaded onto the host
                    state["step"] = state["step"].to(p.device, torch.float32)
            grads = [p.grad for p in params]
            mus = [self.state[p]["exp_avg"] for p in params]
            nus = [self.state[p]["exp_avg_sq"] for p in params]
            steps = [self.state[p]["step"] for p in params]
            n = len(params)
            g2 = torch._foreach_mul(grads, grads)
            if found_inf is None:
                keep = torch.ones((), device=params[0].device)
                torch._foreach_lerp_(mus, grads, 1 - b1)
                torch._foreach_lerp_(nus, g2, 1 - b2)
            else:
                # a rejected step's gradients become zeros, and the moments' weights 0, so
                # every update below moves a finite value by 0
                keep = 1 - found_inf
                reject = found_inf.bool()
                grads = [torch.where(reject, 0.0, g) for g in grads]
                g2 = [torch.where(reject, 0.0, g) for g in g2]
                torch._foreach_lerp_(mus, grads, [(1 - b1) * keep] * n)
                torch._foreach_lerp_(nus, g2, [(1 - b2) * keep] * n)
            t = steps[0] + keep
            torch._foreach_copy_(steps, [t] * n)
            # a step rejected at count 0 leaves t = 0, where the bias corrections divide by
            # 0: the coefficients take t >= 1, so keep = 0 scales finite values
            t = t.clamp(min=1.0)
            rho_inf = 2.0 / (1.0 - b2) - 1.0
            b2t = b2**t
            rho = rho_inf - 2 * t * b2t / (1 - b2t)
            rect = (rho >= self.THRESHOLD).float()
            r = torch.sqrt(((rho - 4.0) * (rho - 2.0) * rho_inf
                            / ((rho_inf - 4.0) * (rho_inf - 2.0) * rho)).clamp(min=0.0))
            step_size = -torch.as_tensor(group["lr"], dtype=torch.float32, device=t.device) \
                * keep / (1 - b1**t)
            # p += mu (step_size rect r / (sqrt(nu_hat) + eps) + step_size (1 - rect))
            scale = torch._foreach_div(nus, [1 - b2t] * n)
            torch._foreach_sqrt_(scale)
            torch._foreach_add_(scale, self.EPS)
            torch._foreach_reciprocal_(scale)
            torch._foreach_mul_(scale, [step_size * rect * r] * n)
            torch._foreach_add_(scale, [step_size * (1 - rect)] * n)
            torch._foreach_addcmul_(params, mus, scale)
        return None


def make_optimizer(name: str, model: torch.nn.Module, learning_rate: float,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """optax's ``adam``, ``adamw`` or ``radam`` (its defaults) over the
    trainable parameters; Adam and AdamW fused (one multi-tensor kernel a
    step, and the guard's ``found_inf``), RAdam the port's own (``RAdam``).

    ``adamw`` decays decoupled from the gradient, as optax ``adamw`` does
    (``scale_by_adam``, then ``add_decayed_weights``, then the learning
    rate); ``weight_decay`` is passed explicitly, torch's default being
    1e-2.  The JAX mask keeps the frozen Fourier ``W`` out of the decay;
    here ``W`` is not in the optimizer at all, which gives the same update
    (and under optax ``radam`` its zero gradient moves it by 0)."""
    params = [p for p in model.parameters() if p.requires_grad]
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate, fused=True)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate, weight_decay=weight_decay, fused=True)
    if name == "radam":
        return RAdam(params, lr=learning_rate)
    raise ValueError(f"unknown optimizer {name!r} (have: 'adam', 'adamw', 'radam')")
