"""Training steps as ``Trainer.fit`` calls them: each step seeds the step's
generator and the default one (dropout) from the run's seed and the step's
number, then calls the recipe's ``train_step(state, batch, generator=)`` on a
``TrainState`` (the live UNet, its EMA, Adam under the cosine schedule), one
batch after another from a ``DeviceResidentLoader`` over a synthetic set made
on the card from the seed.

Traffic keys: ``batch``, ``dataset_rows``, ``checked_steps`` (the set-up's
steps that the reference follows), ``reference_block`` (rows the reference
computes at once), ``trace_steps``.

Correctness: the set-up drives the same state through its first
``checked_steps`` steps with the window's own call and loader, and the
reference (float32, the same rows, draws and dropout masks) follows them.
Compared: each step's loss (``loss_gap``), the first gradient as Adam got
it, worked out from its first moment after one step (``grad_gap``), and the
parameters' and the EMA's change over the steps (``change_gap``,
``ema_gap``), by the worst leaf.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from portbench.harness import checks, flops, inputs, trace
from portbench.reference import diffusion as ref_diffusion
from portbench.reference import lowp, nets
from portbench.reference import shapes as ref_shapes
from portbench.reference import signal as ref_signal

STREAM_WEIGHTS, STREAM_DATA, STREAM_LOADER, STREAM_STEP = 1, 5, 6, 7
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ADAM_B1 = 0.9


class Rows:
    """A data set of arrays held in memory, as the loaders read one."""

    def __init__(self, arrays: dict):
        self.arrays = arrays

    def __len__(self) -> int:
        return len(self.arrays["cond"])

    def load_batch(self, idx, keys=None) -> dict:
        return {k: v[idx] for k, v in self.arrays.items() if keys is None or k in keys}


def weights(cell, ctx) -> dict:
    cfg = cell.config
    return inputs.make_weights(ref_shapes.unet(cfg["unet"]),
                               inputs.generator(ctx.device, ctx.seed, STREAM_WEIGHTS, 0),
                               ctx.device, torch.float32, cfg["fourier_scale"])


def data(cell, ctx):
    """(waveforms (n, 3, t), normalised cond (n, 5)) of the synthetic set."""
    return inputs.synthetic_waveforms(inputs.generator(ctx.device, ctx.seed, STREAM_DATA),
                                      cell.traffic["dataset_rows"], cell.config["signal"]["t"],
                                      ctx.device)


def loader_seed(ctx) -> int:
    return inputs.sub_seed(ctx.seed, STREAM_LOADER) % 2**31


def max_steps(cell) -> int:
    tr, tcfg = cell.traffic, cell.config["train"]
    return tcfg["epochs"] * (tr["dataset_rows"] // tr["batch"])


def seed_step(ctx, gen: torch.Generator, n: int) -> None:
    """Step ``n``'s draws: its generator (sigma, noise) and the default one
    (dropout), as ``Trainer`` seeds them."""
    gen.manual_seed(inputs.sub_seed(ctx.seed, STREAM_STEP, n, 0))
    torch.manual_seed(inputs.sub_seed(ctx.seed, STREAM_STEP, n, 1))


def build(cell, ctx):
    """(state, train_step, loader) as the train CLI assembles them."""
    from tqdne_tpu_torch.cli import common
    from tqdne_tpu_torch.data.pipeline import DeviceResidentLoader
    from tqdne_tpu_torch.train.state import TrainState, cosine_annealing, make_optimizer
    from tqdne_tpu_torch.train.steps import make_edm_steps

    cfg, tr, tcfg = cell.config, cell.traffic, cell.config["train"]
    recipe = common.RECIPES[cfg["recipe"]]
    config = recipe.config_cls(workdir=".")
    channels = cfg["model_shape"][-1]
    tiny = {"model_channels": cfg["unet"]["model_channels"]} if cfg.get("tiny") else {}
    with torch.device("meta"):
        unet, _ = common.build_unet(config, channels, channels, DTYPES[cfg["dtype"]],
                                    dims=recipe.dims, **tiny)
    unet = unet.to_empty(device=ctx.device)
    inputs.load_weights(weights(cell, ctx), [unet])
    if ctx.device.type == "cuda":
        unet = unet.to(memory_format=torch.channels_last)
    schedule = cosine_annealing(tcfg["learning_rate"], max_steps(cell))
    optimizer = make_optimizer(tcfg["optimizer"], unet, tcfg["learning_rate"])
    state = TrainState(unet, optimizer, schedule)
    train_step, _ = make_edm_steps(ema_decay=tcfg["ema_decay"])
    waves, cond = data(cell, ctx)
    signal = config.make_representation().get_representation(waves)
    rows = Rows({"signal": signal.cpu().numpy(), "cond": cond.cpu().numpy()})
    del waves, signal, cond
    loader = DeviceResidentLoader(rows, tr["batch"], keys=("signal", "cond"),
                                  seed=loader_seed(ctx), device=ctx.device)
    return state, train_step, loader


def batches(loader):
    while True:
        yield from loader


def run(cell, ctx):
    from tqdne_tpu_torch.nn.layers import Norm32

    from portbench.harness.context import Result

    tr = cell.traffic
    state, train_step, loader = build(cell, ctx)
    names = {p: n for n, p in state.model.named_parameters()}
    gen = torch.Generator(device=ctx.device)
    feed = batches(loader)
    bad = torch.zeros((), device=ctx.device)

    def step(n: int):
        nonlocal bad
        batch = next(feed)
        seed_step(ctx, gen, n)
        if ctx.fault == "half_batch":
            batch = {k: v[: len(v) // 2] for k, v in batch.items()}
        loss = train_step(state, batch, generator=gen)["loss"]
        bad += (~torch.isfinite(loss)).float() * tr["batch"]
        return loss

    # the set-up's steps, which the reference follows (and the warm-up)
    theta0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    losses = [step(0)]
    grad = {names[p]: float(s["exp_avg"].norm() / (1 - ADAM_B1))
            for p, s in state.optimizer.state.items()}
    for n in range(1, tr["checked_steps"]):
        losses.append(step(n))
    ema = dict(state.ema.named_parameters())
    program = {"losses": [float(x) for x in losses], "grad": grad,
               "delta": {n: p.detach() - theta0[n] for n, p in state.model.named_parameters()},
               "ema_delta": {n: ema[n] - theta0[n] for n in theta0}}
    del theta0, ema
    res = Result(unit_size=tr["batch"])
    ctx.window_opens()
    first = tr["checked_steps"]
    if not ctx.trace:
        t0, n, pending = time.perf_counter(), 0, None
        while True:
            step(first + n)
            n += 1
            pending = _wait_previous(ctx, pending)
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        ctx.synchronize()
        res.window_s, res.units = time.perf_counter() - t0, n
    else:
        rec = trace.Recorder()
        trace.wrap_norms(state.model, rec, Norm32)
        n = tr["trace_steps"]
        with trace.profiler() as prof:
            t0 = time.perf_counter()
            for i in range(n):
                with trace.span("pb.step"):
                    step(first + i)
            ctx.synchronize()
            res.window_s, res.units = time.perf_counter() - t0, n
        red = trace.reduce(trace.trace_events(prof),
                           extra_spans=("tq::group_norm_silu_backward",))
        model = flops.unet_train_step(cell.config["unet"], tr["batch"],
                                      cell.config["model_shape"][:-1])
        res.layer = {"trace": red, "model_flops": model * n, "gn_bytes": rec.gn_bytes}
    ctx.window_closed()
    res.failed = int(bad)
    del state, train_step, loader, feed, names
    ctx.free()
    if ctx.control == "lowp_reference":  # the reference one precision down, in the program's place
        program = reference_steps(cell, ctx, lowp.fp8)
    res.readings = compare(program, reference_steps(cell, ctx))
    return res


def _wait_previous(ctx, pending):
    """Keep one step queued ahead: wait for the previous step to finish and
    return this one's marker."""
    if ctx.device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    if pending is not None:
        pending.synchronize()
    return event


def dropout_masks(cell, ctx, batch: int) -> list:
    """The dropout masks of one step, drawn as the program draws them: from
    the default generator, in the forward's order, each over a tensor of the
    compute dtype laid out as the program's (channels last, viewed channels
    first)."""
    ucfg = cell.config["unet"]
    masks = []
    for shape in nets.res_block_shapes(ucfg, batch, tuple(cell.config["model_shape"][:-1])):
        ones = torch.ones((shape[0], *shape[2:], shape[1]), dtype=DTYPES[cell.config["dtype"]],
                          device=ctx.device).movedim(-1, 1)
        masks.append(F.dropout(ones, ucfg["dropout"], training=True) != 0)
    return masks


def reference_steps(cell, ctx, lowp_fn=None) -> dict:
    """The reference's losses, first gradient norms and changes over the
    checked steps, from the benchmark's inputs made again from the seed."""
    cfg, tr, tcfg = cell.config, cell.traffic, cell.config["train"]
    b, block = tr["batch"], tr["reference_block"]
    with checks.reference_precision(grad=True):
        P = weights(cell, ctx)
        theta0 = {k: v.clone() for k, v in P.items()}
        trainable = [k for k in P if not k.endswith(".W")]
        for k in trainable:
            P[k].requires_grad_(True)
        with torch.no_grad():
            waves, cond = data(cell, ctx)
            signal = ref_signal.envelope(waves).movedim(1, -1).contiguous()
            del waves
        perm = np.random.default_rng(loader_seed(ctx)).permutation(len(cond))
        adam = ref_diffusion.Adam({k: P[k] for k in trainable}, tcfg["learning_rate"],
                                  max_steps(cell))
        ema = {k: v.detach().clone() for k, v in P.items()}
        out = {"losses": []}
        gen = torch.Generator(device=ctx.device)
        for n in range(tr["checked_steps"]):
            idx = torch.from_numpy(perm[n * b:(n + 1) * b]).to(ctx.device)
            sample, c = signal.index_select(0, idx), cond.index_select(0, idx)
            seed_step(ctx, gen, n)
            sigma_eps = torch.randn((b,), generator=gen, device=ctx.device)
            noise = torch.randn(sample.shape, generator=gen, device=ctx.device)
            masks = dropout_masks(cell, ctx, b)
            total = 0.0
            for s in range(0, b, block):
                e = min(s + block, b)
                ops = nets.Ops(cfg["unet"]["dropout"], [m[s:e] for m in masks], lowp_fn)

                def net(x, t, c=c[s:e], ops=ops):
                    return nets.unet(P, cfg["unet"], x, t, c, ops)

                loss = ref_diffusion.loss(net, sample[s:e], sigma_eps[s:e], noise[s:e])
                (loss * (e - s) / b).backward()
                total += float(loss.detach()) * (e - s) / b
            out["losses"].append(total)
            grads = {k: P[k].grad for k in trainable}
            if n == 0:
                out["grad_t"] = {k: g.detach().clone() for k, g in grads.items()}
                out["grad"] = {k: float(g.norm()) for k, g in grads.items()}
            adam.update({k: P[k].data for k in trainable}, grads)
            for k in trainable:
                P[k].grad = None
            ref_diffusion.ema_update(ema, {k: v.detach() for k, v in P.items()},
                                     tcfg["ema_decay"])
        with torch.no_grad():
            out["delta"] = {k: P[k].detach() - theta0[k] for k in trainable}
            out["ema_delta"] = {k: ema[k] - theta0[k] for k in trainable}
    return out


def compare(program: dict, reference: dict) -> dict:
    """``loss_gap``: the worst step's relative loss gap; ``grad_gap``: the
    worst leaf's gap of first-gradient norms; ``change_gap``, ``ema_gap``: the
    worst leaf's gap of the norms of the parameters' and the EMA's change,
    over the entries whose reference gradient is at least a thousandth of the
    median leaf's root mean square (below, Adam moves an entry by round-off
    alone, as it moves the key's bias under the softmax)."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(program["losses"], reference["losses"]))
    if not all(np.isfinite(program["losses"])):
        loss_gap = float("inf")
    grads = reference["grad_t"]
    floor = 1e-3 * float(np.median([float(g.norm()) / g.numel() ** 0.5 for g in grads.values()]))
    change = {"delta": ({}, {}), "ema_delta": ({}, {})}
    for k, g in grads.items():
        moved = g.abs() >= floor
        if not moved.any():
            continue
        for key, (prog, ref) in change.items():
            prog[k] = float(program[key][k].to(g.device)[moved].norm())
            ref[k] = float(reference[key][k][moved].norm())
    return {"loss_gap": loss_gap,
            "grad_gap": checks.norm_gap(program["grad"], reference["grad"]),
            "change_gap": checks.norm_gap(*change["delta"]),
            "ema_gap": checks.norm_gap(*change["ema_delta"])}
