"""Batch generation with the ``latent_dit`` recipe, as ``generate-waveforms
--config latent_dit`` runs it: the closed loop, inputs, host delivery and row
sampling of ``kinds/generate.py`` (``Delivery``, ``batch_inputs``,
``kept_rows``, ``instrument``, ``invert``), around the bundle that
``build_inference`` assembles with the DiT as its denoiser.

Traffic keys: those of ``generate``.  A run of zero seconds (one batch, as
``control.py`` makes them) keeps ``check_rows`` rows of it, so it compares as
many rows as a timed run.

Correctness: ``signal_err`` and ``wave_err`` as ``generate`` defines them,
against ``reference/dit.py`` through the reference's sampler,
``reference/nets.py:decode`` and ``reference/signal.py``, in blocks of
``reference_block`` rows.  Controls: ``lowp_reference`` puts the reference's
chain with both operands of every product in fp8 e4m3 in the program's place
for ``signal_err``; ``lowp_inverse`` as ``generate``.

The window: on a card, after ``WARMUP_BATCHES`` more warm-up batches, batches
are issued until those issued end half a batch or more past ``--seconds``, and
the window closes when the last has reached host memory.

The program's counters are checked on every run: ``DiT.forwards`` rises by
the sampler's evaluations for each batch, and on a card the flash kernel's
``launches`` by the DiT's depth for each forward; a run that breaks either
exits.  The traced window reduces the program's ``tq::`` spans with the
benchmark's ``pb.`` ones and records the evaluations it ran.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from portbench.harness import checks, dit_flops, flops, inputs, registry, trace
from portbench.reference import diffusion as ref_diffusion
from portbench.reference import dit as ref_dit
from portbench.reference import lowp, nets
from portbench.reference import shapes as ref_shapes

gen = registry.kind("generate")

# The DiT holds the card at its power limit, where its clocks fall as it warms: a window
# opened on a card cooled by the set-up ran up to 1% faster than one opened warm.  So the
# warm-up goes on for WARMUP_BATCHES batches more (about 25 s at 4.2 s a batch), and every
# window opens near the temperature that the load holds.  A count and not a time, so that
# the set-up does not gain or lose a batch between runs.
WARMUP_BATCHES = 6


def evaluations(tr: dict) -> int:
    return 2 * tr["num_steps"] - 1 if tr["solver"] == "heun" else tr["num_steps"]


def build(cell, ctx):
    """The bundle of ``build_inference("latent_dit")`` with the seed's weights
    in its DiT and autoencoder, the DiT's parameters counted."""
    from tqdne_tpu_torch.cli import common

    cfg, tr = cell.config, cell.traffic
    bundle = common.build_inference(cfg["recipe"], dtype=gen.DTYPES[cfg["dtype"]],
                                    num_steps=tr["num_steps"], solver=tr["solver"],
                                    gl_iters=tr["griffin_lim_iters"], device=ctx.device,
                                    tiny=cfg.get("tiny", False))
    if tuple(bundle.model_shape) != tuple(cfg["model_shape"]):
        raise SystemExit(f"the port samples {bundle.model_shape}, the configuration "
                         f"{cfg['model_shape']}")
    inputs.load_weights(reference_weights(cell, ctx), [bundle.unet, bundle.autoencoder])
    count = sum(p.numel() for p in bundle.unet.parameters())
    if "dit_parameters" in cfg and count != cfg["dit_parameters"]:
        raise SystemExit(f"the port's DiT has {count} parameters, the configuration "
                         f"{cfg['dit_parameters']}")
    return bundle


def reference_weights(cell, ctx) -> dict:
    """The DiT's weights (rounded to the served dtype) and the autoencoder's,
    drawn from the seed by the reference's parameter lists."""
    cfg = cell.config
    P = inputs.make_weights(ref_dit.shapes(cfg["dit"]),
                            inputs.generator(ctx.device, ctx.seed, gen.STREAM_WEIGHTS, 0),
                            ctx.device, gen.DTYPES[cfg["dtype"]], cfg["fourier_scale"])
    P |= inputs.make_weights(ref_shapes.autoencoder(cfg["autoencoder"]),
                             inputs.generator(ctx.device, ctx.seed, gen.STREAM_WEIGHTS, 1),
                             ctx.device)
    return P


def reference_signal(cell, P, noise, cond, ops=None):
    cfg, tr = cell.config, cell.traffic

    def net(x, t):
        return ref_dit.dit(P, cfg["dit"], x, t, cond, ops)

    solve = ref_diffusion.heun if tr["solver"] == "heun" else ref_diffusion.dpmpp_2m
    return nets.decode(P, cfg["autoencoder"]["decoder"], solve(net, noise, tr["num_steps"]), ops)


def batch_flops(cell) -> int:
    """Model FLOPs of one batch: the sampler's DiT evaluations and the decode."""
    cfg, tr = cell.config, cell.traffic
    b = tr["batch"]
    model = evaluations(tr) * sum(dit_flops.forward(cfg["dit"], b).values())
    return model + flops.decoder_forward(cfg["autoencoder"]["decoder"], b,
                                         cfg["model_shape"][:-1])


class Counters:
    """The program's ``DiT.forwards`` and flash ``launches`` since ``start``."""

    def __init__(self, cell, ctx):
        from tqdne_tpu_torch.models.dit import DiT
        from tqdne_tpu_torch.ops.flash_attention import flash_attention

        self.dit, self.flash, self.cuda = DiT, flash_attention, ctx.device.type == "cuda"
        self.depth, self.evals = cell.config["dit"]["depth"], evaluations(cell.traffic)
        self.start()

    def start(self):
        self.forwards0, self.launches0 = self.dit.forwards, self.flash.launches

    def check(self, batches: int) -> int:
        """The forwards since ``start``; exits unless they and the launches
        are what ``batches`` batches need."""
        forwards = self.dit.forwards - self.forwards0
        launches = self.flash.launches - self.launches0
        if forwards != batches * self.evals:
            raise SystemExit(f"DiT.forwards rose by {forwards} over {batches} batches of "
                             f"{self.evals} evaluations")
        if self.cuda and launches != self.depth * forwards:
            raise SystemExit(f"{launches} flash launches over {forwards} DiT forwards of depth "
                             f"{self.depth}")
        return forwards


def run(cell, ctx):
    from tqdne_tpu_torch.nn import attention as attention_module

    from portbench.harness.context import Result

    tr = cell.traffic
    if ctx.seconds <= 0:  # one batch: it holds the rows a run compares
        cell.traffic = tr = tr | {"check_rows_per_batch": tr["check_rows"]}
    bundle = build(cell, ctx)
    model_shape = bundle.model_shape
    last = {}
    sample = bundle.sample

    def sample_kept(cond, **kw):
        with trace.span("pb.sample") if last.get("traced") else contextlib.nullcontext():
            last["signal"] = sample(cond, **kw)
        return last["signal"]

    bundle.sample = sample_kept
    bad = torch.zeros((), dtype=torch.int64, device=ctx.device)
    kept, kept_signal = [], {}

    def on_host(b: int, host: np.ndarray) -> None:
        if b >= 0:
            rows = gen.kept_rows(cell, ctx, b)
            kept.append((b, rows, kept_signal.pop(b), torch.from_numpy(host[rows].copy())))

    delivery = None

    def one_batch(b: int) -> float:
        """Issue batch ``b`` (-1: the warm-up) and its host copy; returns the
        host seconds spent issuing ``generate``."""
        nonlocal bad, delivery
        noise, cond, phase = gen.batch_inputs(cell, ctx, model_shape, b)
        t0 = time.perf_counter()
        wave = bundle.generate(cond, noise=noise, init_phase=phase)
        issue = time.perf_counter() - t0
        bad += (~torch.isfinite(wave).flatten(1).all(dim=1)).sum()
        if b >= 0:
            rows = torch.from_numpy(gen.kept_rows(cell, ctx, b))
            if ctx.device.type == "cuda":
                rows = rows.pin_memory()
            idx = rows.to(ctx.device, non_blocking=True)
            kept_signal[b] = last["signal"].index_select(0, idx).float()
        if delivery is None:
            delivery = gen.Delivery(ctx.device, wave.shape, wave.dtype, on_host)
        delivery.send(b, wave)
        return issue

    one_batch(-1)  # warm-up: every shape of the cell, every library built, the host buffers
    if ctx.seconds > 0 and ctx.device.type == "cuda":
        for _ in range(WARMUP_BATCHES):
            one_batch(-1)
    delivery.drain()
    counters = Counters(cell, ctx)
    res = Result(unit_size=tr["batch"])
    ctx.window_opens()
    if not ctx.trace:
        t0 = time.perf_counter()
        b = 0
        while True:  # until the batches issued end half a batch or more past the mark, so
            one_batch(b)  # that a run a little slower or faster does not drop or add one
            b += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= ctx.seconds + elapsed / b / 2:
                break
        delivery.drain()
        res.window_s = time.perf_counter() - t0
        res.units = b
        counters.check(b)
    else:
        n = tr["trace_batches"]
        issue = [one_batch(b) for b in range(n)]
        delivery.drain()
        counters.check(n)
        rec = trace.Recorder()
        gen.instrument(bundle, rec)
        last["traced"] = True
        ctx.synchronize()
        counters.start()
        with trace.wrapped_attention(attention_module, rec), trace.profiler() as prof:
            t0 = time.perf_counter()
            for b in range(n, 2 * n):
                one_batch(b)
            delivery.drain()
            ctx.synchronize()
            res.window_s = time.perf_counter() - t0
        res.units = n
        evals = counters.check(n)
        red = trace.reduce(trace.trace_events(prof), spans=("pb.", "tq::"))
        span = red["span_ms"]
        print(f"device ms an evaluation: modulate {span.get('tq::modulate', 0) / evals:.2f}, "
              f"mlp {span.get('tq::mlp', 0) / evals:.2f}, attn_proj "
              f"{span.get('tq::attn_proj', 0) / evals:.2f}, attention "
              f"{span.get('tq::attention', 0) / evals:.2f}, denoise "
              f"{span.get('tq::denoise', 0) / evals:.2f}; busy {1e3 * red['busy_s'] / n:.1f} "
              f"ms a batch", file=sys.stderr)
        esize = torch.finfo(gen.DTYPES[cell.config["dtype"]]).bits // 8
        res.layer = {"issue_ms": 1e3 * sum(issue) / len(issue), "trace": red, "evals": evals,
                     "model_flops": batch_flops(cell) * n, "gn_bytes": rec.gn_bytes,
                     "attn_flops": rec.attn_flops, "attn_bytes": rec.attn_bytes,
                     "modulate_bytes": evals * dit_flops.modulate_bytes(
                         cell.config["dit"], tr["batch"], esize)}
    ctx.window_closed()
    res.failed = int(bad)
    bundle.sample = sample
    del bundle, last, delivery
    ctx.free()
    res.readings = compare(cell, ctx, kept)
    return res


def compare(cell, ctx, kept) -> dict:
    """``signal_err`` and ``wave_err`` over a seeded sample of the kept rows."""
    tr, cfg = cell.traffic, cell.config
    total = sum(len(rows) for _, rows, _, _ in kept)
    pick = np.random.default_rng(inputs.sub_seed(ctx.seed, gen.STREAM_PICK)).permutation(total)
    chosen = set(pick[: tr["check_rows"]].tolist())
    prog_sig, prog_wave, noise, cond, phase = [], [], [], [], []
    i = 0
    for b, rows, sig, wave in kept:
        take = [j for j in range(len(rows)) if i + j in chosen]
        i += len(rows)
        if not take:
            continue
        n, c, p = gen.batch_inputs(cell, ctx, cfg["model_shape"], b)
        idx = torch.tensor(rows[take], device=ctx.device)
        prog_sig.append(sig[take])
        prog_wave.append(wave[take])
        noise.append(n.index_select(0, idx))
        cond.append(c.index_select(0, idx))
        phase.append(p.index_select(0, idx))
    prog_sig, prog_wave = torch.cat(prog_sig), torch.cat(prog_wave)
    noise, cond, phase = torch.cat(noise), torch.cat(cond), torch.cat(phase)
    with checks.reference_precision(grad=False):
        P = reference_weights(cell, ctx)
        ref_sig, low_sig = [], []
        block = tr["reference_block"]
        for s in range(0, len(noise), block):
            ref_sig.append(reference_signal(cell, P, noise[s:s + block], cond[s:s + block]))
            if ctx.control == "lowp_reference":  # the reference one precision down, in the
                low_sig.append(reference_signal(  # program's place
                    cell, P, noise[s:s + block], cond[s:s + block], nets.Ops(lowp=lowp.fp8)))
        ref_sig = torch.cat(ref_sig)
        ref_wave = gen.invert(cell, prog_sig, phase)
        if ctx.control == "lowp_inverse":  # the reference's inversion in bf16, in its place
            prog_wave = gen.invert(cell, prog_sig, phase, lowp.bf16).cpu()
    signal = torch.cat(low_sig) if low_sig else prog_sig
    return {"signal_err": checks.rel_gap_rows(signal, ref_sig),
            "wave_err": checks.rel_gap_rows(prog_wave, ref_wave)}
