"""Batch generation as ``generate-waveforms`` runs it: one batch after another
(a closed loop), each ``InferenceBundle.generate(cond, noise=, init_phase=)``
of the bundle that ``build_inference`` assembles, copied to host memory.  The
host issues the next batches while the card works (``Delivery``), so the
card, not the host, sets the pace.

Traffic keys: ``batch``, ``solver`` (``heun`` or ``dpmpp_2m``), ``num_steps``,
``griffin_lim_iters`` (spectrogram recipes), ``check_rows_per_batch`` (rows of
every batch kept for the comparison), ``check_rows`` (how many of those are
compared), ``reference_block`` (rows the reference samples at once),
``trace_batches``.

Correctness: the kept rows' signal (the sampler's output, decoded for a
latent recipe) against the reference's chain from the same noise and
conditioning (``signal_err``), and their waveforms against the reference's
inversion of the program's own signal (``wave_err``), which checks the
inversion on its own.
"""

from __future__ import annotations

import collections
import contextlib
import math
import sys
import time

import numpy as np
import torch

from portbench.harness import checks, flops, inputs, trace
from portbench.reference import diffusion as ref_diffusion
from portbench.reference import lowp, nets
from portbench.reference import shapes as ref_shapes
from portbench.reference import signal as ref_signal

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
STREAM_WEIGHTS, STREAM_BATCH, STREAM_ROWS, STREAM_PICK = 1, 2, 3, 4
IN_FLIGHT = 3  # batches whose host copies may be outstanding


def build(cell, ctx, int8: bool = False):
    """The bundle ``build_inference`` assembles, with the benchmark's weights."""
    from tqdne_tpu_torch.cli import common

    cfg, tr = cell.config, cell.traffic
    extra = {"gl_iters": tr["griffin_lim_iters"]} if "griffin_lim_iters" in tr else {}
    bundle = common.build_inference(cfg["recipe"], dtype=DTYPES[cfg["dtype"]],
                                    num_steps=tr["num_steps"], solver=tr["solver"],
                                    device=ctx.device, tiny=cfg.get("tiny", False), int8=int8,
                                    **extra)
    if tuple(bundle.model_shape) != tuple(cfg["model_shape"]):
        raise SystemExit(f"the port samples {bundle.model_shape}, the configuration "
                         f"{cfg['model_shape']}")
    inputs.load_weights(reference_weights(cell, ctx), [bundle.unet, bundle.autoencoder])
    if "unet_parameters" in cfg:
        count = sum(p.numel() for p in bundle.unet.parameters())
        if count != cfg["unet_parameters"]:
            raise SystemExit(f"the port's UNet has {count} parameters, the configuration "
                             f"{cfg['unet_parameters']}")
    return bundle


def batch_inputs(cell, ctx, model_shape, b: int):
    """(noise, cond, init_phase or None) of batch ``b`` (-1: the warm-up)."""
    tr, cfg = cell.traffic, cell.config
    gen = inputs.generator(ctx.device, ctx.seed, STREAM_BATCH, b)
    n = tr["batch"]
    noise = torch.randn((n, *model_shape), generator=gen, device=ctx.device)
    cond = inputs.cond_rows(gen, n, ctx.device)
    phase = None
    if "griffin_lim_iters" in tr:
        sig = cfg["signal"]
        bins, frames = sig["stft_channels"] // 2 + 1, sig["t"] // sig["hop_size"] + 1
        phase = 2 * math.pi * torch.rand((n, sig["channels"], bins, frames), generator=gen,
                                         device=ctx.device)
    return noise, cond, phase


def kept_rows(cell, ctx, b: int) -> np.ndarray:
    tr = cell.traffic
    rng = np.random.default_rng(inputs.sub_seed(ctx.seed, STREAM_ROWS, b))
    return np.sort(rng.choice(tr["batch"], tr["check_rows_per_batch"], replace=False))


class Delivery:
    """Each batch's waveforms copied to host memory without the host waiting
    for the card: the copy goes behind the batch's own work into one of
    ``IN_FLIGHT`` host buffers (pinned on a card), and a buffer is read, and
    used again, only once the card has finished its copy.  So the host issues
    the next batches while the card works, and a stall of the host's is
    absorbed by the work already queued."""

    def __init__(self, device, shape, dtype, on_host):
        self.cuda = device.type == "cuda"
        self.buffers = [torch.empty(shape, dtype=dtype, pin_memory=self.cuda)
                        for _ in range(IN_FLIGHT)]
        self.on_host = on_host  # called with (batch, its waveforms as a numpy array)
        self.pending = collections.deque()
        self.sent = 0

    def send(self, b: int, wave: torch.Tensor) -> None:
        if len(self.pending) == IN_FLIGHT:
            self.receive()
        buf = self.buffers[self.sent % IN_FLIGHT]
        buf.copy_(wave, non_blocking=self.cuda)
        done = torch.cuda.Event() if self.cuda else None
        if done is not None:
            done.record()
        self.pending.append((b, buf, done))
        self.sent += 1

    def receive(self) -> None:
        b, buf, done = self.pending.popleft()
        if done is not None:
            done.synchronize()
        self.on_host(b, buf.numpy())

    def drain(self) -> None:
        while self.pending:
            self.receive()


def run(cell, ctx):
    from tqdne_tpu_torch.nn import attention as attention_module

    from portbench.harness.context import Result

    tr = cell.traffic
    bundle = build(cell, ctx, int8=ctx.control == "int8")
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
            rows = kept_rows(cell, ctx, b)
            kept.append((b, rows, kept_signal.pop(b), torch.from_numpy(host[rows].copy())))

    delivery = None

    def one_batch(b: int, events: list | None = None) -> float:
        """Issue batch ``b`` (-1: the warm-up) and its host copy; returns the
        host seconds spent issuing ``generate``."""
        nonlocal bad, delivery
        noise, cond, phase = batch_inputs(cell, ctx, model_shape, b)
        if events is not None:  # CUDA events around the call, to check the profiler's sums
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        t0 = time.perf_counter()
        wave = bundle.generate(cond, noise=noise, init_phase=phase)
        issue = time.perf_counter() - t0
        if events is not None:
            events[-1][1].record()
        if ctx.fault == "answer_altered":
            wave = wave.roll(1, dims=0)  # each answer delivered to the next request
        bad += (~torch.isfinite(wave).flatten(1).all(dim=1)).sum()
        if b >= 0:
            rows = torch.from_numpy(kept_rows(cell, ctx, b))
            if ctx.device.type == "cuda":
                rows = rows.pin_memory()
            idx = rows.to(ctx.device, non_blocking=True)
            kept_signal[b] = last["signal"].index_select(0, idx).float()
        if delivery is None:
            delivery = Delivery(ctx.device, wave.shape, wave.dtype, on_host)
        delivery.send(b, wave)
        return issue

    one_batch(-1)  # warm-up: every shape of the cell, every library built, the host buffers
    delivery.drain()
    res = Result(unit_size=tr["batch"])
    ctx.window_opens()
    if not ctx.trace:
        # batches are issued until the time is up; the window closes once the
        # card has finished all of them and their copies have reached the host
        t0 = time.perf_counter()
        b = 0
        while True:
            one_batch(b)
            b += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        delivery.drain()
        res.window_s = time.perf_counter() - t0
        res.units = b
    else:
        n = tr["trace_batches"]
        events = [] if ctx.device.type == "cuda" else None
        issue = [one_batch(b, events=events) for b in range(n)]
        delivery.drain()
        rec = trace.Recorder()
        instrument(bundle, rec)
        last["traced"] = True
        ctx.synchronize()
        with trace.wrapped_attention(attention_module, rec), trace.profiler() as prof:
            t0 = time.perf_counter()
            for b in range(n, 2 * n):
                one_batch(b)
            delivery.drain()
            ctx.synchronize()
            res.window_s = time.perf_counter() - t0
        res.units = n
        red = trace.reduce(trace.trace_events(prof))
        if events:
            span = red["span_ms"]
            print(f"device ms a batch: CUDA events around generate "
                  f"{sum(a.elapsed_time(e) for a, e in events) / n:.1f} (untraced), the "
                  f"profiler's sample and invert spans "
                  f"{(span.get('pb.sample', 0) + span.get('pb.invert', 0)) / n:.1f} (traced), "
                  f"busy {1e3 * red['busy_s'] / n:.1f}; kernel time attributed to a launch "
                  f"{red['attributed']}", file=sys.stderr)
        res.layer = {"issue_ms": 1e3 * sum(issue) / len(issue), "trace": red,
                     "model_flops": batch_flops(cell) * n, "gn_bytes": rec.gn_bytes,
                     "attn_flops": rec.attn_flops, "attn_bytes": rec.attn_bytes}
    ctx.window_closed()
    res.failed = int(bad)
    bundle.sample = sample
    del bundle, last, delivery
    ctx.free()
    res.readings = compare(cell, ctx, kept)
    return res


def instrument(bundle, rec) -> None:
    """Spans around the decoder's ``decode``, the bundle's ``invert`` and every
    ``Norm32`` forward (the sample span is the caller's)."""
    from tqdne_tpu_torch.nn.layers import Norm32

    for m in (bundle.unet, bundle.autoencoder):
        if m is not None:
            trace.wrap_norms(m, rec, Norm32)
    if bundle.autoencoder is not None:
        decode = bundle.autoencoder.decode

        def traced_decode(z):
            with trace.span("pb.decode"):
                return decode(z)

        bundle.autoencoder.decode = traced_decode
    invert_signal = bundle.invert

    def traced_invert(signal, **kw):
        with trace.span("pb.invert"):
            return invert_signal(signal, **kw)

    bundle.invert = traced_invert


def batch_flops(cell) -> int:
    """Model FLOPs of one batch: the sampler's UNet evaluations and the decode."""
    tr, cfg = cell.traffic, cell.config
    b, spatial = tr["batch"], cfg["model_shape"][:-1]
    evals = 2 * tr["num_steps"] - 1 if tr["solver"] == "heun" else tr["num_steps"]
    model = evals * sum(flops.unet_forward(cfg["unet"], b, spatial).values())
    if "autoencoder" in cfg:
        model += flops.decoder_forward(cfg["autoencoder"]["decoder"], b, spatial)
    return model


def compare(cell, ctx, kept) -> dict:
    """``signal_err`` and ``wave_err`` over a seeded sample of the kept rows."""
    tr, cfg = cell.traffic, cell.config
    total = sum(len(rows) for _, rows, _, _ in kept)
    pick = np.random.default_rng(inputs.sub_seed(ctx.seed, STREAM_PICK)).permutation(total)
    chosen = set(pick[: tr["check_rows"]].tolist())
    prog_sig, prog_wave, noise, cond, phase = [], [], [], [], []
    i = 0
    for b, rows, sig, wave in kept:
        take = [j for j in range(len(rows)) if i + j in chosen]
        i += len(rows)
        if not take:
            continue
        n, c, p = batch_inputs(cell, ctx, cfg["model_shape"], b)
        idx = torch.tensor(rows[take], device=ctx.device)
        prog_sig.append(sig[take])
        prog_wave.append(wave[take])
        noise.append(n.index_select(0, idx))
        cond.append(c.index_select(0, idx))
        phase.append(None if p is None else p.index_select(0, idx))
    prog_sig, prog_wave = torch.cat(prog_sig), torch.cat(prog_wave)
    noise, cond = torch.cat(noise), torch.cat(cond)
    phase = None if phase[0] is None else torch.cat(phase)
    with checks.reference_precision(grad=False):
        P = reference_weights(cell, ctx)
        ref_sig = []
        block = tr["reference_block"]
        for s in range(0, len(noise), block):
            ref_sig.append(reference_signal(cell, P, noise[s:s + block], cond[s:s + block]))
        ref_sig = torch.cat(ref_sig)
        rnd = lowp.bf16 if ctx.control == "lowp_inverse" else None
        ref_wave = invert(cell, prog_sig, phase)
        if rnd is not None:  # the reference's inversion one precision down, in the program's place
            prog_wave = invert(cell, prog_sig, phase, rnd).cpu()
    return {"signal_err": checks.rel_gap_rows(prog_sig, ref_sig),
            "wave_err": checks.rel_gap_rows(prog_wave, ref_wave)}


def reference_weights(cell, ctx) -> dict:
    """The benchmark's weights made again from the seed, by the reference's
    own parameter list (the published names)."""
    cfg = cell.config
    P = inputs.make_weights(ref_shapes.unet(cfg["unet"]),
                            inputs.generator(ctx.device, ctx.seed, STREAM_WEIGHTS, 0),
                            ctx.device, DTYPES[cfg["dtype"]], cfg["fourier_scale"])
    if "autoencoder" in cfg:
        P |= inputs.make_weights(ref_shapes.autoencoder(cfg["autoencoder"]),
                                 inputs.generator(ctx.device, ctx.seed, STREAM_WEIGHTS, 1),
                                 ctx.device)
    return P


def reference_signal(cell, P, noise, cond):
    cfg, tr = cell.config, cell.traffic

    def net(x, t):
        return nets.unet(P, cfg["unet"], x, t, cond)

    solve = ref_diffusion.heun if tr["solver"] == "heun" else ref_diffusion.dpmpp_2m
    z = solve(net, noise, tr["num_steps"])
    if "autoencoder" in cfg:
        return nets.decode(P, cfg["autoencoder"]["decoder"], z)
    return z


def invert(cell, signal, phase, rnd=None):
    """Channels-last signal -> (B, 3, t) waveforms by the reference."""
    cfg, tr = cell.config, cell.traffic
    sig = signal.movedim(-1, 1).float()
    if cfg["signal"]["kind"] == "log_spectrogram":
        s = cfg["signal"]
        return ref_signal.spectrogram_inverse(sig, phase, n_fft=s["stft_channels"],
                                              hop=s["hop_size"], length=s["t"],
                                              n_iter=tr["griffin_lim_iters"], rnd=rnd)
    if rnd is None:
        return ref_signal.envelope_inverse(sig)
    return rnd(ref_signal.envelope_inverse(rnd(sig)))
