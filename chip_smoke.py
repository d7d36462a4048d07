"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the three CUDA sources of ``tqdne_tpu_torch/csrc`` (one nvcc each,
   in parallel);
2. hold each kernel against its plain PyTorch version on the card: GroupNorm
   (+SiLU) at every (S, C) that sampling's UNet and decoder, training's UNet
   and encoder, the evaluation classifier's encoder and the autoencoder and
   classifier recipes' train steps give it (read off one forward of each), in
   f32 and in each (x, scale) dtype pair the bf16 paths give that shape, SiLU
   on and off, at batch 32, 64 and 128, and in cases that force the launch
   plan's other
   variants (the largest cluster the card co-schedules, chunks re-read from
   L2, element loads, groups of 5 channels); the flash forward (output and
   base-2 log-sum-exp) and the two flash backward kernels (dQ with delta =
   rowsum(dO * O), then dK/dV with that delta), f32 and bf16, causal and not,
   at the main paths' (32, 16, 4, 128), (128, 16, 4, 128), the classifier's
   (32, 256, 4, 64) and its training step's (64, 256, 4, 64), at every L in
   (16, 17, 100, 256, 508) x D in
   (32, 64, 128) with q, k and v as strided views of one fused (B, L, 3, H, D)
   projection, and at the variants the bf16 tensor-core kernels take for
   other layouts: D = 40 (zero-padded to its head block of 64), D = 12 (2-byte
   loads and stores) and views one element into their buffers (2-byte loads);
3. full-width flagship sampling in f32, 2 Heun steps, once through the
   kernels and once through the plain versions: the decoded spectrograms
   must agree (TF32 off); the full-width f32 classifier the same way (its
   embeddings and logits); then one full-width f32 train step of each recipe
   (the flagship's frozen encoder, EDM loss and backward; the autoencoder's
   reconstruction and KL; the classifier's weighted cross-entropy through two
   attention blocks) with the same injected draws, in eval mode, both ways:
   the loss to 1e-5 relative and every parameter gradient to 1e-3 of its
   peak, with every flash backward through the kernels;
4. the main paths, each with the launch counters set to 0 just before it and
   read just after: sampling (``build_inference`` + ``generate`` at full width
   in bf16, batch 32, Heun-25 then dpmpp_2m-10, each with 32 Griffin-Lim
   iterations, seeded random weights; waveforms must be finite
   (32, 3, 4064)), training (``Trainer.fit`` through ``BatchLoader`` over
   in-memory synthetic waveforms, bf16 compute over f32 parameters, batch
   128, 30 steps; the loss must be finite), the recipes over the same 512
   waveforms (the autoencoder recipe, AdamW, batch 128, 20 steps; the
   classifier recipe, batch 64, 21 steps and one validation pass whose macro
   metrics must be finite; the precompute core over the waveforms with that
   autoencoder, then 30 flagship steps from the cached moments through
   ``DeviceResidentLoader``, with no encoder launch; 30 flagship steps with
   the representation on the device; the non-finite guard: a NaN batch
   leaves every parameter, the Adam moments and the update count as they
   were, the next clean batch moves them), serving (the HTTP server of
   ``tqdne_tpu_torch.serving`` on loopback over the dpmpp_2m-10 bundle: rounds
   of concurrent requests, a seeded request twice bit-identical and another
   seed different, coalescing) and evaluation (two ``evaluate_batch`` calls
   at the evaluate CLI's Heun-25 and Griffin-Lim 128 with the full-width
   bf16 classifier, then ``report_from_arrays``: FID, IS and ASD finite); the
   counts must be exact;
5. timings on the card: each kernel at the main paths' shapes beside its
   bound, its plain version and a PyTorch yardstick call (and, for the
   record, the bf16 flash forward at (128, 16, 4, 128)), GroupNorm per UNet
   eval, per train step and per classifier forward, end-to-end waveforms/s
   (through the server too, with request latencies and one round of JSON
   responses) and training samples/s, the guarded and the cached-latent
   flagship step against the plain flagship step in alternated single steps
   (issue and wall ms, device ms and launches of one profiled step), each
   recipe step's samples/s beside the flagship step's in alternate windows,
   the classifier train step's kernels at (64, 256, 4, 64) and its GroupNorm
   shapes, a profiled sampling run, a profiled classifier forward, and a
   profiled train step of the flagship, the classifier and the autoencoder
   by kernel class, and one train step at the recipe's batch 256.

Prints the card's name and power limit and a ``{"kernels": [...]}`` line,
then, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import math
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch
import torch.nn.functional as F

SEED = 0
BATCH = 32
E2E_RUNS = 3  # timed generate() calls per solver, the launch-counted one included
TRAIN_BATCH = 128  # the training benchmark's batch (bench_train.py)
TRAIN_STEPS = 30
TRAIN_E2E_RUNS, TRAIN_E2E_STEPS = 3, 8  # timed train_step windows for [train-e2e]
TRAIN_SAMPLES = 512  # synthetic waveforms in memory: 4 batches per epoch
CLF_TRAIN_BATCH = 64  # the classifier recipe's batch
AE_STEPS = 20  # Trainer.fit steps of the autoencoder recipe: 5 epochs of 4 batches
CLF_STEPS = 21  # of the classifier recipe: 3 epochs of 7 batches of its 460 rows, one validation
GUARD_N = 3  # skip_nonfinite of the guard's check and timing
STEP_PAIRS = 16  # alternated single-step pairs of the guard's and the cached step's cost
SERVE_CLIENTS, SERVE_ROWS, SERVE_ROUNDS = 16, 4, 3  # concurrent requests of 4 rows, 3 rounds
SERVE_DELAY_MS = 15.0  # the serve CLI's micro-batching window
SERVE_FULL_CLIENTS, SERVE_FULL_ROUNDS = 4, 2  # concurrent requests of a full batch, 2 rounds
EVAL_BATCHES = 2  # evaluate_batch calls at batch 32 (Heun-25, Griffin-Lim 128)
CLASSIFIER_SEED = SEED + 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 vector
GN_OPS_PER_ELEM = {True: 10, False: 7}  # moments 2, normalise+affine 4 (+1 store), SiLU 3
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1.6e-2, 1e-3)}  # rtol, atol
# flash backward: f32 takes the JAX package's own gradient bound
# (tests/test_flash_attention.py); bf16 outputs one bf16 step, as above
BWD_TOL = {torch.float32: (2e-3, 2e-4), torch.bfloat16: (1.6e-2, 1e-3)}


def log(msg: str):
    print(msg, flush=True)


def fail(msg: str):
    log(f"FAIL: {msg}")
    sys.exit(1)


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def issue_ms(fn, windows: int = 5, reps: int = 20) -> tuple[float, float]:
    """Per-call time of ``fn`` issued back to back, the median and the least
    over a few windows: at the UNet's shapes the host's issue rate sets it,
    and a lone window swings with the load on the shared host."""
    cuda_ms(fn, reps=1)  # warm-up
    times = [cuda_ms(fn, reps=reps, warmup=0) for _ in range(windows)]
    return statistics.median(times), min(times)


def device_kernels(prof) -> list:
    """The profiler's averaged CUDA kernel events.  A ``record_function``
    range (the GroupNorm backward's, the optimizer step's) is mirrored on the
    device timeline under its own name and spans kernels already counted:
    CUDA events named like a CPU-side user annotation are left out."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    ranges = {e.key for e in events
              if e.device_type == DeviceType.CPU and getattr(e, "is_user_annotation", False)}
    return [e for e in events if e.device_type == DeviceType.CUDA and e.key not in ranges]


def device_ms(fn, reps: int = 20, names: list | None = None) -> float:
    """Device time per call: the summed durations of the CUDA kernels ``fn``
    launches, from torch.profiler.  Event timing of back-to-back calls
    measures the host's issue rate instead when a call's kernels are shorter
    than its Python overhead, as they are at the UNet's shapes.  ``names``,
    when given, receives the kernels' names.

    Now and then the profiler loses some or all of a window's device records,
    which reads low, so three windows are taken and the time comes from those
    with the most kernel records (their median)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        windows.append((sum(e.count for e in kernels),
                        sum(e.self_device_time_total for e in kernels), kernels))
    most = max(w[0] for w in windows)
    if not most:
        fail("torch.profiler recorded no device time in three windows")
    full = sorted((w for w in windows if w[0] == most), key=lambda w: w[1])
    _, total_us, kernels = full[len(full) // 2]
    if names is not None:
        names.extend(e.key[:80] for e in kernels)
    return total_us / 1e3 / reps


def close(got, want, dtype, tol=TOL) -> tuple[float, bool]:
    rtol, atol = tol[dtype]
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all()) and bool(torch.isfinite(got).all())
    return err.max().item(), ok


def tol_share(got, want, dtype, tol) -> float:
    """The largest error as a share of what the tolerance allows there (<= 1 passes)."""
    rtol, atol = tol[dtype]
    err = (got.float() - want.float()).abs()
    return (err / (atol + rtol * want.float().abs())).max().item()


def qkv_views(b, length, h, d, dtype, layout, gen, dev):
    """q, k and v as the paths give them: ``fused``, strided views of one
    (B, L, 3, H, D) projection (the attention block's); ``separate``,
    contiguous tensors; ``offset``, views one element into their buffers,
    which no 16-byte load can read."""
    if layout == "fused":
        qkv = torch.randn(b, length, 3, h, d, generator=gen, device=dev).to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if layout == "offset":
        n = b * length * h * d
        return tuple(torch.randn(n + 1, generator=gen, device=dev).to(dtype)[1:]
                     .view(b, length, h, d) for _ in range(3))
    return tuple(torch.randn(b, length, h, d, generator=gen, device=dev).to(dtype)
                 for _ in range(3))


def check_flash_kernels(gen, dev, errs: dict, path_cases: list = ()) -> int:
    """The flash forward and both backward kernels against their plain
    versions, f32 and bf16, causal and not: at the main paths' shapes (and
    the (B, L, H, D) of ``path_cases``, read off a forward), at
    every L x D of the redesigned bf16 kernels' two variants as fused-qkv
    views, and in the layouts that take their narrow loads.  Records the
    largest errors in ``errs``; returns the number of failed checks."""
    from tqdne_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dkdv_plain,
        flash_attention_bwd_dq,
        flash_attention_bwd_dq_delta_plain,
        flash_attention_plain,
        tensor_core_plan,
    )

    errs |= {"flash_attention": 0.0, "flash_attention_bwd_dkdv": 0.0,
             "flash_attention_bwd_dq": 0.0}
    bad = 0
    bf16_share = {"flash_attention": 0.0, "flash_attention_bwd_dkdv": 0.0,
                  "flash_attention_bwd_dq": 0.0}
    flash_cases = [(BATCH, 16, 4, 128, "separate"), (TRAIN_BATCH, 16, 4, 128, "fused"),
                   (BATCH, 256, 4, 64, "fused")]
    flash_cases += [(*case, "fused") for case in dict.fromkeys(path_cases)]
    flash_cases += [(4, length, 4, d, "fused") for length in (16, 17, 100, 256, 508)
                    for d in (32, 64, 128)]
    flash_cases += [(4, 100, 4, 40, "fused"), (4, 17, 2, 12, "fused"), (4, 100, 2, 64, "offset")]
    for b_, length, h, d, layout in flash_cases:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                q, k, v = qkv_views(b_, length, h, d, dtype, layout, gen, dev)
                do = torch.randn(b_, length, h, d, generator=gen, device=dev).to(dtype)
                plan = tensor_core_plan(q, k, v) if dtype == torch.bfloat16 else "fma"
                label = (f"B={b_} L={length} H={h} D={d} {layout} {str(dtype)[6:]} "
                         f"causal={causal} plan={plan}")
                out, lse = flash_attention(q, k, v, causal, return_lse=True)
                want, want_lse = flash_attention_plain(q, k, v, causal, return_lse=True)
                err, ok = close(out, want, dtype)
                lse_err, lse_ok = close(lse, want_lse, torch.float32)
                errs["flash_attention"] = max(errs["flash_attention"], err)
                bad += not (ok and lse_ok)
                share = tol_share(out, want, dtype, TOL)
                if dtype == torch.bfloat16:
                    bf16_share["flash_attention"] = max(bf16_share["flash_attention"], share)
                log(f"[check] flash_attention {label}: max_abs_err={err:.3e} "
                    f"(share of tol {share:.3f}) tol={TOL[dtype]} lse_err={lse_err:.3e} "
                    f"tol={TOL[torch.float32]} {'ok' if ok and lse_ok else 'FAIL'}")
                # dQ first: it also forms delta, which dK/dV then reads, as on the path
                dq, delta = flash_attention_bwd_dq(q, k, v, do, want, want_lse, causal)
                want_dq, want_delta = flash_attention_bwd_dq_delta_plain(q, k, v, do, want,
                                                                         want_lse, causal)
                got = (dq, *flash_attention_bwd_dkdv(q, k, v, do, want_lse, delta, causal))
                ref = (want_dq, *flash_attention_bwd_dkdv_plain(q, k, v, do, want_lse,
                                                                want_delta, causal))
                results = [close(g, w, dtype, BWD_TOL) for g, w in zip(got, ref)]
                shares = [tol_share(g, w, dtype, BWD_TOL) for g, w in zip(got, ref)]
                delta_err, delta_ok = close(delta, want_delta, torch.float32)
                errs["flash_attention_bwd_dq"] = max(errs["flash_attention_bwd_dq"],
                                                     results[0][0])
                errs["flash_attention_bwd_dkdv"] = max(errs["flash_attention_bwd_dkdv"],
                                                       results[1][0], results[2][0])
                if dtype == torch.bfloat16:
                    bf16_share["flash_attention_bwd_dq"] = max(
                        bf16_share["flash_attention_bwd_dq"], shares[0])
                    bf16_share["flash_attention_bwd_dkdv"] = max(
                        bf16_share["flash_attention_bwd_dkdv"], *shares[1:])
                ok = all(r[1] for r in results) and delta_ok
                bad += not ok
                log(f"[check] flash backward {label}: max_abs_err dq={results[0][0]:.3e} "
                    f"dk={results[1][0]:.3e} dv={results[2][0]:.3e} (share of tol dq="
                    f"{shares[0]:.3f} dk={shares[1]:.3f} dv={shares[2]:.3f}; peak "
                    f"{max(w.float().abs().max().item() for w in ref):.3e}) "
                    f"tol(rtol,atol)={BWD_TOL[dtype]}; delta max_abs_err={delta_err:.3e} "
                    f"tol={TOL[torch.float32]} {'ok' if ok else 'FAIL'}")
    log(f"[check] {len(flash_cases) * 4} flash cases; largest bf16 error as a share of its "
        f"tolerance: {json.dumps(bf16_share)}")
    return bad


def check_group_norm_kernels(gen, dev, errs: dict, path_calls: list,
                             batches=(BATCH, TRAIN_BATCH)) -> int:
    """GroupNorm (+SiLU) against its plain version: at every (S, C, G) of
    ``path_calls`` (sampling's UNet and decoder, training's UNet and
    encoder, the autoencoder and classifier recipes'), in f32 and in each
    (x, scale) dtype pair the paths give that shape, SiLU on and off, at
    each of ``batches`` (the paths' batch sizes); then
    cases that force the plan's other variants: the largest cluster the card
    co-schedules, the re-read variant, element loads (views one element into
    their buffers, a C of 12 in bf16) and groups of 5 channels.  Records the
    largest error in ``errs``; returns the number of failed checks."""
    from tqdne_tpu_torch.ops.group_norm import (
        cluster_limit,
        group_norm_plan,
        group_norm_silu,
        group_norm_silu_plain,
    )

    f32, bf16 = torch.float32, torch.bfloat16
    limit = cluster_limit(torch.cuda.current_device())
    pairs = {}
    for x_dtype, p_dtype, s, c, g, _ in path_calls:
        pairs.setdefault((s, c, g), {(f32, f32)}).add((x_dtype, p_dtype))
    cases = [(b, s, c, g, dtype, pdtype, "path") for b in batches
             for (s, c, g), found in sorted(pairs.items())
             for dtype, pdtype in sorted(found, key=str)]
    def takes_largest(s):
        plan = group_norm_plan(2, s, 64, 32, bf16, bf16, True, limit)
        return plan.cluster == limit and plan.resident

    # the smallest slab that takes the largest cluster, still resident
    largest = next((s for s in range(16384, 1 << 18, 1024) if takes_largest(s)), None)
    if largest is None:
        fail(f"no GroupNorm shape plans a resident cluster of {limit}")
    forced = [(2, largest, 64, 32, bf16, bf16, "largest cluster"),
              (2, 65536, 64, 32, f32, f32, "re-read"),
              (BATCH, 1024, 128, 32, bf16, bf16, "offset"),
              (TRAIN_BATCH, 16384, 64, 32, bf16, f32, "offset"),
              (4, 4096, 64, 32, f32, f32, "offset"),
              (4, 100, 12, 4, bf16, bf16, "narrow C"),
              (4, 17, 40, 8, f32, f32, "groups of 5"),
              (4, 17, 40, 8, bf16, f32, "groups of 5")]
    errs["group_norm_silu"] = 0.0
    bad = 0
    log(f"[check] GroupNorm: clusters of up to {limit} blocks co-schedule on this card")
    for b, s, c, g, dtype, pdtype, case in cases + forced:
        n = b * s * c
        buf = (torch.randn(n + 1, generator=gen, device=dev) * 2 + 0.5).to(dtype)
        x = buf[1:].view(b, s, c) if case == "offset" else buf[:n].view(b, s, c)
        plan = group_norm_plan(b, s, c, g, dtype, pdtype, x.data_ptr() % 16 == 0, limit)
        want_variant = {"largest cluster": plan.cluster == limit and plan.resident,
                        "re-read": not plan.resident, "offset": plan.vec == 1,
                        "narrow C": plan.vec == 1}.get(case, True)
        for silu in (True, False):
            w = (1 + 0.1 * torch.randn(c, generator=gen, device=dev)).to(pdtype)
            bias = (0.1 * torch.randn(c, generator=gen, device=dev)).to(pdtype)
            err, ok = close(group_norm_silu(x, w, bias, g, 1e-5, silu),
                            group_norm_silu_plain(x, w, bias, g, 1e-5, silu), dtype)
            ok = ok and want_variant
            errs["group_norm_silu"] = max(errs["group_norm_silu"], err)
            bad += not ok
            log(f"[check] group_norm_silu B={b} S={s} C={c} G={g} x={str(dtype)[6:]} "
                f"scale={str(pdtype)[6:]} silu={silu} {case}: plan=({plan.slice_channels} ch x "
                f"{plan.slices}, cluster {plan.cluster} x {plan.chunk_rows} rows, "
                f"{plan.threads} threads, vec {plan.vec}, resident {plan.resident}, "
                f"{plan.smem} B) max_abs_err={err:.3e} tol(rtol,atol)={TOL[dtype]} "
                f"{'ok' if ok else 'FAIL'}")
    log(f"[check] {2 * len(cases + forced)} GroupNorm cases")
    return bad


KERNEL_CLASSES = (("group_norm_silu", ("group_norm_silu_kernel",)),
                  ("flash_attention", ("flash_fwd",)),
                  ("convolution", ("conv", "xmma", "cudnn", "implicit", "gemm", "cutlass")),
                  ("fft", ("fft",)))


def profile_breakdown(fn, label: str, tag: str = "profile") -> dict | None:
    """Device time of one ``fn()`` by kernel class, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = device_kernels(prof)
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not total_ms:
        log(f"[{tag}] the profiler recorded no device time: breakdown not measured")
        return None
    classes = {name: 0.0 for name, _ in KERNEL_CLASSES} | {"other": 0.0}
    counts = dict.fromkeys(classes, 0)
    for e in kernels:
        name = next((n for n, keys in KERNEL_CLASSES if any(k in e.key.lower() for k in keys)),
                    "other")
        classes[name] += e.self_device_time_total / 1e3
        counts[name] += e.count
    log(f"[{tag}] {label}: wall {wall_ms:.3f} ms under the profiler, device kernels "
        f"{total_ms:.3f} ms (busy share {total_ms / wall_ms:.3f}); by class (ms): "
        f"{json.dumps({k: round(v, 3) for k, v in classes.items()})}; kernels by class: "
        f"{json.dumps(counts)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:110]}")
    return dict(wall_ms=wall_ms, device_ms=total_ms, busy_share=total_ms / wall_ms, **classes)


TRAIN_CLASSES = (("group_norm_silu", ("group_norm_silu_kernel",)),
                 ("flash_fwd", ("flash_fwd",)),
                 ("flash_bwd_dkdv", ("flash_bwd_dkdv",)),
                 ("flash_bwd_dq", ("flash_bwd_dq",)),
                 ("convolution_gemm", ("conv", "xmma", "cudnn", "implicit", "gemm", "cutlass",
                                       "wgrad", "dgrad")),
                 ("optimizer_ema", ("multi_tensor", "foreach")))
GN_BWD_CLASS = "group_norm_silu_backward_plain"


def kernel_class(name: str) -> str:
    return next((n for n, keys in TRAIN_CLASSES if any(k in name.lower() for k in keys)),
                "other")


def train_profile(step, label: str):
    """Device time of one train step by kernel class.  The plain GroupNorm
    backward's kernels are found under its profiler range
    (``tq::group_norm_silu_backward``) and moved into their own class."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = device_kernels(prof)
    left_out = sorted({e.key for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA} - {e.key for e in kernels})
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launched = sum(e.count for e in kernels)
    if not total_ms:
        log("[train-profile] the profiler recorded no device time: breakdown not measured")
        return None
    classes = {name: 0.0 for name, _ in TRAIN_CLASSES} | {GN_BWD_CLASS: 0.0, "other": 0.0}
    for e in kernels:
        classes[kernel_class(e.key)] += e.self_device_time_total / 1e3
    found = []

    def walk(ev):
        found.extend(ev.kernels)
        for child in ev.cpu_children:
            walk(child)

    ranges = [ev for ev in prof.events()
              if ev.name == "tq::group_norm_silu_backward" and ev.device_type == DeviceType.CPU]
    for ev in ranges:
        walk(ev)
    for k in found:
        classes[kernel_class(k.name)] -= k.duration / 1e3
        classes[GN_BWD_CLASS] += k.duration / 1e3
    log(f"[train-profile] {label}: wall {wall_ms:.3f} ms under the profiler, device kernels "
        f"{total_ms:.3f} ms in {launched} launches (busy share {total_ms / wall_ms:.3f}; "
        f"device-side ranges left out: {left_out}); {len(ranges)} GroupNorm "
        f"backward ranges holding {len(found)} kernels; by class (ms): "
        f"{json.dumps({k: round(v, 3) for k, v in classes.items()})}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[train-profile]   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} x  "
            f"{e.key[:110]}")
    return dict(wall_ms=wall_ms, device_ms=total_ms, busy_share=total_ms / wall_ms,
                launches=launched, **classes)


def step_costs(fn) -> tuple[float, float]:
    """(issue ms, wall ms) of one call of ``fn`` started on an idle device:
    the host's time to return from it, and to the end of its device work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t0)


def paired_steps(label: str, step, base, base_profile: dict | None) -> dict:
    """``step`` against ``base`` in single calls alternated (base step step
    base base step ...), so that both see the same host state: each side's
    median issue and wall ms, the median of the pairs' wall differences, and
    one profiled ``step`` (device ms, launches) beside ``base_profile``.
    Windows of several steps each cannot resolve a few percent on a host
    whose speed drifts between windows."""
    step()
    base()
    costs = {"step": [], "base": []}
    for i in range(STEP_PAIRS):
        for name in ("base", "step") if i % 2 == 0 else ("step", "base"):
            costs[name].append(step_costs(step if name == "step" else base))
    med = {name: {"issue_ms": statistics.median(c[0] for c in v),
                  "wall_ms": statistics.median(c[1] for c in v)} for name, v in costs.items()}
    diffs = [s[1] - b[1] for s, b in zip(costs["step"], costs["base"])]
    out = dict(label=label, pairs=STEP_PAIRS, step=med["step"], base=med["base"],
               wall_diff_ms=statistics.median(diffs),
               wall_diff_quartiles=statistics.quantiles(diffs, n=4),
               step_wins=sum(d < 0 for d in diffs))
    profiled = train_profile(step, label)
    if profiled is not None and base_profile is not None:
        out |= {"device_ms": [profiled["device_ms"], base_profile["device_ms"]],
                "launches": [profiled["launches"], base_profile["launches"]]}
    log(f"[paired] {json.dumps(out)}")
    return out


def guard_update_cost(state, windows: int = 8, calls: int = 20) -> dict:
    """The guard's own cost on an optimizer update: ``apply_updates`` (fused
    Adam, schedule, EMA) over stand-in gradients of ``state``'s model, armed
    and disarmed in alternate windows of ``calls`` calls (a b b a ...).  Per
    call, the median over the windows of the host's issue ms (the loop
    before it waits on the device) and of the wall ms to the end of the
    device work.  The state is restored afterwards."""
    from tqdne_tpu_torch.train.state import apply_updates

    saved = copy.deepcopy(state.state_dict())
    params = [p for p in state.model.parameters() if p.requires_grad]
    gen = torch.Generator(device=params[0].device).manual_seed(SEED)
    # in each parameter's own layout (channels-last convolutions), as autograd leaves them
    grads = [torch.empty_like(p).normal_(0.0, 1e-3, generator=gen) for p in params]

    def update():
        for p, g in zip(params, grads):
            p.grad = g
        apply_updates(state, 0.999)

    costs = {"armed": [], "disarmed": []}
    arms = {"armed": GUARD_N, "disarmed": 0}
    for i in range(windows + 1):  # window 0 warms both up and is not kept
        for name in ("disarmed", "armed") if i % 2 == 0 else ("armed", "disarmed"):
            state.skip_nonfinite = arms[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                update()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            if i:
                costs[name].append((1e3 * (t1 - t0) / calls,
                                    1e3 * (time.perf_counter() - t0) / calls))
    state.skip_nonfinite = 0
    state.load_state_dict(saved)
    out = {name: {"issue_ms": statistics.median(c[0] for c in v),
                  "wall_ms": statistics.median(c[1] for c in v)} for name, v in costs.items()}
    out |= {k: out["armed"][k] - out["disarmed"][k] for k in ("issue_ms", "wall_ms")}
    log(f"[guard] apply_updates of the flagship UNet, {windows} alternate windows of {calls} "
        f"calls: {json.dumps(out)}")
    return out


@contextlib.contextmanager
def plain_versions():
    """Run the models' GroupNorm and attention through the plain versions."""
    from tqdne_tpu_torch.nn import attention as attention_mod
    from tqdne_tpu_torch.nn import layers as layers_mod
    from tqdne_tpu_torch.ops.flash_attention import flash_attention_plain
    from tqdne_tpu_torch.ops.group_norm import group_norm_silu_plain

    saved = layers_mod.group_norm_silu, attention_mod.flash_attention
    layers_mod.group_norm_silu, attention_mod.flash_attention = (group_norm_silu_plain,
                                                                 flash_attention_plain)
    try:
        yield
    finally:
        layers_mod.group_norm_silu, attention_mod.flash_attention = saved


def post(url: str, payload: dict) -> tuple[int, dict, float]:
    """(status, JSON body, seconds) of one POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            status, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, body = e.code, json.loads(e.read())
    return status, body, time.perf_counter() - t0


def waveforms_of(status: int, body: dict):
    """The waveforms of a /generate reply, b64 or JSON, as numpy."""
    import base64

    import numpy as np

    if status != 200:
        fail(f"/generate answered {status}: {body}")
    if "waveforms_b64" in body:
        return np.frombuffer(base64.b64decode(body["waveforms_b64"]), "<f4").reshape(body["shape"])
    return np.array(body["waveforms"], np.float32)


def serve_round(url: str, rows: list, fmt: str, clients: int, per_request: int) -> dict:
    """``clients`` concurrent requests of ``per_request`` rows each: the
    round's rows, wall seconds and waveforms/s, and each request's latency."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    payloads = [{"conditions": [rows[(per_request * i + j) % len(rows)]
                                for j in range(per_request)],
                 "format": fmt} for i in range(clients)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        replies = list(pool.map(lambda p: post(url, p), payloads))
    wall = time.perf_counter() - t0
    for status, body, _ in replies:
        wave = waveforms_of(status, body)
        if wave.shape != (per_request, 3, 4064) or not np.isfinite(wave).all():
            fail(f"served waveforms {wave.shape}, finite {bool(np.isfinite(wave).all())}")
    rows_done = clients * per_request
    return dict(format=fmt, rows=rows_done, seconds=wall, waveforms_per_s=rows_done / wall,
                latencies=[r[2] for r in replies])


def percentile(values, q: float) -> float:
    values = sorted(values)
    return values[min(len(values) - 1, max(0, math.ceil(q * len(values)) - 1))]


def serve_split(label: str, rounds: list, batches: int, issue: list, gen_issue: float,
                gen_total: float):
    """Split the gap between ``generate``'s rate and the server's over
    ``rounds`` into four measured factors whose product it is: batch fill
    (BATCH over rows a batch), the device owner's slow-down (its seconds
    issuing a batch in the server over ``generate``'s issue seconds alone),
    the device tail a synchronised ``generate`` waits for (its issue over its
    total seconds) and the device owner's idle share (1 over the share of the
    window it spends issuing)."""
    rows, wall = sum(r["rows"] for r in rounds), sum(r["seconds"] for r in rounds)
    issue_mean, busy = sum(issue) / len(issue), sum(issue) / wall
    factors = dict(fill=BATCH * batches / rows, owner_slowdown=issue_mean / gen_issue,
                   device_tail=gen_issue / gen_total, owner_idle=1 / busy)
    log(f"[serve-split] {label}: {rows / wall:.2f} waveforms/s ({rows} rows over "
        f"{wall:.4f} s), {rows / batches:.2f} rows a batch of {BATCH} ({batches} batches); "
        f"device owner issues a batch in {issue_mean:.4f} s (generate alone {gen_issue:.4f} s "
        f"issue, {gen_total:.4f} s with its device tail) and is busy {busy:.3f} of the "
        f"window; generate / server {(BATCH / gen_total) / (rows / wall):.3f} = "
        + " x ".join(f"{k} {v:.3f}" for k, v in factors.items()))


def serve_path(bundle, per_batch: tuple[int, int]) -> tuple[int, int]:
    """The serving path: the HTTP server on loopback over ``bundle``, warmed
    up as the serve CLI does, then, with the launch counters set to 0 just
    before and read just after: SERVE_ROUNDS rounds of SERVE_CLIENTS
    concurrent b64 requests (rows of ``examples/demo_conditioning.csv``,
    normalised by the server as the CLI does), SERVE_FULL_ROUNDS rounds of
    SERVE_FULL_CLIENTS requests of a full batch each, one seeded request
    twice plus another seed, and two unseeded requests queued together so
    that they share one batch.  Then one JSON round and ``bundle.generate``'s
    rate in the same process.  The seeded and the coalesced rows must equal,
    bit for bit, a direct ``bundle.sampler`` call at the same seed on the
    card.  ``per_batch``: the (GroupNorm, flash) launches of one device
    batch.  Returns the counted launches."""
    from argparse import Namespace

    import numpy as np

    from tqdne_tpu_torch import serving
    from tqdne_tpu_torch.cli.generate_waveforms import normalize, read_conditioning
    from tqdne_tpu_torch.ops.flash_attention import flash_attention
    from tqdne_tpu_torch.ops.group_norm import group_norm_silu
    from tqdne_tpu_torch.utils import fold_seed

    csv = Path(__file__).resolve().parent / "examples" / "demo_conditioning.csv"
    rows = read_conditioning(Namespace(csv=str(csv))).tolist()
    batcher = serving.Microbatcher.from_bundle(bundle, BATCH, max_delay_ms=SERVE_DELAY_MS)
    batcher.generate(np.zeros((1, len(serving.FEATURES)), np.float32), seed=0)  # warm-up
    issue, run_fn = [], batcher.run_fn  # the device owner's seconds in run, per batch

    def timed_run(seed, cond):
        t0 = time.perf_counter()
        out = run_fn(seed, cond)
        issue.append(time.perf_counter() - t0)
        return out

    batcher.run_fn = timed_run
    server = serving.make_server(batcher, normalize, {"config": "latent_edm"}, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/generate"
    pair = [normalize(np.array(rows[i * SERVE_ROWS:(i + 1) * SERVE_ROWS])).astype(np.float32)
            for i in range(2)]
    try:
        torch.cuda.synchronize()
        group_norm_silu.launches = flash_attention.launches = 0
        batches0, rows0 = batcher.batches_run, batcher.rows_served
        rounds = [serve_round(url, rows, "b64", SERVE_CLIENTS, SERVE_ROWS)
                  for _ in range(SERVE_ROUNDS)]
        mixed_batches, mixed_issue = batcher.batches_run - batches0, issue[:]
        full_rounds = [serve_round(url, rows, "b64", SERVE_FULL_CLIENTS, BATCH)
                       for _ in range(SERVE_FULL_ROUNDS)]
        full_issue = issue[len(mixed_issue):]
        seeded = [waveforms_of(*post(url, {"conditions": rows[:SERVE_ROWS], "seed": seed,
                                           "format": "b64"})[:2]) for seed in (7, 7, 8)]
        # two unseeded requests queued under the batcher's lock, so the device
        # owner packs them into one batch, at the next draw of its counter
        counter, pair_batches0 = batcher._counter, batcher.batches_run
        with batcher._cv:
            pending = [batcher.submit(cond) for cond in pair]
        for p in pending:
            if not p.done.wait(300) or p.error is not None:
                fail(f"coalesced request: done {p.done.is_set()}, error {p.error!r}")
        coalesced = np.concatenate([p.out for p in pending])
        pair_batches = batcher.batches_run - pair_batches0
        counts = (group_norm_silu.launches, flash_attention.launches)
        batches, served = batcher.batches_run - batches0, batcher.rows_served - rows0
        json_round = serve_round(url, rows, "json", SERVE_CLIENTS, SERVE_ROWS)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        batcher.shutdown()
    requests = ((SERVE_CLIENTS * SERVE_ROUNDS + SERVE_FULL_CLIENTS * SERVE_FULL_ROUNDS)
                + len(seeded) + len(pending))
    want_rows = (SERVE_ROWS * (SERVE_CLIENTS * SERVE_ROUNDS + len(seeded) + len(pending))
                 + BATCH * SERVE_FULL_CLIENTS * SERVE_FULL_ROUNDS)
    rates = [r["waveforms_per_s"] for r in rounds]
    latencies = [t for r in rounds for t in r["latencies"]]
    run = bundle.sampler(BATCH)  # the same function on the main thread, outside the count
    direct_seeded = run(fold_seed(7, 0), normalize(np.array(rows[:SERVE_ROWS])))
    direct_pair = run(fold_seed(0, counter), np.concatenate(pair))
    direct_seeded = direct_seeded[:SERVE_ROWS].cpu().numpy()
    direct_pair = direct_pair[:2 * SERVE_ROWS].cpu().numpy()
    repeat_equal = bool(np.array_equal(seeded[0], seeded[1]))
    other_differs = not np.array_equal(seeded[0], seeded[2])
    seeded_direct = bool(np.array_equal(seeded[0], direct_seeded))
    pair_direct = bool(np.array_equal(coalesced, direct_pair))
    log(f"[serve] {SERVE_ROUNDS} rounds of {SERVE_CLIENTS} concurrent b64 requests x "
        f"{SERVE_ROWS} rows over loopback HTTP (dpmpp_2m-10 + GL 32, batch {BATCH}, bf16, "
        f"window {SERVE_DELAY_MS} ms): waveforms/s per round {[round(r, 2) for r in rates]}, "
        f"all rows over all rounds' time "
        f"{sum(r['rows'] for r in rounds) / sum(r['seconds'] for r in rounds):.2f}; request "
        f"latency p50 {percentile(latencies, 0.5):.4f} s p95 {percentile(latencies, 0.95):.4f} s; "
        f"{mixed_batches} batches for {SERVE_CLIENTS * SERVE_ROUNDS} requests")
    full_rates = [r["waveforms_per_s"] for r in full_rounds]
    log(f"[serve] {SERVE_FULL_ROUNDS} rounds of {SERVE_FULL_CLIENTS} concurrent b64 requests x "
        f"{BATCH} rows (every batch full): waveforms/s per round "
        f"{[round(r, 2) for r in full_rates]}, all rows over all rounds' time "
        f"{sum(r['rows'] for r in full_rounds) / sum(r['seconds'] for r in full_rounds):.2f}; "
        f"request latency p50 {percentile([t for r in full_rounds for t in r['latencies']], 0.5):.4f} s")
    log(f"[serve] counted window: batches_run {batches} for {requests} requests, rows_served "
        f"{served}; launches group_norm_silu={counts[0]} flash_attention={counts[1]} (batches x "
        f"{per_batch}); seeded repeat bit-identical {repeat_equal}, another seed differs "
        f"{other_differs}; served seeded rows bit-identical to a direct sampler call "
        f"{seeded_direct}; two unseeded requests in {pair_batches} batch, bit-identical to a "
        f"direct sampler call at the counter's seed {pair_direct}")
    log(f"[serve] one round of JSON responses: {json_round['waveforms_per_s']:.2f} waveforms/s "
        f"({json_round['seconds']:.4f} s), request latency p50 "
        f"{percentile(json_round['latencies'], 0.5):.4f} s p95 "
        f"{percentile(json_round['latencies'], 0.95):.4f} s")
    if not (repeat_equal and other_differs):
        fail("a repeated seeded request must be bit-identical and another seed must differ")
    if not (seeded_direct and pair_direct and pair_batches == 1):
        fail("served rows must equal a direct sampler call at the same seed, bit for bit, and "
             "two requests queued together must share one batch")
    if batches >= requests or served != want_rows:
        fail(f"serving: {batches} batches for {requests} requests, {served} rows served "
             f"(want {want_rows})")
    if counts != (batches * per_batch[0], batches * per_batch[1]):
        fail(f"serving launches {counts} != {batches} batches x {per_batch}")
    cond = torch.as_tensor(normalize(np.array(rows[:BATCH])), dtype=torch.float32)
    gen = torch.Generator(device=bundle.device).manual_seed(SEED)
    secs, issued = [], []
    for _ in range(E2E_RUNS):
        t0 = time.perf_counter()
        bundle.generate(cond.to(bundle.device), generator=gen)
        issued.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    log(f"[serve] bundle.generate in the same process, batch {BATCH}: "
        f"{BATCH / statistics.median(secs):.2f} waveforms/s (median of {E2E_RUNS}, seconds "
        f"{[round(t, 4) for t in secs]}, of which issuing {[round(t, 4) for t in issued]})")
    gen_issue, gen_total = statistics.median(issued), statistics.median(secs)
    serve_split(f"{SERVE_CLIENTS} clients x {SERVE_ROWS} rows", rounds, mixed_batches,
                mixed_issue, gen_issue, gen_total)
    serve_split(f"{SERVE_FULL_CLIENTS} clients x {BATCH} rows", full_rounds,
                SERVE_FULL_CLIENTS * SERVE_FULL_ROUNDS, full_issue, gen_issue, gen_total)
    return counts


def evaluate_path(bundle, classifier, per_batch: tuple[int, int]) -> tuple[int, int]:
    """The evaluation path: EVAL_BATCHES ``evaluate_batch`` calls at batch 32
    over in-memory synthetic waveforms, with the launch counters set to 0
    just before and read just after, then ``report_from_arrays`` over their
    outputs; FID, IS and ASD must be finite.  ``per_batch``: the (GroupNorm,
    flash) launches of one batch.  Returns the counted launches."""
    import numpy as np

    from tqdne_tpu_torch.cli.evaluate import evaluate_batch
    from tqdne_tpu_torch.data.dataset import ArrayDataset, synthetic_arrays
    from tqdne_tpu_torch.eval.report import report_from_arrays
    from tqdne_tpu_torch.ops.flash_attention import flash_attention
    from tqdne_tpu_torch.ops.group_norm import group_norm_silu
    from tqdne_tpu_torch.utils import fold_seed

    n = EVAL_BATCHES * BATCH
    data = ArrayDataset(synthetic_arrays(n, t=bundle.t, seed=SEED), bundle.representation,
                        cut=bundle.t, cond=True, split="full")
    with torch.no_grad():  # the classifier's cuDNN plans at batch 32, outside the count
        classifier.embed_and_logits(torch.zeros(BATCH, 128, 128, 3, device=bundle.device))
    torch.cuda.synchronize()
    group_norm_silu.launches = flash_attention.launches = 0
    parts, wall_ms = [], []
    for i in range(EVAL_BATCHES):
        batch = data.load_batch(np.arange(i * BATCH, (i + 1) * BATCH))
        generator = torch.Generator(device=bundle.device).manual_seed(fold_seed(SEED, i * BATCH))
        t0 = time.perf_counter()
        out = evaluate_batch(bundle, classifier, batch, generator, BATCH)
        torch.cuda.synchronize()
        wall_ms.append(1e3 * (time.perf_counter() - t0))
        parts.append({k: v.cpu().numpy() for k, v in out.items()}
                     | {"target_waveform": batch["waveform"]})
    counts = (group_norm_silu.launches, flash_attention.launches)
    arrays = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    arrays |= {k: data.get_feature(k)[:n] for k in ("magnitude", "hypocentral_distance")}
    report = report_from_arrays(arrays)
    finite = all(math.isfinite(v) for v in (report["fid"], report["inception_score"],
                                            *report["asd_frechet_per_channel"],
                                            *report["mse_per_channel"]))
    log(f"[evaluate] {EVAL_BATCHES} evaluate_batch calls (Heun-25 + GL 128, batch {BATCH}, "
        f"bf16, classifier bf16): wall ms per batch {[round(t, 3) for t in wall_ms]}; launches "
        f"group_norm_silu={counts[0]} flash_attention={counts[1]} (batches x {per_batch}); "
        f"report over {n} waveforms: fid {report['fid']:.6e}, inception_score "
        f"{report['inception_score']:.6f}, asd_frechet_per_channel "
        f"{report['asd_frechet_per_channel']}, mse_per_channel {report['mse_per_channel']}, "
        f"classifier accuracy target/predicted {report['classifier_accuracy_target']:.4f} / "
        f"{report['classifier_accuracy_predicted']:.4f} (random weights: the values only "
        f"show that the path runs)")
    if not finite or arrays["predicted_waveform"].shape != (n, 3, bundle.t):
        fail("evaluation: a non-finite statistic or a wrong waveform shape")
    if counts != (EVAL_BATCHES * per_batch[0], EVAL_BATCHES * per_batch[1]):
        fail(f"evaluation launches {counts} != {EVAL_BATCHES} batches x {per_batch}")
    return counts


def training_setup(dev, dtype):
    """The bench_train.py configuration: the full-width flagship UNet and
    frozen 64-channel autoencoder with seeded random weights, computing in
    ``dtype`` over f32 parameters, Adam with the cosine schedule, EMA 0.999."""
    from tqdne_tpu_torch import configs
    from tqdne_tpu_torch.cli.common import build_autoencoder, build_unet, latent_shape, \
        signal_shape
    from tqdne_tpu_torch.train.state import TrainState, cosine_annealing, make_optimizer
    from tqdne_tpu_torch.train.steps import make_edm_steps
    from tqdne_tpu_torch.utils import randomize_

    config = configs.LatentSpectrogramConfig()
    ae, enc_cfg, _ = build_autoencoder(config, dtype)
    model_shape = latent_shape(enc_cfg, signal_shape(config))
    unet, _ = build_unet(config, model_shape[-1], model_shape[-1], dtype)
    for module, seed in ((unet, SEED), (ae, SEED + 1)):
        randomize_(module, seed).to(dev, memory_format=torch.channels_last)
    schedule = cosine_annealing(1e-4, 100_000)
    state = TrainState(unet, make_optimizer("adam", unet, 1e-4), schedule)
    train_step, eval_step = make_edm_steps(autoencoder=ae)
    return config, state, (train_step, eval_step), ae, model_shape, schedule


def launch_counters():
    """Every kernel wrapper's launch counter (``fn.launches``)."""
    from tqdne_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dq,
    )
    from tqdne_tpu_torch.ops.group_norm import group_norm_silu

    return group_norm_silu, flash_attention, flash_attention_bwd_dkdv, flash_attention_bwd_dq


def want_launches(gn: int = 0, fa: int = 0, bwd: int = 0) -> dict:
    """The launches a path must count: GroupNorm, flash forward, and each backward kernel."""
    return {"group_norm_silu": gn, "flash_attention": fa, "flash_attention_bwd_dkdv": bwd,
            "flash_attention_bwd_dq": bwd}


def counted_fit(label: str, steps, state, loader, *, max_steps: int, want: dict,
                want_gn_bwd: int, val_loader=None, eval_every: int = 10**6,
                metric_postprocess=None, lr_schedule=None):
    """``Trainer.fit`` of ``state`` up to step ``max_steps``, with every launch
    counter and the GroupNorm plain-backward count set to 0 just before and
    read just after: they must equal ``want`` and ``want_gn_bwd``, every
    logged training loss must be finite and the checkpoint written.  Returns
    (counts, metric rows)."""
    from tqdne_tpu_torch.ops.group_norm import group_norm_silu
    from tqdne_tpu_torch.train.loop import Trainer

    workdir = Path(__file__).resolve().parent / "build" / f"chip_smoke_{label}"
    shutil.rmtree(workdir, ignore_errors=True)
    trainer = Trainer(*steps, workdir, device="cuda", max_epochs=10**4, max_steps=max_steps,
                      log_every=10, seed=SEED, checkpoint_every_epochs=10**6,
                      eval_every_epochs=eval_every, lr_schedule=lr_schedule,
                      metric_postprocess=metric_postprocess)
    kernels = launch_counters()
    torch.cuda.synchronize()
    for fn in kernels:
        fn.launches = 0
    group_norm_silu.backward_calls = 0
    t0 = time.perf_counter()
    trainer.fit(state, loader, val_loader, resume=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in kernels}
    gn_bwd = group_norm_silu.backward_calls
    rows = [json.loads(line) for line in (workdir / "metrics.jsonl").open()]
    losses = [r["training/loss"] for r in rows if "training/loss" in r]
    traintime = [r["traintime"] for r in rows if "traintime" in r][-1:] or [0.0]
    log(f"[{label}] Trainer.fit to step {state.step} in {fit_s:.2f} s (checkpoint included), "
        f"logged losses {losses}, traintime {traintime[0]:.3f} s; launches "
        f"{counts}, GroupNorm plain backward calls {gn_bwd}")
    if state.step != max_steps or not losses or not all(map(math.isfinite, losses)):
        fail(f"{label}: step {state.step} (want {max_steps}), losses {losses}")
    if counts != want or gn_bwd != want_gn_bwd:
        fail(f"{label}: launches {counts} (GroupNorm backward {gn_bwd}) != expected {want} "
             f"({want_gn_bwd})")
    if not (workdir / "checkpoints" / "last" / f"{max_steps}.pt").exists():
        fail(f"{label}: no checkpoint written")
    shutil.rmtree(workdir, ignore_errors=True)
    return counts, rows


def check_step_vs_plain(label: str, module, loss_fn, want_bwd: tuple[int, int],
                        min_grads: int):
    """One f32 step's loss and every parameter gradient of ``module``
    through the kernels against the plain versions (same inputs and draws):
    the loss to 1e-5 relative, each gradient to 1e-3 of its peak, with
    ``want_bwd`` (dK/dV, dQ) backward launches through the kernels and none
    through the plain versions."""
    from tqdne_tpu_torch.ops.flash_attention import flash_attention_bwd_dkdv, flash_attention_bwd_dq

    def run():
        module.zero_grad(set_to_none=True)
        before = (flash_attention_bwd_dkdv.launches, flash_attention_bwd_dq.launches)
        loss = loss_fn()
        loss.backward()
        launched = (flash_attention_bwd_dkdv.launches - before[0],
                    flash_attention_bwd_dq.launches - before[1])
        return loss.item(), {n: p.grad.clone() for n, p in module.named_parameters()
                             if p.grad is not None}, launched

    k_loss, k_grads, k_launched = run()
    with plain_versions():  # autograd through the plain ops
        p_loss, p_grads, p_launched = run()
    worst, worst_name = 0.0, ""
    for name, want in p_grads.items():
        ratio = (k_grads[name] - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
        if ratio > worst:
            worst, worst_name = ratio, name
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    log(f"[{label}] f32 train step: loss kernels {k_loss:.8e} plain {p_loss:.8e} (rel "
        f"{loss_rel:.3e}, tol 1e-5); {len(p_grads)} parameter gradients, worst max_abs_err / "
        f"peak {worst:.3e} at {worst_name} (tol 1e-3); backward launches dkdv/dq kernels "
        f"{k_launched} plain {p_launched}")
    module.zero_grad(set_to_none=True)
    if (set(k_grads) != set(p_grads) or len(p_grads) < min_grads or loss_rel > 1e-5
            or worst > 1e-3 or k_launched != want_bwd or p_launched != (0, 0)
            or not math.isfinite(k_loss)):
        fail(f"{label}: the f32 train step through the kernels disagrees with the plain "
             "versions")


def rates_beside(label: str, step, batch_size: int, flagship) -> tuple[float, float]:
    """Samples/s of ``step`` (``batch_size`` samples a call) and of the
    flagship train step, in alternating windows of TRAIN_E2E_STEPS calls:
    the median of TRAIN_E2E_RUNS windows each."""
    step()
    flagship()
    torch.cuda.synchronize()
    rates = {"recipe": [], "flagship": []}
    for _ in range(TRAIN_E2E_RUNS):
        for name, fn, n in (("recipe", step, batch_size), ("flagship", flagship, TRAIN_BATCH)):
            t0 = time.perf_counter()
            for _ in range(TRAIN_E2E_STEPS):
                fn()
            torch.cuda.synchronize()
            rates[name].append(n * TRAIN_E2E_STEPS / (time.perf_counter() - t0))
    mine, ref = statistics.median(rates["recipe"]), statistics.median(rates["flagship"])
    log(f"[recipe-e2e] {label}: {mine:.2f} samples/s (windows "
        f"{[round(r, 2) for r in rates['recipe']]}) beside the flagship step's [train-e2e] "
        f"{ref:.2f} ({[round(r, 2) for r in rates['flagship']]}) in alternate windows of "
        f"{TRAIN_E2E_STEPS} steps; ratio {mine / ref:.4f}")
    return mine, ref


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)

    import numpy as np

    from tqdne_tpu_torch import configs
    from tqdne_tpu_torch.cli.common import build_autoencoder, build_inference
    from tqdne_tpu_torch.cli.evaluate import load_classifier
    from tqdne_tpu_torch.cli.precompute_latents import latent_moments
    from tqdne_tpu_torch.data.dataset import (
        ArrayDataset,
        CachedLatentsDataset,
        ClassificationDataset,
        synthetic_arrays,
    )
    from tqdne_tpu_torch.data.pipeline import BatchLoader, DeviceResidentLoader
    from tqdne_tpu_torch.data.representation import Identity
    from tqdne_tpu_torch.models.classifier import Classifier
    from tqdne_tpu_torch.nn.attention import AttentionBlock
    from tqdne_tpu_torch.nn.layers import Norm32, set_compute_dtype
    from tqdne_tpu_torch.ops import cuda_build
    from tqdne_tpu_torch.ops.representation import device_representation_fn
    from tqdne_tpu_torch.ops.flash_attention import (
        attention_delta,
        flash_attention,
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dkdv_plain,
        flash_attention_bwd_dq,
        flash_attention_bwd_dq_delta_plain,
        flash_attention_plain,
    )
    from tqdne_tpu_torch.ops.group_norm import group_norm_silu, group_norm_silu_plain
    from tqdne_tpu_torch.train.state import (
        TrainState,
        applied_updates,
        cosine_annealing,
        make_optimizer,
    )
    from tqdne_tpu_torch.train.steps import (
        autoencoder_losses,
        classifier_outputs,
        edm_step_loss,
        make_autoencoder_steps,
        make_classifier_steps,
        make_edm_steps,
    )
    from tqdne_tpu_torch.utils import init_like_flax_, randomize_

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build()
    log(f"[build] {len(cuda_build.SOURCES)} sources built in {time.perf_counter() - t0:.2f} s")
    for name in cuda_build.SOURCES:
        for line in (cuda_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # ---- the main path's kernel shapes, read off one forward ------------------
    bundles = {
        "heun-25": build_inference(dtype=torch.bfloat16, num_steps=25, solver="heun",
                                   gl_iters=32, device=dev, init_seed=SEED),
        "dpmpp_2m-10": build_inference(dtype=torch.bfloat16, num_steps=10, solver="dpmpp_2m",
                                       gl_iters=32, device=dev, init_seed=SEED),
    }
    main_bundle = bundles["heun-25"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cond = torch.randn(BATCH, 5, generator=gen, device=dev)
    gn_calls, fa_calls = [], []

    def gn_recorder(sink):
        def hook(mod, args):
            x = args[0]
            sink.append((x.dtype, mod.weight.dtype, x[0, 0].numel(), x.shape[1], mod.groups,
                         mod.silu))
        return hook

    gn_hook = gn_recorder(gn_calls)

    def fa_recorder(sink):
        def hook(mod, args):
            x = args[0]
            sink.append((x.dtype, x[0, 0].numel(), mod.num_heads, x.shape[1] // mod.num_heads,
                         mod.use_causal_mask))
        return hook

    fa_hook = fa_recorder(fa_calls)

    unet, ae = main_bundle.unet.to(torch.bfloat16), main_bundle.autoencoder
    hooks = [m.register_forward_pre_hook(gn_hook) for m in unet.modules() if isinstance(m, Norm32)]
    hooks += [m.register_forward_pre_hook(fa_hook) for m in unet.modules()
              if isinstance(m, AttentionBlock)]
    with torch.no_grad():
        x = torch.randn(BATCH, *main_bundle.model_shape, generator=gen, device=dev)
        unet(x, torch.zeros(BATCH, device=dev), cond)
        unet_gn, unet_fa = list(gn_calls), list(fa_calls)
        gn_calls.clear()
        hooks += [m.register_forward_pre_hook(gn_hook) for m in ae.decoder.modules()
                  if isinstance(m, Norm32)]
        ae.decode(x.float())
        dec_gn = list(gn_calls)
    for h in hooks:
        h.remove()
    # the training path's: the bf16 train step's UNet and frozen encoder (no update here)
    config, state, (train_step, eval_step), ae_t, model_shape, schedule = training_setup(
        dev, torch.bfloat16)
    train_gn, enc_gn = [], []
    hooks = [m.register_forward_pre_hook(gn_recorder(train_gn)) for m in state.model.modules()
             if isinstance(m, Norm32)]
    hooks += [m.register_forward_pre_hook(gn_recorder(enc_gn)) for m in ae_t.encoder.modules()
              if isinstance(m, Norm32)]
    with torch.no_grad():
        edm_step_loss(state.model, {"signal": torch.zeros(2, 128, 128, 3, device=dev),
                                    "cond": torch.zeros(2, 5, device=dev)}, autoencoder=ae_t)
    for h in hooks:
        h.remove()
    # the evaluation path's: the full-width bf16 classifier (seeded random weights)
    classifier = load_classifier(dtype=torch.bfloat16, device=dev, init_seed=CLASSIFIER_SEED)
    clf_gn, clf_fa = [], []
    hooks = [m.register_forward_pre_hook(gn_recorder(clf_gn)) for m in classifier.modules()
             if isinstance(m, Norm32)]
    hooks += [m.register_forward_pre_hook(fa_recorder(clf_fa)) for m in classifier.modules()
              if isinstance(m, AttentionBlock)]
    with torch.no_grad():
        classifier.embed_and_logits(torch.zeros(2, 128, 128, 3, device=dev))
    for h in hooks:
        h.remove()
    log(f"[shapes] UNet eval: {len(unet_gn)} GroupNorm calls, {len(unet_fa)} attention calls; "
        f"decode: {len(dec_gn)} GroupNorm calls; train step: {len(train_gn)} UNet and "
        f"{len(enc_gn)} encoder GroupNorm calls, dtype pairs "
        f"{sorted({(str(x)[6:], str(p)[6:]) for x, p, *_ in train_gn + enc_gn})}")
    log(f"[shapes] classifier forward: {len(clf_gn)} GroupNorm calls (S, C, silu): "
        f"{sorted(collections.Counter((s, c, silu) for *_, s, c, _, silu in clf_gn).items())}, "
        f"dtype pairs {sorted({(str(x)[6:], str(p)[6:]) for x, p, *_ in clf_gn})}; "
        f"{len(clf_fa)} attention calls {sorted(set(clf_fa), key=str)}")
    if (len(unet_gn), len(unet_fa), len(train_gn)) != (51, 6, 51):
        fail(f"expected 45 + 6 GroupNorm and 6 attention calls per UNet eval, got "
             f"{len(unet_gn)} and {len(unet_fa)} ({len(train_gn)} in training)")
    if (len(clf_gn), len(clf_fa)) != (18, 2):
        fail(f"expected 18 GroupNorm and 2 attention calls per classifier forward, got "
             f"{len(clf_gn)} and {len(clf_fa)}")
    # the recipes' training paths, one forward each in train mode: the full-width
    # autoencoder (moments, then decode) and the classifier, bf16 over f32 parameters
    ae_train = init_like_flax_(build_autoencoder(config, torch.bfloat16)[0], SEED + 3)
    clf_config = configs.SpectrogramClassificationConfig()
    clf_train = init_like_flax_(set_compute_dtype(Classifier(
        configs.get_classifier_encoder_config(clf_config), clf_config.num_classes),
        torch.bfloat16), CLASSIFIER_SEED + 1)
    ae_gn, clf_train_gn, clf_train_fa = [], [], []
    hooks = []
    for module in (ae_train, clf_train):
        module.to(dev, memory_format=torch.channels_last).train()
        sink = ae_gn if module is ae_train else clf_train_gn
        hooks += [m.register_forward_pre_hook(gn_recorder(sink)) for m in module.modules()
                  if isinstance(m, Norm32)]
    hooks += [m.register_forward_pre_hook(fa_recorder(clf_train_fa)) for m in clf_train.modules()
              if isinstance(m, AttentionBlock)]
    with torch.no_grad():
        zeros = torch.zeros(2, 128, 128, 3, device=dev)
        autoencoder_losses(ae_train, {"signal": zeros})
        classifier_outputs(clf_train, {"signal": zeros, "label": torch.zeros(2, device=dev)},
                           torch.ones(clf_config.num_classes))
    for h in hooks:
        h.remove()
    log(f"[shapes] autoencoder train step: {len(ae_gn)} GroupNorm calls (S, C): "
        f"{sorted(collections.Counter((s, c) for *_, s, c, _, _ in ae_gn).items())}; classifier "
        f"train step: {len(clf_train_gn)} GroupNorm calls, {len(clf_train_fa)} attention calls "
        f"{sorted(set(clf_train_fa), key=str)}, at batch {CLF_TRAIN_BATCH}; dtype pairs "
        f"{sorted({(str(x)[6:], str(p)[6:]) for x, p, *_ in ae_gn + clf_train_gn})}")
    if (len(ae_gn), len(clf_train_gn), len(clf_train_fa)) != (len(enc_gn) + len(dec_gn), 18, 2):
        fail(f"expected {len(enc_gn)} + {len(dec_gn)} GroupNorm calls per autoencoder step and "
             f"18 GroupNorm and 2 attention calls per classifier step, got {len(ae_gn)}, "
             f"{len(clf_train_gn)} and {len(clf_train_fa)}")

    # ---- 2. kernels against their plain versions ------------------------------
    errs = {}
    bad = check_group_norm_kernels(
        gen, dev, errs, unet_gn + dec_gn + train_gn + enc_gn + clf_gn + ae_gn + clf_train_gn,
        batches=(BATCH, CLF_TRAIN_BATCH, TRAIN_BATCH))
    bad += check_flash_kernels(gen, dev, errs, [(CLF_TRAIN_BATCH, length, h, d)
                                                for _, length, h, d, _ in clf_train_fa])
    torch.cuda.synchronize()
    if bad:
        fail(f"{bad} kernel checks disagree with the plain versions")

    # ---- 3. full-width f32 slice: kernels vs plain versions -------------------
    f32_bundle = build_inference(dtype=torch.float32, num_steps=2, solver="heun", device=dev,
                                 init_seed=SEED)
    noise = torch.randn(4, *f32_bundle.model_shape, generator=gen, device=dev)
    with torch.no_grad():
        with_kernels = f32_bundle.sample(cond[:4], noise=noise)
        with plain_versions():
            plain = f32_bundle.sample(cond[:4], noise=noise)
    scale = plain.abs().max().item()
    slice_err = (with_kernels - plain).abs().max().item()
    log(f"[slice-f32] Heun-2 decoded spectrograms {tuple(plain.shape)}: kernels vs plain "
        f"max_abs_err={slice_err:.3e} (peak {scale:.3e}, tol 1e-4 * peak)")
    if not (torch.isfinite(with_kernels).all() and slice_err <= 1e-4 * scale):
        fail("the f32 slice through the kernels disagrees with the plain versions")
    del f32_bundle

    # the full-width f32 classifier (embeddings and logits), kernels vs plain versions
    clf32 = load_classifier(dtype=torch.float32, device=dev, init_seed=CLASSIFIER_SEED)
    spectrograms = torch.rand(8, 128, 128, 3, generator=gen, device=dev) * 2 - 1
    with torch.no_grad():
        with_kernels = clf32.embed_and_logits(spectrograms)
        with plain_versions():
            plain = clf32.embed_and_logits(spectrograms)
    for name, got, want in zip(("embeddings", "logits"), with_kernels, plain):
        peak, err = want.abs().max().item(), (got - want).abs().max().item()
        log(f"[classifier-f32] {name} {tuple(want.shape)}, batch 8: kernels vs plain "
            f"max_abs_err={err:.3e} (peak {peak:.3e}, tol 1e-4 * peak)")
        if not (torch.isfinite(got).all() and err <= 1e-4 * peak):
            fail(f"the f32 classifier's {name} through the kernels disagree with the plain "
                 "versions")
    del clf32

    # one full-width f32 train step of each recipe, kernels vs plain versions, same draws
    _, f32_state, _, f32_ae, model_shape, _ = training_setup(dev, torch.float32)
    unet32 = f32_state.model.eval()  # no dropout: the two passes see the same function
    n32 = 8
    batch32 = {"signal": torch.rand(n32, 128, 128, 3, generator=gen, device=dev) * 2 - 1,
               "cond": torch.randn(n32, 5, generator=gen, device=dev)}
    draws = {"ae_eps": torch.randn(n32, *model_shape, generator=gen, device=dev),
             "sigma_eps": torch.randn(n32, generator=gen, device=dev),
             "noise": torch.randn(n32, *model_shape, generator=gen, device=dev)}
    check_step_vs_plain("slice-f32-train", unet32,
                        lambda: edm_step_loss(unet32, batch32, autoencoder=f32_ae, draws=draws),
                        (6, 6), 100)
    del f32_state, f32_ae, unet32
    ae32 = randomize_(build_autoencoder(config, torch.float32)[0], SEED + 3)
    ae32.to(dev, memory_format=torch.channels_last).eval()
    check_step_vs_plain("ae-f32-train", ae32, lambda: autoencoder_losses(
        ae32, {"signal": batch32["signal"]}, kl_weight=config.kl_weight,
        draws={"ae_eps": draws["ae_eps"]})["loss"], (0, 0), 50)
    clf32 = load_classifier(dtype=torch.float32, device=dev, init_seed=CLASSIFIER_SEED)
    clf_batch32 = {"signal": batch32["signal"],
                   "label": torch.randint(0, clf_config.num_classes, (n32,), generator=gen,
                                          device=dev)}
    class_weights = torch.rand(clf_config.num_classes, generator=gen, device=dev) + 0.5
    check_step_vs_plain("classifier-f32-train", clf32, lambda: classifier_outputs(
        clf32, clf_batch32, class_weights)[1]["loss"], (2, 2), 50)
    del ae32, clf32
    torch.cuda.empty_cache()

    # ---- 4. the main path ------------------------------------------------------
    bundles["dpmpp_2m-10"].generate(cond, generator=gen)  # warm-up: lazy CUDA init, cuDNN plans
    torch.cuda.synchronize()
    group_norm_silu.launches = 0
    flash_attention.launches = 0
    runs, counts = {}, {}
    for name, bundle in bundles.items():
        before = (group_norm_silu.launches, flash_attention.launches)
        t0 = time.perf_counter()
        wave = bundle.generate(cond, generator=gen)
        torch.cuda.synchronize()
        runs[name] = [time.perf_counter() - t0]
        counts[name] = (group_norm_silu.launches - before[0], flash_attention.launches - before[1])
        if wave.shape != (BATCH, 3, 4064) or not torch.isfinite(wave).all():
            fail(f"{name}: waveforms {tuple(wave.shape)} finite={bool(torch.isfinite(wave).all())}")
        log(f"[main] {name}: waveforms {tuple(wave.shape)} finite, peak "
            f"{wave.abs().max().item():.3e}, launches group_norm_silu={counts[name][0]} "
            f"flash_attention={counts[name][1]}")
    launches = {"group_norm_silu": group_norm_silu.launches,
                "flash_attention": flash_attention.launches}
    for name, evals in (("heun-25", 2 * 25 - 1), ("dpmpp_2m-10", 10)):
        want = (len(unet_gn) * evals + len(dec_gn), len(unet_fa) * evals)
        if counts[name] != want:
            fail(f"{name}: launches {counts[name]} != expected {want} ({evals} UNet evals)")
    if min(launches.values()) == 0:
        fail(f"a kernel of the path was never launched: {launches}")

    # ---- 4b. the main training path: Trainer.fit, bf16, batch 128 -------------
    t0 = time.perf_counter()
    arrays = synthetic_arrays(TRAIN_SAMPLES, t=config.t, seed=SEED)
    representation = config.make_representation()
    dataset = ArrayDataset(arrays, representation, cut=config.t, cond=True, split="full")
    loader = BatchLoader(dataset, TRAIN_BATCH, device=dev, keys=("signal", "cond"), seed=SEED)
    log(f"[train] {TRAIN_SAMPLES} synthetic waveforms in {time.perf_counter() - t0:.2f} s; "
        f"{len(loader)} batches of {TRAIN_BATCH} per epoch; encoder GroupNorm calls per "
        f"encode: {len(enc_gn)}")

    def flagship_want(steps: int, encoder: bool = True) -> dict:
        """The flagship step's launches: the UNet's, and the frozen encoder's GroupNorm."""
        gn = len(unet_gn) + (len(enc_gn) if encoder else 0)
        return want_launches(gn * steps, len(unet_fa) * steps, len(unet_fa) * steps)

    train_counts, metric_rows = counted_fit(
        "train", (train_step, eval_step), state, loader, max_steps=TRAIN_STEPS,
        want=flagship_want(TRAIN_STEPS), want_gn_bwd=len(unet_gn) * TRAIN_STEPS,
        lr_schedule=schedule)
    launches = {k: launches.get(k, 0) + v for k, v in train_counts.items()}
    recipe_counts = {}  # the recipe paths' launch counts, by run

    # ---- 4e. the autoencoder recipe: Trainer.fit, AdamW, bf16, batch 128 -------
    ae_loader = BatchLoader(ArrayDataset(arrays, representation, cut=config.t, split="full"),
                            TRAIN_BATCH, device=dev, keys=("signal",), seed=SEED)
    ae_schedule = cosine_annealing(1e-4, 300 * len(ae_loader))  # the recipe's 300 epochs
    ae_state = TrainState(ae_train, make_optimizer("adamw", ae_train, 1e-4, 1e-4), ae_schedule)
    ae_steps = make_autoencoder_steps(kl_weight=config.kl_weight, ema_decay=0.0)
    recipe_counts["ae_train"], _ = counted_fit(
        "ae-train", ae_steps, ae_state, ae_loader, max_steps=AE_STEPS,
        want=want_launches(len(ae_gn) * AE_STEPS), want_gn_bwd=len(ae_gn) * AE_STEPS,
        lr_schedule=ae_schedule)

    # ---- 4f. the classifier recipe: Adam, bf16, batch 64, one validation pass ------
    bins = clf_config.mag_bins, clf_config.dist_bins
    clf_train_ds = ClassificationDataset(arrays, representation, *bins, cut=config.t,
                                         split="train_validation")
    clf_val_ds = ClassificationDataset(arrays, representation, *bins, cut=config.t, split="test")
    clf_loader = BatchLoader(clf_train_ds, CLF_TRAIN_BATCH, device=dev, keys=("signal", "label"),
                             seed=SEED)
    clf_val = BatchLoader(clf_val_ds, min(CLF_TRAIN_BATCH, len(clf_val_ds)), shuffle=False,
                          device=dev, keys=("signal", "label"))
    clf_schedule = cosine_annealing(1e-4, 110 * len(clf_loader))  # the recipe's 110 epochs
    clf_state = TrainState(clf_train, make_optimizer("adam", clf_train, 1e-4), clf_schedule)
    clf_train_step, clf_eval_step, clf_post = make_classifier_steps(
        clf_train_ds.get_class_weights(), ema_decay=0.0)
    forwards = CLF_STEPS + len(clf_val)  # the train steps' and the one validation pass's
    recipe_counts["classifier_train"], clf_rows = counted_fit(
        "classifier-train", (clf_train_step, clf_eval_step), clf_state, clf_loader,
        max_steps=CLF_STEPS, want=want_launches(len(clf_train_gn) * forwards,
                                                len(clf_train_fa) * forwards,
                                                len(clf_train_fa) * CLF_STEPS),
        want_gn_bwd=len(clf_train_gn) * CLF_STEPS, val_loader=clf_val,
        eval_every=CLF_STEPS // len(clf_loader), metric_postprocess=clf_post,
        lr_schedule=clf_schedule)
    val_rows = [r for r in clf_rows if "validation/loss" in r]
    macro = {k: v for r in val_rows for k, v in r.items() if k.startswith("validation/macro")}
    log(f"[classifier-train] {len(val_rows)} validation pass over {len(clf_val_ds)} test rows: "
        f"{json.dumps({k: v for r in val_rows for k, v in r.items()})}")
    if len(val_rows) != 1 or len(macro) != 4 or not all(map(math.isfinite, macro.values())):
        fail(f"classifier recipe: {len(val_rows)} validation passes, macro metrics {macro}")

    # ---- 4g. cached latents: the precompute core with that autoencoder, then the
    # flagship step from the moments through DeviceResidentLoader (no encoder) -----
    ae32 = build_autoencoder(config, torch.float32)[0]  # precompute_latents' f32 default
    ae32.load_state_dict(ae_state.model.state_dict())
    ae32.to(dev, memory_format=torch.channels_last).eval()
    torch.cuda.synchronize()
    group_norm_silu.launches = 0
    t0 = time.perf_counter()
    mean, log_std = latent_moments(ae32, arrays["waveforms"], representation, cut=config.t,
                                   device=dev)
    pre_s, pre_gn = time.perf_counter() - t0, group_norm_silu.launches
    finite = bool(np.isfinite(mean).all() and np.isfinite(log_std).all())
    log(f"[precompute] latent moments of {TRAIN_SAMPLES} waveforms in {pre_s:.3f} s (f32, batch "
        f"64): {mean.shape} finite {finite}; GroupNorm launches {pre_gn}")
    if (mean.shape != (TRAIN_SAMPLES, *model_shape) or not finite
            or pre_gn != len(enc_gn) * -(-TRAIN_SAMPLES // 64)):
        fail(f"precompute: moments {mean.shape}, finite {finite}, GroupNorm launches {pre_gn}")
    latent_keys = ("latent_mean", "latent_log_std", "cond")
    cached_ds = CachedLatentsDataset(arrays, {"latent_mean": mean, "latent_log_std": log_std},
                                     representation, split="full")
    if not DeviceResidentLoader.fits(cached_ds, latent_keys):
        fail("cached latents: the moments do not fit the device-resident budget")
    cached_loader = DeviceResidentLoader(cached_ds, TRAIN_BATCH, keys=latent_keys, device=dev,
                                         seed=SEED)
    cached_steps = make_edm_steps(autoencoder=ae32, latent_moments=True)
    recipe_counts["cached_latents"], _ = counted_fit(
        "cached-latents", cached_steps, state, cached_loader, max_steps=state.step + TRAIN_STEPS,
        want=flagship_want(TRAIN_STEPS, encoder=False), want_gn_bwd=len(unet_gn) * TRAIN_STEPS,
        lr_schedule=schedule)

    # ---- 4h. the representation on the device: the loader ships raw waveforms -----
    wave_loader = BatchLoader(ArrayDataset(arrays, Identity(), cut=config.t, cond=True,
                                           split="full"),
                              TRAIN_BATCH, device=dev, keys=("waveform", "cond"), seed=SEED)
    rep_steps = make_edm_steps(autoencoder=ae_t,
                               device_representation=device_representation_fn(representation))
    recipe_counts["device_representation"], _ = counted_fit(
        "device-representation", rep_steps, state, wave_loader,
        max_steps=state.step + TRAIN_STEPS, want=flagship_want(TRAIN_STEPS),
        want_gn_bwd=len(unet_gn) * TRAIN_STEPS, lr_schedule=schedule)

    # ---- 4i. the non-finite guard on the card: a NaN batch, then a clean one ------
    tgen = torch.Generator(device=dev).manual_seed(SEED)
    clean = next(iter(loader))
    bad_batch = dict(clean, signal=torch.full_like(clean["signal"], float("nan")))
    params = [p for p in state.model.parameters() if p.requires_grad]
    before = [p.detach().clone() for p in params]
    moments_before = state.optimizer.state[params[0]]["exp_avg"].clone()
    count0, step0 = int(applied_updates(state.optimizer)), state.step
    state.skip_nonfinite = GUARD_N
    kernels = launch_counters()
    for fn in kernels:
        fn.launches = 0
    group_norm_silu.backward_calls = 0
    bad_loss = train_step(state, bad_batch, generator=tgen)["loss"].item()
    held = (all(torch.equal(b, p) for b, p in zip(before, params))
            and torch.equal(moments_before, state.optimizer.state[params[0]]["exp_avg"]))
    after_bad = int(applied_updates(state.optimizer)), state.notfinite_count.item()
    clean_loss = train_step(state, clean, generator=tgen)["loss"].item()
    moved = sum(not torch.equal(b, p) for b, p in zip(before, params))
    after_clean = int(applied_updates(state.optimizer)), state.notfinite_count.item()
    state.skip_nonfinite = 0
    recipe_counts["guard"] = {fn.__name__: fn.launches for fn in kernels}
    log(f"[guard] skip_nonfinite={GUARD_N}: a NaN batch gave loss {bad_loss}, parameters and "
        f"Adam moments held {held}, (updates applied, consecutive non-finite) {count0} -> "
        f"{after_bad}; the next clean batch gave loss {clean_loss:.6e}, moved {moved} of "
        f"{len(params)} parameter tensors, {after_clean}; step {step0} -> {state.step}; "
        f"launches {recipe_counts['guard']}, GroupNorm plain backward calls "
        f"{group_norm_silu.backward_calls}")
    if (math.isfinite(bad_loss) or not held or after_bad != (count0, 1.0)
            or not math.isfinite(clean_loss) or moved < len(params) // 2
            or after_clean != (count0 + 1, 0.0) or state.step != step0 + 2):
        fail("the non-finite guard did not hold a NaN step and apply the clean one")
    if (recipe_counts["guard"] != flagship_want(2)
            or group_norm_silu.backward_calls != 2 * len(unet_gn)):
        fail(f"guard launches {recipe_counts['guard']} != {flagship_want(2)}")
    for run_counts in recipe_counts.values():
        launches = {k: launches[k] + v for k, v in run_counts.items()}

    # ---- 4c. the serving path: the HTTP server over the dpmpp_2m-10 bundle -----
    per_serve_batch = (len(unet_gn) * 10 + len(dec_gn), len(unet_fa) * 10)
    path_counts = {"serve": serve_path(bundles["dpmpp_2m-10"], per_serve_batch)}

    # ---- 4d. the evaluation path: evaluate_batch + report_from_arrays ----------
    eval_bundle = build_inference(dtype=torch.bfloat16, num_steps=25, solver="heun", device=dev,
                                  init_seed=SEED)  # the evaluate CLI's defaults: GL 128
    per_eval_batch = (len(unet_gn) * 49 + len(dec_gn) + 2 * len(clf_gn),
                      len(unet_fa) * 49 + 2 * len(clf_fa))
    path_counts["evaluate"] = evaluate_path(eval_bundle, classifier, per_eval_batch)
    del eval_bundle
    for which, name in enumerate(("group_norm_silu", "flash_attention")):
        launches[name] += sum(c[which] for c in path_counts.values())

    # ---- 5. timings --------------------------------------------------------------
    for name, bundle in bundles.items():
        for _ in range(E2E_RUNS - 1):
            t0 = time.perf_counter()
            bundle.generate(cond, generator=gen)
            torch.cuda.synchronize()
            runs[name].append(time.perf_counter() - t0)
        sec = statistics.median(runs[name])
        log(f"[e2e] {name} + Griffin-Lim 32, batch {BATCH}, bf16: {BATCH / sec:.2f} waveforms/s "
            f"(median of {len(runs[name])} runs, seconds {[round(r, 4) for r in runs[name]]})")
    rep = torch.rand(BATCH, 3, 128, 128, generator=gen, device=dev) * 2 - 1
    gl_ms = cuda_ms(lambda: main_bundle.representation.invert_representation(rep, generator=gen),
                    reps=3, warmup=1)
    log(f"[e2e] de-normalise + Griffin-Lim 32 on {BATCH} x 3 spectrograms: {gl_ms:.3f} ms")
    profile_breakdown(lambda: bundles["dpmpp_2m-10"].generate(cond, generator=gen),
                      f"dpmpp_2m-10 + GL 32, batch {BATCH} (10 UNet evals and one decode)")

    def bound(nbytes, ops, dtype):
        """Least time for the work: bytes over HBM rate vs operations over peak."""
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / PEAK_OPS[dtype]
        return dict(bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")

    def timed(kernel, plain, library):
        """Device ms of each, plus the kernel's per-call time when issued back
        to back (CUDA events), which the host's overhead sets at small shapes,
        and the kernels the library call ran."""
        names = []
        issue, issue_min = issue_ms(kernel)
        return dict(ms=device_ms(kernel), plain_ms=device_ms(plain),
                    library_ms=device_ms(library, names=names), issue_ms=issue,
                    issue_min_ms=issue_min, library_kernels=sorted(set(names)))

    def summed(rows, key):  # the kernel's work in one UNet eval (plus one decode) or step
        return sum((1 if key == "one" else r[key]) * r["calls"] for r in rows)

    def gn_row(dtype, pdtype, s, c, g, silu, calls, batch=BATCH):
        x = torch.randn(batch, s, c, generator=gen, device=dev).to(dtype)
        w = torch.ones(c, device=dev, dtype=pdtype)
        b = torch.zeros(c, device=dev, dtype=pdtype)
        # torch's group_norm takes the (B, C, S) view and parameters in x's dtype
        xt, wx, bx = x.transpose(1, 2), w.to(dtype), b.to(dtype)
        lib = (lambda: F.silu(F.group_norm(xt, g, wx, bx, 1e-5))) if silu else \
            (lambda: F.group_norm(xt, g, wx, bx, 1e-5))
        nbytes = 2 * x.numel() * x.element_size() + 2 * c * w.element_size()
        return dict(
            shape=[batch, s, c], groups=g, silu=silu, dtype=str(dtype)[6:],
            scale_dtype=str(pdtype)[6:], calls=calls,
            **timed(lambda: group_norm_silu(x, w, b, g, 1e-5, silu),
                    lambda: group_norm_silu_plain(x, w, b, g, 1e-5, silu), lib),
            **bound(nbytes, GN_OPS_PER_ELEM[silu] * x.numel(), torch.float32))

    def fa_row(dtype, length, h, d, causal, calls, batch=BATCH):
        q, k, v = (torch.randn(batch, length, h, d, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        qs, ks, vs = (t.transpose(1, 2) for t in (q * d**-0.25, k * d**-0.25, v))
        pairs = length * (length + 1) / 2 if causal else length * length
        return dict(
            shape=[batch, length, h, d], causal=causal, dtype=str(dtype)[6:], calls=calls,
            **timed(lambda: flash_attention(q, k, v, causal),
                    lambda: flash_attention_plain(q, k, v, causal),
                    lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                           scale=1.0)),
            **bound(4 * q.numel() * q.element_size(), 4 * batch * h * pairs * d, dtype))

    gn_rows = [gn_row(*key, calls=unet_gn.count(key)) for key in dict.fromkeys(unet_gn)]
    gn_rows += [gn_row(*key, calls=dec_gn.count(key)) for key in dict.fromkeys(dec_gn)]
    step_gn = train_gn + enc_gn  # one bf16 train step's GroupNorm calls, at batch 128
    gn_train_rows = [gn_row(*key, calls=step_gn.count(key), batch=TRAIN_BATCH)
                     for key in dict.fromkeys(step_gn)]
    fa_rows = [fa_row(*key, calls=unet_fa.count(key)) for key in dict.fromkeys(unet_fa)]
    # the classifier's, one forward at batch 32: the new (32, 256, 256) GroupNorm with
    # SiLU on and off, and the forward at 256 tokens
    clf_gn_rows = [gn_row(*key, calls=clf_gn.count(key)) for key in dict.fromkeys(clf_gn)]
    clf_fa_rows = [fa_row(*key, calls=clf_fa.count(key)) for key in dict.fromkeys(clf_fa)]
    for row in gn_rows + gn_train_rows + fa_rows + clf_gn_rows + clf_fa_rows:
        log(f"[time] {json.dumps(row)}")
    clf_sums = {}
    for label, name, rows in (
            ("one UNet eval and one decode, batch 32", "group_norm_silu", gn_rows),
            ("one train step's UNet and encoder, batch 128", "group_norm_silu", gn_train_rows),
            ("one classifier forward, batch 32", "group_norm_silu", clf_gn_rows),
            ("one classifier forward, batch 32", "flash_attention", clf_fa_rows)):
        sums = {k: summed(rows, k) for k in ("ms", "bound_ms", "plain_ms", "library_ms",
                                             "issue_ms")} | {"calls": summed(rows, "one")}
        log(f"[time] {name} over {label}: " + json.dumps(sums))
        if label.startswith("one classifier"):
            clf_sums[name] = sums
    # for the record (no main-path calls): the forward at the training batch
    log(f"[time] {json.dumps(fa_row(torch.bfloat16, 16, 4, 128, False, 0, TRAIN_BATCH))}")
    spectrograms = torch.rand(BATCH, 128, 128, 3, generator=gen, device=dev) * 2 - 1
    for _ in range(2):
        with torch.no_grad():
            profile_breakdown(lambda: classifier.embed_and_logits(spectrograms),
                              f"classifier forward (embed_and_logits), batch {BATCH}, bf16",
                              tag="eval-profile")

    # training: samples/s of train_step on a resident batch, a profiled step,
    # the backward kernels per call, and one step at the recipe's batch 256
    batch = next(iter(loader))

    def one_step(b=batch):
        return train_step(state, b, generator=tgen)

    one_step()
    torch.cuda.synchronize()
    secs = []
    for _ in range(TRAIN_E2E_RUNS):
        t0 = time.perf_counter()
        for _ in range(TRAIN_E2E_STEPS):
            one_step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    sec = statistics.median(secs)
    log(f"[train-e2e] flagship latent-EDM train step (frozen encoder, loss, backward, Adam, "
        f"EMA), batch {TRAIN_BATCH}, bf16: {TRAIN_BATCH * TRAIN_E2E_STEPS / sec:.2f} samples/s "
        f"(median of {TRAIN_E2E_RUNS} runs of {TRAIN_E2E_STEPS} steps, seconds "
        f"{[round(r, 4) for r in secs]}); Trainer.fit ran {TRAIN_STEPS} steps at "
        f"{TRAIN_BATCH * TRAIN_STEPS / metric_rows[-1]['traintime']:.2f} samples/s of its "
        f"traintime")
    flagship_profile = train_profile(one_step, f"one train step, batch {TRAIN_BATCH}, bf16")

    # the guard's cost and the cached-latent step against the flagship step in alternated
    # single steps, each also profiled; then the recipes' steps beside the flagship step
    recipe_batches = {name: next(iter(ld)) for name, ld in (
        ("ae", ae_loader), ("classifier", clf_loader), ("cached", cached_loader),
        ("waveform", wave_loader))}

    def guarded_step():
        state.skip_nonfinite = GUARD_N
        one_step()
        state.skip_nonfinite = 0

    guard = paired_steps(f"the flagship step with the guard armed (skip_nonfinite={GUARD_N}), "
                         f"batch {TRAIN_BATCH}, bf16", guarded_step, one_step, flagship_profile)
    guard_update = guard_update_cost(state)
    step_issue = guard["base"]["issue_ms"]
    log(f"[guard] cost on the flagship step, batch {TRAIN_BATCH}, bf16: in its update "
        f"{guard_update['issue_ms']:.4f} issue ms "
        f"({100 * guard_update['issue_ms'] / step_issue:.3f}% of the step's {step_issue:.3f}) "
        f"and {guard_update['wall_ms']:.4f} wall ms; median step pair difference "
        f"{guard['wall_diff_ms']:.3f} ms; launches {guard.get('launches')}")
    paired_steps(f"the flagship step from cached latents (no encoder), batch {TRAIN_BATCH}, bf16",
                 lambda: cached_steps[0](state, recipe_batches["cached"], generator=tgen),
                 one_step, flagship_profile)
    for label, step, st, name, n in (
            ("autoencoder recipe step (AdamW, no EMA), batch 128, bf16", ae_steps[0], ae_state,
             "ae", TRAIN_BATCH),
            ("classifier recipe step (Adam, no EMA), batch 64, bf16", clf_train_step, clf_state,
             "classifier", CLF_TRAIN_BATCH),
            ("flagship step from cached latents (no encoder), batch 128, bf16",
             cached_steps[0], state, "cached", TRAIN_BATCH),
            ("flagship step with the representation on the device, batch 128, bf16",
             rep_steps[0], state, "waveform", TRAIN_BATCH)):
        rates_beside(label, lambda: step(st, recipe_batches[name], generator=tgen), n, one_step)

    def bwd_rows(dtype, length, h, d, causal, calls, batch=TRAIN_BATCH):
        q, k, v = qkv_views(batch, length, h, d, dtype, "fused", gen, dev)
        do = torch.randn(batch, length, h, d, generator=gen, device=dev).to(dtype)
        out, lse = flash_attention(q, k, v, causal, return_lse=True)
        delta = attention_delta(do, out)
        # the library: autograd through SDPA on the same pre-scaled inputs; one
        # backward computes dq, dk and dv together
        lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q * d**-0.25, k * d**-0.25, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal, scale=1.0)
        go = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(lib_out, (lq, lk, lv), go, retain_graph=True)

        pairs = length * (length + 1) / 2 if causal else length * length
        elems, size, rows_bytes = q.numel(), q.element_size(), 2 * lse.numel() * 4
        common = dict(shape=[batch, length, h, d], causal=causal, dtype=str(dtype)[6:],
                      calls=calls)
        return {
            # reads q, k, v, dO, lse, delta; writes dK, dV; products S, dP, dV, dK
            "flash_attention_bwd_dkdv": dict(
                kernel="flash_attention_bwd_dkdv", **common,
                **timed(lambda: flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal),
                        lambda: flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, causal),
                        library),
                **bound(6 * elems * size + rows_bytes, 8 * batch * h * pairs * d, dtype)),
            # reads q, k, v, dO, O, lse; writes dQ, delta; products S, dP, dQ and dO * O;
            # attention_delta_ms: the plain delta this kernel replaces, for the record
            "flash_attention_bwd_dq": dict(
                kernel="flash_attention_bwd_dq", **common,
                **timed(lambda: flash_attention_bwd_dq(q, k, v, do, out, lse, causal),
                        lambda: flash_attention_bwd_dq_delta_plain(q, k, v, do, out, lse,
                                                                   causal),
                        library),
                attention_delta_ms=device_ms(lambda: attention_delta(do, out)),
                **bound(6 * elems * size + rows_bytes, 6 * batch * h * pairs * d + 2 * elems,
                        dtype)),
        }

    bwd = [bwd_rows(*key, calls=unet_fa.count(key)) for key in dict.fromkeys(unet_fa)]
    for row in bwd:
        for r in row.values():
            log(f"[time] {json.dumps(r)}")
    for row in bwd:
        dq_row, dkdv_row = row["flash_attention_bwd_dq"], row["flash_attention_bwd_dkdv"]
        log(f"[time] flash backward {dq_row['shape']}: dQ + dK/dV "
            f"{1e3 * (dq_row['ms'] + dkdv_row['ms']):.2f} us against SDPA's whole backward "
            f"{1e3 * dq_row['library_ms']:.2f} us; the plain attention_delta alone "
            f"{1e3 * dq_row['attention_delta_ms']:.2f} us")
    # the classifier recipe's train step at batch 64: its kernels per call, summed per
    # step, and the step by kernel class
    clf_fa_key = clf_train_fa[0]
    clf_step_rows = {
        "group_norm_silu": [gn_row(*key, calls=clf_train_gn.count(key), batch=CLF_TRAIN_BATCH)
                            for key in dict.fromkeys(clf_train_gn)],
        "flash_attention": [fa_row(*clf_fa_key, calls=len(clf_train_fa),
                                   batch=CLF_TRAIN_BATCH)],
        **{k: [v] for k, v in bwd_rows(*clf_fa_key, calls=len(clf_train_fa),
                                       batch=CLF_TRAIN_BATCH).items()}}
    clf_step_sums = {}
    for name, rows in clf_step_rows.items():
        for row in rows:
            log(f"[time] classifier train step {json.dumps(row)}")
        clf_step_sums[name] = {k: summed(rows, k) for k in ("ms", "bound_ms", "plain_ms",
                                                            "library_ms", "issue_ms")}
        clf_step_sums[name] |= {"calls": summed(rows, "one"),
                                "per": f"one classifier train step, batch {CLF_TRAIN_BATCH}, bf16"}
        log(f"[time] {name} over one classifier train step, batch {CLF_TRAIN_BATCH}: "
            + json.dumps(clf_step_sums[name]))
    dq_row = clf_step_rows["flash_attention_bwd_dq"][0]
    dkdv_row = clf_step_rows["flash_attention_bwd_dkdv"][0]
    log(f"[time] flash backward {dq_row['shape']}: dQ + dK/dV "
        f"{1e3 * (dq_row['ms'] + dkdv_row['ms']):.2f} us against SDPA's whole backward "
        f"{1e3 * dq_row['library_ms']:.2f} us (factor "
        f"{(dq_row['ms'] + dkdv_row['ms']) / dq_row['library_ms']:.3f})")
    train_profile(lambda: clf_train_step(clf_state, recipe_batches["classifier"], generator=tgen),
                  f"one classifier train step, batch {CLF_TRAIN_BATCH}, bf16")
    train_profile(lambda: ae_steps[0](ae_state, recipe_batches["ae"], generator=tgen),
                  f"one autoencoder train step, batch {TRAIN_BATCH}, bf16")

    big = next(iter(BatchLoader(dataset, 2 * TRAIN_BATCH, device=dev, keys=("signal", "cond"),
                                prefetch=0)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    big_loss = one_step(big)["loss"].item()
    torch.cuda.synchronize()
    log(f"[train-256] one train step at batch {2 * TRAIN_BATCH}, bf16: loss {big_loss:.4e}, "
        f"{time.perf_counter() - t0:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not math.isfinite(big_loss):
        fail("the batch-256 train step gave a non-finite loss")

    kernels = []
    for name, rows, source, replaces in (
        ("group_norm_silu", gn_rows, "tqdne_tpu_torch/csrc/group_norm.cu",
         "tqdne_tpu/ops/group_norm.py:24"),
        ("flash_attention", fa_rows, "tqdne_tpu_torch/csrc/flash_attention.cu",
         "tqdne_tpu/ops/flash_attention.py:65"),
    ):
        which = 0 if name == "group_norm_silu" else 1
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name],
            ms=summed(rows, "ms"), plain_ms=summed(rows, "plain_ms"),
            bound_ms=summed(rows, "bound_ms"),
            bound_by="bytes" if summed(rows, "bytes_ms") >= summed(rows, "ops_ms")
            else "operations",
            library_ms=summed(rows, "library_ms"), issue_ms=summed(rows, "issue_ms"),
            per=f"all calls of one UNet eval{' and one decode' if which == 0 else ''}, "
                f"batch {BATCH}, bf16",
            launches_per_run={**{run: counts[run][which] for run in counts},
                              "train": train_counts[name],
                              **{run: c[which] for run, c in path_counts.items()},
                              **{run: c[name] for run, c in recipe_counts.items()}},
            classifier_forward=clf_sums[name] | {"per": f"one classifier forward, batch {BATCH}, "
                                                        f"bf16"},
            classifier_train_step=clf_step_sums[name],
        ))
    for name, line in (("flash_attention_bwd_dkdv", 209), ("flash_attention_bwd_dq", 274)):
        rows = [row[name] for row in bwd]
        kernels.append(dict(
            name=name, route="cuda", source="tqdne_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=f"tqdne_tpu/ops/flash_attention.py:{line}",
            launches=launches[name], max_abs_err=errs[name],
            ms=summed(rows, "ms"), plain_ms=summed(rows, "plain_ms"),
            bound_ms=summed(rows, "bound_ms"),
            bound_by="bytes" if summed(rows, "bytes_ms") >= summed(rows, "ops_ms")
            else "operations",
            library_ms=summed(rows, "library_ms"), issue_ms=summed(rows, "issue_ms"),
            per=f"all calls of one train step, batch {TRAIN_BATCH}, bf16; library_ms is the "
                f"SDPA backward, which computes dq, dk and dv together",
            launches_per_run={"train": train_counts[name],
                              **{run: c[name] for run, c in recipe_counts.items()}},
            classifier_train_step=clf_step_sums[name],
        ))
    redesigned = {
        "group_norm_silu": "one launch: a thread-block cluster over row chunks of whole-group "
                           "channel slices, each chunk staged once with 16-byte loads, "
                           "statistics merged through distributed shared memory",
        "flash_attention": "bf16 tensor cores (mma.sync m16n8k16); FMA loops in f32",
        "flash_attention_bwd_dkdv": "bf16 tensor cores (mma.sync m16n8k16); FMA loops in f32",
        "flash_attention_bwd_dq": "bf16 tensor cores (mma.sync m16n8k16) with delta = "
                                  "rowsum(dO * O) folded in; FMA loops in f32",
    }
    for entry in kernels:
        entry["redesigned"] = redesigned[entry["name"]]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
