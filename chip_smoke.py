"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the four CUDA sources of ``tqdne_tpu_torch/csrc`` (one nvcc each,
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
   and at the shapes of the EDM recipes beyond the flagship (``1d_edm``,
   ``1d_autoencoder``, ``1d_latent_edm``, ``edm``): every GroupNorm (S, C)
   of their samplers' UNet evals and decodes and of their train steps, at
   batch 32 and 256 (1D) or 64 (``edm``), and the flash kernels at (32, 508,
   4, 64), (256, 508, 4, 64), (32, 127, 4, 64), (256, 127, 4, 64), (32, 256,
   4, 128) and (64, 256, 4, 128), and at the ``latent_dit`` DiT-XL/2's
   (128, 256, 16, 72) as fused-qkv views; and at the few-eval and DDPM recipes'
   (``consistency``, ``latent_consistency``, ``latent_distill``, ``ddpm``)
   (shape, batch) pairs not held above: their samplers' at batch 32 and their
   train steps' at batch 256 (the flagship UNet and encoder, and the flash
   kernels at (256, 16, 4, 128)); and at the shapes of 4n below (GroupNorm without SiLU
   at every scale-shift ``out_norm`` of the options UNet, its resample-free
   autoencoder's, the paired 1D UNet's at batch 64 with its flash kernels at
   (64, 508, 4, 64)); and the convolutions' bias epilogue at every convolution
   output of the flagship UNet and decoder at batch 1024 and of the
   ``1d_edm`` UNet at 128 and 256, channels innermost and channels first, f32
   and bf16, with and without the ResBlock's embedding shift, bit for bit;
3. full-width flagship sampling in f32, 2 Heun steps, once through the
   kernels and once through the plain versions: the decoded spectrograms
   must agree (TF32 off); the full-width f32 classifier the same way (its
   embeddings and logits); then one full-width f32 train step of each recipe
   (the flagship's frozen encoder, EDM loss and backward; the autoencoder's
   reconstruction and KL; the classifier's weighted cross-entropy through two
   attention blocks) with the same injected draws, in eval mode, both ways:
   the loss to 1e-5 relative and every parameter gradient to 1e-3 of its
   peak, with every flash backward through the kernels; the same for a
   full-width f32 ``1d_edm`` and ``edm`` sample (batch 4) and one full-width
   f32 train step of each of the four recipes beyond the flagship; and for a
   full-width f32 ``consistency`` and ``latent_distill`` sample (2 network
   evals, the same draws) and one f32 step of each few-eval and DDPM recipe;
4. the main paths, each with the launch counters set to 0 just before it and
   read just after (GroupNorm, flash forward and backward, and the bias
   epilogue: 78 launches, 22 with a shift, per UNet eval and 18 per decode):
   sampling (``build_inference`` + ``generate`` at full width
   in bf16, batch 32, Heun-25 then dpmpp_2m-10, each with 32 Griffin-Lim
   iterations, seeded random weights; waveforms must be finite
   (32, 3, 4064)), training (``Trainer.fit`` through ``BatchLoader`` over
   in-memory synthetic waveforms, bf16 compute over f32 parameters, batch
   128, 20 steps; the loss must be finite), the recipes over the same 512
   waveforms (the autoencoder recipe, AdamW, batch 128, 20 steps; the
   classifier recipe, batch 64, 21 steps and one validation pass whose macro
   metrics must be finite; the precompute core over the waveforms with that
   autoencoder, then 20 flagship steps from the cached moments through
   ``DeviceResidentLoader``, with no encoder launch; 20 flagship steps with
   the representation on the device; the non-finite guard: a NaN batch
   leaves every parameter, the Adam moments and the update count as they
   were, the next clean batch moves them), serving (the HTTP server of
   ``tqdne_tpu_torch.serving`` on loopback over the dpmpp_2m-10 bundle: rounds
   of concurrent requests, a seeded request twice bit-identical and another
   seed different, coalescing) and evaluation (two ``evaluate_batch`` calls
   at the evaluate CLI's Heun-25 and Griffin-Lim 128 with the full-width
   bf16 classifier, then ``report_from_arrays``: FID, IS and ASD finite), the
   samplers of ``1d_edm``, ``1d_latent_edm`` and ``edm`` (``build_inference``
   + ``generate`` in bf16 at batch 32, Heun-25 and dpmpp_2m-10, Griffin-Lim 32
   for ``edm``; waveforms finite (32, 3, 4064)) and ``Trainer.fit`` of each of
   the four recipes, 10 bf16 steps at its batch (256, or 64 for ``edm``),
   whose last 5 give the recipe's samples/s; then
   (4k) the few-eval and DDPM samplers (bf16, batch 32: ``consistency``,
   ``latent_consistency`` and ``latent_distill`` at 1 and 2 network evals, the
   latent ones with decode and Griffin-Lim 32; ``ddpm`` at its 1000 steps),
   ``Trainer.fit`` of each of the four recipes, 20 bf16 steps at batch 256
   (RAdam at a constant rate; ``latent_distill`` with a seeded-random teacher,
   4 UNet forwards a step; the last 10 give its samples/s), and RAdam under
   the non-finite guard (a NaN batch
   leaves the parameters, moments and count where they were); then (4l) the
   sampling-eval callback: a ``Trainer.fit`` of the flagship at full width with
   the callback firing once on two validation batches of 256 (Heun-25, decode,
   Griffin-Lim 128, the ASD of each channel; no figures: matplotlib is absent
   on the GPU machine), its pass timed by part and batch 0 bit for bit a
   direct sample and inversion at its seed; a sample with a NaN row zeroed and
   warned; the ``consistency`` callback and DDPM's at 20 timesteps; then the
   seismology of the callback's 512 waveforms on the card against the host
   (peaks, ``residual_report``, RotD50 SA against the plain loop), timed; then
   (4m) reference checkpoints and the data scans: full-width reference
   Lightning checkpoints of the flagship UNet, the autoencoder and the
   classifier (seeded random weights in the reference's key layout, each with
   an EMA that differs from its live weights) imported by
   ``cli.import_checkpoint``, the flagship sampled (bf16, batch 32,
   dpmpp_2m-10, GL 32) from the imported runs and from the checkpoints
   converted on the fly, each bit-identical to the EMA weights' ``.pt`` route
   with the flagship's launches, one forward of the imported classifier
   bit-identical to its ``.pt``; ``compute_validity_indices`` and
   ``quality_report`` over 4096 records of 3 x 12501 f32 on the card against
   the host over the first 512 (indices and flags exact, the linear-trend R^2
   to 1e-9), import, first-waveform and scan seconds printed; then (4n) the
   UNet's options and paired data: the flagship UNet with every option of the
   JAX UNet (``cond_emb_scale``, ``use_scale_shift_norm``,
   ``conv_resample=False``, ``use_checkpoint``) over the autoencoder without
   resampling convolutions, 10 ``Trainer.fit`` steps at 128 checkpointed and
   the same 10 from the same state without (the first loss bit-identical, the
   parameters to the bf16 bound, a step's memory both ways), saved as runs and
   rebuilt by ``build_inference`` from their ``hparams.json`` (Heun-25 and
   dpmpp_2m-10 at 32 with Griffin-Lim 32, an f32 sample against the plain
   versions), one autoencoder step at 128; the paired flagship over a
   ``PairedDataset`` of two in-memory tables (10 steps at 128, both signals
   encoded; one autoencoder step with its ``cond_*`` losses; a dpmpp_2m-10
   sample at 32 from a validation ``cond_signal``, Griffin-Lim 32); paired
   ``consistency`` and ``ddpm`` on the ``1d_edm`` UNet (2 steps at 64, a sample
   at 32 of 2 evals and of 20 DDPM timesteps); the counts must be exact;
   then (4o) data parallelism: (a) in a subprocess, phase 4's flagship
   ``Trainer.fit`` without a process group, again in an NCCL group of one
   (joined through torchrun's environment) and again once the group is
   destroyed: no collective issued, the launches equal to phase 4's and the
   parameters bit-identical, samples/s beside phase 4's; (d) there too, one flagship step through
   ``parallel.fsdp.shard_with_ema`` at world size 1 against the plain step;
   (b) two ranks sharing the card over gloo: 2 f32 flagship steps at 2 x 64
   (dropout 0, plain SGD) against one rank's at 128 (losses to 1e-5, the
   averaged gradients to 1e-4 of each one's peak plus 1e-6 of the largest,
   parameters to the f32 bound, the ranks bit-identical), then 5 bf16 steps with their
   launches, walls and the gradient all-reduce's share (not a scaling
   figure); (c) the train CLI's ``-d 2`` refused on one card, its ``-d 1``
   reaching the run; then (4p) spatial partitioning, two ranks sharing the card
   over gloo: the full-width flagship built with ``spatial=2`` (each sample's
   rows split in two, halo convolutions, GroupNorm through the kernel's
   statistics and normalisation entries with the shards' statistics merged,
   attention over the gathered tokens) sampled by dpmpp_2m-10 with its decode,
   in f32 at batch 2 and 32 against one rank's sample (to 1e-4 of the peak) and
   in bf16 at 32 (relative L2 error within bf16's 1.6e-2), with exact launches
   (the statistics and normalisation entries once for each GroupNorm of one
   rank's run, no fused launch, the flash forward as one rank's); a bf16
   ``generate`` timed with its collectives' share; one f32 flagship train step
   at 32 (dropout 0, SGD) against one rank's (loss to 1e-4, every gradient to
   1e-4 of its peak plus 1e-6 of the largest, the flash backward kernels run);
   one ``serve --spatial 2`` round on loopback; then the two entries against
   their plain versions at every GroupNorm shape of one UNet eval and one
   decode on one shard (f32, and the path's bf16 pairs) and timed; then (4q) the
   int8 mode: the flagship in bf16 at batch 32 with and without ``int8`` at
   Heun-25 and dpmpp_2m-10 (Griffin-Lim 32), waveforms/s of each, launches, the
   decoded signal's cosine against bf16 (at least 0.98), the int32 sums of
   every convolution shape of one UNet eval and one decode bit-identical to the
   float64 convolution of the codes on the card, and one quantized convolution's
   device ms beside cuDNN's bf16 convolution at ds 1, ds 4 and the decoder's
   128 x 128;
5. timings on the card: each kernel at the main paths' shapes beside its
   bound, its plain version and a PyTorch yardstick call (and, for the
   record, the bf16 flash forward at (128, 16, 4, 128)), GroupNorm per UNet
   eval, per train step and per classifier forward, end-to-end waveforms/s
   (through the server too, with request latencies and one round of JSON
   responses) and training samples/s, the guarded flagship step against the
   plain flagship step in alternated single steps (issue and wall ms, device
   ms and launches of one profiled step), each recipe step's samples/s in one
   window,
   the classifier train step's kernels at (64, 256, 4, 64) and its GroupNorm
   shapes, a profiled sampling run, a profiled classifier forward, and a
   profiled train step of the flagship, the classifier and the autoencoder
   by kernel class, and one train step at the recipe's batch 256; then each
   recipe beyond the flagship: a profiled step by kernel class, the 1D
   ``Norm32`` transposes of a ``1d_edm`` step, and each kernel per call at
   its train step's and sampler's shapes; then (5c) the same for the
   few-eval and DDPM recipes: a profiled step, each few-eval sampler's
   profiled device time, DDPM's device ms a step, and each kernel per call
   at the new shapes (a shape and batch is timed once a run, and its row
   reused), and the callback's UNet eval and decode at batch 256; GroupNorm
   without SiLU at the options UNet's shapes at batch 128; the bias epilogue
   over one UNet eval and one decode and over one ``1d_edm`` UNet eval
   beside its byte bound, its plain version and ATen's adds it replaced.

Prints the card's name and power limit and a ``{"kernels": [...]}`` line,
then, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
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
TRAIN_STEPS = 20
TRAIN_E2E_RUNS, TRAIN_E2E_STEPS = 3, 8  # timed train_step windows for [train-e2e]
TRAIN_SAMPLES = 512  # synthetic waveforms in memory: 4 batches per epoch
CLF_TRAIN_BATCH = 64  # the classifier recipe's batch
AE_STEPS = 20  # Trainer.fit steps of the autoencoder recipe: 5 epochs of 4 batches
CLF_STEPS = 21  # of the classifier recipe: 3 epochs of 7 batches of its 460 rows, one validation
GUARD_N = 3  # skip_nonfinite of the guard's check and timing
STEP_PAIRS = 8  # alternated single-step pairs of the guard's cost
SERVE_CLIENTS, SERVE_ROWS, SERVE_ROUNDS = 16, 4, 3  # concurrent requests of 4 rows, 3 rounds
SERVE_DELAY_MS = 15.0  # the serve CLI's micro-batching window
SERVE_FULL_CLIENTS, SERVE_FULL_ROUNDS = 4, 2  # concurrent requests of a full batch, 2 rounds
EVAL_BATCHES = 2  # evaluate_batch calls at batch 32 (Heun-25, Griffin-Lim 128)
CLASSIFIER_SEED = SEED + 2
CKPT_STEP = 4321  # the reference checkpoints' global_step (4m)
SCAN_RECORDS, SCAN_HOST, SCAN_T = 4096, 512, 12501  # 4m: records on the card, on the host; T
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 vector
GN_OPS_PER_ELEM = {True: 10, False: 7}  # moments 2, normalise+affine 4 (+1 store), SiLU 3
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1.6e-2, 1e-3)}  # rtol, atol
# flash backward: f32 takes the JAX package's own gradient bound
# (tests/test_flash_attention.py); bf16 outputs one bf16 step, as above
BWD_TOL = {torch.float32: (2e-3, 2e-4), torch.bfloat16: (1.6e-2, 1e-3)}


T0 = time.perf_counter()


def log(msg: str):
    print(msg, flush=True)


def phase(name: str):
    """Mark the start of a phase with the script's elapsed seconds."""
    log(f"[phase] {name} at {time.perf_counter() - T0:.1f} s")


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


def sleep_cycles_per_ms() -> float:
    """The clock cycles ``torch.cuda._sleep`` spins per millisecond."""
    if not hasattr(sleep_cycles_per_ms, "rate"):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(10**7)
        end.record()
        torch.cuda.synchronize()
        sleep_cycles_per_ms.rate = 10**7 / start.elapsed_time(end)
    return sleep_cycles_per_ms.rate


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of ``fn`` issued back to back: CUDA events around
    ``reps`` calls queued behind a spin kernel (``torch.cuda._sleep``) that
    holds the device until the host has issued them all, so the host's
    overhead, which exceeds a call's kernels at the UNet's shapes, does not
    show.  A window is kept only if the spin outlasted the host's issuing;
    the median of three.  (torch.profiler's summed kernel durations read up
    to 2.3x low late in this script, as if records were dropped: a fresh
    process read the same kernels right.)"""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    spin_ms = 2e3 * (time.perf_counter() - t0) + 1.0
    torch.cuda.synchronize()
    times = []
    while len(times) < 3:
        queued, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        queued.record()
        t0 = time.perf_counter()
        torch.cuda._sleep(int(spin_ms * sleep_cycles_per_ms()))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        issued_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        if queued.elapsed_time(start) > issued_ms:
            times.append(start.elapsed_time(end) / reps)
        else:
            spin_ms *= 2
            if spin_ms > 1e4:
                fail("device_ms: the host could not queue the calls within 10 s of spin")
    return statistics.median(times)


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
    # the DiT-XL/2's token attention at the latent_dit cell's batch: 256 tokens x 16 heads
    # of 72 (padded to the 128-wide head block), views of one (B, L, 3, H, D) qkv output
    flash_cases += [(128, 256, 16, 72, "fused")]
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
                             batches=(BATCH, TRAIN_BATCH), forced: bool = True) -> int:
    """GroupNorm (+SiLU) against its plain version: at every (S, C, G) of
    ``path_calls`` (sampling's UNet and decoder, training's UNet and
    encoder, the autoencoder and classifier recipes'), in f32 and in each
    (x, scale) dtype pair the paths give that shape, SiLU on and off, at
    each of ``batches`` (the paths' batch sizes); then
    cases that force the plan's other variants: the largest cluster the card
    co-schedules, the re-read variant, element loads (views one element into
    their buffers, a C of 12 in bf16) and groups of 5 channels (unless not
    ``forced``).  Records the largest error in ``errs``; returns the number
    of failed checks."""
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
    forced = [] if not forced else [(2, largest, 64, 32, bf16, bf16, "largest cluster"),
              (2, 65536, 64, 32, f32, f32, "re-read"),
              (BATCH, 1024, 128, 32, bf16, bf16, "offset"),
              (TRAIN_BATCH, 16384, 64, 32, bf16, f32, "offset"),
              (4, 4096, 64, 32, f32, f32, "offset"),
              (4, 100, 12, 4, bf16, bf16, "narrow C"),
              (4, 17, 40, 8, f32, f32, "groups of 5"),
              (4, 17, 40, 8, bf16, f32, "groups of 5")]
    errs.setdefault("group_norm_silu", 0.0)
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


def check_group_norm_backward(gen, dev, errs: dict, shapes, forced: bool = True) -> int:
    """The GroupNorm backward kernel against autograd over the plain version: dx, dscale and
    dbias at each (B, S, C, G) of ``shapes`` (the training paths') in every (x, scale) dtype
    pair, SiLU on with the gradient as a transposed view (the 1D ``Norm32``'s) and off with a
    contiguous one; then (unless not ``forced``) element loads, groups of 5, a narrow C, the
    largest cluster and the re-read variant.  Each case launches the kernel twice on the same
    inputs: all three gradients must be bit-identical (no atomics in the sums), and each
    backward one launch.  Records the largest error in ``errs``; returns failed checks."""
    from tqdne_tpu_torch.ops.group_norm import (
        cluster_limit,
        group_norm_plan,
        group_norm_silu,
        group_norm_silu_plain,
    )

    f32, bf16 = torch.float32, torch.bfloat16
    limit = cluster_limit(torch.cuda.current_device())
    cases = [(b, s, c, g, dtype, pdtype, "path") for b, s, c, g in sorted(set(shapes))
             for dtype, pdtype in ((f32, f32), (bf16, bf16), (bf16, f32))]
    largest = next((s for s in range(4096, 1 << 18, 512) if group_norm_plan(
        2, s, 64, 32, bf16, bf16, True, limit, True).cluster == limit), None)
    if forced and largest is None:
        fail(f"no GroupNorm backward shape plans a cluster of {limit}")
    if forced:
        cases += [(2, largest, 64, 32, bf16, bf16, "largest cluster"),
                  (2, 32768, 64, 32, f32, f32, "re-read"),
                  (4, 4096, 64, 32, f32, f32, "offset"),
                  (TRAIN_BATCH, 2032, 128, 32, bf16, f32, "offset"),
                  (4, 100, 12, 4, bf16, bf16, "narrow C"),
                  (4, 17, 40, 8, f32, f32, "groups of 5"),
                  (4, 17, 40, 8, bf16, f32, "groups of 5")]
    errs.setdefault("group_norm_silu_backward", 0.0)
    bad = 0
    for b, s, c, g, dtype, pdtype, case in cases:
        n = b * s * c
        buf = (torch.randn(n + 1, generator=gen, device=dev) * 2 + 0.5).to(dtype)
        x = buf[1:].view(b, s, c) if case == "offset" else buf[:n].view(b, s, c)
        plan = group_norm_plan(b, s, c, g, dtype, pdtype, x.data_ptr() % 16 == 0, limit, True)
        want_variant = {"largest cluster": plan.cluster == limit and plan.resident,
                        "re-read": not plan.resident, "offset": plan.vec == 1,
                        "narrow C": plan.vec == 1}.get(case, True)
        for silu in (True, False):
            w = (1 + 0.1 * torch.randn(c, generator=gen, device=dev)).to(pdtype)
            bias = (0.1 * torch.randn(c, generator=gen, device=dev)).to(pdtype)
            if silu:
                dy = torch.randn(b, c, s, generator=gen, device=dev).to(dtype).transpose(1, 2)
            else:
                dy = torch.randn(b, s, c, generator=gen, device=dev).to(dtype)

            def grads(fn):
                leaves = [t.detach().requires_grad_() for t in (x, w, bias)]
                fn(*leaves, g, 1e-5, silu).backward(dy)
                return [t.grad for t in leaves]

            before = (group_norm_silu.backward_launches, group_norm_silu.backward_calls)
            got, again = grads(group_norm_silu), grads(group_norm_silu)
            launched = (group_norm_silu.backward_launches - before[0],
                        group_norm_silu.backward_calls - before[1])
            want = grads(group_norm_silu_plain)
            same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
            checks = [close(gt, wt, t.dtype, BWD_TOL) for gt, wt, t in zip(got, want, (x, w, w))]
            ok = all(o for _, o in checks) and same and launched == (2, 2) and want_variant
            errs["group_norm_silu_backward"] = max(errs["group_norm_silu_backward"],
                                                   *(e for e, _ in checks))
            bad += not ok
            log(f"[check] group_norm_silu_backward B={b} S={s} C={c} G={g} "
                f"x={str(dtype)[6:]} scale={str(pdtype)[6:]} silu={silu} {case}: plan=("
                f"{plan.slice_channels} ch x {plan.slices}, cluster {plan.cluster} x "
                f"{plan.chunk_rows} rows, {plan.threads} threads, vec {plan.vec}, resident "
                f"{plan.resident}, {plan.smem} B) max_abs_err dx/dscale/dbias="
                f"{'/'.join(f'{e:.3e}' for e, _ in checks)} tol(rtol,atol)="
                f"{BWD_TOL[dtype]}/{BWD_TOL[pdtype]}; bit-identical twice {same}; "
                f"launches/calls {launched} {'ok' if ok else 'FAIL'}")
    log(f"[check] {2 * len(cases)} GroupNorm backward cases")
    return bad


def conv_output(b, shape, dtype, channels_last, gen, dev):
    """A convolution's (B, C, *spatial) output of ``shape`` = (C, *spatial) in ``dtype``,
    channels innermost in memory where ``channels_last``, a bias (C,) and a shift (B, C)."""
    c, *sp = shape
    if channels_last:
        y = torch.randn((b, *sp, c), generator=gen, device=dev).to(dtype).movedim(-1, 1)
    else:
        y = torch.randn((b, c, *sp), generator=gen, device=dev).to(dtype)
    bias = torch.randn(c, generator=gen, device=dev).to(dtype)
    shift = torch.randn(b, c, generator=gen, device=dev).to(dtype)
    return y, bias, shift


def check_conv_bias_kernels(gen, dev, errs: dict, cases) -> int:
    """The convolutions' bias epilogue against its plain version at each (batch, output
    (C, *spatial)) of ``cases``, channels innermost and channels first, f32 and bf16, with
    and without the shift: bit for bit, in place, one launch a call.  Returns the failures."""
    from tqdne_tpu_torch.ops.conv_bias import conv_bias_add, conv_bias_add_plain

    bad = n = 0
    errs.setdefault("conv_bias_add", 0.0)
    for b, shape in cases:
        for channels_last in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                y, bias, shift = conv_output(b, shape, dtype, channels_last, gen, dev)
                for shifted in (False, True):
                    addend = shift if shifted else None
                    got, want = y.clone(), y.clone()  # the clones keep y's strides
                    launches = conv_bias_add.launches
                    out = conv_bias_add(got, bias, addend)
                    conv_bias_add_plain(want, bias, addend)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    errs["conv_bias_add"] = max(errs["conv_bias_add"], err)
                    n += 1
                    if (out is not got or conv_bias_add.launches != launches + 1
                            or got.stride() != y.stride() or not torch.equal(got, want)):
                        bad += 1
                        log(f"[check] conv_bias_add B={b} {shape} channels_last={channels_last} "
                            f"{dtype} shift={shifted}: max_abs_err={err:.3e} MISMATCH")
                    del got, want, out
                del y, bias, shift
                torch.cuda.empty_cache()
    log(f"[check] conv_bias_add: {n} cases over {len(cases)} (batch, output) pairs, both "
        f"layouts, f32 and bf16, with and without the shift: {bad} differ from the plain "
        f"version, max_abs_err={errs['conv_bias_add']:.3e}")
    return bad


def gn_backward_timing(gen, dev, dtype, pdtype, s, c, g, silu, batch,
                       channels_first: bool = False) -> dict:
    """Device ms of one GroupNorm backward at (batch, S, C) with G groups: the kernel's entry
    with a contiguous gradient (``ms``) and with a transposed one, the 1D ``Norm32``'s, whose
    copy the wrapper makes (``transposed_ms``); the plain recompute under autograd
    (``plain_ms``, what the backward was before its kernel); the library's backward
    (``library_ms``: autograd through ``F.silu(F.group_norm(...))`` over its recorded forward,
    scale and bias in x's dtype, on x and dy as (B, C, S) views, channels first where
    ``channels_first``, the 1D UNet's layout, else channels last, the flagship's); the least
    time of x and dy read once and dx written once (``bound_ms``); and the launches of one
    call."""
    import torch.nn.functional as F

    from tqdne_tpu_torch.ops.group_norm import _launch_backward, group_norm_silu_plain

    x = torch.randn(batch, s, c, generator=gen, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(c, generator=gen, device=dev)).to(pdtype)
    b = (0.1 * torch.randn(c, generator=gen, device=dev)).to(pdtype)
    dy_t = torch.randn(batch, c, s, generator=gen, device=dev).to(dtype).transpose(1, 2)
    dy = dy_t.contiguous()
    leaves = [t.detach().requires_grad_() for t in (x, w, b)]

    def plain():
        with torch.enable_grad():
            torch.autograd.grad(group_norm_silu_plain(*leaves, g, 1e-5, silu), leaves, dy)

    x_l = x.transpose(1, 2).contiguous() if channels_first else x.transpose(1, 2)
    lib_leaves = [t.detach().requires_grad_() for t in (x_l, w.to(dtype), b.to(dtype))]
    dy_l = dy_t.transpose(1, 2) if channels_first else dy.transpose(1, 2)
    with torch.enable_grad():
        lib_out = F.group_norm(lib_leaves[0], g, *lib_leaves[1:], 1e-5)
        lib_out = F.silu(lib_out) if silu else lib_out

    def library():
        torch.autograd.grad(lib_out, lib_leaves, dy_l, retain_graph=True)

    nbytes = 3 * x.numel() * x.element_size() + 4 * c * w.element_size()
    return dict(shape=[batch, s, c], groups=g, silu=silu, dtype=str(dtype)[6:],
                scale_dtype=str(pdtype)[6:],
                ms=device_ms(lambda: _launch_backward(x, dy, w, b, g, 1e-5, silu)),
                transposed_ms=device_ms(lambda: _launch_backward(x, dy_t, w, b, g, 1e-5, silu)),
                plain_ms=device_ms(plain), library_ms=device_ms(library),
                library_layout="channels first" if channels_first else "channels last",
                bound_ms=1e3 * nbytes / HBM_BYTES_PER_S)


CONV_BIAS_KERNELS = ("bias_channels_kernel", "bias_rows_kernel")
OWN_KERNELS = ("group_norm_silu_kernel", "group_norm_silu_bwd_kernel", "flash_fwd",
               "flash_bwd_dkdv", "flash_bwd_dq", *CONV_BIAS_KERNELS)
KERNEL_CLASSES = (("group_norm_silu", ("group_norm_silu_kernel",)),
                  ("flash_attention", ("flash_fwd",)),
                  ("conv_bias_add", CONV_BIAS_KERNELS),
                  ("convolution", ("conv", "xmma", "cudnn", "implicit", "gemm", "cutlass")),
                  ("fft", ("fft",)))


def profiled(fn):
    """(profiler, wall ms) of one ``fn()``, and a note of how many of the
    port's kernel launches in it (by the wrappers' counters) the profiler
    kept a device record of: it drops records now and then."""
    from torch.profiler import ProfilerActivity, profile

    from tqdne_tpu_torch.ops.group_norm import group_norm_silu

    def count():
        return sum(k.launches for k in launch_counters() if not isinstance(k, ShiftedLaunches)
                   ) + group_norm_silu.backward_launches

    before = count()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    launched = count() - before
    recorded = sum(e.count for e in device_kernels(prof)
                   if any(name in e.key for name in OWN_KERNELS))
    return prof, wall_ms, f"the profiler kept {recorded} of {launched} kernel launches of the port"


def profile_breakdown(fn, label: str, tag: str = "profile") -> dict | None:
    """Device time of one ``fn()`` by kernel class, from torch.profiler."""
    prof, wall_ms, kept = profiled(fn)
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
        f"{total_ms:.3f} ms (busy share {total_ms / wall_ms:.3f}; {kept}); by class (ms): "
        f"{json.dumps({k: round(v, 3) for k, v in classes.items()})}; kernels by class: "
        f"{json.dumps(counts)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:110]}")
    return dict(wall_ms=wall_ms, device_ms=total_ms, busy_share=total_ms / wall_ms, **classes)


GN_BWD_CLASS = "group_norm_silu_backward"  # the kernel, dy's copy and the partials' sum
TRAIN_CLASSES = (("group_norm_silu", ("group_norm_silu_kernel",)),
                 (GN_BWD_CLASS, ("group_norm_silu_bwd_kernel",)),
                 ("flash_fwd", ("flash_fwd",)),
                 ("flash_bwd_dkdv", ("flash_bwd_dkdv",)),
                 ("flash_bwd_dq", ("flash_bwd_dq",)),
                 ("conv_bias_add", CONV_BIAS_KERNELS),
                 ("convolution_gemm", ("conv", "xmma", "cudnn", "implicit", "gemm", "cutlass",
                                       "wgrad", "dgrad")),
                 ("copies_and_casts", ("direct_copy", "copy_kernel")),
                 ("optimizer_ema", ("multi_tensor", "foreach")))


def kernel_class(name: str) -> str:
    return next((n for n, keys in TRAIN_CLASSES if any(k in name.lower() for k in keys)),
                "other")


def train_profile(step, label: str):
    """Device time of one train step by kernel class.  The GroupNorm
    backward's class holds its kernel (by name: its ctypes launch is no
    child of the range) and the kernels found under its profiler range
    (``tq::group_norm_silu_backward``: the copy of a transposed gradient
    and the sum of the partials)."""
    from torch.autograd import DeviceType

    prof, wall_ms, kept = profiled(step)
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

    cpu_events = [ev for ev in prof.events() if ev.device_type == DeviceType.CPU]
    ranges = [ev for ev in cpu_events if ev.name == "tq::group_norm_silu_backward"]
    for ev in ranges:
        walk(ev)
    for k in found:
        classes[kernel_class(k.name)] -= k.duration / 1e3
        classes[GN_BWD_CLASS] += k.duration / 1e3
    # the copies and casts of the backward: those under an autograd node's range (outside
    # the GroupNorm backward, counted above), by the node that launched them
    in_gn_bwd = {id(k) for k in found}
    bwd_copies = collections.Counter()
    for ev in cpu_events:
        if ev.name.startswith("autograd::engine::evaluate_function: "):
            found.clear()
            walk(ev)
            node = ev.name.split(": ", 1)[1]
            for k in found:
                if id(k) not in in_gn_bwd and kernel_class(k.name) == "copies_and_casts":
                    bwd_copies[node] += k.duration / 1e3
    copies_bwd = sum(bwd_copies.values())
    log(f"[train-profile] {label}: wall {wall_ms:.3f} ms under the profiler, device kernels "
        f"{total_ms:.3f} ms in {launched} launches (busy share {total_ms / wall_ms:.3f}; "
        f"{kept}; device-side ranges left out: {left_out}); {len(ranges)} GroupNorm "
        f"backward ranges holding {len(in_gn_bwd)} kernels; by class (ms): "
        f"{json.dumps({k: round(v, 3) for k, v in classes.items()})}; copies and casts: "
        f"forward {classes['copies_and_casts'] - copies_bwd:.3f}, backward {copies_bwd:.3f} "
        f"ms, the backward's by autograd node "
        f"{json.dumps({k: round(v, 3) for k, v in bwd_copies.most_common(6)})}")
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
    """Run the models' GroupNorm, attention and convolution bias epilogue through the plain
    versions."""
    from tqdne_tpu_torch.nn import attention as attention_mod
    from tqdne_tpu_torch.nn import layers as layers_mod
    from tqdne_tpu_torch.ops.conv_bias import conv_bias_add_plain
    from tqdne_tpu_torch.ops.flash_attention import flash_attention_plain
    from tqdne_tpu_torch.ops.group_norm import group_norm_silu_plain

    saved = layers_mod.group_norm_silu, attention_mod.flash_attention, layers_mod.conv_bias_add
    layers_mod.group_norm_silu, attention_mod.flash_attention, layers_mod.conv_bias_add = (
        group_norm_silu_plain, flash_attention_plain, conv_bias_add_plain)
    try:
        yield
    finally:
        layers_mod.group_norm_silu, attention_mod.flash_attention, layers_mod.conv_bias_add = \
            saved


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


def serve_path(bundle, per_batch: tuple[int, int, int]) -> tuple[int, int, int]:
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
    card.  ``per_batch``: the (GroupNorm, flash, bias epilogue) launches of
    one device batch.  Returns the counted launches."""
    from argparse import Namespace

    import numpy as np

    from tqdne_tpu_torch import serving
    from tqdne_tpu_torch.cli.generate_waveforms import normalize, read_conditioning
    from tqdne_tpu_torch.ops.conv_bias import conv_bias_add
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
        group_norm_silu.launches = flash_attention.launches = conv_bias_add.launches = 0
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
        counts = (group_norm_silu.launches, flash_attention.launches, conv_bias_add.launches)
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
        f"{served}; launches group_norm_silu={counts[0]} flash_attention={counts[1]} "
        f"conv_bias_add={counts[2]} (batches x {per_batch}); seeded repeat bit-identical {repeat_equal}, another seed differs "
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
    if counts != tuple(batches * n for n in per_batch):
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


def evaluate_path(bundle, classifier,
                  per_batch: tuple[int, int, int]) -> tuple[int, int, int]:
    """The evaluation path: EVAL_BATCHES ``evaluate_batch`` calls at batch 32
    over in-memory synthetic waveforms, with the launch counters set to 0
    just before and read just after, then ``report_from_arrays`` over their
    outputs; FID, IS and ASD must be finite.  ``per_batch``: the (GroupNorm,
    flash, bias epilogue) launches of one batch.  Returns the counted launches."""
    import numpy as np

    from tqdne_tpu_torch.cli.evaluate import evaluate_batch
    from tqdne_tpu_torch.data.dataset import ArrayDataset, synthetic_arrays
    from tqdne_tpu_torch.eval.report import report_from_arrays
    from tqdne_tpu_torch.ops.conv_bias import conv_bias_add
    from tqdne_tpu_torch.ops.flash_attention import flash_attention
    from tqdne_tpu_torch.ops.group_norm import group_norm_silu
    from tqdne_tpu_torch.utils import fold_seed

    n = EVAL_BATCHES * BATCH
    data = ArrayDataset(synthetic_arrays(n, t=bundle.t, seed=SEED), bundle.representation,
                        cut=bundle.t, cond=True, split="full")
    with torch.no_grad():  # the classifier's cuDNN plans at batch 32, outside the count
        classifier.embed_and_logits(torch.zeros(BATCH, 128, 128, 3, device=bundle.device))
    torch.cuda.synchronize()
    group_norm_silu.launches = flash_attention.launches = conv_bias_add.launches = 0
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
    counts = (group_norm_silu.launches, flash_attention.launches, conv_bias_add.launches)
    arrays = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    arrays |= {k: data.get_feature(k)[:n] for k in ("magnitude", "hypocentral_distance")}
    report = report_from_arrays(arrays)
    finite = all(math.isfinite(v) for v in (report["fid"], report["inception_score"],
                                            *report["asd_frechet_per_channel"],
                                            *report["mse_per_channel"]))
    log(f"[evaluate] {EVAL_BATCHES} evaluate_batch calls (Heun-25 + GL 128, batch {BATCH}, "
        f"bf16, classifier bf16): wall ms per batch {[round(t, 3) for t in wall_ms]}; launches "
        f"group_norm_silu={counts[0]} flash_attention={counts[1]} conv_bias_add={counts[2]} "
        f"(batches x {per_batch}); "
        f"report over {n} waveforms: fid {report['fid']:.6e}, inception_score "
        f"{report['inception_score']:.6f}, asd_frechet_per_channel "
        f"{report['asd_frechet_per_channel']}, mse_per_channel {report['mse_per_channel']}, "
        f"classifier accuracy target/predicted {report['classifier_accuracy_target']:.4f} / "
        f"{report['classifier_accuracy_predicted']:.4f} (random weights: the values only "
        f"show that the path runs)")
    if not finite or arrays["predicted_waveform"].shape != (n, 3, bundle.t):
        fail("evaluation: a non-finite statistic or a wrong waveform shape")
    if counts != tuple(EVAL_BATCHES * n for n in per_batch):
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


class ShiftedLaunches:
    """``conv_bias_add.shifted_launches`` read and set as a counter's ``launches``."""

    __name__ = "conv_bias_add.shifted"

    @property
    def launches(self) -> int:
        from tqdne_tpu_torch.ops.conv_bias import conv_bias_add

        return conv_bias_add.shifted_launches

    @launches.setter
    def launches(self, value: int):
        from tqdne_tpu_torch.ops.conv_bias import conv_bias_add

        conv_bias_add.shifted_launches = value


def launch_counters():
    """Every kernel wrapper's launch counter (``fn.launches``), and the bias epilogue's
    launches with a shift."""
    from tqdne_tpu_torch.ops.conv_bias import conv_bias_add
    from tqdne_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dq,
    )
    from tqdne_tpu_torch.ops.group_norm import group_norm_silu

    return (group_norm_silu, flash_attention, flash_attention_bwd_dkdv, flash_attention_bwd_dq,
            conv_bias_add, ShiftedLaunches())


def want_launches(gn: int = 0, fa: int = 0, bwd: int = 0, convs=()) -> dict:
    """The launches a path must count: GroupNorm, flash forward, each backward kernel, and
    the convolutions' bias epilogue, all and with a shift, over ``convs``: (the convolution
    calls of one forward, as ``record_calls`` gives them, forwards) pairs."""
    return {"group_norm_silu": gn, "flash_attention": fa, "flash_attention_bwd_dkdv": bwd,
            "flash_attention_bwd_dq": bwd,
            "conv_bias_add": sum(len(calls) * n for calls, n in convs),
            "conv_bias_add.shifted": sum(sum(c[-1] for c in calls) * n for calls, n in convs)}


def counted_fit(label: str, steps, state, loader, *, max_steps: int, want: dict,
                want_gn_bwd: int, val_loader=None, eval_every: int = 10**6,
                metric_postprocess=None, lr_schedule=None, callbacks=()):
    """``Trainer.fit`` of ``state`` up to step ``max_steps`` (with
    ``callbacks``), with every launch counter and the GroupNorm backward
    counts set to 0 just before and read just after: they must equal ``want``
    and ``want_gn_bwd`` (backward calls, each one launch of the backward
    kernel on the card), every logged training loss must be finite and the
    checkpoint written.  Returns (counts, metric rows)."""
    from tqdne_tpu_torch.ops.group_norm import group_norm_silu
    from tqdne_tpu_torch.train.loop import Trainer

    workdir = Path(__file__).resolve().parent / "build" / f"chip_smoke_{label}"
    shutil.rmtree(workdir, ignore_errors=True)
    trainer = Trainer(*steps, workdir, device="cuda", max_epochs=10**4, max_steps=max_steps,
                      log_every=10, seed=SEED, checkpoint_every_epochs=10**6,
                      eval_every_epochs=eval_every, lr_schedule=lr_schedule,
                      metric_postprocess=metric_postprocess, callbacks=callbacks)
    kernels = launch_counters()
    torch.cuda.synchronize()
    for fn in kernels:
        fn.launches = 0
    group_norm_silu.backward_calls = group_norm_silu.backward_launches = 0
    t0 = time.perf_counter()
    trainer.fit(state, loader, val_loader, resume=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in kernels}
    gn_bwd = group_norm_silu.backward_calls
    gn_bwd_launches = group_norm_silu.backward_launches
    rows = [json.loads(line) for line in (workdir / "metrics.jsonl").open()]
    losses = [r["training/loss"] for r in rows if "training/loss" in r]
    traintime = [r["traintime"] for r in rows if "traintime" in r][-1:] or [0.0]
    log(f"[{label}] Trainer.fit to step {state.step} in {fit_s:.2f} s (checkpoint included), "
        f"logged losses {losses}, traintime {traintime[0]:.3f} s; launches "
        f"{counts}, GroupNorm backward calls {gn_bwd}, kernel launches {gn_bwd_launches}")
    if state.step != max_steps or not losses or not all(map(math.isfinite, losses)):
        fail(f"{label}: step {state.step} (want {max_steps}), losses {losses}")
    if (counts != want or gn_bwd != want_gn_bwd
            or gn_bwd_launches != (gn_bwd if DEVICE == "cuda" else 0)):
        fail(f"{label}: launches {counts} (GroupNorm backward {gn_bwd}, launched "
             f"{gn_bwd_launches}) != expected {want} ({want_gn_bwd})")
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


def rate_of(label: str, step, batch_size: int) -> float:
    """Samples/s of ``step`` (``batch_size`` samples a call) over one window of
    TRAIN_E2E_STEPS calls on a resident batch, after a warm-up call."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_E2E_STEPS):
        step()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    rate = batch_size * TRAIN_E2E_STEPS / sec
    log(f"[recipe-e2e] {label}: {rate:.2f} samples/s ({TRAIN_E2E_STEPS} steps in {sec:.3f} s on "
        f"a resident batch)")
    return rate


def tail_timed(step, max_steps: int, window: int):
    """``step`` wrapped to time the wall of the last ``window`` steps of a
    ``Trainer.fit`` to step ``max_steps``, the loader's batches and the
    trainer's own work between them included: the device is synced and the
    clock read after the step that leaves ``max_steps - window`` and after
    the last.  Returns the wrapped step and the list that receives the two
    readings."""
    marks = []

    def timed(state, batch, **kw):
        out = step(state, batch, **kw)
        if state.step in (max_steps - window, max_steps):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        return out

    return timed, marks


def tail_rate(label: str, marks: list, batch_size: int, window: int) -> float:
    """Samples/s of the ``window`` steps that ``tail_timed``'s ``marks`` span."""
    if len(marks) != 2:
        fail(f"{label}: {len(marks)} clock readings of the timed steps, not 2")
    sec = marks[1] - marks[0]
    rate = batch_size * window / sec
    log(f"[recipe-e2e] {label}: {rate:.2f} samples/s (the last {window} Trainer.fit steps in "
        f"{sec:.3f} s of wall, on the loader's batches)")
    return rate


# ---- the EDM recipes beyond the flagship: 1d_edm, 1d_autoencoder, 1d_latent_edm, edm ----
SAMPLERS = ("1d_edm", "1d_latent_edm", "edm")
RECIPE_BATCH = {"1d_edm": 256, "1d_autoencoder": 256, "1d_latent_edm": 256, "edm": 64}
RECIPE_STEPS = 10  # Trainer.fit steps of each recipe at its batch (2 or 8 per epoch)
F32_BATCH = 4  # the full-width f32 checks' batch


def conv_hooks(module, sink: list) -> list:
    """Forward hooks on ``module``'s convolutions that append each call's (output (C,
    *spatial), channels innermost, shift given) to ``sink``; returns their handles."""
    from tqdne_tpu_torch.nn.layers import _Conv

    def hook(mod, args, kwargs, out):
        cl = out.dim() > 3 and out.is_contiguous(memory_format=torch.channels_last)
        sink.append((tuple(out.shape[1:]), cl, kwargs.get("shift") is not None))

    return [m.register_forward_hook(hook, with_kwargs=True) for m in module.modules()
            if isinstance(m, _Conv)]


def record_calls(modules, fn) -> tuple[list, list, list]:
    """The (x dtype, scale dtype, S, C, G, silu) of every GroupNorm, the
    (dtype, L, H, D, causal) of every attention call and the (output shape,
    channels innermost, shifted) of every convolution that ``fn()`` makes
    through ``modules``."""
    from tqdne_tpu_torch.nn.attention import AttentionBlock
    from tqdne_tpu_torch.nn.layers import Norm32

    gn, fa, cv = [], [], []

    def gn_hook(mod, args):
        x = args[0]
        gn.append((x.dtype, mod.weight.dtype, x[0, 0].numel(), x.shape[1], mod.groups, mod.silu))

    def fa_hook(mod, args):
        x = args[0]
        fa.append((x.dtype, x[0, 0].numel(), mod.num_heads, x.shape[1] // mod.num_heads,
                   mod.use_causal_mask))

    hooks = []
    for module in modules:
        hooks += [m.register_forward_pre_hook(gn_hook) for m in module.modules()
                  if isinstance(m, Norm32)]
        hooks += [m.register_forward_pre_hook(fa_hook) for m in module.modules()
                  if isinstance(m, AttentionBlock)]
        hooks += conv_hooks(module, cv)
    try:
        with torch.no_grad():
            fn()
    finally:
        for h in hooks:
            h.remove()
    return gn, fa, cv


def recipe_setup(key: str, dev, dtype, init):
    """The train CLI's modules and steps for recipe ``key`` at full width:
    the trained module (UNet or autoencoder) and the frozen autoencoder of a
    latent recipe, with weights from ``init`` (``utils.init_like_flax_`` as
    the CLI, or ``utils.randomize_``), the steps, and the signal and model
    shapes.  Computes in ``dtype`` over f32 parameters."""
    from tqdne_tpu_torch.cli import common
    from tqdne_tpu_torch.cli.common import RECIPES
    from tqdne_tpu_torch.train.steps import make_autoencoder_steps, make_edm_steps

    recipe = RECIPES[key]
    config = recipe.config_cls()
    sig = model_shape = common.signal_shape(config)
    if recipe.kind == "autoencoder":
        ae = common.build_autoencoder(config, dtype, dims=recipe.dims)[0]
        steps = make_autoencoder_steps(kl_weight=config.kl_weight, ema_decay=recipe.ema_decay)
        return init(ae, SEED + 3).to(dev), None, steps, sig, sig
    frozen = None
    if recipe.latent:
        frozen, enc_cfg, _ = common.build_autoencoder(config, dtype, dims=recipe.dims)
        init(frozen, SEED + 1).to(dev).eval()
        model_shape = common.latent_shape(enc_cfg, sig)
    unet = common.build_unet(config, model_shape[-1], model_shape[-1], dtype,
                             dims=recipe.dims)[0]
    if recipe.dims == 2:
        for module in (unet, frozen):
            if module is not None:
                module.to(memory_format=torch.channels_last)
    steps = make_edm_steps(autoencoder=frozen, ema_decay=recipe.ema_decay)
    return init(unet, SEED).to(dev), frozen, steps, sig, model_shape


def recipe_batch(key: str, n: int, sig, model_shape, gen, dev) -> tuple[dict, dict]:
    """A batch of ``n`` signals in [-1, 1] (with conditioning for an EDM
    recipe) and the step's draws (``ae_eps``, ``sigma_eps``, ``noise``)."""
    batch = {"signal": torch.rand(n, *sig, generator=gen, device=dev) * 2 - 1}
    if key == "1d_autoencoder":
        return batch, {"ae_eps": torch.randn(n, sig[0] // 4, 16, generator=gen, device=dev)}
    batch["cond"] = torch.randn(n, 5, generator=gen, device=dev)
    draws = {"sigma_eps": torch.randn(n, generator=gen, device=dev),
             "noise": torch.randn(n, *model_shape, generator=gen, device=dev)}
    if key == "1d_latent_edm":
        draws["ae_eps"] = torch.randn(n, *model_shape, generator=gen, device=dev)
    return batch, draws


def recipe_loss(key: str, model, frozen, batch, draws):
    from tqdne_tpu_torch.train.steps import autoencoder_losses, edm_step_loss

    if key == "1d_autoencoder":
        return autoencoder_losses(model, batch, draws=draws)["loss"]
    return edm_step_loss(model, batch, autoencoder=frozen, draws=draws)


# ---- the few-eval and DDPM recipes: consistency, latent_consistency, latent_distill, ddpm ----
NEW_RECIPES = ("consistency", "latent_consistency", "latent_distill", "ddpm")
NEW_BATCH = 256  # each new recipe's training batch
NEW_STEPS = 20  # Trainer.fit steps of each at that batch (2 per epoch of the 512 waveforms)
NEW_MAX_STEPS = 400  # N(k)'s horizon in the consistency steps: 200 epochs of 2 batches
NEW_FORWARDS = {"consistency": 2, "latent_consistency": 2, "latent_distill": 4, "ddpm": 1}
FEW_NFE = (1, 2)  # the few-eval samplers' network evals


def new_recipe_setup(key: str, dev, dtype, init):
    """The train CLI's modules and steps for a new recipe at full width: the
    trained UNet, the frozen autoencoder of a latent recipe and, for
    ``latent_distill``, the frozen teacher (seeded random weights standing in
    for a trained ``latent_edm`` run; the student starts from them, as the
    CLI starts it), the steps, and the signal and model shapes.  Computes in
    ``dtype`` over f32 parameters; ``init`` fills the weights."""
    from tqdne_tpu_torch.cli import common
    from tqdne_tpu_torch.cli.common import RECIPES
    from tqdne_tpu_torch.diffusion import ddpm as ddpm_lib
    from tqdne_tpu_torch.diffusion.consistency import ConsistencyConfig, make_consistency_steps
    from tqdne_tpu_torch.diffusion.distillation import make_distillation_steps

    recipe = RECIPES[key]
    config = recipe.config_cls()
    sig = model_shape = common.signal_shape(config)
    layout = torch.channels_last if recipe.dims == 2 else torch.preserve_format
    frozen = teacher = None
    if recipe.latent:
        frozen, enc_cfg, _ = common.build_autoencoder(config, dtype, dims=recipe.dims)
        init(frozen, SEED + 1).to(dev, memory_format=layout).eval()
        model_shape = common.latent_shape(enc_cfg, sig)
    unet = common.build_unet(config, model_shape[-1], model_shape[-1], dtype,
                             dims=recipe.dims)[0]
    init(unet, SEED + 4).to(dev, memory_format=layout)
    if recipe.kind == "distill":
        teacher = copy.deepcopy(unet)
        steps = make_distillation_steps(teacher, ema_decay=recipe.ema_decay, autoencoder=frozen)
    elif recipe.kind == "consistency":
        steps = make_consistency_steps(ConsistencyConfig(), NEW_MAX_STEPS,
                                       ema_decay=recipe.ema_decay, autoencoder=frozen)
    else:
        steps = ddpm_lib.make_ddpm_steps(ddpm_lib.DDPMConfig(), ema_decay=recipe.ema_decay)
    return unet, frozen, teacher, steps, sig, model_shape


def new_batch(key: str, n: int, sig, model_shape, gen, dev) -> tuple[dict, dict]:
    """A batch of ``n`` signals in [-1, 1] with conditioning, and the step's
    draws: the encoder's eps for a latent recipe, then the consistency
    step's timesteps (below N(0) - 1) and noise, the distill step's interval
    and noise, or DDPM's t and noise."""
    from tqdne_tpu_torch.cli.common import RECIPES
    from tqdne_tpu_torch.diffusion.consistency import ConsistencyConfig, num_timesteps

    kind = RECIPES[key].kind
    batch = {"signal": torch.rand(n, *sig, generator=gen, device=dev) * 2 - 1,
             "cond": torch.randn(n, 5, generator=gen, device=dev)}
    draws = {}
    if RECIPES[key].latent:
        draws["ae_eps"] = torch.randn(n, *model_shape, generator=gen, device=dev)
    eps = torch.randn(n, *model_shape, generator=gen, device=dev)
    if kind == "consistency":
        top = int(num_timesteps(ConsistencyConfig(), 0, NEW_MAX_STEPS)) - 1
        draws |= {"timesteps": torch.randint(0, top, (n,), generator=gen, device=dev),
                  "eps": eps}
    elif kind == "distill":
        draws |= {"i": torch.randint(0, 17, (n,), generator=gen, device=dev), "eps": eps}
    else:
        draws |= {"t": torch.randint(0, 1000, (n,), generator=gen, device=dev), "noise": eps}
    return batch, draws


def new_loss(key: str, model, frozen, teacher, batch, draws):
    """The new recipe's loss at step 0 through ``model`` (the student, also
    the distill target and the consistency teacher), in its current mode."""
    from tqdne_tpu_torch.cli.common import RECIPES
    from tqdne_tpu_torch.diffusion import ddpm as ddpm_lib
    from tqdne_tpu_torch.diffusion import edm as edm_lib
    from tqdne_tpu_torch.diffusion.consistency import ConsistencyConfig, consistency_loss
    from tqdne_tpu_torch.diffusion.distillation import distillation_loss, edm_conditioned_net
    from tqdne_tpu_torch.train.steps import training_sample

    kind = RECIPES[key].kind
    if kind == "ddpm":
        return ddpm_lib.ddpm_loss(ddpm_lib.DDPMConfig(), model, batch["signal"],
                                  cond=batch["cond"], t=draws["t"], noise=draws["noise"])
    sample = training_sample(batch, autoencoder=frozen, ae_eps=draws.get("ae_eps"))
    if kind == "consistency":
        return consistency_loss(ConsistencyConfig(), model, model, sample, 0, NEW_MAX_STEPS,
                                cond=batch["cond"], timesteps=draws["timesteps"],
                                eps=draws["eps"])
    edm_cfg = edm_lib.EDMConfig()
    net = edm_conditioned_net(model, edm_cfg, train=model.training)
    return distillation_loss(
        ConsistencyConfig(), edm_cfg,
        lambda x, s, c: edm_lib.precondition(edm_cfg, teacher, x, s, cond=c), net, net, sample,
        18, cond=batch["cond"], i=draws["i"], eps=draws["eps"])


# ---- the sampling-eval callback and the seismological evaluation ---------------------------
CB_BATCH = 256  # the callback's validation batch: latent_edm's recipe batch over 512 waveforms
CB_BATCHES = 2  # the validation batches it samples, as the train CLI holds them
CB_STEPS = 4  # Trainer.fit steps around it: one epoch of the 512 waveforms at batch 128
CB_SEED = 123  # SamplingEvalCallback's default seed
HEUN_EVALS = 2 * 25 - 1  # the EDM kinds' callback sampler: Heun at 25 steps
FEW_EVALS = 2  # the consistency kinds': one eval from sigma_max, one refinement at sigma 1
DDPM_CB_STEPS = 20  # DDPM timesteps of its timed callback pass (the recipe's are 1000)
SA_PERIODS = (0.1, 0.3, 1.0, 2.0)
SA_LOOP_ROWS = 32  # rows whose RotD50 SA the plain loop recomputes on the host
DEVICE = "cuda"  # the card; "cpu" runs phase 4l's functions on the plain versions


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    if not hasattr(card_line, "text"):
        card_line.text = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    return card_line.text


def host_batches(arrays, config) -> list:
    """The first CB_BATCHES validation batches as the train CLI holds them for
    the callback: the conditioning and the channels-last waveforms, on the host."""
    from tqdne_tpu_torch.data.dataset import ArrayDataset
    from tqdne_tpu_torch.data.pipeline import BatchLoader

    loader = BatchLoader(ArrayDataset(arrays, config.make_representation(), cut=config.t,
                                      cond=True, split="full"),
                         CB_BATCH, shuffle=False, device="cpu", keys=("cond", "waveform"),
                         prefetch=0)
    return [b for _, b in zip(range(CB_BATCHES), loader)]


class Split:
    """Seconds of callback passes by part; each timed call synchronises the
    card before and after, so a part's device work is its own."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)

    def timed(self, part: str, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.seconds[part] += time.perf_counter() - t0
            return out
        return run

    def representation(self, rep):
        """``rep`` with its inversion timed as "inversion" (still its own class)."""
        timed = type(f"Timed{type(rep).__name__}", (type(rep),), {
            "invert_representation": self.timed("inversion", type(rep).invert_representation)})
        out = copy.copy(rep)
        out.__class__ = timed
        return out

    def metrics(self, metrics):
        class Timed:
            def __init__(self, metric, run):
                self.name, self.run = metric.name, run

            def __call__(self, pred, target):
                return self.run(pred, target)

        return [Timed(m, self.timed("metrics", m)) for m in metrics]


def counted_callback(cb, sink: list):
    """``cb`` wrapped to record each call's own launches and wall seconds."""
    def run(trainer, state, epoch, gstep):
        kernels = launch_counters()
        torch.cuda.synchronize()
        before = [fn.launches for fn in kernels]
        t0 = time.perf_counter()
        cb(trainer, state, epoch, gstep)
        torch.cuda.synchronize()
        sink.append(({fn.__name__: fn.launches - b for fn, b in zip(kernels, before)},
                     time.perf_counter() - t0))
    return run


def asd_metrics(config) -> list:
    """The train CLI's callback metrics: the isotropic ASD of each channel."""
    from tqdne_tpu_torch.eval.metrics import AmplitudeSpectralDensity

    return [AmplitudeSpectralDensity(fs=config.fs, channel=c, isotropic=True) for c in range(3)]


def direct_callback(label: str, cb, state) -> tuple[dict, float, list]:
    """One counted call of ``cb`` at epoch 0 outside a fit, with a trainer of
    its own workdir; returns (launches, wall seconds, metric rows)."""
    from types import SimpleNamespace

    from tqdne_tpu_torch.train.loop import MetricWriter

    workdir = Path(__file__).resolve().parent / "build" / f"chip_smoke_{label}"
    shutil.rmtree(workdir, ignore_errors=True)
    writer = MetricWriter(workdir)
    windows = []
    try:
        counted_callback(cb, windows)(SimpleNamespace(workdir=workdir, writer=writer,
                                                      device=torch.device(DEVICE)), state, 0, 0)
    finally:
        writer.close()
    rows = [json.loads(line) for line in (workdir / "metrics.jsonl").open()]
    shutil.rmtree(workdir, ignore_errors=True)
    return windows[0][0], windows[0][1], rows


def finite_evals(label: str, rows: list) -> dict:
    evals = [{k: v for k, v in r.items() if k.startswith("eval/")} for r in rows]
    evals = [e for e in evals if e]
    if len(evals) != 1 or not all(math.isfinite(v) for v in evals[0].values()):
        fail(f"{label}: eval scalars {evals} (want one finite row)")
    return evals[0]


def report_diff(got, want) -> tuple[float, bool]:
    """(largest relative difference, NaN positions equal) over every number of
    two residual reports."""
    import numpy as np

    worst, same_nan = 0.0, True
    for key, value in want.items():
        if isinstance(value, dict):
            w, n = report_diff(got[key], value)
            worst, same_nan = max(worst, w), same_nan and n
            continue
        a, b = np.asarray(got[key], np.float64), np.asarray(value, np.float64)
        same_nan = same_nan and a.shape == b.shape and bool((np.isnan(a) == np.isnan(b)).all())
        ok = ~np.isnan(b)
        if ok.any():
            worst = max(worst, float((np.abs(a[ok] - b[ok]) / np.maximum(np.abs(b[ok]), 1e-300))
                                     .max()))
    return worst, same_nan


def seismology_on_card(pred, target, dist, mag, vs30):
    """The seismological evaluation of the callback's waveforms against their
    targets, on the card and on the host: the PGV and PGA peaks to rtol 1e-10,
    ``residual_report`` (every binned list) to 1e-9 with NaN positions equal,
    and the generated waveforms' RotD50 SA at SA_PERIODS over 18 angles to
    rtol 1e-9 against the host's FFT formulation (every row) and its plain
    loop (SA_LOOP_ROWS rows); each timed."""
    import numpy as np

    from tqdne_tpu_torch.eval import seismo
    from tqdne_tpu_torch.eval.residuals import residual_report

    dev = torch.device(DEVICE)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    t_card, p_card = (torch.as_tensor(a, dtype=torch.float64, device=dev) for a in (target, pred))
    peak_err = 0.0
    for pgv in (True, False):
        got = seismo.evaluate_pgx(t_card, p_card, pgv=pgv)
        want = seismo.evaluate_pgx(target, pred, pgv=pgv)
        for key in want:
            g, w = got[key].cpu().numpy(), want[key].numpy()
            if not (np.isnan(g) == np.isnan(w)).all():
                fail(f"seismology: {key} NaN positions differ between the card and the host")
            peak_err = max(peak_err, float(np.nanmax(np.abs(g - w) / np.abs(w))))
    kw = dict(magnitude=mag, vs30=vs30)
    residual_report(target[:8], pred[:8], dist[:8], device=dev)  # warm-up: cuFFT plans
    rep_card, s_card = wall(lambda: residual_report(target, pred, dist, device=dev, **kw))
    rep_host, s_host = wall(lambda: residual_report(target, pred, dist, device="cpu", **kw))
    rep_err, rep_nan = report_diff(rep_card, rep_host)
    c1, c2 = (torch.as_tensor(pred[:, i], dtype=torch.float64) for i in (0, 1))
    seismo.sa_rotd(c1[:8].to(dev), c2[:8].to(dev), 0.01, SA_PERIODS)  # warm-up
    sa_card, sa_s_card = wall(lambda: seismo.sa_rotd(c1.to(dev), c2.to(dev), 0.01, SA_PERIODS))
    sa_host, sa_s_host = wall(lambda: seismo.sa_rotd(c1, c2, 0.01, SA_PERIODS))
    n = SA_LOOP_ROWS
    sa_loop, sa_s_loop = wall(lambda: seismo.sa_rotd(c1[:n], c2[:n], 0.01, SA_PERIODS,
                                                      spectrum=seismo.response_spectrum_loop))
    sa_card = sa_card.cpu()
    loop_err = float(((sa_card[:n] - sa_loop).abs() / sa_loop.abs()).max())
    host_err = float(((sa_card - sa_host).abs() / sa_host.abs()).max())
    out = dict(rows=len(pred), peaks_rel_err=peak_err, report_rel_err=rep_err,
               report_nan_equal=rep_nan, residual_report_s={"card": s_card, "host": s_host},
               sa_rotd_rel_err={"vs_plain_loop": loop_err, "vs_host_fft": host_err},
               sa_rotd_s={"card": sa_s_card, "host_fft": sa_s_host,
                          f"host_plain_loop_{n}_rows": sa_s_loop},
               card=card_line())
    log(f"[seismo] the callback's {len(pred)} waveforms against their targets: "
        f"{json.dumps(out)}")
    if not (peak_err <= 1e-10 and rep_err <= 1e-9 and rep_nan and loop_err <= 1e-9
            and host_err <= 1e-9):
        fail("seismology on the card disagrees with the host")
    return out


def sampling_eval_path(*, state, steps, loader, ae, model_shape, config, schedule, arrays,
                       flagship_want, per_eval, per_decode, convs, few_runs) -> dict:
    """The sampling-eval callback on the card.  A counted ``Trainer.fit`` of
    the flagship at full width (CB_STEPS steps, the callback firing once on
    CB_BATCHES validation batches of CB_BATCH): exact launches for the fit and
    for the callback's own window, its wall split into sampling, inversion and
    metrics, batch 0 bit for bit a direct ``sample_edm`` and inversion at the
    callback's seed, finite ``eval/`` scalars; then a sample with a NaN row
    (zeroed and warned), the ``consistency`` callback (1D, its few evals) and
    DDPM's at DDPM_CB_STEPS timesteps (timed, for an estimate of its 1000),
    and the seismology of the flagship's waveforms.  ``per_eval`` /
    ``per_decode``: (GroupNorm, flash) launches of one UNet eval, GroupNorm
    launches of one decode; ``convs``: the convolution calls (``record_calls``)
    of one UNet eval and of one decode;
    ``few_runs``: key -> (TrainState, model shape, (GroupNorm and flash
    launches, convolution calls) of one UNet eval).
    Returns the counts by run."""
    import importlib.util
    import logging

    import numpy as np

    from tqdne_tpu_torch.cli.common import RECIPES, signal_shape
    from tqdne_tpu_torch.cli.train import eval_sampler
    from tqdne_tpu_torch.data.representation import invert
    from tqdne_tpu_torch.diffusion import ddpm as ddpm_lib
    from tqdne_tpu_torch.eval.metrics import MeanSquaredError
    from tqdne_tpu_torch.train.callbacks import SamplingEvalCallback
    from tqdne_tpu_torch.train.steps import sample_edm
    from tqdne_tpu_torch.utils import fold_seed

    dev = torch.device(DEVICE)
    log(f"[callback] plots=(): the figures need matplotlib, which the GPU machine's image does "
        f"not carry (installed here: {importlib.util.find_spec('matplotlib') is not None}); "
        f"the CPU tests hold every figure against the JAX package's. Card: {card_line()}")

    class Keep(MeanSquaredError):
        """MSE over all channels that keeps the callback's waveforms."""

        def compute(self, pred, target):
            self.pred, self.target = pred, target
            return super().compute(pred, target)

    counts = {}
    val = host_batches(arrays, config)
    split, keep = Split(), Keep(channel=None)
    stats = np.array([[arrays[k].mean(), arrays[k].std()] for k in config.features_keys])
    cb = SamplingEvalCallback(
        split.timed("sampling", eval_sampler("edm", ae, model_shape, dev)), val,
        split.representation(config.make_representation()),
        metrics=split.metrics(asd_metrics(config)) + [keep], every_n_epochs=1, seed=CB_SEED,
        feature_stats=stats, features_keys=config.features_keys)
    per_pass = want_launches(CB_BATCHES * (HEUN_EVALS * per_eval[0] + per_decode),
                             CB_BATCHES * HEUN_EVALS * per_eval[1],
                             convs=[(convs[0], CB_BATCHES * HEUN_EVALS), (convs[1], CB_BATCHES)])
    fit_want = {k: v + per_pass[k] for k, v in flagship_want(CB_STEPS).items()}
    windows = []
    counts["callback flagship fit"], rows = counted_fit(
        "callback-flagship", steps, state, loader, max_steps=state.step + CB_STEPS,
        want=fit_want, want_gn_bwd=per_eval[0] * CB_STEPS, lr_schedule=schedule,
        callbacks=(counted_callback(cb, windows),))
    scalars = finite_evals("the flagship callback", rows)
    if len(windows) != 1 or windows[0][0] != per_pass:
        fail(f"the flagship callback's window: {windows} (want one pass of {per_pass})")
    counts["callback flagship pass"] = windows[0][0]
    wall_s = windows[0][1]
    log(f"[callback] latent_edm at full width (bf16 compute over f32 EMA weights), "
        f"{CB_BATCHES} validation batches of {CB_BATCH}, Heun-25 ({HEUN_EVALS} evals) + decode + "
        f"Griffin-Lim {config.griffin_lim_iters} + 3 ASD metrics: one pass {wall_s:.4f} s of "
        f"wall, by part (s) {json.dumps(dict(split.seconds))}, the rest (host copies, NaN "
        f"check, the kept MSE) {wall_s - sum(split.seconds.values()):.4f}; launches of the pass "
        f"{windows[0][0]}, of the fit ({CB_STEPS} steps + the pass) "
        f"{counts['callback flagship fit']}; eval scalars {json.dumps(scalars)}; card "
        f"{card_line()}")
    # batch 0, bit for bit: a direct sample and inversion at the callback's seed
    gen = torch.Generator(device=dev).manual_seed(fold_seed(CB_SEED, 0))
    cond0 = val[0]["cond"].to(dev)
    signal = sample_edm(state.ema, (len(cond0), *model_shape), cond0, autoencoder=ae,
                        generator=gen, device=dev)
    if not bool(torch.isfinite(signal).all()):
        signal = torch.nan_to_num(signal)
    direct = invert(config.make_representation(), signal.movedim(-1, 1),
                    generator=gen).cpu().numpy()
    bit_equal = bool(np.array_equal(direct, keep.pred[:len(cond0)]))
    log(f"[callback] batch 0 {direct.shape} bit-identical to a direct sample_edm + inversion at "
        f"fold_seed({CB_SEED}, 0): {bit_equal}; peak {float(np.abs(direct).max()):.4e}")
    if not bit_equal or keep.pred.shape != (CB_BATCHES * CB_BATCH, 3, config.t):
        fail("the callback's waveforms differ from a direct sample at its seed")

    # a sample function that returns one NaN row: zeroed and warned, not raised
    sig_shape = signal_shape(config)

    def nan_row(model, generator, batch):
        out = torch.rand(len(batch["cond"]), *sig_shape, generator=generator, device=dev) * 2 - 1
        out[0] = float("nan")
        return out

    warnings = []
    handler = logging.Handler()
    handler.emit = lambda record: warnings.append(record.getMessage())
    logger = logging.getLogger("tqdne_tpu_torch")
    logger.addHandler(handler)
    try:
        _, _, rows = direct_callback("callback-guard", SamplingEvalCallback(
            nan_row, val[:1], config.make_representation(), metrics=asd_metrics(config),
            every_n_epochs=1), state)
    finally:
        logger.removeHandler(handler)
    guard = finite_evals("the NaN-row callback", rows)
    warned = any("NaN guard" in w for w in warnings)
    log(f"[callback] a sample with a NaN row: warned {warned}, eval scalars {json.dumps(guard)}")
    if not warned:
        fail("the callback did not warn about a non-finite sample")

    # the consistency callback (1D, the JAX default's evals) and DDPM's, each counted
    few_out = {}
    saved = ddpm_lib.DDPMConfig
    ddpm_lib.DDPMConfig = functools.partial(saved, num_train_timesteps=DDPM_CB_STEPS)
    try:
        for key, evals in (("consistency", FEW_EVALS), ("ddpm", DDPM_CB_STEPS)):
            st, mshape, (gn, fa, cv) = few_runs[key]
            cfg = RECIPES[key].config_cls()
            few_split = Split()
            few_cb = SamplingEvalCallback(
                few_split.timed("sampling", eval_sampler(RECIPES[key].kind, None, mshape, dev)),
                host_batches(arrays, cfg), few_split.representation(cfg.make_representation()),
                metrics=few_split.metrics(asd_metrics(cfg)), every_n_epochs=1, seed=CB_SEED)
            want = want_launches(CB_BATCHES * evals * gn, CB_BATCHES * evals * fa,
                                 convs=[(cv, CB_BATCHES * evals)])
            got, sec, rows = direct_callback(f"callback-{key}", few_cb, st)
            counts[f"callback {key} pass"] = got
            few_out[key] = dict(evals=evals, wall_s=sec, **few_split.seconds,
                                scalars=finite_evals(f"the {key} callback", rows))
            if got != want:
                fail(f"the {key} callback's launches {got} != {want}")
    finally:
        ddpm_lib.DDPMConfig = saved
    d = few_out["ddpm"]
    d["estimate_1000_steps_s"] = (d["sampling"] * 1000 / DDPM_CB_STEPS + d["inversion"]
                                  + d["metrics"])
    few_counts = {k: counts[f"callback {k} pass"] for k in few_out}
    log(f"[callback] consistency ({FEW_EVALS} evals) and ddpm ({DDPM_CB_STEPS} of its 1000 "
        f"timesteps), 1D UNet at full width, {CB_BATCHES} batches of {CB_BATCH}: "
        f"{json.dumps(few_out)}; launches {json.dumps(few_counts)}; the ddpm estimate scales "
        f"the sampling seconds to 1000 timesteps; card {card_line()}")

    # the seismology of the flagship callback's waveforms
    targets = np.concatenate([np.moveaxis(b["waveform"].numpy(), -1, 1) for b in val])
    feats = {k: arrays[k][:len(targets)] for k in ("hypocentral_distance", "magnitude", "vs30")}
    seismology_on_card(keep.pred.astype(np.float64), targets.astype(np.float64),
                       feats["hypocentral_distance"], feats["magnitude"], feats["vs30"])
    return counts


def reference_checkpoints_path(dev, want: dict, want_clf: dict) -> dict:
    """4m: full-width reference Lightning checkpoints (seeded random live
    weights and a different EMA; the UNet's EMA at the top level, the
    autoencoder's under ``callbacks``, the classifier's at the top level)
    imported by ``cli.import_checkpoint``, then the flagship sampled (bf16,
    batch 32, dpmpp_2m-10, GL 32) by three routes, each from its own
    ``build_inference``: (a) the imported runs, (b) the checkpoints converted
    on the fly, (c) the EMA weights as the port's ``.pt`` files.  (a) and (b)
    must equal (c) bit for bit, each run's launches ``want``, the flagship's;
    one forward at 32 of the imported classifier run bit-identical to its
    ``.pt``, with the launches ``want_clf``.  Returns each counted run's
    launches."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from lightning_layout import lightning_checkpoint, reference_state_dict

    from tqdne_tpu_torch import configs
    from tqdne_tpu_torch.cli.common import build_autoencoder, build_inference
    from tqdne_tpu_torch.cli.evaluate import load_classifier, load_classifier_run
    from tqdne_tpu_torch.cli.import_checkpoint import import_checkpoint
    from tqdne_tpu_torch.models.classifier import Classifier
    from tqdne_tpu_torch.models.unet import UNet
    from tqdne_tpu_torch.utils import randomize_

    work = Path(__file__).resolve().parent / "build" / "chip_smoke_4m"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    config = configs.LatentSpectrogramConfig()
    clf_config = configs.SpectrogramClassificationConfig()
    models = {
        "edm": (UNet(**configs.get_2d_unet_config(config, 8, 8)), "unet"),
        "autoencoder": (build_autoencoder(config)[0], "autoencoder"),
        "classifier": (Classifier(configs.get_classifier_encoder_config(clf_config),
                                  clf_config.num_classes), "classifier"),
    }
    t0 = time.perf_counter()
    for i, (kind, (module, layout)) in enumerate(models.items()):
        live = reference_state_dict(randomize_(module, SEED + 40 + i), layout)
        ema = reference_state_dict(randomize_(module, SEED + 50 + i), layout)
        torch.save(lightning_checkpoint(live, ema, step=CKPT_STEP,
                                        prefix="unet" if kind == "edm" else "",
                                        in_callbacks=kind == "autoencoder"),
                   work / f"{kind}.ckpt")
        torch.save(module.state_dict(), work / f"{kind}-ema.pt")  # the module holds the EMA
    n_params = {kind: sum(p.numel() for p in m.parameters()) for kind, (m, _) in models.items()}
    log(f"[ckpt] three full-width reference checkpoints ({json.dumps(n_params)} parameters) "
        f"written in {time.perf_counter() - t0:.2f} s")
    del models

    wd = work / "workdir"
    import_s = {}
    for kind in ("edm", "autoencoder", "classifier"):
        t0 = time.perf_counter()
        import_checkpoint(kind, work / f"{kind}.ckpt", wd)
        import_s[kind] = round(time.perf_counter() - t0, 3)
    log(f"[ckpt] import_checkpoint s by model: {json.dumps(import_s)}; {card_line()}")

    kw = dict(dtype=torch.bfloat16, num_steps=10, solver="dpmpp_2m", gl_iters=32, device=dev)
    routes = {
        "imported run": lambda: build_inference(workdir=wd, **kw),
        "on the fly": lambda: build_inference(edm_checkpoint=work / "edm.ckpt",
                                              autoencoder_checkpoint=work / "autoencoder.ckpt",
                                              **kw),
        ".pt": lambda: build_inference(unet_weights=work / "edm-ema.pt",
                                       ae_weights=work / "autoencoder-ema.pt", **kw),
    }
    waves, counts, first_s = {}, {}, {}
    for route, make in routes.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle = make()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        cond = torch.randn(BATCH, 5, generator=gen, device=dev)
        zero_launches()
        waves[route] = bundle.generate(cond, generator=gen)
        counts[route] = read_launches()
        first_s[route] = round(time.perf_counter() - t0, 3)
        wave = waves[route]
        if wave.shape != (BATCH, 3, 4064) or not torch.isfinite(wave).all():
            fail(f"4m {route}: waveforms {tuple(wave.shape)} "
                 f"finite={bool(torch.isfinite(wave).all())}")
        if counts[route] != want:
            fail(f"4m {route}: launches {counts[route]} != the flagship's {want}")
        if route == "imported run" and bundle.provenance.get("checkpoint_step") != CKPT_STEP:
            fail(f"4m: the imported run's provenance {bundle.provenance}")
        del bundle
    same = {route: torch.equal(waves[route], waves[".pt"]) for route in routes}
    log(f"[ckpt] seconds to the first waveform (build_inference + one dpmpp_2m-10 generate at "
        f"{BATCH}): {json.dumps(first_s)}; bit-identical to the .pt route: {json.dumps(same)}; "
        f"launches {json.dumps(counts['imported run'])} each; peak "
        f"{waves['.pt'].abs().max().item():.3e}; {card_line()}")
    if not all(same.values()):
        fail(f"4m: the routes' waveforms differ: {same}")
    del waves

    clf_run = load_classifier_run(wd, "Classifier-LogSpectrogram", dtype=torch.bfloat16,
                                  device=dev)
    clf_pt = load_classifier(work / "classifier-ema.pt", dtype=torch.bfloat16, device=dev)
    x = torch.randn(BATCH, 128, 128, 3, generator=torch.Generator(device=dev).manual_seed(SEED),
                    device=dev)
    with torch.no_grad():
        zero_launches()
        got = clf_run.embed_and_logits(x)
        counts["classifier run"] = read_launches()
        ref = clf_pt.embed_and_logits(x)
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    log(f"[ckpt] imported classifier forward at {BATCH}: embeddings and logits bit-identical to "
        f"the .pt route {same}, launches {json.dumps(counts['classifier run'])}")
    if not same or counts["classifier run"] != want_clf:
        fail(f"4m: the imported classifier: identical {same}, launches "
             f"{counts['classifier run']} (want {want_clf})")
    shutil.rmtree(work, ignore_errors=True)
    return counts


def synthetic_records(n: int, t: int, dev) -> torch.Tensor:
    """(n, 3, t) f32 raw-length records made on ``dev`` from a seed: noise, then
    a decaying arrival at 5-20 s; every 8th record dead from a random sample
    on (trailing zeros), every 16th with a constant channel, every 32nd with
    a straight-line tail."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    time_s = torch.arange(t, device=dev) / 100.0
    onset = 5 + 15 * torch.rand(n, 1, 1, generator=gen, device=dev)
    freq = 1 + 6 * torch.rand(n, 3, 1, generator=gen, device=dev)
    lag = (time_s - onset).clamp(min=0)
    wf = (0.01 * torch.randn(n, 3, t, generator=gen, device=dev)
          + (time_s > onset) * torch.sin(2 * math.pi * freq * lag) * torch.exp(-lag / 10))
    dead = torch.randint(t // 4, t, (n, 1, 1), generator=gen, device=dev)
    wf = torch.where((torch.arange(n, device=dev) % 8 == 0)[:, None, None]
                     & (torch.arange(t, device=dev) >= dead), 0.0, wf)
    wf[::16, 1] = 0.5
    wf[::32, 0, -2000:] = torch.linspace(0.0, 0.8, 2000, device=dev)
    return wf


def data_scans(dev) -> dict:
    """4m: ``compute_validity_indices`` and ``quality_report`` on the card over
    SCAN_RECORDS raw-length records, against the same functions on the host
    over the first SCAN_HOST: validity indices, trailing-zero and small-range
    flags exact, the linear-trend R^2 of every tail window to 1e-9 relative,
    and the linear-trend flags that differ counted (the run fails on any)."""
    from tqdne_tpu_torch.data.quality import compute_validity_indices, linear_trend_r2, \
        quality_report

    wf = synthetic_records(SCAN_RECORDS, SCAN_T, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    validity = compute_validity_indices(wf)
    torch.cuda.synchronize()
    validity_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = quality_report(wf)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    host = wf[:SCAN_HOST].cpu()
    t0 = time.perf_counter()
    host_validity = compute_validity_indices(host)
    host_validity_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_report = quality_report(host)
    host_s = time.perf_counter() - t0
    r2, host_r2 = linear_trend_r2(wf[:SCAN_HOST]).cpu(), linear_trend_r2(host)
    r2_rel = ((r2 - host_r2).abs() / host_r2.abs().clamp(min=1e-300)).max().item()
    exact = {key: torch.equal(report[key][:SCAN_HOST].cpu(), host_report[key])
             for key in ("has_trailing_zeros", "trailing_zero_index", "has_small_range",
                         "validity_index")}
    exact["compute_validity_indices"] = torch.equal(validity[:SCAN_HOST].cpu(), host_validity)
    trend_diff = int((report["has_linear_trend"][:SCAN_HOST].cpu()
                      != host_report["has_linear_trend"]).sum())
    flagged = {key: int(report[key].sum()) for key in
               ("has_trailing_zeros", "has_small_range", "has_linear_trend")}
    gb = wf.numel() * wf.element_size() / 1e9
    log(f"[scan] {SCAN_RECORDS} records x 3 x {SCAN_T} f32 ({gb:.3f} GB) on the card: "
        f"compute_validity_indices {validity_s:.4f} s, quality_report {card_s:.4f} s; the first "
        f"{SCAN_HOST} on the host: {host_validity_s:.4f} s and {host_s:.4f} s; flagged of "
        f"{SCAN_RECORDS}: {json.dumps(flagged)}, median validity index "
        f"{int(validity.median())}; exact: {json.dumps(exact)}; linear-trend R^2 max rel diff "
        f"{r2_rel:.3e}, flags that differ {trend_diff}; {card_line()}")
    if not all(exact.values()) or r2_rel > 1e-9 or trend_diff:
        fail(f"4m scans: exact {exact}, R^2 rel diff {r2_rel:.3e}, trend flags differ "
             f"{trend_diff}")
    return {"card_s": card_s, "host_s": host_s}


# ---- 4n: the UNet's and autoencoder's options, and paired (cond_signal) data -------------
UNET_OPTIONS = {"cond_emb_scale": 1.0, "use_scale_shift_norm": True, "conv_resample": False,
                "use_checkpoint": True}  # every option of the JAX UNet
OPT_STEPS = 10  # Trainer.fit steps of the options flagship at 128, checkpointed, then plain
PAIRED_STEPS = 10  # of the paired flagship at 128
PAIRED_1D_BATCH, PAIRED_1D_STEPS = 64, 2  # paired consistency and DDPM, at reduced depth
PAIRED_DDPM_STEPS = 20  # the paired DDPM sample's timesteps


def paired_tables(waveforms) -> tuple[dict, dict]:
    """Observed and synthetic tables of the records ``waveforms`` (N, 3, T):
    the observed as they are, the synthetic a 9-sample moving average of them
    (a coarse simulation of the same events); an SNR of 0.5 on every channel of
    every 16th observed record and a data ratio of 50 on every 32nd synthetic
    one from row 8, so 48 of 512 rows fail the filters."""
    import numpy as np
    from scipy.ndimage import uniform_filter1d

    n = len(waveforms)
    snr = np.full((n, waveforms.shape[1]), 5.0, np.float32)
    snr[::16] = 0.5
    ratio = np.ones(n, np.float32)
    ratio[8::32] = 50.0
    syn = uniform_filter1d(waveforms, 9, axis=-1).astype(np.float32)
    return {"waveforms": waveforms, "snr": snr}, {"waveforms": syn, "data_ratio": ratio}


def setup_4n(dev, gen):
    """4n's models at full width (seeded random weights, bf16 compute over f32
    parameters) and the kernel calls of one forward of each: (a) the flagship
    UNet with every option of the JAX UNet, over the latent of the autoencoder
    without resampling convolutions; (b) the flagship UNet for paired latents
    (the latent and the encoded ``cond_signal`` in, no features); (c) the
    ``1d_edm`` UNet for paired envelopes (twice the signal's channels in, no
    features), one for consistency and one for DDPM."""
    from types import SimpleNamespace

    from tqdne_tpu_torch import configs
    from tqdne_tpu_torch.cli import common
    from tqdne_tpu_torch.models.unet import ResBlock
    from tqdne_tpu_torch.utils import randomize_

    s = SimpleNamespace(config=configs.LatentSpectrogramConfig(),
                        env_config=configs.MovingAverageEnvelopeConfig())
    s.ae, s.enc_cfg, s.dec_cfg = common.build_autoencoder(s.config, torch.bfloat16,
                                                          conv_resample=False)
    s.model_shape = common.latent_shape(s.enc_cfg, common.signal_shape(s.config))
    c = s.model_shape[-1]
    s.unet, s.ucfg = common.build_unet(s.config, c, c, torch.bfloat16, **UNET_OPTIONS)
    s.unet_p = common.build_unet(s.config, 2 * c, c, torch.bfloat16, cond_features=None)[0]
    s.sig_1d = common.signal_shape(s.env_config)
    c1 = s.sig_1d[-1]
    s.cons_unet, s.ddpm_unet = (common.build_unet(s.env_config, 2 * c1, c1, torch.bfloat16,
                                                  dims=1, cond_features=None)[0]
                                for _ in range(2))
    for i, module in enumerate((s.unet, s.ae, s.unet_p)):
        randomize_(module, SEED + 60 + i).to(dev, memory_format=torch.channels_last)
    for i, module in enumerate((s.cons_unet, s.ddpm_unet)):
        randomize_(module, SEED + 63 + i).to(dev)
    x = torch.randn(2, *s.model_shape, generator=gen, device=dev)
    t2 = torch.zeros(2, device=dev)
    cond = torch.randn(2, 5, generator=gen, device=dev)
    s.opt_gn, s.opt_fa, s.opt_cv = record_calls([s.unet], lambda: s.unet(x, t2, cond))
    res_blocks = [m for m in s.unet.modules() if isinstance(m, ResBlock)]
    s.n_res = len(res_blocks)
    # the convolution epilogues a checkpointed step recomputes: a ResBlock's but its last,
    # where the recomputation stops (all its saved tensors are back once that convolution ran)
    s.res_cv = [c for block in res_blocks
                for c in record_calls([block], lambda: s.unet(x, t2, cond))[2][:-1]]
    s.opt_enc_gn, _, s.opt_enc_cv = record_calls([s.ae.encoder], lambda: s.ae.moments(
        torch.zeros(2, *common.signal_shape(s.config), device=dev)))
    s.opt_dec_gn, _, s.opt_dec_cv = record_calls([s.ae.decoder],
                                                 lambda: s.ae.decode(x.float()))
    s.p_gn, s.p_fa, s.p_cv = record_calls([s.unet_p],
                                          lambda: s.unet_p(torch.cat([x, x], -1), t2))
    x1 = torch.randn(2, *s.sig_1d[:-1], 2 * c1, generator=gen, device=dev)
    s.u1_gn, s.u1_fa, s.u1_cv = record_calls([s.cons_unet], lambda: s.cons_unet(x1, t2))
    plain_norms = collections.Counter((sh, ch) for *_, sh, ch, _, silu in s.opt_gn if not silu)
    log(f"[shapes] 4n options UNet ({sum(p.numel() for p in s.unet.parameters())} parameters, "
        f"{s.n_res} ResBlocks): {len(s.opt_gn)} GroupNorm calls, "
        f"{sum(plain_norms.values())} without SiLU (S, C): {sorted(plain_norms.items())}; "
        f"{len(s.opt_fa)} attention calls; the resample-free encoder {len(s.opt_enc_gn)} and "
        f"decoder {len(s.opt_dec_gn)} GroupNorm calls, latent {s.model_shape}; the paired UNet "
        f"{len(s.p_gn)} GroupNorm and {len(s.p_fa)} attention calls; the paired 1D UNet "
        f"{len(s.u1_gn)} GroupNorm and {len(s.u1_fa)} attention calls "
        f"{sorted(set(s.u1_fa), key=str)}")
    # the scale-shift out_norm (no SiLU) of every ResBlock, besides the attention blocks' norms
    if sum(plain_norms.values()) != s.n_res + len(s.opt_fa) or not s.opt_fa or not s.u1_fa:
        fail(f"4n: {sum(plain_norms.values())} GroupNorm calls without SiLU, {s.n_res} "
             f"ResBlocks, {len(s.opt_fa)} attention calls")
    return s


def options_and_paired_path(dev, s, arrays, ae_t, enc_gn: list, dec_gn: list, enc_cv: list,
                            dec_cv: list) -> dict:
    """4n: (a) the flagship with every option of the JAX UNet: ``Trainer.fit``
    of ``OPT_STEPS`` at batch 128 (the frozen autoencoder without resampling
    convolutions), checkpointed, then the same steps from the same state and
    draws without checkpointing (the first loss bit-identical, the parameters
    after them to the bf16 bound, a step's peak memory both ways); the trained
    UNet and the autoencoder saved as the port's runs and rebuilt by
    ``build_inference`` from their ``hparams.json``, Heun-25 and dpmpp_2m-10 at
    32 with decode and Griffin-Lim 32, an f32 sample against the plain
    versions, one autoencoder step at 128; (b) the paired flagship: a
    ``PairedDataset`` of two in-memory tables through ``LogSpectrogram`` into
    ``BatchLoader``, ``PAIRED_STEPS`` at 128 with the frozen flagship
    autoencoder encoding ``signal`` and ``cond_signal``, one autoencoder step on
    the paired batches, a dpmpp_2m-10 sample at 32 from a validation batch's
    ``cond_signal`` decoded with Griffin-Lim 32; (c) paired ``consistency`` and
    ``ddpm`` on the ``1d_edm`` UNet, ``PAIRED_1D_STEPS`` at 64, then a sample at
    32 (2 evals; DDPM at ``PAIRED_DDPM_STEPS``).  Every launch count exact.
    Returns each counted run's launches."""
    from tqdne_tpu_torch import configs
    from tqdne_tpu_torch.cli import common
    from tqdne_tpu_torch.data.dataset import ArrayDataset, PairedDataset
    from tqdne_tpu_torch.data.pipeline import BatchLoader
    from tqdne_tpu_torch.diffusion import ddpm as ddpm_lib
    from tqdne_tpu_torch.diffusion.consistency import (ConsistencyConfig, make_consistency_steps,
                                                       sample_consistency)
    from tqdne_tpu_torch.ops.group_norm import group_norm_silu
    from tqdne_tpu_torch.train.checkpoint import Checkpointer, hparams_diff
    from tqdne_tpu_torch.train.state import TrainState, cosine_annealing, make_optimizer
    from tqdne_tpu_torch.train.steps import make_autoencoder_steps, make_edm_steps, sample_edm

    config, counts, rates = s.config, {}, {}
    representation = config.make_representation()
    gl32 = copy.copy(config)
    gl32.griffin_lim_iters = 32
    gl32 = gl32.make_representation()
    kernels = launch_counters()
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)

    def counted(label, fn, want):
        """``fn()`` with every counter set to 0 just before and read just after."""
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        group_norm_silu.backward_calls = group_norm_silu.backward_launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts[label] = {k.__name__: k.launches for k in kernels}
        log(f"[4n] {label}: {sec:.3f} s, launches {counts[label]}")
        if (counts[label] != want or group_norm_silu.backward_calls
                or group_norm_silu.backward_launches):
            fail(f"4n {label}: launches {counts[label]} != expected {want} (GroupNorm backward "
                 f"{group_norm_silu.backward_calls}, launched "
                 f"{group_norm_silu.backward_launches})")
        return out, sec

    def waveforms_ok(label, wave):
        finite = bool(torch.isfinite(wave).all())
        log(f"[4n] {label}: waveforms {tuple(wave.shape)} finite {finite}, peak "
            f"{wave.abs().max().item():.3e}")
        if wave.shape != (BATCH, 3, config.t) or not finite:
            fail(f"4n {label}: waveforms {tuple(wave.shape)} finite {finite}")

    def flagship_loader(keys=("signal", "cond")):
        return BatchLoader(ArrayDataset(arrays, representation, cut=config.t, cond=True,
                                        split="full"),
                           TRAIN_BATCH, device=dev, keys=keys, seed=SEED)

    # (a) the options flagship: Trainer.fit checkpointed, then plain from the same state
    schedule = cosine_annealing(1e-4, 100_000)
    plain = copy.deepcopy(s.unet)
    plain.use_checkpoint = False
    steps = make_edm_steps(autoencoder=s.ae)
    per_step = len(s.opt_gn) + len(s.opt_enc_gn)
    runs = {}
    for mode, unet in (("checkpointed", s.unet), ("plain", plain)):
        st = TrainState(unet, make_optimizer("adam", unet, 1e-4), schedule)
        losses = []
        timed, marks = tail_timed(steps[0], OPT_STEPS, OPT_STEPS // 2)

        def step(state, batch, _timed=timed, _losses=losses, **kw):
            out = _timed(state, batch, **kw)
            _losses.append(out["loss"])
            return out

        # the recomputation relaunches each ResBlock's two GroupNorms and its convolutions'
        # epilogues in the backward
        gn = (per_step + 2 * s.n_res * (mode == "checkpointed")) * OPT_STEPS
        convs = [(s.opt_cv, OPT_STEPS), (s.opt_enc_cv, OPT_STEPS),
                 (s.res_cv, OPT_STEPS * (mode == "checkpointed"))]
        counts[f"options {mode} train"], _ = counted_fit(
            f"options-{mode}", (step, steps[1]), st, flagship_loader(), max_steps=OPT_STEPS,
            want=want_launches(gn, len(s.opt_fa) * OPT_STEPS, len(s.opt_fa) * OPT_STEPS,
                               convs=convs),
            want_gn_bwd=len(s.opt_gn) * OPT_STEPS, lr_schedule=schedule)
        rates[f"options {mode}"] = tail_rate(
            f"options flagship, {mode}, batch {TRAIN_BATCH}, bf16", marks, TRAIN_BATCH,
            OPT_STEPS // 2)
        runs[mode] = (st, losses)
    (ckpt_state, ckpt_losses), (plain_state, plain_losses) = runs["checkpointed"], runs["plain"]
    first_equal = torch.equal(ckpt_losses[0], plain_losses[0])
    loss_rel = max(abs(a.item() - b.item()) / abs(b.item())
                   for a, b in zip(ckpt_losses, plain_losses))
    shares = [tol_share(a, b, torch.bfloat16, TOL) for a, b in
              zip(ckpt_state.model.parameters(), plain_state.model.parameters())]
    mem = {}
    batch = next(iter(flagship_loader()))
    for mode, (st, _) in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        steps[0](st, batch, generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        mem[mode] = {"step_gib": round((peak - base) / 2**30, 3),
                     "peak_gib": round(peak / 2**30, 3)}
    log(f"[options] first step's loss checkpointed {ckpt_losses[0].item():.8e} plain "
        f"{plain_losses[0].item():.8e} bit-identical {first_equal}; largest relative loss "
        f"difference over {OPT_STEPS} steps {loss_rel:.3e}; parameters after them: largest error "
        f"as a share of the bf16 tolerance {max(shares):.3f} over {len(shares)} tensors; "
        f"memory of one step (allocated above the state, and the peak) {json.dumps(mem)}; "
        f"samples/s {json.dumps({k: round(v, 2) for k, v in rates.items()})}; {card_line()}")
    if not first_equal or max(shares) > 1.0:
        fail("4n: the checkpointed options flagship departs from the plain one")
    del plain, plain_state, runs
    torch.cuda.empty_cache()

    # the trained UNet and the autoencoder as the port's runs, rebuilt from hparams.json
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_4n"
    shutil.rmtree(work, ignore_errors=True)
    outputs = Path(configs.LatentSpectrogramConfig(workdir=str(work)).outputdir)
    ae_train = copy.deepcopy(s.ae).requires_grad_(True).train()
    ae_state = TrainState(ae_train, make_optimizer("adamw", ae_train, 1e-4, 1e-4))
    for name, st, hparams in (
            (common.RUN_NAME, ckpt_state, {"kind": "edm", "dims": 2, "latent": True,
                                           "ae_name": common.AE_NAME, "dtype": "bf16",
                                           "unet": s.ucfg}),
            (common.AE_NAME, ae_state, common.autoencoder_hparams(config, s.enc_cfg,
                                                                 s.dec_cfg))):
        ckpt = Checkpointer(outputs / name / "checkpoints")
        ckpt.save(st.step, st)
        ckpt.save_hyperparameters(hparams)
        diffs = hparams_diff(ckpt.restore_hyperparameters(), hparams)
        if diffs:
            fail(f"4n: {name}'s hparams.json does not round-trip: {diffs}")
    heun = common.build_inference(workdir=work, dtype=torch.bfloat16, num_steps=25,
                                  solver="heun", gl_iters=32, device=dev)
    unet = heun.unet
    rebuilt = (unet.cond_embed is not None and unet.use_checkpoint
               and unet.mid_res1.use_scale_shift_norm and heun.model_shape == s.model_shape
               and all(m.op is None for n, m in unet.named_children() if n.endswith("sample")
                       and hasattr(m, "op")))
    if not rebuilt:
        fail(f"4n: build_inference rebuilt another UNet or latent {heun.model_shape}")
    dpmpp = copy.copy(heun)
    dpmpp.num_steps, dpmpp.solver = 10, "dpmpp_2m"
    cond = torch.randn(BATCH, 5, generator=gen, device=dev)
    dpmpp.generate(cond, generator=gen)  # warm-up at its shapes (cuDNN plans)
    for name, bundle, evals in (("heun-25", heun, 49), ("dpmpp_2m-10", dpmpp, 10)):
        wave, sec = counted(f"options {name}", lambda: bundle.generate(cond, generator=gen),
                            want_launches(evals * len(s.opt_gn) + len(s.opt_dec_gn),
                                          evals * len(s.opt_fa),
                                          convs=[(s.opt_cv, evals), (s.opt_dec_cv, 1)]))
        rates[f"options {name}"] = BATCH / sec
        waveforms_ok(f"options {name} + Griffin-Lim 32, {BATCH / sec:.2f} waveforms/s", wave)
    del heun, dpmpp, unet
    b32 = common.build_inference(workdir=work, dtype=torch.float32, num_steps=2, solver="heun",
                                 device=dev)
    noise = torch.randn(F32_BATCH, *b32.model_shape, generator=gen, device=dev)
    with torch.no_grad():
        with_kernels = b32.sample(cond[:F32_BATCH], noise=noise)
        with plain_versions():
            want = b32.sample(cond[:F32_BATCH], noise=noise)
    peak, err = want.abs().max().item(), (with_kernels - want).abs().max().item()
    log(f"[options-f32] Heun-2 decoded spectrograms {tuple(want.shape)} of the rebuilt run: "
        f"kernels vs plain max_abs_err={err:.3e} (peak {peak:.3e}, tol 1e-4 * peak)")
    if not (torch.isfinite(with_kernels).all() and err <= 1e-4 * peak):
        fail("4n: the f32 options sample through the kernels disagrees with the plain versions")
    del b32
    shutil.rmtree(work, ignore_errors=True)
    n_ae = len(s.opt_enc_gn) + len(s.opt_dec_gn)
    counts["options autoencoder train"], _ = counted_fit(
        "options-ae", make_autoencoder_steps(kl_weight=config.kl_weight, ema_decay=0.0),
        ae_state, flagship_loader(("signal",)), max_steps=1,
        want=want_launches(n_ae, convs=[(s.opt_enc_cv, 1), (s.opt_dec_cv, 1)]),
        want_gn_bwd=n_ae)
    del ae_state, ae_train, ckpt_state
    torch.cuda.empty_cache()

    # (b) the paired flagship
    obs, syn = paired_tables(arrays["waveforms"])
    paired = {training: PairedDataset(obs, syn, representation, cut=config.t, training=training)
              for training in (True, False)}
    n = len(arrays["waveforms"])
    dropped = len(set(range(0, n, 16)) | set(range(8, n, 32)))
    log(f"[paired] {n} records, {dropped} filtered out: {len(paired[True])} for training, "
        f"{len(paired[False])} for validation")
    if len(paired[True]) + len(paired[False]) != n - dropped:
        fail(f"4n: the paired filters kept {len(paired[True])} + {len(paired[False])} rows")

    def paired_loader(datasets, batch_size=TRAIN_BATCH, training=True,
                      keys=("signal", "cond_signal")):
        return BatchLoader(datasets[training], batch_size, shuffle=training, device=dev,
                           keys=keys, seed=SEED)

    pstate = TrainState(s.unet_p, make_optimizer("adam", s.unet_p, 1e-4), schedule)
    psteps = make_edm_steps(autoencoder=ae_t)
    timed, marks = tail_timed(psteps[0], PAIRED_STEPS, PAIRED_STEPS // 2)
    counts["paired train"], _ = counted_fit(
        "paired-train", (timed, psteps[1]), pstate, paired_loader(paired),
        max_steps=PAIRED_STEPS,
        want=want_launches((len(s.p_gn) + 2 * len(enc_gn)) * PAIRED_STEPS,
                           len(s.p_fa) * PAIRED_STEPS, len(s.p_fa) * PAIRED_STEPS,
                           convs=[(s.p_cv, PAIRED_STEPS), (enc_cv, 2 * PAIRED_STEPS)]),
        want_gn_bwd=len(s.p_gn) * PAIRED_STEPS, lr_schedule=schedule)
    rates["paired train"] = tail_rate(f"paired flagship, batch {TRAIN_BATCH}, bf16", marks,
                                      TRAIN_BATCH, PAIRED_STEPS // 2)
    pae = copy.deepcopy(ae_t).requires_grad_(True).train()
    n_ae = len(enc_gn) + len(dec_gn)
    counts["paired autoencoder train"], rows = counted_fit(
        "paired-ae", make_autoencoder_steps(kl_weight=config.kl_weight, ema_decay=0.0),
        TrainState(pae, make_optimizer("adamw", pae, 1e-4, 1e-4)), paired_loader(paired),
        max_steps=1, want=want_launches(2 * n_ae, convs=[(enc_cv, 2), (dec_cv, 2)]),
        want_gn_bwd=2 * n_ae)
    metrics = {k: v for r in rows for k, v in r.items() if k.startswith("training/")}
    log(f"[paired-ae] one step on a paired batch of {TRAIN_BATCH}: {json.dumps(metrics)}")
    if not {"training/cond_reconstruction_loss", "training/cond_kl_divergence"} <= set(metrics) \
            or not all(map(math.isfinite, metrics.values())):
        fail(f"4n: the paired autoencoder step's metrics {metrics}")
    del pae
    cond_signal = next(iter(paired_loader(paired, BATCH, False, ("cond_signal",)))
                       )["cond_signal"]

    def paired_sample():
        z = sample_edm(pstate.ema, (BATCH, *s.model_shape), autoencoder=ae_t, num_steps=10,
                       solver="dpmpp_2m", cast_params=torch.bfloat16, cond_signal=cond_signal,
                       generator=gen, device=dev)
        return gl32.invert_representation(z.movedim(-1, 1), generator=gen)

    paired_sample()  # warm-up at its shapes
    wave, sec = counted("paired dpmpp_2m-10", paired_sample, want_launches(
        10 * len(s.p_gn) + len(enc_gn) + len(dec_gn), 10 * len(s.p_fa),
        convs=[(s.p_cv, 10), (enc_cv, 1), (dec_cv, 1)]))
    rates["paired dpmpp_2m-10"] = BATCH / sec
    waveforms_ok(f"paired dpmpp_2m-10 from a validation cond_signal + Griffin-Lim 32, "
                 f"{BATCH / sec:.2f} waveforms/s", wave)
    del pstate
    torch.cuda.empty_cache()

    # (c) paired consistency and DDPM on the 1d_edm UNet, at reduced depth
    env = s.env_config
    envelope = env.make_representation()
    paired_1d = {training: PairedDataset(obs, syn, envelope, cut=env.t, training=training)
                 for training in (True, False)}
    cond_signal = next(iter(paired_loader(paired_1d, BATCH, False, ("cond_signal",)))
                       )["cond_signal"]
    n1, f1, k = len(s.u1_gn), len(s.u1_fa), PAIRED_1D_STEPS
    shape = (BATCH, *s.sig_1d)
    cst = TrainState(s.cons_unet, make_optimizer("radam", s.cons_unet, 1e-4))
    counts["paired consistency train"], _ = counted_fit(
        "paired-consistency", make_consistency_steps(ConsistencyConfig(), NEW_MAX_STEPS), cst,
        paired_loader(paired_1d, PAIRED_1D_BATCH), max_steps=k,
        want=want_launches(2 * n1 * k, 2 * f1 * k, f1 * k, convs=[(s.u1_cv, 2 * k)]),
        want_gn_bwd=n1 * k)
    dst = TrainState(s.ddpm_unet, make_optimizer("adamw", s.ddpm_unet, 1e-4, 0.0))
    counts["paired ddpm train"], _ = counted_fit(
        "paired-ddpm", ddpm_lib.make_ddpm_steps(ddpm_lib.DDPMConfig()), dst,
        paired_loader(paired_1d, PAIRED_1D_BATCH), max_steps=k,
        want=want_launches(n1 * k, f1 * k, f1 * k, convs=[(s.u1_cv, k)]), want_gn_bwd=n1 * k)
    with torch.no_grad():
        for label, fn, evals in (
                ("paired consistency 2 evals", lambda: sample_consistency(
                    cst.ema, shape, None, sigmas=(1.0,), cond_signal=cond_signal, generator=gen,
                    device=dev), 2),
                (f"paired ddpm {PAIRED_DDPM_STEPS} timesteps", lambda: ddpm_lib.ddpm_sample(
                    ddpm_lib.DDPMConfig(num_train_timesteps=PAIRED_DDPM_STEPS), dst.ema, shape,
                    cond_signal=cond_signal, generator=gen, device=dev), PAIRED_DDPM_STEPS)):
            signal, sec = counted(label, fn, want_launches(evals * n1, evals * f1,
                                                           convs=[(s.u1_cv, evals)]))
            rates[label] = BATCH / sec
            waveforms_ok(f"{label}, the envelope inverse, {BATCH / sec:.2f} waveforms/s",
                         envelope.invert_representation(signal.movedim(-1, 1)))
    log(f"[4n-rates] {json.dumps({k_: round(v, 2) for k_, v in rates.items()})}; {card_line()}")
    return counts


# ---- 4o. data parallelism: world size 1 through the process group, two gloo ranks on one
# card, the -d refusal, FSDP at world size 1 ----------------------------------------------
DP_F32_STEPS = 2  # f32 steps of the two gloo ranks held against one rank at the global batch
DP_BF16_STEPS = 5  # bf16 steps of the two gloo ranks, timed
DP_RESULTS = Path(__file__).resolve().parent / "build" / "chip_smoke_4o"


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, args: tuple, nprocs: int, timeout: float = 600.0):
    """``fn(rank, *args)`` in ``nprocs`` spawned processes; fails (killing
    them) when one fails or they are not all done within ``timeout`` s."""
    ctx = torch.multiprocessing.start_processes(fn, args=args, nprocs=nprocs, join=False,
                                                start_method="spawn")
    deadline = time.perf_counter() + timeout
    try:
        while not ctx.join(timeout=1):
            if time.perf_counter() > deadline:
                fail(f"{fn.__name__}: {nprocs} processes not done in {timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def flagship_loader(config, dev):
    """Phase 4's training loader: the 512 seeded synthetic waveforms at batch 128."""
    from tqdne_tpu_torch.data.dataset import ArrayDataset, synthetic_arrays
    from tqdne_tpu_torch.data.pipeline import BatchLoader

    arrays = synthetic_arrays(TRAIN_SAMPLES, t=config.t, seed=SEED)
    dataset = ArrayDataset(arrays, config.make_representation(), cut=config.t, cond=True,
                           split="full")
    return BatchLoader(dataset, TRAIN_BATCH, device=dev, keys=("signal", "cond"), seed=SEED)


def count_collectives():
    """Wrap torch.distributed's collectives to count their calls; returns the counts."""
    import torch.distributed as dist

    counts = collections.Counter()
    for name in ("all_reduce", "broadcast", "barrier", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "all_gather"):
        fn = getattr(dist, name)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)

        setattr(dist, name, counted)
    return counts


def zero_launches():
    from tqdne_tpu_torch.ops.group_norm import group_norm_silu

    torch.cuda.synchronize()
    for fn in launch_counters():
        fn.launches = 0
    group_norm_silu.backward_calls = group_norm_silu.backward_launches = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {fn.__name__: fn.launches for fn in launch_counters()}


def params_of(module) -> dict:
    return {n: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().clone()
            for n, p in module.named_parameters()}


def param_diff(got: dict, want: dict) -> tuple[int, float, float, str]:
    """(tensors not bit-identical, max |got - want|, max of that over TOL[f32]'s
    bound, the tensor where that share is largest)."""
    rtol, atol = TOL[torch.float32]
    differ, worst, share, where = 0, 0.0, 0.0, ""
    for name, w in want.items():
        g = got[name].to(w.device)
        if not torch.equal(g, w):
            differ += 1
            d = (g - w).abs()
            worst = max(worst, d.max().item())
            s = (d / (atol + rtol * w.abs())).max().item()
            if s > share:
                share, where = s, name
    return differ, worst, share, where


def dp_world1_worker(_index: int, port: int, want: dict, want_gn_bwd: int, out: str):
    """Phase 4o (a) and (d) in a subprocess of their own: after two warm-up
    steps, phase 4's flagship fit without a process group, then in a group of
    one (NCCL, joined through torchrun's environment), which must issue no
    collective, count the same launches and end bit-identical; then one
    flagship step through ``shard_with_ema`` at world size 1 against the
    plain step; then, the group destroyed, the fit without a group again (its
    rate tells the group's cost from the order's)."""
    import os

    import torch.distributed as dist

    from tqdne_tpu_torch.parallel import make_mesh, maybe_initialize_distributed, world_size
    from tqdne_tpu_torch.parallel.fsdp import shard_with_ema
    from tqdne_tpu_torch.train.loop import step_seed
    from tqdne_tpu_torch.train.state import TrainState, make_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    result, fits = {}, {}

    def fit(label: str):
        config, state, steps, _, _, schedule = training_setup(dev, torch.bfloat16)
        counts, rows = counted_fit(f"4o-{label}", steps, state, flagship_loader(config, dev),
                                   max_steps=TRAIN_STEPS, want=want, want_gn_bwd=want_gn_bwd,
                                   lr_schedule=schedule)
        fits[label] = params_of(state.model)
        result[label] = {"launches": counts,
                         "samples_per_s": TRAIN_BATCH * TRAIN_STEPS / rows[-1]["traintime"]}
        del state, steps
        torch.cuda.empty_cache()

    # warm-up: the process's first steps (cuDNN plans, the allocator) outside the fits
    config, state, (train_step, _), _, _, _ = training_setup(dev, torch.bfloat16)
    for batch, _ in zip(flagship_loader(config, dev), range(2)):
        train_step(state, batch, generator=torch.Generator(device=dev).manual_seed(SEED))
    del state
    fit("plain")
    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    if not maybe_initialize_distributed(DEVICE) or world_size() != 1:
        fail("4o: no process group of one")
    result["backend"] = dist.get_backend()
    collectives = count_collectives()
    fit("world1")
    result["collectives"] = dict(collectives)

    # (d) one flagship step through FSDP at world size 1 against the plain step
    config, plain, (train_step, _), _, _, schedule = training_setup(dev, torch.bfloat16)
    model, ema = shard_with_ema(copy.deepcopy(plain.model), make_mesh())
    sharded = TrainState(model, make_optimizer("adam", model, 1e-4), schedule, ema=ema)
    conv = next(p for n, p in model.named_parameters() if p.ndim == 4 and p.numel() >= 2**16)
    result["fsdp_layout"] = {"placements": [repr(pl) for pl in conv.placements],
                             "local_shape": list(conv.to_local().shape),
                             "channels_last": conv.to_local().is_contiguous(
                                 memory_format=torch.channels_last)}
    batch = next(iter(flagship_loader(config, dev)))
    for label, state in (("plain", plain), ("fsdp", sharded)):
        gen = torch.Generator(device=dev).manual_seed(step_seed(SEED, 0, 0))
        torch.manual_seed(step_seed(SEED, 0, 1))
        zero_launches()
        t0 = time.perf_counter()
        loss = train_step(state, batch, generator=gen)["loss"]
        torch.cuda.synchronize()
        result[f"step_{label}"] = {"loss": loss.item(), "launches": read_launches(),
                                   "ms": (time.perf_counter() - t0) * 1e3}
    differ, worst, share, _ = param_diff(params_of(sharded.model), params_of(plain.model))
    result["fsdp_params_differ"], result["fsdp_max_abs"], result["fsdp_tol_share"] = \
        differ, worst, share
    del plain, sharded, model, ema
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    fit("plain_after")
    result["params"] = len(fits["plain"])
    result["params_differ"] = {k: param_diff(fits[k], fits["plain"])[0]
                               for k in ("world1", "plain_after")}
    Path(out).write_text(json.dumps(result))


def dp_gloo_worker(rank: int, port: int, want_step: dict, out_dir: str):
    """Phase 4o (b): rank ``rank`` of two sharing card 0 over gloo.  Rank 0
    first runs the 1-rank f32 reference (DP_F32_STEPS flagship steps at the
    global batch, dropout 0, no group); then both ranks run the same steps
    on their 64 rows, and DP_BF16_STEPS flagship bf16 steps (Adam, dropout
    on) timed, with the gradient all-reduce timed inside them.  The f32
    steps descend by plain SGD at 1e-4 and keep the gradients each update
    reads: Adam divides each gradient by its own magnitude, so an element
    whose gradient is zero up to rounding moves by up to the learning rate
    either way, and its parameters say nothing finer about the all-reduce."""
    import hashlib

    import torch.distributed as dist

    from tqdne_tpu_torch.train import state as state_mod
    from tqdne_tpu_torch.train.loop import step_seed

    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    result = {"rank": rank}

    def batches(loader, n: int):
        """The loader's first ``n`` batches, over as many epochs as it takes."""
        while n > 0:
            for batch in loader:
                if n == 0:
                    break
                n -= 1
                yield batch

    def run(dtype, steps: int, sgd: bool):
        config, state, (train_step, _), _, _, _ = training_setup(dev, dtype)
        grads = []
        if sgd:  # dropout 0, plain gradient descent, the gradients of each update kept
            for m in state.model.modules():
                if isinstance(m, torch.nn.Dropout):
                    m.p = 0.0
            names = {p: n for n, p in state.model.named_parameters()}
            state.optimizer = torch.optim.SGD(list(names), lr=1e-4)
            state.lr_schedule = None
            state.optimizer.register_step_pre_hook(lambda opt, *_: grads.append(
                {names[p]: p.grad.detach().cpu() for p in names if p.grad is not None}))
        losses, walls = [], []
        for n, batch in enumerate(batches(flagship_loader(config, dev), steps)):
            gen = torch.Generator(device=dev).manual_seed(step_seed(SEED, n, 0))
            torch.manual_seed(step_seed(SEED, n, 1, dist.get_rank() if dist.is_initialized()
                                        else 0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(train_step(state, batch, generator=gen)["loss"].item())
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return state, losses, walls, grads

    if rank == 0:  # the reference: one rank, the global batch, before the group exists
        ref_state, ref_losses, _, ref_grads = run(torch.float32, DP_F32_STEPS, sgd=True)
        ref_params = {n: p.cpu() for n, p in params_of(ref_state.model).items()}
        del ref_state
        torch.cuda.empty_cache()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    reduce_ms = []
    reduce = state_mod.all_reduce_gradients_

    def timed_reduce(params, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce(params, *args)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    state_mod.all_reduce_gradients_ = timed_reduce
    state, losses, _, grads = run(torch.float32, DP_F32_STEPS, sgd=True)
    got = params_of(state.model)
    digest = hashlib.sha256()
    for name in sorted(got):
        digest.update(got[name].cpu().numpy().tobytes())
    digests = [None, None]
    dist.all_gather_object(digests, digest.hexdigest())
    all_losses = [None, None]
    dist.all_gather_object(all_losses, losses)
    result["ranks_bit_identical"] = digests[0] == digests[1]
    if rank == 0:
        mean = [sum(ls) / 2 for ls in zip(*all_losses)]
        worst, where = 0.0, ""
        for step_got, step_want in zip(grads, ref_grads):
            # 1e-4 of each gradient's peak, plus 1e-6 of the largest for those zero up to
            # rounding (a bias before a GroupNorm whose groups it shifts alike)
            largest = max(w.abs().max().item() for w in step_want.values())
            for name, want in step_want.items():
                err = (step_got[name] - want).abs().max().item()
                share = err / (1e-4 * want.abs().max().item() + 1e-6 * largest)
                if share > worst:
                    worst, where = share, name
        result["f32"] = {"losses_2ranks": mean, "losses_1rank": ref_losses,
                         "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(mean, ref_losses)),
                         "grad_share": worst, "grad_worst_at": where,
                         "grads": sum(len(g) for g in ref_grads)}
        differ, worst, share, where = param_diff(got, {n: p.to(dev)
                                                       for n, p in ref_params.items()})
        result["f32"] |= {"params_differ": differ, "max_abs": worst, "tol_share": share,
                          "worst_at": where}
    del state, got, grads
    torch.cuda.empty_cache()
    reduce_ms.clear()
    zero_launches()
    _, losses, walls, _ = run(torch.bfloat16, DP_BF16_STEPS, sgd=False)
    result["bf16"] = {"launches": read_launches(), "wall_ms": walls, "all_reduce_ms": reduce_ms,
                      "losses": losses, "want_launches": {k: v * DP_BF16_STEPS
                                                          for k, v in want_step.items()}}
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()


def data_parallel_path(train_want: dict, want_gn_bwd: int, step_want: dict,
                       phase4_rate: float) -> dict:
    """Phase 4o: (a) and (d) in a subprocess, (b) in two, (c) the train CLI's
    refusal of ``-d 2`` on one card and its ``-d 1``.  Returns the launch
    counts by run."""
    shutil.rmtree(DP_RESULTS, ignore_errors=True)
    DP_RESULTS.mkdir(parents=True)
    card = card_line()

    # (a) world size 1 through the new code, and (d) FSDP at world size 1
    out = DP_RESULTS / "world1.json"
    t0 = time.perf_counter()
    spawn_ranks(dp_world1_worker, (free_port(), train_want, want_gn_bwd, str(out)), 1)
    w1 = json.loads(out.read_text())
    log(f"[4o] (a) world size 1 ({w1['backend']} group of one, in a subprocess, "
        f"{time.perf_counter() - t0:.1f} s with (d)): Trainer.fit {TRAIN_STEPS} steps, "
        f"launches {w1['world1']['launches']} (phase 4's {train_want}; the subprocess's fits "
        f"without a group {w1['plain']['launches']}, {w1['plain_after']['launches']}); "
        f"collectives issued {w1['collectives']}; of {w1['params']} parameters, not "
        f"bit-identical to the first fit without a group: {w1['params_differ']}; samples/s of "
        f"traintime: without a group {w1['plain']['samples_per_s']:.2f}, world 1 "
        f"{w1['world1']['samples_per_s']:.2f}, without a group again (after it was destroyed) "
        f"{w1['plain_after']['samples_per_s']:.2f}; phase 4's fit {phase4_rate:.2f} ({card})")
    if (any(w1[k]["launches"] != train_want for k in ("plain", "world1", "plain_after"))
            or any(w1["collectives"].values()) or any(w1["params_differ"].values())):
        fail("4o (a): world size 1 through the process group differs from the plain fit")
    fsdp, plain = w1["step_fsdp"], w1["step_plain"]
    log(f"[4o] (d) FSDP at world size 1 (every DTensor whole): one flagship bf16 step at "
        f"{TRAIN_BATCH}, loss {fsdp['loss']:.6e} (plain {plain['loss']:.6e}), launches "
        f"{fsdp['launches']} (plain {plain['launches']}), {w1['fsdp_params_differ']} parameters "
        f"not bit-identical, max abs {w1['fsdp_max_abs']:.3e} ({w1['fsdp_tol_share']:.3f} of "
        f"the f32 bound); a large conv weight: {w1['fsdp_layout']}; step wall {fsdp['ms']:.1f} "
        f"ms (plain {plain['ms']:.1f} ms, first calls) ({card})")
    log("[4o] (d) FSDP and HSDP over several ranks are held on the CPU only "
        "(tests/test_torch_port_parallel.py); this card shows world size 1")
    if (fsdp["launches"] != plain["launches"] or plain["launches"] != step_want
            or w1["fsdp_tol_share"] > 1.0 or abs(fsdp["loss"] - plain["loss"]) > 1e-5 * abs(
                plain["loss"])):
        fail("4o (d): the FSDP step at world size 1 disagrees with the plain step")

    # (b) two ranks sharing the one card over gloo
    t0 = time.perf_counter()
    spawn_ranks(dp_gloo_worker, (free_port(), step_want, str(DP_RESULTS)), 2)
    ranks = [json.loads((DP_RESULTS / f"rank{r}.json").read_text()) for r in range(2)]
    f32 = ranks[0]["f32"]
    log(f"[4o] (b) two ranks sharing one card over gloo ({time.perf_counter() - t0:.1f} s): "
        f"{DP_F32_STEPS} f32 flagship steps (dropout 0, SGD at 1e-4) at 2 x "
        f"{TRAIN_BATCH // 2}: losses {f32['losses_2ranks']} vs one rank at {TRAIN_BATCH} "
        f"{f32['losses_1rank']} (max rel {f32['loss_rel']:.3e}, tol 1e-5); the {f32['grads']} "
        f"averaged gradients the updates read: worst max abs err {f32['grad_share']:.3f} of "
        f"its bound (1e-4 of its peak + 1e-6 of the largest) at {f32['grad_worst_at']}; "
        f"parameters: "
        f"{f32['params_differ']} tensors not "
        f"bit-identical to one rank, max abs {f32['max_abs']:.3e}, {f32['tol_share']:.3f} of "
        f"the f32 bound (rtol, atol {TOL[torch.float32]}) at {f32['worst_at']}; ranks bit-identical to each other: "
        f"{ranks[0]['ranks_bit_identical']}")
    for r in ranks:
        b = r["bf16"]
        log(f"[4o] (b) rank {r['rank']}, two ranks sharing one card over gloo; not a scaling "
            f"figure: {DP_BF16_STEPS} bf16 steps at {TRAIN_BATCH // 2} rows, launches "
            f"{b['launches']} (want {b['want_launches']}), wall ms a step "
            f"{[round(w, 1) for w in b['wall_ms']]}, of which the gradient all-reduce "
            f"{[round(w, 1) for w in b['all_reduce_ms']]} ({card})")
    if (not ranks[0]["ranks_bit_identical"] or f32["loss_rel"] > 1e-5 or f32["tol_share"] > 1.0
            or f32["grad_share"] > 1.0
            or any(r["bf16"]["launches"] != r["bf16"]["want_launches"] for r in ranks)
            or not all(map(math.isfinite, ranks[0]["bf16"]["losses"]))):
        fail("4o (b): the two gloo ranks disagree with one rank or with each other")

    # (c) the train CLI refuses -d 2 on one card, and takes -d 1 to run
    cmd = [sys.executable, "-m", "tqdne_tpu_torch.cli.train", "latent_edm", "--tiny",
           "--device", "cuda", "--workdir", str(DP_RESULTS / "cli")]
    root = Path(__file__).resolve().parent
    refused = subprocess.run([*cmd, "-d", "2"], capture_output=True, text=True, cwd=root,
                             timeout=300)
    stub = ("import sys; from tqdne_tpu_torch.cli import train; "
            "train.run = lambda args: print('RAN', args.num_devices); "
            "train.main(sys.argv[1:])")
    single = subprocess.run([sys.executable, "-c", stub, *cmd[3:], "-d", "1"],
                            capture_output=True, text=True, cwd=root, timeout=300)
    message = (refused.stderr.strip().splitlines() or [""])[-1]
    log(f"[4o] (c) train CLI -d 2 on {torch.cuda.device_count()} card: exit {refused.returncode}, "
        f"{message!r}; -d 1 reaches the training run: {single.stdout.strip()!r} (exit "
        f"{single.returncode})")
    if (refused.returncode == 0 or "asks for 2 devices, but 1 CUDA" not in refused.stderr
            or single.returncode != 0 or "RAN 1" not in single.stdout):
        fail("4o (c): the train CLI's -d refusal or its -d 1")
    shutil.rmtree(DP_RESULTS, ignore_errors=True)
    return {"4o world1": w1["world1"]["launches"], "4o gloo2 rank0": ranks[0]["bf16"]["launches"]}


def bound(nbytes, ops, dtype):
    """Least time for the work: bytes over HBM rate vs operations over peak."""
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / PEAK_OPS[dtype]
    return dict(bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


SP_RESULTS = Path(__file__).resolve().parent / "build" / "chip_smoke_4p"
SP_K = 2  # shards of each sample's rows: two ranks sharing the card over gloo
SP_BATCHES = (2, BATCH)  # the f32 samples held against one rank
SP_STEPS = 10  # dpmpp_2m steps of the spatial samples
SP_TRAIN_BATCH = 32  # the f32 spatial train step's global batch
GN_STATS_OPS, GN_APPLY_OPS = 4, {True: 8, False: 5}  # per element: sums, d, d^2 / affine, SiLU
COLLECTIVES = ("all_gather", "all_reduce", "broadcast")


def gn_entries():
    """The wrappers of the GroupNorm kernel's statistics and normalisation entries."""
    from tqdne_tpu_torch.ops.group_norm import group_norm_apply, group_norm_stats

    return group_norm_stats, group_norm_apply


def all_launches() -> dict:
    """``read_launches`` with the GroupNorm entries' counts."""
    counts = read_launches()
    return counts | {fn.__name__: fn.launches for fn in gn_entries()}


def zero_all_launches():
    zero_launches()
    for fn in gn_entries():
        fn.launches = 0


def timed_collectives():
    """Wrap torch.distributed's collectives to sum their wall ms (synchronised
    before and after); returns the running totals."""
    import torch.distributed as dist

    totals = collections.Counter()
    for name in COLLECTIVES:
        fn = getattr(dist, name)

        def timed(*a, _fn=fn, _name=name, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            totals[_name + "_ms"] += 1e3 * (time.perf_counter() - t0)
            totals[_name] += 1
            return out

        setattr(dist, name, timed)
    return totals


def spatial_worker(rank: int, port: int, out_dir: str):
    """Phase 4p: rank ``rank`` of two sharing card 0 over gloo.  Rank 0 first takes
    the references on one rank, before the group exists: the flagship's f32
    dpmpp_2m-10 samples (decoded) at batch 2 and 32, the bf16 one at 32, and one f32
    train step's loss and gradients.  Then both ranks build the flagship with
    ``spatial=2`` and take the same samples and step on their halves of the rows
    (launches counted, the GroupNorm shapes recorded, the collectives timed), a
    bf16 ``generate`` (with Griffin-Lim 32) timed, and one ``serve --spatial 2``
    round on loopback."""
    import json as json_mod
    import threading
    import urllib.request

    import torch.distributed as dist

    from tqdne_tpu_torch import configs
    from tqdne_tpu_torch.cli import serve as serve_cli
    from tqdne_tpu_torch.cli.common import build_inference
    from tqdne_tpu_torch.parallel import spatial
    from tqdne_tpu_torch.train.loop import step_seed
    from tqdne_tpu_torch.train.steps import make_edm_steps

    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    cond = torch.randn(BATCH, 5, generator=torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    result = {"rank": rank}

    def flagship(dtype, k):
        return build_inference("latent_edm", dtype=dtype, num_steps=SP_STEPS, solver="dpmpp_2m",
                               gl_iters=32, device=dev, spatial=k)

    def sample(bundle, n):
        return bundle.sample(cond[:n], generator=torch.Generator(device=dev).manual_seed(SEED + n))

    # the train step's batch, read before the group exists (the loader cuts a group's rows)
    step_batch = next(iter(flagship_loader(configs.LatentSpectrogramConfig(), dev)))
    step_batch = {k: v[:SP_TRAIN_BATCH] for k, v in step_batch.items()}

    def train_step_run(mesh):
        """One f32 flagship step (dropout 0, SGD at 1e-4) at SP_TRAIN_BATCH: its loss,
        the gradients the update read, its launches."""
        _, state, _, ae, _, _ = training_setup(dev, torch.float32)
        for m in state.model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        names = {p: n for n, p in state.model.named_parameters()}
        state.optimizer = torch.optim.SGD(list(names), lr=1e-4)
        state.lr_schedule = None
        grads = {}
        state.optimizer.register_step_pre_hook(lambda opt, *_: grads.update(
            {names[p]: p.grad.detach().cpu() for p in names if p.grad is not None}))
        batch = step_batch if mesh is None else spatial.shard_batch(mesh, step_batch)
        train_step, _ = make_edm_steps(autoencoder=ae, mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(step_seed(SEED, 0, 0))
        zero_all_launches()
        t0 = time.perf_counter()
        loss = train_step(state, batch, generator=gen)["loss"].item()
        torch.cuda.synchronize()
        return {"loss": loss, "launches": all_launches(),
                "ms": 1e3 * (time.perf_counter() - t0)}, grads

    if rank == 0:  # the references: one rank, before the group exists
        refs = {}
        for dtype, batches in ((torch.float32, SP_BATCHES), (torch.bfloat16, (BATCH,))):
            bundle = flagship(dtype, 0)
            for n in batches:
                zero_all_launches()
                refs[(str(dtype), n)] = sample(bundle, n).cpu()
                result[f"ref_launches_{str(dtype)[6:]}_{n}"] = all_launches()
            del bundle
        result["ref_step"], ref_grads = train_step_run(None)
        torch.cuda.empty_cache()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=SP_K)
    totals = timed_collectives()
    checks = {}
    for dtype, batches in ((torch.float32, SP_BATCHES), (torch.bfloat16, (BATCH,))):
        bundle = flagship(dtype, SP_K)
        for n in batches:
            label = f"{str(dtype)[6:]}_{n}"
            zero_all_launches()
            totals.clear()
            t0 = time.perf_counter()
            held = {}
            # the GroupNorm shapes the timing rows need, recorded on this run
            gn_calls = record_calls([bundle.unet, bundle.autoencoder],
                                    lambda: held.update(got=sample(bundle, n)))[0]
            got = held["got"]
            if dtype == torch.bfloat16:
                result["gn_calls"] = [[str(c[0])[6:], str(c[1])[6:], *c[2:]] for c in gn_calls]
            torch.cuda.synchronize()
            checks[label] = {"launches": all_launches(), "ms": 1e3 * (time.perf_counter() - t0),
                             "collectives": dict(totals)}
            if rank == 0:
                want = refs[(str(dtype), n)].to(dev)
                checks[label] |= {"max_abs": (got - want).abs().max().item(),
                                  "peak": want.abs().max().item(),
                                  "rel_l2": ((got - want).norm() / want.norm()).item(),
                                  "finite": bool(torch.isfinite(got).all())}
        if dtype == torch.bfloat16:
            for _ in range(2):  # generate (sample, decode, Griffin-Lim 32) timed; the second counts
                totals.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gen = torch.Generator(device=dev).manual_seed(SEED)
                wave = bundle.generate(cond, generator=gen)
                torch.cuda.synchronize()
            result["generate"] = {"ms": 1e3 * (time.perf_counter() - t0), "shape": list(wave.shape),
                                  "finite": bool(torch.isfinite(wave).all()),
                                  "collectives": dict(totals)}
            serve_bundle = bundle
        else:
            del bundle
    result["checks"] = checks

    # one f32 train step on the two halves of every sample's rows
    mesh = spatial.spatial_mesh(SP_K)
    totals.clear()
    result["step"], grads = train_step_run(mesh)
    result["step"]["collectives"] = dict(totals)
    if rank == 0:
        largest = max(g.abs().max().item() for g in ref_grads.values())
        worst, where = 0.0, ""
        for name, want in ref_grads.items():
            err = (grads[name] - want).abs().max().item()
            share = err / (1e-4 * want.abs().max().item() + 1e-6 * largest)
            if share > worst:
                worst, where = share, name
        result["step"] |= {"grad_share": worst, "grad_worst_at": where, "grads": len(ref_grads),
                           "loss_rel": abs(result["step"]["loss"] - result["ref_step"]["loss"])
                           / abs(result["ref_step"]["loss"])}
    del grads
    torch.cuda.empty_cache()

    # one serve --spatial 2 round: rank 0 serves on loopback, rank 1 follows
    args = serve_cli.parse_args(["--device", DEVICE, "--num-steps", str(SP_STEPS), "--solver",
                                 "dpmpp_2m", "--gl-iters", "32", "--batch-size", str(BATCH),
                                 "--port", "0", "--spatial", str(SP_K)])
    if rank == 0:
        server, batcher = serve_cli.build_server(args, serve_bundle)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            body = json_mod.dumps({"conditions": [[50, 5.5, 400, 20, 100]] * 4, "seed": 7,
                                   "format": "b64"}).encode()
            t0 = time.perf_counter()
            req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/generate",
                                         data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                reply = json_mod.loads(r.read())
                result["serve"] = {"status": r.status, "shape": reply["shape"],
                                   "ms": 1e3 * (time.perf_counter() - t0)}
        finally:
            server.shutdown()
            server.server_close()
            batcher.shutdown()
            serve_cli.stop_followers(args.batch_size)
            thread.join(timeout=60)
        result["serve"]["batches"] = batcher.batches_run
    else:
        result["serve"] = {"batches": serve_cli.follow(serve_bundle, args.batch_size)}
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()


def spatial_path(per_eval: tuple[int, int], per_decode: int, convs: tuple[list, list], dev,
                 errs: dict) -> dict:
    """Phase 4p: the two gloo ranks of ``spatial_worker``, then the GroupNorm
    entries against their plain versions and timed at the shapes rank 0 recorded.
    Returns the entries' timing rows and the launch counts by run."""
    from tqdne_tpu_torch.ops.group_norm import (
        group_norm_apply,
        group_norm_apply_plain,
        group_norm_stats,
        group_norm_stats_plain,
        merge_group_stats,
    )

    shutil.rmtree(SP_RESULTS, ignore_errors=True)
    SP_RESULTS.mkdir(parents=True)
    card = card_line()
    t0 = time.perf_counter()
    spawn_ranks(spatial_worker, (free_port(), str(SP_RESULTS)), SP_K, timeout=900)
    ranks = [json.loads((SP_RESULTS / f"rank{r}.json").read_text()) for r in range(SP_K)]
    lead = ranks[0]
    per_sample = per_eval[0] * SP_STEPS + per_decode
    want = want_launches(0, per_eval[1] * SP_STEPS, convs=[(convs[0], SP_STEPS), (convs[1], 1)])
    want |= {"group_norm_stats": per_sample, "group_norm_apply": per_sample}
    bad = []
    for label, c in lead["checks"].items():
        # f32: the largest error within 1e-4 of the peak; bf16, whose 1-ulp roundings the ODE
        # carries on through 10 steps and the decoder: the relative L2 error within bf16's rtol
        f32 = label.startswith("float32")
        err = c["max_abs"] / c["peak"] if f32 else c["rel_l2"]
        limit = 1e-4 if f32 else TOL[torch.bfloat16][0]
        ref = lead[f"ref_launches_{label}"]
        log(f"[4p] {label.replace('_', ' at batch ')}: dpmpp_2m-{SP_STEPS} + decode on {SP_K} "
            f"ranks sharing one card over gloo against one rank: max abs {c['max_abs']:.3e} of "
            f"peak {c['peak']:.3e} ({c['max_abs'] / c['peak']:.3e} of it), relative L2 "
            f"{c['rel_l2']:.3e}; bound {limit:g} on the {'former' if f32 else 'latter'}; "
            f"launches {c['launches']} (one rank: {ref}), wall {c['ms']:.1f} ms of which "
            f"collectives {c['collectives']} ({card})")
        for r in ranks:
            if r["checks"][label]["launches"] != want:
                bad.append(f"{label} rank {r['rank']} launches {r['checks'][label]['launches']}")
        if err > limit or not c["finite"] or ref["group_norm_silu"] != per_sample:
            bad.append(f"{label}: {err:.3e} against {limit:g}")
    gen = lead["generate"]
    coll_ms = sum(v for k, v in gen["collectives"].items() if k.endswith("_ms"))
    log(f"[4p] bf16 generate at batch {BATCH} (dpmpp_2m-{SP_STEPS}, decode, Griffin-Lim 32) on "
        f"{SP_K} ranks sharing one card: {gen['ms']:.1f} ms, of which collectives "
        f"{coll_ms:.1f} ms ({coll_ms / gen['ms']:.3f} of the wall; {gen['collectives']}); "
        f"waveforms {gen['shape']} finite {gen['finite']}; a correctness cell, not a scaling "
        f"figure ({card})")
    step, ref = lead["step"], lead["ref_step"]
    log(f"[4p] one f32 flagship train step at {SP_TRAIN_BATCH} (dropout 0, SGD at 1e-4) on "
        f"{SP_K} ranks: loss {step['loss']:.6e} against one rank's {ref['loss']:.6e} (rel "
        f"{step['loss_rel']:.3e}, tol 1e-4); the {step['grads']} gradients the update read: "
        f"worst {step['grad_share']:.3f} of 1e-4 of its peak + 1e-6 of the largest, at "
        f"{step['grad_worst_at']}; launches {step['launches']} (one rank: {ref['launches']}); "
        f"wall {step['ms']:.1f} ms (one rank {ref['ms']:.1f} ms), collectives "
        f"{step['collectives']} ({card})")
    step_want = dict(ref["launches"], group_norm_silu=0,
                     group_norm_stats=ref["launches"]["group_norm_silu"],
                     group_norm_apply=ref["launches"]["group_norm_silu"])
    # the loss to 1e-4: the encoder's latents differ at about 5e-6 of their peak between the
    # shards' summation order and one rank's (measured on the CPU), which the EDM weighting of
    # a random-weight loss in the thousands carries to about 2e-5
    if (step["loss_rel"] > 1e-4 or step["grad_share"] > 1.0 or step["launches"] != step_want
            or not step["launches"]["flash_attention_bwd_dq"]):
        bad.append(f"train step: {step}")
    serve = lead["serve"]
    log(f"[4p] serve --spatial {SP_K}: one request of 4 rows, status {serve['status']}, shape "
        f"{serve['shape']}, {serve['ms']:.1f} ms; batches run by rank: "
        f"{[r['serve']['batches'] for r in ranks]} (warm-up and request) ({card})")
    if serve["status"] != 200 or serve["shape"] != [4, 3, 4064] or any(
            r["serve"]["batches"] != 2 for r in ranks):
        bad.append(f"serve: {serve}")
    log(f"[4p] {time.perf_counter() - t0:.1f} s for the two ranks")
    if bad:
        fail(f"4p: the spatial path disagrees: {bad}")

    # the two entries against their plain versions, at the shapes of one UNet eval and one
    # decode of the bf16 run (one shard's rows), f32 and bf16; then timed
    gen_ = torch.Generator(device=dev).manual_seed(SEED)
    calls = [tuple(c) for c in lead["gn_calls"]]
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    rows = {"group_norm_stats": [], "group_norm_apply": []}
    one_eval = calls[:per_eval[0]] + calls[-per_decode:]
    errs.setdefault("group_norm_stats", 0.0)
    errs.setdefault("group_norm_apply", 0.0)
    for key in dict.fromkeys(one_eval):
        xd, pd, s, c, g, silu = key
        for xdtype, pdtype in ((torch.float32, torch.float32), (dtypes[xd], dtypes[pd])):
            x = (torch.randn(BATCH, s, c, generator=gen_, device=dev) * 2 + 1).to(xdtype)
            w = (torch.rand(c, generator=gen_, device=dev) + 0.5).to(pdtype)
            b = torch.randn(c, generator=gen_, device=dev).to(pdtype)
            st, st_plain = group_norm_stats(x, g), group_norm_stats_plain(x, g)
            err_s, ok_s = close(st, st_plain, torch.float32)
            other = group_norm_stats(torch.randn_like(x), g)  # the other shard's
            mean, rstd = merge_group_stats(torch.stack([st, other]))
            err_a, ok_a = close(group_norm_apply(x, mean, rstd, w, b, g, silu),
                                group_norm_apply_plain(x, mean, rstd, w, b, g, silu), xdtype)
            errs["group_norm_stats"] = max(errs["group_norm_stats"], err_s)
            errs["group_norm_apply"] = max(errs["group_norm_apply"], err_a)
            if not (ok_s and ok_a):
                fail(f"4p: group_norm_stats/apply B={BATCH} S={s} C={c} G={g} {xdtype} {pdtype}: "
                     f"{err_s:.3e} {err_a:.3e}")
        x = torch.randn(BATCH, s, c, generator=gen_, device=dev).to(dtypes[xd])
        w = torch.ones(c, device=dev, dtype=dtypes[pd])
        b = torch.zeros(c, device=dev, dtype=dtypes[pd])
        mean, rstd = merge_group_stats(torch.stack([group_norm_stats(x, g)] * SP_K))
        # the library call: torch's group_norm on the whole (two shards') tensor, (B, C, 2S)
        whole = torch.cat([x] * SP_K, 1).transpose(1, 2)
        wx, bx = w.to(x.dtype), b.to(x.dtype)
        lib = (lambda: F.silu(F.group_norm(whole, g, wx, bx, 1e-5))) if silu else \
            (lambda: F.group_norm(whole, g, wx, bx, 1e-5))
        lib_ms = device_ms(lib)
        n = one_eval.count(key)
        rows["group_norm_stats"].append(dict(
            shape=[BATCH, s, c], groups=g, dtype=xd, calls=n,
            ms=device_ms(lambda: group_norm_stats(x, g)),
            plain_ms=device_ms(lambda: group_norm_stats_plain(x, g)), library_ms=lib_ms,
            **bound(x.numel() * x.element_size() + 12 * BATCH * g, GN_STATS_OPS * x.numel(),
                    torch.float32)))
        rows["group_norm_apply"].append(dict(
            shape=[BATCH, s, c], groups=g, silu=silu, dtype=xd, scale_dtype=pd, calls=n,
            ms=device_ms(lambda: group_norm_apply(x, mean, rstd, w, b, g, silu)),
            plain_ms=device_ms(lambda: group_norm_apply_plain(x, mean, rstd, w, b, g, silu)),
            library_ms=lib_ms,
            **bound(2 * x.numel() * x.element_size() + 2 * c * w.element_size() + 8 * BATCH * g,
                    GN_APPLY_OPS[silu] * x.numel(), torch.float32)))
    for name, rs in rows.items():
        log(f"[time] {name} over one UNet eval and one decode on one of {SP_K} shards, batch "
            f"{BATCH}, bf16: ms {sum(r['ms'] * r['calls'] for r in rs):.4f}, plain "
            f"{sum(r['plain_ms'] * r['calls'] for r in rs):.4f}, bound "
            f"{sum(r['bound_ms'] * r['calls'] for r in rs):.4f}, F.group_norm on the whole "
            f"tensor {sum(r['library_ms'] * r['calls'] for r in rs):.4f} ({card})")
    return {"rows": rows, "launches": {f"4p {k}": v["launches"]
                                       for k, v in lead["checks"].items()}
            | {"4p train step": step["launches"]}}


INT8_SOLVERS = (("heun", 25), ("dpmpp_2m", 10))


def int8_path(dev, per_eval: tuple[int, int], per_decode: int,
              convs: tuple[list, list]) -> dict:
    """Phase 4q: the flagship (bf16, batch 32, Griffin-Lim 32) with ``--int8`` beside
    bf16 at Heun-25 and dpmpp_2m-10: waveforms/s of each, launches, the int32 sums of
    every convolution shape of one UNet eval and one decode against the plain version
    on the card (bit for bit), the output's cosine against bf16, and one quantized
    convolution's device ms beside cuDNN's bf16 convolution."""
    from tqdne_tpu_torch.cli.common import build_inference
    from tqdne_tpu_torch.nn import layers as layers_mod
    from tqdne_tpu_torch.nn.quant import (
        int8_scope,
        int_conv_mm,
        int_conv_plain,
        quant_conv,
        quantize_symmetric,
    )

    card = card_line()
    cond = torch.randn(BATCH, 5, generator=torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    out, launches = {}, {}
    for solver, steps in INT8_SOLVERS:
        for int8 in (False, True):
            bundle = build_inference("latent_edm", dtype=torch.bfloat16, num_steps=steps,
                                     solver=solver, gl_iters=32, device=dev, int8=int8)
            walls = []
            for run in range(3):
                gen = torch.Generator(device=dev).manual_seed(SEED)
                if run == 1:
                    zero_all_launches()
                    quant_conv.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                signal = bundle.sample(cond, generator=gen)
                wave = bundle.invert(signal, generator=gen)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if run == 1:
                    counts = all_launches() | {"quant_conv": quant_conv.launches}
            label = f"{solver}-{steps}{' int8' if int8 else ''}"
            launches[f"4q {label}"] = counts
            out[label] = {"signal": signal.float(), "wf_s": BATCH / statistics.median(walls[1:]),
                          "walls": walls, "finite": bool(torch.isfinite(wave).all())}
            evals = 2 * steps - 1 if solver == "heun" else steps
            # int8: every convolution is quant_conv, with its own bias
            want = want_launches(per_eval[0] * evals + per_decode, per_eval[1] * evals,
                                 convs=[] if int8 else [(convs[0], evals), (convs[1], 1)])
            want |= {"group_norm_stats": 0, "group_norm_apply": 0}
            got = {k: v for k, v in counts.items() if k != "quant_conv"}
            if got != want or (counts["quant_conv"] > 0) != int8 or not out[label]["finite"]:
                fail(f"4q: {label}: launches {counts} (want {want}), finite "
                     f"{out[label]['finite']}")
        a, b = (out[f"{solver}-{steps}{s}"]["signal"].flatten().double() for s in ("", " int8"))
        cos = (a @ b / (a.norm() * b.norm())).item()
        log(f"[4q] {solver}-{steps} + decode + Griffin-Lim 32, batch {BATCH}: bf16 "
            f"{out[f'{solver}-{steps}']['wf_s']:.2f} waveforms/s, int8 "
            f"{out[f'{solver}-{steps} int8']['wf_s']:.2f} waveforms/s (median of the last two "
            f"of 3 runs each); the decoded signal's cosine int8 vs bf16 {cos:.5f} (gate 0.98); "
            f"launches {launches[f'4q {solver}-{steps} int8']} ({card})")
        if cos < 0.98:
            fail(f"4q: {solver}-{steps}: int8 cosine {cos:.5f} against bf16")

    # every convolution of one UNet eval and one decode: the int32 sums against the plain
    # version (a float64 convolution of the codes, exact) on the card
    seen = {}
    real = layers_mod.quant_conv

    def capture(x, weight, bias, stride, padding):
        key = (tuple(x.shape), str(x.dtype), tuple(weight.shape), stride, padding)
        seen.setdefault(key, (x.detach(), weight.detach(), bias.detach(), stride, padding))
        return real(x, weight, bias, stride, padding)

    layers_mod.quant_conv = capture
    try:
        with torch.no_grad(), int8_scope():
            z = torch.randn(BATCH, *bundle.model_shape, device=dev)
            bundle.unet(z, torch.full((BATCH,), 0.5, device=dev), cond)
            bundle.autoencoder.decode(z)
    finally:
        layers_mod.quant_conv = real
    exact = 0
    for x, w, _, stride, padding in seen.values():
        dims = w.ndim - 2
        wq, _ = quantize_symmetric(w, tuple(range(1, dims + 2)))
        xf = x.float()
        xq = torch.clamp(torch.round(xf / (xf.abs().amax().clamp(min=1e-8) / 127.0)), -127,
                         127).to(torch.int8)
        got, want = int_conv_mm(xq, wq, stride, padding), int_conv_plain(xq, wq, stride, padding)
        if not torch.equal(got, want):
            fail(f"4q: int8 sums of x {tuple(x.shape)} w {tuple(w.shape)} stride {stride} differ "
                 f"from the plain version by {(got - want).abs().max().item()}")
        exact += 1
    log(f"[4q] the int32 sums of all {exact} convolution shapes of one UNet eval and one decode "
        f"(batch {BATCH}) bit-identical to the float64 convolution of the codes on the card")

    # one quantized convolution's device ms beside cuDNN's bf16 convolution
    rows = []
    for label, size in (("ds 1", 32), ("ds 4", 8), ("decoder 128 x 128", 128)):
        x, w, b, stride, padding = next(v for (shape, *_), v in seen.items()
                                        if shape[2] == size and v[1].shape[-1] == 3
                                        and v[3] == (1, 1) and shape[1] == v[1].shape[0])
        xb, wb, bb = x.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16)
        xb = xb.contiguous(memory_format=torch.channels_last)
        wb = wb.contiguous(memory_format=torch.channels_last)
        q_ms = device_ms(lambda: quant_conv(x, w, b, stride, padding))
        mm_ms = device_ms(lambda: int_conv_mm(x.to(torch.int8), w.to(torch.int8), stride,
                                              padding))
        conv_ms = device_ms(lambda: F.conv2d(xb, wb, bb, stride, padding))
        flops = 2 * x.shape[0] * w.numel() * x.shape[2] * x.shape[3]
        rows.append(dict(at=label, x=list(x.shape), x_dtype=str(x.dtype)[6:], w=list(w.shape),
                         quant_conv_ms=q_ms, im2col_int_mm_ms=mm_ms, cudnn_bf16_ms=conv_ms,
                         int8_bound_ms=1e3 * flops / 1979e12, bf16_bound_ms=1e3 * flops / 989e12))
    log(f"[4q] one convolution, device ms (quant_conv = quantize, im2col, torch._int_mm, "
        f"dequantize; the bounds are the operations over the dense int8 and bf16 peaks): "
        f"{json.dumps(rows)} ({card})")
    return launches


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
    from tqdne_tpu_torch.ops.conv_bias import conv_bias_add, conv_bias_add_plain
    from tqdne_tpu_torch.ops.group_norm import group_norm_silu, group_norm_silu_plain
    from tqdne_tpu_torch.train.state import (
        TrainState,
        apply_updates,
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
    phase("1. build")
    t0 = time.perf_counter()
    cuda_build.build()
    log(f"[build] {len(cuda_build.SOURCES)} sources built in {time.perf_counter() - t0:.2f} s")
    for name in cuda_build.SOURCES:
        for line in (cuda_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # ---- the main path's kernel shapes, read off one forward ------------------
    phase("the paths' shapes")
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
    unet_cv, dec_cv = [], []  # the convolutions' (output, channels innermost, shifted)
    hooks = [m.register_forward_pre_hook(gn_hook) for m in unet.modules() if isinstance(m, Norm32)]
    hooks += [m.register_forward_pre_hook(fa_hook) for m in unet.modules()
              if isinstance(m, AttentionBlock)]
    hooks += conv_hooks(unet, unet_cv)
    with torch.no_grad():
        x = torch.randn(BATCH, *main_bundle.model_shape, generator=gen, device=dev)
        unet(x, torch.zeros(BATCH, device=dev), cond)
        unet_gn, unet_fa = list(gn_calls), list(fa_calls)
        gn_calls.clear()
        hooks += [m.register_forward_pre_hook(gn_hook) for m in ae.decoder.modules()
                  if isinstance(m, Norm32)]
        hooks += conv_hooks(ae.decoder, dec_cv)
        ae.decode(x.float())
        dec_gn = list(gn_calls)
    for h in hooks:
        h.remove()
    # the training path's: the bf16 train step's UNet and frozen encoder (no update here)
    config, state, (train_step, eval_step), ae_t, model_shape, schedule = training_setup(
        dev, torch.bfloat16)
    train_gn, enc_gn, train_cv, enc_cv = [], [], [], []
    hooks = [m.register_forward_pre_hook(gn_recorder(train_gn)) for m in state.model.modules()
             if isinstance(m, Norm32)]
    hooks += [m.register_forward_pre_hook(gn_recorder(enc_gn)) for m in ae_t.encoder.modules()
              if isinstance(m, Norm32)]
    hooks += conv_hooks(state.model, train_cv) + conv_hooks(ae_t.encoder, enc_cv)
    with torch.no_grad():
        edm_step_loss(state.model, {"signal": torch.zeros(2, 128, 128, 3, device=dev),
                                    "cond": torch.zeros(2, 5, device=dev)}, autoencoder=ae_t)
    for h in hooks:
        h.remove()
    # the sampling-eval callback's: the EMA flagship UNet (f32 weights, bf16 compute) and the
    # frozen autoencoder's decoder, at the validation batch
    x2 = torch.randn(2, *model_shape, generator=gen, device=dev)
    cb_gn, cb_fa, cb_cv = record_calls([state.ema], lambda: state.ema(
        x2, torch.zeros(2, device=dev), cond[:2]))
    cb_dec, _, cb_dec_cv = record_calls([ae_t.decoder], lambda: ae_t.decode(x2.float()))
    # the evaluation path's: the full-width bf16 classifier (seeded random weights)
    classifier = load_classifier(dtype=torch.bfloat16, device=dev, init_seed=CLASSIFIER_SEED)
    clf_gn, clf_fa, clf_cv = [], [], []
    hooks = [m.register_forward_pre_hook(gn_recorder(clf_gn)) for m in classifier.modules()
             if isinstance(m, Norm32)]
    hooks += conv_hooks(classifier, clf_cv)
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
    conv_counts = {name: (len(cv), sum(c[-1] for c in cv)) for name, cv in (
        ("UNet eval", unet_cv), ("decode", dec_cv), ("train UNet", train_cv),
        ("train encoder", enc_cv), ("classifier", clf_cv), ("callback UNet eval", cb_cv),
        ("callback decode", cb_dec_cv))}
    log(f"[shapes] convolutions (calls, of them with the embedding shift): "
        f"{json.dumps(conv_counts)}; UNet eval outputs (C, *spatial) "
        f"{sorted(set(c[0] for c in unet_cv))}, decode {sorted(set(c[0] for c in dec_cv))}")
    if (conv_counts["UNet eval"] != (78, 22) or conv_counts["decode"] != (18, 0)
            or conv_counts["train UNet"] != (78, 22) or conv_counts["callback UNet eval"]
            != (78, 22) or conv_counts["callback decode"] != (18, 0)):
        fail(f"expected 78 convolutions (22 with a shift) per UNet eval and 18 (none) per "
             f"decode, got {conv_counts}")
    log(f"[shapes] sampling-eval callback at batch {CB_BATCH}: EMA UNet eval {len(cb_gn)} "
        f"GroupNorm calls, {len(cb_fa)} attention calls {sorted(set(cb_fa), key=str)}; decode "
        f"{len(cb_dec)} GroupNorm calls (S, C): "
        f"{sorted(collections.Counter((s, c) for *_, s, c, _, _ in cb_dec).items())}, dtype "
        f"pairs {sorted({(str(x)[6:], str(p)[6:]) for x, p, *_ in cb_gn + cb_dec})}")
    if (len(cb_gn), len(cb_fa), len(cb_dec)) != (len(unet_gn), len(unet_fa), len(dec_gn)):
        fail("the callback's UNet eval and decode differ from the sampling path's in count")
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
    ae_gn, clf_train_gn, clf_train_fa, ae_cv, clf_train_cv = [], [], [], [], []
    hooks = []
    for module in (ae_train, clf_train):
        module.to(dev, memory_format=torch.channels_last).train()
        sink = ae_gn if module is ae_train else clf_train_gn
        hooks += [m.register_forward_pre_hook(gn_recorder(sink)) for m in module.modules()
                  if isinstance(m, Norm32)]
        hooks += conv_hooks(module, ae_cv if module is ae_train else clf_train_cv)
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

    # the EDM recipes beyond the flagship: each sampler's UNet eval (and decode) at batch 32,
    # and one bf16 forward of each recipe's train step in train mode
    new_bundles, sampler_calls, sampler_convs = {}, {}, {}
    for key in SAMPLERS:
        gl = {"gl_iters": 32} if key == "edm" else {}
        b = build_inference(key, dtype=torch.bfloat16, num_steps=25, solver="heun", device=dev,
                            init_seed=SEED, **gl)
        dpmpp = copy.copy(b)  # the same models, sampled by the deployment solver
        dpmpp.num_steps, dpmpp.solver = 10, "dpmpp_2m"
        new_bundles[key] = {"heun-25": b, "dpmpp_2m-10": dpmpp}
        x = torch.randn(BATCH, *b.model_shape, generator=gen, device=dev)
        u_gn, u_fa, u_cv = record_calls([b.unet], lambda: b.unet(
            x, torch.zeros(BATCH, device=dev), cond))
        d_gn, _, d_cv = ([], [], []) if b.autoencoder is None else record_calls(
            [b.autoencoder.decoder], lambda: b.autoencoder.decode(x.float()))
        sampler_calls[key] = (u_gn, u_fa, d_gn)
        sampler_convs[key] = (u_cv, d_cv)
        log(f"[shapes] {key} sampling, batch {BATCH}: UNet eval {len(u_gn)} GroupNorm calls "
            f"(S, C): {sorted(collections.Counter((s, c) for *_, s, c, _, _ in u_gn).items())}; "
            f"{len(u_fa)} attention calls {sorted(set(u_fa), key=str)}; decode {len(d_gn)} "
            f"GroupNorm calls")
    recipe_models, step_calls, step_convs = {}, {}, {}
    for key in RECIPE_BATCH:
        model, frozen, steps, sig, mshape = recipe_setup(key, dev, torch.bfloat16,
                                                         init_like_flax_)
        recipe_models[key] = (model.train(), frozen, steps)
        rb, rd = recipe_batch(key, 2, sig, mshape, gen, dev)
        gn, fa, cv = record_calls([model], lambda: recipe_loss(key, model, frozen, rb, rd))
        enc, _, enc_cv_ = ([], [], []) if frozen is None else record_calls(
            [frozen.encoder], lambda: frozen.moments(rb["signal"]))
        step_calls[key] = (gn, fa, enc)
        step_convs[key] = (cv, enc_cv_)
        log(f"[shapes] {key} train step at batch {RECIPE_BATCH[key]}: signal {sig}, model "
            f"{mshape}; {len(gn)} GroupNorm calls (S, C): "
            f"{sorted(collections.Counter((s, c) for *_, s, c, _, _ in gn).items())}, frozen "
            f"encoder {len(enc)}; {len(fa)} attention calls {sorted(set(fa), key=str)}")
    if any(not fa for key, (_, fa, _) in sampler_calls.items()):
        fail("a sampler's UNet made no attention call")
    u1_cv = sampler_convs["1d_edm"][0]
    if (len(u1_cv), sum(c[-1] for c in u1_cv)) != (78, 22):
        fail(f"expected 78 convolutions (22 with a shift) per 1d_edm UNet eval, got "
             f"{len(u1_cv)}")

    # the few-eval and DDPM recipes: each sampler's UNet eval (and decode) at batch 32, and
    # one bf16 forward of each recipe's train step in train mode
    from tqdne_tpu_torch.cli.common import RECIPES

    few_bundles, few_calls, few_convs = {}, {}, {}
    for key in NEW_RECIPES:
        gl = {"gl_iters": 32} if RECIPES[key].latent else {}
        b = build_inference(key, dtype=torch.bfloat16, num_steps=FEW_NFE[0], device=dev,
                            init_seed=SEED, **gl)
        for nfe in FEW_NFE if key != "ddpm" else (None,):
            bn = copy.copy(b)  # the same models at another number of evals
            if nfe is not None:
                bn.num_steps = nfe
            few_bundles[(key, nfe)] = bn
        x = torch.randn(BATCH, *b.model_shape, generator=gen, device=dev)
        u_gn, u_fa, u_cv = record_calls([b.unet], lambda: b.unet(
            x, torch.ones(BATCH, device=dev), cond))
        d_gn, _, d_cv = ([], [], []) if b.autoencoder is None else record_calls(
            [b.autoencoder.decoder], lambda: b.autoencoder.decode(x.float()))
        few_calls[key] = (u_gn, u_fa, d_gn)
        few_convs[key] = (u_cv, d_cv)
        log(f"[shapes] {key} sampling, batch {BATCH}: UNet eval {len(u_gn)} GroupNorm calls, "
            f"{len(u_fa)} attention calls {sorted(set(u_fa), key=str)}; decode {len(d_gn)} "
            f"GroupNorm calls")
    new_models, new_calls, new_convs = {}, {}, {}
    for key in NEW_RECIPES:
        model, frozen, teacher, steps, sig, mshape = new_recipe_setup(key, dev, torch.bfloat16,
                                                                      init_like_flax_)
        new_models[key] = (model.train(), frozen, teacher, steps, sig, mshape)
        rb, rd = new_batch(key, 2, sig, mshape, gen, dev)
        x = torch.randn(2, *mshape, generator=gen, device=dev)
        u_gn, u_fa, u_cv = record_calls([model], lambda: model(x, torch.ones(2, device=dev),
                                                               rb["cond"]))
        gn, fa, cv = record_calls([model] + ([teacher] if teacher is not None else []),
                                  lambda: new_loss(key, model, frozen, teacher, rb, rd))
        enc, _, enc_cv_ = ([], [], []) if frozen is None else record_calls(
            [frozen.encoder], lambda: frozen.moments(rb["signal"]))
        new_calls[key] = (gn, fa, enc, u_gn, u_fa)
        new_convs[key] = (cv, enc_cv_)
        log(f"[shapes] {key} train step at batch {NEW_BATCH}: signal {sig}, model {mshape}; "
            f"{len(gn)} GroupNorm and {len(fa)} attention calls over {NEW_FORWARDS[key]} UNet "
            f"forwards of {len(u_gn)} and {len(u_fa)} {sorted(set(u_fa), key=str)}; frozen "
            f"encoder {len(enc)}")
        if ((len(gn), len(fa), len(cv))
                != (NEW_FORWARDS[key] * len(u_gn), NEW_FORWARDS[key] * len(u_fa),
                    NEW_FORWARDS[key] * len(u_cv))):
            fail(f"{key}: a train step's forwards are not {NEW_FORWARDS[key]} UNet evals")

    # the UNet's options and paired data (4n): the options flagship and its resample-free
    # autoencoder, the paired flagship UNet and the paired 1D UNets, one forward each
    s4n = setup_4n(dev, gen)

    # ---- 2. kernels against their plain versions ------------------------------
    phase("2. kernels against their plain versions")
    errs = {}
    gn_held = set()  # the (batch, x dtype, scale dtype, S, C, G) held so far

    def gn_checks(calls, batches, forced=False):
        fresh = [c for c in calls if any((b_, *c[:5]) not in gn_held for b_ in batches)]
        gn_held.update((b_, *c[:5]) for c in calls for b_ in batches)
        return check_group_norm_kernels(gen, dev, errs, fresh, batches=batches,
                                        forced=forced) if fresh or forced else 0

    bad = gn_checks(unet_gn + dec_gn + train_gn + enc_gn + clf_gn + ae_gn + clf_train_gn,
                    (BATCH, CLF_TRAIN_BATCH, TRAIN_BATCH), forced=True)
    bad += gn_checks([c for key in SAMPLERS for c in sampler_calls[key][0] +
                      sampler_calls[key][2]], (BATCH,))
    for batch_size in sorted(set(RECIPE_BATCH.values())):
        bad += gn_checks([c for key, b_ in RECIPE_BATCH.items() if b_ == batch_size
                          for c in step_calls[key][0] + step_calls[key][2]], (batch_size,))
    # the few-eval and DDPM recipes': the (shape, batch) pairs not held above
    bad += gn_checks([c for key in NEW_RECIPES for c in few_calls[key][0] + few_calls[key][2]],
                     (BATCH,))
    bad += gn_checks([c for key in NEW_RECIPES for c in new_calls[key][0] + new_calls[key][2]],
                     (NEW_BATCH,))
    # the sampling-eval callback's: the EMA UNet and the decoder at the validation batch
    bad += gn_checks(cb_gn + cb_dec, (CB_BATCH,))
    # 4n's: the options flagship's (GroupNorm without SiLU at every scale-shift out_norm) and
    # its autoencoder's at the training and sampling batches, the paired 1D UNet's at 64 and 32
    bad += gn_checks(s4n.opt_gn + s4n.opt_enc_gn + s4n.opt_dec_gn + s4n.p_gn,
                     (TRAIN_BATCH, BATCH))
    bad += gn_checks(s4n.u1_gn, (PAIRED_1D_BATCH, BATCH))
    # the backward kernel at the training steps' shapes: the flagship UNet's at 128 and each
    # recipe's trained module's at its batch (the 1D UNet's at 256), in every dtype pair
    bad += check_group_norm_backward(
        gen, dev, errs, [(TRAIN_BATCH, s_, c_, g_) for _, _, s_, c_, g_, _ in train_gn] +
        [(RECIPE_BATCH[key], s_, c_, g_) for key in RECIPE_BATCH
         for _, _, s_, c_, g_, _ in step_calls[key][0]])
    path_fa = [(CLF_TRAIN_BATCH, length, h, d) for _, length, h, d, _ in clf_train_fa]
    path_fa += [(BATCH, length, h, d) for key in SAMPLERS
                for _, length, h, d, _ in sampler_calls[key][1]]
    path_fa += [(RECIPE_BATCH[key], length, h, d) for key in RECIPE_BATCH
                for _, length, h, d, _ in step_calls[key][1]]
    path_fa += [(BATCH, length, h, d) for key in NEW_RECIPES
                for _, length, h, d, _ in few_calls[key][1]]
    path_fa += [(NEW_BATCH, length, h, d) for key in NEW_RECIPES
                for _, length, h, d, _ in new_calls[key][1]]
    path_fa += [(CB_BATCH, length, h, d) for _, length, h, d, _ in cb_fa]
    path_fa += [(b_, length, h, d) for _, length, h, d, _ in s4n.opt_fa + s4n.p_fa
                for b_ in (TRAIN_BATCH, BATCH)]
    path_fa += [(b_, length, h, d) for _, length, h, d, _ in s4n.u1_fa
                for b_ in (PAIRED_1D_BATCH, BATCH)]
    bad += check_flash_kernels(gen, dev, errs, path_fa)
    # the bias epilogue at every convolution output of the benchmarked generation paths at
    # their batches: the flagship UNet and decoder at 1024, the 1d_edm UNet at 128 and 256
    bad += check_conv_bias_kernels(gen, dev, errs, sorted(
        {(1024, c[0]) for c in unet_cv + dec_cv}
        | {(b_, c[0]) for c in sampler_convs["1d_edm"][0] for b_ in (128, 256)}))
    torch.cuda.synchronize()
    if bad:
        fail(f"{bad} kernel checks disagree with the plain versions")

    # ---- 3. full-width f32 slice: kernels vs plain versions -------------------
    phase("3. full-width f32 checks")
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
    # the EDM recipes beyond the flagship: a full-width f32 sample of 1d_edm and edm (2 Heun
    # steps) and a full-width f32 train step of each recipe, kernels vs plain versions
    for key in ("1d_edm", "edm"):
        b32 = build_inference(key, dtype=torch.float32, num_steps=2, solver="heun", device=dev,
                              init_seed=SEED)
        noise = torch.randn(F32_BATCH, *b32.model_shape, generator=gen, device=dev)
        with torch.no_grad():
            with_kernels = b32.sample(cond[:F32_BATCH], noise=noise)
            with plain_versions():
                plain = b32.sample(cond[:F32_BATCH], noise=noise)
        peak, err = plain.abs().max().item(), (with_kernels - plain).abs().max().item()
        log(f"[{key}-f32] Heun-2 signals {tuple(plain.shape)}: kernels vs plain "
            f"max_abs_err={err:.3e} (peak {peak:.3e}, tol 1e-4 * peak)")
        if not (torch.isfinite(with_kernels).all() and err <= 1e-4 * peak):
            fail(f"the f32 {key} sample through the kernels disagrees with the plain versions")
        del b32
    for key in RECIPE_BATCH:
        m32, frozen32, _, sig, mshape = recipe_setup(key, dev, torch.float32, randomize_)
        rb, rd = recipe_batch(key, F32_BATCH, sig, mshape, gen, dev)
        n_fa = len(step_calls[key][1])
        check_step_vs_plain(f"{key}-f32-train", m32.eval(),
                            lambda: recipe_loss(key, m32, frozen32, rb, rd), (n_fa, n_fa), 40)
        del m32, frozen32
    # the few-eval and DDPM recipes: a full-width f32 sample of consistency and latent_distill
    # (2 network evals, the same draws both ways) and one full-width f32 train step of each
    # recipe, kernels vs plain versions
    for key in ("consistency", "latent_distill"):
        b32 = build_inference(key, dtype=torch.float32, num_steps=2, device=dev, init_seed=SEED)
        noise = torch.randn(F32_BATCH, *b32.model_shape, generator=gen, device=dev)
        outs = []
        for route in (contextlib.nullcontext, plain_versions):
            with torch.no_grad(), route():
                outs.append(b32.sample(cond[:F32_BATCH], noise=noise, generator=torch.Generator(
                    device=dev).manual_seed(SEED)))
        with_kernels, plain = outs
        peak, err = plain.abs().max().item(), (with_kernels - plain).abs().max().item()
        log(f"[{key}-f32] 2-eval samples {tuple(plain.shape)}: kernels vs plain "
            f"max_abs_err={err:.3e} (peak {peak:.3e}, tol 1e-4 * peak)")
        if not (torch.isfinite(with_kernels).all() and err <= 1e-4 * peak):
            fail(f"the f32 {key} sample through the kernels disagrees with the plain versions")
        del b32
    for key in NEW_RECIPES:
        m32, frozen32, teacher32, _, sig, mshape = new_recipe_setup(key, dev, torch.float32,
                                                                     randomize_)
        rb, rd = new_batch(key, F32_BATCH, sig, mshape, gen, dev)
        n_fa = len(new_calls[key][4])
        check_step_vs_plain(f"{key}-f32-train", m32.eval(),
                            lambda: new_loss(key, m32, frozen32, teacher32, rb, rd),
                            (n_fa, n_fa), 40)
        del m32, frozen32, teacher32
    # the shared dropout masks on the card: the consistency teacher's forward (no gradients)
    # draws the student's masks (bf16, train mode, dropout 0.1)
    model, frozen, teacher, _, sig, mshape = new_models["consistency"]
    rb, rd = new_batch("consistency", 2, sig, mshape, gen, dev)
    masks = []
    hooks = [m.register_forward_hook(lambda mod, args, out: masks.append(
        (out == 0) & (args[0] != 0))) for m in model.modules() if isinstance(m, torch.nn.Dropout)]
    new_loss("consistency", model.train(), frozen, teacher, rb, rd)
    for h in hooks:
        h.remove()
    k = len(hooks)
    same = len(masks) == 2 * k and all(torch.equal(a, b) for a, b in zip(masks[:k], masks[k:]))
    dropped = sum(m.sum().item() for m in masks[:k]) / max(sum(m.numel() for m in masks[:k]), 1)
    log(f"[dropout] consistency step, batch 2: {k} dropout layers, teacher and student masks "
        f"equal {same}, share dropped {dropped:.4f} (rate 0.1)")
    if not same or not 0.05 < dropped < 0.15:
        fail("the consistency teacher and student drew different dropout masks on the card")
    torch.cuda.empty_cache()

    # ---- 4. the main path ------------------------------------------------------
    phase("4. the main paths")
    bundles["dpmpp_2m-10"].generate(cond, generator=gen)  # warm-up: lazy CUDA init, cuDNN plans
    runs, counts = {}, {}
    for name, bundle in bundles.items():
        zero_launches()
        t0 = time.perf_counter()
        wave = bundle.generate(cond, generator=gen)
        torch.cuda.synchronize()
        runs[name] = [time.perf_counter() - t0]
        counts[name] = read_launches()
        if wave.shape != (BATCH, 3, 4064) or not torch.isfinite(wave).all():
            fail(f"{name}: waveforms {tuple(wave.shape)} finite={bool(torch.isfinite(wave).all())}")
        log(f"[main] {name}: waveforms {tuple(wave.shape)} finite, peak "
            f"{wave.abs().max().item():.3e}, launches {counts[name]}")
    launches = {k: sum(c[k] for c in counts.values()) for k in counts["heun-25"]}
    for name, evals in (("heun-25", 2 * 25 - 1), ("dpmpp_2m-10", 10)):
        want = want_launches(len(unet_gn) * evals + len(dec_gn), len(unet_fa) * evals,
                             convs=[(unet_cv, evals), (dec_cv, 1)])
        if counts[name] != want:
            fail(f"{name}: launches {counts[name]} != expected {want} ({evals} UNet evals)")
    if min(launches[k] for k in ("group_norm_silu", "flash_attention", "conv_bias_add",
                                 "conv_bias_add.shifted")) == 0:
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
        """The flagship step's launches: the UNet's, and the frozen encoder's GroupNorm and
        convolutions."""
        gn = len(unet_gn) + (len(enc_gn) if encoder else 0)
        return want_launches(gn * steps, len(unet_fa) * steps, len(unet_fa) * steps,
                             convs=[(train_cv, steps), (enc_cv, steps if encoder else 0)])

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
        want=want_launches(len(ae_gn) * AE_STEPS, convs=[(ae_cv, AE_STEPS)]),
        want_gn_bwd=len(ae_gn) * AE_STEPS,
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
                                                len(clf_train_fa) * CLF_STEPS,
                                                convs=[(clf_train_cv, forwards)]),
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
    group_norm_silu.backward_calls = group_norm_silu.backward_launches = 0
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
        f"launches {recipe_counts['guard']}, GroupNorm backward calls "
        f"{group_norm_silu.backward_calls}, kernel launches {group_norm_silu.backward_launches}")
    if (math.isfinite(bad_loss) or not held or after_bad != (count0, 1.0)
            or not math.isfinite(clean_loss) or moved < len(params) // 2
            or after_clean != (count0 + 1, 0.0) or state.step != step0 + 2):
        fail("the non-finite guard did not hold a NaN step and apply the clean one")
    if (recipe_counts["guard"] != flagship_want(2)
            or group_norm_silu.backward_calls != 2 * len(unet_gn)
            or group_norm_silu.backward_launches != 2 * len(unet_gn)):
        fail(f"guard launches {recipe_counts['guard']} != {flagship_want(2)}")
    for run_counts in recipe_counts.values():
        launches = {k: launches[k] + v for k, v in run_counts.items()}

    # ---- 4c. the serving path: the HTTP server over the dpmpp_2m-10 bundle -----
    per_serve_batch = (len(unet_gn) * 10 + len(dec_gn), len(unet_fa) * 10,
                       len(unet_cv) * 10 + len(dec_cv))
    path_counts = {"serve": serve_path(bundles["dpmpp_2m-10"], per_serve_batch)}

    # ---- 4d. the evaluation path: evaluate_batch + report_from_arrays ----------
    eval_bundle = build_inference(dtype=torch.bfloat16, num_steps=25, solver="heun", device=dev,
                                  init_seed=SEED)  # the evaluate CLI's defaults: GL 128
    per_eval_batch = (len(unet_gn) * 49 + len(dec_gn) + 2 * len(clf_gn),
                      len(unet_fa) * 49 + 2 * len(clf_fa),
                      len(unet_cv) * 49 + len(dec_cv) + 2 * len(clf_cv))
    path_counts["evaluate"] = evaluate_path(eval_bundle, classifier, per_eval_batch)
    del eval_bundle
    for which, name in enumerate(("group_norm_silu", "flash_attention", "conv_bias_add")):
        launches[name] += sum(c[which] for c in path_counts.values())

    # ---- 4j. the EDM recipes beyond the flagship: each sampler, then Trainer.fit of each
    # recipe at its batch ------------------------------------------------------------
    phase("4j. the EDM recipes beyond the flagship")
    new_counts, new_rates = {}, {}
    kernels_ = launch_counters()
    for key, runs_ in new_bundles.items():
        u_gn, u_fa, d_gn = sampler_calls[key]
        u_cv, d_cv = sampler_convs[key]
        runs_["dpmpp_2m-10"].generate(cond, generator=gen)  # warm-up: cuDNN plans at its shapes
        for name, bundle in runs_.items():
            evals = 2 * 25 - 1 if name == "heun-25" else 10
            torch.cuda.synchronize()
            for fn in kernels_:
                fn.launches = 0
            t0 = time.perf_counter()
            wave = bundle.generate(cond, generator=gen)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            got = {fn.__name__: fn.launches for fn in kernels_}
            want = want_launches(len(u_gn) * evals + len(d_gn), len(u_fa) * evals,
                                 convs=[(u_cv, evals), (d_cv, 1)])
            finite = bool(torch.isfinite(wave).all())
            new_counts[f"{key} {name}"] = got
            new_rates[f"{key} {name}"] = BATCH / sec
            log(f"[{key}] {name} + {'Griffin-Lim 32' if key == 'edm' else 'the envelope inverse'}"
                f", batch {BATCH}, bf16: waveforms {tuple(wave.shape)} finite {finite}, peak "
                f"{wave.abs().max().item():.3e}; {BATCH / sec:.2f} waveforms/s (one run, "
                f"{sec:.3f} s); launches {got}")
            if wave.shape != (BATCH, 3, 4064) or not finite:
                fail(f"{key} {name}: waveforms {tuple(wave.shape)} finite {finite}")
            if got != want:
                fail(f"{key} {name}: launches {got} != expected {want} ({evals} UNet evals)")
        profile_breakdown(lambda: runs_["dpmpp_2m-10"].generate(cond, generator=gen),
                          f"{key} dpmpp_2m-10, batch {BATCH} (10 UNet evals"
                          f"{' and one decode' if d_gn else ''}, then the inversion)")
    del new_bundles
    torch.cuda.empty_cache()
    recipe_runs = {}
    for key, (model, frozen, steps) in recipe_models.items():
        recipe = RECIPES[key]
        cfg = recipe.config_cls()
        edm_kind = recipe.kind == "edm"
        keys = ("signal", "cond") if edm_kind else ("signal",)
        ld = BatchLoader(ArrayDataset(arrays, cfg.make_representation(), cut=cfg.t,
                                      cond=edm_kind, split="full"),
                         RECIPE_BATCH[key], device=dev, keys=keys, seed=SEED)
        sched = cosine_annealing(1e-4, recipe.epochs * len(ld))  # the recipe's epochs
        st = TrainState(model, make_optimizer(recipe.optimizer, model, 1e-4,
                                              recipe.weight_decay), sched)
        gn, fa, enc = step_calls[key]
        cv, enc_cv_ = step_convs[key]
        timed, marks = tail_timed(steps[0], RECIPE_STEPS, RECIPE_STEPS // 2)
        new_counts[f"{key} train"], rows = counted_fit(
            f"{key}-train", (timed, steps[1]), st, ld, max_steps=RECIPE_STEPS,
            want=want_launches((len(gn) + len(enc)) * RECIPE_STEPS, len(fa) * RECIPE_STEPS,
                               len(fa) * RECIPE_STEPS,
                               convs=[(cv, RECIPE_STEPS), (enc_cv_, RECIPE_STEPS)]),
            want_gn_bwd=len(gn) * RECIPE_STEPS, lr_schedule=sched)
        new_rates[f"{key} train"] = tail_rate(
            f"{key} train step, batch {RECIPE_BATCH[key]}, bf16", marks, RECIPE_BATCH[key],
            RECIPE_STEPS // 2)
        recipe_runs[key] = (st, steps[0], next(iter(ld)))
    for run_counts in new_counts.values():
        launches = {k: launches[k] + v for k, v in run_counts.items()}

    # ---- 4k. the few-eval and DDPM recipes: each sampler (1 and 2 evals; DDPM's 1000 steps),
    # then Trainer.fit of each recipe at batch 256, then RAdam under the guard ---------------
    phase("4k. the few-eval and DDPM recipes")
    from tqdne_tpu_torch.diffusion import ddpm as ddpm_lib

    few_counts, few_rates, few_wall = {}, {}, {}
    for (key, nfe), bundle in few_bundles.items():
        u_gn, u_fa, d_gn = few_calls[key]
        u_cv, d_cv = few_convs[key]
        evals = nfe or bundle.ddpm_cfg.num_train_timesteps
        label = f"{key} {'ddpm-1000' if nfe is None else f'nfe-{nfe}'}"
        warm = copy.copy(bundle)  # warm-up at its shapes (cuDNN plans); DDPM's at 2 steps
        if nfe is None:
            warm.ddpm_cfg = ddpm_lib.DDPMConfig(num_train_timesteps=2)
        warm.generate(cond, generator=gen)
        torch.cuda.synchronize()
        for fn in kernels_:
            fn.launches = 0
        t0 = time.perf_counter()
        wave = bundle.generate(cond, generator=gen)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = {fn.__name__: fn.launches for fn in kernels_}
        want = want_launches(len(u_gn) * evals + len(d_gn), len(u_fa) * evals,
                             convs=[(u_cv, evals), (d_cv, 1)])
        finite = bool(torch.isfinite(wave).all())
        few_counts[label], few_rates[label], few_wall[label] = got, BATCH / sec, 1e3 * sec
        log(f"[{key}] {label.split()[1]} ({evals} UNet evals"
            f"{', one decode and Griffin-Lim 32' if d_gn else ', the envelope inverse'}), batch "
            f"{BATCH}, bf16: waveforms {tuple(wave.shape)} finite {finite}, peak "
            f"{wave.abs().max().item():.3e}; {BATCH / sec:.2f} waveforms/s (one run, {sec:.3f} "
            f"s); launches {got}")
        if wave.shape != (BATCH, 3, 4064) or not finite:
            fail(f"{label}: waveforms {tuple(wave.shape)} finite {finite}")
        if got != want:
            fail(f"{label}: launches {got} != expected {want} ({evals} UNet evals)")
    new_runs = {}
    for key, (model, frozen, teacher, steps, sig, mshape) in new_models.items():
        recipe = RECIPES[key]
        cfg = recipe.config_cls()
        ld = BatchLoader(ArrayDataset(arrays, cfg.make_representation(), cut=cfg.t, cond=True,
                                      split="full"),
                         NEW_BATCH, device=dev, keys=("signal", "cond"), seed=SEED)
        # RAdam at a constant rate, as the train CLI runs it; DDPM's AdamW under the cosine
        sched = None if recipe.optimizer == "radam" else cosine_annealing(
            1e-4, recipe.epochs * len(ld))
        st = TrainState(model, make_optimizer(recipe.optimizer, model, 1e-4,
                                              recipe.weight_decay), sched)
        gn, fa, enc, u_gn, u_fa = new_calls[key]
        cv, enc_cv_ = new_convs[key]
        timed, marks = tail_timed(steps[0], NEW_STEPS, NEW_STEPS // 2)
        few_counts[f"{key} train"], _ = counted_fit(
            f"{key}-train", (timed, steps[1]), st, ld, max_steps=NEW_STEPS,
            want=want_launches((len(gn) + len(enc)) * NEW_STEPS, len(fa) * NEW_STEPS,
                               len(u_fa) * NEW_STEPS,
                               convs=[(cv, NEW_STEPS), (enc_cv_, NEW_STEPS)]),
            want_gn_bwd=len(u_gn) * NEW_STEPS, lr_schedule=sched)
        few_rates[f"{key} train"] = tail_rate(f"{key} train step, batch {NEW_BATCH}, bf16",
                                              marks, NEW_BATCH, NEW_STEPS // 2)
        new_runs[key] = (st, steps[0], next(iter(ld)))
    # RAdam under the non-finite guard on the card: a NaN batch, then a clean one
    st, step, clean = new_runs["latent_consistency"]
    params = [p for p in st.model.parameters() if p.requires_grad]
    before = [p.detach().clone() for p in params]
    moments_before = st.optimizer.state[params[0]]["exp_avg"].clone()
    count0, step0 = int(applied_updates(st.optimizer)), st.step
    st.skip_nonfinite = GUARD_N
    for fn in kernels_:
        fn.launches = 0
    bad_loss = step(st, dict(clean, signal=torch.full_like(clean["signal"], float("nan"))),
                    generator=tgen)["loss"].item()
    held = (all(torch.equal(b, p) for b, p in zip(before, params))
            and torch.equal(moments_before, st.optimizer.state[params[0]]["exp_avg"]))
    after_bad = int(applied_updates(st.optimizer)), st.notfinite_count.item()
    clean_loss = step(st, clean, generator=tgen)["loss"].item()
    moved = sum(not torch.equal(b, p) for b, p in zip(before, params))
    after_clean = int(applied_updates(st.optimizer)), st.notfinite_count.item()
    st.skip_nonfinite = 0
    few_counts["latent_consistency guard"] = {fn.__name__: fn.launches for fn in kernels_}
    gn, fa, enc, u_gn, u_fa = new_calls["latent_consistency"]
    cv, enc_cv_ = new_convs["latent_consistency"]
    log(f"[radam-guard] latent_consistency, skip_nonfinite={GUARD_N}: a NaN batch gave loss "
        f"{bad_loss}, parameters and RAdam moments held {held}, (updates applied, consecutive "
        f"non-finite) {count0} -> {after_bad}; the next clean batch gave loss {clean_loss:.6e}, "
        f"moved {moved} of {len(params)} parameter tensors, {after_clean}; step {step0} -> "
        f"{st.step}; launches {few_counts['latent_consistency guard']}")
    if (math.isfinite(bad_loss) or not held or after_bad != (count0, 1.0)
            or not math.isfinite(clean_loss) or moved < len(params) // 2
            or after_clean != (count0 + 1, 0.0) or st.step != step0 + 2):
        fail("RAdam under the guard did not hold a NaN step and apply the clean one")
    if few_counts["latent_consistency guard"] != want_launches(
            2 * (len(gn) + len(enc)), 2 * len(fa), 2 * len(u_fa), convs=[(cv, 2), (enc_cv_, 2)]):
        fail(f"RAdam guard launches {few_counts['latent_consistency guard']}")
    # and a NaN at the very first update (count 0, where the bias corrections have no value)
    lin = torch.nn.Linear(8, 8).to(dev)
    first = TrainState(lin, make_optimizer("radam", lin, 1e-4), skip_nonfinite=GUARD_N)
    w0 = lin.weight.detach().clone()
    for p in lin.parameters():
        p.grad = torch.full_like(p, float("nan"))
    apply_updates(first, 0.999)
    held0 = torch.equal(lin.weight, w0) and int(applied_updates(first.optimizer)) == 0
    log(f"[radam-guard] a NaN gradient at the first update: parameters and count held {held0}")
    if not held0:
        fail("RAdam under the guard moved the parameters on a rejected first step")
    for run_counts in few_counts.values():
        launches = {k: launches[k] + v for k, v in run_counts.items()}

    # ---- 4l. the sampling-eval callback and the seismological evaluation ------------
    phase("4l. the sampling-eval callback and the seismological evaluation")
    cb_counts = sampling_eval_path(
        state=state, steps=(train_step, eval_step), loader=loader, ae=ae_t,
        model_shape=model_shape, config=config, schedule=schedule, arrays=arrays,
        flagship_want=flagship_want, per_eval=(len(unet_gn), len(unet_fa)),
        per_decode=len(dec_gn), convs=(cb_cv, cb_dec_cv),
        few_runs={key: (new_runs[key][0], new_models[key][5],
                        (len(few_calls[key][0]), len(few_calls[key][1]), few_convs[key][0]))
                  for key in ("consistency", "ddpm")})
    for run, run_counts in cb_counts.items():
        if run != "callback flagship pass":  # within the fit's count
            launches = {k: launches[k] + v for k, v in run_counts.items()}
    torch.cuda.empty_cache()

    # ---- 4m. reference checkpoints and the data scans ------------------------------------
    phase("4m. reference checkpoints and the data scans")
    ckpt_counts = reference_checkpoints_path(
        dev, want_launches(len(unet_gn) * 10 + len(dec_gn), len(unet_fa) * 10,
                           convs=[(unet_cv, 10), (dec_cv, 1)]),
        want_launches(len(clf_gn), len(clf_fa), convs=[(clf_cv, 1)]))
    for run_counts in ckpt_counts.values():
        launches = {k: launches[k] + v for k, v in run_counts.items()}
    data_scans(dev)
    torch.cuda.empty_cache()

    # ---- 4n. the UNet's options and paired (cond_signal) data --------------------------------
    phase("4n. the UNet's options and paired (cond_signal) data")
    opt_counts = options_and_paired_path(dev, s4n, arrays, ae_t, enc_gn, dec_gn, enc_cv, dec_cv)
    for run_counts in opt_counts.values():
        launches = {k: launches[k] + v for k, v in run_counts.items()}
    torch.cuda.empty_cache()

    # ---- 4o. data parallelism ----------------------------------------------------------------
    phase("4o. data parallelism")
    dp_counts = data_parallel_path(train_counts, len(unet_gn) * TRAIN_STEPS, flagship_want(1),
                                   TRAIN_BATCH * TRAIN_STEPS / metric_rows[-1]["traintime"])
    launches = {k: launches[k] + v for k, v in dp_counts["4o world1"].items()}

    # ---- 4p. spatial partitioning ------------------------------------------------------------
    phase("4p. spatial partitioning")
    sp = spatial_path((len(unet_gn), len(unet_fa)), len(dec_gn), (unet_cv, dec_cv), dev, errs)
    for run_counts in sp["launches"].values():
        launches = {k: launches[k] + run_counts[k] for k in launches}
    entry_launches = {name: sum(c[name] for c in sp["launches"].values())
                      for name in ("group_norm_stats", "group_norm_apply")}
    torch.cuda.empty_cache()

    # ---- 4q. the int8 mode -------------------------------------------------------------------
    phase("4q. the int8 mode")
    int8_counts = int8_path(dev, (len(unet_gn), len(unet_fa)), len(dec_gn), (unet_cv, dec_cv))
    for run_counts in int8_counts.values():
        launches = {k: launches[k] + run_counts[k] for k in launches}
    torch.cuda.empty_cache()

    # ---- 5. timings --------------------------------------------------------------
    phase("5. timings")
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

    def timed(kernel, plain, library):
        """Device ms of each, plus the kernel's per-call time when issued back
        to back (CUDA events), which the host's overhead sets at small shapes,
        and the kernels the library call ran."""
        issue, issue_min = issue_ms(kernel)
        return dict(ms=device_ms(kernel), plain_ms=device_ms(plain), library_ms=device_ms(library),
                    issue_ms=issue, issue_min_ms=issue_min)

    def summed(rows, key):  # the kernel's work in one UNet eval (plus one decode) or step
        return sum((1 if key == "one" else r[key]) * r["calls"] for r in rows)

    timed_rows = {}  # a (kernel, shape, dtype, batch) timed once a run; each row adds its calls

    def once(fn):
        def row(*args, calls, batch=BATCH):
            key = (fn.__name__, *args, batch)
            if key not in timed_rows:
                timed_rows[key] = fn(*args, batch=batch)
            got = timed_rows[key]
            if fn.__name__ == "bwd_timing":  # a row for each backward kernel
                return {k: dict(v, calls=calls) for k, v in got.items()}
            return dict(got, calls=calls)
        return row

    def gn_timing(dtype, pdtype, s, c, g, silu, batch=BATCH):
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
            scale_dtype=str(pdtype)[6:],
            **timed(lambda: group_norm_silu(x, w, b, g, 1e-5, silu),
                    lambda: group_norm_silu_plain(x, w, b, g, 1e-5, silu), lib),
            **bound(nbytes, GN_OPS_PER_ELEM[silu] * x.numel(), torch.float32))

    def fa_timing(dtype, length, h, d, causal, batch=BATCH):
        q, k, v = (torch.randn(batch, length, h, d, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        qs, ks, vs = (t.transpose(1, 2) for t in (q * d**-0.25, k * d**-0.25, v))
        pairs = length * (length + 1) / 2 if causal else length * length
        return dict(
            shape=[batch, length, h, d], causal=causal, dtype=str(dtype)[6:],
            **timed(lambda: flash_attention(q, k, v, causal),
                    lambda: flash_attention_plain(q, k, v, causal),
                    lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                           scale=1.0)),
            **bound(4 * q.numel() * q.element_size(), 4 * batch * h * pairs * d, dtype))

    def bias_timing(shape, channels_last, shifted, batch=BATCH):
        y, bias, shift = conv_output(batch, shape, torch.bfloat16, channels_last, gen, dev)
        shift = shift if shifted else None
        tail = (1,) * (len(shape) - 1)

        def library():  # what the epilogue replaced: ATen's add_ of the bias, then h + emb_out
            out = y.add_(bias.view(-1, *tail))
            return out if shift is None else out + shift.view(*shift.shape, *tail)

        nbytes = 2 * y.numel() * y.element_size() + bias.numel() * bias.element_size() + (
            0 if shift is None else shift.numel() * shift.element_size())
        return dict(
            shape=[batch, *shape], channels_last=channels_last, shifted=shifted,
            dtype="bfloat16",
            **timed(lambda: conv_bias_add(y, bias, shift),
                    lambda: conv_bias_add_plain(y, bias, shift), library),
            **bound(nbytes, (1 + shifted) * y.numel(), torch.float32))

    gn_row, fa_row, bias_row = once(gn_timing), once(fa_timing), once(bias_timing)
    gn_rows = [gn_row(*key, calls=unet_gn.count(key)) for key in dict.fromkeys(unet_gn)]
    gn_rows += [gn_row(*key, calls=dec_gn.count(key)) for key in dict.fromkeys(dec_gn)]
    step_gn = train_gn + enc_gn  # one bf16 train step's GroupNorm calls, at batch 128
    gn_train_rows = [gn_row(*key, calls=step_gn.count(key), batch=TRAIN_BATCH)
                     for key in dict.fromkeys(step_gn)]
    fa_rows = [fa_row(*key, calls=unet_fa.count(key)) for key in dict.fromkeys(unet_fa)]
    # the bias epilogue over one UNet eval and one decode, and over one 1d_edm UNet eval
    bias_rows = [bias_row(*key, calls=(unet_cv + dec_cv).count(key))
                 for key in dict.fromkeys(unet_cv + dec_cv)]
    u1_cv = sampler_convs["1d_edm"][0]
    bias_1d_rows = [bias_row(*key, calls=u1_cv.count(key)) for key in dict.fromkeys(u1_cv)]
    # the classifier's, one forward at batch 32: the new (32, 256, 256) GroupNorm with
    # SiLU on and off, and the forward at 256 tokens
    clf_gn_rows = [gn_row(*key, calls=clf_gn.count(key)) for key in dict.fromkeys(clf_gn)]
    clf_fa_rows = [fa_row(*key, calls=clf_fa.count(key)) for key in dict.fromkeys(clf_fa)]
    for row in gn_rows + gn_train_rows + fa_rows + clf_gn_rows + clf_fa_rows + bias_rows + \
            bias_1d_rows:
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
    log(f"[time] {json.dumps(fa_row(torch.bfloat16, 16, 4, 128, False, calls=0,
                                    batch=TRAIN_BATCH))}")
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

    # the guard's cost against the flagship step in alternated single steps, also profiled;
    # then the recipes' steps, one window each
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
    for label, step, st, name, n in (
            ("autoencoder recipe step (AdamW, no EMA), batch 128, bf16", ae_steps[0], ae_state,
             "ae", TRAIN_BATCH),
            ("classifier recipe step (Adam, no EMA), batch 64, bf16", clf_train_step, clf_state,
             "classifier", CLF_TRAIN_BATCH),
            ("flagship step from cached latents (no encoder), batch 128, bf16",
             cached_steps[0], state, "cached", TRAIN_BATCH),
            ("flagship step with the representation on the device, batch 128, bf16",
             rep_steps[0], state, "waveform", TRAIN_BATCH)):
        rate_of(label, lambda: step(st, recipe_batches[name], generator=tgen), n)

    def bwd_timing(dtype, length, h, d, causal, batch=TRAIN_BATCH):
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
        common = dict(shape=[batch, length, h, d], causal=causal, dtype=str(dtype)[6:])
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

    bwd_rows = once(bwd_timing)
    bwd = [bwd_rows(*key, calls=unet_fa.count(key), batch=TRAIN_BATCH)
           for key in dict.fromkeys(unet_fa)]
    for row in bwd:
        for r in row.values():
            log(f"[time] {json.dumps(r)}")
    for row in bwd:
        dq_row, dkdv_row = row["flash_attention_bwd_dq"], row["flash_attention_bwd_dkdv"]
        log(f"[time] flash backward {dq_row['shape']}: dQ + dK/dV "
            f"{1e3 * (dq_row['ms'] + dkdv_row['ms']):.2f} us against SDPA's whole backward "
            f"{1e3 * dq_row['library_ms']:.2f} us; the plain attention_delta alone "
            f"{1e3 * dq_row['attention_delta_ms']:.2f} us")
    # the GroupNorm backward per call, summed over one train step's UNet: the flagship's at
    # 128 (its gradients arrive contiguous: ms) and the 1D UNet's at 256 (channels first, as
    # transposed views: transposed_ms, the wrapper's copy included); the library's in each
    # UNet's own layout
    gn_bwd_sums = {}
    for label, calls, batch_size, channels_first in (
            (f"one flagship train step's UNet, batch {TRAIN_BATCH}", train_gn, TRAIN_BATCH,
             False),
            (f"one 1d_edm train step's UNet, batch {RECIPE_BATCH['1d_edm']}",
             step_calls["1d_edm"][0], RECIPE_BATCH["1d_edm"], True)):
        rows = []
        for key in dict.fromkeys(calls):
            rows.append(gn_backward_timing(gen, dev, *key, batch=batch_size,
                                           channels_first=channels_first)
                        | {"calls": calls.count(key)})
            log(f"[time] {json.dumps(rows[-1])}")
        gn_bwd_sums[label] = {k: summed(rows, k) for k in ("ms", "transposed_ms", "plain_ms",
                                                            "library_ms", "bound_ms")} | {
            "calls": summed(rows, "one"), "bound_by": "bytes"}
        log(f"[time] group_norm_silu_backward over {label}: {json.dumps(gn_bwd_sums[label])}")
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

    # the EDM recipes beyond the flagship: a profiled step, the 1D layout copies, and each
    # kernel per call at the new path shapes
    phase("5b. the EDM recipes' timings")
    for key, (st, step, rb) in recipe_runs.items():
        train_profile(lambda: step(st, rb, generator=tgen),
                      f"one {key} train step, batch {RECIPE_BATCH[key]}, bf16")
    layout = {"forward_ms": 0.0, "calls": 0}
    for key in ("1d_edm",):  # each 1D Norm32: (B, C, L) -> (B, L, C) in, and back for the conv
        gn = step_calls[key][0]
        for k in dict.fromkeys(gn):
            xt = torch.randn(RECIPE_BATCH[key], k[3], k[2], generator=gen, device=dev).to(k[0])
            back = xt.movedim(1, -1).contiguous().movedim(-1, 1)
            ms = device_ms(lambda: xt.movedim(1, -1).contiguous()) + device_ms(
                lambda: back.contiguous())
            layout["forward_ms"] += ms * gn.count(k)
            layout["calls"] += gn.count(k)
    log(f"[layout] 1d_edm train step, batch 256, bf16: the 1D Norm32 transposes (in, and back "
        f"to the convolution's layout) cost {layout['forward_ms']:.3f} device ms over "
        f"{layout['calls']} calls of the forward (the backward's copies: the profiled step's "
        f"[train-profile] line, by autograd node)")
    new_rows = {}
    for key in RECIPE_BATCH:
        gn, fa, enc = step_calls[key]
        bsz, calls = RECIPE_BATCH[key], gn + enc
        rows = {"group_norm_silu": [gn_row(*k, calls=calls.count(k), batch=bsz)
                                    for k in dict.fromkeys(calls)]}
        if fa:
            rows["flash_attention"] = [fa_row(*fa[0], calls=len(fa), batch=bsz)]
            rows |= {n: [r] for n, r in bwd_rows(*fa[0], calls=len(fa), batch=bsz).items()}
        new_rows[f"one {key} train step, batch {bsz}, bf16"] = rows
    for key in SAMPLERS:
        u_gn, u_fa, d_gn = sampler_calls[key]
        calls = u_gn + d_gn
        new_rows[f"one {key} UNet eval{' and one decode' if d_gn else ''}, batch {BATCH}, "
                 f"bf16"] = {
            "group_norm_silu": [gn_row(*k, calls=calls.count(k)) for k in dict.fromkeys(calls)],
            "flash_attention": [fa_row(*u_fa[0], calls=len(u_fa))]}
    new_sums = collections.defaultdict(dict)
    for label, rows in new_rows.items():
        for name, rs in rows.items():
            for r in rs:
                log(f"[time] {label}: {json.dumps(r)}")
            new_sums[name][label] = {k: summed(rs, k) for k in (
                "ms", "bound_ms", "plain_ms", "library_ms", "issue_ms")} | {
                "calls": summed(rs, "one"),
                "bound_by": "bytes" if summed(rs, "bytes_ms") >= summed(rs, "ops_ms")
                else "operations"}
            log(f"[time] {name} over {label}: {json.dumps(new_sums[name][label])}")
    log(f"[recipe-rates] {json.dumps(new_rates)}")

    # the few-eval and DDPM recipes: a profiled step of each, the samplers' device ms, and
    # each kernel per call at the new paths' shapes
    phase("5c. the few-eval and DDPM recipes' timings")
    for key, (st, step, rb) in new_runs.items():
        train_profile(lambda: step(st, rb, generator=tgen),
                      f"one {key} train step, batch {NEW_BATCH}, bf16")
    for (key, nfe), bundle in few_bundles.items():
        if nfe is not None:
            then = " and one decode, then Griffin-Lim 32" if few_calls[key][2] else ""
            profile_breakdown(lambda: bundle.generate(cond, generator=gen),
                              f"{key} {nfe} UNet evals{then}, batch {BATCH}", tag="few-profile")
    # DDPM's 1000 steps are too many launches to profile: a 10-step run (the same kernels a
    # step, the envelope inverse once) is, and its device ms a step is scaled to 1000
    ddpm10 = copy.copy(few_bundles[("ddpm", None)])
    ddpm10.ddpm_cfg = ddpm_lib.DDPMConfig(num_train_timesteps=10)
    ddpm_profile = profile_breakdown(lambda: ddpm10.generate(cond, generator=gen),
                                     f"ddpm, 10 of its steps, batch {BATCH}", tag="few-profile")
    if ddpm_profile is not None:
        ddpm_ms = 100 * ddpm_profile["device_ms"]
        log(f"[few-profile] ddpm, batch {BATCH}: {ddpm_profile['device_ms'] / 10:.3f} device ms "
            f"a step, {ddpm_ms:.1f} for 1000 steps against the counted run's "
            f"{few_wall['ddpm ddpm-1000']:.1f} wall ms (busy share "
            f"{ddpm_ms / few_wall['ddpm ddpm-1000']:.3f})")
    few_rows = {}
    for key in NEW_RECIPES:
        gn, fa, enc, u_gn, u_fa = new_calls[key]
        calls = gn + enc
        few_rows[f"one {key} train step, batch {NEW_BATCH}, bf16"] = {
            "group_norm_silu": [gn_row(*k, calls=calls.count(k), batch=NEW_BATCH)
                                for k in dict.fromkeys(calls)],
            "flash_attention": [fa_row(*fa[0], calls=len(fa), batch=NEW_BATCH)],
            **{n: [r] for n, r in bwd_rows(*fa[0], calls=len(u_fa), batch=NEW_BATCH).items()}}
        u_gn, u_fa, d_gn = few_calls[key]
        calls = u_gn + d_gn
        few_rows[f"one {key} UNet eval{' and one decode' if d_gn else ''}, batch {BATCH}, "
                 f"bf16"] = {
            "group_norm_silu": [gn_row(*k, calls=calls.count(k)) for k in dict.fromkeys(calls)],
            "flash_attention": [fa_row(*u_fa[0], calls=len(u_fa))]}
    few_sums = collections.defaultdict(dict)
    for label, rows in few_rows.items():
        for name, rs in rows.items():
            for r in rs:
                log(f"[time] {label}: {json.dumps(r)}")
            few_sums[name][label] = {k: summed(rs, k) for k in (
                "ms", "bound_ms", "plain_ms", "library_ms", "issue_ms")} | {
                "calls": summed(rs, "one"),
                "bound_by": "bytes" if summed(rs, "bytes_ms") >= summed(rs, "ops_ms")
                else "operations"}
            log(f"[time] {name} over {label}: {json.dumps(few_sums[name][label])}")
    log(f"[few-rates] {json.dumps(few_rates)}")
    # the sampling-eval callback's kernels at the validation batch: one EMA UNet eval and one
    # decode (the decoder's GroupNorm at 256 is new)
    cb_label = f"one flagship UNet eval (EMA) and one decode, batch {CB_BATCH}, bf16"
    cb_rows = {"group_norm_silu": [gn_row(*k, calls=(cb_gn + cb_dec).count(k), batch=CB_BATCH)
                                   for k in dict.fromkeys(cb_gn + cb_dec)],
               "flash_attention": [fa_row(*cb_fa[0], calls=len(cb_fa), batch=CB_BATCH)]}
    cb_sums = {}
    for name, rs in cb_rows.items():
        for r in rs:
            log(f"[time] {cb_label}: {json.dumps(r)}")
        cb_sums[name] = {k: summed(rs, k) for k in ("ms", "bound_ms", "plain_ms", "library_ms",
                                                    "issue_ms")} | {
            "calls": summed(rs, "one"), "per": cb_label,
            "bound_by": "bytes" if summed(rs, "bytes_ms") >= summed(rs, "ops_ms")
            else "operations"}
        log(f"[time] {name} over {cb_label}: {json.dumps(cb_sums[name])}")

    # 4n: GroupNorm without SiLU (the scale-shift out_norm of every ResBlock and the
    # attention blocks' norms) in one options flagship train step's UNet forward
    opt_label = (f"the GroupNorm calls without SiLU of one options flagship UNet forward, "
                 f"batch {TRAIN_BATCH}, bf16")
    plain_gn = [key for key in s4n.opt_gn if not key[-1]]
    opt_rows = [gn_row(*key, calls=plain_gn.count(key), batch=TRAIN_BATCH)
                for key in dict.fromkeys(plain_gn)]
    for r in opt_rows:
        log(f"[time] {opt_label}: {json.dumps(r)}")
    opt_sums = {k: summed(opt_rows, k) for k in ("ms", "bound_ms", "plain_ms", "library_ms",
                                                 "issue_ms")} | {
        "calls": summed(opt_rows, "one"), "per": opt_label,
        "bound_by": "bytes" if summed(opt_rows, "bytes_ms") >= summed(opt_rows, "ops_ms")
        else "operations"}
    log(f"[time] group_norm_silu over {opt_label}: {json.dumps(opt_sums)}")

    phase("the kernels line")
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
            launches_per_run={**{run: counts[run][name] for run in counts},
                              "train": train_counts[name],
                              **{run: c[which] for run, c in path_counts.items()},
                              **{run: c[name] for run, c in recipe_counts.items()},
                              **{run: c[name] for run, c in new_counts.items()},
                              **{run: c[name] for run, c in few_counts.items()},
                              **{run: c[name] for run, c in cb_counts.items()},
                              **{f"4m {run}": c[name] for run, c in ckpt_counts.items()},
                              **{f"4n {run}": c[name] for run, c in opt_counts.items()},
                              **{run: c[name] for run, c in dp_counts.items()},
                              **{run: c[name] for run, c in sp["launches"].items()},
                              **{run: c[name] for run, c in int8_counts.items()}},
            classifier_forward=clf_sums[name] | {"per": f"one classifier forward, batch {BATCH}, "
                                                        f"bf16"},
            classifier_train_step=clf_step_sums[name],
            edm_recipes=new_sums[name],
            few_eval_ddpm_recipes=few_sums[name],
            sampling_eval_callback=cb_sums[name],
        ))
    kernels[0]["scale_shift_norm"] = opt_sums
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
                              **{run: c[name] for run, c in recipe_counts.items()},
                              **{run: c[name] for run, c in new_counts.items()},
                              **{run: c[name] for run, c in few_counts.items()},
                              **{run: c[name] for run, c in cb_counts.items()},
                              **{f"4n {run}": c[name] for run, c in opt_counts.items()},
                              **{run: c[name] for run, c in dp_counts.items()},
                              **{run: c[name] for run, c in sp["launches"].items()}},
            classifier_train_step=clf_step_sums[name],
            edm_recipes=new_sums[name],
            few_eval_ddpm_recipes=few_sums[name],
        ))
    for name, rows in sp["rows"].items():
        kernels.append(dict(
            name=name, route="cuda", source="tqdne_tpu_torch/csrc/group_norm.cu",
            replaces="tqdne_tpu/ops/group_norm.py:24",
            launches=entry_launches[name], max_abs_err=errs[name],
            ms=summed(rows, "ms"), plain_ms=summed(rows, "plain_ms"),
            bound_ms=summed(rows, "bound_ms"),
            bound_by="bytes" if summed(rows, "bytes_ms") >= summed(rows, "ops_ms")
            else "operations",
            library_ms=summed(rows, "library_ms"),
            per=f"all calls of one UNet eval and one decode on one of {SP_K} shards, batch "
                f"{BATCH}, bf16; library_ms is torch's group_norm on the whole tensor",
            launches_per_run={run: c[name] for run, c in sp["launches"].items()},
        ))
    bias_sums = {}
    for label, rows in ((f"one UNet eval and one decode, batch {BATCH}, bf16", bias_rows),
                        (f"one 1d_edm UNet eval, batch {BATCH}, bf16", bias_1d_rows)):
        bias_sums[label] = {k: summed(rows, k) for k in ("ms", "bound_ms", "plain_ms",
                                                       "library_ms", "issue_ms")} | {
            "calls": summed(rows, "one"),
            "bound_by": "bytes" if summed(rows, "bytes_ms") >= summed(rows, "ops_ms")
            else "operations"}
        log(f"[time] conv_bias_add over {label}: {json.dumps(bias_sums[label])}")
    bias_label = f"one UNet eval and one decode, batch {BATCH}, bf16"
    conv_runs = {**counts, "train": train_counts, **recipe_counts, **new_counts, **few_counts,
                 **cb_counts, **{f"4m {run}": c for run, c in ckpt_counts.items()},
                 **{f"4n {run}": c for run, c in opt_counts.items()}, **dp_counts,
                 **sp["launches"], **int8_counts}
    kernels.append(dict(
        name="conv_bias_add", route="cuda", source="tqdne_tpu_torch/csrc/conv_bias.cu",
        replaces="none: XLA fuses the bias into tqdne_tpu's convolutions; on the port it "
                 "replaces ATen's strided add_ of the bias and the ResBlock's h + emb_out",
        launches=launches["conv_bias_add"],
        shifted_launches=launches["conv_bias_add.shifted"],
        max_abs_err=errs["conv_bias_add"],
        **{k: bias_sums[bias_label][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "issue_ms")},
        per=f"all calls of {bias_label}; library_ms is ATen's add_ of the bias, plus h + "
            f"emb_out where a shift is added",
        launches_per_run={**{run: c["conv_bias_add"] for run, c in conv_runs.items()},
                          **{run: c[2] for run, c in path_counts.items()}},
        edm_recipes={k: v for k, v in bias_sums.items() if k != bias_label},
    ))
    kernels.append(dict(
        name="group_norm_silu_backward", route="cuda",
        source="tqdne_tpu_torch/csrc/group_norm.cu",
        replaces="none: tqdne_tpu/ops/group_norm.py:_bwd is autograd over _reference",
        max_abs_err=errs["group_norm_silu_backward"], per_train_step=gn_bwd_sums,
        library="autograd through F.silu(F.group_norm(...)) over its recorded forward, scale "
                "and bias in x's dtype, channels first for the 1D UNet, channels last for the "
                "flagship's"))
    redesigned = {
        "group_norm_silu_backward": "one launch and a sum of per-block partials: the forward's "
                                    "plan with x and dy staged, the statistics recomputed, two "
                                    "merges through distributed shared memory",
        "group_norm_silu": "one launch: a thread-block cluster over row chunks of whole-group "
                           "channel slices, each chunk staged once with 16-byte loads, "
                           "statistics merged through distributed shared memory",
        "flash_attention": "bf16 tensor cores (mma.sync m16n8k16); FMA loops in f32",
        "flash_attention_bwd_dkdv": "bf16 tensor cores (mma.sync m16n8k16); FMA loops in f32",
        "flash_attention_bwd_dq": "bf16 tensor cores (mma.sync m16n8k16) with delta = "
                                  "rowsum(dO * O) folded in; FMA loops in f32",
        "group_norm_stats": "the fused kernel's plan and code (its mode 1): the cluster's "
                            "merged (n, mean, M2) written, no normalisation",
        "group_norm_apply": "the fused kernel's plan and code (its mode 2): a given (mean, "
                            "rstd), no statistics",
        "conv_bias_add": "one in-place pass over cuDNN's output in 16-byte vectors along its "
                         "contiguous axis, the bias and the embedding shift held in registers",
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
