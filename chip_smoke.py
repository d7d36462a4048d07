"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the three CUDA sources of ``tqdne_tpu_torch/csrc`` (one nvcc each,
   in parallel);
2. hold each kernel against its plain PyTorch version on the card: GroupNorm
   (+SiLU) at every (S, C) the flagship UNet and decoder give it, in f32 and
   in each (x, scale) dtype pair the bf16 path gives that shape, SiLU on and
   off; the flash forward (output and base-2 log-sum-exp) and the two flash
   backward kernels (dK/dV and dQ), f32 and bf16, causal and not, at the
   main paths' (32, 16, 4, 128) and (128, 16, 4, 128), at every L in
   (16, 17, 100, 256, 508) x D in (32, 64, 128) with q, k and v as strided
   views of one fused (B, L, 3, H, D) projection, and at the variants the
   bf16 tensor-core kernels take for other layouts: D = 40 (zero-padded to
   its head block of 64), D = 12 (2-byte loads and stores) and views one
   element into their buffers (2-byte loads);
3. full-width flagship sampling in f32, 2 Heun steps, once through the
   kernels and once through the plain versions: the decoded spectrograms
   must agree (TF32 off); then one full-width f32 training step (frozen
   encoder, EDM loss, backward) with the same injected draws both ways: the
   loss and every parameter gradient must agree;
4. the main paths, each with the launch counters set to 0 just before it and
   read just after: sampling (``build_inference`` + ``generate`` at full width
   in bf16, batch 32, Heun-25 then dpmpp_2m-10, each with 32 Griffin-Lim
   iterations, seeded random weights; waveforms must be finite
   (32, 3, 4064)), and training (``Trainer.fit`` through ``BatchLoader`` over
   in-memory synthetic waveforms, bf16 compute over f32 parameters, batch
   128, 30 steps; the loss must be finite); the counts must be exact;
5. timings on the card: each kernel at the main paths' shapes beside its
   bound, its plain version and a PyTorch yardstick call (and, for the
   record, the bf16 flash forward at (128, 16, 4, 128) and the forward and
   dK/dV at a classifier-like (32, 256, 4, 64)), end-to-end
   waveforms/s and training samples/s, a profiled sampling run and a profiled
   train step by kernel class, and one train step at the recipe's batch 256.

Prints the card's name and power limit and a ``{"kernels": [...]}`` line,
then, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import statistics
import subprocess
import sys
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


def check_flash_kernels(gen, dev, errs: dict) -> int:
    """The flash forward and both backward kernels against their plain
    versions, f32 and bf16, causal and not: at the main paths' shapes, at
    every L x D of the redesigned bf16 kernels' two variants as fused-qkv
    views, and in the layouts that take their narrow loads.  Records the
    largest errors in ``errs``; returns the number of failed checks."""
    from tqdne_tpu_torch.ops.flash_attention import (
        attention_delta,
        flash_attention,
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dkdv_plain,
        flash_attention_bwd_dq,
        flash_attention_bwd_dq_plain,
        flash_attention_plain,
        tensor_core_plan,
    )

    errs |= {"flash_attention": 0.0, "flash_attention_bwd_dkdv": 0.0,
             "flash_attention_bwd_dq": 0.0}
    bad = 0
    bf16_share = {"flash_attention": 0.0, "flash_attention_bwd_dkdv": 0.0}
    flash_cases = [(BATCH, 16, 4, 128, "separate"), (TRAIN_BATCH, 16, 4, 128, "fused")]
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
                delta = attention_delta(do, want)
                got = (flash_attention_bwd_dq(q, k, v, do, want_lse, delta, causal),
                       *flash_attention_bwd_dkdv(q, k, v, do, want_lse, delta, causal))
                ref = (flash_attention_bwd_dq_plain(q, k, v, do, want_lse, delta, causal),
                       *flash_attention_bwd_dkdv_plain(q, k, v, do, want_lse, delta, causal))
                results = [close(g, w, dtype, BWD_TOL) for g, w in zip(got, ref)]
                shares = [tol_share(g, w, dtype, BWD_TOL) for g, w in zip(got, ref)]
                errs["flash_attention_bwd_dq"] = max(errs["flash_attention_bwd_dq"],
                                                     results[0][0])
                errs["flash_attention_bwd_dkdv"] = max(errs["flash_attention_bwd_dkdv"],
                                                       results[1][0], results[2][0])
                if dtype == torch.bfloat16:
                    bf16_share["flash_attention_bwd_dkdv"] = max(
                        bf16_share["flash_attention_bwd_dkdv"], *shares[1:])
                ok = all(r[1] for r in results)
                bad += not ok
                log(f"[check] flash backward {label}: max_abs_err dq={results[0][0]:.3e} "
                    f"dk={results[1][0]:.3e} dv={results[2][0]:.3e} (share of tol dk="
                    f"{shares[1]:.3f} dv={shares[2]:.3f}; peak "
                    f"{max(w.float().abs().max().item() for w in ref):.3e}) "
                    f"tol(rtol,atol)={BWD_TOL[dtype]} {'ok' if ok else 'FAIL'}")
    log(f"[check] {len(flash_cases) * 4} flash cases; largest bf16 error as a share of its "
        f"tolerance: {json.dumps(bf16_share)}")
    return bad


KERNEL_CLASSES = (("group_norm_silu", ("gn_partial", "gn_finalize", "gn_apply")),
                  ("flash_attention", ("flash_fwd",)),
                  ("convolution", ("conv", "xmma", "cudnn", "implicit", "gemm", "cutlass")),
                  ("fft", ("fft",)))


def profile_breakdown(bundle, cond, gen):
    """Device time of one generate() by kernel class, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bundle.generate(cond, generator=gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = device_kernels(prof)
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not total_ms:
        log("[profile] the profiler recorded no device time: breakdown not measured")
        return
    classes = {name: 0.0 for name, _ in KERNEL_CLASSES} | {"other": 0.0}
    for e in kernels:
        name = next((n for n, keys in KERNEL_CLASSES if any(k in e.key.lower() for k in keys)),
                    "other")
        classes[name] += e.self_device_time_total / 1e3
    log(f"[profile] dpmpp_2m-10 + GL 32, batch {BATCH}: wall {wall_ms:.3f} ms under the "
        f"profiler, device kernels {total_ms:.3f} ms (busy share {total_ms / wall_ms:.3f}); "
        f"by class (ms): {json.dumps({k: round(v, 3) for k, v in classes.items()})}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:110]}")


TRAIN_CLASSES = (("group_norm_silu", ("gn_partial", "gn_finalize", "gn_apply")),
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
        f"{total_ms:.3f} ms (busy share {total_ms / wall_ms:.3f}; device-side ranges left out: "
        f"{left_out}); {len(ranges)} GroupNorm "
        f"backward ranges holding {len(found)} kernels; by class (ms): "
        f"{json.dumps({k: round(v, 3) for k, v in classes.items()})}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[train-profile]   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} x  "
            f"{e.key[:110]}")
    return dict(wall_ms=wall_ms, device_ms=total_ms, busy_share=total_ms / wall_ms, **classes)


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)

    from tqdne_tpu_torch.cli.common import build_inference
    from tqdne_tpu_torch.nn import attention as attention_mod
    from tqdne_tpu_torch.nn import layers as layers_mod
    from tqdne_tpu_torch.nn.attention import AttentionBlock
    from tqdne_tpu_torch.nn.layers import Norm32
    from tqdne_tpu_torch.ops import cuda_build
    from tqdne_tpu_torch.data.dataset import ArrayDataset, synthetic_arrays
    from tqdne_tpu_torch.data.pipeline import BatchLoader
    from tqdne_tpu_torch.ops.flash_attention import (
        attention_delta,
        flash_attention,
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dkdv_plain,
        flash_attention_bwd_dq,
        flash_attention_bwd_dq_plain,
        flash_attention_plain,
    )
    from tqdne_tpu_torch.train.loop import Trainer
    from tqdne_tpu_torch.train.steps import edm_step_loss
    from tqdne_tpu_torch.ops.group_norm import group_norm_silu, group_norm_silu_plain

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

    def gn_hook(mod, args):
        x = args[0]
        gn_calls.append((x.dtype, mod.weight.dtype, x[0, 0].numel(), x.shape[1], mod.groups,
                         mod.silu))

    def fa_hook(mod, args):
        x = args[0]
        fa_calls.append((x.dtype, x[0, 0].numel(), mod.num_heads, x.shape[1] // mod.num_heads,
                         mod.use_causal_mask))

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
    log(f"[shapes] UNet eval: {len(unet_gn)} GroupNorm calls, {len(unet_fa)} attention calls; "
        f"decode: {len(dec_gn)} GroupNorm calls")
    if (len(unet_gn), len(unet_fa)) != (51, 6):
        fail(f"expected 45 + 6 GroupNorm and 6 attention calls per UNet eval, got "
             f"{len(unet_gn)} and {len(unet_fa)}")

    # ---- 2. kernels against their plain versions ------------------------------
    errs = {"group_norm_silu": 0.0}
    bad = 0
    # every (S, C, G) of the path, in f32 and in each (x, scale) dtype pair the
    # path gives that shape: bf16/bf16 in the UNet, bf16/f32 in the decoder
    gn_pairs = {}
    for x_dtype, p_dtype, s, c, g, _ in unet_gn + dec_gn:
        gn_pairs.setdefault((s, c, g), {(torch.float32, torch.float32)}).add((x_dtype, p_dtype))
    for (s, c, g), pairs in sorted(gn_pairs.items()):
        for dtype, pdtype in sorted(pairs, key=str):
            for silu in (True, False):
                x = (torch.randn(BATCH, s, c, generator=gen, device=dev) * 2 + 0.5).to(dtype)
                w = (1 + 0.1 * torch.randn(c, generator=gen, device=dev)).to(pdtype)
                b = (0.1 * torch.randn(c, generator=gen, device=dev)).to(pdtype)
                err, ok = close(group_norm_silu(x, w, b, g, 1e-5, silu),
                                group_norm_silu_plain(x, w, b, g, 1e-5, silu), dtype)
                errs["group_norm_silu"] = max(errs["group_norm_silu"], err)
                bad += not ok
                log(f"[check] group_norm_silu B={BATCH} S={s} C={c} G={g} "
                    f"x={str(dtype)[6:]} scale={str(pdtype)[6:]} silu={silu}: "
                    f"max_abs_err={err:.3e} tol(rtol,atol)={TOL[dtype]} {'ok' if ok else 'FAIL'}")
    bad += check_flash_kernels(gen, dev, errs)
    torch.cuda.synchronize()
    if bad:
        fail(f"{bad} kernel checks disagree with the plain versions")

    # ---- 3. full-width f32 slice: kernels vs plain versions -------------------
    f32_bundle = build_inference(dtype=torch.float32, num_steps=2, solver="heun", device=dev,
                                 init_seed=SEED)
    noise = torch.randn(4, *f32_bundle.model_shape, generator=gen, device=dev)
    with torch.no_grad():
        with_kernels = f32_bundle.sample(cond[:4], noise=noise)
        with contextlib.ExitStack() as stack:
            stack.callback(setattr, layers_mod, "group_norm_silu", layers_mod.group_norm_silu)
            stack.callback(setattr, attention_mod, "flash_attention", attention_mod.flash_attention)
            layers_mod.group_norm_silu = group_norm_silu_plain
            attention_mod.flash_attention = flash_attention_plain
            plain = f32_bundle.sample(cond[:4], noise=noise)
    scale = plain.abs().max().item()
    slice_err = (with_kernels - plain).abs().max().item()
    log(f"[slice-f32] Heun-2 decoded spectrograms {tuple(plain.shape)}: kernels vs plain "
        f"max_abs_err={slice_err:.3e} (peak {scale:.3e}, tol 1e-4 * peak)")
    if not (torch.isfinite(with_kernels).all() and slice_err <= 1e-4 * scale):
        fail("the f32 slice through the kernels disagrees with the plain versions")
    del f32_bundle

    # one full-width f32 train step, kernels vs plain versions, same draws
    _, f32_state, _, f32_ae, model_shape, _ = training_setup(dev, torch.float32)
    unet32 = f32_state.model.eval()  # no dropout: the two passes see the same function
    n32 = 8
    batch32 = {"signal": torch.rand(n32, 128, 128, 3, generator=gen, device=dev) * 2 - 1,
               "cond": torch.randn(n32, 5, generator=gen, device=dev)}
    draws = {"ae_eps": torch.randn(n32, *model_shape, generator=gen, device=dev),
             "sigma_eps": torch.randn(n32, generator=gen, device=dev),
             "noise": torch.randn(n32, *model_shape, generator=gen, device=dev)}

    def loss_and_grads():
        unet32.zero_grad(set_to_none=True)
        before = (flash_attention_bwd_dkdv.launches, flash_attention_bwd_dq.launches)
        loss = edm_step_loss(unet32, batch32, autoencoder=f32_ae, draws=draws)
        loss.backward()
        launched = (flash_attention_bwd_dkdv.launches - before[0],
                    flash_attention_bwd_dq.launches - before[1])
        return loss.item(), {n: p.grad.clone() for n, p in unet32.named_parameters()
                             if p.grad is not None}, launched

    k_loss, k_grads, k_launched = loss_and_grads()
    with contextlib.ExitStack() as stack:
        stack.callback(setattr, layers_mod, "group_norm_silu", layers_mod.group_norm_silu)
        stack.callback(setattr, attention_mod, "flash_attention", attention_mod.flash_attention)
        layers_mod.group_norm_silu = group_norm_silu_plain  # autograd through the plain ops
        attention_mod.flash_attention = flash_attention_plain
        p_loss, p_grads, p_launched = loss_and_grads()
    worst, worst_name = 0.0, ""
    for name, want in p_grads.items():
        ratio = (k_grads[name] - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
        if ratio > worst:
            worst, worst_name = ratio, name
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    log(f"[slice-f32-train] batch {n32} f32 train step: loss kernels {k_loss:.8e} plain "
        f"{p_loss:.8e} (rel {loss_rel:.3e}, tol 1e-5); {len(p_grads)} parameter gradients, "
        f"worst max_abs_err / peak {worst:.3e} at {worst_name} (tol 1e-3); backward launches "
        f"dkdv/dq kernels {k_launched} plain {p_launched}")
    if (set(k_grads) != set(p_grads) or len(p_grads) < 100 or loss_rel > 1e-5 or worst > 1e-3
            or k_launched != (6, 6) or p_launched != (0, 0) or not math.isfinite(k_loss)):
        fail("the f32 train step through the kernels disagrees with the plain versions")
    del f32_state, f32_ae, unet32, k_grads, p_grads
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
    config, state, (train_step, eval_step), ae, model_shape, schedule = training_setup(
        dev, torch.bfloat16)
    enc_gn = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: enc_gn.append(1))
             for m in ae.encoder.modules() if isinstance(m, Norm32)]
    with torch.no_grad():
        ae.encode(torch.zeros(1, 128, 128, 3, device=dev))
    for h in hooks:
        h.remove()
    t0 = time.perf_counter()
    dataset = ArrayDataset(synthetic_arrays(TRAIN_SAMPLES, t=config.t, seed=SEED),
                           config.make_representation(), cut=config.t, cond=True, split="full")
    loader = BatchLoader(dataset, TRAIN_BATCH, device=dev, keys=("signal", "cond"), seed=SEED)
    log(f"[train] {TRAIN_SAMPLES} synthetic waveforms in {time.perf_counter() - t0:.2f} s; "
        f"{len(loader)} batches of {TRAIN_BATCH} per epoch; encoder GroupNorm calls per "
        f"encode: {len(enc_gn)}")
    workdir = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    shutil.rmtree(workdir, ignore_errors=True)
    trainer = Trainer(train_step, eval_step, workdir, device=dev, max_epochs=1000,
                      max_steps=TRAIN_STEPS, log_every=10, seed=SEED,
                      checkpoint_every_epochs=10**6, lr_schedule=schedule)
    torch.cuda.synchronize()
    counters = (group_norm_silu, flash_attention, flash_attention_bwd_dkdv,
                flash_attention_bwd_dq)
    for fn in counters:
        fn.launches = 0
    group_norm_silu.backward_calls = 0
    t0 = time.perf_counter()
    trainer.fit(state, loader, resume=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train_counts = {fn.__name__: fn.launches for fn in counters}
    gn_bwd_calls = group_norm_silu.backward_calls
    metric_rows = [json.loads(line) for line in (workdir / "metrics.jsonl").open()]
    losses = [r["training/loss"] for r in metric_rows if "training/loss" in r]
    log(f"[train] Trainer.fit: {state.step} steps of batch {TRAIN_BATCH} bf16 in {fit_s:.2f} s "
        f"(checkpoint included), logged losses {losses}, traintime "
        f"{metric_rows[-1]['traintime']:.3f} s; launches {train_counts}, GroupNorm plain backward "
        f"calls {gn_bwd_calls}")
    want_counts = {"group_norm_silu": (len(unet_gn) + len(enc_gn)) * TRAIN_STEPS,
                   "flash_attention": len(unet_fa) * TRAIN_STEPS,
                   "flash_attention_bwd_dkdv": len(unet_fa) * TRAIN_STEPS,
                   "flash_attention_bwd_dq": len(unet_fa) * TRAIN_STEPS}
    if state.step != TRAIN_STEPS or not losses or not all(map(math.isfinite, losses)):
        fail(f"training: {state.step} steps, losses {losses}")
    if train_counts != want_counts or gn_bwd_calls != len(unet_gn) * TRAIN_STEPS:
        fail(f"training launches {train_counts} (GroupNorm backward {gn_bwd_calls}) != "
             f"expected {want_counts} ({len(unet_gn) * TRAIN_STEPS})")
    if not (workdir / "checkpoints" / "last" / f"{TRAIN_STEPS}.pt").exists():
        fail("training: no checkpoint written")
    shutil.rmtree(workdir, ignore_errors=True)
    launches = {k: launches.get(k, 0) + v for k, v in train_counts.items()}

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
    profile_breakdown(bundles["dpmpp_2m-10"], cond, gen)

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

    def gn_row(dtype, pdtype, s, c, g, silu, calls):
        x = torch.randn(BATCH, s, c, generator=gen, device=dev).to(dtype)
        w = torch.ones(c, device=dev, dtype=pdtype)
        b = torch.zeros(c, device=dev, dtype=pdtype)
        # torch's group_norm takes the (B, C, S) view and parameters in x's dtype
        xt, wx, bx = x.transpose(1, 2), w.to(dtype), b.to(dtype)
        lib = (lambda: F.silu(F.group_norm(xt, g, wx, bx, 1e-5))) if silu else \
            (lambda: F.group_norm(xt, g, wx, bx, 1e-5))
        nbytes = 2 * x.numel() * x.element_size() + 2 * c * w.element_size()
        return dict(
            shape=[BATCH, s, c], groups=g, silu=silu, dtype=str(dtype)[6:],
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
    fa_rows = [fa_row(*key, calls=unet_fa.count(key)) for key in dict.fromkeys(unet_fa)]
    for row in gn_rows + fa_rows:
        log(f"[time] {json.dumps(row)}")
    # for the record (no main-path calls): the forward at the training batch, and at a
    # classifier-like 256 tokens, where the tensor cores first carry real work
    for batch, length, d in ((TRAIN_BATCH, 16, 128), (BATCH, 256, 64)):
        log(f"[time] {json.dumps(fa_row(torch.bfloat16, length, 4, d, False, 0, batch))}")

    # training: samples/s of train_step on a resident batch, a profiled step,
    # the backward kernels per call, and one step at the recipe's batch 256
    tgen = torch.Generator(device=dev).manual_seed(SEED)
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
    train_profile(one_step, f"one train step, batch {TRAIN_BATCH}, bf16")

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
            # reads q, k, v, dO, lse, delta; writes dQ; products S, dP, dQ
            "flash_attention_bwd_dq": dict(
                kernel="flash_attention_bwd_dq", **common,
                **timed(lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, causal),
                        lambda: flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal),
                        library),
                **bound(5 * elems * size + rows_bytes, 6 * batch * h * pairs * d, dtype)),
        }

    bwd = [bwd_rows(*key, calls=unet_fa.count(key)) for key in dict.fromkeys(unet_fa)]
    for row in bwd:
        for r in row.values():
            log(f"[time] {json.dumps(r)}")
    classifier_like = bwd_rows(torch.bfloat16, 256, 4, 64, False, 0, batch=BATCH)
    log(f"[time] {json.dumps(classifier_like['flash_attention_bwd_dkdv'])}")  # for the record

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

    def summed(rows, key):  # the kernel's work in one UNet eval (plus one decode) or step
        return sum(r[key] * r["calls"] for r in rows)

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
                              "train": train_counts[name]},
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
            launches_per_run={"train": train_counts[name]},
        ))
    for entry in kernels:  # the kernels rebuilt on the tensor cores
        if entry["name"] in ("flash_attention", "flash_attention_bwd_dkdv"):
            entry["redesigned"] = "bf16 tensor cores (mma.sync m16n8k16); FMA loops in f32"

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
