"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build both CUDA kernels from ``tqdne_tpu_torch/csrc`` (one nvcc each, in
   parallel);
2. hold each kernel against its plain PyTorch version on the card: GroupNorm
   (+SiLU) at every (S, C) the flagship UNet and decoder give it, in f32 and
   in each (x, scale) dtype pair the bf16 path gives that shape, SiLU on and
   off; flash attention at (L, D) = (16, 128), (256, 64)
   and (508, 64), causal and not, output and base-2 log-sum-exp;
3. full-width flagship sampling in f32, 2 Heun steps, once through the
   kernels and once through the plain versions: the decoded spectrograms
   must agree (TF32 off);
4. the main path: ``build_inference`` + ``generate`` at full width in bf16,
   batch 32, Heun-25 then dpmpp_2m-10, each with 32 Griffin-Lim iterations,
   seeded random weights; waveforms must be finite (32, 3, 4064) and the
   launch counters must show both kernels on the path;
5. timings on the card: each kernel at the main path's shapes beside its
   bound, its plain version and a PyTorch yardstick call, and end-to-end
   waveforms/s.

Prints the card's name and power limit and a ``{"kernels": [...]}`` line,
then, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

SEED = 0
BATCH = 32
E2E_RUNS = 5  # timed generate() calls per solver, the launch-counted one included
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 vector
GN_OPS_PER_ELEM = {True: 10, False: 7}  # moments 2, normalise+affine 4 (+1 store), SiLU 3
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1.6e-2, 1e-3)}  # rtol, atol


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


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call: the summed durations of the CUDA kernels ``fn``
    launches, from torch.profiler.  Event timing of back-to-back calls
    measures the host's issue rate instead when a call's kernels are shorter
    than its Python overhead, as they are at the UNet's shapes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    if not total_us:
        fail("torch.profiler recorded no device time")
    return total_us / 1e3 / reps


def close(got, want, dtype) -> tuple[float, bool]:
    rtol, atol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all()) and bool(torch.isfinite(got).all())
    return err.max().item(), ok


KERNEL_CLASSES = (("group_norm_silu", ("gn_partial", "gn_finalize", "gn_apply")),
                  ("flash_attention", ("flash_fwd",)),
                  ("convolution", ("conv", "xmma", "cudnn", "implicit", "gemm", "cutlass")),
                  ("fft", ("fft",)))


def profile_breakdown(bundle, cond, gen):
    """Device time of one generate() by kernel class, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bundle.generate(cond, generator=gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
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
    from tqdne_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from tqdne_tpu_torch.ops.group_norm import group_norm_silu, group_norm_silu_plain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build()
    log(f"[build] both kernels built in {time.perf_counter() - t0:.2f} s")
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
    errs = {"group_norm_silu": 0.0, "flash_attention": 0.0}
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
    for b_, length, h, d in ((BATCH, 16, 4, 128), (8, 256, 4, 64), (8, 508, 4, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                q, k, v = (torch.randn(b_, length, h, d, generator=gen, device=dev).to(dtype)
                           for _ in range(3))
                out, lse = flash_attention(q, k, v, causal, return_lse=True)
                want, want_lse = flash_attention_plain(q, k, v, causal, return_lse=True)
                err, ok = close(out, want, dtype)
                lse_err, lse_ok = close(lse, want_lse, torch.float32)
                errs["flash_attention"] = max(errs["flash_attention"], err)
                bad += not (ok and lse_ok)
                log(f"[check] flash_attention B={b_} L={length} H={h} D={d} {str(dtype)[6:]} "
                    f"causal={causal}: max_abs_err={err:.3e} tol={TOL[dtype]} "
                    f"lse_err={lse_err:.3e} tol={TOL[torch.float32]} "
                    f"{'ok' if ok and lse_ok else 'FAIL'}")
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
        to back (CUDA events), which the host's overhead sets at small shapes."""
        return dict(ms=device_ms(kernel), plain_ms=device_ms(plain),
                    library_ms=device_ms(library), issue_ms=cuda_ms(kernel))

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

    def fa_row(dtype, length, h, d, causal, calls):
        q, k, v = (torch.randn(BATCH, length, h, d, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        qs, ks, vs = (t.transpose(1, 2) for t in (q * d**-0.25, k * d**-0.25, v))
        pairs = length * (length + 1) / 2 if causal else length * length
        return dict(
            shape=[BATCH, length, h, d], causal=causal, dtype=str(dtype)[6:], calls=calls,
            **timed(lambda: flash_attention(q, k, v, causal),
                    lambda: flash_attention_plain(q, k, v, causal),
                    lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                           scale=1.0)),
            **bound(4 * q.numel() * q.element_size(), 4 * BATCH * h * pairs * d, dtype))

    gn_rows = [gn_row(*key, calls=unet_gn.count(key)) for key in dict.fromkeys(unet_gn)]
    gn_rows += [gn_row(*key, calls=dec_gn.count(key)) for key in dict.fromkeys(dec_gn)]
    fa_rows = [fa_row(*key, calls=unet_fa.count(key)) for key in dict.fromkeys(unet_fa)]
    for row in gn_rows + fa_rows:
        log(f"[time] {json.dumps(row)}")

    def summed(rows, key):  # the kernel's work in one UNet eval plus one decode
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
            launches_per_run={run: counts[run][which] for run in counts},
        ))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
