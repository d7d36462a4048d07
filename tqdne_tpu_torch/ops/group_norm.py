"""Fused GroupNorm + affine + optional SiLU (kernel 1 of the port).

``group_norm_silu`` is the counterpart of ``tqdne_tpu.ops.group_norm``:
channels-last ``(B, *spatial, C)`` activations in the model dtype, f32
statistics with eps inside the rsqrt, output cast back to the input dtype.

- On a CUDA tensor it launches the hand-written kernel in
  ``csrc/group_norm.cu`` (replaces ``tqdne_tpu/ops/group_norm.py:_gn_silu_kernel``;
  bytes bound it, see the source for the design), or raises.
- On a CPU tensor it runs ``group_norm_silu_plain``, the two-pass PyTorch
  version of the JAX module's ``_reference``.

The backward recomputes through the plain version, as the JAX ``_bwd`` does.
``group_norm_silu.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tqdne_tpu_torch.ops import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (x, scale/bias) dtype pairs the kernel is built for: the f32 models, the
# bf16 UNet with its norms cast, and bf16 decoder activations with f32 norms
_DTYPE_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                (torch.bfloat16, torch.float32)}
_ROWS_PER_THREAD = 16  # rows of one channel each thread reduces and normalises


def group_norm_silu_plain(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                          apply_silu: bool = True):
    """Two-pass f32 GroupNorm (+ SiLU) over (B, *spatial, C); same dtype out."""
    shape = x.shape
    c = shape[-1]
    xf = x.float().reshape(shape[0], -1, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + eps)).reshape(shape[0], -1, c)
    out = xn * scale.float() + bias.float()
    if apply_silu:
        out = F.silu(out)
    return out.reshape(shape).to(x.dtype)


@functools.cache
def _lib():
    lib = cuda_build.load("group_norm")
    fn = lib.tq_group_norm_silu
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float] + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, scale, bias, groups: int, eps: float, apply_silu: bool):
    shape = x.shape
    b, c = shape[0], shape[-1]
    s = x.numel() // (b * c) if b * c else 0
    if (x.dtype, scale.dtype) not in _DTYPE_PAIRS:
        raise TypeError(f"group_norm_silu: unsupported dtypes {x.dtype}, {scale.dtype}")
    if scale.dtype != bias.dtype or scale.shape != (c,) or bias.shape != (c,):
        raise ValueError("group_norm_silu: scale and bias must be (C,) of one dtype")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("group_norm_silu: x, scale and bias must be on one device")
    if not (x.is_contiguous() and scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("group_norm_silu: inputs must be contiguous")
    if c % groups or c > 1024 or s < 1:
        raise ValueError(f"group_norm_silu: unsupported shape {tuple(shape)} with {groups} groups")
    rows_per_iter = max(1, 256 // c)
    rows_per_chunk = rows_per_iter * _ROWS_PER_THREAD
    nchunks = -(-s // rows_per_chunk)
    out = torch.empty_like(x)
    partial = torch.empty(b * nchunks * groups * 3, dtype=torch.float32, device=x.device)
    stats = torch.empty(b * groups * 2, dtype=torch.float32, device=x.device)
    err = _lib()(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), partial.data_ptr(),
        stats.data_ptr(), _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], b, s, c, groups,
        eps, int(apply_silu), rows_per_iter, rows_per_chunk, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"group_norm_silu: kernel launch failed with CUDA error {err}")
    group_norm_silu.launches += 1
    return out


def _forward(x, scale, bias, groups, eps, apply_silu):
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, scale, bias, groups, eps, apply_silu)
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm_silu: no kernel for device {x.device}")
    return _launch(x, scale, bias, groups, eps, apply_silu)


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, apply_silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.config = (groups, eps, apply_silu)
        return _forward(x, scale, bias, groups, eps, apply_silu)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = group_norm_silu_plain(*inputs, *ctx.config)
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None, None)


def group_norm_silu(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                    apply_silu: bool = True):
    """Fused f32 GroupNorm + affine + optional SiLU over channels-last
    ``(B, *spatial, C)``; returns the input's shape and dtype."""
    return _GroupNormSiLU.apply(x, scale, bias, groups, eps, apply_silu)


group_norm_silu.launches = 0
