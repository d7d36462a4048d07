"""Flash-attention forward (kernel 2 of the port).

``flash_attention`` is the counterpart of the forward of
``tqdne_tpu.ops.flash_attention.flash_attention``: multi-head attention over
``(B, L, H, D)`` tensors with q and k both scaled by d^-1/4, an f32 softmax,
an optional causal mask and, on request, the per-row base-2 log-sum-exp the
backward consumes (as a ``(B, H, L)`` float32 tensor).

- On a CUDA tensor it launches the hand-written kernel in
  ``csrc/flash_attention.cu`` (replaces
  ``tqdne_tpu/ops/flash_attention.py:_attention_kernel``; see the source for
  what bounds it and the design), or raises.
- On a CPU tensor it runs ``flash_attention_plain``, the einsum of
  ``tqdne_tpu/nn/attention.py:qkv_attention``.

``flash_attention.launches`` counts kernel launches.  The backward kernels are
not ported yet: this is the inference path.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tqdne_tpu_torch.ops import cuda_build

LOG2E = 1.4426950408889634
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def flash_attention_plain(q, k, v, causal: bool = False, return_lse: bool = False):
    """Einsum attention with the kernel's numerics: inputs cast to f32 before
    the d^-1/4 scaling, f32 softmax, output in the input dtype."""
    d = q.shape[-1]
    scale = d**-0.25
    logits = torch.einsum("blhd,bshd->bhls", q.float() * scale, k.float() * scale)
    if causal:
        l, s = logits.shape[-2:]
        mask = torch.ones(l, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhls,bshd->blhd", weights, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1) * LOG2E
    return out


@functools.cache
def _lib():
    lib = cuda_build.load("flash_attention")
    fn = lib.tq_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal: bool, return_lse: bool):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention: q, k, v must share one (B, L, H, D) shape")
    b, length, h, d = q.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: unsupported dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must be on one device")
    if d > MAX_HEAD_DIM or b * h > 65535 or q.numel() == 0:
        raise ValueError(f"flash_attention: unsupported shape {tuple(q.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dimension must have unit stride")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("flash_attention: the backward kernels are not ported yet")
    out = torch.empty((b, length, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, length), dtype=torch.float32, device=q.device) if return_lse else None
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(1), t.stride(2))]
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None, _DTYPE_CODES[q.dtype], b, length, h, d,
        *strides, d**-0.25 * math.sqrt(LOG2E), int(causal), q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, causal: bool = False, return_lse: bool = False):
    """Attention over (B, L, H, D) -> (B, L, H, D) [, base-2 lse (B, H, L)]."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, return_lse)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    return _launch(q, k, v, causal, return_lse)


flash_attention.launches = 0
