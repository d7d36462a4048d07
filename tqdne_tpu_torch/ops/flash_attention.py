"""Flash attention, forward and backward (kernels 2, 3 and 4 of the port).

``flash_attention`` is the counterpart of
``tqdne_tpu.ops.flash_attention.flash_attention``: multi-head attention over
``(B, L, H, D)`` tensors with q and k both scaled by d^-1/4, an f32 softmax,
an optional causal mask and, on request, the per-row base-2 log-sum-exp (as a
``(B, H, L)`` float32 tensor).  It is a ``torch.autograd.Function``, as the
JAX function is a ``custom_vjp``: the forward saves q, k, v, the output and
the lse; the backward first forms dQ and delta = rowsum(dO * O) in f32 (one
call), then dK and dV from the saved lse and that delta.

- On CUDA tensors each of the three launches a hand-written kernel, or
  raises: the forward ``csrc/flash_attention.cu`` (replaces
  ``tqdne_tpu/ops/flash_attention.py:_attention_kernel``), the backward
  ``csrc/flash_attention_bwd.cu`` (replaces ``_bwd_dq_kernel``, with the
  delta the JAX package computes beside it, and ``_bwd_dkdv_kernel``).  The
  sources say what bounds each and how it is built.  In bf16 all three run
  on the tensor cores, in variants that ``tensor_core_plan`` picks from the
  shapes, strides and pointers; in f32 they run FMA loops.
- On CPU tensors they run the plain versions: ``flash_attention_plain`` (the
  einsum of ``tqdne_tpu/nn/attention.py:qkv_attention``),
  ``flash_attention_bwd_dq_delta_plain`` (``attention_delta``, then
  ``flash_attention_bwd_dq_plain``) and ``flash_attention_bwd_dkdv_plain``.

``flash_attention.launches``, ``flash_attention_bwd_dkdv.launches`` and
``flash_attention_bwd_dq.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tqdne_tpu_torch.ops import cuda_build

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def _prescale(d: int) -> float:
    """The q/k pre-scale of the base-2 kernels: d^-1/4 * sqrt(log2 e)."""
    return d**-0.25 * math.sqrt(LOG2E)


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


def _bwd_scores(q, k, v, do, lse, delta, causal: bool):
    """The backward's recomputed (B, H, Lq, Lk) P and dS = P * (dP - delta)
    from base-2 logits of the pre-scaled q' and k', which it also returns."""
    scale = _prescale(q.shape[-1])
    qs, ks = q.float() * scale, k.float() * scale
    p = torch.exp2(torch.einsum("blhd,bshd->bhls", qs, ks) - lse[..., None])
    if causal:
        length = q.shape[1]
        mask = torch.ones(length, length, dtype=torch.bool, device=q.device).tril()
        p = p.masked_fill(~mask, 0.0)
    dp = torch.einsum("blhd,bshd->bhls", do.float(), v.float())
    return p, p * (dp - delta[..., None]), qs, ks


def flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, causal: bool = False):
    """dK = dS^T Q' * scale * ln2 and dV = P^T dO, in the input dtype."""
    p, ds, qs, _ = _bwd_scores(q, k, v, do, lse, delta, causal)
    dv = torch.einsum("bhls,blhd->bshd", p, do.float())
    dk = torch.einsum("bhls,blhd->bshd", ds, qs) * (_prescale(q.shape[-1]) * LN2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = False):
    """dQ = dS K' * scale * ln2, in the input dtype."""
    _, ds, _, ks = _bwd_scores(q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bhls,bshd->blhd", ds, ks) * (_prescale(q.shape[-1]) * LN2)
    return dq.to(q.dtype)


@functools.cache
def _kernel(source: str, symbol: str, n_ptrs: int, n_strides: int, n_plan: int = 0):
    fn = getattr(cuda_build.load(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + \
        [ctypes.c_longlong] * n_strides + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p] + [ctypes.c_int] * n_plan
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, *tensors):
    """Shared checks of the (B, L, H, D) operands a kernel reads.  It runs on
    every launch, so each tensor's attributes are read once."""
    q = tensors[0]
    shape, dtype, device = q.shape, q.dtype, q.device
    for t in tensors[1:]:
        if t.shape != shape:
            raise ValueError(f"{name}: operands must share one (B, L, H, D) shape")
        if t.dtype != dtype:
            raise TypeError(f"{name}: unsupported dtypes {[t.dtype for t in tensors]}")
        if t.device != device:
            raise ValueError(f"{name}: operands must be on one device")
    if len(shape) != 4:
        raise ValueError(f"{name}: operands must share one (B, L, H, D) shape")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtypes {[t.dtype for t in tensors]}")
    b, length, h, d = shape
    if d > MAX_HEAD_DIM or b * h > 65535 or b * length * h * d == 0:
        raise ValueError(f"{name}: unsupported shape {tuple(shape)}")
    if any(t.stride(3) != 1 for t in tensors):
        raise ValueError(f"{name}: the head dimension must have unit stride")


def _check_rows(name: str, q, *rows):
    """lse (and delta): contiguous (B, H, L) float32 on q's device."""
    b, length, h, _ = q.shape
    for t in rows:
        if t.shape != (b, h, length) or t.dtype != torch.float32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: lse and delta must be contiguous (B, H, L) float32")


def _strides(*tensors):
    return [s for t in tensors for s in t.stride()[:3]]


def tensor_core_plan(*tensors, strides=None) -> tuple[int, int, int]:
    """The variant the bf16 tensor-core kernels run for these (B, L, H, D)
    operands: (head block, warps per head, vec).

    - head block: the smallest of 32, 64 and 128 that holds D (the kernel
      zero-pads D to it in shared memory);
    - warps per head: 1 for L <= 16 (four heads a block), else 4 (four warps
      share the staged tiles of one head);
    - vec: 1 when every operand's pointer and (b, l, h) strides are 16-byte
      aligned, so the kernel stages rows with 16-byte cp.async; else 0, and
      it loads 2 bytes at a time.

    ``strides``, when given, is ``_strides(*tensors)``, which the launch has
    already read.
    """
    _, length, _, d = tensors[0].shape
    head_block = 32 if d <= 32 else 64 if d <= 64 else 128
    ptrs = ored = 0  # or-ed together: aligned only if every one is
    for t in tensors:
        ptrs |= t.data_ptr()
    for stride in strides or _strides(*tensors):
        ored |= stride
    vec = ptrs % 16 == 0 and ored * tensors[0].element_size() % 16 == 0
    return head_block, 1 if length <= 16 else 4, int(vec)


def _plan(strides, *tensors):
    if tensors[0].dtype != torch.bfloat16:
        return 0, 0, 0  # the f32 kernels take no variant
    return tensor_core_plan(*tensors, strides=strides)


def _launch_args(q):
    b, length, h, d = q.shape
    return _DTYPE_CODES[q.dtype], b, length, h, d


def _stream(q):
    """(device, its current stream), read without building a Stream object:
    every launch pays for this on the host."""
    device = q.device.index or 0
    return device, torch._C._cuda_getCurrentRawStream(device)


def _launch(q, k, v, causal: bool, return_lse: bool):
    _check("flash_attention", q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32,
                      device=q.device) if return_lse else None
    strides = _strides(q, k, v)
    err = _kernel("flash_attention", "tq_flash_attention_fwd", 5, 9, 3)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None, *_launch_args(q), *strides,
        _prescale(q.shape[-1]), int(causal), *_stream(q), *_plan(strides, q, k, v))
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return out, lse


def _on_device(name: str, t) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel for device {t.device}")
    return t.device.type == "cuda"


def _forward(q, k, v, causal: bool, return_lse: bool):
    if _on_device("flash_attention", q):
        return _launch(q, k, v, causal, return_lse)
    if return_lse:
        return flash_attention_plain(q, k, v, causal, True)
    return flash_attention_plain(q, k, v, causal), None


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal: bool = False):
    """(dK, dV) over (B, L, H, D) from the saved base-2 lse and delta =
    rowsum(dO * O), both (B, H, L) float32; outputs in the input dtype."""
    if not _on_device("flash_attention_bwd_dkdv", q):
        return flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, causal)
    _check("flash_attention_bwd_dkdv", q, k, v, do)
    _check_rows("flash_attention_bwd_dkdv", q, lse, delta)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = _strides(q, k, v, do)
    err = _kernel("flash_attention_bwd", "tq_flash_attention_bwd_dkdv", 8, 12, 3)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_launch_args(q), *strides,
        _prescale(q.shape[-1]), int(causal), *_stream(q), *_plan(strides, q, k, v, do))
    if err:
        raise RuntimeError(f"flash_attention_bwd_dkdv: kernel launch failed with CUDA error {err}")
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, out, lse, causal: bool = False):
    """(dQ, delta) over (B, L, H, D) from the forward's output and base-2
    lse: one kernel forms delta = rowsum(dO * O) as the (B, H, L) float32 rows
    that ``flash_attention_bwd_dkdv`` reads, and dQ in the input dtype."""
    if not _on_device("flash_attention_bwd_dq", q):
        return flash_attention_bwd_dq_delta_plain(q, k, v, do, out, lse, causal)
    _check("flash_attention_bwd_dq", q, k, v, do, out)
    _check_rows("flash_attention_bwd_dq", q, lse)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, do, out)
    err = _kernel("flash_attention_bwd", "tq_flash_attention_bwd_dq", 8, 15, 3)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), out.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), *_launch_args(q), *strides, _prescale(q.shape[-1]),
        int(causal), *_stream(q), *_plan(strides, q, k, v, do, out))
    if err:
        raise RuntimeError(f"flash_attention_bwd_dq: kernel launch failed with CUDA error {err}")
    flash_attention_bwd_dq.launches += 1
    return dq, delta


def attention_delta(do, out):
    """delta = rowsum(dO * O) in f32, as the (B, H, L) rows the backward reads."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_dq_delta_plain(q, k, v, do, out, lse, causal: bool = False):
    """The plain version of ``flash_attention_bwd_dq``: delta, then dQ."""
    delta = attention_delta(do, out)
    return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal), delta


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, grad, _):
        q, k, v, out, lse = ctx.saved_tensors
        if grad.stride(-1) != 1:
            grad = grad.contiguous()
        dq, delta = flash_attention_bwd_dq(q, k, v, grad, out, lse, ctx.causal)
        dk, dv = flash_attention_bwd_dkdv(q, k, v, grad, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False, return_lse: bool = False):
    """Attention over (B, L, H, D) -> (B, L, H, D) [, base-2 lse (B, H, L)];
    differentiable in q, k and v."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = _FlashAttention.apply(q, k, v, causal)
    else:
        out, lse = _forward(q, k, v, causal, return_lse)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention_bwd_dkdv.launches = 0
flash_attention_bwd_dq.launches = 0
