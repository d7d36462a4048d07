"""int8 convolution, a quality-gated fast mode for sampling: the port of
``tqdne_tpu/nn/quant.py``.

Every convolution ``nn.layers.conv_nd`` builds (ResBlocks, up- and
downsampling, qkv and the attention's output projection, the in and out
convolutions) routes through ``quant_conv`` while ``int8_enabled()``: inside
``int8_scope()``, or for the whole process with ``TQDNE_INT8_CONV=1``.  The
parameters do not change, so every checkpoint loads into either mode.

Numerics, as the JAX ``QuantConv``:

- weights: symmetric int8 per output channel, the scale from the amax over
  (I, *window) of the weight as the module holds it (after a bf16 cast, the
  bf16 copy), at every call;
- activations: symmetric int8 per tensor, the amax over the whole tensor,
  batch included (under ``parallel.spatial`` over every rank's block, as
  the JAX amax is over the global array);
- products accumulated in int32, then dequantized in f32 as
  ``acc * (x_scale * w_scale) + bias`` and cast back to the input's dtype.

On a CUDA tensor the product runs on the int8 tensor cores: the
activation's codes are cut into patches (im2col, one strided view and one
copy), then ``torch._int_mm`` (cuBLASLt's int8 GEMM), with the rows and the
depth and width padded with zeros to what it takes.  The JAX product is
``lax.conv_general_dilated`` with int8 operands, which XLA lowers outside
any Pallas kernel, so it has no hand-written counterpart here.  On a CPU
tensor ``int_conv_plain`` computes the same integers as a float64
convolution of the codes, which is exact (|acc| <= 127^2 K, far below
2^53).  ``quant_conv.launches`` counts the int8 products issued on the card.
"""

from __future__ import annotations

import contextlib
import contextvars
import os

import torch
import torch.nn.functional as F

from tqdne_tpu_torch.parallel import spatial

_INT8_SCOPE: contextvars.ContextVar = contextvars.ContextVar("tqdne_int8_convs", default=False)
MIN_ROWS = 17  # torch._int_mm takes more than 16 rows
ALIGN = 8  # and a depth and a width that are multiples of 8


@contextlib.contextmanager
def int8_scope(enabled: bool = True):
    """The convolutions inside run as ``quant_conv`` (``enabled``)."""
    token = _INT8_SCOPE.set(enabled)
    try:
        yield
    finally:
        _INT8_SCOPE.reset(token)


def int8_enabled() -> bool:
    return _INT8_SCOPE.get() or os.environ.get("TQDNE_INT8_CONV") == "1"


def quantize_symmetric(x, dims, eps: float = 1e-8):
    """(q int8, scale f32) with q = round(x / scale) clipped to [-127, 127] and
    scale = max(amax, eps) / 127, the amax over ``dims`` (kept as size 1).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    amax = xf.abs().amax(dim=dims, keepdim=True)
    return _codes(xf, amax, eps)


def _codes(xf, amax, eps: float = 1e-8):
    scale = torch.clamp(amax, min=eps) / 127.0
    return torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8), scale


def _padded(stride, padding, dims: int):
    stride = (stride,) * dims if isinstance(stride, int) else tuple(stride)
    padding = (padding,) * dims if isinstance(padding, int) else tuple(padding)
    return stride, padding


def int_conv_plain(xq, wq, stride=1, padding=0) -> torch.Tensor:
    """The int32 products of int8 codes xq (B, I, *spatial) and wq (O, I, *window):
    a float64 convolution of the codes, exact, on any device."""
    dims = wq.ndim - 2
    stride, padding = _padded(stride, padding, dims)
    conv = F.conv1d if dims == 1 else F.conv2d
    return conv(xq.double(), wq.double(), stride=stride, padding=padding).to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_conv_mm(xq, wq, stride=1, padding=0) -> torch.Tensor:
    """``int_conv_plain`` as im2col then ``torch._int_mm``: the codes' patches
    (B * out rows, window * I) in channels-last order against the weight's codes
    (window * I, O), both zero-padded to the product's alignment; returns the int32
    (B, O, *out) in channels-last memory."""
    dims = wq.ndim - 2
    stride, padding = _padded(stride, padding, dims)
    o, i, *window = wq.shape
    x = F.pad(xq.movedim(1, -1), [0, 0] + [p for pad in reversed(padding) for p in (pad, pad)])
    b, *size, _ = x.shape
    out = [(n - k) // s + 1 for n, k, s in zip(size, window, stride)]
    xs = x.stride()
    # (B, *out, *window, I): a patch view of the padded channels-last codes
    patches = x.as_strided((b, *out, *window, i),
                           (xs[0], *(xs[1 + d] * stride[d] for d in range(dims)),
                            *xs[1:1 + dims], xs[-1]))
    m, k = b * int(torch.Size(out).numel()), i * int(torch.Size(window).numel())
    kp, op, mp = _round_up(k, ALIGN), _round_up(o, ALIGN), max(m, MIN_ROWS)
    a = patches.reshape(m, k)
    if kp != k or mp != m:
        a = F.pad(a, (0, kp - k, 0, mp - m))
    w = wq.movedim(1, -1).reshape(o, k)  # (O, *window, I), the patches' order
    if kp != k or op != o:
        w = F.pad(w, (0, kp - k, 0, op - o))
    acc = torch._int_mm(a.contiguous(), w.contiguous().t())
    return acc[:m, :o].reshape(b, *out, o).movedim(-1, 1)


def quant_conv(x, weight, bias, stride=1, padding=0) -> torch.Tensor:
    """int8 x int8 -> int32 convolution of ``x`` (B, I, *spatial) with ``weight``
    (O, I, *window) and ``bias`` (O,), dequantized in f32 and returned in x's dtype.
    The int8 tensor cores on a CUDA tensor (``int_conv_mm``), ``int_conv_plain`` on
    a CPU one."""
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"quant_conv: no int8 product for device {x.device}")
    dims = weight.ndim - 2
    wq, w_scale = quantize_symmetric(weight, tuple(range(1, dims + 2)))
    xf = x.float()
    amax = spatial.all_reduce_max(xf.abs().amax())  # the global array's, under the scope
    xq, x_scale = _codes(xf, amax)
    if x.device.type == "cuda":
        acc = int_conv_mm(xq, wq, stride, padding)
        quant_conv.launches += 1
    else:
        acc = int_conv_plain(xq, wq, stride, padding)
    out = acc.float() * (x_scale * w_scale.reshape(-1, *(1,) * dims))
    if bias is not None:
        out = out + bias.float().reshape(-1, *(1,) * dims)
    return out.to(x.dtype if x.is_floating_point() else torch.float32)


quant_conv.launches = 0
