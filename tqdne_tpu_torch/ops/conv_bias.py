"""A convolution's bias, and a ResBlock's embedding shift, added in place in one pass.

``conv_bias_add(y, bias, shift=None)`` adds ``bias[c]``, plus ``shift[b, c]`` where one is
given, to a convolution's output ``y`` (B, C, *spatial), in place: the sum taken in f32 as
``(y + bias) + shift`` and rounded once to ``y``'s dtype.  ``bias`` is (C,) and ``shift``
(B, C), both of ``y``'s dtype.

- On a CUDA tensor it launches the hand-written kernel in ``csrc/conv_bias.cu`` (bytes bound
  it, see the source for the design), or raises: one launch a call, laid along whichever axis
  of ``y`` is contiguous (``conv_bias_plan``).  No TPU kernel is replaced: XLA fuses the bias
  into the convolution, where PyTorch runs ATen's strided broadcast add after cuDNN.
- On a CPU tensor it runs ``conv_bias_add_plain``, the same arithmetic in PyTorch.

Under autograd the add is a ``torch.autograd.Function`` that marks ``y`` dirty: the backward
passes ``dy`` through for ``y`` and sums it over the spatial axes for ``shift`` and over the
batch too for ``bias``, in one pass over ``dy`` where both are wanted (the (B, C) sums folded
over B).  ``conv_bias_add.launches`` counts kernel launches and
``conv_bias_add.shifted_launches`` those with a shift.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from tqdne_tpu_torch.ops import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ESIZE = {torch.float32: 4, torch.bfloat16: 2}
SMS = 132  # streaming multiprocessors of an H100 SXM
THREADS = 256  # a block's threads: 8 blocks an SM at full occupancy
BLOCKS = 2 * 8 * SMS  # about two waves of blocks; a grid-stride loop covers the rest
MAX_BLOCKS_Y = 65535


def conv_bias_add_plain(y, bias, shift=None):
    """``y.copy_((y.float() + bias + shift).to(y.dtype))`` with ``bias`` (C,) and ``shift``
    (B, C) broadcast over ``y`` (B, C, *spatial); returns ``y``."""
    tail = (1,) * (y.dim() - 2)
    out = y.float() + bias.float().view(-1, *tail)
    if shift is not None:
        out = out + shift.float().view(*shift.shape, *tail)
    return y.copy_(out)


class ConvBiasPlan(NamedTuple):
    """The launch of ``csrc/conv_bias.cu`` for one output.

    - ``layout``: 0 channels innermost ((B, *spatial, C) in memory), 1 rows of one channel
      ((B, C, *spatial) contiguous);
    - ``b``, ``s``, ``c``: samples, spatial positions and channels;
    - ``vec``: elements a thread moves at once, 16 bytes' worth where the run allows;
    - ``blocks_x``, ``blocks_y``, ``threads``: the grid.
    """

    layout: int
    b: int
    s: int
    c: int
    vec: int
    blocks_x: int
    blocks_y: int
    threads: int


def _channels_innermost(shape, stride) -> bool:
    """Whether (B, C, *spatial) lies in memory as (B, *spatial, C), densely."""
    want = shape[1]
    if stride[1] != 1 and shape[1] > 1:
        return False
    for size, st in zip(reversed(shape[2:]), reversed(stride[2:])):
        if st != want and size > 1:
            return False
        want *= size
    return stride[0] == want or shape[0] == 1


def _contiguous(shape, stride) -> bool:
    want = 1
    for size, st in zip(reversed(shape), reversed(stride)):
        if st != want and size > 1:
            return False
        want *= size
    return True


def conv_bias_plan(shape: tuple, stride: tuple, esize: int) -> ConvBiasPlan:
    """The kernel's launch for an output of ``shape`` and ``stride`` with ``esize``-byte
    elements; raises on a layout the kernel does not take (neither channels innermost nor
    contiguous, or no spatial axis).

    The vector is the widest of 16, 8, 4, 2 bytes (or one element) that divides the run a
    vector may not cross (a sample's S x C elements, or a row's S); ``y`` must be aligned to
    it, as a fresh convolution output is (the wrapper raises otherwise).  Channels
    innermost: ``blocks_x`` blocks a sample, about ``BLOCKS`` in all, rounded up so that the
    threads of a sample times the vector are a multiple of C.  Rows: a warp a row, up to
    ``BLOCKS`` blocks.
    """
    if len(shape) < 3 or len(stride) != len(shape) or 0 in shape:
        raise ValueError(f"conv_bias_add: unsupported shape {shape}")
    b, c = shape[0], shape[1]
    s = math.prod(shape[2:])
    if _channels_innermost(shape, stride):
        layout, run = 0, s * c
    elif _contiguous(shape, stride):
        layout, run = 1, s
    else:
        raise ValueError(f"conv_bias_add: y of shape {shape} and strides {stride} is neither "
                         "channels-last nor contiguous")
    vec = 16 // esize
    while vec > 1 and run % vec:
        vec //= 2
    if layout == 0:
        period = c // math.gcd(c, vec)  # vectors after which the channels repeat
        unit = period // math.gcd(period, THREADS)
        per_sample = -(-(run // vec) // THREADS)
        blocks_x = max(1, min(-(-BLOCKS // b), per_sample))
        blocks_x = -(-blocks_x // unit) * unit
        return ConvBiasPlan(0, b, s, c, vec, blocks_x, min(b, MAX_BLOCKS_Y), THREADS)
    blocks = min(-(-b * c // (THREADS // 32)), BLOCKS)
    return ConvBiasPlan(1, b, s, c, vec, blocks, 1, THREADS)


@functools.cache
def _lib():
    fn = cuda_build.load("conv_bias").tq_conv_bias_add
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2 + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launch_args(shape, stride, dtype, bias_meta, shift_meta) -> tuple:
    """The integer arguments of ``tq_conv_bias_add`` after the checks of ``y``'s and the
    addends' (shape, stride, dtype); raises on what the kernel does not take."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"conv_bias_add: unsupported dtype {dtype}")
    want = {"bias": (shape[1],), "shift": tuple(shape[:2])}
    for name, meta in (("bias", bias_meta), ("shift", shift_meta)):
        if meta is not None and (meta[0] != want[name] or meta[2] != dtype
                                 or not _contiguous(meta[0], meta[1])):
            raise ValueError(f"conv_bias_add: {name} must be a contiguous {want[name]} of y's "
                             f"dtype")
    plan = conv_bias_plan(shape, stride, _ESIZE[dtype])
    return (_DTYPE_CODES[dtype], plan.layout, plan.b, plan.s, plan.c, plan.vec, plan.blocks_x,
            plan.blocks_y, plan.threads)


def _launch(y, bias, shift):
    ptr, device = y.data_ptr(), y.get_device()
    args = _launch_args(y.shape, y.stride(), y.dtype, (bias.shape, bias.stride(), bias.dtype),
                        None if shift is None else (shift.shape, shift.stride(), shift.dtype))
    if ptr % (args[5] * y.element_size()):
        raise ValueError(f"conv_bias_add: y's address is not aligned to its {args[5]}-element "
                         "vector")
    if bias.get_device() != device or (shift is not None and shift.get_device() != device):
        raise ValueError("conv_bias_add: y, bias and shift must be on one device")
    err = _lib()(ptr, bias.data_ptr(), None if shift is None else shift.data_ptr(), *args,
                 device, torch._C._cuda_getCurrentRawStream(device))
    if err:
        raise RuntimeError(f"conv_bias_add: kernel launch failed with CUDA error {err}")
    conv_bias_add.launches += 1
    conv_bias_add.shifted_launches += shift is not None
    return y


def _add(y, bias, shift):
    if y.is_cuda:
        return _launch(y, bias, shift)
    if y.is_cpu:
        return conv_bias_add_plain(y, bias, shift)
    raise RuntimeError(f"conv_bias_add: no kernel for device {y.device}")


class _ConvBiasAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, bias, shift):
        ctx.mark_dirty(y)
        ctx.dtypes = (bias.dtype, None if shift is None else shift.dtype)
        return _add(y, bias, shift)

    @staticmethod
    def backward(ctx, dy):
        need_bias, need_shift = ctx.needs_input_grad[1:]
        spatial = tuple(range(2, dy.dim()))
        dbias = dshift = None
        if need_shift:
            sums = dy.sum(spatial, dtype=torch.float32)  # (B, C)
            dshift = sums.to(ctx.dtypes[1])
            if need_bias:
                dbias = sums.sum(0).to(ctx.dtypes[0])
        elif need_bias:
            dbias = dy.sum((0, *spatial), dtype=torch.float32).to(ctx.dtypes[0])
        return dy, dbias, dshift


def conv_bias_add(y, bias, shift=None):
    """``y`` (B, C, *spatial) plus ``bias`` (C,) and ``shift`` (B, C), in place, in f32,
    rounded once to ``y``'s dtype; returns ``y``."""
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad
                                    or (shift is not None and shift.requires_grad)):
        return _ConvBiasAdd.apply(y, bias, shift)
    return _add(y, bias, shift)


conv_bias_add.launches = 0
conv_bias_add.shifted_launches = 0
