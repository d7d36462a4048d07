"""Fused GroupNorm + affine + optional SiLU (kernel 1 of the port).

``group_norm_silu`` is the counterpart of ``tqdne_tpu.ops.group_norm``:
channels-last ``(B, *spatial, C)`` activations in the model dtype, f32
statistics with eps inside the rsqrt, output cast back to the input dtype.

- On a CUDA tensor it launches the hand-written kernel in
  ``csrc/group_norm.cu`` (replaces ``tqdne_tpu/ops/group_norm.py:_gn_silu_kernel``;
  bytes bound it, see the source for the design), or raises: one launch a
  call, in the variant ``group_norm_plan`` picks from the shape, the dtypes
  and the alignment, and no scratch memory.
- On a CPU tensor it runs ``group_norm_silu_plain``, the two-pass PyTorch
  version of the JAX module's ``_reference``.

The backward recomputes through the plain version, as the JAX ``_bwd`` does
(XLA autograd over ``_reference``: the TPU package has no backward kernel).
``group_norm_silu.launches`` counts kernel launches and
``group_norm_silu.backward_calls`` the plain backward recomputations, which
run inside a ``tq::group_norm_silu_backward`` profiler range.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tqdne_tpu_torch.ops import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (x, scale/bias) dtype pairs the kernel is built for: the f32 models, the
# bf16 UNet with its norms cast, and bf16 activations with f32 norms
_DTYPE_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                (torch.bfloat16, torch.float32)}
MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90 (227 KB)
MAX_CLUSTER = 16  # blocks of a thread-block cluster, non-portable above 8
TARGET_CHUNK = 64 * 1024  # bytes of x a block stages: two or three blocks an SM
MIN_SEGMENT = 64  # bytes of a row a slice reads at least: two full 32-byte sectors
THREADS = 256  # a block's threads, more only where a slice has more vector columns
SMS = 132  # streaming multiprocessors of an H100 SXM
BLOCKS = 2 * SMS  # slices stay narrow while fewer blocks would run


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


class GroupNormPlan(NamedTuple):
    """The launch variant of the GroupNorm kernel (``csrc/group_norm.cu``).

    - ``slice_channels``: channels a block owns (whole groups); ``slices``
      = C / slice_channels;
    - ``cluster``: blocks of one (sample, slice), each ``chunk_rows`` rows;
    - ``rows_per_pass``: threads that share a vector column; a block has
      rows_per_pass * slice_channels / vec of them at work, ``threads`` in
      all (a multiple of 32);
    - ``vec``: elements a thread loads at once, 16 bytes' worth where x, y
      and C are 16-byte aligned, else 1;
    - ``resident``: the chunk stays in shared memory (x read from HBM once);
      else every pass reads it again, from L2;
    - ``smem``: bytes of dynamic shared memory a block uses.
    """

    slice_channels: int
    slices: int
    cluster: int
    chunk_rows: int
    rows_per_pass: int
    threads: int
    vec: int
    resident: bool
    smem: int


def _smem(esize, vec, cs, gsize, chunk_rows, rpp, threads, cluster, resident):
    """``smem_bytes`` of ``csrc/group_norm.cu``: the staged chunk, the
    partial sums (one row of cs a warp where the lanes of a column fold by
    shuffles, else one a row slot), channel totals, and 5 + 3 * cluster
    floats a group."""
    stage = -(-chunk_rows * cs * esize // 16) * 16 if resident else 0
    red_rows = threads // 32 if 32 % (cs // vec) == 0 else rpp
    return stage + 4 * (red_rows * cs + cs + (5 + 3 * cluster) * (cs // gsize))


def _threads(cs, vec, chunk_rows):
    """(rows_per_pass, threads) of a block over chunks of ``chunk_rows``."""
    rpp = max(1, min(THREADS // (cs // vec), chunk_rows))
    return rpp, -(-rpp * (cs // vec) // 32) * 32


@functools.cache
def group_norm_plan(b: int, s: int, c: int, g: int, x_dtype, p_dtype, aligned: bool,
                    max_cluster: int = MAX_CLUSTER) -> GroupNormPlan:
    """The kernel's variant for a (B, S, C) call with G groups.

    A slice is the fewest whole groups that read ``MIN_SEGMENT`` bytes of a
    row, widened while each (sample, slice) stays under ``TARGET_CHUNK``
    bytes and at least ``BLOCKS`` slices remain.  The rows of a slice split
    into a cluster of chunks of about ``TARGET_CHUNK`` bytes, or more where
    fewer blocks than SMs would run, up to ``max_cluster`` blocks (the
    largest cluster the card co-schedules); where a chunk would still not
    fit in shared memory it is read again from L2 instead of staged
    (``resident`` False).
    """
    if (x_dtype, p_dtype) not in _DTYPE_PAIRS:
        raise TypeError(f"group_norm_silu: unsupported dtypes {x_dtype}, {p_dtype}")
    if c % g or s < 1 or b < 1:
        raise ValueError(f"group_norm_silu: unsupported shape {(b, s, c)} with {g} groups")
    esize = 4 if x_dtype == torch.float32 else 2
    vec = 16 // esize if aligned and c * esize % 16 == 0 else 1
    gsize = c // g
    unit = math.lcm(gsize, vec)
    widths = [w for w in range(unit, c + 1, unit) if c % w == 0]
    cs = next((w for w in widths if w * esize >= MIN_SEGMENT), widths[-1])
    for w in widths:
        if w > cs and s * w * esize <= TARGET_CHUNK and b * (c // w) >= BLOCKS \
                and w // vec <= THREADS:
            cs = w
    slab = s * cs * esize

    def fits(cluster):
        rows = -(-s // cluster)
        return _smem(esize, vec, cs, gsize, rows, *_threads(cs, vec, rows), cluster,
                     True) <= MAX_SMEM

    # chunks of about TARGET_CHUNK bytes, and at least one block for each of 132 SMs
    want = max(-(-slab // TARGET_CHUNK), -(-SMS // (b * (c // cs))))
    cluster = max(1, min(want, max_cluster, s))
    while not fits(cluster) and cluster < min(max_cluster, s):
        cluster += 1
    resident = fits(cluster)
    chunk_rows = -(-s // cluster)
    cluster = -(-s // chunk_rows)  # no block without rows
    rpp, threads = _threads(cs, vec, chunk_rows)
    return GroupNormPlan(cs, c // cs, cluster, chunk_rows, rpp, threads, vec, resident,
                         _smem(esize, vec, cs, gsize, chunk_rows, rpp, threads, cluster,
                               resident))


@functools.cache
def _lib():
    lib = cuda_build.load("group_norm")
    fn = lib.tq_group_norm_silu
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] + \
        [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def cluster_limit(device: int) -> int:
    """The largest cluster (up to 16 blocks of 512 threads and 227 KB of shared memory)
    that the card co-schedules, read once per device."""
    limit = ctypes.c_int(0)
    err = cuda_build.load("group_norm").tq_group_norm_cluster_limit(
        ctypes.c_int(device), ctypes.byref(limit))
    if err or limit.value < 1:
        raise RuntimeError(f"group_norm_silu: no cluster co-schedules (CUDA error {err})")
    return limit.value


def _launch(x, scale, bias, groups: int, eps: float, apply_silu: bool):
    shape = x.shape
    b, c = shape[0], shape[-1]
    s = x.numel() // (b * c) if b * c else 0
    if scale.dtype != bias.dtype or scale.shape != (c,) or bias.shape != (c,):
        raise ValueError("group_norm_silu: scale and bias must be (C,) of one dtype")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("group_norm_silu: x, scale and bias must be on one device")
    if not (x.is_contiguous() and scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("group_norm_silu: inputs must be contiguous")
    if c % groups or c > 1024 or s < 1:
        raise ValueError(f"group_norm_silu: unsupported shape {tuple(shape)} with {groups} groups")
    device = x.device.index or 0
    plan = group_norm_plan(b, s, c, groups, x.dtype, scale.dtype, x.data_ptr() % 16 == 0,
                           cluster_limit(device))
    out = torch.empty_like(x)
    err = _lib()(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], b, s, c, groups, eps,
        int(apply_silu), plan.slice_channels, plan.cluster, plan.chunk_rows,
        plan.rows_per_pass, plan.threads, plan.vec, int(plan.resident), device,
        torch._C._cuda_getCurrentRawStream(device),
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
        with torch.enable_grad(), torch.profiler.record_function("tq::group_norm_silu_backward"):
            out = group_norm_silu_plain(*inputs, *ctx.config)
            grads = iter(torch.autograd.grad(out, wanted, grad))
        group_norm_silu.backward_calls += 1
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None, None)


def group_norm_silu(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                    apply_silu: bool = True):
    """Fused f32 GroupNorm + affine + optional SiLU over channels-last
    ``(B, *spatial, C)``; returns the input's shape and dtype."""
    return _GroupNormSiLU.apply(x, scale, bias, groups, eps, apply_silu)


group_norm_silu.launches = 0
group_norm_silu.backward_calls = 0
