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

The backward of a CUDA tensor launches the kernel's backward entry
(``tq_group_norm_silu_backward``, in the plan ``group_norm_plan(...,
backward=True)`` picks): it recomputes the statistics from x, writes dx and
each block's per-channel partials of dscale and dbias, which the wrapper sums
in a fixed order (no atomics).  The TPU package has no backward kernel (the JAX
``_bwd`` is XLA autograd over ``_reference``); a CPU tensor's backward
recomputes through the plain version under autograd as that one does.
``group_norm_silu.launches`` counts forward launches,
``group_norm_silu.backward_launches`` backward launches and
``group_norm_silu.backward_calls`` every backward, kernel or plain; a backward
runs inside a ``tq::group_norm_silu_backward`` span (``utils.tracing``), a
forward inside ``tq::group_norm_silu``.

For an activation whose rows are split over ranks (``parallel/spatial.py``),
the statistics span every shard: ``group_norm_silu_sharded`` takes each
shard's per-(sample, group) count, mean and M2 (``group_norm_stats``), gathers
them from the other shards, merges them (``merge_group_stats``, Chan's
formula) and normalises (``group_norm_apply``).  The two entries launch the
same kernel in two more modes on CUDA, with plain versions beside them for
the CPU; the backward recomputes through the plain versions and a
differentiable gather, so the gradient carries the cross-shard terms.
``group_norm_stats.launches`` and ``group_norm_apply.launches`` count their
launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tqdne_tpu_torch.ops import cuda_build
from tqdne_tpu_torch.utils.tracing import span

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
BWD_THREADS = 128  # a backward block's threads: more blocks an SM at its 122 registers a thread
MAX_BWD_THREADS = 512  # a backward block's threads at most (its launch bound)


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


def _smem(esize, vec, cs, gsize, chunk_rows, rpp, threads, cluster, resident,
          backward=False):
    """``smem_bytes`` of ``csrc/group_norm.cu``: the staged chunk, the
    partial sums (one row of cs a warp where the lanes of a column fold by
    shuffles, else one a row slot), channel totals, and 5 + 3 * cluster
    floats a group; ``smem_bwd_bytes`` where ``backward``: the chunks of x
    and dy, two rows of channel totals and 7 + 3 * cluster floats a group."""
    k = 2 if backward else 1
    stage = k * -(-chunk_rows * cs * esize // 16) * 16 if resident else 0
    red_rows = threads // 32 if 32 % (cs // vec) == 0 else rpp
    return stage + 4 * (red_rows * cs + k * cs + (3 + 2 * k + 3 * cluster) * (cs // gsize))


def _threads(cs, vec, chunk_rows, target=THREADS):
    """(rows_per_pass, threads) of a block over chunks of ``chunk_rows``, about ``target``
    threads where a slice has fewer vector columns."""
    rpp = max(1, min(target // (cs // vec), chunk_rows))
    return rpp, -(-rpp * (cs // vec) // 32) * 32


@functools.cache
def group_norm_plan(b: int, s: int, c: int, g: int, x_dtype, p_dtype, aligned: bool,
                    max_cluster: int = MAX_CLUSTER, backward: bool = False) -> GroupNormPlan:
    """The kernel's variant for a (B, S, C) call with G groups.

    A slice is the fewest whole groups that read ``MIN_SEGMENT`` bytes of a
    row, widened while each (sample, slice) stays under ``TARGET_CHUNK``
    bytes and at least ``BLOCKS`` slices remain.  The rows of a slice split
    into a cluster of chunks of about ``TARGET_CHUNK`` bytes, or more where
    fewer blocks than SMs would run, up to ``max_cluster`` blocks (the
    largest cluster the card co-schedules); where a chunk would still not
    fit in shared memory it is read again from L2 instead of staged
    (``resident`` False).  The ``backward`` stages x and dy: twice the bytes
    a row, so about twice the blocks a cluster, with at most
    ``MAX_BWD_THREADS`` threads a block (raises where a slice needs more).
    """
    if (x_dtype, p_dtype) not in _DTYPE_PAIRS:
        raise TypeError(f"group_norm_silu: unsupported dtypes {x_dtype}, {p_dtype}")
    if c % g or s < 1 or b < 1:
        raise ValueError(f"group_norm_silu: unsupported shape {(b, s, c)} with {g} groups")
    esize = 4 if x_dtype == torch.float32 else 2
    staged = 2 * esize if backward else esize  # bytes a block stages of each element
    target = BWD_THREADS if backward else THREADS
    vec = 16 // esize if aligned and c * esize % 16 == 0 else 1
    gsize = c // g
    unit = math.lcm(gsize, vec)
    widths = [w for w in range(unit, c + 1, unit) if c % w == 0]
    cs = next((w for w in widths if w * esize >= MIN_SEGMENT), widths[-1])
    for w in widths:
        if w > cs and s * w * staged <= TARGET_CHUNK and b * (c // w) >= BLOCKS \
                and w // vec <= THREADS:
            cs = w
    slab = s * cs * staged

    def fits(cluster):
        rows = -(-s // cluster)
        return _smem(esize, vec, cs, gsize, rows, *_threads(cs, vec, rows, target), cluster,
                     True, backward) <= MAX_SMEM

    # chunks of about TARGET_CHUNK bytes, and at least one block for each of 132 SMs
    want = max(-(-slab // TARGET_CHUNK), -(-SMS // (b * (c // cs))))
    cluster = max(1, min(want, max_cluster, s))
    while not fits(cluster) and cluster < min(max_cluster, s):
        cluster += 1
    resident = fits(cluster)
    chunk_rows = -(-s // cluster)
    cluster = -(-s // chunk_rows)  # no block without rows
    rpp, threads = _threads(cs, vec, chunk_rows, target)
    if backward and threads > MAX_BWD_THREADS:
        raise ValueError(f"group_norm_silu backward: a slice of {cs // vec} columns takes more "
                         f"than {MAX_BWD_THREADS} threads (16-byte aligned rows take fewer)")
    return GroupNormPlan(cs, c // cs, cluster, chunk_rows, rpp, threads, vec, resident,
                         _smem(esize, vec, cs, gsize, chunk_rows, rpp, threads, cluster,
                               resident, backward))


@functools.cache
def _lib():
    lib = cuda_build.load("group_norm")
    fn = lib.tq_group_norm_silu
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] + \
        [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_lib():
    fn = cuda_build.load("group_norm").tq_group_norm_silu_backward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float] + \
        [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry(symbol: str, n_ptrs: int, n_ints: int):
    """A C entry of the library taking ``n_ptrs`` pointers, ``n_ints`` ints and the stream."""
    fn = getattr(cuda_build.load("group_norm"), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
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


def _checked_plan(name: str, x, groups: int, params=(), grad=None):
    """(B, S, C, device, plan) of a kernel call on ``x`` (B, *spatial, C) with ``params``
    (scale and bias, each (C,)), after the checks the kernel needs; raises on what it
    does not take.  With ``grad`` (dy, x's shape and dtype) the backward's plan."""
    shape = x.shape
    b, c = shape[0], shape[-1]
    s = x.numel() // (b * c) if b * c else 0
    if params:
        scale, bias = params
        if scale.dtype != bias.dtype or scale.shape != (c,) or bias.shape != (c,):
            raise ValueError(f"{name}: scale and bias must be (C,) of one dtype")
    if any(t.device != x.device for t in params):
        raise ValueError(f"{name}: x, scale and bias must be on one device")
    if not all(t.is_contiguous() for t in (x, *params)):
        raise ValueError(f"{name}: inputs must be contiguous")
    if c % groups or c > 1024 or s < 1:
        raise ValueError(f"{name}: unsupported shape {tuple(shape)} with {groups} groups")
    device = x.device.index or 0
    p_dtype = params[0].dtype if params else x.dtype
    aligned = x.data_ptr() % 16 == 0
    if grad is not None:
        if grad.shape != shape or grad.dtype != x.dtype or grad.device != x.device \
                or not grad.is_contiguous():
            raise ValueError(f"{name}: the gradient must be contiguous, of x's shape and dtype")
        aligned = aligned and grad.data_ptr() % 16 == 0
    plan = group_norm_plan(b, s, c, groups, x.dtype, p_dtype, aligned, cluster_limit(device),
                           grad is not None)
    return b, s, c, device, plan


def _plan_args(plan: GroupNormPlan) -> tuple:
    return (plan.slice_channels, plan.cluster, plan.chunk_rows, plan.rows_per_pass,
            plan.threads, plan.vec, int(plan.resident))


def _launch(x, scale, bias, groups: int, eps: float, apply_silu: bool):
    b, s, c, device, plan = _checked_plan("group_norm_silu", x, groups, (scale, bias))
    out = torch.empty_like(x)
    err = _lib()(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], b, s, c, groups, eps,
        int(apply_silu), *_plan_args(plan), device, torch._C._cuda_getCurrentRawStream(device),
    )
    if err:
        raise RuntimeError(f"group_norm_silu: kernel launch failed with CUDA error {err}")
    group_norm_silu.launches += 1
    return out


def _launch_backward(x, grad, scale, bias, groups: int, eps: float, apply_silu: bool):
    """(dx, dscale, dbias) from the kernel's backward entry: one launch, then the sum of its
    per-block partials (B * cluster, 2, C) in f32, in a fixed order.  A transposed gradient
    (the 1D ``Norm32``'s, from a channels-first convolution) is made contiguous first."""
    dy = grad.contiguous()
    b, s, c, device, plan = _checked_plan("group_norm_silu_backward", x, groups, (scale, bias),
                                          dy)
    dx = torch.empty_like(x)
    part = torch.empty((b * plan.cluster, 2, c), dtype=torch.float32, device=x.device)
    err = _bwd_lib()(
        x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(), dx.data_ptr(),
        part.data_ptr(), _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], b, s, c, groups, eps,
        int(apply_silu), *_plan_args(plan), device, torch._C._cuda_getCurrentRawStream(device),
    )
    if err:
        raise RuntimeError(f"group_norm_silu_backward: kernel launch failed with CUDA error {err}")
    group_norm_silu.backward_launches += 1
    dscale, dbias = part.sum(0).to(scale.dtype)
    return dx, dscale, dbias


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
        x, scale, bias = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        with span("group_norm_silu_backward"):
            if x.device.type == "cpu":
                inputs = [t.detach().requires_grad_(need)
                          for t, need in zip((x, scale, bias), needs)]
                with torch.enable_grad():
                    out = group_norm_silu_plain(*inputs, *ctx.config)
                    grads = iter(torch.autograd.grad(
                        out, [t for t in inputs if t.requires_grad], grad))
                grads = [next(grads) if need else None for need in needs]
            else:
                grads = _launch_backward(x, grad, scale, bias, *ctx.config)
        group_norm_silu.backward_calls += 1
        return (*(g if need else None for g, need in zip(grads, needs)), None, None, None)


def group_norm_silu(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                    apply_silu: bool = True):
    """Fused f32 GroupNorm + affine + optional SiLU over channels-last
    ``(B, *spatial, C)``; returns the input's shape and dtype."""
    with span("group_norm_silu"):
        return _GroupNormSiLU.apply(x, scale, bias, groups, eps, apply_silu)


group_norm_silu.launches = 0
group_norm_silu.backward_launches = 0
group_norm_silu.backward_calls = 0


# ---- statistics and normalisation apart, for rows split over ranks ----------------------------


def group_norm_stats_plain(x, groups: int = 32) -> torch.Tensor:
    """Each (sample, group)'s element count, mean and M2 (the sum of squared deviations
    from that mean) over (B, *spatial, C): a (B, G, 3) float32 tensor, two-pass."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    mean = xf.mean(dim=(1, 3))
    m2 = ((xf - mean[:, None, :, None]) ** 2).sum(dim=(1, 3))
    count = torch.full_like(mean, xf.shape[1] * xf.shape[3])
    return torch.stack([count, mean, m2], dim=-1)


def merge_group_stats(parts, eps: float = 1e-5):
    """(mean, rstd), each (B, G) float32, of the union of the shards whose statistics
    ``parts`` (K, B, G, 3) holds (``group_norm_stats`` of each): Chan's formula for the
    parallel variance, mean = sum n_k m_k / n and M2 = sum M2_k + sum n_k (m_k - mean)^2."""
    count, means, m2 = parts.unbind(-1)
    n = count.sum(0)
    mean = (count * means).sum(0) / n
    var = (m2.sum(0) + (count * (means - mean) ** 2).sum(0)) / n
    return mean, torch.rsqrt(var + eps)


def group_norm_apply_plain(x, mean, rstd, scale, bias, groups: int = 32,
                           apply_silu: bool = True):
    """(x - mean) rstd (each (B, G) float32, broadcast over a group's channels), then the
    affine and the optional SiLU, in f32; the input's shape and dtype out."""
    shape, c = x.shape, x.shape[-1]
    xf = x.float().reshape(shape[0], -1, groups, c // groups)
    xn = ((xf - mean[:, None, :, None]) * rstd[:, None, :, None]).reshape(shape[0], -1, c)
    out = xn * scale.float() + bias.float()
    if apply_silu:
        out = F.silu(out)
    return out.reshape(shape).to(x.dtype)


def group_norm_stats(x, groups: int = 32) -> torch.Tensor:
    """``group_norm_stats_plain``: the kernel's statistics mode on a CUDA tensor (one
    launch, the plan of ``group_norm_silu``), the plain version on a CPU one."""
    if x.device.type == "cpu":
        return group_norm_stats_plain(x, groups)
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm_stats: no kernel for device {x.device}")
    b, s, c, device, plan = _checked_plan("group_norm_stats", x, groups)
    out = torch.empty((b, groups, 3), dtype=torch.float32, device=x.device)
    err = _entry("tq_group_norm_stats", 2, 13)(
        x.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype], b, s, c, groups,
        *_plan_args(plan), device, torch._C._cuda_getCurrentRawStream(device))
    if err:
        raise RuntimeError(f"group_norm_stats: kernel launch failed with CUDA error {err}")
    group_norm_stats.launches += 1
    return out


def group_norm_apply(x, mean, rstd, scale, bias, groups: int = 32, apply_silu: bool = True):
    """``group_norm_apply_plain``: the kernel's normalisation mode on a CUDA tensor (one
    launch, the plan of ``group_norm_silu``), the plain version on a CPU one."""
    if x.device.type == "cpu":
        return group_norm_apply_plain(x, mean, rstd, scale, bias, groups, apply_silu)
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm_apply: no kernel for device {x.device}")
    b, s, c, device, plan = _checked_plan("group_norm_apply", x, groups, (scale, bias))
    mean_rstd = torch.stack([mean, rstd], dim=-1).float().contiguous()
    if mean_rstd.shape != (b, groups, 2) or mean_rstd.device != x.device:
        raise ValueError(f"group_norm_apply: mean and rstd must be ({b}, {groups}) on "
                         f"{x.device}")
    out = torch.empty_like(x)
    err = _entry("tq_group_norm_apply", 5, 15)(
        x.data_ptr(), mean_rstd.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], b, s, c, groups, int(apply_silu),
        *_plan_args(plan), device, torch._C._cuda_getCurrentRawStream(device))
    if err:
        raise RuntimeError(f"group_norm_apply: kernel launch failed with CUDA error {err}")
    group_norm_apply.launches += 1
    return out


group_norm_stats.launches = 0
group_norm_apply.launches = 0


class _ShardedGroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, apply_silu, gather):
        ctx.save_for_backward(x, scale, bias)
        ctx.config = (groups, eps, apply_silu, gather)
        mean, rstd = merge_group_stats(gather(group_norm_stats(x, groups)), eps)
        return group_norm_apply(x, mean, rstd, scale, bias, groups, apply_silu)

    @staticmethod
    def backward(ctx, grad):
        groups, eps, apply_silu, gather = ctx.config
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        x = inputs[0]
        if not x.requires_grad:  # the gathered statistics carry other shards' gradients
            x.requires_grad_(True)
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad(), span("group_norm_silu_backward"):
            mean, rstd = merge_group_stats(gather(group_norm_stats_plain(x, groups)), eps)
            out = group_norm_apply_plain(x, mean, rstd, *inputs[1:], groups, apply_silu)
            grads = dict(zip(map(id, wanted), torch.autograd.grad(out, wanted, grad)))
        group_norm_silu.backward_calls += 1
        return (*(grads[id(t)] if need else None
                  for t, need in zip(inputs, ctx.needs_input_grad[:3])),
                None, None, None, None)


def group_norm_silu_sharded(x, scale, bias, groups: int, eps: float, apply_silu: bool, gather):
    """``group_norm_silu`` of a tensor whose rows (dim 1 of (B, *spatial, C)) are one shard of
    the whole: ``gather`` maps this shard's (B, G, 3) statistics to every shard's (K, B, G, 3),
    through a differentiable collective.  Its shape and dtype out."""
    return _ShardedGroupNormSiLU.apply(x, scale, bias, groups, eps, apply_silu, gather)
