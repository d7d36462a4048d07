"""Plain PyTorch forward passes of the HighFEM networks, in float32.

Functional: every function reads its weights from a dict of tensors keyed by
the published (flax-scope) parameter names, e.g. ``down_0_res.in_conv.weight``.
Activations are channels-first (B, C, *spatial); ``unet`` and ``decode`` take
and return the channels-last layout (B, *spatial, C) of the published code.

- ``unet``: the conditional UNet of arXiv 2410.19343 (Gaussian-Fourier time
  embedding -> 4x MLP, the conditioning MLP, ResBlocks with GroupNorm(32) +
  SiLU, attention at the listed downsample rates with q and k scaled by
  d^-1/4, a Res-Attn-Res middle, skip concatenation, nearest upsampling).
- ``decode``: the KL autoencoder's decoder.

``Ops`` carries what a caller may change: ``dropout`` masks, consumed in the
forward's order (one per ResBlock), and ``lowp``, a rounding applied to both
operands of every convolution, linear layer and attention product (the
benchmark's lower-precision control).  The reference imports nothing of the
program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import torch
import torch.nn.functional as F


@dataclass
class Ops:
    dropout_p: float = 0.0
    masks: list = field(default_factory=list)  # one {0, 1} mask per ResBlock, in forward order
    lowp: Callable | None = None

    def q(self, x):
        return x if self.lowp is None else self.lowp(x)

    def drop(self, h):
        if not self.masks:
            return h
        return h * self.masks.pop(0).to(h.dtype) / (1.0 - self.dropout_p)


def group_norm(x, weight, bias, silu: bool, eps: float = 1e-5):
    groups = math.gcd(32, x.shape[1])
    h = F.group_norm(x.float(), groups, weight.float(), bias.float(), eps)
    return F.silu(h) if silu else h


def conv(P, name, x, ops: Ops, stride: int = 1):
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    pad = w.shape[-1] // 2
    fn = F.conv1d if w.ndim == 3 else F.conv2d
    return fn(ops.q(x), ops.q(w), b, stride=stride, padding=pad)


def linear(P, name, x, ops: Ops):
    return F.linear(ops.q(x), ops.q(P[f"{name}.weight"]), P[f"{name}.bias"])


def mlp(P, name, x, ops: Ops):
    return linear(P, f"{name}.fc2", F.silu(linear(P, f"{name}.fc1", x, ops)), ops)


def fourier(W, t):
    h = t[..., None].float() * W.float() * (2 * math.pi)
    return torch.cat([torch.sin(h), torch.cos(h)], dim=-1)


def res_block(P, name, x, emb, ops: Ops):
    h = conv(P, f"{name}.in_conv", group_norm(x, P[f"{name}.in_norm.weight"],
                                              P[f"{name}.in_norm.bias"], True), ops)
    e = linear(P, f"{name}.emb_proj", F.silu(emb), ops)
    h = h + e.reshape(e.shape + (1,) * (h.ndim - 2))
    h = group_norm(h, P[f"{name}.out_norm.weight"], P[f"{name}.out_norm.bias"], True)
    h = conv(P, f"{name}.out_conv", ops.drop(h), ops)
    skip = conv(P, f"{name}.skip", x, ops) if f"{name}.skip.weight" in P else x
    return skip + h


def plain_res_block(P, name, x, ops: Ops):
    h = conv(P, f"{name}.in_conv", group_norm(x, P[f"{name}.in_norm.weight"],
                                              P[f"{name}.in_norm.bias"], True), ops)
    h = group_norm(h, P[f"{name}.out_norm.weight"], P[f"{name}.out_norm.bias"], True)
    h = conv(P, f"{name}.out_conv", ops.drop(h), ops)
    skip = conv(P, f"{name}.skip", x, ops) if f"{name}.skip.weight" in P else x
    return skip + h


def attention(P, name, x, heads: int, ops: Ops):
    b, c, *size = x.shape
    h = group_norm(x, P[f"{name}.norm.weight"], P[f"{name}.norm.bias"], False)
    qkv = conv(P, f"{name}.qkv", h, ops).flatten(2).transpose(1, 2)  # (B, L, 3C)
    d = c // heads
    qkv = qkv.reshape(b, -1, 3, heads, d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) * (d ** -0.25 if i < 2 else 1.0) for i in range(3))
    logits = torch.matmul(ops.q(q), ops.q(k).transpose(-1, -2))  # (B, H, L, L)
    a = torch.matmul(ops.q(torch.softmax(logits, dim=-1)), ops.q(v))  # (B, H, L, D)
    a = a.transpose(1, 2).reshape(b, -1, c).transpose(1, 2).reshape(b, c, *size)
    return x + conv(P, f"{name}.proj_out", a, ops)


def upsample(P, name, x, ops: Ops):
    return conv(P, name, F.interpolate(x, scale_factor=2, mode="nearest"), ops)


def unet(P, cfg: dict, x, timesteps, cond, ops: Ops | None = None):
    """(B, *spatial, C_in) -> (B, *spatial, C_out) float32."""
    ops = ops or Ops()
    mult, nrb = cfg["channel_mult"], cfg["num_res_blocks"]
    attn_at, heads = tuple(cfg["attention_resolutions"]), cfg["num_heads"]
    emb = mlp(P, "time_mlp", fourier(P["time_embed.W"], timesteps), ops)
    if cond is not None:
        emb = emb + mlp(P, "cond_mlp", cond.float(), ops)
    h = conv(P, "in_conv", x.movedim(-1, 1).float(), ops)
    hs, ds, block = [h], 1, 0
    for level in range(len(mult)):
        for _ in range(nrb):
            h = res_block(P, f"down_{block}_res", h, emb, ops)
            if ds in attn_at:
                h = attention(P, f"down_{block}_attn", h, heads, ops)
            hs.append(h)
            block += 1
        if level != len(mult) - 1:
            h = conv(P, f"down_{block}_downsample.op", h, ops, stride=2)
            hs.append(h)
            ds *= 2
            block += 1
    h = res_block(P, "mid_res1", h, emb, ops)
    h = attention(P, "mid_attn", h, heads, ops)
    h = res_block(P, "mid_res2", h, emb, ops)
    block = 0
    for level in reversed(range(len(mult))):
        for i in range(nrb + 1):
            h = res_block(P, f"up_{block}_res", torch.cat([h, hs.pop()], dim=1), emb, ops)
            if ds in attn_at:
                h = attention(P, f"up_{block}_attn", h, heads, ops)
            if level and i == nrb:
                h = upsample(P, f"up_{block}_upsample.conv", h, ops)
                ds //= 2
            block += 1
    h = group_norm(h, P["out_norm.weight"], P["out_norm.bias"], True)
    return conv(P, "out_conv", h, ops).movedim(1, -1)


def decode(P, cfg: dict, z, ops: Ops | None = None):
    """The autoencoder's decoder: (B, *latent, C) -> (B, *spatial, C_out) float32.
    ``P`` holds the decoder's weights under the ``decoder.`` prefix."""
    ops = ops or Ops()
    D = {k[len("decoder."):]: v for k, v in P.items() if k.startswith("decoder.")}
    mult, nrb = cfg["channel_mult"], cfg["num_res_blocks"]
    h = conv(D, "in_conv", z.movedim(-1, 1).float(), ops)
    block = 0
    for level in reversed(range(len(mult))):
        if level != len(mult) - 1:
            h = upsample(D, f"up_{block}_upsample.conv", h, ops)
            block += 1
        for _ in range(nrb):
            h = plain_res_block(D, f"up_{block}_res", h, ops)
            block += 1
    return conv(D, "out_conv", h, ops).movedim(1, -1)


def res_block_shapes(cfg: dict, batch: int, spatial: tuple[int, ...]) -> list[tuple]:
    """(batch, channels, *spatial) of each UNet ResBlock's dropout input, in the
    forward's order."""
    mult, nrb, m = cfg["channel_mult"], cfg["num_res_blocks"], cfg["model_channels"]
    size, shapes = list(spatial), []
    for level, mu in enumerate(mult):
        shapes += [(batch, mu * m, *size)] * nrb
        if level != len(mult) - 1:
            size = [-(-s // 2) for s in size]
    shapes += [(batch, mult[-1] * m, *size)] * 2
    for level in reversed(range(len(mult))):
        shapes += [(batch, mult[level] * m, *size)] * (nrb + 1)
        if level:
            size = [s * 2 for s in size]
    return shapes
