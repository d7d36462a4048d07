"""Conditional UNet for EDM diffusion: the port of ``tqdne_tpu/models/unet.py``.

Same topology and parameter names as the flax module: Gaussian-Fourier time
embedding -> 4x-width MLP, plus the conditioning MLP on the raw features,
a down path of ResBlocks with attention at the configured downsample rates,
a Res-Attn-Res middle, an up path with skip concatenation and a zero-init
output convolution.  The public ``forward`` takes and returns the JAX
layout, (B, *spatial, C); the output is float32.

It ports the flagship configuration (no scale-shift norm, no per-feature
conditioning embedding, no remat) for sampling and training: dropout is
active in ``train()`` mode, and ``nn.layers.set_compute_dtype`` gives it the
JAX module's ``dtype`` (bf16 compute over float32 parameters).  GroupNorm
and attention always take the fused kernels, which is the JAX
``use_pallas_norm=True, use_pallas_attention=True`` route; both are
differentiable.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tqdne_tpu_torch.nn.attention import AttentionBlock
from tqdne_tpu_torch.nn.layers import (
    MLP,
    Dense,
    Downsample,
    GaussianFourierProjection,
    Norm32,
    Upsample,
    conv_nd,
)


class ResBlock(nn.Module):
    """norm -> SiLU -> conv, + projected embedding, norm -> SiLU -> dropout
    -> zero-init conv, plus an identity or 1x1-conv skip."""

    def __init__(self, channels: int, emb_channels: int, dropout: float = 0.0,
                 out_channels: int | None = None, kernel_size: int = 3, dims: int = 2):
        super().__init__()
        out_ch = out_channels or channels
        self.in_norm = Norm32(channels, silu=True)
        self.in_conv = conv_nd(dims, channels, out_ch, kernel_size)
        self.emb_proj = Dense(emb_channels, out_ch)
        self.out_norm = Norm32(out_ch, silu=True)
        self.dropout = nn.Dropout(dropout)
        self.out_conv = conv_nd(dims, out_ch, out_ch, kernel_size)
        self.skip = None if out_ch == channels else conv_nd(dims, channels, out_ch, 1)

    def forward(self, x, emb):
        h = self.in_conv(self.in_norm(x))
        emb_out = self.emb_proj(F.silu(emb)).to(h.dtype)
        h = h + emb_out.reshape(emb_out.shape + (1,) * (h.ndim - 2))
        h = self.out_conv(self.dropout(self.out_norm(h)))
        skip = x if self.skip is None else self.skip(x)
        return skip + h


class UNet(nn.Module):
    """The conditional UNet; ``forward(x, timesteps, cond)`` over the JAX
    layout (B, *spatial, C) -> float32 (B, *spatial, out_channels)."""

    def __init__(
        self,
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int,
        attention_resolutions: Sequence[int] = (8, 16, 32),
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        conv_kernel_size: int = 3,
        dims: int = 2,
        cond_features: int | None = None,
        num_heads: int = 1,
        use_causal_mask: bool = False,
    ):
        super().__init__()
        m = model_channels
        embed_dim = 4 * m
        k = conv_kernel_size
        self.cond_features = cond_features
        self.time_embed = GaussianFourierProjection(m)
        self.time_mlp = MLP(m, embed_dim, embed_dim)
        if cond_features is not None:
            self.cond_mlp = MLP(cond_features, embed_dim, embed_dim)

        def attn(ch):
            return AttentionBlock(ch, num_heads, dims, use_causal_mask)

        ch = int(channel_mult[0] * m)
        self.in_conv = conv_nd(dims, in_channels, ch, k)
        skip_channels = [ch]
        # each step is a list of attribute names run in order; every down step
        # pushes one skip, every up step pops one before its ResBlock
        self.down_steps, self.up_steps = [], []
        ds, block = 1, 0
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                step = [self._add(f"down_{block}_res",
                                  ResBlock(ch, embed_dim, dropout, int(mult * m), k, dims))]
                ch = int(mult * m)
                if ds in attention_resolutions:
                    step.append(self._add(f"down_{block}_attn", attn(ch)))
                self.down_steps.append(step)
                skip_channels.append(ch)
                block += 1
            if level != len(channel_mult) - 1:
                self.down_steps.append([self._add(f"down_{block}_downsample",
                                                  Downsample(ch, dims, ch))])
                skip_channels.append(ch)
                ds *= 2
                block += 1

        self.mid_res1 = ResBlock(ch, embed_dim, dropout, None, k, dims)
        self.mid_attn = attn(ch)
        self.mid_res2 = ResBlock(ch, embed_dim, dropout, None, k, dims)

        block = 0
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                step = [self._add(f"up_{block}_res", ResBlock(
                    ch + skip_channels.pop(), embed_dim, dropout, int(mult * m), k, dims))]
                ch = int(mult * m)
                if ds in attention_resolutions:
                    step.append(self._add(f"up_{block}_attn", attn(ch)))
                if level and i == num_res_blocks:
                    step.append(self._add(f"up_{block}_upsample", Upsample(ch, dims, ch, k)))
                    ds //= 2
                self.up_steps.append(step)
                block += 1

        self.out_norm = Norm32(ch, silu=True)
        self.out_conv = conv_nd(dims, ch, out_channels, k)

    def _add(self, name: str, module: nn.Module) -> str:
        self.add_module(name, module)
        return name

    def _run(self, step, h, emb):
        for name in step:
            module = getattr(self, name)
            h = module(h, emb) if isinstance(module, ResBlock) else module(h)
        return h

    def forward(self, x, timesteps, cond=None):
        if (cond is not None) != (self.cond_features is not None):
            raise ValueError("must specify cond iff the model is conditioned")
        emb = self.time_mlp(self.time_embed(timesteps))
        if cond is not None:
            emb = emb + self.cond_mlp(cond.to(x.dtype))

        h = self.in_conv(x.movedim(-1, 1))
        hs = [h]
        for step in self.down_steps:
            h = self._run(step, h, emb)
            hs.append(h)
        h = self.mid_res2(self.mid_attn(self.mid_res1(h, emb)), emb)
        for step in self.up_steps:
            h = self._run(step, torch.cat([h, hs.pop()], dim=1), emb)
        h = self.out_conv(self.out_norm(h))
        return h.movedim(1, -1).float()
