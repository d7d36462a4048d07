"""Conditional UNet for EDM diffusion: the port of ``tqdne_tpu/models/unet.py``.

Same topology and parameter names as the flax module: Gaussian-Fourier time
embedding -> 4x-width MLP, plus the conditioning MLP on the features (raw,
or through a per-feature Fourier embedding ``cond_embed`` with
``cond_emb_scale``), a down path of ResBlocks with attention at the
configured downsample rates, a Res-Attn-Res middle, an up path with skip
concatenation and a zero-init output convolution.  The public ``forward``
takes and returns the JAX layout, (B, *spatial, C); the output is float32.

It takes the JAX module's options: ``use_scale_shift_norm`` (the embedding
scales and shifts the normalised activations), ``conv_resample=False``
(average-pool and repeat in place of the resampling convolutions) and
``use_checkpoint`` (each ResBlock recomputed in the backward, the JAX
``nn.remat``).  Dropout is active in ``train()`` mode, and
``nn.layers.set_compute_dtype`` gives it the JAX module's ``dtype`` (bf16
compute over float32 parameters).  GroupNorm and attention always take the
fused kernels, which is the JAX ``use_pallas_norm=True,
use_pallas_attention=True`` route; both are differentiable.

Under ``parallel.spatial.spatial_scope`` the input and the output are this
rank's rows of the sample (dim 1 of the JAX layout), and each step runs on
its rows where its level's extent splits over the shards, on all of them
where it does not (``SpatialScope.enter``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
from tqdne_tpu_torch.parallel import spatial


class ResBlock(nn.Module):
    """norm -> SiLU -> conv, + projected embedding (or, with
    ``use_scale_shift_norm``, norm -> x (1 + scale) + shift -> SiLU), norm ->
    SiLU -> dropout -> zero-init conv, plus an identity or 1x1-conv skip."""

    def __init__(self, channels: int, emb_channels: int, dropout: float = 0.0,
                 out_channels: int | None = None, kernel_size: int = 3, dims: int = 2,
                 use_scale_shift_norm: bool = False):
        super().__init__()
        out_ch = out_channels or channels
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_norm = Norm32(channels, silu=True)
        self.in_conv = conv_nd(dims, channels, out_ch, kernel_size)
        self.emb_proj = Dense(emb_channels, 2 * out_ch if use_scale_shift_norm else out_ch)
        self.out_norm = Norm32(out_ch, silu=not use_scale_shift_norm)
        self.dropout = nn.Dropout(dropout)
        self.out_conv = conv_nd(dims, out_ch, out_ch, kernel_size)
        self.skip = None if out_ch == channels else conv_nd(dims, channels, out_ch, 1)

    def forward(self, x, emb):
        emb_out = self.emb_proj(F.silu(emb))
        if self.use_scale_shift_norm:
            h = self.in_conv(self.in_norm(x))
            emb_out = emb_out.to(h.dtype)
            emb_out = emb_out.reshape(emb_out.shape + (1,) * (h.ndim - 2))
            # the JAX order and dtype: the normalised h (compute dtype) scaled and
            # shifted in that dtype, then the SiLU
            scale, shift = emb_out.chunk(2, dim=1)
            h = F.silu(self.out_norm(h) * (1 + scale) + shift)
        else:
            # the embedding added with the convolution's bias, in its epilogue
            h = self.out_norm(self.in_conv(self.in_norm(x), shift=emb_out))
        h = self.out_conv(self.dropout(h))
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
        conv_resample: bool = True,
        dims: int = 2,
        cond_features: int | None = None,
        cond_emb_scale: float | None = None,
        use_checkpoint: bool = False,
        num_heads: int = 1,
        use_scale_shift_norm: bool = False,
        use_causal_mask: bool = False,
    ):
        super().__init__()
        m = model_channels
        embed_dim = 4 * m
        k = conv_kernel_size
        self.cond_features = cond_features
        self.use_checkpoint = use_checkpoint
        self.time_embed = GaussianFourierProjection(m)
        self.time_mlp = MLP(m, embed_dim, embed_dim)
        self.cond_embed = None
        if cond_features is not None:
            if cond_emb_scale is not None:
                self.cond_embed = GaussianFourierProjection(m, cond_emb_scale)
            self.cond_mlp = MLP(cond_features * (m if cond_emb_scale is not None else 1),
                                embed_dim, embed_dim)

        def attn(ch):
            return AttentionBlock(ch, num_heads, dims, use_causal_mask)

        def res(ch, out_ch):
            return ResBlock(ch, embed_dim, dropout, out_ch, k, dims, use_scale_shift_norm)

        ch = int(channel_mult[0] * m)
        self.in_conv = conv_nd(dims, in_channels, ch, k)
        skip_channels = [ch]
        # each step is a list of attribute names run in order; every down step
        # pushes one skip, every up step pops one before its ResBlock
        self.down_steps, self.up_steps = [], []
        ds, block = 1, 0
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                step = [self._add(f"down_{block}_res", res(ch, int(mult * m)))]
                ch = int(mult * m)
                if ds in attention_resolutions:
                    step.append(self._add(f"down_{block}_attn", attn(ch)))
                self.down_steps.append(step)
                skip_channels.append(ch)
                block += 1
            if level != len(channel_mult) - 1:
                self.down_steps.append([self._add(f"down_{block}_downsample",
                                                  Downsample(ch, conv_resample, dims, ch))])
                skip_channels.append(ch)
                ds *= 2
                block += 1

        self.mid_res1 = res(ch, None)
        self.mid_attn = attn(ch)
        self.mid_res2 = res(ch, None)

        block = 0
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                step = [self._add(f"up_{block}_res", res(ch + skip_channels.pop(),
                                                         int(mult * m)))]
                ch = int(mult * m)
                if ds in attention_resolutions:
                    step.append(self._add(f"up_{block}_attn", attn(ch)))
                if level and i == num_res_blocks:
                    step.append(self._add(f"up_{block}_upsample",
                                          Upsample(ch, conv_resample, dims, ch, k)))
                    ds //= 2
                self.up_steps.append(step)
                block += 1

        self.out_norm = Norm32(ch, silu=True)
        self.out_conv = conv_nd(dims, ch, out_channels, k)

    def _add(self, name: str, module: nn.Module) -> str:
        self.add_module(name, module)
        return name

    def _res(self, module, h, emb):
        """A ResBlock; with ``use_checkpoint`` under autograd, recomputed in the
        backward instead of keeping its activations, with the RNG state the
        forward drew its dropout masks from."""
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(module, h, emb, use_reentrant=False, preserve_rng_state=True)
        return module(h, emb)

    def _run(self, step, h, emb):
        for name in step:
            module = getattr(self, name)
            h = self._res(module, h, emb) if isinstance(module, ResBlock) else module(h)
        return h

    def forward(self, x, timesteps, cond=None):
        if (cond is not None) != (self.cond_features is not None):
            raise ValueError("must specify cond iff the model is conditioned")
        emb = self.time_mlp(self.time_embed(timesteps))
        if cond is not None:
            c = cond.to(x.dtype)
            if self.cond_embed is not None:
                # (B, F) -> (B, F, M) -> (B, F*M): feature-major, each feature's [sin | cos]
                c = self.cond_embed(c).flatten(1)
            emb = emb + self.cond_mlp(c)

        scope = spatial.current()
        if scope is not None:
            return self._forward_spatial(scope, x, emb)
        h = self.in_conv(x.movedim(-1, 1))
        hs = [h]
        for step in self.down_steps:
            h = self._run(step, h, emb)
            hs.append(h)
        h = self._res(self.mid_res1, h, emb)
        h = self._res(self.mid_res2, self.mid_attn(h), emb)
        for step in self.up_steps:
            h = self._run(step, torch.cat([h, hs.pop()], dim=1), emb)
        h = self.out_conv(self.out_norm(h))
        return h.movedim(1, -1).float()

    def _forward_spatial(self, scope, x, emb):
        """``forward``'s body on this rank's rows of ``x`` under ``scope``."""
        halo = self.in_conv.kernel_size[0] // 2

        def run(fn, h, sharded, downsample=False, skip=None):
            h, sharded = scope.enter(h, sharded, halo, downsample)
            if skip is not None:
                h = torch.cat([h, scope.place(*skip, sharded)], dim=1)
            with scope.at(sharded):
                return fn(h), sharded

        h, sh = run(self.in_conv, x.movedim(-1, 1), True)
        hs = [(h, sh)]
        for step in self.down_steps:
            down = step[-1].endswith("downsample")
            h, sh = run(lambda t, step=step: self._run(step, t, emb), h, sh, down)
            hs.append((h, sh))
        h, sh = run(lambda t: self._res(self.mid_res2, self.mid_attn(
            self._res(self.mid_res1, t, emb)), emb), h, sh)
        for step in self.up_steps:
            h, sh = run(lambda t, step=step: self._run(step, t, emb), h, sh, skip=hs.pop())
        h, sh = run(lambda t: self.out_conv(self.out_norm(t)), h, sh)
        return scope.place(h, sh, True).movedim(1, -1).float()
