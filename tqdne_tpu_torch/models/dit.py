"""DiT (Peebles & Xie, arXiv 2212.09748; facebookresearch/DiT ``models.py``) as
an EDM denoiser over a channels-last latent, with the UNet's signature:
``forward(x, timesteps, cond)`` on (B, H, W, C) -> float32 (B, H, W, C_out),
so ``diffusion.edm.precondition``, the samplers and the train steps take it
as they take the UNet.  The JAX package has no counterpart.

- patchify: the p x p patches of the latent, each (p, p, C) flattened, through
  a dense layer to the hidden size (the published stride-p convolution), plus
  fixed 2D sin-cos positions over the patch grid (a buffer, not a parameter);
- the conditioning ``c``: the port's own embeddings, as the UNet's (a
  Gaussian-Fourier projection of the noise level through an MLP, plus an MLP
  of the normalised features), in place of the published sinusoidal timestep
  embedder and class table;
- ``depth`` adaLN-Zero blocks: six per-sample vectors (shift, scale and gate,
  twice) from a dense layer over SiLU(c); ``x + g1 attn(modulate(x, s1, a1))``,
  then ``x + g2 mlp(modulate(x, s2, a2))``; ``modulate`` is LayerNorm without
  affine (eps 1e-6, f32 statistics) then ``x (1 + scale) + shift``; the MLP
  is dense, tanh-GELU, dense;
- the final layer: ``modulate`` by a shift and scale from SiLU(c), a dense
  layer to p x p x C_out, and unpatchify.  No learned variance (EDM predicts
  none), no label dropout or guidance (the port's samplers are unguided).

Dense layers compute in ``compute_dtype`` over their parameters
(``nn.layers.set_compute_dtype``), the token stream in that dtype.  The adaLN
and final dense layers are the ones DiT initialises to zero
(``utils.init_like_flax_`` does so by their names).  ``DiT.forwards`` counts
forward calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tqdne_tpu_torch.nn.attention import TokenAttention
from tqdne_tpu_torch.nn.layers import MLP, Dense, GaussianFourierProjection, gated_add, modulate
from tqdne_tpu_torch.utils.tracing import span


def sincos_2d(channels: int, grid: int) -> torch.Tensor:
    """DiT's ``get_2d_sincos_pos_embed``: (grid^2, channels) float32; token
    ``i * grid + j`` (row i, column j) takes [sin, cos] of column j over the
    first half of the channels and of row i over the second, at frequencies
    10000^(-k / (channels / 4))."""
    quarter = channels // 4
    omega = 1.0 / 10000 ** (torch.arange(quarter, dtype=torch.float64) / quarter)
    pos = torch.arange(grid, dtype=torch.float64)
    rows, cols = pos.repeat_interleave(grid), pos.repeat(grid)

    def one(p):
        out = p[:, None] * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    return torch.cat([one(cols), one(rows)], dim=1).float()


class FeedForward(nn.Module):
    """Dense -> tanh-GELU -> dense (timm's ``Mlp``)."""

    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(channels, hidden)
        self.fc2 = Dense(hidden, channels)

    def forward(self, x):
        with span("mlp"):
            return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    """An adaLN-Zero block over tokens (B, L, C) and SiLU(c) (B, C)."""

    def __init__(self, channels: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.attn = TokenAttention(channels, num_heads)
        self.mlp = FeedForward(channels, int(channels * mlp_ratio))
        self.adaLN_modulation = Dense(channels, 6 * channels)

    def forward(self, x, c):
        s1, a1, g1, s2, a2, g2 = self.adaLN_modulation(c).chunk(6, dim=1)
        x = gated_add(x, g1, self.attn(modulate(x, s1, a1)))
        return gated_add(x, g2, self.mlp(modulate(x, s2, a2)))


class FinalLayer(nn.Module):
    def __init__(self, channels: int, out: int):
        super().__init__()
        self.adaLN_modulation = Dense(channels, 2 * channels)
        self.linear = Dense(channels, out)

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=1)
        return self.linear(modulate(x, shift, scale))


class DiT(nn.Module):
    """The DiT denoiser; ``forward(x, timesteps, cond)`` over (B, H, W, C)
    with H = W = ``input_size``."""

    forwards = 0

    def __init__(self, input_size: int = 32, patch_size: int = 2, in_channels: int = 8,
                 out_channels: int = 8, hidden_size: int = 1152, depth: int = 28,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 frequency_embedding_size: int = 256, cond_features: int = 5):
        super().__init__()
        if input_size % patch_size:
            raise ValueError(f"patch {patch_size} does not tile the {input_size} grid")
        self.input_size, self.patch_size = input_size, patch_size
        patch = patch_size * patch_size
        self.x_embedder = Dense(patch * in_channels, hidden_size)
        self.register_buffer("pos_embed", sincos_2d(hidden_size, input_size // patch_size),
                             persistent=False)
        self.time_embed = GaussianFourierProjection(frequency_embedding_size)
        self.time_mlp = MLP(frequency_embedding_size, hidden_size, hidden_size)
        self.cond_mlp = MLP(cond_features, hidden_size, hidden_size)
        self.blocks = nn.ModuleList(DiTBlock(hidden_size, num_heads, mlp_ratio)
                                    for _ in range(depth))
        self.final_layer = FinalLayer(hidden_size, patch * out_channels)

    def forward(self, x, timesteps, cond):
        DiT.forwards += 1
        b, h, w, ch = x.shape
        p = self.patch_size
        tokens = x.reshape(b, h // p, p, w // p, p, ch).transpose(2, 3)
        x = self.x_embedder(tokens.reshape(b, (h // p) * (w // p), p * p * ch))
        x = x + self.pos_embed.to(x.dtype)
        c = F.silu(self.time_mlp(self.time_embed(timesteps)) + self.cond_mlp(cond))
        for block in self.blocks:
            x = block(x, c)
        out = self.final_layer(x, c).reshape(b, h // p, w // p, p, p, -1)
        return out.transpose(2, 3).reshape(b, h, w, -1).float()
