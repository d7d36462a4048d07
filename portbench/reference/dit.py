"""Plain PyTorch forward of DiT (arXiv 2212.09748; facebookresearch/DiT
``models.py``) as the ``latent_dit`` configuration runs it, in float32, and its
parameter list, {name: shape}, from the configuration's widths.

Functional: weights come from a dict of tensors keyed by the program's names
(``x_embedder``, ``time_embed.W``, ``time_mlp.fc1``, ``cond_mlp.fc2``,
``blocks.<i>.attn.qkv``, ``blocks.<i>.attn.proj``, ``blocks.<i>.mlp.fc1``,
``blocks.<i>.adaLN_modulation``, ``final_layer.adaLN_modulation``,
``final_layer.linear``), each dense weight (out, in).  ``dit`` takes and
returns the channels-last latent (B, H, W, C).

The configuration's departures from the published DiT: the noise level
``ln(sigma) / 4`` enters through a Gaussian Fourier projection and an MLP
(SiLU), the five normalised features through an MLP added to it, in place of
the sinusoidal timestep embedder and the class table; no label dropout, no
guidance; the output has the input's channels (no learned variance); the
patch embedding is a dense layer over each patch flattened as (row, column,
channel), the published stride-p convolution with its entries reordered.

``nets.Ops.lowp`` rounds both operands of every dense layer and of both
attention products (the benchmark's lower-precision control).  Imports
nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.nets import Ops, fourier, linear


def shapes(cfg: dict) -> dict:
    """{name: shape} of the DiT's parameters."""
    h, p = cfg["hidden_size"], cfg["patch_size"]
    hidden = int(h * cfg["mlp_ratio"])
    out = {}

    def dense(name, cin, cout):
        out[f"{name}.weight"] = (cout, cin)
        out[f"{name}.bias"] = (cout,)

    dense("x_embedder", p * p * cfg["in_channels"], h)
    out["time_embed.W"] = (cfg["frequency_embedding_size"] // 2,)
    dense("time_mlp.fc1", cfg["frequency_embedding_size"], h)
    dense("time_mlp.fc2", h, h)
    dense("cond_mlp.fc1", cfg["cond_features"], h)
    dense("cond_mlp.fc2", h, h)
    for i in range(cfg["depth"]):
        dense(f"blocks.{i}.attn.qkv", h, 3 * h)
        dense(f"blocks.{i}.attn.proj", h, h)
        dense(f"blocks.{i}.mlp.fc1", h, hidden)
        dense(f"blocks.{i}.mlp.fc2", hidden, h)
        dense(f"blocks.{i}.adaLN_modulation", h, 6 * h)
    dense("final_layer.adaLN_modulation", h, 2 * h)
    dense("final_layer.linear", h, p * p * cfg["out_channels"])
    return out


def pos_embed(channels: int, grid: int, device=None) -> torch.Tensor:
    """The published ``get_2d_sincos_pos_embed(channels, grid)``: token
    ``i * grid + j`` takes [sin, cos] of column j over the first half of the
    channels and of row i over the second; (grid^2, channels)."""
    def one_d(dim, pos):
        omega = 1.0 / 10000 ** (torch.arange(dim // 2, dtype=torch.float64) / (dim / 2.0))
        out = pos.reshape(-1)[:, None] * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    g = torch.arange(grid, dtype=torch.float64)
    cols, rows = torch.meshgrid(g, g, indexing="xy")
    return torch.cat([one_d(channels // 2, cols), one_d(channels // 2, rows)], dim=1).float().to(
        device)


def layer_norm(x, eps: float = 1e-6):
    mean = x.mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(((x - mean) ** 2).mean(-1, keepdim=True) + eps)


def modulate(x, shift, scale):
    return layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


def attention(P, name, x, heads: int, ops: Ops):
    b, n, c = x.shape
    d = c // heads
    qkv = linear(P, f"{name}.qkv", x, ops).reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * d**-0.25, qkv[1] * d**-0.25, qkv[2]  # (B, H, N, D)
    a = torch.softmax(torch.matmul(ops.q(q), ops.q(k).transpose(-1, -2)), dim=-1)
    a = torch.matmul(ops.q(a), ops.q(v))
    return linear(P, f"{name}.proj", a.transpose(1, 2).reshape(b, n, c), ops)


def dit(P, cfg: dict, x, timesteps, cond, ops: Ops | None = None):
    """(B, H, W, C) -> (B, H, W, C_out) float32."""
    ops = ops or Ops()
    p, hidden, heads = cfg["patch_size"], cfg["hidden_size"], cfg["num_heads"]
    b, h, w, ch = x.shape
    gh, gw = h // p, w // p
    tokens = x.float().reshape(b, gh, p, gw, p, ch).permute(0, 1, 3, 2, 4, 5)
    x = linear(P, "x_embedder", tokens.reshape(b, gh * gw, p * p * ch), ops)
    x = x + pos_embed(hidden, gh, x.device)
    c = linear(P, "time_mlp.fc2", F.silu(linear(P, "time_mlp.fc1",
                                                fourier(P["time_embed.W"], timesteps), ops)), ops)
    c = c + linear(P, "cond_mlp.fc2", F.silu(linear(P, "cond_mlp.fc1", cond.float(), ops)), ops)
    c = F.silu(c)
    for i in range(cfg["depth"]):
        name = f"blocks.{i}"
        s1, a1, g1, s2, a2, g2 = linear(P, f"{name}.adaLN_modulation", c, ops).chunk(6, dim=1)
        x = x + g1[:, None] * attention(P, f"{name}.attn", modulate(x, s1, a1), heads, ops)
        y = linear(P, f"{name}.mlp.fc1", modulate(x, s2, a2), ops)
        y = linear(P, f"{name}.mlp.fc2", F.gelu(y, approximate="tanh"), ops)
        x = x + g2[:, None] * y
    shift, scale = linear(P, "final_layer.adaLN_modulation", c, ops).chunk(2, dim=1)
    out = linear(P, "final_layer.linear", modulate(x, shift, scale), ops)
    out = out.reshape(b, gh, gw, p, p, -1).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, h, w, -1)
