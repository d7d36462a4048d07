"""Plain float32 PyTorch DiT (Peebles & Xie, arXiv 2212.09748; facebookresearch/DiT
``models.py``) as the ``latent_dit`` recipe uses it, for the port's tests: the
forward over a dict of weights, the EDM preconditioning, Heun's sampler and
the EDM loss.  It imports nothing of the port and no JAX; matrix products run
with TF32 off.

Weights are keyed by the port's parameter names (``x_embedder``,
``time_embed.W``, ``time_mlp.fc1``, ``cond_mlp.fc2``, ``blocks.<i>.attn.qkv``,
``blocks.<i>.mlp.fc1``, ``blocks.<i>.adaLN_modulation``,
``final_layer.linear``, ...), each dense weight (out, in).

Departures from the published DiT, all the recipe's own:
- the noise level enters as ``c_noise = ln(sigma) / 4`` through a Gaussian
  Fourier projection (2 pi t W, [sin, cos], frozen W) and an MLP with SiLU,
  in place of the sinusoidal timestep embedder (whose MLP is also SiLU);
- the conditioning is an MLP of the five normalised features added to the
  time embedding, in place of the class-label table, with no label dropout
  and no classifier-free guidance;
- the output has the input's channels: no learned variance (EDM predicts
  none);
- the patch embedding is a dense layer over each patch flattened as
  (row, column, channel) of the channels-last latent, which is the published
  stride-p convolution with its kernel's entries in another order.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

SIGMA_MIN, SIGMA_MAX, RHO, SIGMA_DATA = 0.002, 80.0, 7.0, 0.5
P_MEAN, P_STD = -1.2, 1.2


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def linear(P, name, x):
    return F.linear(x, P[f"{name}.weight"], P[f"{name}.bias"])


def pos_embed(channels: int, grid: int) -> torch.Tensor:
    """``get_2d_sincos_pos_embed(channels, grid)`` of the published code,
    written from its numpy: (grid^2, channels)."""
    def one_d(dim, pos):
        omega = torch.arange(dim // 2, dtype=torch.float64) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = pos.reshape(-1)[:, None] * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    gh = torch.arange(grid, dtype=torch.float64)
    gw = torch.arange(grid, dtype=torch.float64)
    grid_w, grid_h = torch.meshgrid(gw, gh, indexing="xy")  # numpy's meshgrid(w, h)
    emb_h = one_d(channels // 2, grid_w)
    emb_w = one_d(channels // 2, grid_h)
    return torch.cat([emb_h, emb_w], dim=1).float()


def layer_norm(x, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def modulate(x, shift, scale):
    return layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


def attention(P, name, x, heads):
    b, n, c = x.shape
    qkv = linear(P, f"{name}.qkv", x).reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (B, H, N, D)
    attn = torch.softmax(q @ k.transpose(-2, -1) * (c // heads) ** -0.5, dim=-1)
    return linear(P, f"{name}.proj", (attn @ v).transpose(1, 2).reshape(b, n, c))


def mlp(P, name, x, act):
    return linear(P, f"{name}.fc2", act(linear(P, f"{name}.fc1", x)))


def dit(P, cfg: dict, x, t, cond):
    """(B, H, W, C) f32 latent, c_noise (B,), normalised features (B, 5) ->
    (B, H, W, C_out)."""
    with no_tf32():
        p, hidden, heads = cfg["patch_size"], cfg["hidden_size"], cfg["num_heads"]
        b, h, w, ch = x.shape
        gh, gw = h // p, w // p
        tokens = x.float().reshape(b, gh, p, gw, p, ch).permute(0, 1, 3, 2, 4, 5)
        x = linear(P, "x_embedder", tokens.reshape(b, gh * gw, p * p * ch))
        x = x + pos_embed(hidden, gh).to(x.device)
        arg = t.float()[:, None] * P["time_embed.W"][None] * (2 * math.pi)
        c = mlp(P, "time_mlp", torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1), F.silu)
        c = F.silu(c + mlp(P, "cond_mlp", cond.float(), F.silu))
        for i in range(cfg["depth"]):
            name = f"blocks.{i}"
            s1, a1, g1, s2, a2, g2 = linear(P, f"{name}.adaLN_modulation", c).chunk(6, dim=1)
            x = x + g1[:, None] * attention(P, f"{name}.attn", modulate(x, s1, a1), heads)
            x = x + g2[:, None] * mlp(P, f"{name}.mlp", modulate(x, s2, a2),
                                      lambda y: F.gelu(y, approximate="tanh"))
        shift, scale = linear(P, "final_layer.adaLN_modulation", c).chunk(2, dim=1)
        out = linear(P, "final_layer.linear", modulate(x, shift, scale))
        out = out.reshape(b, gh, gw, p, p, -1).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, h, w, -1)


def denoise(net, x, sigma):
    """EDM: c_skip x + c_out F(c_in x, ln(sigma) / 4); sigma (B,)."""
    s = sigma.reshape(-1, *(1,) * (x.ndim - 1))
    s2 = s**2 + SIGMA_DATA**2
    out = net(x / s2.sqrt(), 0.25 * torch.log(sigma))
    return out * (s * SIGMA_DATA / s2.sqrt()) + x * (SIGMA_DATA**2 / s2)


def heun(net, noise, num_steps: int):
    """The deterministic Heun sampler over the rho-spaced grid (2N - 1 evals)."""
    a, b = SIGMA_MAX ** (1 / RHO), SIGMA_MIN ** (1 / RHO)
    sig = [(a + i / (num_steps - 1) * (b - a)) ** RHO for i in range(num_steps)] + [0.0]
    x = noise.float() * sig[0]

    def d(x, s):
        return denoise(net, x, torch.full((x.shape[0],), s, dtype=torch.float32))

    for s, s_next in zip(sig[:-1], sig[1:]):
        d_cur = (x - d(x, s)) / s
        x_euler = x + d_cur * (s_next - s)
        if s_next > 0:
            x = x + (s_next - s) * (0.5 * d_cur + 0.5 * (x_euler - d(x_euler, s_next)) / s_next)
        else:
            x = x_euler
    return x


def edm_loss(net, sample, sigma_eps, noise):
    """The lambda(sigma)-weighted MSE of D(x + sigma n, sigma) against x."""
    sigma = torch.exp(sigma_eps * P_STD + P_MEAN)
    s = sigma.reshape(-1, *(1,) * (sample.ndim - 1))
    weight = (s**2 + SIGMA_DATA**2) / (s * SIGMA_DATA) ** 2
    return torch.mean((denoise(net, sample + noise * s, sigma) - sample) ** 2 * weight)
