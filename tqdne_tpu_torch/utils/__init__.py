"""Small shared helpers."""

from __future__ import annotations

import numpy as np
import torch


def append_dims(x: torch.Tensor, target_ndim: int) -> torch.Tensor:
    """Append trailing singleton dims so ``x`` broadcasts against a
    ``target_ndim``-dimensional tensor."""
    return x.reshape(x.shape + (1,) * (target_ndim - x.ndim))


def fold_seed(seed: int, offset: int) -> int:
    """A 63-bit generator seed from a request seed and an offset: the port's
    ``jax.random.fold_in(jax.random.key(seed), offset)``.  A negative seed
    is taken modulo 2**64, as ``SeedSequence`` takes no negative entropy."""
    return int(np.random.SeedSequence([seed % 2**64, offset]).generate_state(1, np.uint64)[0]
               >> 1)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; ``cuda`` without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available "
                           "(pass device='cpu' to run the plain versions on the CPU)")
    return device


@torch.no_grad()
def randomize_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill every parameter from a seeded normal, zero-init layers included,
    so an untrained model computes something non-trivial: weights with
    fan-in n get std 1/sqrt(n), norm scales 1 + 0.1 N(0, 1), the Fourier
    frequencies keep their module's N(0, scale^2) and other vectors 0.05 N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        draw = torch.randn(p.shape, generator=gen, dtype=torch.float32)
        if name.endswith("W"):
            draw = draw * module.get_submodule(name.rpartition(".")[0]).scale
        elif p.ndim >= 2:
            draw = draw / (p[0].numel() ** 0.5)
        elif name.endswith("norm.weight"):
            draw = 1 + 0.1 * draw
        else:
            draw = 0.05 * draw
        p.copy_(draw)
    return module


# attribute names of the layers the JAX UNet creates with zero_init=True, and of DiT's
# adaLN-Zero modulations and final dense layer
_ZERO_INIT = ("out_conv", "proj_out", "adaLN_modulation", "linear")


@torch.no_grad()
def init_like_flax_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Initialise as the JAX modules' ``init`` does (the draws differ): conv and
    dense weights lecun-normal (truncated at 2 sigma), biases zero, the UNet's
    zero-init layers (``out_conv``, ``proj_out``) and DiT's (``adaLN_modulation``,
    ``final_layer.linear``) zero, norms 1 and 0, and the
    Fourier frequencies N(0, scale^2)."""
    from tqdne_tpu_torch.nn.layers import GaussianFourierProjection, Norm32, _Cast

    gen = torch.Generator().manual_seed(seed)
    for name, m in module.named_modules():
        if isinstance(m, _Cast):
            if name.rsplit(".", 1)[-1] in _ZERO_INIT:
                m.weight.zero_()
            else:
                std = (m.weight[0].numel() ** -0.5) / 0.87962566103423978
                torch.nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                            generator=gen)
            m.bias.zero_()
        elif isinstance(m, Norm32):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, GaussianFourierProjection):
            m.W.copy_(torch.randn(m.W.shape, generator=gen) * m.scale)
    return module
