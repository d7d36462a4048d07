"""Operations and bytes the work needs, from the configuration's shapes, and
the card's published peaks: the yardstick of ``mfu.*`` and the rooflines.

Model FLOPs count convolutions, linear layers and attention's two products
(``4 L^2 D H`` a sample), 2 a multiply-add, every kernel position included
(as ``torch.utils.flop_counter`` counts them); norms, activations,
resampling and the inversion are not model FLOPs.  A training step is the
forward and its backward: twice each product's forward for its input and
weight gradients, less the input gradient that no leaf needs (the first
convolution's and the first layers of the two embedding MLPs).
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM, dense (data sheet; at its 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def conv(b, cin, cout, k, dims, out):
    return 2 * b * cin * cout * k**dims * math.prod(out)


def _half(size):
    return [-(-s // 2) for s in size]


def unet_forward(cfg: dict, b: int, spatial) -> dict:
    """{part: FLOPs} of one UNet forward at batch ``b`` over ``spatial``."""
    m, mult, nrb = cfg["model_channels"], cfg["channel_mult"], cfg["num_res_blocks"]
    k, dims = cfg["conv_kernel_size"], cfg["dims"]
    attn_at = tuple(cfg["attention_resolutions"])
    emb, size = 4 * m, list(spatial)
    f = {"in_conv": conv(b, cfg["in_channels"], m * mult[0], k, dims, size),
         "time_fc1": 2 * b * m * emb, "cond_fc1": 2 * b * cfg["cond_features"] * emb,
         "mlp_fc2": 2 * 2 * b * emb * emb, "res": 0, "attn_proj": 0, "attn": 0, "resample": 0}

    def res(cin, cout, size):
        f["res"] += (conv(b, cin, cout, k, dims, size) + conv(b, cout, cout, k, dims, size)
                     + 2 * b * emb * cout + (conv(b, cin, cout, 1, dims, size) if cin != cout
                                             else 0))

    def attn(c, size):
        n = math.prod(size)
        f["attn_proj"] += conv(b, c, 3 * c, 1, dims, size) + conv(b, c, c, 1, dims, size)
        f["attn"] += 4 * b * n * n * c  # QK^T and PV over all heads: 4 L^2 D H

    ch, skips, ds = m * mult[0], [m * mult[0]], 1
    for level, mu in enumerate(mult):
        for _ in range(nrb):
            res(ch, mu * m, size)
            ch = mu * m
            if ds in attn_at:
                attn(ch, size)
            skips.append(ch)
        if level != len(mult) - 1:
            size = _half(size)
            f["resample"] += conv(b, ch, ch, 3, dims, size)  # the downsampling is 3 wide
            skips.append(ch)
            ds *= 2
    res(ch, ch, size)
    attn(ch, size)
    res(ch, ch, size)
    for level in reversed(range(len(mult))):
        for i in range(nrb + 1):
            res(ch + skips.pop(), mult[level] * m, size)
            ch = mult[level] * m
            if ds in attn_at:
                attn(ch, size)
            if level and i == nrb:
                size = [s * 2 for s in size]
                f["resample"] += conv(b, ch, ch, k, dims, size)
                ds //= 2
    f["out_conv"] = conv(b, ch, cfg["out_channels"], k, dims, size)
    return f


def decoder_forward(cfg: dict, b: int, latent) -> int:
    """FLOPs of one decoder forward at batch ``b`` from ``latent`` (spatial)."""
    m, mult, nrb = cfg["model_channels"], cfg["channel_mult"], cfg["num_res_blocks"]
    k, dims, size = cfg["conv_kernel_size"], cfg["dims"], list(latent)
    ch = m * mult[-1]
    total = conv(b, cfg["in_channels"], ch, k, dims, size)
    for level in reversed(range(len(mult))):
        if level != len(mult) - 1:
            size = [s * 2 for s in size]
            total += conv(b, ch, ch, 3, dims, size)  # the decoder's upsampling is 3 wide
        for _ in range(nrb):
            cout = mult[level] * m
            total += conv(b, ch, cout, k, dims, size) + conv(b, cout, cout, k, dims, size)
            if cout != ch:
                total += conv(b, ch, cout, 1, dims, size)
            ch = cout
    return total + conv(b, ch, cfg["out_channels"], k, dims, size)


def unet_train_step(cfg: dict, b: int, spatial) -> int:
    """FLOPs of a training step's forward and backward."""
    f = unet_forward(cfg, b, spatial)
    first = f["in_conv"] + f["time_fc1"] + f["cond_fc1"]  # no input gradient
    return 3 * sum(f.values()) - first


def group_norm_bytes(x_numel: int, x_esize: int, channels: int, p_esize: int) -> int:
    """A GroupNorm (+ SiLU) call reads its input and its scale and bias once
    and writes its output once."""
    return 2 * x_numel * x_esize + 2 * channels * p_esize


def attention_cost(b: int, length: int, heads: int, d: int, esize: int) -> tuple[int, int]:
    """(FLOPs, bytes) of an attention forward: two products, q, k and v read
    and the output written once."""
    return 4 * b * heads * length * length * d, 4 * b * length * heads * d * esize
