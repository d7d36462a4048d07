"""Operations and bytes of the DiT's work, from the configuration's widths, in
``harness/flops.py``'s convention: 2 FLOPs a multiply-add, dense layers and
attention's two products (``4 L^2 D H`` a sample) counted; norms,
activations and the modulation's elementwise arithmetic are not model FLOPs.

``modulate_bytes`` is the least traffic of the modulation: each LayerNorm +
modulation reads its tokens and writes them once, each gated residual reads
the stream and the branch and writes the stream once, and each reads its
per-sample vectors (shift and scale, or gate) once.
"""

from __future__ import annotations


def forward(cfg: dict, b: int) -> dict:
    """{part: FLOPs} of one DiT forward at batch ``b``."""
    h, p, depth = cfg["hidden_size"], cfg["patch_size"], cfg["depth"]
    tokens = (cfg["input_size"] // p) ** 2
    hidden = int(h * cfg["mlp_ratio"])
    rows = b * tokens
    return {"patch": 2 * rows * p * p * cfg["in_channels"] * h,
            "embed": 2 * b * (cfg["frequency_embedding_size"] * h + cfg["cond_features"] * h
                              + 2 * h * h),
            "adaln": 2 * b * h * (6 * h * depth + 2 * h),
            "attn_proj": depth * 2 * rows * h * 4 * h,
            "attn": depth * 4 * b * tokens * tokens * h,
            "mlp": depth * 2 * rows * h * hidden * 2,
            "final": 2 * rows * h * p * p * cfg["out_channels"]}


def modulate_bytes(cfg: dict, b: int, esize: int) -> int:
    """Bytes of one forward's LayerNorm-modulations and gated residuals at
    batch ``b`` in elements of ``esize`` bytes: per block two of each, and the
    final layer's modulation."""
    h, depth = cfg["hidden_size"], cfg["depth"]
    stream = b * (cfg["input_size"] // cfg["patch_size"]) ** 2 * h
    per_block = 2 * (2 * stream + 2 * b * h) + 2 * (3 * stream + b * h)
    return esize * (depth * per_block + 2 * stream + 2 * b * h)
