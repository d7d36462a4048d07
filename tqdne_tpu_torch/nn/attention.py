"""Spatial self-attention: the port of ``tqdne_tpu/nn/attention.py``.

GroupNorm -> 1x1 conv to 3C with channel order [q|k|v] x heads x head_dim
-> attention with q and k both scaled by d^-1/4 and an f32 softmax ->
zero-init 1x1 output projection -> residual add.  The attention is always
``flash_attention`` (the kernel on CUDA, its plain einsum on the CPU): the
JAX package's ``use_pallas=True`` route, with no length switch.  The kernels
need the head dimension at unit stride: where the projection comes out
channels-first (in 1D, which has no channels-last memory format, and on the
CPU) its channels-last layout is a copy.

Under a sharded ``parallel.spatial`` scope the projection's rows of every
shard are gathered, the kernel attends over all the tokens (it takes q, k
and v of one shape, so each rank repeats the whole attention) and the
block keeps this shard's rows; the gather's backward sums the gradient over
the shards, so dK, dV and dQ of each rank's rows reach their owners.

``TokenAttention`` is the token-major entry of ``models.dit``: (B, L, C) in
and out, dense projections with biases, the same ``flash_attention`` call.
"""

from __future__ import annotations

from torch import nn

from tqdne_tpu_torch.nn.layers import Dense, Norm32, conv_nd
from tqdne_tpu_torch.ops.flash_attention import flash_attention
from tqdne_tpu_torch.parallel import spatial
from tqdne_tpu_torch.utils.tracing import span


class AttentionBlock(nn.Module):
    """Residual self-attention over the flattened spatial dims."""

    def __init__(self, channels: int, num_heads: int = 1, dims: int = 2,
                 use_causal_mask: bool = False):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels do not split into {num_heads} heads")
        self.num_heads = num_heads
        self.use_causal_mask = use_causal_mask
        self.norm = Norm32(channels)
        self.qkv = conv_nd(dims, channels, 3 * channels, 1)
        self.proj_out = conv_nd(dims, channels, channels, 1)

    def forward(self, x):  # (B, C, *spatial)
        qkv = self.qkv(self.norm(x))
        scope = spatial.current()
        sharded = scope is not None and scope.sharded
        if sharded:
            qkv = spatial.gather_rows(qkv, scope)  # every shard's rows
        b, c3, *size = qkv.shape
        c = c3 // 3
        qkv = qkv.movedim(1, -1)  # (B, *spatial, 3C), channels-last view
        if qkv.stride(-1) != 1:
            qkv = qkv.contiguous()
        qkv = qkv.reshape(b, -1, 3, self.num_heads, c // self.num_heads)
        with span("attention"):
            a = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], self.use_causal_mask)
        a = a.reshape(b, *size, c).movedim(-1, 1)
        if sharded:
            a = a.narrow(2, scope.model_rank * x.shape[2], x.shape[2])
        return x + self.proj_out(a)


class TokenAttention(nn.Module):
    """Multi-head self-attention over tokens (B, L, C), DiT's (timm's
    ``Attention`` with ``qkv_bias``): a biased dense projection to 3C in the
    channel order [q|k|v] x heads x head_dim, ``flash_attention`` (q and k
    each scaled by d^-1/4, so d^-1/2 in all) on views of it, and a biased
    dense projection out.  No norm, no residual: the block around it adds
    both."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels do not split into {num_heads} heads")
        self.num_heads = num_heads
        self.qkv = Dense(channels, 3 * channels)
        self.proj = Dense(channels, channels)

    def forward(self, x):  # (B, L, C)
        b, length, c = x.shape
        with span("attn_proj"):
            qkv = self.qkv(x).view(b, length, 3, self.num_heads, c // self.num_heads)
        with span("attention"):
            a = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        with span("attn_proj"):
            return self.proj(a.reshape(b, length, c))
