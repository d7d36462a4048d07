"""Conditioning classifier for FID/IS evaluation: the port of
``tqdne_tpu/models/classifier.py``.

Encoder backbone (the autoencoder's ``Encoder``, attention at ds 8) ->
global mean-pool over the spatial dims -> 2-layer SiLU MLP ``embed`` ->
linear ``head``, with the flax scope names (``encoder``, ``mlp1``, ``mlp2``,
``head``) so ``utils.convert`` maps a flax tree onto it one to one.  The
public methods take the JAX layout (B, *spatial, C) and return f32.  Its
compute dtype comes from ``nn.layers.set_compute_dtype`` (bf16 over f32
parameters is the JAX ``Classifier(dtype=bf16)``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tqdne_tpu_torch.models.autoencoder import Encoder
from tqdne_tpu_torch.nn.layers import Dense


class Classifier(nn.Module):
    def __init__(self, encoder_config: dict, num_classes: int):
        super().__init__()
        self.encoder = Encoder(**encoder_config)
        width = encoder_config["out_channels"]
        self.mlp1 = Dense(width, width)
        self.mlp2 = Dense(width, width)
        self.head = Dense(width, num_classes)

    def embed(self, x):
        """(B, *spatial, C) -> (B, out_channels) embeddings in f32."""
        h = self.encoder(x.movedim(-1, 1))  # (B, C, *spatial)
        h = h.mean(dim=tuple(range(2, h.ndim)))  # global spatial mean-pool
        h = self.mlp1(F.silu(h))
        h = self.mlp2(F.silu(h))
        return h.float()  # embeddings feed host-side FID math

    def forward(self, x):
        """(B, *spatial, C) -> (B, num_classes) logits in f32."""
        return self.head(self.embed(x)).float()

    def embed_and_logits(self, x):
        """(embeddings, logits) from one encoder pass: the JAX evaluate CLI's
        two ``apply`` calls, which XLA merges and eager PyTorch would not."""
        emb = self.embed(x)
        return emb, self.head(emb).float()


def weighted_cross_entropy(logits, labels, class_weights, weight_sum=None):
    """Inverse-frequency weighted cross-entropy (torch ``CrossEntropyLoss(weight=w)``):
    the mean is normalised by the sum of the per-sample weights, or by
    ``weight_sum`` when given (a data-parallel rank's share of the global sum)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = -log_probs.gather(-1, labels[:, None])[:, 0]
    w = class_weights[labels]
    return (w * nll).sum() / (w.sum() if weight_sum is None else weight_sum)
