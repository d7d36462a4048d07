"""PyTorch/CUDA port of tqdne_tpu for NVIDIA Hopper GPUs.

The package mirrors ``tqdne_tpu``'s module paths and class names.  It imports
neither JAX nor ``tqdne_tpu``; its tests hold it against the JAX package.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The top-level names below load their modules on first use, so ``import
tqdne_tpu_torch`` stays light (the lazy re-exports of ``tqdne_tpu/__init__.py``).
"""

import importlib

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "EDMConfig",
    "ConsistencyConfig",
    "DDPMConfig",
    "UNet",
    "AutoencoderKL",
    "Classifier",
    "configs",
]

_LAZY = {
    "EDMConfig": "tqdne_tpu_torch.diffusion.edm",
    "ConsistencyConfig": "tqdne_tpu_torch.diffusion.consistency",
    "DDPMConfig": "tqdne_tpu_torch.diffusion.ddpm",
    "UNet": "tqdne_tpu_torch.models.unet",
    "AutoencoderKL": "tqdne_tpu_torch.models.autoencoder",
    "Classifier": "tqdne_tpu_torch.models.classifier",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    if name == "configs":
        return importlib.import_module("tqdne_tpu_torch.configs")
    raise AttributeError(name)
