"""PyTorch/CUDA port of tqdne_tpu for NVIDIA Hopper GPUs.

The package mirrors ``tqdne_tpu``'s module paths and class names.  It imports
neither JAX nor ``tqdne_tpu``; its tests hold it against the JAX package.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
