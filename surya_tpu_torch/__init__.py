"""surya_tpu_torch — the PyTorch + CUDA port of ``surya_tpu`` for NVIDIA Hopper.

It sits beside the JAX package, which stays the reference, and imports
nothing of it (nor of jax, flax, optax or orbax). Module names mirror the
JAX package so each counterpart is easy to find:

- ``core``     — config tree and presets (a copy of the JAX one)
- ``ops``      — quadrant split/merge, and ``ops/cuda``: the hand-written
                 CUDA kernels that replace the Pallas TPU kernels
- ``models``   — ResNet trunk, heads, QuadtreeCNN, losses, registry, JAX
                 weight import
- ``train``    — the train and eval steps (AdamW, clip, freeze, NaN guard)
- ``infer``    — fixed-batch ``Predictor`` and the HTTP server

Entry points run on the card (``device=None`` → ``"cuda"``) and raise if
there is none, unless the caller passes ``device="cpu"``.
"""

from surya_tpu_torch.ops import resolve_device  # noqa: F401

__version__ = "0.1.0"
