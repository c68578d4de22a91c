"""surya_tpu_torch — the PyTorch + CUDA port of ``surya_tpu`` for NVIDIA Hopper.

It sits beside the JAX package, which stays the reference, and imports
nothing of it (nor of jax, flax, optax or orbax). Module names mirror the
JAX package so each counterpart is easy to find:

- ``core``     — config tree and presets (a copy of the JAX one)
- ``ops``      — quadrant split/merge, and ``ops/cuda``: the hand-written
                 CUDA kernels that replace the Pallas TPU kernels
- ``models``   — backbones (ResNet with the s2d stem and folded BN, VGG16,
                 MobileNetV2, DenseNet121), heads, the spatial families
                 (quadtree, hierarchical, attention, standard), the first
                 temporal families (CNN+LSTM, Ji3DCNN, Quadtree3DCNN, the
                 r3d_18 and ViT ones), ``models/pose``: the landmark net
                 and its training, losses, registry, JAX weight import,
                 and the reference's PyTorch checkpoints both ways
                 (``full_import``/``full_export``)
- ``data``     — host batches (in-memory, disk, packed; sequence windows
                 and sequence packs), the device-side augmentation and
                 imputation, the replay and synthetic-pose generators, the
                 PIL- and cv2-equivalent resizes, ``data/prep``: dataset
                 preparation and ingestion
- ``native``   — the ctypes JPEG batch decoder (host side)
- ``train``    — the train and eval steps (AdamW, clip, freeze, NaN guard),
                 the epoch loop with checkpoints and resume, comparison
- ``infer``    — fixed-batch ``Predictor``, the ``torch.export`` serving
                 artifact (``export_model``/``load_exported``), the HTTP
                 server, video
- ``interpret`` — Grad-CAM by autograd, the hierarchical feature maps
- ``core``     — also checkpoints, metrics, the named random streams and
                 the pose artifacts' flax msgpack
- ``features`` — the 47- and 443-feature extractors; ``utils`` — plots
- ``bench``    — host input-pipeline throughput (native decoder vs PIL)

Entry points run on the card (``device=None`` → ``"cuda"``) and raise if
there is none, unless the caller passes ``device="cpu"``.
"""

from surya_tpu_torch.ops import resolve_device  # noqa: F401

__version__ = "0.1.0"
