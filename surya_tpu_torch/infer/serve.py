"""Serving: a fixed-batch predictor, ported from
``surya_tpu/infer/serve.py::Predictor``.

``predict`` takes any number of samples, runs them in ``batch_size``
chunks, pads the tail chunk by repeating its last row and slices the
padding off again. A sample is an image (H,W,3) with features (F,), or,
for a temporal model (``models.TEMPORAL_MODELS``), a clip (T,H,W,3) with
a feature sequence (T,F). The image wire format is set by ``input_dtype``:
``uint8`` takes raw 0-255 pixels and divides by 255 on the device (a 4×
smaller host→device copy), ``float32``/``bfloat16`` take [0,1] pixels.
As in the JAX predictor no ImageNet normalisation is applied (see ROADMAP
section C). ``param_dtype`` casts the float weights and keeps the BN
running statistics in f32.

The forward runs on the card (``device=None`` → ``"cuda"``, raising if
there is none) unless the caller passes ``device="cpu"``. The StableHLO
``export_model``/``load_exported`` wait for ``torch.export`` (ROADMAP A6).
"""

from __future__ import annotations

import numpy as np
import torch

from surya_tpu_torch.core.config import ModelConfig
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.backbones import trunk_channels_last
from surya_tpu_torch.models.common import apply_mode_ablation
from surya_tpu_torch.ops import resolve_device

_WIRE = {"uint8": torch.uint8, "float32": torch.float32,
         "bfloat16": torch.bfloat16}


def wire_dtype(dtype) -> torch.dtype:
    """A torch dtype, numpy dtype or name → the torch wire dtype."""
    name = (str(dtype).removeprefix("torch.")
            if isinstance(dtype, (str, torch.dtype)) else np.dtype(dtype).name)
    if name not in _WIRE:
        raise ValueError(f"unsupported wire dtype {dtype!r}; use one of "
                         f"{sorted(_WIRE)}")
    return _WIRE[name]


def cast_params(model: torch.nn.Module, dtype: torch.dtype) -> None:
    """Cast float parameters to ``dtype`` in place; buffers (the BN
    running statistics) stay f32."""
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.to(dtype)


class Predictor:
    """Fixed-batch classifier for serving (see the module docstring).

    ``state_dict`` is the port's own (``model.state_dict()``, or
    ``models.from_jax.from_jax_variables`` of a JAX tree)."""

    def __init__(self, cfg: ModelConfig, state_dict, batch_size: int = 32,
                 image_size: int = 224, param_dtype=None,
                 input_dtype=torch.float32, device=None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.image_size = image_size
        self.input_dtype = wire_dtype(input_dtype)
        self.device = resolve_device(device)
        model = get_model(cfg, image_size=image_size)
        model.load_state_dict(state_dict, strict=True)
        if param_dtype is not None:
            cast_params(model, param_dtype)
        trunk_channels_last(model)   # cuDNN convs without a re-layout
        self.model = model.to(self.device).eval()

    @torch.inference_mode()
    def _forward(self, img: np.ndarray, ft: np.ndarray):
        images = torch.from_numpy(img)
        if self.input_dtype == torch.bfloat16:
            images = images.to(torch.bfloat16)   # halve the host→device copy
        images = images.to(self.device, non_blocking=True).float()
        if self.input_dtype == torch.uint8:
            images = images / 255.0
        feats = torch.from_numpy(ft).to(self.device, non_blocking=True)
        images, feats = apply_mode_ablation(self.cfg.mode, images, feats)
        logits = self.model(images, feats)
        probs = torch.softmax(logits.float(), dim=-1)
        return probs.argmax(-1).int().cpu().numpy(), probs.cpu().numpy()

    def predict(self, images: np.ndarray, feats: np.ndarray):
        """→ (preds int32 (N,), probs f32 (N, num_classes)) for N samples.

        The caller's image dtype must match the wire format: a uint8 wire
        takes raw 0-255 pixels only, a float wire [0,1] pixels only; a
        mismatch raises instead of giving confidently wrong predictions."""
        images = np.asarray(images)
        if self.input_dtype == torch.uint8:
            if images.dtype != np.uint8:
                raise ValueError(
                    "this predictor's wire format is uint8 raw pixels; "
                    f"got {images.dtype} (send raw 0-255 uint8 pixels)")
        elif np.issubdtype(images.dtype, np.integer):
            wire = str(self.input_dtype).removeprefix("torch.")
            raise ValueError(
                f"this predictor's wire format is {wire} [0,1] pixels; "
                f"got integer dtype {images.dtype} (normalize with /255 "
                "first, or serve with input_dtype=uint8)")
        n = images.shape[0]
        if n == 0:
            return (np.zeros((0,), np.int32),
                    np.zeros((0, self.cfg.num_classes), np.float32))
        host = np.uint8 if self.input_dtype == torch.uint8 else np.float32
        preds, probs = [], []
        for lo in range(0, n, self.batch_size):
            img = np.ascontiguousarray(images[lo:lo + self.batch_size], host)
            ft = np.ascontiguousarray(feats[lo:lo + self.batch_size],
                                      np.float32)
            pad = self.batch_size - img.shape[0]
            if pad:
                img = np.concatenate([img, np.repeat(img[-1:], pad, 0)])
                ft = np.concatenate([ft, np.repeat(ft[-1:], pad, 0)])
            p, pr = self._forward(img, ft)
            take = min(self.batch_size, n - lo)
            preds.append(p[:take])
            probs.append(pr[:take])
        return np.concatenate(preds), np.concatenate(probs)
