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
there is none) unless the caller passes ``device="cpu"``. With a ``mesh``
of several ranks (``core/mesh.py``, under ``torchrun``) every rank calls
``predict`` with the same request: each batch is split over 'data', the
parameters follow the tensor-parallel rule over 'model'
(``parallel/sharding.py``), and the predictions are gathered, so every
rank returns the whole batch.

:class:`ServingForward` is the one serving forward (JAX's
``_make_forward``): wire → f32 pixels → ablation → model → f32 softmax and
int32 argmax. ``Predictor`` runs it eagerly; :func:`export_model` traces
it with ``torch.export`` at a fixed batch, weights baked in, and
:func:`load_exported` runs the saved program on the card or the CPU, as
JAX's artifact serves ``platforms=("cpu", "tpu")``. The exported graph
holds the quadrant and fusion-head kernels as the operators
``surya_tpu_torch::quadrant_process`` and ``::fusion_head``, so unlike
JAX's StableHLO artifact it needs ``surya_tpu_torch`` installed where it
runs: the operators launch the package's kernels on the card and its
plain versions on the CPU.
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import torch

from surya_tpu_torch.core.config import ModelConfig
from surya_tpu_torch.models import TEMPORAL_MODELS, get_model
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


class ServingForward(torch.nn.Module):
    """(images, feats) → (preds int32 (B,), probs f32 (B, C)): JAX's
    ``_make_forward``. A uint8 wire divides by 255 here, on the device;
    a float wire is cast to f32. Then the ablation mode's zeroing, the
    model, the softmax in f32 and the argmax."""

    def __init__(self, model: torch.nn.Module, mode: str):
        super().__init__()
        self.model, self.mode = model, mode

    def forward(self, images: torch.Tensor, feats: torch.Tensor):
        x = images.float()
        if images.dtype == torch.uint8:
            x = x / 255.0
        x, feats = apply_mode_ablation(self.mode, x, feats)
        probs = torch.softmax(self.model(x, feats).float(), dim=-1)
        return probs.argmax(-1).int(), probs


def serving_forward(cfg: ModelConfig, state_dict, image_size: int,
                    param_dtype, device: torch.device) -> ServingForward:
    """The model at ``image_size`` with ``state_dict`` (``strict``), float
    weights cast to ``param_dtype`` (BN statistics stay f32), the trunk
    channels-last, frozen, in eval mode on ``device``, wrapped in
    :class:`ServingForward`. Frozen weights keep every kernel wrapper on
    its inference form, in eager runs and in ``torch.export``'s trace."""
    model = get_model(cfg, image_size=image_size)
    model.load_state_dict(state_dict, strict=True)
    if param_dtype is not None:
        cast_params(model, param_dtype)
    trunk_channels_last(model)   # cuDNN convs without a re-layout
    model = model.to(device).eval().requires_grad_(False)
    return ServingForward(model, cfg.mode)


def input_shapes(cfg: ModelConfig, batch_size: int, image_size: int):
    """The fixed (images, feats) shapes of one batch: (B, H, W, 3) and
    (B, F), or (B, T, H, W, 3) and (B, T, F) for a temporal model."""
    if cfg.name in TEMPORAL_MODELS:
        return ((batch_size, cfg.seq_len, image_size, image_size, 3),
                (batch_size, cfg.seq_len, cfg.num_features))
    return ((batch_size, image_size, image_size, 3),
            (batch_size, cfg.num_features))


class Predictor:
    """Fixed-batch classifier for serving (see the module docstring).

    ``state_dict`` is the port's own (``model.state_dict()``, or
    ``models.from_jax.from_jax_variables`` of a JAX tree)."""

    def __init__(self, cfg: ModelConfig, state_dict, batch_size: int = 32,
                 image_size: int = 224, mesh=None, param_dtype=None,
                 input_dtype=torch.float32, device=None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.image_size = image_size
        self.input_dtype = wire_dtype(input_dtype)
        self.device = resolve_device(device)
        self.serving = serving_forward(cfg, state_dict, image_size,
                                       param_dtype, self.device)
        self.model = self.serving.model
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        if self.mesh is not None:
            from surya_tpu_torch.core.mesh import DATA_AXIS
            from surya_tpu_torch.parallel.sharding import partition_params

            ddim = self.mesh.shape[DATA_AXIS]
            if batch_size % ddim:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by the "
                    f"mesh data axis ({ddim})")
            partition_params(self.model, self.mesh)

    @torch.inference_mode()
    def _forward(self, img: np.ndarray, ft: np.ndarray):
        rows = None
        if self.mesh is not None:   # this rank's rows of the batch
            rows = self.mesh.row_shard(img.shape[0])
            img, ft = rows.take(img), rows.take(ft)
        images = torch.from_numpy(img)
        if self.input_dtype == torch.bfloat16:
            images = images.to(torch.bfloat16)   # halve the host→device copy
        preds, probs = self.serving(
            images.to(self.device, non_blocking=True),
            torch.from_numpy(ft).to(self.device, non_blocking=True))
        if rows is not None and rows.group is not None:
            from surya_tpu_torch.core.mesh import all_gather_stack

            preds, probs = (all_gather_stack(t, rows.group).flatten(0, 1)
                            for t in (preds, probs))
        return preds.cpu().numpy(), probs.cpu().numpy()

    def cost_analysis(self) -> dict:
        """``{"flops": F}``: the operations of one ``batch_size`` chunk's
        forward, counted by ``torch.utils.flop_counter.FlopCounterMode``
        on fake tensors (nothing runs on the device), the two kernels'
        operators through their flop formulas. XLA's ``bytes accessed``
        has no counterpart in PyTorch and is not reported."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils.flop_counter import FlopCounterMode

        img, ft = input_shapes(self.cfg, self.batch_size, self.image_size)
        counter = FlopCounterMode(display=False)
        with (torch.inference_mode(),
              FakeTensorMode(allow_non_fake_inputs=True), counter):
            self.serving(torch.empty(img, dtype=self.input_dtype,
                                     device=self.device),
                         torch.empty(ft, device=self.device))
        return {"flops": counter.get_total_flops()}

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


_META = "surya_tpu_torch.json"   # the artifact's own description


def export_model(cfg: ModelConfig, state_dict, path: str,
                 batch_size: int = 32, image_size: int = 224,
                 param_dtype=None, input_dtype=torch.float32,
                 device=None) -> None:
    """Trace :class:`ServingForward` with ``torch.export`` at a fixed
    ``batch_size``, weights baked in, and save it to ``path``
    (``torch.export.save``); :func:`load_exported` reads it back.

    The trace runs on ``device`` (the card unless ``"cpu"``) under
    ``torch.no_grad()`` with frozen weights, so the two kernels enter the
    graph as their inference operators. ``param_dtype`` (e.g.
    ``torch.bfloat16``) casts the float weights, roughly halving the
    artifact; BN statistics stay f32. ``input_dtype=torch.uint8`` bakes
    the raw-pixel ÷255 into the program."""
    device = resolve_device(device)
    wire = wire_dtype(input_dtype)
    forward = serving_forward(cfg, state_dict, image_size, param_dtype,
                              device)
    img, ft = input_shapes(cfg, batch_size, image_size)
    example = (torch.zeros(img, dtype=wire, device=device),
               torch.zeros(ft, device=device))
    with torch.no_grad():
        program = torch.export.export(forward, example)
    program.example_inputs = None   # else the file keeps a batch of zeros
    meta = {"model": cfg.name, "batch_size": batch_size,
            "image_size": image_size,
            "input_dtype": str(wire).removeprefix("torch."),
            "images": list(img), "features": list(ft)}
    with warnings.catch_warnings():
        # channels-last weights do not cover their storage in order; the
        # archive then stores the storage whole, with each weight's strides
        warnings.filterwarnings("ignore", "No complete tensor found")
        torch.export.save(program, path,
                          extra_files={_META: json.dumps(meta)})


class ExportedPredictor:
    """An :func:`export_model` artifact on one device. ``call(images,
    feats)`` runs one fixed batch → (preds int32 (B,), probs f32 (B, C))
    as tensors on that device, like JAX's ``loaded.call``; ``meta`` is the
    artifact's description (model, batch, wire, shapes)."""

    def __init__(self, program, meta: dict, device: torch.device):
        self.program, self.meta, self.device = program, meta, device
        self.input_dtype = wire_dtype(meta["input_dtype"])
        self._module = program.module()

    def call(self, images, feats):
        images, feats = torch.as_tensor(images), torch.as_tensor(feats)
        want = (tuple(self.meta["images"]), self.input_dtype,
                tuple(self.meta["features"]), torch.float32)
        got = (tuple(images.shape), images.dtype, tuple(feats.shape),
               feats.dtype)
        if got != want:
            raise ValueError(f"this artifact takes images {want[:2]} and "
                             f"features {want[2:]}; got {got}")
        with torch.inference_mode():
            return self._module(
                images.to(self.device, non_blocking=True),
                feats.to(self.device, non_blocking=True))


def load_exported(path: str, device=None) -> ExportedPredictor:
    """Load an :func:`export_model` artifact onto ``device`` (the card
    unless ``"cpu"``): the package's two operators are registered first,
    then the program and its weights move there
    (``torch.export.passes.move_to_device_pass``). One artifact serves
    the card (kernels) and the CPU (their plain versions)."""
    from torch.export.passes import move_to_device_pass

    import surya_tpu_torch.ops.cuda.fusion_head  # noqa: F401  the operators
    import surya_tpu_torch.ops.cuda.quadrant  # noqa: F401

    device = resolve_device(device)
    extra = {_META: ""}
    program = torch.export.load(path, extra_files=extra)
    if not extra[_META]:
        raise ValueError(f"{path} is not an export_model artifact")
    return ExportedPredictor(move_to_device_pass(program, device),
                             json.loads(extra[_META]), device)
