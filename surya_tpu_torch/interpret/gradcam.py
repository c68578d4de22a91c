"""Grad-CAM by autograd on a captured activation, mirroring
``surya_tpu/interpret/gradcam.py``.

JAX splits the forward at the target activation and takes ``jax.vjp`` of
the tail. Here the same split runs on the model's own modules: the
activation is computed without a graph, made a leaf that requires a
gradient, the tail (``model.head`` after whatever remains of the trunk)
maps it to the logits, and ``torch.autograd.grad`` of the one-hot score
gives d score / d activation. No hooks, no model surgery; the ResNet's
``start=`` entry reruns a trunk tail. The CAM runs at f32 in eval mode,
whatever the checkpoint's compute dtype, with every parameter frozen, so
autograd differentiates towards the activation alone. On a card the
quadtree's tail goes through the quadrant and fusion-head kernels in
their training forms (their autograd Functions).

Heatmap: channel weights = the gradient's spatial mean; cam = ReLU(Σ_c
w_c · act_c), divided by its maximum.

Targets: ``quadtree`` — ``layer3`` (the quadrant block's map) or
``layer4`` (the global branch); ``standard_resnet`` and
``standard_multimodal`` with a ResNet backbone — ``layer4`` (other
backbones raise, as in JAX); the hierarchical families — ``layer2`` (the
base map; ``base`` and ``layer4`` mean the same) or ``level1`` /
``level2``, the post-ReLU level activations, whose per-quadrant CAMs are
stitched back with ``quadrant_merge``. ``numerical_only`` has no image to
explain and raises.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from surya_tpu_torch.core.config import ModelConfig
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.backbones.resnet import (
    global_avg_pool,
    stem_is_s2d,
)
from surya_tpu_torch.ops import resolve_device
from surya_tpu_torch.ops.quadtree import quadrant_merge

HIERARCHICAL = ("hierarchical_quadtree", "attention_hierarchical")
STANDARD = ("standard_resnet", "standard_multimodal")


def cam_model(cfg: ModelConfig, state_dict, image_size: int = 224,
              device=None) -> torch.nn.Module:
    """The model Grad-CAM differentiates: ``cfg``'s family at f32 with the
    stem the state_dict has, in eval mode, every parameter frozen, on the
    card unless ``device="cpu"``."""
    if cfg.mode == "numerical_only":
        raise ValueError("grad-cam is undefined for numerical_only mode")
    if cfg.name in STANDARD and not cfg.backbone.startswith("resnet"):
        raise NotImplementedError(
            "grad_cam supports resnet backbones (the reference hooks "
            "resnet layer4 only, resnet/grad_cam_analysis.py:258)")
    if cfg.name not in ("quadtree", *HIERARCHICAL, *STANDARD):
        raise NotImplementedError(f"grad_cam for {cfg.name!r}")
    prefix = "trunk.resnet." if cfg.name in STANDARD else "trunk."
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              stem_space_to_depth=stem_is_s2d(state_dict,
                                                              prefix))
    model = get_model(cfg, image_size=image_size)
    model.load_state_dict(state_dict, strict=True)
    model.requires_grad_(False)
    model.trunk.to(memory_format=torch.channels_last)
    return model.to(resolve_device(device)).eval()


def _cam_raw(act, grad):
    """(B, h, w, C) activation and gradient → (B, h, w) heatmap."""
    weights = grad.mean(dim=(1, 2), keepdim=True)
    return torch.relu((weights * act).sum(-1))


def _cam_normalize(cam):
    return cam / cam.amax(dim=(1, 2), keepdim=True).clamp(min=1e-12)


def _canonical_target(cfg, target_layer: str) -> str:
    if cfg.name == "quadtree":
        if target_layer not in ("layer3", "layer4"):
            raise ValueError("quadtree targets: layer3 | layer4")
        return target_layer
    if cfg.name in HIERARCHICAL:
        if target_layer in ("layer2", "base", "layer4"):
            # layer4, the CLI's default target, means the base map here
            return "layer2"
        if target_layer not in ("level1", "level2"):
            raise ValueError(
                "hierarchical targets: layer2 | level1 | level2")
        return target_layer
    return "layer4"


def cam_split(cfg, model, images, target_layer):
    """→ (activation, constants, merges): the target activation, what the
    tail reads beside it (the other branches, fixed), and how many
    quadrant splits to undo in the heatmap. No graph is built."""
    target_layer = _canonical_target(cfg, target_layer)
    trunk = model.trunk
    with torch.no_grad():
        if cfg.name == "quadtree":
            fmap = trunk(images, upto="layer3")["out"]
            if target_layer == "layer3":
                return fmap, {}, 0
            return trunk(fmap, start="layer4")["out"], {"fmap": fmap}, 0
        if cfg.name in HIERARCHICAL:
            base = trunk(images, upto="layer2")["out"]
            if target_layer == "layer2":
                return base, {}, 0
            g, l1_act, l2_act = model.from_base(base)
            if target_layer == "level1":
                return l1_act, {"g": g, "l2_act": l2_act}, 1
            return l2_act, {"g": g, "l1_act": l1_act}, 2
        return trunk.resnet(images, upto="layer4")["out"], {}, 0


def _tail(cfg, model, target_layer, consts, feats):
    """The function from the target activation to the logits."""
    target_layer = _canonical_target(cfg, target_layer)
    if cfg.name == "quadtree":
        if target_layer == "layer3":
            return lambda a: model.head(
                a, model.trunk(a, start="layer4")["out"], feats)
        return lambda a: model.head(consts["fmap"], a, feats)
    if cfg.name in HIERARCHICAL:
        if target_layer == "layer2":
            return lambda a: model.head(*model.from_base(a), feats)
        if target_layer == "level1":
            return lambda a: model.head(consts["g"], a, consts["l2_act"],
                                        feats)
        return lambda a: model.head(consts["g"], consts["l1_act"], a, feats)
    return lambda a: model.head(global_avg_pool(a, torch.float32), feats)


def cam_from(cfg, model, act, consts, merges, feats, target_layer,
             target_class: int | None = None):
    """Grad-CAM from a target activation and the constants of
    :func:`cam_split` (on the model's device) → (heatmaps, preds,
    logits)."""
    act = act.detach().requires_grad_(True)
    with torch.enable_grad():
        logits = _tail(cfg, model, target_layer, consts, feats)(act)
        preds = logits.argmax(-1)
        target = (preds if target_class is None
                  else torch.full_like(preds, target_class))
        seed = F.one_hot(target, logits.shape[-1]).to(logits.dtype)
        (grad,) = torch.autograd.grad((seed * logits).sum(), act)
    cam = _cam_raw(act.detach(), grad)             # (B·4^merges, h, w)
    for _ in range(merges):                        # stitch quadrants back
        cam = quadrant_merge(cam[..., None], cam.shape[0] // 4)[..., 0]
    return _cam_normalize(cam), preds, logits.detach()


def grad_cam_of(cfg: ModelConfig, model, images, feats,
                target_layer: str = "layer4",
                target_class: int | None = None):
    """Grad-CAM with a model from :func:`cam_model` → (heatmaps (B, h, w),
    preds (B,), logits (B, C)), tensors on the model's device."""
    device = next(model.parameters()).device
    images = torch.as_tensor(images, dtype=torch.float32).to(device)
    feats = torch.as_tensor(feats, dtype=torch.float32).to(device)
    act, consts, merges = cam_split(cfg, model, images, target_layer)
    return cam_from(cfg, model, act, consts, merges, feats, target_layer,
                    target_class)


def grad_cam(cfg: ModelConfig, state_dict, images, feats,
             target_layer: str = "layer4", target_class: int | None = None,
             device=None):
    """Returns (heatmaps (B, h, w), preds (B,), logits (B, C)) for one
    batch: images (B, H, W, 3) NHWC and feats (B, F), numpy or tensors.
    Runs on the card unless ``device="cpu"``."""
    model = cam_model(cfg, state_dict, np.shape(images)[1], device)
    return grad_cam_of(cfg, model, images, feats, target_layer, target_class)


def resize_bilinear(cam, size: tuple[int, int]) -> torch.Tensor:
    """(B, h, w) → (B, H, W) bilinear upsample (half-pixel centres, the
    ``cv2.resize`` rule)."""
    cam = torch.as_tensor(cam, dtype=torch.float32)
    return F.interpolate(cam[:, None], size=tuple(size), mode="bilinear",
                         align_corners=False)[:, 0]


def overlay_heatmap(image: np.ndarray, cam: np.ndarray,
                    alpha: float = 0.4) -> np.ndarray:
    """Blend a [0, 1] heatmap onto an HWC uint8 or float image (the JET
    colour map, as the reference's ``cv2.COLORMAP_JET`` blend)."""
    import matplotlib.cm as mcm

    cam = resize_bilinear(np.asarray(cam)[None], image.shape[:2])[0].numpy()
    colored = mcm.jet(np.clip(cam, 0, 1))[..., :3]
    img = np.asarray(image, np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    out = (1 - alpha) * img + alpha * colored
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def batch_grad_cam(cfg: ModelConfig, state_dict, batches,
                   target_layer: str = "layer4", device=None):
    """Yields (heatmaps, preds, labels) as numpy per batch of (images,
    feats, labels); the model is built once, at the first batch's size."""
    if cfg.mode == "numerical_only":
        raise ValueError("grad-cam is undefined for numerical_only mode")
    model = None
    for images, feats, labels in batches:
        if model is None:
            model = cam_model(cfg, state_dict, np.shape(images)[1], device)
        cams, preds, _ = grad_cam_of(cfg, model, images, feats, target_layer)
        yield cams.cpu().numpy(), preds.cpu().numpy(), np.asarray(labels)


def save_batch_grad_cam(cfg: ModelConfig, state_dict, batches, class_names,
                        out_dir: str, target_layer: str = "layer4",
                        alpha: float = 0.4, device=None) -> int:
    """Write ``<idx>_pred_<label>_cam.jpg`` overlays into a directory per
    true class; returns how many. Batches are (model images, feats, labels)
    or (model images, feats, labels, display images): the overlay is drawn
    on the display images, the model classifies the others."""
    from PIL import Image

    if cfg.mode == "numerical_only":
        raise ValueError("grad-cam is undefined for numerical_only mode")
    model, n = None, 0
    for batch in batches:
        images, feats, labels = batch[:3]
        display = batch[3] if len(batch) > 3 else images
        if model is None:
            model = cam_model(cfg, state_dict, np.shape(images)[1], device)
        cams, preds, _ = grad_cam_of(cfg, model, images, feats, target_layer)
        cams, preds = cams.cpu().numpy(), preds.cpu().numpy()
        for i in range(len(labels)):
            if int(labels[i]) < 0:
                continue   # a padding row
            d = os.path.join(out_dir, class_names[int(labels[i])])
            os.makedirs(d, exist_ok=True)
            img = np.asarray(display[i])
            if img.max() <= 1.5:
                img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            else:
                img = np.clip(img, 0, 255).astype(np.uint8)
            Image.fromarray(overlay_heatmap(img, cams[i], alpha)).save(
                os.path.join(d, f"{n:05d}_pred_"
                                f"{class_names[int(preds[i])]}_cam.jpg"))
            n += 1
    return n
