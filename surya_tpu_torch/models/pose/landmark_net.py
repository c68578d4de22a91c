"""Pose-landmark detection on the card: the MediaPipe stand-in, ported
from ``surya_tpu/models/pose/landmark_net.py``.

- ``PoseLandmarkNet``: an encoder to stride 16, a two-skip decoder back to
  stride 4 where a 33-channel heatmap lives, a differentiable soft-argmax
  for (x, y), and a regression head on the pooled bottleneck for depth z
  and per-landmark visibility. GroupNorm (not BN): batch-size independent,
  no running state. Module names follow the flax tree, so
  ``models.from_jax.from_jax_variables`` maps JAX weights one to one.
- ``landmark_loss``: visibility-masked coordinate and depth regression, an
  unmasked visibility BCE, and a spatial cross-entropy of the heatmaps
  against rendered gaussians.
- ``neural_landmark_extractor``: trained weights → a ``LandmarkExtractor``
  (``data/prep/still_image_dataset.py``): a path → ((33, 4), detected),
  with ``process_array`` (one BGR uint8 frame) and ``process_batch`` (a
  list of them, one forward on the device).
- ``save_pose_params`` / ``load_pose_params``: the single-file artifact
  the JAX package writes (flax msgpack, ``{"meta", "params"}``; legacy flat
  params are read too), through ``core/flax_msgpack.py`` (the ``msgpack``
  package with flax's extension types),
  so artifacts of either package load in both.

Numerics follow flax where they differ from torch's defaults: SAME padding
of the stride-2 convs is (0, 1) per side pair; GroupNorm
(``models/norms.py``) takes eps 1e-6
and the variance E[x²] − E[x]² (clipped at 0) in f32 (at least: flax
promotes the statistics' dtype to f32), and returns the compute dtype;
convs run in the compute dtype (bf16 by default), the heatmap conv and the
heads in f32 (f64 for an f64 model, which ``chip_smoke.py`` uses to
measure f32's own rounding).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.features.landmarks import NUM_LANDMARKS
from surya_tpu_torch.models.backbones.resnet import Conv
from surya_tpu_torch.models.common import reset_dense
from surya_tpu_torch.models.norms import GroupNorm, acc_dtype
from surya_tpu_torch.ops import resolve_device


def _grid(h: int, w: int, device, dtype=torch.float32) -> torch.Tensor:
    """(h·w, 2) pixel-centre (x, y) coordinates in [0, 1], row-major."""
    xs = (torch.arange(w, dtype=dtype, device=device) + 0.5) / w
    ys = (torch.arange(h, dtype=dtype, device=device) + 0.5) / h
    return torch.stack([xs.repeat(h), ys.repeat_interleave(w)], dim=-1)


def _positions_last(heatmaps: torch.Tensor) -> torch.Tensor:
    """(B, h, w, K) → (B, K, h·w) in at least f32, contiguous: torch's CPU
    softmax over a strided dimension sums in f32 one element after
    another, which put the 4,096 probabilities of a 64×64 heatmap 6.7e-5
    off a sum of 1 (on the 256-px pose checkpoint an f32 forward's
    landmarks then sat 5.4e-5 from an f64 one on the CPU, 6e-6 on an
    H100); over the contiguous last dimension it sums accurately."""
    b, h, w, k = heatmaps.shape
    return (heatmaps.reshape(b, h * w, k).to(acc_dtype(heatmaps.dtype))
            .transpose(1, 2).contiguous())


def soft_argmax_2d(heatmaps: torch.Tensor) -> torch.Tensor:
    """(B, h, w, K) logits → (B, K, 2) expected (x, y) in [0, 1]: a softmax
    over the h·w positions, then the expectation of the pixel centres
    (differentiable and sub-pixel)."""
    b, h, w, k = heatmaps.shape
    probs = torch.softmax(_positions_last(heatmaps), dim=-1)
    return torch.einsum("bkp,pc->bkc", probs,
                        _grid(h, w, heatmaps.device, probs.dtype))


class PoseLandmarkNet(nn.Module):
    """Images (B, S, S, 3) in [0, 1] → {"landmarks" (B, 33, 4) = (x, y, z,
    visibility), "heatmaps" (B, S/4, S/4, 33) logits, "vis_logits" (B,
    33)}. S must be divisible by 16; ``width`` by 8 (the group count)."""

    def __init__(self, num_landmarks: int = NUM_LANDMARKS, width: int = 32,
                 dtype: torch.dtype = torch.bfloat16, generator=None):
        super().__init__()
        if width % 8:
            raise ValueError(
                f"PoseLandmarkNet width must be divisible by 8 (the "
                f"GroupNorm group count), got {width}")
        self.num_landmarks, self.width, self.dtype = num_landmarks, width, dtype
        w = width
        same_s2 = ((0, 1), (0, 1))   # flax SAME for a 3×3/2 conv, even size
        self.stem = Conv(3, w, 3, stride=2, padding=same_s2)
        self.stem_gn = GroupNorm(w)
        cin = w
        for i, f in enumerate((2 * w, 4 * w, 8 * w)):
            setattr(self, f"down{i}_a", Conv(cin, f, 3, 2, same_s2))
            setattr(self, f"down{i}_gn_a", GroupNorm(f))
            setattr(self, f"down{i}_b", Conv(f, f, 3, 1, 1))
            setattr(self, f"down{i}_gn_b", GroupNorm(f))
            cin = f
        self.up0 = Conv(8 * w, 4 * w, 3, 1, 1)
        self.up0_gn = GroupNorm(4 * w)
        self.up1 = Conv(4 * w, 2 * w, 3, 1, 1)
        self.up1_gn = GroupNorm(2 * w)
        self.heatmap = Conv(2 * w, num_landmarks, 1, bias=True)
        self.head_dense = nn.Linear(8 * w, 256)
        self.head_out = nn.Linear(256, 2 * num_landmarks)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """JAX's init: lecun_normal conv and dense kernels, zero biases,
        GroupNorm scale 1 and bias 0."""
        for m in self.modules():
            if isinstance(m, (Conv, GroupNorm)):
                m.reset_parameters(generator)
            elif isinstance(m, nn.Linear):
                reset_dense(m, generator)

    def forward(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        x = (images.to(self.dtype) - 0.5).permute(0, 3, 1, 2)   # NCHW view
        x = F.relu(self.stem_gn(self.stem(x)))                  # S/2
        skips = []
        for i in range(3):                                      # S/4, 8, 16
            x = F.relu(getattr(self, f"down{i}_gn_a")(
                getattr(self, f"down{i}_a")(x)))
            y = F.relu(getattr(self, f"down{i}_gn_b")(
                getattr(self, f"down{i}_b")(x)))
            x = x + y                                           # residual
            skips.append(x)
        bottleneck = x

        for name, skip in (("up0", skips[1]), ("up1", skips[0])):
            # jax.image.resize "bilinear" upsampling by 2: half-pixel
            # centres with edge clamping, which is this interpolation
            x = F.interpolate(x, size=skip.shape[2:], mode="bilinear",
                              align_corners=False)
            x = F.relu(getattr(self, f"{name}_gn")(
                getattr(self, name)(x))) + skip

        acc = acc_dtype(self.dtype)
        heatmaps = self.heatmap(x.to(acc)).permute(0, 2, 3, 1)  # (B,h,w,K)
        xy = soft_argmax_2d(heatmaps)
        g = bottleneck.to(acc).mean((2, 3))
        zv = self.head_out(F.relu(self.head_dense(g)))
        k = self.num_landmarks
        z = 0.5 * torch.tanh(zv[:, :k])
        vis_logits = zv[:, k:]
        landmarks = torch.cat([xy, z[..., None],
                               torch.sigmoid(vis_logits)[..., None]], dim=-1)
        return {"landmarks": landmarks, "heatmaps": heatmaps,
                "vis_logits": vis_logits}


def _gaussian_targets(xy: torch.Tensor, h: int, w: int,
                      sigma: float = 0.02) -> torch.Tensor:
    """(B, K, 2) coords → (B, h·w, K) normalised gaussian distributions
    (normalised over the contiguous last dimension, then transposed)."""
    grid = _grid(h, w, xy.device)
    d2 = ((xy[:, :, None, :] - grid[None, None]) ** 2).sum(-1)   # (B,K,hw)
    g = torch.exp(-d2 / (2.0 * sigma ** 2))
    return (g / (g.sum(-1, keepdim=True) + 1e-8)).transpose(1, 2)


def landmark_loss(out: dict, target_xy: torch.Tensor, target_z: torch.Tensor,
                  target_vis: torch.Tensor, heatmap_weight: float = 1.0):
    """Visibility-masked supervision → (total, parts dict).

    Coordinate, z and heatmap terms count only landmarks with target
    visibility > 0.5; the visibility BCE is unmasked (predicting WHICH
    joints are off-frame is part of the task)."""
    lm = out["landmarks"]
    mask = (target_vis > 0.5).float()
    denom = mask.sum().clamp(min=1.0)
    coord = (mask * ((lm[..., :2] - target_xy) ** 2).sum(-1)).sum() / denom
    zloss = (mask * (lm[..., 2] - target_z) ** 2).sum() / denom
    vis_bce = F.binary_cross_entropy_with_logits(out["vis_logits"], mask)
    _, h, w, _ = out["heatmaps"].shape
    logp = torch.log_softmax(_positions_last(out["heatmaps"]), dim=-1)
    targets = _gaussian_targets(target_xy, h, w).transpose(1, 2)
    ce = -(targets * logp).sum(-1)                               # (B, K)
    heat = (mask * ce).sum() / denom
    total = coord + 0.5 * zloss + 0.1 * vis_bce + heatmap_weight * heat
    return total, {"coord": coord, "z": zloss, "vis_bce": vis_bce,
                   "heatmap_ce": heat}


def pck(pred_xy: torch.Tensor, target_xy: torch.Tensor,
        target_vis: torch.Tensor, threshold: float = 0.1) -> torch.Tensor:
    """Fraction of visible landmarks within ``threshold`` (normalised image
    units) of the target."""
    mask = (target_vis > 0.5).float()
    hit = (torch.linalg.vector_norm(pred_xy - target_xy, dim=-1)
           < threshold).float()
    return (mask * hit).sum() / mask.sum().clamp(min=1.0)


def save_pose_params(path: str, params, image_size: int = 256) -> None:
    """The JAX package's single-file artifact (format 1): flax msgpack of
    ``{"meta": {format, width, image_size}, "params": <flax tree>}``.
    ``params`` is a ``PoseLandmarkNet`` or its state_dict."""
    from surya_tpu_torch.core.flax_msgpack import packb
    from surya_tpu_torch.models.from_jax import to_jax_params

    sd = params.state_dict() if isinstance(params, nn.Module) else params
    payload = {"meta": {"format": 1,
                        "width": int(sd["stem.weight"].shape[0]),
                        "image_size": int(image_size)},
               "params": to_jax_params(sd)}
    with open(path, "wb") as f:
        f.write(packb(payload))


def _restore_artifact(path: str) -> tuple[dict, dict]:
    """A pose artifact → (flax param tree, meta): the format-1 payload, or
    legacy flat params (width from the stem kernel, image size 256)."""
    from surya_tpu_torch.core.flax_msgpack import unpackb

    with open(path, "rb") as f:
        raw = unpackb(f.read())
    if isinstance(raw, dict) and set(raw) == {"meta", "params"}:
        return raw["params"], dict(raw["meta"])
    width = int(np.asarray(raw["stem"]["kernel"]).shape[-1])
    return raw, {"format": 0, "width": width, "image_size": 256}


def _load_artifact(path: str, model: PoseLandmarkNet | None = None,
                   image_size: int | None = None,
                   dtype: torch.dtype = torch.bfloat16):
    """→ (state_dict, model holding it, image size)."""
    from surya_tpu_torch.models.from_jax import from_jax_variables

    tree, meta = _restore_artifact(path)
    model = model or PoseLandmarkNet(width=meta["width"], dtype=dtype)
    sd = from_jax_variables({"params": tree})
    model.load_state_dict(sd, strict=True)
    return sd, model, image_size or meta["image_size"]


def load_pose_params(path: str, model: PoseLandmarkNet | None = None,
                     image_size: int | None = None) -> dict:
    """A ``save_pose_params`` artifact (of either package) → the port's
    state_dict. ``model``/``image_size`` override the artifact's metadata
    (needed only for legacy artifacts of another geometry)."""
    return _load_artifact(path, model, image_size)[0]


def load_pose_extractor(path: str, detection_threshold: float = 0.3,
                        image_size: int | None = None, device=None,
                        dtype: torch.dtype = torch.bfloat16):
    """An artifact → a ready ``LandmarkExtractor`` at the artifact's own
    width, resizing inputs to its training ``image_size``."""
    sd, model, size = _load_artifact(path, image_size=image_size,
                                     dtype=dtype)
    return neural_landmark_extractor(
        sd, model=model, image_size=size,
        detection_threshold=detection_threshold, device=device)


def neural_landmark_extractor(params, model: PoseLandmarkNet | None = None,
                              image_size: int = 256,
                              detection_threshold: float = 0.3,
                              device=None):
    """Trained weights (a state_dict) → a ``LandmarkExtractor``: callable on
    an image path → ((33, 4) float32, detected), with ``process_array`` (an
    in-memory BGR uint8 frame) and ``process_batch`` (a list of them: one
    forward on the device). ``detected`` = mean predicted visibility above
    ``detection_threshold``; an undetected frame gives zeros, as
    MediaPipe's no-pose result does.

    Frames are resized to ``image_size`` as PIL's bilinear resize does
    (``data/resample.py``, on the device), then scaled to [0, 1]. The JAX
    extractor pads each batch to a power of two so XLA compiles one program
    per size; GroupNorm is per sample, so the padding changes no output and
    is dropped here."""
    from surya_tpu_torch.data.resample import pil_bilinear_u8

    device = resolve_device(device)
    model = model or PoseLandmarkNet()
    model.load_state_dict(params, strict=True)
    model = model.to(device).eval()
    size = (image_size, image_size)

    def _decode(lm: np.ndarray) -> tuple[np.ndarray, bool]:
        if not lm[:, 3].mean() > detection_threshold:
            return np.zeros((NUM_LANDMARKS, 4), np.float32), False
        return lm, True

    @torch.inference_mode()
    def _landmarks(rgb_u8: list) -> np.ndarray:
        if len({f.shape for f in rgb_u8}) == 1:
            batch = pil_bilinear_u8(torch.stack(rgb_u8), size)
        else:
            batch = torch.stack([pil_bilinear_u8(f, size) for f in rgb_u8])
        out = model(batch.float() / 255.0)["landmarks"]
        return out.float().cpu().numpy()

    def _bgr_to_rgb(frame) -> torch.Tensor:
        t = torch.as_tensor(np.ascontiguousarray(frame)).to(device)
        return t.flip(-1)

    def process_batch(frames_bgr) -> list[tuple[np.ndarray, bool]]:
        if not len(frames_bgr):
            return []
        return [_decode(lm) for lm in
                _landmarks([_bgr_to_rgb(f) for f in frames_bgr])]

    def process_array(img_bgr: np.ndarray):
        return process_batch([img_bgr])[0]

    def extract(image_path: str):
        try:
            from PIL import Image   # decoding a file only; no resize
        except ImportError as e:
            raise ImportError(
                "decoding an image path needs PIL; call process_array or "
                "process_batch with decoded frames instead") from e
        try:
            with Image.open(image_path) as img:
                rgb = np.array(img.convert("RGB"))
        except OSError:
            return np.zeros((NUM_LANDMARKS, 4), np.float32), False
        return _decode(_landmarks([torch.as_tensor(rgb).to(device)])[0])

    extract.process_array = process_array
    extract.process_batch = process_batch
    return extract
