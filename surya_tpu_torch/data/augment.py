"""Batched image augmentations on the device, mirroring
``surya_tpu/data/augment.py``.

The train transform is the reference's torchvision set: RandomResizedCrop
(scale 0.8–1), horizontal flip (0.5), ColorJitter (0.2, 0.2, 0.2, 0.1),
rotation (±10°), GaussianBlur (kernel 5 wide × 9 high, σ 0.1–0.5) and
ImageNet normalisation; crop, flip and rotation compose into one bilinear
resample per image. Images are NHWC float32 in [0, 1].

Each random op is split in two: :func:`draw_augment_params` draws every
parameter from an explicit ``torch.Generator`` (on its device, where the
crop box and the rotation's cos and sin are also derived), and
:func:`apply_augment` applies them with no randomness and nothing but
correctly rounded arithmetic (:func:`div` where CUDA would not round a
division so), a mean and the blur's exp. A test can so
feed the parameters JAX drew and compare the outputs exactly; the draws
themselves cannot match JAX's stream and are compared by distribution.

The arithmetic follows JAX's expression for expression (the same order
of operations, floor modulo for the hue, the bilinear weights taken from
the floor before it is clamped), so that it agrees with JAX and with
itself across devices to float32 rounding. :func:`eval_preprocess`
resizes with ``antialias=True``: ``jax.image.resize`` antialiases when it
downscales, and without it the 256 → 224 resize differs from JAX by up to
0.2.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` correctly rounded on every device: for a Python-scalar
    divisor CUDA multiplies by its reciprocal, which is one ulp off at
    times, and one ulp of a crop height moves the normalised 256-px
    output by 3.5e-5 (``chip_smoke.py``'s augment phase, H100)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def normalize(images: torch.Tensor) -> torch.Tensor:
    mean, std = (torch.tensor(v, dtype=images.dtype).to(images.device,
                                                        non_blocking=True)
                 for v in (IMAGENET_MEAN, IMAGENET_STD))
    return (images - mean) / std


def bilinear_sample(images: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """Per-sample bilinear sampling: images (B,H,W,C), source coordinates
    ys/xs (B,Ho,Wo) in pixel units → (B,Ho,Wo,C). The weights come from
    the unclamped floor, then the corners are clamped into the image (the
    border rule of JAX's ``_bilinear_sample``)."""
    b, h, w, _ = images.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    y0 = y0.long().clamp(0, h - 1)
    x0 = x0.long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)

    bidx = torch.arange(b, device=images.device)[:, None, None]
    p00 = images[bidx, y0, x0]
    p01 = images[bidx, y0, x1]
    p10 = images[bidx, y1, x0]
    p11 = images[bidx, y1, x1]
    top = p00 * (1 - wx) + p01 * wx
    bot = p10 * (1 - wx) + p11 * wx
    return top * (1 - wy) + bot * wy


def _uniform(generator, n, lo, hi):
    u = torch.rand(n, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def _rrc_box(generator, b, h, w, scale_min, scale_max,
             ratio=(3 / 4, 4 / 3)):
    """RandomResizedCrop box (JAX's single-try variant: the aspect ratio
    is clamped so the box always fits) → (y0, x0, ch, cw), each (B,)."""
    area = h * w * _uniform(generator, b, scale_min, scale_max)
    log_r = _uniform(generator, b, math.log(ratio[0]), math.log(ratio[1]))
    # cw = sqrt(area·r) ≤ w  ⇔  r ≤ w²/area;  ch ≤ h  ⇔  r ≥ area/h²
    r = torch.minimum(torch.maximum(torch.exp(log_r), area / (h * h)),
                      (w * w) / area)
    cw = torch.sqrt(area * r)
    ch = torch.sqrt(area / r)
    y0 = torch.rand(b, generator=generator, device=generator.device) * (
        h - ch)
    x0 = torch.rand(b, generator=generator, device=generator.device) * (
        w - cw)
    return y0, x0, ch, cw


def draw_augment_params(generator: torch.Generator, b: int, h: int, w: int,
                        scale_min: float = 0.8, hflip_prob: float = 0.5,
                        jitter: tuple = (0.2, 0.2, 0.2, 0.1),
                        rotation_deg: float = 10.0,
                        blur_sigma: tuple = (0.1, 0.5)) -> dict:
    """Every random parameter of :func:`apply_augment` for a (B,H,W,3)
    batch, drawn on the generator's device. A jitter strength of 0 gives
    None for its factor (the op is skipped, as in JAX)."""
    y0, x0, ch, cw = _rrc_box(generator, b, h, w, scale_min, 1.0)
    theta = torch.deg2rad(_uniform(generator, b, -rotation_deg,
                                   rotation_deg))
    flip = torch.rand(b, generator=generator,
                      device=generator.device) < hflip_prob
    bright, contrast, sat, hue = jitter
    factor = (lambda x: _uniform(generator, b, 1 - x, 1 + x)  # noqa: E731
              if x > 0 else None)
    # cos and sin are taken here, on the generator's device: the card's
    # cosf is not the CPU's, and one ulp of cos moved a normalised output
    # by 0.27 where a rotated sample crossed a negative integer coordinate
    # (bilinear_sample's border rule jumps there; chip_smoke.py's augment
    # phase, H100)
    return {"y0": y0, "x0": x0, "ch": ch, "cw": cw,
            "cos": torch.cos(theta), "sin": torch.sin(theta), "flip": flip,
            "brightness": factor(bright), "contrast": factor(contrast),
            "saturation": factor(sat),
            "hue": _uniform(generator, b, -hue, hue) if hue > 0 else None,
            "sigma": _uniform(generator, b, blur_sigma[0], blur_sigma[1])}


def crop_flip_rotate(images: torch.Tensor, params: dict,
                     out_size: int) -> torch.Tensor:
    """Rotation ∘ flip ∘ crop-resize as one bilinear resample →
    (B, out, out, C)."""
    dev = images.device
    oy = (torch.arange(out_size, dtype=torch.float32, device=dev)
          + 0.5)[None, :, None]
    ox = (torch.arange(out_size, dtype=torch.float32, device=dev)
          + 0.5)[None, None, :]
    cy = cx = out_size / 2.0           # rotate about the output centre
    cos = params["cos"][:, None, None]
    sin = params["sin"][:, None, None]
    ry = cy + (oy - cy) * cos - (ox - cx) * sin
    rx = cx + (oy - cy) * sin + (ox - cx) * cos
    rx = torch.where(params["flip"][:, None, None], out_size - rx, rx)
    sy = div(params["ch"], out_size)[:, None, None]   # into the crop box
    sx = div(params["cw"], out_size)[:, None, None]
    ys = params["y0"][:, None, None] + ry * sy - 0.5
    xs = params["x0"][:, None, None] + rx * sx - 0.5
    return bilinear_sample(images, ys, xs)


def _gray(images):
    return (0.2989 * images[..., 0] + 0.587 * images[..., 1]
            + 0.114 * images[..., 2])


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    v = maxc
    rng = maxc - minc
    s = torch.where(maxc > 0, rng / maxc.clamp(min=1e-12), 0.0)
    safe = rng.clamp(min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(div(h, 6.0), 1.0)     # floor modulo, as jnp's %
    h = torch.where(rng == 0, 0.0, h)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.long(), 6)[..., None]
    pick = lambda *c: torch.stack(c, -1).gather(-1, i)[..., 0]  # noqa: E731
    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def color_jitter(images: torch.Tensor, params: dict) -> torch.Tensor:
    """torchvision ColorJitter with a fixed op order (brightness,
    contrast, saturation, hue), per-sample factors from ``params``."""
    b = images.shape[0]
    if params["brightness"] is not None:
        images = images * params["brightness"].reshape(b, 1, 1, 1)
    if params["contrast"] is not None:
        # blend with the mean of the grayscale image
        mean = _gray(images).mean(dim=(1, 2)).reshape(b, 1, 1, 1)
        images = (images - mean) * params["contrast"].reshape(
            b, 1, 1, 1) + mean
    images = images.clamp(0.0, 1.0)
    if params["saturation"] is not None:
        # blend with the grayscale image (not an HSV S-multiply)
        gray = _gray(images)[..., None]
        images = (gray + (images - gray) * params["saturation"].reshape(
            b, 1, 1, 1)).clamp(0.0, 1.0)
    if params["hue"] is not None:
        hsv = rgb_to_hsv(images)
        hue = torch.remainder(hsv[..., 0] + params["hue"].reshape(b, 1, 1),
                              1.0)
        images = hsv_to_rgb(torch.stack([hue, hsv[..., 1], hsv[..., 2]],
                                        dim=-1))
    return images.clamp(0.0, 1.0)


def gaussian_blur(images: torch.Tensor, sigma: torch.Tensor,
                  kernel_hw=(9, 5)) -> torch.Tensor:
    """Separable Gaussian blur with per-sample σ (B,): a 9-tap vertical
    pass, then a 5-tap horizontal pass, each over an edge-padded copy
    (padding by clamped indices on the NHWC layout)."""
    b, h, w, _ = images.shape
    kh, kw = kernel_hw
    s = sigma.reshape(b, 1)
    dev = images.device

    def kern(n):
        x = torch.arange(n, dtype=torch.float32, device=dev) - (n - 1) / 2
        k = torch.exp(-(x[None, :] ** 2) / (2 * s ** 2))
        return k / k.sum(dim=1, keepdim=True)        # (B, n)

    ky, kx = kern(kh), kern(kw)
    rows = torch.arange(-(kh // 2), h + kh // 2, device=dev).clamp(0, h - 1)
    x = images[:, rows]
    out = torch.zeros_like(images)
    for i in range(kh):
        out = out + x[:, i:i + h] * ky[:, i].reshape(b, 1, 1, 1)
    cols = torch.arange(-(kw // 2), w + kw // 2, device=dev).clamp(0, w - 1)
    x = out[:, :, cols]
    out = torch.zeros_like(images)
    for i in range(kw):
        out = out + x[:, :, i:i + w] * kx[:, i].reshape(b, 1, 1, 1)
    return out


def apply_augment(images: torch.Tensor, params: dict,
                  out_size: int = 224) -> torch.Tensor:
    """(B,H,W,3) float32 [0,1] and drawn ``params`` → (B,out,out,3)
    normalised: geometry, colour jitter, blur, normalise."""
    out = crop_flip_rotate(images, params, out_size)
    out = color_jitter(out, params)
    out = gaussian_blur(out, params["sigma"])
    return normalize(out)


def augment_batch(generator: torch.Generator, images: torch.Tensor,
                  out_size: int = 224, scale_min: float = 0.8,
                  hflip_prob: float = 0.5,
                  jitter: tuple = (0.2, 0.2, 0.2, 0.1),
                  rotation_deg: float = 10.0,
                  blur_sigma: tuple = (0.1, 0.5)) -> torch.Tensor:
    """The full train-time augmentation: draw (on the generator's
    device), then apply (on the images')."""
    b, h, w, _ = images.shape
    params = draw_augment_params(generator, b, h, w, scale_min, hflip_prob,
                                 jitter, rotation_deg, blur_sigma)
    params = {k: None if v is None else v.to(images.device)
              for k, v in params.items()}
    return apply_augment(images, params, out_size)


def eval_preprocess(images: torch.Tensor, out_size: int = 224
                    ) -> torch.Tensor:
    """Eval path: antialiased bilinear resize + normalise."""
    out = F.interpolate(images.permute(0, 3, 1, 2), size=(out_size, out_size),
                        mode="bilinear", align_corners=False, antialias=True)
    return normalize(out.permute(0, 2, 3, 1))
