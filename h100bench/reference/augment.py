"""Plain reference of the training input transform: uint8 NHWC staging
images → /255 → RandomResizedCrop (scale 0.8–1, ratio 3/4–4/3, the box
clamped to fit), horizontal flip (0.5), rotation (±10°) as one bilinear
resample about the output centre → ColorJitter (brightness, contrast,
saturation 0.2, hue 0.1, in that order) → GaussianBlur (9 tall × 5 wide,
σ 0.1–0.5, edges clamped) → ImageNet normalisation; and the features'
per-class NaN imputation from the train split's per-class means.

The random parameters are drawn from the step's augment generator in the
order the program draws them (area, log-ratio, y, x, angle, flip,
brightness, contrast, saturation, hue, σ: one ``rand`` of B each), so the
reference works the same parameters out again from the same seed. The
arithmetic is a frozen copy of the program's plain formulas, in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _div(x, c):
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _uniform(g, n, lo, hi):
    return torch.rand(n, generator=g, device=g.device) * (hi - lo) + lo


def draw(g, b, h, w, aug: dict) -> dict:
    area = h * w * _uniform(g, b, aug["scale_min"], 1.0)
    log_r = _uniform(g, b, math.log(3 / 4), math.log(4 / 3))
    r = torch.minimum(torch.maximum(torch.exp(log_r), area / (h * h)),
                      (w * w) / area)
    cw, ch = torch.sqrt(area * r), torch.sqrt(area / r)
    y0 = torch.rand(b, generator=g, device=g.device) * (h - ch)
    x0 = torch.rand(b, generator=g, device=g.device) * (w - cw)
    theta = torch.deg2rad(_uniform(g, b, -aug["rotation_deg"],
                                   aug["rotation_deg"]))
    flip = torch.rand(b, generator=g, device=g.device) < aug["hflip_prob"]
    jb, jc, js, jh = aug["jitter"]
    return {"y0": y0, "x0": x0, "ch": ch, "cw": cw, "cos": torch.cos(theta),
            "sin": torch.sin(theta), "flip": flip,
            "brightness": _uniform(g, b, 1 - jb, 1 + jb),
            "contrast": _uniform(g, b, 1 - jc, 1 + jc),
            "saturation": _uniform(g, b, 1 - js, 1 + js),
            "hue": _uniform(g, b, -jh, jh),
            "sigma": _uniform(g, b, *aug["blur_sigma"])}


def _sample(img, ys, xs):
    b, h, w, _ = img.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[..., None], (xs - x0)[..., None]
    y0 = y0.long().clamp(0, h - 1)
    x0 = x0.long().clamp(0, w - 1)
    y1, x1 = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)
    bi = torch.arange(b, device=img.device)[:, None, None]
    top = img[bi, y0, x0] * (1 - wx) + img[bi, y0, x1] * wx
    bot = img[bi, y1, x0] * (1 - wx) + img[bi, y1, x1] * wx
    return top * (1 - wy) + bot * wy


def _geometry(img, p, n):
    dev = img.device
    oy = (torch.arange(n, dtype=img.dtype, device=dev) + 0.5)[None, :, None]
    ox = (torch.arange(n, dtype=img.dtype, device=dev) + 0.5)[None, None, :]
    c = n / 2.0
    cos, sin = p["cos"][:, None, None], p["sin"][:, None, None]
    ry = c + (oy - c) * cos - (ox - c) * sin
    rx = c + (oy - c) * sin + (ox - c) * cos
    rx = torch.where(p["flip"][:, None, None], n - rx, rx)
    ys = p["y0"][:, None, None] + ry * _div(p["ch"], n)[:, None, None] - 0.5
    xs = p["x0"][:, None, None] + rx * _div(p["cw"], n)[:, None, None] - 0.5
    return _sample(img, ys, xs)


def _gray(x):
    return 0.2989 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def _hue_shift(rgb, shift):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc, minc = rgb.amax(dim=-1), rgb.amin(dim=-1)
    rng = maxc - minc
    s = torch.where(maxc > 0, rng / maxc.clamp(min=1e-12), 0.0)
    safe = rng.clamp(min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(_div(h, 6.0), 1.0)
    h = torch.where(rng == 0, 0.0, h)
    h = torch.remainder(h + shift, 1.0)
    v = maxc
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p_, q_, t_ = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = torch.remainder(i.long(), 6)[..., None]

    def pick(*c):
        return torch.stack(c, -1).gather(-1, i)[..., 0]

    return torch.stack([pick(v, q_, p_, p_, t_, v), pick(t_, v, v, q_, p_, p_),
                        pick(p_, p_, t_, v, v, q_)], dim=-1)


def _jitter(x, p):
    b = x.shape[0]
    x = x * p["brightness"].reshape(b, 1, 1, 1)
    mean = _gray(x).mean(dim=(1, 2)).reshape(b, 1, 1, 1)
    x = ((x - mean) * p["contrast"].reshape(b, 1, 1, 1) + mean).clamp(0, 1)
    gray = _gray(x)[..., None]
    x = (gray + (x - gray) * p["saturation"].reshape(b, 1, 1, 1)).clamp(0, 1)
    x = _hue_shift(x, p["hue"].reshape(b, 1, 1))
    return x.clamp(0.0, 1.0)


def _blur(x, sigma, kh=9, kw=5):
    b, h, w, _ = x.shape
    s = sigma.reshape(b, 1)
    dev = x.device

    def kern(n):
        t = torch.arange(n, dtype=x.dtype, device=dev) - (n - 1) / 2
        k = torch.exp(-(t[None, :] ** 2) / (2 * s ** 2))
        return k / k.sum(dim=1, keepdim=True)

    ky, kx = kern(kh), kern(kw)
    rows = torch.arange(-(kh // 2), h + kh // 2, device=dev).clamp(0, h - 1)
    src = x[:, rows]
    out = torch.zeros_like(x)
    for i in range(kh):
        out = out + src[:, i:i + h] * ky[:, i].reshape(b, 1, 1, 1)
    cols = torch.arange(-(kw // 2), w + kw // 2, device=dev).clamp(0, w - 1)
    src = out[:, :, cols]
    out = torch.zeros_like(x)
    for i in range(kw):
        out = out + src[:, :, i:i + w] * kx[:, i].reshape(b, 1, 1, 1)
    return out


def _normalize(x):
    mean = torch.tensor(MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def augment(images_u8: torch.Tensor, generator, out_size: int,
            aug: dict, dtype=torch.float32) -> torch.Tensor:
    """uint8 (B,S,S,3) on the device → normalised f32 (B,out,out,3),
    computed in ``dtype`` (float32; bfloat16 for the control)."""
    x = _div(images_u8.float(), 255.0).to(dtype)
    b, h, w, _ = x.shape
    p = draw(generator, b, h, w, aug)
    p = {k: v.to(x.device) if v.dtype == torch.bool
         else v.to(x.device, dtype) for k, v in p.items()}
    x = _geometry(x, p, out_size)
    x = _jitter(x, p)
    x = _blur(x, p["sigma"])
    return _normalize(x).float()


def class_means(feats: np.ndarray, labels: np.ndarray,
                classes: int) -> np.ndarray:
    """(classes, F) float32 NaN-aware means of the train split; a class
    with no rows, or a feature NaN in every row, gives 0."""
    out = np.zeros((classes, feats.shape[1]), np.float32)
    for c in range(classes):
        rows = feats[labels == c]
        if len(rows):
            with np.errstate(all="ignore"):
                out[c] = np.nan_to_num(np.nanmean(rows, axis=0))
    return out


def impute(feats: torch.Tensor, labels: torch.Tensor,
           means: torch.Tensor) -> torch.Tensor:
    """NaN → the sample's class mean, any NaN left → 0."""
    m = means[labels.long()]
    return torch.nan_to_num(torch.where(torch.isnan(feats), m, feats))
