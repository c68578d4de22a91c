"""U²-Net salient-object segmentation on the card, ported from
``surya_tpu/models/segmentation/u2net.py``.

The reference's background-removal stage calls ``rembg.remove()``
(``Background_remove/batch_remove_background.py:114``), which runs U²-Net
(Qin et al. 2020, the ``u2net``/``u2netp`` onnx files). This is that model,
both configurations, with the canonical torch names
(``stage1.rebnconvin.conv_s1``, ``bn_s1``, ``side1``, ``outconv``), so
:func:`import_u2net` is a strict load of a published ``.pth`` and
``models.from_jax.from_jax_variables`` maps the flax tree one to one. The
interface is NHWC, as in JAX.

- BatchNorm is flax's (``models/backbones/resnet.py::BatchNorm``): eval
  mode on the running statistics; train mode on the batch's, moving the
  running ones with momentum 0.9 and the biased variance;
- 2×2/2 max pooling in ceil mode (torch's ``ceil_mode=True`` is JAX's
  −inf padding of odd edges);
- ``_upsample_like`` is bilinear at half-pixel centres
  (``F.interpolate(align_corners=False)``); inside the net it only grows
  a map, where ``jax.image.resize`` does the same;
- :func:`saliency` resizes the input to ``size`` and the map back with
  ``antialias=True``: ``jax.image.resize`` antialiases when it shrinks
  (without it, a 96→64 shrink of 0–255 data is up to 58 levels off);
- :func:`u2net_loss` is the paper's deep-supervision BCE sum.

No pretrained weights ship: weights come from a seed or a converted file.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.models.backbones.resnet import BatchNorm, Conv
from surya_tpu_torch.models.common import load_state, on_meta, reset_model

# Per-stage specs: (kind, height L or None, mid, out). Encoder stages 1-6
# then decoder stages 5d-1d; decoder input = concat(up, skip).
_CONFIGS = {
    "u2net": {
        "enc": [("rsu", 7, 32, 64), ("rsu", 6, 32, 128),
                ("rsu", 5, 64, 256), ("rsu", 4, 128, 512),
                ("rsu4f", None, 256, 512), ("rsu4f", None, 256, 512)],
        "dec": [("rsu4f", None, 256, 512), ("rsu", 4, 128, 256),
                ("rsu", 5, 64, 128), ("rsu", 6, 32, 64),
                ("rsu", 7, 16, 64)],
    },
    "u2netp": {
        "enc": [("rsu", 7, 16, 64), ("rsu", 6, 16, 64),
                ("rsu", 5, 16, 64), ("rsu", 4, 16, 64),
                ("rsu4f", None, 16, 64), ("rsu4f", None, 16, 64)],
        "dec": [("rsu4f", None, 16, 64), ("rsu", 4, 16, 64),
                ("rsu", 5, 16, 64), ("rsu", 6, 16, 64),
                ("rsu", 7, 16, 64)],
    },
}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _maxpool_ceil(x: torch.Tensor) -> torch.Tensor:
    """2×2/2 max pool with torch ceil_mode=True semantics (NCHW)."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _upsample_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``ref``'s spatial size."""
    return F.interpolate(x, size=ref.shape[2:], mode="bilinear",
                         align_corners=False)


class REBNCONV(nn.Module):
    """Conv3×3 (dilated, biased) + BN + ReLU (``conv_s1``/``bn_s1``)."""

    def __init__(self, cin: int, cout: int, dilation: int = 1):
        super().__init__()
        self.conv_s1 = Conv(cin, cout, 3, padding=dilation, bias=True,
                            dilation=dilation)
        self.bn_s1 = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn_s1(self.conv_s1(x)))


class RSU(nn.Module):
    """Residual U-block of height L: L-2 internal ceil-mode pools down,
    bilinear ups back, a dilation-2 bridge at the bottom."""

    def __init__(self, height: int, cin: int, mid: int, out: int):
        super().__init__()
        self.height = height
        self.rebnconvin = REBNCONV(cin, out)
        self.rebnconv1 = REBNCONV(out, mid)
        for i in range(2, height):
            setattr(self, f"rebnconv{i}", REBNCONV(mid, mid))
        setattr(self, f"rebnconv{height}", REBNCONV(mid, mid, dilation=2))
        for i in range(height - 1, 1, -1):
            setattr(self, f"rebnconv{i}d", REBNCONV(2 * mid, mid))
        self.rebnconv1d = REBNCONV(2 * mid, out)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        enc = [self.rebnconv1(hxin)]
        hx = enc[0]
        for i in range(2, self.height):
            hx = getattr(self, f"rebnconv{i}")(_maxpool_ceil(hx))
            enc.append(hx)
        hx = getattr(self, f"rebnconv{self.height}")(enc[-1])
        for i in range(self.height - 1, 1, -1):
            hx = getattr(self, f"rebnconv{i}d")(torch.cat([hx, enc[i - 1]], 1))
            hx = _upsample_like(hx, enc[i - 2])
        return hxin + self.rebnconv1d(torch.cat([hx, enc[0]], 1))


class RSU4F(nn.Module):
    """Flat RSU-4: dilations 1/2/4/8 instead of pooling."""

    def __init__(self, cin: int, mid: int, out: int):
        super().__init__()
        self.rebnconvin = REBNCONV(cin, out)
        self.rebnconv1 = REBNCONV(out, mid, 1)
        self.rebnconv2 = REBNCONV(mid, mid, 2)
        self.rebnconv3 = REBNCONV(mid, mid, 4)
        self.rebnconv4 = REBNCONV(mid, mid, 8)
        self.rebnconv3d = REBNCONV(2 * mid, mid, 4)
        self.rebnconv2d = REBNCONV(2 * mid, mid, 2)
        self.rebnconv1d = REBNCONV(2 * mid, out, 1)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        hx1 = self.rebnconv1(hxin)
        hx2 = self.rebnconv2(hx1)
        hx3 = self.rebnconv3(hx2)
        hx4 = self.rebnconv4(hx3)
        hx3d = self.rebnconv3d(torch.cat([hx4, hx3], 1))
        hx2d = self.rebnconv2d(torch.cat([hx3d, hx2], 1))
        return hxin + self.rebnconv1d(torch.cat([hx2d, hx1], 1))


def _make_stage(spec, cin: int) -> nn.Module:
    kind, height, mid, out = spec
    if kind == "rsu4f":
        return RSU4F(cin, mid, out)
    return RSU(height, cin, mid, out)


class U2Net(nn.Module):
    """6-stage encoder / 5-stage decoder U²-Net with deep supervision.

    ``(B, H, W, 3) → (fused, sides)``: the fused saliency probability map
    (B, H, W, 1) f32 and the list [d1..d6] of side probabilities at input
    resolution. ``dtype`` is the compute dtype (f32 parameters)."""

    def __init__(self, variant: str = "u2netp", dtype=torch.float32,
                 generator=None):
        super().__init__()
        if variant not in _CONFIGS:
            raise ValueError(f"variant must be one of {sorted(_CONFIGS)}")
        self.variant, self.dtype = variant, dtype
        cfg = _CONFIGS[variant]
        cin = 3
        for i, spec in enumerate(cfg["enc"]):
            setattr(self, f"stage{i + 1}", _make_stage(spec, cin))
            cin = spec[3]
        enc_out = [s[3] for s in cfg["enc"]]
        up, dec_out = enc_out[5], []
        for i, spec in enumerate(cfg["dec"]):
            setattr(self, f"stage{5 - i}d",
                    _make_stage(spec, up + enc_out[4 - i]))
            up = spec[3]
            dec_out.append(up)
        heads = list(reversed(dec_out)) + [enc_out[5]]
        for i, c in enumerate(heads):
            setattr(self, f"side{i + 1}", Conv(c, 1, 3, padding=1, bias=True))
        self.outconv = Conv(6, 1, 1, bias=True)
        if generator is not None or not on_meta(self):
            self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        reset_model(self, generator)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        hx, enc = x, []
        for i in range(6):
            hx = getattr(self, f"stage{i + 1}")(hx)
            enc.append(hx)
            if i < 5:
                hx = _maxpool_ceil(hx)
        hx6 = enc[5]
        hx = _upsample_like(hx6, enc[4])
        dec = []
        for i in range(5):
            d = getattr(self, f"stage{5 - i}d")(torch.cat([hx, enc[4 - i]], 1))
            dec.append(d)
            if i < 4:
                hx = _upsample_like(d, enc[3 - i])
        sides = []
        for i, h in enumerate(list(reversed(dec)) + [hx6]):
            s = getattr(self, f"side{i + 1}")(h)
            sides.append(_upsample_like(s, x) if i else s)
        d0 = self.outconv(torch.cat(sides, 1))

        def sig(t):
            return torch.sigmoid(t.float()).permute(0, 2, 3, 1)

        return sig(d0), [sig(s) for s in sides]


def u2net_loss(fused, sides, target):
    """Deep-supervision loss: the sum of the BCEs of the fused and side
    probabilities against a (B,H,W,1) target in [0, 1]."""
    eps = 1e-7

    def bce(p):
        p = torch.clamp(p, eps, 1.0 - eps)
        return -torch.mean(target * torch.log(p)
                           + (1.0 - target) * torch.log(1.0 - p))

    return bce(fused) + sum(bce(s) for s in sides)


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of an NCHW float map:
    half-pixel centres, antialiased when it shrinks."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)


def saliency(model: U2Net, images_u8: torch.Tensor, size: int = 320
             ) -> torch.Tensor:
    """rembg's u2net matting on a batch: (B, H, W, 3) uint8 → (B, H, W)
    f32 alpha in [0, 1]. Bilinear resize to size², divide by the image's
    max, ImageNet mean/std; the fused map min-max normalised per image and
    resized back to the source size."""
    b, h, w, _ = images_u8.shape
    img = _resize(images_u8.float().permute(0, 3, 1, 2), (size, size))
    img = img / torch.clamp(img.amax(dim=(1, 2, 3), keepdim=True), min=1e-6)
    mean = img.new_tensor(IMAGENET_MEAN)[:, None, None]
    std = img.new_tensor(IMAGENET_STD)[:, None, None]
    fused, _ = model(((img - mean) / std).permute(0, 2, 3, 1))
    m = fused[..., 0]
    lo = m.amin(dim=(1, 2), keepdim=True)
    hi = m.amax(dim=(1, 2), keepdim=True)
    m = (m - lo) / torch.clamp(hi - lo, min=1e-6)
    return _resize(m[:, None], (h, w))[:, 0]


def saliency_fn(model: U2Net, size: int = 320):
    """(H, W, 3) uint8 → (H, W) f32 alpha, one image at a time (JAX's
    ``saliency_fn`` contract); runs on the image's device."""

    def fn(image_u8):
        with torch.inference_mode():
            return saliency(model, torch.as_tensor(image_u8)[None], size)[0]

    return fn


def import_u2net(state_dict, variant: str = "u2netp", device=None) -> U2Net:
    """A canonical torch U²-Net ``state_dict`` (``stage1.rebnconvin.
    conv_s1.weight`` naming, as published by xuebinqin/U-2-Net) → the
    port's model, strict (BN's ``num_batches_tracked`` is dropped: flax
    has no such counter)."""
    state = {k: v for k, v in state_dict.items()
             if not k.endswith("num_batches_tracked")}
    return load_state(lambda: U2Net(variant), state, device)
