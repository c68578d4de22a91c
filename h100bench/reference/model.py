"""Plain PyTorch reference of the two benchmarked models, written from the
architectures and from nothing of the program.

Functional form: a model is a dict of named tensors (the parameter and
buffer names the port's ``state_dict`` uses, so one dict of weights made
by the benchmark goes to both sides) and :func:`forward` applies it.
Tensors are NCHW float32 inside; the images come in NHWC, as the
program takes them.

- ResNet-18 / ResNet-50 trunks (He et al., arXiv:1512.03385): 7×7/2 stem,
  3×3/2 max pool, basic or bottleneck blocks with the stride on the 3×3
  conv, a 1×1 projection where the shape changes. BatchNorm: eps 1e-5;
  train mode normalises with the batch mean and biased variance and
  moves the running statistics by ``r ← 0.9·r + 0.1·batch`` with the
  biased variance.
- ``quadtree``: the layer3 map (14×14×256 at 224 px) split into four 7×7
  quadrants (quadrant-major), each zero-padded alone, one shared 3×3
  conv 256→128 + bias, ReLU, 2×2/2 max pool (VALID), flattened in
  (quadrant, row, column, channel) order → 4608; beside it layer4's
  global average pool → 512.
- ``standard_multimodal``: layer4's global average pool alone.
- Numerical MLP 47 → 94 → ReLU → dropout → 256 (no final activation),
  concatenated after the image features; fusion head
  D → H → ReLU → dropout → classes.

Dropout draws what the program's streams draw, so that a train step can
be followed exactly: the MLP's mask is ``rand((B, 94)) >= rate`` from the
step's dropout generator, then the head's 62-bit seed is one ``randint``
from the same generator, and its mask is the first word of
Philox4x32-10 keyed by that seed at counter (row, unit, 0, 0), kept where
the bits are at least ``rate·2³²``. Kept units are scaled by
``1/(1-rate)``.

``Precision`` sets how the operands of every convolution and matrix
product are rounded before an f32 product with TF32 off: not at all (the
reference) or to float8 e4m3 with one scale a tensor (the control: the
precision below the configuration's bfloat16).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_M32 = 0xFFFFFFFF
FP8_MAX = 448.0   # largest finite float8 e4m3fn


class Precision:
    """Rounding of conv and matmul operands: ``"f32"`` or ``"fp8"``."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision must be f32 or fp8, got {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return x
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = FP8_MAX / amax
        r = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return x + (r - x.detach())   # rounded forward, straight through

    def conv(self, x, w, bias=None, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(w), bias, stride, padding)

    def linear(self, x, w, b):
        return F.linear(self.q(x), self.q(w), b)


# ---------------------------------------------------------------------------
# Shapes: every leaf of a configuration, in the port's names
# ---------------------------------------------------------------------------

def _bn(prefix, c, out):
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        out[f"{prefix}.{leaf}"] = (c,)


def _conv(name, cout, cin, k, out):
    out[f"{name}.weight"] = (cout, cin, k, k)


def resnet_leaves(prefix: str, arch: str, out: dict) -> int:
    """Fill ``out`` with the trunk's leaves → its output channels."""
    bottleneck, sizes = {"resnet18": (False, (2, 2, 2, 2)),
                         "resnet50": (True, (3, 4, 6, 3))}[arch]
    _conv(f"{prefix}conv1", 64, 3, 7, out)
    _bn(f"{prefix}bn1", 64, out)
    cin = 64
    for i, n in enumerate(sizes):
        filters = 64 * 2 ** i
        for j in range(n):
            stride = 2 if (i > 0 and j == 0) else 1
            p = f"{prefix}layer{i + 1}_block{j}."
            if bottleneck:
                cout = filters * 4
                _conv(p + "conv1", filters, cin, 1, out)
                _bn(p + "bn1", filters, out)
                _conv(p + "conv2", filters, filters, 3, out)
                _bn(p + "bn2", filters, out)
                _conv(p + "conv3", cout, filters, 1, out)
                _bn(p + "bn3", cout, out)
            else:
                cout = filters
                _conv(p + "conv1", filters, cin, 3, out)
                _bn(p + "bn1", filters, out)
                _conv(p + "conv2", filters, filters, 3, out)
                _bn(p + "bn2", filters, out)
            if cin != cout or stride != 1:
                _conv(p + "downsample_conv", cout, cin, 1, out)
                _bn(p + "downsample_bn", cout, out)
            cin = cout
    return cin


def trunk_prefix(model: dict) -> str:
    return "trunk." if model["family"] == "quadtree" else "trunk.resnet."


def leaf_shapes(model: dict) -> dict:
    """{name: shape} of every parameter and buffer of a configuration's
    ``model`` section, in the port's ``state_dict`` names."""
    out: dict = {}
    resnet_leaves(trunk_prefix(model), model["backbone"], out)
    if model["family"] == "quadtree":
        c3, qc = model["layer3_channels"], model["quadrant_channels"]
        out["quadrant_conv_kernel"] = (3, 3, c3, qc)   # HWIO
        out["quadrant_conv_bias"] = (qc,)
    f, hid, mo = model["mlp"]
    out["numerical_mlp.fc1.weight"] = (hid, f)
    out["numerical_mlp.fc1.bias"] = (hid,)
    out["numerical_mlp.fc2.weight"] = (mo, hid)
    out["numerical_mlp.fc2.bias"] = (mo,)
    d, h, c = model["head"]
    out["classifier.fc1.weight"] = (h, d)
    out["classifier.fc1.bias"] = (h,)
    out["classifier.fc2.weight"] = (c, h)
    out["classifier.fc2.bias"] = (c,)
    return out


def is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def fan_in(name: str, shape: tuple) -> int | None:
    """Inputs a weight's output unit sums over; None for a bias or a norm
    leaf."""
    if name == "quadrant_conv_kernel":
        return shape[0] * shape[1] * shape[2]
    if name.endswith(".weight") and len(shape) in (2, 4):
        return math.prod(shape[1:])
    return None


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def batch_norm(x, P, name, train, stats):
    """BatchNorm of NCHW ``x``; in train mode the batch's (mean, biased
    variance) go to ``stats[name]``."""
    w, b = P[name + ".weight"], P[name + ".bias"]
    if not train:
        return F.batch_norm(x, P[name + ".running_mean"],
                            P[name + ".running_var"], w, b, False, 0.0, 1e-5)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    stats[name] = (mean.detach(), var.detach())
    shape = (1, -1, 1, 1)
    return ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + 1e-5)
            * w.view(shape) + b.view(shape))


def resnet(x, P, prefix, arch, train, stats, prec, upto_layer3=False):
    """NCHW ``x`` → {"layer3": map, "out": layer4 map}."""
    bottleneck, sizes = {"resnet18": (False, (2, 2, 2, 2)),
                         "resnet50": (True, (3, 4, 6, 3))}[arch]

    def cbn(x, name, bn, stride, pad):
        y = prec.conv(x, P[prefix + name + ".weight"], None, stride, pad)
        return batch_norm(y, P, prefix + bn, train, stats)

    x = F.relu(cbn(x, "conv1", "bn1", 2, 3))
    x = F.max_pool2d(x, 3, 2, 1)
    outs = {}
    for i, n in enumerate(sizes):
        for j in range(n):
            stride = 2 if (i > 0 and j == 0) else 1
            p = f"layer{i + 1}_block{j}."
            if bottleneck:
                y = F.relu(cbn(x, p + "conv1", p + "bn1", 1, 0))
                y = F.relu(cbn(y, p + "conv2", p + "bn2", stride, 1))
                y = cbn(y, p + "conv3", p + "bn3", 1, 0)
            else:
                y = F.relu(cbn(x, p + "conv1", p + "bn1", stride, 1))
                y = cbn(y, p + "conv2", p + "bn2", 1, 1)
            r = x
            if prefix + p + "downsample_conv.weight" in P:
                r = cbn(x, p + "downsample_conv", p + "downsample_bn",
                        stride, 0)
            x = F.relu(y + r)
        if i == 2:
            outs["layer3"] = x
    outs["out"] = x
    return outs


def quadrant_block(fmap, kernel, bias, prec):
    """(B, C, H, H) → (B, 4·(H/4)²·Cout) in (q, ph, pw, c) order."""
    b, c, h, _ = fmap.shape
    hh = h // 2
    q = fmap.reshape(b, c, 2, hh, 2, hh).permute(0, 2, 4, 1, 3, 5)
    q = q.reshape(b * 4, c, hh, hh)          # quadrant-major, each alone
    w = kernel.permute(3, 2, 0, 1)           # HWIO → OIHW
    y = F.relu(prec.conv(q, w, None, 1, 1) + bias.view(1, -1, 1, 1))
    y = F.max_pool2d(y, 2, 2)                # VALID: 7 → 3
    return y.permute(0, 2, 3, 1).reshape(b, -1)


def philox_bits(seed: int, rows: int, units: int, device) -> torch.Tensor:
    """(rows, units) int64 of the first Philox4x32-10 word for key
    (seed low, seed high) and counter (row, unit, 0, 0)."""
    row = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    unit = torch.arange(units, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros((rows, units), dtype=torch.int64, device=device)
    c0, c1, c2, c3 = row + zero, unit + zero, zero, zero
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    for _ in range(10):
        p0, p1 = c0 * 0xD2511F53, c2 * 0xCD9E8D57
        c0, c1, c2, c3 = (((p1 >> 32) & _M32) ^ c1 ^ k0, p1 & _M32,
                          ((p0 >> 32) & _M32) ^ c3 ^ k1, p0 & _M32)
        k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
    return c0


def forward(model: dict, P: dict, images, feats, *, train: bool,
            generator=None, prec: Precision | None = None,
            stats: dict | None = None):
    """NHWC f32 images and (B, F) features → (B, classes) f32 logits.
    ``generator``: the step's dropout stream (train mode). ``stats``
    receives each BatchNorm's batch (mean, biased variance) in train
    mode."""
    prec = prec or Precision()
    stats = {} if stats is None else stats
    x = images.permute(0, 3, 1, 2)
    outs = resnet(x, P, trunk_prefix(model), model["backbone"], train,
                  stats, prec)
    gap = outs["out"].mean(dim=(2, 3))
    parts = [gap]
    if model["family"] == "quadtree":
        parts.append(quadrant_block(outs["layer3"], P["quadrant_conv_kernel"],
                                    P["quadrant_conv_bias"], prec))
    rate = model["dropout"]
    h = F.relu(prec.linear(feats, P["numerical_mlp.fc1.weight"],
                           P["numerical_mlp.fc1.bias"]))
    if train:
        keep = torch.rand(h.shape, generator=generator,
                          device=h.device) >= rate
        h = torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))
    num = prec.linear(h, P["numerical_mlp.fc2.weight"],
                      P["numerical_mlp.fc2.bias"])
    z = torch.cat(parts + [num], dim=-1)
    h = F.relu(prec.linear(z, P["classifier.fc1.weight"],
                           P["classifier.fc1.bias"]))
    if train:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=h.device, dtype=torch.int64))
        keep = philox_bits(seed, h.shape[0], h.shape[1], h.device) >= min(
            int(round(rate * 2 ** 32)), 2 ** 32 - 1)
        h = torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))
    return prec.linear(h, P["classifier.fc2.weight"],
                       P["classifier.fc2.bias"])
