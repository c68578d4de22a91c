"""The benchmark's own operation and byte counts, from a configuration's
shapes, and the peaks they are divided by. A kernel change in the program
cannot move them.

- :func:`forward_flops`: the multiply-adds (2 FLOP each) of every
  convolution and matrix product of one image's forward pass. Norms,
  activations, pools and the loss are left out, as a FLOP counter over
  convolutions and products leaves them out.
- :func:`train_flops`: forward and backward of the trainable layers: the
  backward takes the weight gradient and the input gradient of each layer
  (two forward's worth), except the input gradients of the layers that
  read the inputs (the images into the stem, the features into the MLP).
- :func:`quadrant_count`, :func:`fusion_head_count`: the (FLOPs, bytes)
  of one call of the two hand kernels' operators at a batch, each input
  read once at the dtype it is handed over in and each output written
  once; the training forms also write their residual (``act``, ``h``).
  A roofline share divides the least time these need on the card
  (:func:`bound_s`) by the device time attributed to the operator, so a
  later kernel under the same operator, of any name, reads against the
  same work.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 tensor rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

_BYTES = {"bfloat16": 2, "float32": 4}


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _conv(cin, cout, k, s, p, n):
    m = _out(n, k, s, p)
    return 2 * cin * cout * k * k * m * m, m


def trunk_flops(arch: str, image_size: int) -> dict:
    """{"stem": FLOPs of the stem conv, "total": all convs, "layer3":
    side of the layer3 map, "channels": output channels}."""
    bottleneck, sizes = {"resnet18": (False, (2, 2, 2, 2)),
                         "resnet50": (True, (3, 4, 6, 3))}[arch]
    stem, n = _conv(3, 64, 7, 2, 3, image_size)
    total = stem
    n = _out(n, 3, 2, 1)                       # max pool
    cin, side3 = 64, None
    for i, blocks in enumerate(sizes):
        filters = 64 * 2 ** i
        for j in range(blocks):
            s = 2 if (i > 0 and j == 0) else 1
            if bottleneck:
                cout = 4 * filters
                f1, _ = _conv(cin, filters, 1, 1, 0, n)
                f2, m = _conv(filters, filters, 3, s, 1, n)
                f3, _ = _conv(filters, cout, 1, 1, 0, m)
                f = f1 + f2 + f3
            else:
                cout = filters
                f1, m = _conv(cin, filters, 3, s, 1, n)
                f2, _ = _conv(filters, filters, 3, 1, 1, m)
                f = f1 + f2
            if cin != cout or s != 1:
                f += _conv(cin, cout, 1, s, 0, n)[0]
            total += f
            n, cin = m, cout
        if i == 2:
            side3 = n
    return {"stem": stem, "total": total, "layer3": side3, "channels": cin}


def head_in(model: dict, image_size: int) -> int:
    """The fusion head's input width at ``image_size``."""
    t = trunk_flops(model["backbone"], image_size)
    d = t["channels"] + model["mlp"][2]
    if model["family"] == "quadtree":
        d += 4 * (t["layer3"] // 4) ** 2 * model["quadrant_channels"]
    return d


def forward_flops(model: dict, image_size: int) -> int:
    t = trunk_flops(model["backbone"], image_size)
    total = t["total"]
    if model["family"] == "quadtree":
        half = t["layer3"] // 2
        total += (4 * 2 * model["layer3_channels"]
                  * model["quadrant_channels"] * 9 * half * half)
    f, hid, mo = model["mlp"]
    total += 2 * (f * hid + hid * mo)
    _, h, c = model["head"]
    total += 2 * (head_in(model, image_size) * h + h * c)
    return total


def train_flops(model: dict, image_size: int) -> int:
    t = trunk_flops(model["backbone"], image_size)
    f, hid, _ = model["mlp"]
    fwd = forward_flops(model, image_size)
    return 3 * fwd - t["stem"] - 2 * f * hid


def quadrant_count(model: dict, image_size: int, batch: int,
                   training: bool, param_dtype: str,
                   act_dtype: str = "bfloat16") -> tuple:
    side = trunk_flops(model["backbone"], image_size)["layer3"]
    cin, cout = model["layer3_channels"], model["quadrant_channels"]
    a, w = _BYTES[act_dtype], _BYTES[param_dtype]
    half, pooled = side // 2, side // 4
    flops = batch * 4 * 2 * cin * cout * 9 * half * half
    nbytes = (batch * side * side * cin * a + 9 * cin * cout * w + cout * w
              + batch * 4 * pooled * pooled * cout * a)
    if training:
        nbytes += batch * side * side * cout * a          # act
    return flops, nbytes


def fusion_head_count(model: dict, image_size: int, batch: int,
                      training: bool, param_dtype: str,
                      act_dtype: str = "bfloat16") -> tuple:
    d = head_in(model, image_size)
    _, h, c = model["head"]
    a, w = _BYTES[act_dtype], _BYTES[param_dtype]
    flops = 2 * batch * (d * h + h * c)
    nbytes = (batch * d * a + (h * d + h + c * h + c) * w + batch * c * 4)
    if training:
        nbytes += batch * h * a                             # h
    return flops, nbytes


def bound_s(count: tuple) -> float:
    """The least seconds the card needs for (FLOPs, bytes)."""
    flops, nbytes = count
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def sized(model: dict, image_size: int) -> dict:
    """A configuration's model section with the head's input width at
    ``image_size`` (the CPU tests run smaller images)."""
    m = dict(model)
    d = head_in(m, image_size)
    hidden = d // 2 if m["family"] == "quadtree" else m["head"][1]
    m["head"] = [d, hidden, m["head"][2]]
    return m
