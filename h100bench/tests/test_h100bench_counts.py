"""``counts.py`` against a FLOP counter on the plain reference, and the
kernel counts from their shapes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import counts
import harness as H
from reference import model as RM

CONFIGS = ["quadtree-fusion", "comparative-resnet50"]


@pytest.mark.parametrize("config", CONFIGS)
def test_forward_flops_match_a_flop_counter(config):
    """The analytic forward count equals ``FlopCounterMode`` over the
    reference's forward at batch 2 and the published 224 px."""
    spec = H.load_json(H.HERE / "configs" / f"{config}.json")
    model = spec["model"]
    weights = H.make_weights(RM.leaf_shapes(model), 1, "cpu", RM.fan_in)
    x = torch.rand(2, 224, 224, 3)
    f = torch.randn(2, 47)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        RM.forward(model, weights, x, f, train=False)
    assert counter.get_total_flops() == 2 * counts.forward_flops(model, 224)


def test_published_sizes():
    q = H.load_json(H.HERE / "configs" / "quadtree-fusion.json")["model"]
    r = H.load_json(H.HERE / "configs" / "comparative-resnet50.json")["model"]
    # ResNet-18 1.82 and ResNet-50 4.1 GMAC at 224 px (torchvision)
    assert abs(counts.trunk_flops("resnet18", 224)["total"] / 2 - 1.814e9) \
        < 0.01e9
    assert abs(counts.trunk_flops("resnet50", 224)["total"] / 2 - 4.09e9) \
        < 0.02e9
    assert counts.head_in(q, 224) == 5376 and counts.head_in(r, 224) == 2304
    # forward + backward without the inputs' gradients: about 3 forwards
    assert 2.9 < counts.train_flops(q, 224) / counts.forward_flops(q, 224) \
        < 3.0
    params = sum(torch.Size(s).numel()
                 for n, s in RM.leaf_shapes(r).items()
                 if not RM.is_buffer(n) and n.startswith("trunk"))
    assert abs(params - 23.5e6) < 0.1e6    # resnet50 without its fc


def test_kernel_counts_from_shapes():
    q = H.load_json(H.HERE / "configs" / "quadtree-fusion.json")["model"]
    flops, nbytes = counts.quadrant_count(q, 224, 64, False, "bfloat16")
    assert flops == 64 * 4 * 2 * 256 * 128 * 9 * 7 * 7
    assert nbytes == (64 * 14 * 14 * 256 * 2 + 9 * 256 * 128 * 2 + 128 * 2
                      + 64 * 4608 * 2)
    _, train_bytes = counts.quadrant_count(q, 224, 64, True, "bfloat16")
    assert train_bytes - nbytes == 64 * 14 * 14 * 128 * 2     # act
    flops, nbytes = counts.fusion_head_count(q, 224, 256, True, "float32")
    assert flops == 2 * 256 * (5376 * 2688 + 2688 * 8)
    assert nbytes == (256 * 5376 * 2 + (2688 * 5376 + 2688 + 8 * 2688 + 8)
                      * 4 + 256 * 8 * 4 + 256 * 2688 * 2)
    # the head at batch 64 is bound by its bytes, the quadrant by FLOPs
    f, b = counts.fusion_head_count(q, 224, 64, False, "bfloat16")
    assert b / counts.PEAK_HBM_BYTES > f / counts.PEAK_BF16_FLOPS
    f, b = counts.quadrant_count(q, 224, 64, False, "bfloat16")
    assert f / counts.PEAK_BF16_FLOPS > b / counts.PEAK_HBM_BYTES
