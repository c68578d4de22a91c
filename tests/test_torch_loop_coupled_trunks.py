"""Arm (a) of ``tests/test_torch_loop_coupled.py`` for the three replay rows
whose trunks train: ``comparative-mobilenet-v2`` (MobileNetV2's depthwise
convolutions, ReLU6 and 52 train-mode BNs, the numerical MLP and the fused
head, augmentation on; the port fed JAX's augmentation parameters, the
numerical MLP's mask and the head's mask), ``comparative-vgg16`` (the same
draws; VGG16's 13 convs and ReLUs, five max pools and its wide training
head) and ``resnet3d-video-trainable`` (``resnet3d-video`` with
``model.freeze_backbone=false``: the whole r3d_18 trunk on train-mode BN
under AdamW with weight decay 5e-4 and clip 1.0 over the sequence pack;
the head's mask, its only draw). Both loops start from JAX's initial
weights on the small packs; per-epoch train and validation losses must
agree to 4e-3 relative over 3 epochs, as there.

JAX's augmentation runs eagerly for the spatial rows (``eager_jax_augment``,
each batch's output computed once for both): jitted on the CPU it gets
some pixels' hue wrong, and a trainable trunk turns them into a
train-loss gap past the bound by the third epoch.
"""

import pytest

from test_torch_loop_coupled import (  # noqa: F401
    check_shared_draws,
    eager_jax_augment,
    packs,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401

# row → (preset, overrides, numerical-MLP masks a step)
ROWS = {
    "comparative-mobilenet-v2": ("comparative-mobilenet-v2", {}, 1),
    "comparative-vgg16": ("comparative-vgg16", {}, 1),
    "resnet3d-video-trainable": ("resnet3d-video",
                                 {"model.freeze_backbone": "false"}, 0),
}


# JAX's eager augmentation outputs, shared by the spatial cases
AUGMENTED = {}


@pytest.mark.parametrize("row", list(ROWS))
def test_trainable_trunk_fed_jax_draws_tracks_jax_loop(row, packs,  # noqa: F811
                                                       mesh1, monkeypatch):
    preset, extra, mlp_masks = ROWS[row]
    if mlp_masks:
        eager_jax_augment(monkeypatch, AUGMENTED)
    check_shared_draws(preset, packs, mesh1, monkeypatch, mlp_masks,
                       **extra)
