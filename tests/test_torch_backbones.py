"""The port's backbones (``surya_tpu_torch/models/backbones``) against the
JAX ones at f32 on the CPU: same weights through ``from_jax_variables``
with ``strict=True``, same numpy input (32 px, B = 2, the architectures'
own depths).

- VGG16, MobileNetV2, DenseNet121 and the pooled ResNet-50: eval features
  to 1e-4, and the BN running statistics a train-mode forward leaves, to
  1e-5 (ResNet-50: 1e-4, see ``TRAIN_CASES``);
- the ResNet's ``start=`` entry, the space-to-depth stem and folded BN:
  each equal to the standard trunk, and JAX's s2d and folded trees loaded
  through the bridge give JAX's maps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from surya_tpu.models.backbones import feature_extractor as jax_features
from surya_tpu.models.backbones.resnet import (
    fold_resnet_params as jax_fold,
    make_resnet as jax_resnet,
    stem_kernel_to_s2d as jax_stem_to_s2d,
)
from surya_tpu_torch.models.backbones import feature_extractor
from surya_tpu_torch.models.backbones.resnet import (
    STAGES,
    fold_resnet_params,
    make_resnet,
    stem_is_s2d,
    stem_kernel_to_s2d,
)
from surya_tpu_torch.models.from_jax import from_jax_variables
from test_torch_resnet import numpy_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401

ARCHS = ("vgg16", "mobilenet_v2", "densenet121", "resnet50")


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(5).normal(
        size=(2, 32, 32, 3)).astype(np.float32)


def _pair(arch, images, seed=0):
    jm = jax_features(arch, dtype=jnp.float32)
    variables = numpy_variables(jm, jnp.asarray(images), seed=seed)
    tm = feature_extractor(arch, torch.float32, image_size=images.shape[1])
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, variables, tm


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_features_match_jax(arch, images):
    jm, variables, tm = _pair(arch, images)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(images)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(images))
    assert got.shape == want.shape == (2, tm.out_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# (arch, image size, tolerance of the running statistics) for a train-mode
# forward at B = 4. Each BN needs enough values per channel in the last
# stages to be well conditioned: at 32 px and B = 2 MobileNetV2's 1×1 maps
# give it 2, and normalising two near-equal values flips their order with
# the last bit of either framework's sums (measured: 7e-3). ResNet-50 is
# held to 1e-4: its layer4 running variances differ from JAX's by up to
# 6e-5 relative to 1 + |value| at 64 and at 128 px, the f32 rounding of the
# two frameworks amplified through 16 train-mode bottleneck blocks (the
# features themselves differ by 2e-3 in train mode and agree to 1e-4 in
# eval mode); swapping flax's one-pass variance into the port moves the
# gap by under 10%, so it is not the variance formula.
TRAIN_CASES = [("mobilenet_v2", 128, 1e-5), ("densenet121", 64, 1e-5),
               ("resnet50", 64, 1e-4)]


@pytest.mark.parametrize("arch,size,tol", TRAIN_CASES)
def test_train_forward_moves_bn_stats_as_jax(arch, size, tol):
    images = np.random.default_rng(6).normal(
        size=(4, size, size, 3)).astype(np.float32)
    jm, variables, tm = _pair(arch, images, seed=1)
    _, mut = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(images))
    with torch.no_grad():
        tm.train()(torch.from_numpy(images))
    moved = from_jax_variables(
        {"batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])})
    state = tm.state_dict()
    assert moved and all("running_" in k for k in moved)
    assert set(moved) == {k for k in state if "running_" in k}
    for name, w in moved.items():
        np.testing.assert_allclose(state[name].numpy(), w.numpy(),
                                   rtol=tol, atol=tol, err_msg=name)


def test_densenet_keeps_channels_last():
    """A dense layer's concatenation of channels_last maps is channels_last
    (the NHWC view the next conv reads without a re-layout)."""
    tm = feature_extractor("densenet121", torch.float32).eval()
    x = torch.randn(2, 8, 8, 64).permute(0, 3, 1, 2)   # channels_last view
    with torch.no_grad():
        y = tm.block0_layer1(tm.block0_layer0(x))
    assert y.shape == (2, 128, 8, 8)
    assert y.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("start", STAGES[1:])
def test_start_equals_the_full_forward(start, images):
    tm = make_resnet("resnet18", dtype=torch.float32).eval()
    tm.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(images)
    before = STAGES[STAGES.index(start) - 1]
    with torch.no_grad():
        full = tm(x, upto="layer4", capture=(before,))
        tail = tm(full[before], start=start)
    np.testing.assert_allclose(tail["out"].numpy(), full["out"].numpy(),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="start"):
        tm(x, start="stem")


def test_s2d_stem_matches_standard_stem(images):
    """The port's counterpart of ``tests/test_models.py::
    test_s2d_stem_matches_standard_stem``; and the s2d weight equals JAX's
    conversion."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 64, 64, 3)).astype(np.float32))
    std = make_resnet("resnet18", dtype=torch.float32).eval()
    std.reset_parameters(torch.Generator().manual_seed(0))
    sd = std.state_dict()
    sd["conv1.weight"] = stem_kernel_to_s2d(sd["conv1.weight"])
    s2d = make_resnet("resnet18", dtype=torch.float32, stem_s2d=True).eval()
    s2d.load_state_dict(sd, strict=True)
    with torch.no_grad():
        want, got = std(x)["out"], s2d(x)["out"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert stem_is_s2d(sd) and not stem_is_s2d(std.state_dict())
    k7 = std.conv1.weight.detach().numpy().transpose(2, 3, 1, 0)   # HWIO
    want_w = jax_stem_to_s2d(k7).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(sd["conv1.weight"].numpy(), want_w)


def test_s2d_trunk_matches_jax(images):
    jm = jax_resnet("resnet18", dtype=jnp.float32, stem_s2d=True)
    variables = numpy_variables(jm, jnp.asarray(images), seed=3)
    want = jm.apply(variables, jnp.asarray(images), train=False)["out"]
    tm = make_resnet("resnet18", dtype=torch.float32, stem_s2d=True).eval()
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(images))["out"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_folded_trunk_equals_unfolded_and_jax_fold(arch, images):
    jm = jax_resnet(arch, dtype=jnp.float32)
    variables = numpy_variables(jm, jnp.asarray(images), seed=4)
    tm = make_resnet(arch, dtype=torch.float32).eval()
    sd = from_jax_variables(variables)
    tm.load_state_dict(sd, strict=True)

    folded = fold_resnet_params(sd)
    fm = make_resnet(arch, dtype=torch.float32, fold_bn=True).eval()
    fm.load_state_dict(folded, strict=True)
    assert all(k.endswith((".weight", ".bias")) for k in folded)
    x = torch.from_numpy(images)
    with torch.no_grad():
        want, got = tm(x)["out"], fm(x)["out"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)

    # JAX's folded tree through the bridge is the port's fold
    jfold = jax.tree.map(np.asarray, jax_fold(variables["params"],
                                              variables["batch_stats"]))
    bridged = from_jax_variables({"params": jfold})
    assert set(bridged) == set(folded)
    for name, w in bridged.items():
        np.testing.assert_allclose(folded[name].numpy(), w.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    jwant = jax_resnet(arch, dtype=jnp.float32, fold_bn=True).apply(
        {"params": jfold}, jnp.asarray(images), train=False)["out"]
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-4,
                               atol=1e-4)

    with pytest.raises(ValueError, match="inference-only"):
        fm.train()(x)
