"""The ResNet trunk of the PyTorch port against the JAX trunk in eval mode
at f32: same weights (through ``from_jax_variables``), same numpy input,
layer3 and layer4 maps to 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from surya_tpu.models.backbones.resnet import make_resnet as jax_resnet
from surya_tpu_torch.models.backbones.resnet import make_resnet
from surya_tpu_torch.models.from_jax import from_jax_variables


def numpy_variables(module, *args, seed=0, **kwargs):
    """A flax module's variable tree with random numpy values (shapes from
    ``jax.eval_shape``, no JAX init): lecun-scaled kernels, small biases,
    non-trivial BN scales and running statistics."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.key(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel" or name.endswith("_kernel"):
            fan_in = int(np.prod(shape[:-1]))
            a = rng.normal(size=shape) / np.sqrt(fan_in)
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:  # bias, BN bias, mean
            a = rng.normal(size=shape) * 0.1
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_trunk_matches_jax(arch):
    x = np.random.default_rng(1).random((2, 64, 64, 3)).astype(np.float32)
    jm = jax_resnet(arch, dtype=jnp.float32)
    variables = numpy_variables(jm, jnp.asarray(x), upto="layer4")
    want = jm.apply(variables, jnp.asarray(x), upto="layer4",
                    capture=("layer3",))

    tm = make_resnet(arch, dtype=torch.float32).eval()
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), upto="layer4", capture=("layer3",))
    for key in ("layer3", "out"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4)
    # the NHWC view of a channels_last map is the quadrant kernel's input
    assert got["layer3"].is_contiguous()


def test_upto_stops_early_and_rejects_unknown_stage():
    tm = make_resnet("resnet18", dtype=torch.float32).eval()
    with torch.no_grad():
        outs = tm(torch.zeros(1, 64, 64, 3), upto="layer2",
                  capture=("stem",))
    assert outs["stem"].shape == (1, 16, 16, 64)
    assert outs["out"].shape == (1, 8, 8, 128)
    with pytest.raises(ValueError, match="upto"):
        tm(torch.zeros(1, 64, 64, 3), upto="layer9")


def test_train_mode_bn_is_refused():
    """Train mode runs since the training slice (tests/test_torch_bn_train.py
    holds it against flax); what BatchNorm still refuses is a batch with one
    value per channel, which has no variance to normalise with."""
    tm = make_resnet("resnet18", dtype=torch.float32).train()
    before = tm.bn1.running_mean.clone()
    with torch.no_grad():
        tm(torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0)),
           upto="layer3")
    assert not torch.equal(tm.bn1.running_mean, before)
    with pytest.raises(ValueError, match="more than one value"):
        tm(torch.zeros(1, 32, 32, 3))       # layer4's map is 1x1 at batch 1


def test_init_matches_jax_distribution():
    """lecun_normal kernels (std sqrt(1/fan_in)), BN scale 1 / bias 0."""
    tm = make_resnet("resnet18", dtype=torch.float32)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    w = tm.layer3_block0.conv2.weight
    assert abs(w.std().item() - (1 / (9 * 256)) ** 0.5) < 2e-3
    assert w.abs().max().item() <= 2 * (1 / (9 * 256)) ** 0.5 / 0.8796 + 1e-6
    assert torch.all(tm.bn1.weight == 1) and torch.all(tm.bn1.bias == 0)
