"""Train-mode BatchNorm of the PyTorch port against flax
``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` on the same numpy inputs: the
normalised output and the running mean and variance after one and after
two train forwards (flax stores the *biased* batch variance, torch's own
BatchNorm2d the unbiased one: 6.7% apart at n = 16), and the whole ResNet
trunk's running statistics after one train forward. f32, 1e-5."""

import flax.linen as nn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from surya_tpu.models.backbones.resnet import make_resnet as jax_resnet
from surya_tpu_torch.models.backbones.resnet import BatchNorm, make_resnet
from surya_tpu_torch.models.from_jax import from_jax_variables
from test_torch_resnet import numpy_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401


def _flax_bn(x, scale, bias, mean, var, steps, dtype=jnp.float32):
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=dtype, param_dtype=jnp.float32)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    outs = []
    for i in range(steps):
        y, mut = bn.apply(v, jnp.asarray(x[i], dtype), mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        outs.append(np.asarray(y, np.float32))
    return outs, v["batch_stats"]


def _port_bn(x, scale, bias, mean, var, steps, dtype=torch.float32):
    bn = BatchNorm(len(scale)).train()
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean.copy()),
                        "running_var": torch.from_numpy(var.copy())})
    outs = []
    for i in range(steps):   # the port's BN takes NCHW views of NHWC data
        y = bn(torch.from_numpy(x[i]).to(dtype).permute(0, 3, 1, 2))
        outs.append(y.permute(0, 2, 3, 1).float().detach().numpy())
    return outs, bn


@pytest.mark.parametrize("shape", [(4, 2, 2, 8),     # n = 16
                                   (3, 5, 7, 6), (2, 1, 1, 4)])
@pytest.mark.parametrize("steps", [1, 2])
def test_output_and_running_stats_match_flax(shape, steps):
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = (rng.normal(size=(steps,) + shape) * 2 + 0.7).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    mean = rng.normal(size=c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    want, stats = _flax_bn(x, scale, bias, mean, var, steps)
    got, bn = _port_bn(x, scale, bias, mean, var, steps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5, atol=1e-6)


def test_running_variance_is_the_biased_one():
    """n = 16: the unbiased variance torch's BatchNorm2d stores would be
    16/15 of this."""
    x = np.random.default_rng(1).normal(size=(1, 4, 2, 2, 3)).astype(
        np.float32)
    _, bn = _port_bn(x, np.ones(3, np.float32), np.zeros(3, np.float32),
                     np.zeros(3, np.float32), np.zeros(3, np.float32), 1)
    biased = x[0].reshape(-1, 3).var(axis=0)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.1 * biased,
                               rtol=1e-5)
    assert not np.allclose(bn.running_var.numpy(), 0.1 * biased * 16 / 15,
                           rtol=1e-2)


def test_bf16_input_f32_statistics():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 4, 6, 6, 8)).astype(np.float32)
    scale, bias = np.ones(8, np.float32), np.zeros(8, np.float32)
    zeros, ones = np.zeros(8, np.float32), np.ones(8, np.float32)
    want, stats = _flax_bn(x, scale, bias, zeros, ones, 1, jnp.bfloat16)
    bn = BatchNorm(8).train()
    y = bn(torch.from_numpy(x[0]).bfloat16().permute(0, 3, 1, 2))
    assert y.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).float().numpy(),
                               want[0], rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-4)


def test_eval_mode_reads_the_moved_statistics_and_moves_nothing():
    x = np.random.default_rng(3).normal(size=(1, 4, 3, 3, 5)).astype(
        np.float32)
    _, bn = _port_bn(x, np.ones(5, np.float32), np.zeros(5, np.float32),
                     np.zeros(5, np.float32), np.ones(5, np.float32), 1)
    mean, var = bn.running_mean.clone(), bn.running_var.clone()
    bn.eval()
    xt = torch.from_numpy(x[0]).permute(0, 3, 1, 2)
    y = bn(xt)
    want = (xt - mean[None, :, None, None]) / torch.sqrt(
        var[None, :, None, None] + 1e-5)
    np.testing.assert_allclose(y.detach().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(bn.running_mean, mean)
    assert torch.equal(bn.running_var, var)


def test_one_value_per_channel_is_refused():
    with pytest.raises(ValueError, match="more than one value"):
        BatchNorm(3).train()(torch.zeros(1, 3, 1, 1))


def test_trunk_running_stats_match_jax_after_a_train_forward():
    """64 px, B = 4: layer4's maps are 2x2, so its BN sees n = 16."""
    x = np.random.default_rng(4).random((4, 64, 64, 3)).astype(np.float32)
    jm = jax_resnet("resnet18", dtype=jnp.float32)
    variables = numpy_variables(jm, jnp.asarray(x), upto="layer4")
    want, mut = jm.apply(variables, jnp.asarray(x), train=True,
                         upto="layer4", capture=("layer3",),
                         mutable=["batch_stats"])
    tm = make_resnet("resnet18", dtype=torch.float32).train()
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), upto="layer4", capture=("layer3",))
    for key in ("layer3", "out"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-3, atol=1e-3)
    moved = from_jax_variables({"batch_stats": jax.tree.map(
        np.asarray, mut["batch_stats"])})
    state = tm.state_dict()
    assert len(moved) == 40   # 20 BN layers, mean and var each
    for name, w in moved.items():
        np.testing.assert_allclose(state[name].numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
