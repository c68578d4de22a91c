"""The port's stem-BN passes (``ops/cuda/stem_bn.py``; their plain
versions run on the CPU) against the JAX package on the same numpy inputs:
against ``reference_bn_relu_train``, against the Pallas kernels in
interpret mode, and against flax ``nn.BatchNorm`` in train mode, with the
tolerances of ``tests/test_pallas_stem_bn.py`` (1e-5 at f32, 2e-2 at
bf16)."""

import flax.linen as nn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from surya_tpu.ops.pallas import stem_bn as jbn
from surya_tpu_torch.ops.cuda import stem_bn as tbn


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return ((rng.normal(size=shape) * 3 + 0.5).astype(np.float32),
            rng.uniform(0.5, 2.0, c).astype(np.float32),
            rng.normal(size=c).astype(np.float32))


def _to_torch(x, dtype):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


CASES = [((4, 16, 16, 64), "float32"), ((2, 14, 14, 64), "bfloat16"),
         ((3, 7, 5, 24), "float32"), ((3, 7, 5, 5), "bfloat16")]


@pytest.mark.parametrize("shape,dname", CASES)
def test_fused_matches_jax_reference(shape, dname):
    """Any channel count and any (also odd) number of rows."""
    x, scale, bias = _inputs(shape)
    xj = jnp.asarray(x, getattr(jnp, dname))
    yr, mr, vr = jbn.reference_bn_relu_train(xj, jnp.asarray(scale),
                                             jnp.asarray(bias))
    xt = _to_torch(xj, getattr(torch, dname))
    tol = 1e-5 if dname == "float32" else 2e-2
    for fn in (tbn.fused_bn_relu_train, tbn.reference_bn_relu_train):
        y, mean, var = fn(xt, torch.from_numpy(scale), torch.from_numpy(bias))
        assert y.dtype == xt.dtype and y.shape == xt.shape
        assert mean.dtype == var.dtype == torch.float32
        np.testing.assert_allclose(mean.numpy(), np.asarray(mr), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(var.numpy(), np.asarray(vr), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(yr, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("shape,dname", CASES[:2])
def test_passes_match_pallas_kernels(shape, dname):
    x, scale, bias = _inputs(shape, seed=1)
    xj = jnp.asarray(x, getattr(jnp, dname))
    xt = _to_torch(xj, getattr(torch, dname))
    a, b = scale, bias
    with pltpu.force_tpu_interpret_mode():
        sums, sumsq = jbn.channel_stats(xj)
        want = jbn.affine_relu(xj, jnp.asarray(a), jnp.asarray(b))
        yj, mj, vj = jbn.fused_bn_relu_train(xj, jnp.asarray(scale),
                                             jnp.asarray(bias))
    got_s, got_ss = tbn.channel_stats(xt)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(sums), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(got_ss.numpy(), np.asarray(sumsq), rtol=1e-5,
                               atol=1e-3)
    tol = 1e-5 if dname == "float32" else 2e-2
    got = tbn.affine_relu(xt, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    y, mean, var = tbn.fused_bn_relu_train(xt, torch.from_numpy(scale),
                                           torch.from_numpy(bias))
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yj, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mj), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(var.numpy(), np.asarray(vj), rtol=tol,
                               atol=tol)


def test_matches_flax_batchnorm_train():
    """The same normalisation as flax nn.BatchNorm(train) + relu, and the
    returned (mean, var) are what the momentum update needs."""
    x, scale, bias = _inputs((4, 8, 8, 64), seed=2)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=jnp.float32)
    v = bn.init(jax.random.key(0), jnp.asarray(x))
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": v["batch_stats"]}
    want, mut = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    want = jnp.maximum(want, 0.0)
    got, mean, var = tbn.fused_bn_relu_train(
        *map(torch.from_numpy, (x, scale, bias)), eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(mut["batch_stats"]["mean"]),
                               0.1 * mean.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(mut["batch_stats"]["var"]),
                               0.9 + 0.1 * var.numpy(), rtol=1e-5, atol=1e-5)


def test_variance_is_clamped_at_zero():
    x = torch.full((2, 3, 3, 4), 1000.0)
    y, mean, var = tbn.fused_bn_relu_train(x, torch.ones(4), torch.zeros(4))
    assert torch.all(var >= 0) and torch.isfinite(y).all()


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        tbn.channel_stats(torch.zeros(2, 4, 4, 8, dtype=torch.float16))
    with pytest.raises(ValueError):
        tbn.channel_stats(torch.zeros(0, 4))
    with pytest.raises(ValueError, match="C=8"):
        tbn.affine_relu(torch.zeros(2, 4, 4, 8), torch.zeros(4),
                        torch.zeros(8))


def test_cuda_path_needs_a_contiguous_map(monkeypatch):
    monkeypatch.setattr(tbn, "on_cuda", lambda t: True)
    monkeypatch.setattr(tbn._build, "load", pytest.fail)
    x = torch.zeros(2, 8, 4, 4).permute(0, 2, 3, 1)   # NHWC view of NCHW
    with pytest.raises(ValueError, match="contiguous"):
        tbn.channel_stats(x)
