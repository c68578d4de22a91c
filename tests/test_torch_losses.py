"""The port's losses against ``surya_tpu/models/losses.py`` on the same
numpy logits and labels (f32, 1e-6)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surya_tpu.models import losses as jl
from surya_tpu_torch.models import losses as tl


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return ((rng.normal(size=(16, 8)) * 3).astype(np.float32),
            rng.integers(0, 8, 16))


def _t(logits, labels):
    return torch.from_numpy(logits), torch.from_numpy(labels)


@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.5])
def test_cross_entropy_matches_jax(batch, smoothing):
    logits, labels = batch
    want = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            smoothing)
    want_per = jl.cross_entropy_per_sample(jnp.asarray(logits),
                                           jnp.asarray(labels), smoothing)
    got = tl.cross_entropy(*_t(logits, labels), smoothing)
    got_per = tl.cross_entropy_per_sample(*_t(logits, labels), smoothing)
    assert got.shape == () and got_per.shape == (16,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_per.numpy(), np.asarray(want_per),
                               rtol=1e-6, atol=1e-6)


def test_cross_entropy_equals_torch_without_smoothing(batch):
    logits, labels = _t(*batch)
    want = torch.nn.functional.cross_entropy(logits, labels)
    np.testing.assert_allclose(tl.cross_entropy(logits, labels).numpy(),
                               want.numpy(), rtol=1e-6)


@pytest.mark.parametrize("alpha", [None, 0.25,
                                   [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8]])
@pytest.mark.parametrize("gamma", [2.0, 0.5])
def test_focal_loss_matches_jax(batch, alpha, gamma):
    logits, labels = batch
    want = jl.focal_loss(jnp.asarray(logits), jnp.asarray(labels), gamma,
                         alpha)
    got = tl.focal_loss(*_t(logits, labels), gamma, alpha)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_cross_entropy_gradient_matches_jax(batch):
    import jax

    logits, labels = batch
    want = jax.grad(lambda z: jl.cross_entropy(z, jnp.asarray(labels), 0.1))(
        jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    tl.cross_entropy(z, torch.from_numpy(labels), 0.1).backward()
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
