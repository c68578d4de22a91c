"""The fused head of the PyTorch port against the JAX package on the same
numpy inputs: the plain version against the Pallas kernel (interpret mode,
rate 0) and against the lax reference at the flagship shape, to 2e-4.
The port keeps weights in nn.Linear layout, so w1/w2 go in transposed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from surya_tpu.ops.pallas.fusion_head import _fusion_head_impl, _lax_reference
from surya_tpu_torch.ops.cuda import fusion_head as thead


def _params(b, d, h, c, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(b, d)) * 0.1).astype(np.float32),
            (rng.normal(size=(d, h)) * 0.02).astype(np.float32),
            rng.normal(size=(h,)).astype(np.float32),
            (rng.normal(size=(h, c)) * 0.02).astype(np.float32),
            rng.normal(size=(c,)).astype(np.float32))


def _port(x, w1, b1, w2, b2, dtype=torch.float32):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return thead.fusion_head(t(x).to(dtype), t(w1.T), t(b1), t(w2.T), t(b2))


def test_plain_matches_pallas_kernel():
    x, w1, b1, w2, b2 = _params(5, 256, 128, 3)
    with pltpu.force_tpu_interpret_mode():
        want, _ = _fusion_head_impl(*map(jnp.asarray, (x, w1, b1, w2, b2)),
                                    jnp.zeros((1, 1), jnp.int32), block_b=8,
                                    with_act=False)
    got = _port(x, w1, b1, w2, b2)
    assert got.dtype == torch.float32 and got.shape == (5, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_plain_matches_lax_reference_at_flagship_width():
    x, w1, b1, w2, b2 = _params(16, 5376, 2688, 8)
    want = _lax_reference(*map(jnp.asarray, (x, w1, b1, w2, b2)))
    np.testing.assert_allclose(_port(x, w1, b1, w2, b2).numpy(),
                               np.asarray(want), rtol=2e-4, atol=2e-4)


def test_bf16_follows_pallas_rounding():
    """bf16: f32 accumulation, b1 in f32, h rounded to bf16 before the
    second product — the Pallas kernel's rounding points."""
    x, w1, b1, w2, b2 = _params(5, 256, 128, 3, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want, _ = _fusion_head_impl(
            jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, (w1, b1, w2, b2)),
            jnp.zeros((1, 1), jnp.int32), block_b=8, with_act=False)
    got = _port(x, w1, b1, w2, b2, dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-2, atol=1e-2)


def test_dropout_raises_on_cuda_path(monkeypatch):
    """Serving never passes rate > 0; the kernel path refuses it until
    the training slice adds in-kernel dropout."""
    monkeypatch.setattr(thead, "on_cuda", lambda t: True)
    monkeypatch.setattr(thead._build, "load", pytest.fail)
    x, w1, b1, w2, b2 = _params(2, 16, 8, 2)
    with pytest.raises(NotImplementedError, match="dropout"):
        thead.fusion_head(*map(torch.from_numpy,
                               (x, w1.T.copy(), b1, w2.T.copy(), b2)),
                          rate=0.5)


@pytest.mark.parametrize("shapes", [
    [(2, 16), (8, 15), (8,), (2, 8), (2,)],   # D mismatch
    [(2, 16), (8, 16), (7,), (2, 8), (2,)],   # b1 mismatch
    [(2, 16), (8, 16), (8,), (2, 9), (2,)],   # w2 mismatch
    [(16,), (8, 16), (8,), (2, 8), (2,)],     # x not 2-D
])
def test_wrapper_rejects_bad_shapes(shapes):
    with pytest.raises(ValueError):
        thead.fusion_head(*[torch.zeros(s) for s in shapes])


def test_wrapper_rejects_other_dtypes():
    with pytest.raises(TypeError):
        thead.fusion_head(torch.zeros(2, 16, dtype=torch.float16),
                          torch.zeros(8, 16), torch.zeros(8),
                          torch.zeros(2, 8), torch.zeros(2))
