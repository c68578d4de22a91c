"""Quadrant ops of the PyTorch port against the JAX package on the same
numpy inputs: split/merge/flatten exactly, and the fused quadrant block's
plain version against the Pallas kernel (interpret mode) to 1e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from surya_tpu.ops import quadtree as jq
from surya_tpu.ops.pallas.quadrant import _quadrant_process_impl
from surya_tpu_torch.ops import quadtree as tq
from surya_tpu_torch.ops.cuda import quadrant as tquad


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 14, 6, 4)])
def test_split_merge_flatten_match_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    b = shape[0]
    split_j = np.asarray(jq.quadrant_split(jnp.asarray(x)))
    split_t = tq.quadrant_split(torch.from_numpy(x))
    np.testing.assert_array_equal(split_t.numpy(), split_j)
    np.testing.assert_array_equal(tq.quadrant_merge(split_t, b).numpy(), x)
    np.testing.assert_array_equal(
        tq.quadrant_flatten(split_t, b).numpy(),
        np.asarray(jq.quadrant_flatten(jnp.asarray(split_j), b)))
    with pytest.raises(ValueError):
        tq.quadrant_merge(split_t, b + 1)


def test_split_rejects_odd_sizes():
    with pytest.raises(ValueError, match="even"):
        tq.quadrant_split(torch.zeros(1, 7, 8, 2))


def _inputs(b, h, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, h, cin)).astype(np.float32),
            (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32),
            rng.normal(size=(cout,)).astype(np.float32))


@pytest.mark.parametrize("b,h,cin,cout", [(4, 14, 256, 128),
                                          (3, 28, 32, 16),
                                          (8, 8, 16, 8)])
def test_plain_matches_pallas_kernel(b, h, cin, cout):
    fmap, kernel, bias = _inputs(b, h, cin, cout)
    with pltpu.force_tpu_interpret_mode():
        want = _quadrant_process_impl(jnp.asarray(fmap), jnp.asarray(kernel),
                                      jnp.asarray(bias))
    got = tquad.quadrant_process(*map(torch.from_numpy,
                                      (fmap, kernel, bias)))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_zero_padding_at_quadrant_borders():
    """Each quadrant is zero-padded on its own: on an all-ones map a
    leak across the quadrant boundary would change the border sums."""
    fmap = np.ones((1, 8, 8, 4), np.float32)
    kernel = np.ones((3, 3, 4, 4), np.float32)
    bias = np.zeros((4,), np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = _quadrant_process_impl(jnp.asarray(fmap), jnp.asarray(kernel),
                                      jnp.asarray(bias))
    got = tquad.quadrant_process(*map(torch.from_numpy,
                                      (fmap, kernel, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_bf16_keeps_input_dtype_and_pallas_rounding():
    """bf16 in → bf16 out; f32 accumulation of the bf16-rounded inputs."""
    fmap, kernel, bias = _inputs(2, 8, 16, 8, seed=1)
    f16 = torch.from_numpy(fmap).bfloat16()
    got = tquad.quadrant_process(f16, torch.from_numpy(kernel),
                                 torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    want = tquad.quadrant_process(
        f16.float(), torch.from_numpy(kernel).bfloat16().float(),
        torch.from_numpy(bias))
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.bfloat16().float().numpy())


@pytest.mark.parametrize("fmap,kernel,bias,err", [
    ((1, 8, 6, 4), (3, 3, 4, 2), (2,), ValueError),    # not square
    ((1, 2, 2, 4), (3, 3, 4, 2), (2,), ValueError),    # H < 4
    ((1, 8, 8, 4), (3, 3, 5, 2), (2,), ValueError),    # Cin mismatch
    ((1, 8, 8, 4), (3, 3, 4, 2), (3,), ValueError),    # bias mismatch
])
def test_wrapper_rejects_bad_shapes(fmap, kernel, bias, err):
    with pytest.raises(err):
        tquad.quadrant_process(*[torch.zeros(s) for s in (fmap, kernel, bias)])


def test_odd_quadrant_side_drops_last_row():
    """H=6: 3x3 quadrants pool VALID to 1x1, as H=14 pools 7 → 3."""
    fmap, kernel, bias = _inputs(2, 6, 4, 2, seed=2)
    with pltpu.force_tpu_interpret_mode():
        want = _quadrant_process_impl(jnp.asarray(fmap), jnp.asarray(kernel),
                                      jnp.asarray(bias))
    got = tquad.quadrant_process(*map(torch.from_numpy,
                                      (fmap, kernel, bias)))
    assert got.shape == (2, 4 * 1 * 1 * 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_wrapper_rejects_other_dtypes():
    with pytest.raises(TypeError):
        tquad.quadrant_process(torch.zeros(1, 8, 8, 4, dtype=torch.float64),
                               torch.zeros(3, 3, 4, 2), torch.zeros(2))
