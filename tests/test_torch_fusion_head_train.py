"""Training form of the port's fused head against the JAX package on the
same numpy inputs, on the CPU: gradients at rate 0 against JAX's custom
VJP, dropout at rate 0.5 with an explicit mask against the masked formula
of ``scripts/tpu_kernel_checks.py``, the keep rule against
``_dropout_threshold``, and the Philox stream against its published test
vectors. The port keeps weights in nn.Linear layout, so w1/w2 go in
transposed and their gradients come back transposed.

Tolerance: 1e-5 relative L2 at f32 (the same products in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from surya_tpu.ops.pallas import fusion_head as jhead
from surya_tpu_torch.ops.cuda import fusion_head as thead


def _params(b, d, h, c, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(b, d)) * 0.1).astype(np.float32),
            (rng.normal(size=(d, h)) * 0.1).astype(np.float32),
            rng.normal(size=(h,)).astype(np.float32),
            (rng.normal(size=(h, c)) * 0.1).astype(np.float32),
            rng.normal(size=(c,)).astype(np.float32))


def _leaves(x, w1, b1, w2, b2, dtype=torch.float32):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    leaves = [t(x).to(dtype), t(w1.T), t(b1), t(w2.T), t(b2)]
    return [a.requires_grad_(True) for a in leaves]


def _port_grads(params, dtype=torch.float32, **kw):
    leaves = _leaves(*params, dtype=dtype)
    out = thead.fusion_head(*leaves, **kw)
    (out ** 2).sum().backward()
    x, w1, b1, w2, b2 = (a.grad for a in leaves)
    return out, (x, w1.t(), b1, w2.t(), b2)   # back in JAX's layout


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30)


@pytest.mark.parametrize("shape", [(8, 64, 32, 8), (5, 256, 128, 3)])
def test_rate0_gradients_match_jax_custom_vjp(shape):
    params = _params(*shape)
    out, got = _port_grads(params)

    def loss(*a):
        return jnp.sum(jhead.fusion_head(*a) ** 2)

    want = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, params))
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jhead.fusion_head(*map(jnp.asarray, params))),
        rtol=1e-5, atol=1e-5)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel_l2(g.numpy(), w) < 1e-5


@pytest.mark.parametrize("rate", [0.5, 0.25])
def test_dropout_with_the_seeds_mask_matches_masked_formula(rate):
    """The port's mask is a function of the seed: feed it to JAX's masked
    formula and logits, h and all five gradients agree."""
    shape, seed = (8, 64, 32, 8), 7
    params = _params(*shape, seed=3)
    keep = thead.philox_bits(seed, shape[0], shape[2]) \
        >= thead.dropout_threshold(rate)
    mask = jnp.asarray(keep.numpy(), jnp.float32)

    def loss(x, w1, b1, w2, b2):
        hh = jax.nn.relu(x @ w1 + b1) * mask / (1 - rate)
        return jnp.sum((hh @ w2 + b2) ** 2)

    want = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, params))
    out, got = _port_grads(params, rate=rate, seed=seed)
    for g, w in zip(got, want):
        assert _rel_l2(g.numpy(), w) < 1e-5

    x, w1, b1, w2, b2 = params
    relu = np.maximum(x @ w1 + b1, 0)
    logits, h = thead.fusion_head_with_h(
        *[a.detach() for a in _leaves(*params)], rate=rate, seed=seed)
    np.testing.assert_allclose(h.numpy(), relu * keep.numpy() / (1 - rate),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(logits.numpy(), h.numpy() @ w2 + b2,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), logits.numpy())
    # the same mask given to the plain version as ``keep``
    plain = thead.fusion_head_plain(*[a.detach() for a in _leaves(*params)],
                                    rate, keep)
    np.testing.assert_array_equal(plain.numpy(), logits.numpy())


@pytest.mark.parametrize("rate", [0.0, 1e-9, 0.1, 0.25, 0.5, 0.9,
                                  1 - 2.0 ** -33])
def test_threshold_equals_jax(rate):
    assert thead.dropout_threshold(rate) == jhead._dropout_threshold(rate)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Philox4x32-10 test vectors of the Random123 library."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    got = thead._philox4x32(tuple(map(t, counter)), tuple(map(t, key)))
    assert tuple(int(w) for w in got) == want


def test_mask_is_a_function_of_seed_row_and_unit_alone():
    small = thead.philox_bits(1234, 8, 16)
    big = thead.philox_bits(1234, 16, 40)
    assert torch.equal(small, big[:8, :16])          # no tile in the stream
    assert not torch.equal(small, thead.philox_bits(99, 8, 16))
    assert torch.equal(small, thead.philox_bits(
        torch.tensor([1234], dtype=torch.int64), 8, 16))
    # the counter is (row, unit, 0, 0) and the key the seed's two halves
    seed = (5 << 32) | 9
    t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    want = thead._philox4x32((t(3), t(11), t(0), t(0)), (t(9), t(5)))[0]
    assert thead.philox_bits(seed, 4, 12)[3, 11] == want[0]
    assert small.min() >= 0 and small.max() < 2 ** 32


@pytest.mark.parametrize("rate", [0.5, 0.2])
def test_drop_fraction_and_scale(rate):
    params = _params(64, 64, 512, 8, seed=5)
    leaves = [a.detach() for a in _leaves(*params)]
    _, h0 = thead.fusion_head_with_h(*leaves)
    _, h = thead.fusion_head_with_h(*leaves, rate=rate, seed=1234)
    pos = h0 > 0
    frac = ((h == 0) & pos).sum().item() / pos.sum().item()
    assert abs(frac - rate) < 0.03
    kept = h > 0
    np.testing.assert_allclose(h[kept].numpy(),
                               (h0[kept] / (1 - rate)).numpy(), rtol=1e-6)
    _, again = thead.fusion_head_with_h(*leaves, rate=rate, seed=1234)
    assert torch.equal(h, again)


def test_plain_draws_from_the_generator_and_never_the_global_one():
    params = _params(16, 32, 64, 4, seed=6)
    leaves = [a.detach() for a in _leaves(*params)]
    before = torch.get_rng_state()
    g = torch.Generator().manual_seed(3)
    a = thead.fusion_head_plain(*leaves, 0.5, generator=g)
    b = thead.fusion_head_plain(*leaves, 0.5,
                                generator=torch.Generator().manual_seed(3))
    c = thead.fusion_head_plain(*leaves, 0.5, generator=g)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(before, torch.get_rng_state())
    with pytest.raises(ValueError, match="keep mask or a generator"):
        thead.fusion_head_plain(*leaves, 0.5)


def test_rate_needs_a_seed_and_a_valid_range():
    leaves = [a.detach() for a in _leaves(*_params(2, 16, 8, 2))]
    with pytest.raises(ValueError, match="seed"):
        thead.fusion_head(*leaves, rate=0.5)
    with pytest.raises(ValueError, match="seed"):
        thead.fusion_head_with_h(*leaves, rate=0.5)
    with pytest.raises(ValueError, match="rate"):
        thead.fusion_head(*leaves, rate=1.0, seed=1)


def test_bf16_gradient_dtypes_and_rounding_points():
    """bf16 x: h and g_x in bf16, parameter gradients in f32; against JAX's
    bf16 custom VJP (its lax path) to bf16 accuracy."""
    params = _params(8, 64, 32, 8, seed=8)
    leaves = _leaves(*params, dtype=torch.bfloat16)
    out = thead.fusion_head(*leaves)
    (out ** 2).sum().backward()
    assert out.dtype == torch.float32
    assert leaves[0].grad.dtype == torch.bfloat16
    assert all(a.grad.dtype == torch.float32 for a in leaves[1:])
    _, h = thead.fusion_head_with_h(*[a.detach() for a in leaves])
    assert h.dtype == torch.bfloat16

    x16 = jnp.asarray(params[0], jnp.bfloat16)

    def loss(*a):
        return jnp.sum(jhead.fusion_head(*a) ** 2)

    want = jax.grad(loss, argnums=tuple(range(5)))(
        x16, *map(jnp.asarray, params[1:]))
    got = [leaves[0].grad.float(), leaves[1].grad.t(), leaves[2].grad,
           leaves[3].grad.t(), leaves[4].grad]
    for g, w in zip(got, want):
        assert _rel_l2(g.numpy(), np.asarray(w, np.float32)) < 3e-2


def test_frozen_inputs_get_no_gradient():
    leaves = [a.detach() for a in _leaves(*_params(4, 16, 8, 2))]
    leaves[3].requires_grad_(True)              # only w2 trains
    thead.fusion_head(*leaves).sum().backward()
    assert leaves[3].grad is not None
    assert all(a.grad is None for i, a in enumerate(leaves) if i != 3)
