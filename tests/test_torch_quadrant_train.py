"""Training form of the port's quadrant block against the JAX package on
the same numpy inputs, on the CPU (the port runs its plain forward and the
hand-written backward that the card runs too; JAX runs its custom VJP over
the lax path, and the Pallas kernel in interpret mode for the act output).

Tolerances: f32 forward 1e-5 of the largest value; gradients 1e-5 relative
L2 (the same products summed in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from surya_tpu.ops.pallas import quadrant as jquad
from surya_tpu_torch.ops import quadtree as tq
from surya_tpu_torch.ops.cuda import quadrant as tquad


def _inputs(b, h, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, h, cin)).astype(np.float32),
            (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32),
            rng.normal(size=(cout,)).astype(np.float32))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30)


def _port_grads(fmap, kernel, bias, dtype=torch.float32, cot=None):
    """Gradients of sum(out^2), or of sum(out * cot) for a cotangent that
    is not 0 where the output is."""
    f = torch.from_numpy(fmap).to(dtype).requires_grad_(True)
    k = torch.from_numpy(kernel).requires_grad_(True)
    b = torch.from_numpy(bias).requires_grad_(True)
    out = tquad.quadrant_process(f, k, b)
    loss = out.float() ** 2 if cot is None else out * torch.from_numpy(cot)
    loss.sum().backward()
    return out, (f.grad, k.grad, b.grad)


def _jax_grads(fn, fmap, kernel, bias, cot=None):
    def loss(f, k, b):
        out = fn(f, k, b)
        return jnp.sum(out ** 2 if cot is None else out * jnp.asarray(cot))

    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                  (fmap, kernel, bias)))


SHAPES = [(4, 14, 32, 16), (3, 8, 16, 8), (2, 6, 4, 2)]


@pytest.mark.parametrize("b,h,cin,cout", SHAPES)
def test_out_and_act_match_lax_forward(b, h, cin, cout):
    fmap, kernel, bias = _inputs(b, h, cin, cout)
    want_out, want_act = jquad._lax_forward(*map(jnp.asarray,
                                                 (fmap, kernel, bias)))
    out, act = tquad.quadrant_process_with_act(
        *map(torch.from_numpy, (fmap, kernel, bias)))
    assert act.shape == (b, h, h, cout) and act.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-5)
    # JAX's lax path keeps act split by quadrant; the port keeps the full map
    np.testing.assert_allclose(tq.quadrant_split(act).numpy(),
                               np.asarray(want_act), rtol=1e-5, atol=1e-5)


def test_act_matches_pallas_kernel_full_map_layout():
    fmap, kernel, bias = _inputs(4, 14, 32, 16, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want_out, want_act = jquad._quadrant_process_impl(
            *map(jnp.asarray, (fmap, kernel, bias)), with_act=True)
    out, act = tquad.quadrant_process_plain(
        *map(torch.from_numpy, (fmap, kernel, bias)), with_act=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(act.numpy(), np.asarray(want_act),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,h,cin,cout", SHAPES)
def test_gradients_match_jax_custom_vjp(b, h, cin, cout):
    fmap, kernel, bias = _inputs(b, h, cin, cout, seed=2)
    _, got = _port_grads(fmap, kernel, bias)
    for fn in (jquad.quadrant_process, jquad._lax_reference):
        want = _jax_grads(fn, fmap, kernel, bias)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert _rel_l2(g.numpy(), w) < 1e-5


def test_all_zero_windows_send_no_gradient():
    """After ReLU whole pool windows are 0 and tie; whatever position the
    tie rule picks, the act > 0 mask applied after the pool VJP clears it.
    Half the channels get a bias that keeps them at 0 everywhere."""
    fmap, kernel, bias = _inputs(2, 8, 4, 4, seed=3)
    bias[:2] = -100.0
    cot = np.random.default_rng(8).normal(size=(2, 4 * 2 * 2 * 4)).astype(
        np.float32)           # a cotangent that is not 0 at the 0 outputs
    _, got = _port_grads(fmap, kernel, bias, cot=cot)
    want = _jax_grads(jquad.quadrant_process, fmap, kernel, bias, cot=cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    assert torch.all(got[1][..., :2] == 0) and torch.all(got[2][:2] == 0)
    assert torch.any(got[2][2:] != 0)


def test_positive_ties_go_to_the_first_maximum():
    """A constant map under a centre-tap kernel makes every value of a
    pool window equal and positive: the gradient goes to the window's first
    position in row-major order, on both sides."""
    fmap = np.ones((1, 8, 8, 2), np.float32)
    kernel = np.zeros((3, 3, 2, 2), np.float32)
    kernel[1, 1] = np.eye(2)
    bias = np.zeros((2,), np.float32)
    _, got = _port_grads(fmap, kernel, bias)
    want = _jax_grads(jquad.quadrant_process, fmap, kernel, bias)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    g = got[0][0, :, :, 0]
    assert torch.all(g[0::2, 0::2] > 0)
    assert torch.all(g[1::2, :] == 0) and torch.all(g[:, 1::2] == 0)


def test_gradient_agrees_with_finite_differences():
    fmap, kernel, bias = _inputs(1, 4, 2, 2, seed=4)
    _, grads = _port_grads(fmap, kernel, bias)
    rng = np.random.default_rng(5)
    eps = 1e-3

    def loss(f, k, b):
        out = tquad.quadrant_process(*map(torch.from_numpy, (f, k, b)))
        return float((out.double() ** 2).sum())

    for i, g in enumerate(grads):
        v = rng.normal(size=g.shape).astype(np.float32)
        plus = [fmap, kernel, bias]
        minus = [fmap, kernel, bias]
        plus[i] = plus[i] + eps * v
        minus[i] = minus[i] - eps * v
        fd = (loss(*plus) - loss(*minus)) / (2 * eps)
        assert fd == pytest.approx(float((g.numpy() * v).sum()), rel=2e-2)


def test_gradient_dtypes_follow_the_primals():
    fmap, kernel, bias = _inputs(2, 8, 16, 8, seed=6)
    out, (gf, gk, gb) = _port_grads(fmap, kernel, bias, torch.bfloat16)
    assert out.dtype == gf.dtype == torch.bfloat16
    assert gk.dtype == gb.dtype == torch.float32
    want = _jax_grads(jquad.quadrant_process,
                      np.asarray(jnp.asarray(fmap, jnp.bfloat16), np.float32),
                      kernel, bias)
    # bf16 storage of act and of the cotangents: a few percent (act ties)
    for g, w in zip((gf, gk, gb), want):
        assert _rel_l2(g.float().numpy(), w) < 0.15


def test_frozen_input_gets_no_gradient_and_no_act_without_grad():
    fmap, kernel, bias = map(torch.from_numpy, _inputs(2, 8, 4, 4, seed=7))
    kernel.requires_grad_(True)
    out = tquad.quadrant_process(fmap, kernel, bias)
    out.sum().backward()
    assert kernel.grad is not None and fmap.grad is None
    with torch.no_grad():
        assert not tquad.quadrant_process(fmap, kernel, bias).requires_grad
    g = tquad.quadrant_backward(fmap, kernel.detach(), bias,
                                tquad.quadrant_process_with_act(
                                    fmap, kernel.detach(), bias)[1],
                                torch.ones_like(out), (False, True, False))
    assert g[0] is None and g[2] is None
    np.testing.assert_allclose(g[1].numpy(), kernel.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_training_form_rejects_maps_wider_than_its_kernel_takes(monkeypatch):
    monkeypatch.setattr(tquad, "on_cuda", lambda t: True)
    monkeypatch.setattr(tquad._build, "load", pytest.fail)
    with pytest.raises(ValueError, match="H <= 64"):
        tquad.quadrant_process_with_act(torch.zeros(1, 128, 128, 2),
                                        torch.zeros(3, 3, 2, 2),
                                        torch.zeros(2))
