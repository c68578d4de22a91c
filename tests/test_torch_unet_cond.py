"""The port's zero123plus UNet with reference attention
(``surya_tpu_torch/models/diffusion/unet_cond.py``) against the JAX
package's, on the CPU at f32.

Weights come from ``tests/torch_mirror_unet.py`` (diffusers' names, its
norm parameters moved off 1 and 0), through JAX's ``import_unet``, so no
flax init runs; the JAX side is jitted once per pass. Tolerances: outputs
and every bank entry 1e-5 relative (max |port − JAX| / max |JAX|); the
bridge's round trip bit for bit. The full-width configurations are built
on the ``meta`` device only: their parameter counts against
``jax.eval_shape``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mirror_unet import MirrorUNet2DCondition
from torch_port_fixtures import one_torch_thread  # noqa: F401

from surya_tpu.models.diffusion import unet_cond as juc
from surya_tpu.models.diffusion.euler_ancestral import (
    EulerAncestralSchedule as JaxSchedule,
)
from surya_tpu_torch.models.common import count_parameters
from surya_tpu_torch.models.diffusion import unet_cond as tuc
from surya_tpu_torch.models.diffusion.euler_ancestral import (
    EulerAncestralSchedule,
)
from surya_tpu_torch.models.diffusion.unet_cond import diffusers_state_dict

TINY = dict(in_channels=4, out_channels=4, block_out_channels=(8, 16),
            layers_per_block=1, num_heads=(2, 2),
            down_has_attn=(True, False), cross_attention_dim=12,
            norm_num_groups=4)
TOL = 1e-5


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def inputs(seed=0, b=2, h=16, w=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, h, w, 4)).astype(np.float32)
    t = np.asarray([3.0, 999.0][:b], np.float32)
    ehs = rng.normal(0, 1, (b, 7, 12)).astype(np.float32)
    return x, t, ehs


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def unet():
    """(mirror state_dict, JAX variables, jitted write and read passes,
    the port's model from the JAX tree)."""
    torch.manual_seed(0)
    state = MirrorUNet2DCondition(**TINY).state_dict()
    rng = np.random.default_rng(5)
    for k, v in state.items():   # norm scales and biases off 1 and 0
        if v.dim() == 1 and "norm" in k:
            v.add_(torch.from_numpy(rng.normal(0, 0.2, v.shape).astype(
                np.float32)))
    variables = jax.device_get(juc.import_unet(state))
    model = juc.UNet2DCondition(juc.tiny_config())
    write = jax.jit(model.apply)
    read = jax.jit(lambda v, x, t, e, r: model.apply(v, x, t, e, refs=r))
    port = tuc.UNet2DCondition(tuc.tiny_config())
    port.load_state_dict(diffusers_state_dict(variables), strict=True)
    return state, variables, write, read, port.eval(), model


def test_write_bank_and_read_match_jax(unet):
    """The write pass's output and its 4 bank entries (post-norm1 states:
    down level 0, mid, up level 1 twice), then a read pass over another
    input's bank."""
    _, variables, write, read, port, _ = unet
    x, t, ehs = inputs()
    x2, _, _ = inputs(seed=9)
    want, bank = write(variables, x, t, ehs)
    _, bank2 = write(variables, x2, t, ehs)
    want_read, _ = read(variables, x, t, ehs, bank2)
    with torch.no_grad():
        got, got_bank = port(t_(x), t_(t), t_(ehs))
        _, got_bank2 = port(t_(x2), t_(t), t_(ehs))
        got_read, _ = port(t_(x), t_(t), t_(ehs), refs=got_bank2)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert rel(got, want) <= TOL
    assert len(got_bank) == len(bank) == 4
    for g, w in zip(got_bank, bank):
        assert g.shape == w.shape and rel(g, w) <= TOL
    assert rel(got_read, want_read) <= TOL
    assert float((got_read - got).abs().max()) > 1e-4   # the bank is live


def test_duplicated_ref_is_identity(unet):
    """A forward's own bank fed back as refs gives the plain forward: the
    softmax over duplicated keys renormalises to the same weights."""
    port = unet[4]
    x, t, ehs = inputs(seed=1)
    with torch.no_grad():
        plain, bank = port(t_(x), t_(t), t_(ehs))
        reread, _ = port(t_(x), t_(t), t_(ehs), refs=bank)
    torch.testing.assert_close(reread, plain, rtol=1e-5, atol=1e-5)


def test_reference_denoiser_with_injected_cond_noise(unet):
    """One step of the two-pass denoiser at step i with JAX's cond noise
    (``fold_in(key, i)``) injected; the port takes i from the loop."""
    _, variables, _, _, port, model = unet
    schedule = JaxSchedule.create(5, prediction_type="v_prediction")
    ts = EulerAncestralSchedule.create(5, prediction_type="v_prediction")
    rng = np.random.default_rng(3)
    cond = rng.normal(0, 1, (1, 8, 6, 4)).astype(np.float32)
    scaled = rng.normal(0, 1, (1, 16, 12, 4)).astype(np.float32)
    ehs = rng.normal(0, 1, (1, 7, 12)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    i = 2
    denoiser = juc.reference_conditioned_denoiser(
        model, variables["params"], schedule, jnp.asarray(ehs),
        jnp.asarray(cond), key)
    want = jax.jit(denoiser)(scaled, jnp.asarray(schedule.timesteps)[i])
    noise = np.array(jax.random.normal(jax.random.fold_in(key, i),
                                       cond.shape, jnp.float32))
    got_fn = tuc.reference_conditioned_denoiser(
        port, ts, t_(ehs), t_(cond), cond_noise=lambda j: t_(noise))
    with torch.no_grad():
        got = got_fn(t_(scaled), ts.table("timesteps", "cpu")[i], i)
    assert rel(got, want) <= TOL, rel(got, want)
    with pytest.raises(ValueError, match="cond noise"):
        tuc.reference_conditioned_denoiser(port, ts, t_(ehs), t_(cond))


def test_import_unet_and_round_trip(unet):
    """``import_unet`` of the mirror's state_dict (a strict load of
    diffusers' names) gives JAX's ``import_unet`` + ``apply`` logits, and
    ``from_jax_variables`` of JAX's tree is that state_dict bit for bit."""
    state, variables, write, _, _, _ = unet
    back = diffusers_state_dict(variables)
    assert set(back) == set(state)
    assert all(torch.equal(back[k], state[k]) for k in state)
    port = tuc.import_unet(state, tuc.tiny_config(), device="cpu")
    x, t, ehs = inputs(seed=2, h=8, w=8)
    want, _ = write(variables, x, t, ehs)
    with torch.no_grad():
        got, _ = port(t_(x), t_(t), t_(ehs))
    assert rel(got, want) <= TOL


def test_zero123plus_config_counts_on_meta():
    """The published widths build on ``meta`` with JAX's parameter count
    (865,910,724, from ``jax.eval_shape`` of its init); nothing is
    materialised."""
    cfg = tuc.zero123plus_config()
    assert cfg.block_out_channels == (320, 640, 1280, 1280)
    assert cfg.layers_per_block == 2 and cfg.cross_attention_dim == 1024
    assert all(c // h == 64 for c, h in zip(cfg.block_out_channels,
                                            cfg.num_heads))
    assert cfg.up_has_attn == (False, True, True, True)
    assert cfg.dtype == torch.bfloat16
    with torch.device("meta"):
        model = tuc.UNet2DCondition(cfg)
    shapes = jax.eval_shape(lambda: juc.UNet2DCondition(
        juc.zero123plus_config()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)),
            jnp.zeros((1,)), jnp.zeros((1, 77, 1024))))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes))
    assert count_parameters(model) == want == 865_910_724
