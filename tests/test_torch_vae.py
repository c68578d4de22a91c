"""The port's AutoencoderKL (``surya_tpu_torch/models/diffusion/vae.py``)
against the JAX package's, on the CPU at f32.

Weights come from ``tests/torch_mirror_vae.py`` (diffusers' names, norm
parameters moved off 1 and 0) through JAX's ``import_vae``; the JAX side
is jitted. Tolerances: encode's moments and decode 1e-5 relative (max
|port − JAX| / max |JAX|); ``sample_latents`` on the same draw 1e-6; the
bridge's round trip bit for bit; ``sd_vae_config`` on ``meta`` at JAX's
parameter count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mirror_vae import MirrorAutoencoderKL
from torch_port_fixtures import one_torch_thread  # noqa: F401

from surya_tpu.models.diffusion import vae as jvae
from surya_tpu_torch.models.common import count_parameters
from surya_tpu_torch.models.diffusion import vae as tvae
from surya_tpu_torch.models.diffusion.unet_cond import diffusers_state_dict

TINY = dict(in_channels=3, out_channels=3, latent_channels=4,
            block_out_channels=(8, 16), layers_per_block=1,
            norm_num_groups=4)
TOL = 1e-5


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def vae():
    torch.manual_seed(0)
    state = MirrorAutoencoderKL(**TINY).state_dict()
    rng = np.random.default_rng(1)
    for k, v in state.items():
        if v.dim() == 1 and "norm" in k:
            v.add_(torch.from_numpy(rng.normal(0, 0.2, v.shape).astype(
                np.float32)))
    variables = jax.device_get(jvae.import_vae(state))
    model = jvae.AutoencoderKL(jvae.tiny_vae_config())
    encode = jax.jit(lambda v, x: model.apply(v, x, method="encode"))
    decode = jax.jit(lambda v, z: model.apply(v, z, method="decode"))
    port = tvae.AutoencoderKL(tvae.tiny_vae_config())
    port.load_state_dict(diffusers_state_dict(variables), strict=True)
    return state, variables, encode, decode, port.eval()


def test_encode_decode_match_jax(vae):
    """Odd sizes on the way down (the (0, 1, 0, 1) pad + VALID conv) and
    the mid-block attention at both ends."""
    _, variables, encode, decode, port = vae
    x = np.random.default_rng(0).uniform(-1, 1, (2, 14, 10, 3)).astype(
        np.float32)
    mean, logvar = encode(variables, x)
    with torch.no_grad():
        got_mean, got_logvar = port.encode(torch.from_numpy(x))
    assert got_mean.shape == mean.shape == (2, 7, 5, 4)
    assert rel(got_mean, mean) <= TOL and rel(got_logvar, logvar) <= TOL
    z = np.random.default_rng(1).normal(size=(2, 6, 5, 4)).astype(np.float32)
    want = decode(variables, z)
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z))
    assert got.shape == want.shape == (2, 12, 10, 3)
    assert got.dtype == torch.float32 and rel(got, want) <= TOL


def test_logvar_clip_and_sample_latents(vae):
    """``encode`` clips logvar to [-30, 20]; ``sample_latents`` on JAX's
    own draw is JAX's reparameterisation (1e-6); a generator's draw
    repeats with its seed."""
    port = vae[4]
    rng = np.random.default_rng(2)
    mean = rng.normal(size=(1, 4, 3, 4)).astype(np.float32)
    logvar = rng.normal(0, 20, size=mean.shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jvae.sample_latents(jnp.asarray(mean), jnp.asarray(logvar), key)
    noise = np.array(jax.random.normal(key, mean.shape, jnp.float32))
    got = tvae.sample_latents(torch.from_numpy(mean),
                              torch.from_numpy(logvar),
                              torch.from_numpy(noise))
    assert rel(got, want) <= 1e-6
    a = tvae.sample_latents(torch.from_numpy(mean), torch.from_numpy(logvar),
                            generator=torch.Generator().manual_seed(0))
    b = tvae.sample_latents(torch.from_numpy(mean), torch.from_numpy(logvar),
                            generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tvae.sample_latents(torch.from_numpy(mean), torch.from_numpy(logvar))
    with torch.no_grad():
        _, lv = port.encode(torch.full((1, 8, 8, 3), 50.0))
    assert float(lv.min()) >= -30.0 and float(lv.max()) <= 20.0
    with torch.no_grad():
        rec, (m, _) = port(torch.zeros(1, 8, 8, 3))
    assert rec.shape == (1, 8, 8, 3) and m.shape == (1, 4, 4, 4)


def test_import_vae_and_round_trip(vae):
    state, variables, encode, _, _ = vae
    back = diffusers_state_dict(variables)
    assert set(back) == set(state)
    assert all(torch.equal(back[k], state[k]) for k in state)
    port = tvae.import_vae(state, tvae.tiny_vae_config(), device="cpu")
    x = np.random.default_rng(4).uniform(-1, 1, (1, 8, 8, 3)).astype(
        np.float32)
    mean, _ = encode(variables, x)
    with torch.no_grad():
        got, _ = port.encode(torch.from_numpy(x))
    assert rel(got, mean) <= TOL


def test_sd_vae_config_count_on_meta():
    with torch.device("meta"):
        model = tvae.AutoencoderKL(tvae.sd_vae_config())
    shapes = jax.eval_shape(lambda: jvae.AutoencoderKL(
        jvae.sd_vae_config()).init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 16, 16, 3))))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes))
    assert count_parameters(model) == want == 83_653_863
    assert tvae.SD_SCALING_FACTOR == jvae.SD_SCALING_FACTOR
