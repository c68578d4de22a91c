"""The port's diffusion sampler, conditioning and TinyDenoiser
(``surya_tpu_torch/models/diffusion/{euler_ancestral,conditioning,
tiny_unet}.py``) against the JAX package's, on the CPU at f32.

Tolerances: the schedule tables bit-equal; the step math 1e-6 relative;
TinyDenoiser and a 10-step ``sample`` 1e-5 relative (max |port − JAX| /
max |JAX|); ``combine_conditioning`` exact. JAX's side is jitted and its
weights are made once per file; the sampler is fed JAX's own draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_fixtures import one_torch_thread  # noqa: F401

from surya_tpu.models.diffusion import EulerAncestralSchedule as JaxSchedule
from surya_tpu.models.diffusion import TinyDenoiser as JaxTiny
from surya_tpu.models.diffusion import combine_conditioning as jax_combine
from surya_tpu.models.diffusion import sample as jax_sample
from surya_tpu_torch.models.diffusion import (
    EulerAncestralSchedule,
    TinyDenoiser,
    clip_conditioning_fn,
    combine_conditioning,
    sample,
)
from surya_tpu_torch.models.from_jax import from_jax_variables

FEATURES = 16


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("spacing", ["trailing", "linspace", "leading"])
@pytest.mark.parametrize("steps", [75, 61, 103])
def test_schedule_tables_bit_equal(steps, spacing):
    for pred in ("epsilon", "v_prediction"):
        want = JaxSchedule.create(steps, timestep_spacing=spacing,
                                  prediction_type=pred)
        got = EulerAncestralSchedule.create(steps, timestep_spacing=spacing,
                                            prediction_type=pred)
        np.testing.assert_array_equal(got.timesteps, want.timesteps)
        np.testing.assert_array_equal(got.sigmas, want.sigmas)
        assert got.timesteps.dtype == got.sigmas.dtype == np.float32
        assert got.init_noise_sigma == want.init_noise_sigma
        assert got.prediction_type == want.prediction_type


@pytest.mark.parametrize("pred_type", ["epsilon", "v_prediction"])
def test_step_math_matches_jax(pred_type):
    """A 12-step chain of ``scale_model_input``, ``step`` and
    ``add_noise`` on the same arrays, 1e-6 relative."""
    rng = np.random.default_rng(0)
    js = JaxSchedule.create(12, prediction_type=pred_type)
    ts = EulerAncestralSchedule.create(12, prediction_type=pred_type)
    x = rng.normal(size=(2, 5, 4, 3)).astype(np.float32) * js.init_noise_sigma
    xt = torch.from_numpy(x)
    for i in range(12):
        out = rng.normal(size=x.shape).astype(np.float32)
        noise = rng.normal(size=x.shape).astype(np.float32)
        assert rel(ts.scale_model_input(xt, i),
                   js.scale_model_input(jnp.asarray(x), i)) <= 1e-6
        assert rel(ts.add_noise(xt, torch.from_numpy(noise), i),
                   js.add_noise(jnp.asarray(x), jnp.asarray(noise), i)) <= 1e-6
        x = np.asarray(js.step(jnp.asarray(out), i, jnp.asarray(x),
                               jnp.asarray(noise)))
        xt = ts.step(torch.from_numpy(out), i, xt, torch.from_numpy(noise))
        assert rel(xt, x) <= 1e-6, i


def test_nearest_exact_is_jax_nearest():
    """``jax.image.resize(..., "nearest")`` samples at half-pixel centres:
    torch's ``nearest-exact``, not ``nearest`` (they agree at 2×)."""
    rng = np.random.default_rng(1)
    for src, dst in ((5, 8), (3, 5), (7, 13), (9, 5), (4, 8)):
        x = rng.normal(size=(1, 2, src, src + 1)).astype(np.float32)
        want = np.asarray(jax.image.resize(
            jnp.asarray(x), (1, 2, dst, dst + 2), "nearest"))
        got = F.interpolate(torch.from_numpy(x), size=(dst, dst + 2),
                            mode="nearest-exact").numpy()
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def tiny():
    """JAX TinyDenoiser weights (``out_conv`` moved off its zero init so
    the output depends on every layer), their port, and the jitted
    apply."""
    model = JaxTiny(features=FEATURES)
    x = jnp.zeros((1, 9, 7, 3))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), x,
                                    jnp.float32(0.0), x)
    variables = jax.device_get(variables)
    rng = np.random.default_rng(2)
    oc = variables["params"]["out_conv"]
    oc["kernel"] = rng.normal(0, 0.1, oc["kernel"].shape).astype(np.float32)
    port = TinyDenoiser(FEATURES)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return model, variables, jax.jit(model.apply), port.eval()


def test_tiny_denoiser_odd_size(tiny):
    """9×7: the stride-2 SAME conv pads (1, 1) on odd sizes and the up
    path resizes 5×4 → 9×7 with half-pixel nearest; 1e-5 relative."""
    _, variables, apply, port = tiny
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 7, 3)).astype(np.float32)
    cond = rng.normal(size=(2, 9, 7, 3)).astype(np.float32)
    for t in (5.0, 999.0):
        want = np.asarray(apply(variables, x, jnp.float32(t), cond))
        with torch.no_grad():
            got = port(torch.from_numpy(x), torch.tensor(t),
                       torch.from_numpy(cond))
        assert got.shape == (2, 9, 7, 3) and got.dtype == torch.float32
        assert rel(got, want) <= 1e-5, (t, rel(got, want))


def test_sample_ten_steps_on_jax_draws(tiny):
    """``sample`` with TinyDenoiser over 10 v-prediction steps, fed JAX's
    draws (``split(key)`` for the start, ``k, kn = split(k)`` per step),
    against JAX's ``lax.scan`` trajectory: 1e-5 relative."""
    model, variables, apply, port = tiny
    shape = (1, 8, 6, 3)
    cond = np.random.default_rng(4).uniform(-1, 1, shape).astype(np.float32)
    js = JaxSchedule.create(10, prediction_type="v_prediction")
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(lambda k: jax_sample(
        js, lambda s, t: model.apply(variables, s, t, cond), k, shape))(key))

    k, sub = jax.random.split(key)
    init = np.array(jax.random.normal(sub, shape, jnp.float32))
    steps = []
    for _ in range(10):
        k, kn = jax.random.split(k)
        steps.append(torch.from_numpy(np.array(
            jax.random.normal(kn, shape, jnp.float32))))
    ts = EulerAncestralSchedule.create(10, prediction_type="v_prediction")
    c = torch.from_numpy(cond)
    with torch.no_grad():
        got = sample(ts, lambda s, t, i: port(s, t, c), shape,
                     init_noise=torch.from_numpy(init), step_noise=steps)
    assert got.shape == shape
    assert rel(got, want) <= 1e-5, rel(got, want)


def test_sample_needs_draws():
    ts = EulerAncestralSchedule.create(2)
    with pytest.raises(ValueError, match="generator"):
        sample(ts, lambda s, t, i: s, (1, 2, 2, 3))
    g = torch.Generator().manual_seed(0)
    a = sample(ts, lambda s, t, i: 0.1 * s, (1, 2, 2, 3), generator=g)
    b = sample(ts, lambda s, t, i: 0.1 * s, (1, 2, 2, 3),
               generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)


def test_combine_conditioning_exact():
    rng = np.random.default_rng(0)
    prompt = rng.normal(0, 1, (2, 5, 8)).astype(np.float32)
    image = rng.normal(0, 1, (2, 8)).astype(np.float32)
    ramp = rng.normal(0, 1, (5,)).astype(np.float32)
    got = combine_conditioning(torch.from_numpy(prompt),
                               torch.from_numpy(image),
                               torch.from_numpy(ramp)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_combine(prompt, image, ramp)))
    with pytest.raises(ValueError, match="ramp length"):
        combine_conditioning(torch.from_numpy(prompt),
                             torch.from_numpy(image),
                             torch.from_numpy(ramp[:3]))


def test_clip_conditioning_fn_with_stand_in_encoders():
    """Stand-in CLIP encoders as callables: the CLIP normalisation reaches
    the vision encoder, the projection applies to a pooled output, and
    the ramp's zero token keeps the prompt embedding for every image."""
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.normal(size=(1, 5, 6)).astype(np.float32))
    proj = torch.from_numpy(rng.normal(0, 0.1, (4, 6)).astype(np.float32))
    seen = []

    class Pooled:
        def __init__(self, x):
            self.pooler_output = x.mean(dim=(2, 3)).repeat(1, 2)[:, :4]

    def vision(px):
        seen.append(px)
        return Pooled(px)

    ramp = torch.linspace(0.0, 1.0, 5)
    fn = clip_conditioning_fn(lambda ids: prompt, vision,
                              torch.zeros((1, 5), dtype=torch.int64), ramp,
                              image_proj=proj)
    img = torch.from_numpy(rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32))
    ehs = fn(img)
    assert ehs.shape == (2, 5, 6)
    mean = torch.tensor([0.48145466, 0.4578275, 0.40821073])
    std = torch.tensor([0.26862954, 0.26130258, 0.27577711])
    torch.testing.assert_close(seen[0], ((img - mean) / std).permute(
        0, 3, 1, 2), rtol=0, atol=0)
    embeds = Pooled(seen[0]).pooler_output @ proj
    torch.testing.assert_close(
        ehs, prompt + ramp[None, :, None] * embeds[:, None, :],
        rtol=0, atol=0)
    e2 = fn(img * 0.5)
    torch.testing.assert_close(ehs[:, 0], e2[:, 0], rtol=0, atol=0)
    assert float((ehs[:, -1] - e2[:, -1]).abs().max()) > 1e-5
