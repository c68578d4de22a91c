"""The port's augmentations (``surya_tpu_torch/data/augment.py``) against
``surya_tpu/data/augment.py`` on the CPU.

Each op gets the parameters JAX drew for a key (re-derived here with JAX's
own key splits) and must give JAX's output to 1e-5 absolute (float32
rounding; the per-pixel arithmetic is the same expression in both). The
draws come from different streams (a ``torch.Generator`` against JAX keys)
and are compared by distribution: range, mean and flip rate.

The whole ``augment_batch`` is compared with JAX's run op by op
(``jax.disable_jit``). Under ``jit`` XLA on the CPU fuses the bilinear
sample into the hue conversion and recomputes it there with other
rounding, so ``_rgb_to_hsv``'s ``maxc == r`` tests fail for some pixels and
their hue comes out wrong (differences near 1 after normalisation); the
eager result is the function as written.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from surya_tpu.data import augment as ja
from surya_tpu_torch.data import augment as ta
from torch_port_fixtures import one_torch_thread  # noqa: F401

TOL = 1e-5


def _jax_params(key, b, h, w, scale_min=0.8, hflip_prob=0.5,
                jitter=(0.2, 0.2, 0.2, 0.1), rotation_deg=10.0,
                blur_sigma=(0.1, 0.5)):
    """What ``ja.augment_batch(key, ...)`` draws, as the port's dict."""
    k_crop, k_flip, k_rot, k_jit, k_blur = jax.random.split(key, 5)
    y0, x0, ch, cw = ja._rrc_params(k_crop, b, h, w, scale_min, 1.0)
    theta = jnp.deg2rad(jax.random.uniform(
        k_rot, (b,), minval=-rotation_deg, maxval=rotation_deg))
    flip = jax.random.bernoulli(k_flip, hflip_prob, (b,))
    kb, kc, ks, kh = jax.random.split(k_jit, 4)

    def u(k, shape, lo, hi):
        return jax.random.uniform(k, shape, minval=lo,
                                  maxval=hi).reshape(b)

    bright, contrast, sat, hue = jitter
    p = {"y0": y0, "x0": x0, "ch": ch, "cw": cw, "cos": jnp.cos(theta),
         "sin": jnp.sin(theta), "flip": flip,
         "brightness": (u(kb, (b, 1, 1, 1), 1 - bright, 1 + bright)
                        if bright > 0 else None),
         "contrast": (u(kc, (b, 1, 1, 1), 1 - contrast, 1 + contrast)
                      if contrast > 0 else None),
         "saturation": (u(ks, (b, 1, 1, 1), 1 - sat, 1 + sat)
                        if sat > 0 else None),
         "hue": u(kh, (b, 1, 1), -hue, hue) if hue > 0 else None,
         "sigma": u(k_blur, (b, 1), blur_sigma[0], blur_sigma[1])}
    return {k: None if v is None else torch.from_numpy(np.array(v))
            for k, v in p.items()}


def _images(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _close(got, want, tol=TOL):
    got = got.numpy() if torch.is_tensor(got) else got
    err = np.abs(got - np.asarray(want)).max()
    assert err <= tol, err


def test_normalize_matches_jax():
    x = _images((2, 8, 8, 3))
    _close(ta.normalize(torch.from_numpy(x)), ja.normalize(jnp.asarray(x)))


@pytest.mark.parametrize("b,h,w,out", [(3, 64, 40, 64), (2, 256, 256, 224)])
def test_crop_flip_rotate_matches_jax(b, h, w, out):
    """Crop box, rotation about the output centre, flip, bilinear sample
    with JAX's border rule (weights from the unclamped floor)."""
    x = _images((b, h, w, 3), seed=b)
    key = jax.random.key(b)
    p = _jax_params(key, b, h, w)
    oy = (jnp.arange(out, dtype=jnp.float32) + 0.5)[None, :, None]
    ox = (jnp.arange(out, dtype=jnp.float32) + 0.5)[None, None, :]
    c = out / 2.0
    cos = jnp.asarray(p["cos"].numpy())[:, None, None]
    sin = jnp.asarray(p["sin"].numpy())[:, None, None]
    ry = c + (oy - c) * cos - (ox - c) * sin
    rx = c + (oy - c) * sin + (ox - c) * cos
    rx = jnp.where(jnp.asarray(p["flip"].numpy())[:, None, None], out - rx,
                   rx)
    ys = (jnp.asarray(p["y0"].numpy())[:, None, None]
          + ry * (jnp.asarray(p["ch"].numpy()) / out)[:, None, None] - 0.5)
    xs = (jnp.asarray(p["x0"].numpy())[:, None, None]
          + rx * (jnp.asarray(p["cw"].numpy()) / out)[:, None, None] - 0.5)
    want = ja._bilinear_sample(jnp.asarray(x), ys, xs)
    _close(ta.crop_flip_rotate(torch.from_numpy(x), p, out), want)


def test_bilinear_border_rule_matches_jax():
    """Coordinates outside the image, on both sides: the corners clamp
    after the weights are taken."""
    x = _images((2, 6, 7, 3), seed=3)
    rng = np.random.default_rng(4)
    ys = rng.uniform(-2.5, 8.5, (2, 5, 5)).astype(np.float32)
    xs = rng.uniform(-2.5, 9.5, (2, 5, 5)).astype(np.float32)
    want = ja._bilinear_sample(jnp.asarray(x), jnp.asarray(ys),
                               jnp.asarray(xs))
    _close(ta.bilinear_sample(torch.from_numpy(x), torch.from_numpy(ys),
                              torch.from_numpy(xs)), want)


@pytest.mark.parametrize("jitter", [(0.2, 0.2, 0.2, 0.1),
                                    (0.5, 0.0, 0.4, 0.5),
                                    (0.0, 0.3, 0.0, 0.0)])
def test_color_jitter_matches_jax(jitter):
    """Brightness, contrast, saturation and hue (a negative shift half the
    time: floor modulo) for the factors JAX drew."""
    b = 6
    x = _images((b, 12, 10, 3), seed=5)
    key = jax.random.key(11)
    p = _jax_params(key, b, 12, 10, jitter=jitter)
    k_jit = jax.random.split(key, 5)[3]
    want = ja.color_jitter(k_jit, jnp.asarray(x), *jitter)
    _close(ta.color_jitter(torch.from_numpy(x), p), want)


def test_hsv_round_trip_matches_jax():
    x = _images((3, 9, 9, 3), seed=6)
    x[0, 0, 0] = [0.5, 0.5, 0.5]          # grey: rng == 0
    x[0, 0, 1] = [1.0, 0.0, 0.0]          # pure red
    x[0, 0, 2] = [0.0, 0.0, 0.0]          # black: maxc == 0
    hsv = ta.rgb_to_hsv(torch.from_numpy(x))
    _close(hsv, ja._rgb_to_hsv(jnp.asarray(x)))
    h = hsv.numpy().copy()
    h[..., 0] = np.random.default_rng(7).uniform(0, 1, h.shape[:-1])
    _close(ta.hsv_to_rgb(torch.from_numpy(h)), ja._hsv_to_rgb(jnp.asarray(h)))


def test_gaussian_blur_matches_jax():
    """A 9-tap vertical and a 5-tap horizontal pass over edge padding,
    with the σ JAX drew per sample."""
    b = 4
    x = _images((b, 11, 13, 3), seed=8)
    key = jax.random.key(3)
    sigma = jax.random.uniform(key, (b, 1), minval=0.1, maxval=0.5)
    want = ja.gaussian_blur(key, jnp.asarray(x))
    _close(ta.gaussian_blur(torch.from_numpy(x),
                            torch.from_numpy(np.array(sigma)).reshape(b)),
           want)


def test_augment_batch_matches_jax_for_the_same_key(b=2, h=256, out=224):
    """The staging size to the train size, as the real path runs it."""
    x = _images((b, h, h, 3), seed=9)
    key = jax.random.key(7)
    with jax.disable_jit():
        want = ja.augment_batch(key, jnp.asarray(x), out_size=out)
    got = ta.apply_augment(torch.from_numpy(x), _jax_params(key, b, h, h),
                           out)
    assert got.shape == (b, out, out, 3)
    _close(got, want)


@pytest.mark.parametrize("b,h,out", [(2, 256, 224), (2, 48, 32),
                                     (2, 32, 32), (2, 32, 64)])
def test_eval_preprocess_matches_jax(b, h, out):
    """256 → 224 is the real path: jax.image.resize antialiases when it
    downscales, so the port resizes with antialias=True (without it the
    difference is about 0.2)."""
    x = _images((b, h, h, 3), seed=10)
    want = ja.eval_preprocess(jnp.asarray(x), out_size=out)
    _close(ta.eval_preprocess(torch.from_numpy(x), out), want)


def test_draws_match_jax_by_distribution():
    """Quantiles, mean and flip rate of 4096 draws from each side."""
    n, h = 4096, 256
    got = ta.draw_augment_params(torch.Generator().manual_seed(0), n, h, h)
    want = _jax_params(jax.random.key(0), n, h, h)
    for name in ("y0", "x0", "ch", "cw", "cos", "sin", "brightness",
                 "contrast", "saturation", "hue", "sigma"):
        g, w = got[name].double(), want[name].double()
        spread = float(w.max() - w.min())
        q = torch.tensor([0.05, 0.25, 0.5, 0.75, 0.95], dtype=torch.float64)
        assert (torch.quantile(g, q) - torch.quantile(w, q)).abs().max() <= (
            0.03 * spread), name
        # 5 standard errors of the difference of two means
        se = float(w.std()) * np.sqrt(2 / n)
        assert abs(float(g.mean() - w.mean())) <= 5 * se, name
    for flips in (got["flip"], want["flip"]):
        assert abs(float(flips.double().mean()) - 0.5) < 0.03
    assert got["ch"].max() <= h and got["cw"].max() <= h
    assert ((got["y0"] + got["ch"]) <= h + 1e-3).all()


def test_augment_batch_is_a_function_of_the_generator():
    x = torch.from_numpy(_images((3, 40, 40, 3), seed=12))
    a = ta.augment_batch(torch.Generator().manual_seed(5), x, out_size=32)
    b = ta.augment_batch(torch.Generator().manual_seed(5), x, out_size=32)
    c = ta.augment_batch(torch.Generator().manual_seed(6), x, out_size=32)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert a.shape == (3, 32, 32, 3) and torch.isfinite(a).all()


def test_zero_jitter_strength_skips_the_op():
    p = ta.draw_augment_params(torch.Generator().manual_seed(0), 2, 8, 8,
                               jitter=(0.0, 0.0, 0.3, 0.0))
    assert p["brightness"] is None and p["contrast"] is None
    assert p["hue"] is None and p["saturation"] is not None
