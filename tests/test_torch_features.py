"""The port's 47- and 443-feature extractors (``surya_tpu_torch/features``)
against the JAX package's on the same landmark batches, the NaN guards
included: no pose, ``body_scale <= 0.05``, fewer than two torso points
visible, ``var_y == 0``, invisible history frames. NaN positions must be
equal; values agree to 1e-5 relative (f32, the same formulas; atan2,
arccos and norms round differently in the last bits)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surya_tpu.features import FEATURE_NAMES_47 as JAX_NAMES_47
from surya_tpu.features import extract_features_47 as jax_f47
from surya_tpu.features import pose_extended as jax_ext
from surya_tpu_torch.features import FEATURE_NAMES_47, extract_features_47
from surya_tpu_torch.features import landmarks as L
from surya_tpu_torch.features import pose_extended as port_ext

RTOL, ATOL = 1e-5, 1e-5


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _guarded_batch(seed, n=24):
    """Random landmarks, with rows that trip every guard of the 47 set."""
    rng = np.random.default_rng(seed)
    lm = rng.uniform(0, 1, (n, 33, 4)).astype(np.float32)
    torso = list(L.TORSO)
    lm[0, :, :3] = 0.5                       # zero-length limbs, scale 1
    lm[1, torso, :3] = 0.5 + rng.uniform(-0.01, 0.01, (4, 3))  # scale ≤ 0.05
    lm[2, torso, 3] = [0.9, 0.1, 0.1, 0.1]   # one torso point visible
    lm[3, torso, 3] = 0.9                    # var_y == 0
    lm[3, torso, 1] = 0.4
    lm[4, torso, 3] = 0.65                   # exactly at the threshold
    lm[5] = 0.0                              # an all-zero (no-pose) frame
    return lm


def test_feature_names_match_jax():
    assert FEATURE_NAMES_47 == JAX_NAMES_47
    assert port_ext.FEATURE_NAMES_EXTENDED == jax_ext.FEATURE_NAMES_EXTENDED
    assert port_ext.ANGLES_EXTENDED == jax_ext.ANGLES_EXTENDED


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_detected", [False, True])
def test_features_47_match_jax(seed, with_detected):
    lm = _guarded_batch(seed)
    det = None
    if with_detected:
        det = np.random.default_rng(seed + 10).uniform(size=len(lm)) > 0.3
        det[5] = False
    want = jax_f47(jnp.asarray(lm),
                   None if det is None else jnp.asarray(det))
    got = extract_features_47(torch.from_numpy(lm),
                              None if det is None else torch.from_numpy(det))
    _close(got.numpy(), want)
    assert torch.isnan(got[1, 43:46]).all()      # body_scale <= 0.05
    assert torch.isnan(got[2:4, 46]).all()       # < 2 torso points; var_y 0
    if with_detected:   # the no-pose row: zeros, then NaN
        assert (got[5, :33] == 0).all() and torch.isnan(got[5, 33:]).all()


def test_features_47_leading_dims():
    lm = _guarded_batch(3, 12).reshape(3, 4, 33, 4)
    _close(extract_features_47(torch.from_numpy(lm)).numpy(),
           jax_f47(jnp.asarray(lm)))


def _sequence(seed, b=2, t=6):
    rng = np.random.default_rng(seed)
    lm = rng.uniform(0, 1, (b, t, 33, 4)).astype(np.float32)
    lm[..., 3] = rng.uniform(0.3, 1.0, (b, t, 33))
    lm[0, 3, :, 3] = 0.1                     # an invisible history frame
    lm[1, 2, [L.LEFT_HIP, L.RIGHT_HIP], 3] = 0.2   # hips fall back to centre
    lm[1, 4, list(L.TORSO), 3] = [0.9, 0.1, 0.1, 0.1]
    lm[0, 5, [L.LEFT_SHOULDER, L.LEFT_ELBOW], :3] = 0.3   # zero-length limb
    lm[0, 5, [L.LEFT_SHOULDER, L.LEFT_ELBOW, L.LEFT_WRIST], 3] = 0.9
    return lm


@pytest.mark.parametrize("seed,size", [(0, "scalar"), (1, "per_frame"),
                                       (2, "scalar")])
def test_features_extended_match_jax(seed, size):
    lm = _sequence(seed)
    if size == "scalar":
        w, h = 640.0, 480.0
        tw, th, jw, jh = w, h, w, h
    else:
        rng = np.random.default_rng(seed)
        w = rng.choice([320.0, 640.0], lm.shape[:2]).astype(np.float32)
        h = rng.choice([240.0, 480.0], lm.shape[:2]).astype(np.float32)
        tw, th, jw, jh = (torch.from_numpy(w), torch.from_numpy(h),
                          jnp.asarray(w), jnp.asarray(h))
    got = port_ext.extract_features_extended(torch.from_numpy(lm), tw, th)
    want = jax_ext.extract_features_extended(jnp.asarray(lm), jw, jh)
    assert got.shape == (2, 6, 443)
    _close(got.numpy(), want)
    # the first two frames have no history: all dynamics NaN
    dyn = slice(132 + 10 + 3 + 99, 132 + 10 + 3 + 99 + 198)
    assert torch.isnan(got[:, :2, dyn]).all()


def test_features_extended_body_scale_fallbacks():
    """Shoulders narrow → hip width; both narrow → H/3 (scalar sizes)."""
    lm = _sequence(4)
    lm[0, 0, [L.LEFT_SHOULDER, L.RIGHT_SHOULDER], 0] = 0.5
    lm[0, 1, [L.LEFT_SHOULDER, L.RIGHT_SHOULDER, L.LEFT_HIP,
              L.RIGHT_HIP], 0] = 0.5
    lm[0, :, :, 3] = 0.9
    got = port_ext.extract_features_extended(torch.from_numpy(lm), 100, 90)
    _close(got.numpy(),
           jax_ext.extract_features_extended(jnp.asarray(lm), 100, 90))
