"""The port's pose tier against the JAX package's, on the same inputs:

- the generator's deterministic math (``pose_from_draws``, ``articulate``,
  ``camera_transform``, ``render_pose``, the augmentation's apply half) on
  values drawn by JAX's own streams; ``class_swing_centers`` bit-equal;
- ``PoseLandmarkNet`` at f32 on bridged weights (landmarks, heatmaps,
  vis_logits at 32 and 64 px), flax's GroupNorm and the decoder's upsample;
- ``landmark_loss`` and its gradients, 5 Adam steps under the warmup-cosine
  schedule against an optax loop;
- the msgpack artifacts both ways (the three checkpoints in ``runs/``);
- the neural extractor on ``runs/pose_landmark_cpu`` (96 px) and the
  PIL-equivalent resample against PIL;
- ``pose-train --device cpu``.

Tolerances (f32): 1e-5 relative to each tensor's largest magnitude
(generator, forward, loss, gradients, extractor landmarks); Adam's
parameters after 5 steps 1e-6 absolute (lr 1e-3; the elements whose
gradient is within rounding of 0 to the sum of the rates, see the test),
and on the same gradients four f32 ulps + 1e-4 of the summed rates; bf16
GroupNorm one bf16
step (1e-2); the resample at most 1 uint8 level, and no more than 0.1% of
the values may differ at all.
"""

import inspect
import json
import os

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import flax.linen as nn
import flax.serialization as fser
import jax
import jax.numpy as jnp
from PIL import Image

from surya_tpu.data import synthetic_pose as jsp
from surya_tpu.models.pose import landmark_net as jln
from surya_tpu_torch.__main__ import main as port_main
from surya_tpu_torch.core import flax_msgpack
from surya_tpu_torch.data import synthetic_pose as tsp
from surya_tpu_torch.data.resample import pil_bilinear_u8
from surya_tpu_torch.models.from_jax import from_jax_variables, to_jax_params
from surya_tpu_torch.models.pose import landmark_net as tln
from surya_tpu_torch.models.pose import train as ttrain
from torch_port_fixtures import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = [os.path.join(ROOT, "runs", d, "pose_landmark.msgpack")
         for d in ("pose_landmark", "pose_landmark_aug", "pose_landmark_cpu")]
REL = 1e-5


def _close(got, want, rel=REL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _jax_draws(key):
    """sample_pose's draws, from its own key split."""
    ks = jax.random.split(key, 7)
    u = jax.random.uniform
    return {"swings": u(ks[0], (8,), minval=-1.0, maxval=1.0),
            "scale": u(ks[1], minval=0.55, maxval=0.95),
            "theta": u(ks[2], minval=-0.5, maxval=0.5),
            "trans": u(ks[3], (2,), minval=-0.12, maxval=0.12),
            "jitter": jax.random.normal(ks[4], (33, 2)),
            "lean": u(ks[5], minval=-0.35, maxval=0.35),
            "z_noise": jax.random.normal(ks[6], (33,))}


def _stack_draws(keys):
    draws = [_jax_draws(k) for k in keys]
    return {k: torch.from_numpy(np.stack([np.asarray(d[k]) for d in draws]))
            for k in draws[0]}


# ---------------------------------------------------------------- generator

@pytest.mark.parametrize("num_classes,seed", [(8, 1234), (3, 0), (20, 7)])
def test_class_swing_centers_bit_equal(num_classes, seed):
    got = tsp.class_swing_centers(num_classes, seed)
    want = jsp.class_swing_centers(num_classes, seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_constants_equal():
    for name in ("TEMPLATE_XY", "BONES", "BONE_CHANNEL", "JOINT_CHANNEL",
                 "_CHAIN_PIVOTS", "_CHAIN_MASKS", "_CHAIN_RANGE"):
        assert np.array_equal(getattr(tsp, name), getattr(jsp, name)), name
    assert tsp._CHAINS == jsp._CHAINS


@pytest.mark.parametrize("conditional", [False, True])
def test_pose_from_draws_matches_sample_pose(conditional):
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    centers = jsp.class_swing_centers(4)
    labels = np.array([0, 1, 2, 3, 1, 0])
    if conditional:
        want = [jsp.sample_pose(k, swing_center=jnp.asarray(centers[c]),
                                swing_spread=0.25)
                for k, c in zip(keys, labels)]
        got = tsp.pose_from_draws(_stack_draws(keys),
                                  torch.from_numpy(centers[labels]), 0.25)
    else:
        want = [jsp.sample_pose(k) for k in keys]
        got = tsp.pose_from_draws(_stack_draws(keys))
    for g, w in zip(got, zip(*want)):
        _close(g, np.stack([np.asarray(x) for x in w]))


def test_articulate_and_camera_transform_match_jax():
    rng = np.random.default_rng(0)
    swings = rng.uniform(-1.2, 1.2, (5, 8)).astype(np.float32)
    scale = rng.uniform(0.5, 1.0, 5).astype(np.float32)
    theta = rng.uniform(-0.5, 0.5, 5).astype(np.float32)
    trans = rng.uniform(-0.1, 0.1, (5, 2)).astype(np.float32)
    got = tsp.camera_transform(tsp.articulate(torch.from_numpy(swings)),
                               torch.from_numpy(scale),
                               torch.from_numpy(theta),
                               torch.from_numpy(trans))
    want = [jsp.camera_transform(jsp.articulate(jnp.asarray(s)), c, t, tr)
            for s, c, t, tr in zip(swings, scale, theta, trans)]
    _close(got, np.stack([np.asarray(w) for w in want]))
    _close(tsp.articulate(torch.from_numpy(swings[0])),
           jsp.articulate(jnp.asarray(swings[0])))


@pytest.mark.parametrize("size", [32, 48])
def test_render_pose_matches_jax(size):
    keys = jax.random.split(jax.random.PRNGKey(size), 3)
    poses = [jsp.sample_pose(k) for k in keys]
    xy = np.stack([np.asarray(p[0]) for p in poses])
    z = np.stack([np.asarray(p[1]) for p in poses])
    want = np.stack([np.asarray(jsp.render_pose(jnp.asarray(a),
                                                jnp.asarray(b), size))
                     for a, b in zip(xy, z)])
    got = tsp.render_pose(torch.from_numpy(xy), torch.from_numpy(z), size)
    assert got.shape == (3, size, size, 3)
    _close(got, want)
    _close(tsp.render_pose(torch.from_numpy(xy[0]), torch.from_numpy(z[0]),
                           size), want[0])


@pytest.mark.parametrize("occlude_p,mirror_p", [(0.7, 0.0), (0.0, 0.6),
                                                (0.5, 0.5)])
def test_apply_pose_augment_matches_jax(occlude_p, mirror_p):
    b, s = 6, 32
    key = jax.random.PRNGKey(11)
    imgs = np.random.default_rng(1).random((b, s, s, 3), dtype=np.float32)
    xy = np.random.default_rng(2).random((b, 33, 2), dtype=np.float32)
    want_imgs, want_xy = jsp.augment_pose_batch(
        key, jnp.asarray(imgs), jnp.asarray(xy), occlude_p, mirror_p)
    ko1, ko2, ko3, ko4, km = jax.random.split(key, 5)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    params = {
        "side": t(jax.random.randint(ko1, (b,), s // 4, s // 2 + 1)),
        "oy": t(jax.random.randint(ko2, (b,), 0, s - s // 4)),
        "ox": t(jax.random.randint(ko3, (b,), 0, s - s // 4)),
        "occlude": (t(jax.random.bernoulli(ko4, occlude_p, (b,)))
                    if occlude_p > 0 else None),
        "mirror": (t(jax.random.bernoulli(km, mirror_p, (b,)))
                   if mirror_p > 0 else None)}
    got_imgs, got_xy = tsp.apply_pose_augment(torch.from_numpy(imgs),
                                              torch.from_numpy(xy), params)
    np.testing.assert_array_equal(got_imgs.numpy(), np.asarray(want_imgs))
    np.testing.assert_array_equal(got_xy.numpy(), np.asarray(want_xy))


def test_samplers_draw_on_the_generator():
    """Same seed → same batch; shapes, ranges and dtypes as JAX's."""
    def batch(seed):
        g = torch.Generator().manual_seed(seed)
        return tsp.make_pose_batch(g, 3, 32, occlude_p=0.5, mirror_p=0.5)

    a, b = batch(0), batch(0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    imgs, xy, z, vis = a
    assert imgs.shape == (3, 32, 32, 3) and xy.shape == (3, 33, 2)
    assert z.shape == vis.shape == (3, 33)
    assert all(t.dtype == torch.float32 for t in a)
    assert imgs.min() >= 0 and imgs.max() <= 1
    g = torch.Generator().manual_seed(1)
    imgs, xy, z, vis = tsp.make_pose_class_batch(
        g, np.array([0, 2]), tsp.class_swing_centers(4), image_size=32)
    assert imgs.shape == (2, 32, 32, 3) and torch.isfinite(xy).all()


# -------------------------------------------------------------------- model

def _jax_net(width, size, seed=0, perturb=True):
    model = jln.PoseLandmarkNet(width=width, dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, size, size, 3)))["params"]
    if perturb:   # GroupNorm scales and biases off 1 and 0
        rng = np.random.default_rng(seed)
        params = jax.tree.map(
            lambda p: p + 0.1 * rng.standard_normal(p.shape).astype(
                np.float32), params)
    params = jax.tree.map(np.asarray, params)
    tm = tln.PoseLandmarkNet(width=width, dtype=torch.float32)
    tm.load_state_dict(from_jax_variables({"params": params}), strict=True)
    return model, params, tm


def test_soft_argmax_matches_jax():
    heat = np.random.default_rng(0).normal(size=(2, 6, 10, 5)).astype(
        np.float32) * 4
    _close(tln.soft_argmax_2d(torch.from_numpy(heat)),
           jln.soft_argmax_2d(jnp.asarray(heat)))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_group_norm_matches_flax(dtype, tol):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 6, 5, 16)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    jdt = getattr(jnp, dtype)
    gn = nn.GroupNorm(num_groups=8, dtype=jdt, param_dtype=jnp.float32)
    want = gn.apply({"params": {"scale": scale, "bias": bias}},
                    jnp.asarray(x).astype(jdt))
    m = tln.GroupNorm(16)
    m.load_state_dict({"weight": torch.from_numpy(scale),
                       "bias": torch.from_numpy(bias)})
    got = m(torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2))
    assert got.dtype == getattr(torch, dtype) and want.dtype == jdt
    _close(got.float().permute(0, 2, 3, 1), np.asarray(want, np.float32),
           tol)


@pytest.mark.parametrize("size", [32, 64])
def test_decoder_upsample_is_jax_bilinear(size):
    x = np.random.default_rng(size).normal(size=(2, size // 16, size // 16,
                                                 4)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, size // 8, size // 8, 4),
                            method="bilinear")
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                        size=(size // 8, size // 8), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1)
    _close(got, want)


@pytest.mark.parametrize("size,width", [(32, 8), (64, 16)])
def test_pose_net_forward_matches_jax(size, width):
    model, params, tm = _jax_net(width, size)
    imgs = np.random.default_rng(1).random((2, size, size, 3),
                                           dtype=np.float32)
    want = jax.jit(model.apply)({"params": params}, jnp.asarray(imgs))
    with torch.no_grad():
        got = tm(torch.from_numpy(imgs))
    assert got["heatmaps"].shape == (2, size // 4, size // 4, 33)
    for k in ("landmarks", "heatmaps", "vis_logits"):
        _close(got[k], want[k])


def test_width_must_divide_group_count():
    with pytest.raises(ValueError, match="divisible by 8"):
        tln.PoseLandmarkNet(width=12)


def _fixed_batch(size, n=4, seed=5):
    g = torch.Generator().manual_seed(seed)
    return [t.numpy() for t in tsp.make_pose_batch(g, n, size)]


def test_loss_and_gradients_match_jax():
    model, params, tm = _jax_net(8, 32, perturb=False)
    imgs, xy, z, vis = _fixed_batch(32)

    def loss_fn(p):
        return jln.landmark_loss(model.apply({"params": p},
                                             jnp.asarray(imgs)),
                                 xy, z, vis)

    (want, want_parts), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    got, parts = tln.landmark_loss(tm(torch.from_numpy(imgs)),
                                   *map(torch.from_numpy, (xy, z, vis)))
    got.backward()
    _close(got, want)
    for k in want_parts:
        _close(parts[k], want_parts[k])
    want_g = from_jax_variables({"params": jax.tree.map(np.asarray, grads)})
    got_g = {k: p.grad for k, p in tm.named_parameters()}
    assert got_g.keys() == want_g.keys()
    # the softmax over positions ignores a per-channel shift, so the heatmap
    # bias has an exact gradient of 0: both sides hold it to rounding
    top = max(float(g.abs().max()) for g in want_g.values())
    for k in want_g:
        if k == "heatmap.bias":
            assert max(float(got_g[k].abs().max()),
                       float(want_g[k].abs().max())) <= REL * top
        else:
            _close(got_g[k], want_g[k].numpy())


@pytest.mark.parametrize("steps", [1, 5, 600])
def test_schedule_matches_optax(steps):
    warm = min(50, steps // 2)
    want = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup_steps=warm,
                                              decay_steps=steps)
    got = ttrain.warmup_cosine_schedule(1e-3, warm, steps)
    for c in range(steps + 3):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-5,
                                   atol=1e-10)   # optax's f32 near 0


def _optax_adam(steps):
    return optax.adam(optax.warmup_cosine_decay_schedule(
        0.0, 1e-3, warmup_steps=min(50, steps // 2), decay_steps=steps))


def test_adam_update_matches_optax_on_the_same_gradients():
    """The optimiser alone: the same gradients in, 5 updates → the same
    parameters to four f32 ulps of the parameter plus 1e-4 of the summed
    rates: optax takes the bias corrections in f32, where 1 − 0.999 loses
    1.3e-5 to cancellation; torch takes them in f64."""
    _, params, tm = _jax_net(8, 32)
    rng = np.random.default_rng(0)
    tx = _optax_adam(5)
    opt_state = tx.init(params)
    opt, schedule = ttrain.make_optimizer(tm, 1e-3, 5)
    update = jax.jit(tx.update)
    for _ in range(5):
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
            np.float32) * 10.0 ** rng.integers(-4, 1), params)
        upd, opt_state = update(grads, opt_state)
        params = optax.apply_updates(params, upd)
        for k, g in from_jax_variables({"params": grads}).items():
            tm.get_parameter(k).grad = g
        ttrain.set_scheduled_lr(opt, schedule)
        opt.step()
    want = from_jax_variables({"params": jax.tree.map(np.asarray, params)})
    rates = sum(schedule(c) for c in range(5))
    for k, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=4.8e-7,
                                   atol=1e-4 * rates, err_msg=k)


def test_five_adam_steps_match_optax():
    """The loop: the loss trajectory to 1e-5, the parameters to 1e-6.
    Adam divides each gradient by its running RMS, so an element whose
    gradient is nonzero but within f32 rounding of 0 (below 1e-4 of its
    tensor's largest at some step) may take any step up to the rate on
    either side; those are held to the sum of the rates. A gradient that
    is exactly 0 (a dead ReLU unit) moves neither side, so its element is
    held to 1e-6. So that a broken update cannot hide in the loose set,
    heatmap.bias apart, it must stay under 5% of the parameters (2.2%
    here), and under 1e-4 of them may differ by more than 1e-6 (5 here)."""
    model, params, tm = _jax_net(8, 32, perturb=False)
    imgs, xy, z, vis = _fixed_batch(32)
    steps = 5
    tx = _optax_adam(steps)

    @jax.jit
    def step(p, o):
        def loss_fn(p):
            return jln.landmark_loss(
                model.apply({"params": p}, jnp.asarray(imgs)), xy, z, vis)[0]
        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, o = tx.update(g, o)
        return optax.apply_updates(p, upd), o, loss, g

    opt_state = tx.init(params)
    want_losses, small = [], {}
    for _ in range(steps):
        params, opt_state, loss, grads = step(params, opt_state)
        want_losses.append(float(loss))
        for k, g in from_jax_variables(
                {"params": jax.tree.map(np.asarray, grads)}).items():
            g = g.abs()
            zero_in_exact_math = k == "heatmap.bias"   # see the gradient test
            small[k] = (small.get(k, False)
                        | ((g < 1e-4 * g.max()) & (g > 0)) | zero_in_exact_math)

    opt, schedule = ttrain.make_optimizer(tm, 1e-3, steps)
    batch = [torch.from_numpy(a) for a in (imgs, xy, z, vis)]
    got_losses = [float(ttrain.train_step(tm, opt, schedule, *batch)[0])
                  for _ in range(steps)]
    np.testing.assert_allclose(got_losses, want_losses, rtol=REL)
    bound = sum(schedule(c) for c in range(steps))
    want_sd = from_jax_variables({"params": jax.tree.map(np.asarray, params)})
    n = n_loose = n_off = 0
    for k, p in tm.state_dict().items():
        d = (p - want_sd[k]).abs()
        assert float(torch.cat([d[~small[k]], d.new_zeros(1)]).max()) <= 1e-6
        assert float(torch.cat([d[small[k]], d.new_zeros(1)]).max()) <= bound
        if k != "heatmap.bias":
            n += d.numel()
            n_loose += int(small[k].sum())
            n_off += int((d > 1e-6).sum())
    assert n_loose < 0.05 * n, (n_loose, n)
    assert n_off < 1e-4 * n, (n_off, n)


# ---------------------------------------------------------------- artifacts

@pytest.mark.parametrize("path", CKPTS)
def test_codec_reads_the_checkpoints_as_flax(path):
    with open(path, "rb") as f:
        raw = f.read()
    got = flax_msgpack.unpackb(raw)
    want = fser.msgpack_restore(raw)
    got_l = jax.tree_util.tree_leaves_with_path(got)
    want_l = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (_, a), (_, b) in zip(got_l, want_l):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert flax_msgpack.packb(got) == raw      # the writer gives the same bytes


def test_codec_writes_flax_bytes():
    tree = {"meta": {"format": 1, "width": 8, "image_size": 32, "n": None,
                     "neg": -300, "big": 70000, "f": 0.5, "ok": True,
                     "s": "x" * 40, "l": list(range(20))},
            "params": {"b": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "a": np.float32(2.5), "e": np.zeros(0, np.int32)}}
    assert flax_msgpack.packb(tree) == fser.msgpack_serialize(tree)


@pytest.fixture(scope="module")
def cpu_ckpt():
    """JAX's params of the 96-px checkpoint (JAX's loader initialises the
    model eagerly: seconds, so once per module)."""
    return jln.load_pose_params(CKPTS[2])


def test_jax_checkpoint_loads_into_the_port(cpu_ckpt):
    sd = tln.load_pose_params(CKPTS[2])
    params = cpu_ckpt
    want = from_jax_variables({"params": jax.tree.map(np.asarray, params)})
    assert sd.keys() == want.keys()
    for k in sd:
        assert torch.equal(sd[k], want[k]), k


def test_port_artifact_loads_in_jax(tmp_path):
    _, params, tm = _jax_net(8, 32)
    path = str(tmp_path / "p.msgpack")
    tln.save_pose_params(path, tm, image_size=32)
    # JAX's reader without its model init (the CLI test below runs the
    # whole ``load_pose_params`` on a port-written artifact)
    back, meta = jln._restore_artifact(path)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    assert meta == {"format": 1, "width": 8, "image_size": 32}
    jax_tree = to_jax_params(tm.state_dict())
    jax.tree.map(np.testing.assert_array_equal, jax_tree, params)


def test_legacy_flat_artifact_loads(tmp_path):
    _, params, tm = _jax_net(8, 32)
    path = str(tmp_path / "legacy.msgpack")
    with open(path, "wb") as f:
        f.write(fser.msgpack_serialize(params))
    sd, model, size = tln._load_artifact(path)
    assert size == 256 and model.width == 8
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v), k


# ---------------------------------------------------------------- extractor

@pytest.mark.parametrize("src,dst", [((480, 640), (256, 256)),
                                     ((96, 96), (256, 256)),
                                     ((257, 100), (96, 96)),
                                     ((64, 64), (64, 64))])
def test_pil_bilinear_matches_pil(src, dst):
    rng = np.random.default_rng(sum(src))
    img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst[::-1],
                                                  Image.BILINEAR))
    t = torch.from_numpy(img)
    got = pil_bilinear_u8(t, dst)
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert got.shape == want.shape and got.dtype == torch.uint8
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    if src == dst:   # an equal-size resize is a copy, as PIL's
        assert got.data_ptr() != t.data_ptr()


def _frames(n, shape, seed):
    """Rendered poses as BGR uint8 frames of ``shape``."""
    g = torch.Generator().manual_seed(seed)
    imgs = tsp.make_pose_batch(g, n, 64)[0].numpy()
    out = []
    for im in imgs:
        u8 = np.rint(im * 255).astype(np.uint8)
        u8 = np.asarray(Image.fromarray(u8).resize(shape[::-1],
                                                   Image.BILINEAR))
        out.append(np.ascontiguousarray(u8[..., ::-1]))
    return out


@pytest.mark.parametrize("shape", [(120, 160), (64, 64)])
def test_neural_extractor_matches_jax(shape, cpu_ckpt):
    jparams = cpu_ckpt
    sd = tln.load_pose_params(CKPTS[2])
    jext = jln.neural_landmark_extractor(
        jparams, model=jln.PoseLandmarkNet(width=16, dtype=jnp.float32),
        image_size=96)
    text = tln.neural_landmark_extractor(
        sd, model=tln.PoseLandmarkNet(width=16, dtype=torch.float32),
        image_size=96, device="cpu")
    frames = _frames(3, shape, seed=shape[0])
    # landmarks before the detection threshold
    rgb = np.stack([np.asarray(Image.fromarray(f[..., ::-1]).resize(
        (96, 96), Image.BILINEAR), np.float32) / 255.0 for f in frames])
    want_lm = np.asarray(jln.PoseLandmarkNet(width=16, dtype=jnp.float32)
                         .apply({"params": jparams},
                                jnp.asarray(rgb))["landmarks"])
    for (lm, det), w in zip(text.process_batch(frames), want_lm):
        if abs(w[:, 3].mean() - 0.3) > 1e-3:
            assert det == bool(w[:, 3].mean() > 0.3)
        if det:
            _close(lm, w)
    for (lm, det), (jlm, jdet) in zip(text.process_batch(frames),
                                      jext.process_batch(frames)):
        assert det == jdet
        _close(lm, jlm)
    lm, det = text.process_array(frames[0])
    _close(lm, jext.process_array(frames[0])[0])


def test_neural_extractor_path_protocol(tmp_path):
    sd = tln.load_pose_params(CKPTS[2])
    text = tln.load_pose_extractor(CKPTS[2], device="cpu",
                                   dtype=torch.float32)
    frame = _frames(1, (80, 80), seed=3)[0]
    path = str(tmp_path / "f.png")
    Image.fromarray(frame[..., ::-1]).save(path)
    lm, det = text(path)
    want = tln.neural_landmark_extractor(
        sd, model=tln.PoseLandmarkNet(width=16, dtype=torch.float32),
        image_size=96, device="cpu").process_array(frame)
    assert det == want[1] and np.array_equal(lm, want[0])
    lm, det = text(str(tmp_path / "missing.png"))
    assert not det and not lm.any()


# ---------------------------------------------------------------------- CLI

def test_pose_train_cli_writes_a_jax_artifact(tmp_path):
    out = str(tmp_path / "run")
    rc = port_main(["pose-train", "--device", "cpu", "--steps", "3",
                    "--batch", "2", "--image-size", "32", "--width", "8",
                    "--out", out])
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    assert rc == (0 if summary["pck10"] > 0 else 1)
    assert summary["backend"] == "cpu" and summary["steps"] == 3
    with open(os.path.join(out, "train.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1]
    params = jln.load_pose_params(summary["checkpoint"])
    sd = tln.load_pose_params(summary["checkpoint"])
    want = from_jax_variables({"params": jax.tree.map(np.asarray, params)})
    for k in sd:
        assert torch.equal(sd[k], want[k]), k
    with open(summary["checkpoint"], "rb") as f:
        meta = fser.msgpack_restore(f.read())["meta"]
    assert meta == {"format": 1, "width": 8, "image_size": 32}


def test_pose_train_default_out_is_not_a_jax_run():
    """The port's default run directory is its own: ``runs/pose_landmark*``
    hold the JAX package's checkpoints, which a run would overwrite."""
    from surya_tpu_torch.models.pose.train import POSE_OUT

    jax_runs = {os.path.dirname(os.path.relpath(c, ROOT)) for c in CKPTS}
    assert os.path.normpath(POSE_OUT) not in jax_runs
    sig = inspect.signature(ttrain.train_pose_landmark)
    assert sig.parameters["out_dir"].default == POSE_OUT
