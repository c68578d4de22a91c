"""One train step of the trainable-trunk families against JAX's
``make_train_step`` at f32 on the CPU: ``standard_multimodal`` in fusion
mode (the ``comparative-*`` presets) with MobileNetV2, VGG16 and
ResNet-18 at 64 px, and ``resnet3d_video`` with ``freeze_backbone=false``
(the ``resnet3d-video-trainable`` replay row: the whole r3d_18 trunk on
train-mode BN) at 32 px, T = 5. B = 4, each preset's optimizer (the
comparative AdamW, or the 3-D preset's AdamW with weight decay 5e-4 and
clip 1.0), the same initial weights through ``from_jax_variables`` and
the same numpy batch.

Dropout is 0: ``StandardMultimodalCNN`` fixes its head's and numerical
MLP's rates at 0.5 in both packages, so the JAX modules are built here
with dropout 0 by patching their constructors and the port's modules get
their ``dropout`` attribute set to 0; ``resnet3d_video`` takes
``model.dropout``.

Compared, with the tolerances of ``tests/test_torch_train_steps.py``: the
loss (1e-5), the BN running statistics (rtol 1e-4, atol 1e-5), every
parameter within two AdamW steps of JAX's (the first step moves each by
lr·g/(|g| + eps), so a gradient within float noise of 0 may step the
other way) and, outside the trunk, each parameter's update to 5e-2
relative L2. The update cannot hold the trunk's backward (one AdamW step
moves every weight by about ±lr, whatever its gradient), so the gradients
the two optimizers were handed are compared too, leaf by leaf, with the
tolerances of ``tests/test_torch_temporal_video.py``: relative L2 1e-4
outside the trunk, 5e-2 inside it. JAX's are read off its step as
``tx.update`` receives them and clipped here by optax's rule; the port's
as its optimizer's ``step`` finds them, after its own clip. A leaf whose
exact gradient is 0 (:data:`ZERO_GRAD`) has no relative error to speak
of; there both sides must read float noise, below 1e-5 of the global
gradient norm.
"""

import functools
import re

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from surya_tpu.core import config as jcfg
from surya_tpu.models import get_model as jax_get_model
from surya_tpu.models.backbones.mobilenet import _relu6 as jax_relu6
from surya_tpu.models.spatial import standard as jax_standard
from surya_tpu.train import steps as jsteps
from surya_tpu_torch.core.config import get_preset
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.backbones.mobilenet import relu6
from surya_tpu_torch.models.backbones.resnet import BatchNorm
from surya_tpu_torch.models.from_jax import from_jax_variables
from surya_tpu_torch.train import steps as tsteps
from torch_port_fixtures import one_torch_thread  # noqa: F401

B, CLASSES = 4, 5
HEAD_GRAD_TOL, TRUNK_GRAD_TOL = 1e-4, 5e-2
to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731

# preset, overrides, image batch shape (without B)
CASES = {
    "mobilenet_v2": ("comparative-mobilenet-v2", {}, (64, 64, 3)),
    "vgg16": ("comparative-vgg16", {}, (64, 64, 3)),
    "resnet18": ("comparative-resnet18", {}, (64, 64, 3)),
    "resnet3d_video": ("resnet3d-video", {"model.freeze_backbone": "false",
                                          "model.dropout": "0.0"},
                       (5, 32, 32, 3)),
}


# leaves whose exact gradient is 0. MobileNetV2's projection is linear (no
# ReLU6), so its BN's bias reaches the loss only through 1x1 convs (and
# residual adds) into train-mode BNs, which take out any per-channel
# constant.
ZERO_GRAD = {"mobilenet_v2": r"trunk\.block\d+\.project_bn\.bias"}


def _rel(got, want):
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12))


def _recording(tx, seen):
    """``tx`` whose ``update`` first hands its gradients to ``seen``."""
    def update(grads, state, params=None):
        jax.debug.callback(lambda g: seen.append(to_np(g)), grads)
        return tx.update(grads, state, params)
    return optax.GradientTransformation(tx.init, update)


def _no_dropout(cls):
    return lambda **kw: cls(**{**kw, "dropout": 0.0})


def _jax_state(model, cfg, batch):
    """``jsteps.create_train_state`` with the init jitted (eager flax
    init of a trunk takes tens of seconds)."""
    images, feats, _ = batch
    variables = jax.jit(functools.partial(model.init, train=False))(
        {"params": jax.random.key(0)}, images, feats)
    tx = jsteps.make_optimizer(cfg, variables["params"])
    return jsteps.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(variables["params"])), tx


@pytest.mark.parametrize("case", list(CASES))
def test_one_train_step_matches_jax(case, monkeypatch):
    preset, extra, shape = CASES[case]
    monkeypatch.setattr(jax_standard, "FusionClassifier",
                        _no_dropout(jax_standard.FusionClassifier))
    monkeypatch.setattr(jax_standard, "NumericalMLP",
                        _no_dropout(jax_standard.NumericalMLP))
    overrides = {"model.num_classes": str(CLASSES),
                 "model.compute_dtype": "float32",
                 "data.batch_size": str(B),
                 "data.image_size": str(shape[-2]), **extra}
    port = get_preset(preset).override(overrides)
    ref = jcfg.get_preset(preset).override(overrides)
    assert port.to_dict() == ref.to_dict()
    assert not port.model.freeze_backbone
    if case == "resnet3d_video":
        assert port.train.weight_decay == 5e-4
        assert port.train.grad_clip == 1.0
    rng = np.random.default_rng(11)
    feats = (B, shape[0], 47) if len(shape) == 4 else (B, 47)
    batch = (rng.normal(size=(B, *shape), scale=0.5).astype(np.float32),
             rng.normal(size=feats).astype(np.float32),
             rng.integers(0, CLASSES, size=(B,)).astype(np.int32))

    jm = jax_get_model(ref.model)
    jstate, jtx = _jax_state(jm, ref, batch)
    tm = get_model(port.model, image_size=shape[-2])
    tm.load_state_dict(from_jax_variables(
        {"params": to_np(jstate.params),
         "batch_stats": to_np(jstate.batch_stats)}), strict=True)
    if case != "resnet3d_video":
        tm.classifier.dropout = tm.numerical_mlp.dropout = 0.0
    tstate, ttx = tsteps.create_train_state(tm, port, device="cpu")
    start = {k: v.detach().clone() for k, v in tm.named_parameters()}
    jseen, tseen = [], {}
    step = ttx.step

    def recording_step(*args, **kw):
        tseen.update({n: p.grad.detach().clone()
                      for n, p in tm.named_parameters()})
        return step(*args, **kw)

    monkeypatch.setattr(ttx, "step", recording_step)

    jstate, jmet = jsteps.make_train_step(jm, _recording(jtx, jseen), ref)(
        jstate, batch, jax.random.key(1))
    tstate, tmet = tsteps.make_train_step(tm, ttx, port)(tstate, batch)

    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    assert float(tmet["accuracy"]) == float(jmet["accuracy"])
    state = tm.state_dict()
    stats = from_jax_variables({"batch_stats": to_np(jstate.batch_stats)})
    assert len(stats) == 2 * sum(isinstance(m, BatchNorm)
                                 for m in tm.modules())
    for key, w in stats.items():
        np.testing.assert_allclose(state[key].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    (raw,) = jseen
    clip = port.train.grad_clip
    if clip > 0:   # optax.clip_by_global_norm
        norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                           for g in jax.tree.leaves(raw)))
        raw = jax.tree.map(lambda g: g * (clip / max(norm, clip)), raw)
    grads = from_jax_variables({"params": raw})
    assert set(grads) == set(tseen)
    norm = np.sqrt(sum(float(g.norm()) ** 2 for g in grads.values()))
    zero = {n for n in grads if re.fullmatch(ZERO_GRAD.get(case, "^$"), n)}
    assert len(zero) == (17 if case == "mobilenet_v2" else 0)
    noise = {n: max(float(grads[n].norm()), float(tseen[n].norm())) / norm
             for n in zero}
    assert all(v < 1e-5 for v in noise.values()), noise
    errs = {n: _rel(tseen[n].numpy(), g.numpy()) for n, g in grads.items()
            if n not in zero}
    heads = {n: e for n, e in errs.items() if not n.startswith("trunk.")}
    assert heads and len(heads) < len(errs)
    assert max(heads.values()) < HEAD_GRAD_TOL, sorted(
        heads.items(), key=lambda kv: kv[1])[-3:]
    assert max(errs.values()) < TRUNK_GRAD_TOL, sorted(
        errs.items(), key=lambda kv: kv[1])[-3:]
    print({"case": case, "head": max(heads.values()),
           "trunk": max(errs.values()),
           "zero": max(noise.values(), default=0.0)})
    lr = port.train.lr
    params = from_jax_variables({"params": to_np(jstate.params)})
    assert set(params) == set(start)
    for key, w in params.items():
        got = state[key]
        assert (got - w).abs().max() <= 2.01 * lr, key
        if not key.startswith("trunk."):
            du, dw = got - start[key], w - start[key]
            assert (du - dw).norm() / dw.norm() < 5e-2, key


def test_relu6_backward_matches_jax():
    """MobileNetV2's ReLU6 (``hardtanh``) against JAX's ``minimum(relu(x),
    6)``, gradient included, over [-3, 9]: the step's batch leaves every
    pre-activation below 6, so the step test cannot see the upper clamp's
    backward. At exactly 6 the two rules differ (JAX's ``minimum`` splits
    the tie's gradient, 0.5; ``hardtanh`` gives 0); a pre-activation
    lands there with probability about 0, and the point is left out."""
    x = np.random.default_rng(3).uniform(-3, 9, 4096).astype(np.float32)
    x = x[x != 6]
    assert (x > 6).sum() > 1000
    want, vjp = jax.vjp(jax_relu6, jnp.asarray(x))
    w = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    (want_grad,) = vjp(jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    got = relu6(xt)
    got.backward(torch.from_numpy(w))
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    assert np.array_equal(xt.grad.numpy(), np.asarray(want_grad))
