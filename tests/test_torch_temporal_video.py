"""The r3d_18 families of the port against the JAX package at f32 on the
CPU: the r3d_18 trunk, ``ResNet3DVideo`` and ``HybridQuadtree3DCNN`` (both
modes) through ``from_jax_variables`` with ``strict=True``: eval logits,
train-mode logits at dropout 0, the BN running statistics a train-mode
forward leaves under the partial-unfreeze rule (only layer4's move, as
JAX's do; stem..layer3 stay put), and parameter gradients (relative L2
1e-4 outside the trunk, 5e-2 inside it: the tolerances of
``tests/test_torch_temporal.py``); and one ``hybrid-quadtree-3d`` train
step against JAX's (as ``tests/test_torch_temporal_train.py`` holds
``quadtree-3d``). 32 px, B = 2, T = 4 or 5.

Also: the trunk's train/eval modes by stage, the channels_last_3d layout
of its weights, the unknown hybrid mode, and dropout drawn only from the
explicit generator.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from surya_tpu.core import config as jcfg
from surya_tpu.core.config import ModelConfig as JaxModelConfig
from surya_tpu.models import get_model as jax_get_model
from surya_tpu.models.backbones.resnet3d import r3d_18 as jax_r3d_18
from surya_tpu.train import steps as jsteps
from surya_tpu_torch.core.config import ModelConfig, get_preset
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.backbones import trunk_channels_last
from surya_tpu_torch.models.backbones.resnet import BatchNorm
from surya_tpu_torch.models.backbones.resnet3d import r3d_18
from surya_tpu_torch.models.from_jax import from_jax_variables
from surya_tpu_torch.models.temporal.resnet3d_video import (
    HybridQuadtree3DCNN,
)
from surya_tpu_torch.train import steps as tsteps
from test_torch_resnet import numpy_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401

HEAD_GRAD_TOL, TRUNK_GRAD_TOL = 1e-4, 5e-2
to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731


def _rel(got, want):
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12))


def test_r3d_18_trunk_matches_jax():
    """Every stage map of the trunk (eval mode) and its stage shapes:
    T = 5 → 5, 5, 3, 2, 1 at 32 px."""
    rng = np.random.default_rng(0)
    x = rng.random((2, 5, 32, 32, 3)).astype(np.float32)
    stages = ("stem", "layer1", "layer2", "layer3", "layer4")
    jm = jax_r3d_18(dtype=jnp.float32)
    variables = numpy_variables(jm, jnp.asarray(x), seed=1)
    want = jm.apply(variables, jnp.asarray(x), capture=stages)
    tm = r3d_18(torch.float32)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), capture=stages)
    for s in stages:
        g = got[s].permute(0, 2, 3, 4, 1).numpy()   # NCDHW view → NDHWC
        assert g.shape == want[s].shape, s
        np.testing.assert_allclose(g, np.asarray(want[s]), rtol=1e-4,
                                   atol=1e-4, err_msg=s)
    assert [got[s].shape[2] for s in stages] == [5, 5, 3, 2, 1]


# (label, model config kwargs, T); image 32 px, B = 2, 5 classes
CASES = [("resnet3d_video", dict(name="resnet3d_video",
                                 freeze_backbone=True), 5),
         ("hybrid_fusion", dict(name="hybrid_quadtree_3d",
                                freeze_backbone=True), 5),
         ("hybrid_image_only_unfrozen",
          dict(name="hybrid_quadtree_3d", mode="image_only"), 4)]


@pytest.mark.parametrize("label,kw,t", CASES, ids=[c[0] for c in CASES])
def test_model_matches_jax(label, kw, t):
    rng = np.random.default_rng(len(label))
    images = rng.random((2, t, 32, 32, 3)).astype(np.float32)
    feats = rng.normal(size=(2, t, 47)).astype(np.float32)
    w = rng.normal(size=(2, 5)).astype(np.float32)
    cfg = dict(kw, num_classes=5, compute_dtype="float32", dropout=0.0)
    jm = jax_get_model(JaxModelConfig(**cfg))
    x, f = jnp.asarray(images), jnp.asarray(feats)
    variables = numpy_variables(jm, x, f, seed=3)
    stats = variables["batch_stats"]
    want_eval = jax.jit(lambda v: jm.apply(v, x, f, train=False))(variables)

    def loss(params):
        logits, mut = jm.apply({"params": params, "batch_stats": stats}, x,
                               f, train=True, mutable=["batch_stats"])
        return jnp.sum(logits * w), (logits, mut["batch_stats"])

    (_, (want_train, want_stats)), want_grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])

    tm = get_model(ModelConfig(**cfg))
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    before = {k: v.clone() for k, v in tm.state_dict().items()
              if "running_" in k}
    xt, ft = torch.from_numpy(images), torch.from_numpy(feats)
    with torch.no_grad():
        got_eval = tm.eval()(xt, ft)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval),
                               rtol=1e-4, atol=1e-4)
    logits = tm.train()(xt, ft)
    (logits * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_train), rtol=1e-4, atol=1e-4)

    moved = from_jax_variables({"batch_stats": to_np(want_stats)})
    state = tm.state_dict()
    assert set(moved) == set(before)
    for name, want in moved.items():
        np.testing.assert_allclose(state[name].numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        # partial unfreeze: only layer4's statistics move
        still = kw.get("freeze_backbone") and "layer4" not in name
        assert torch.equal(state[name], before[name]) == bool(still), name
    grads = from_jax_variables({"params": to_np(want_grads)})
    params = dict(tm.named_parameters())
    assert set(grads) == set(params)
    errs = {n: _rel(params[n].grad.numpy(), g.numpy())
            for n, g in grads.items()}
    heads = {n: e for n, e in errs.items() if not n.startswith("trunk.")}
    assert max(heads.values()) < HEAD_GRAD_TOL, sorted(
        heads.items(), key=lambda kv: kv[1])[-3:]
    assert max(errs.values()) < TRUNK_GRAD_TOL, sorted(
        errs.items(), key=lambda kv: kv[1])[-3:]


def test_frozen_trunk_trains_layer4_bn_only():
    """``train()`` on a frozen trunk: layer4 in train mode, stem..layer3 in
    eval mode; ``eval()`` leaves no stage in train mode; an unfrozen trunk
    trains every stage."""
    model = get_model(ModelConfig(name="resnet3d_video",
                                  freeze_backbone=True))
    model.train()
    modes = {n.split("_")[0]: m.training
             for n, m in model.trunk.named_children()}
    assert modes == {"stem": False, "layer1": False, "layer2": False,
                     "layer3": False, "layer4": True}
    assert model.classifier.training
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 20 and sum(m.training for m in bns) == 5   # layer4
    model.eval()
    assert not any(m.training for m in model.modules())
    free = get_model(ModelConfig(name="hybrid_quadtree_3d")).train()
    assert all(m.training for m in free.modules())


def test_trunk_weights_are_channels_last_3d():
    model = trunk_channels_last(get_model(ModelConfig(
        name="resnet3d_video", compute_dtype="float32")))
    w = model.trunk.layer2_block0.conv1.weight
    assert w.is_contiguous(memory_format=torch.channels_last_3d)


def test_unknown_hybrid_mode_raises():
    with pytest.raises(ValueError, match="mode must be one of"):
        HybridQuadtree3DCNN(mode="numerical_only")


@pytest.mark.parametrize("name", ["resnet3d_video", "hybrid_quadtree_3d"])
def test_dropout_draws_from_the_explicit_generator(name):
    model = get_model(ModelConfig(name=name, num_classes=3,
                                  freeze_backbone=True,
                                  compute_dtype="float32")).train()
    x, f = torch.rand(2, 4, 32, 32, 3), torch.randn(2, 4, 47)
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        model(x, f)
    before = torch.get_rng_state()
    with torch.no_grad():
        a = model(x, f, torch.Generator().manual_seed(5))
        b = model(x, f, torch.Generator().manual_seed(5))
        c = model(x, f, torch.Generator().manual_seed(6))
    assert torch.equal(before, torch.get_rng_state())
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_one_hybrid_quadtree_3d_train_step_matches_jax():
    """The preset's optimizer (AdamW, weight decay 5e-4, clip 1.0) and its
    partial unfreeze (layer4 and the head train; stem..layer3 stay), the
    same initial weights and batch, dropout 0; compared as
    ``tests/test_torch_temporal_train.py`` compares: loss 1e-5, BN
    statistics (rtol 1e-4, atol 1e-5), every parameter within two AdamW
    steps of JAX's and its update to 5e-2 relative L2."""
    b, t, size, classes = 4, 5, 32, 5
    overrides = {"model.num_classes": str(classes),
                 "model.compute_dtype": "float32", "model.dropout": "0.0",
                 "data.batch_size": str(b)}
    port = get_preset("hybrid-quadtree-3d").override(overrides)
    ref = jcfg.get_preset("hybrid-quadtree-3d").override(overrides)
    assert port.model.freeze_backbone and port.train.grad_clip == 1.0
    rng = np.random.default_rng(7)
    batch = (rng.normal(size=(b, t, size, size, 3), scale=0.5).astype(
                 np.float32),
             rng.normal(size=(b, t, 47)).astype(np.float32),
             rng.integers(0, classes, size=(b,)).astype(np.int32))

    jm = jax_get_model(ref.model)
    jstate, jtx = jsteps.create_train_state(jm, ref, jax.random.key(0), batch)
    tm = get_model(port.model)
    tm.load_state_dict(from_jax_variables(
        {"params": to_np(jstate.params),
         "batch_stats": to_np(jstate.batch_stats)}), strict=True)
    tstate, ttx = tsteps.create_train_state(tm, port, device="cpu")
    start = {k: v.detach().clone() for k, v in tm.named_parameters()}

    jstate, jmet = jsteps.make_train_step(jm, jtx, ref)(
        jstate, batch, jax.random.key(1))
    tstate, tmet = tsteps.make_train_step(tm, ttx, port)(tstate, batch)

    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    assert float(tmet["accuracy"]) == float(jmet["accuracy"])
    state = tm.state_dict()
    stats = from_jax_variables({"batch_stats": to_np(jstate.batch_stats)})
    assert len(stats) == 2 * 20   # stem + 19 BNs in the blocks
    for key, w in stats.items():
        np.testing.assert_allclose(state[key].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    lr = port.train.lr
    params = from_jax_variables({"params": to_np(jstate.params)})
    assert set(params) == set(start)
    for key, w in params.items():
        got = state[key]
        if key.startswith("trunk.") and "layer4" not in key:
            assert torch.equal(got, start[key]), key       # frozen
            assert torch.equal(w, start[key]), key
            continue
        assert (got - w).abs().max() <= 2.01 * lr, key
        du, dw = got - start[key], w - start[key]
        assert (du - dw).norm() / dw.norm() < 5e-2, key
