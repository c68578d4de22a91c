"""The temporal families of the port against the JAX package at f32 on the
CPU: ``StackedLSTM`` (outputs and gradients), and ``CnnLstm``, ``Ji3DCNN``
and ``Quadtree3DCNN`` (both modes) through ``from_jax_variables`` with
``strict=True``: eval logits, train-mode logits at dropout 0, the BN
running statistics a train-mode forward leaves, and parameter gradients
(relative L2 1e-4 outside the trunk, 5e-2 inside it: the tolerances of
``tests/test_torch_quadtree_train.py``). 32 px, B = 2, T = 4 or 5.

Also: ``conv3d_as_2d`` on and off compute the same function on the same
parameters; too-short clips raise; the registry's widths and dropouts;
``CnnLstm``'s frozen trunk keeps its BN in inference mode through a train
step (its buffers unchanged), while an unfrozen one moves them; dropout
draws only from the explicit generator.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from surya_tpu.core.config import ModelConfig as JaxModelConfig
from surya_tpu.models import get_model as jax_get_model
from surya_tpu.models.temporal.recurrent import StackedLSTM as JaxLSTM
from surya_tpu_torch.core.config import ModelConfig, get_preset
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.from_jax import from_jax_variables
from surya_tpu_torch.models.temporal.recurrent import StackedLSTM
from test_torch_resnet import numpy_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401

HEAD_GRAD_TOL, TRUNK_GRAD_TOL = 1e-4, 5e-2
# A conv bias right before a train-mode BN shifts a channel that the BN
# subtracts again: its exact gradient is 0, so both frameworks give rounding
# noise. Held instead to a norm of 1e-4 times its conv weight's gradient.
ZERO_GRAD_RATIO = 1e-4
to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731


def _rel(got, want):
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12))


@pytest.mark.parametrize("layers,d,hidden", [(1, 5, 4), (2, 47, 12)])
def test_stacked_lstm_outputs_and_gradients_match_jax(layers, d, hidden):
    rng = np.random.default_rng(layers)
    x = rng.normal(size=(3, 4, d)).astype(np.float32)
    w = rng.normal(size=(3, 4, hidden)).astype(np.float32)
    jm = JaxLSTM(hidden=hidden, num_layers=layers, dropout=0.5,
                 dtype=jnp.float32)
    variables = numpy_variables(jm, jnp.asarray(x), seed=layers)

    def loss(params, xs):
        out = jm.apply({"params": params}, xs)
        return jnp.sum(out * w), out

    (_, want), (g_params, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                           jnp.asarray(x))
    tm = StackedLSTM(d, hidden, layers, dropout=0.5, dtype=torch.float32)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm.eval()(xt)
    (out * torch.from_numpy(w)).sum().backward()
    assert out.dtype == torch.float32 and out.shape == (3, 4, hidden)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert _rel(xt.grad.numpy(), np.asarray(g_x)) < 1e-5
    grads = from_jax_variables({"params": to_np(g_params)})
    assert set(grads) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), grads[name].numpy()) < 1e-5, name


def test_lstm_carry_is_f32_under_bf16():
    """flax keeps the LSTM carry in f32 when it computes in bf16, so the
    outputs are f32; the gates see bf16 products."""
    tm = StackedLSTM(6, 4, 2, dtype=torch.bfloat16)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    out = tm(torch.randn(2, 3, 6, generator=torch.Generator().manual_seed(1)))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


# (label, model config kwargs, T); image 32 px, B = 2, 5 classes
CASES = [("cnn_lstm_frozen", dict(name="cnn_lstm", freeze_backbone=True), 4),
         ("cnn_lstm", dict(name="cnn_lstm"), 3),
         ("ji_3dcnn", dict(name="ji_3dcnn"), 4),
         ("quadtree_3d", dict(name="quadtree_3d"), 5),
         ("quadtree_3d_image_only",
          dict(name="quadtree_3d", mode="image_only"), 4)]


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
    stats = variables.get("batch_stats", {})
    want_eval = jax.jit(lambda v: jm.apply(v, x, f, train=False))(variables)

    def loss(params):
        logits, mut = jm.apply({"params": params, "batch_stats": stats}, x,
                               f, train=True, mutable=["batch_stats"])
        return jnp.sum(logits * w), (logits, mut["batch_stats"])

    (_, (want_train, want_stats)), want_grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])

    tm = get_model(ModelConfig(**cfg))
    tm.load_state_dict(from_jax_variables(variables), strict=True)
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
    assert set(moved) == {k for k in state if "running_" in k}
    for name, want in moved.items():
        np.testing.assert_allclose(state[name].numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    grads = from_jax_variables({"params": to_np(want_grads)})
    params = dict(tm.named_parameters())
    assert set(grads) == set(params)
    zero = {n for n in grads if n.endswith("_conv.bias")}
    for n in zero:
        scale = np.linalg.norm(grads[n.replace("bias", "weight")].numpy())
        for g in (params[n].grad.numpy(), grads[n].numpy()):
            assert np.linalg.norm(g) <= ZERO_GRAD_RATIO * scale, n
    errs = {n: _rel(params[n].grad.numpy(), g.numpy())
            for n, g in grads.items() if n not in zero}
    heads = {n: e for n, e in errs.items() if not n.startswith("trunk.")}
    assert max(heads.values()) < HEAD_GRAD_TOL, sorted(
        heads.items(), key=lambda kv: kv[1])[-3:]
    assert max(errs.values()) < TRUNK_GRAD_TOL, sorted(
        errs.items(), key=lambda kv: kv[1])[-3:]


@pytest.mark.parametrize("name", ["ji_3dcnn", "quadtree_3d"])
def test_conv3d_as_2d_matches_conv3d(name):
    """The port's counterpart of ``tests/test_models.py::
    test_conv3d_as_2d_matches_conv3d``: the same state_dict, the same
    logits (eval) and BN statistics (a train-mode forward)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 5, 32, 32, 3)).astype(
        np.float32))
    f = torch.from_numpy(rng.normal(size=(2, 5, 47)).astype(np.float32))
    cfg = ModelConfig(name=name, num_classes=4, compute_dtype="float32",
                      dropout=0.0)
    base = get_model(cfg, seed=2)
    as2d = get_model(dataclasses.replace(cfg, conv3d_as_2d=True))
    as2d.load_state_dict(base.state_dict(), strict=True)
    assert base.block1_conv.as_2d is False and as2d.block1_conv.as_2d
    with torch.no_grad():
        np.testing.assert_allclose(as2d.eval()(x, f).numpy(),
                                   base.eval()(x, f).numpy(),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(as2d.train()(x, f).numpy(),
                                   base.train()(x, f).numpy(),
                                   rtol=2e-5, atol=2e-5)
    for key, value in base.state_dict().items():
        np.testing.assert_allclose(as2d.state_dict()[key].numpy(),
                                   value.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("name,least", [("ji_3dcnn", 2), ("quadtree_3d", 4)])
def test_short_clips_raise(name, least):
    model = get_model(ModelConfig(name=name, compute_dtype="float32")).eval()
    t = least - 1
    x, f = torch.zeros(1, t, 32, 32, 3), torch.zeros(1, t, 47)
    with pytest.raises(ValueError, match=f"seq_len >= {least}"):
        model(x, f)
    jm = jax_get_model(JaxModelConfig(name=name, compute_dtype="float32"))
    with pytest.raises(ValueError, match=f"seq_len >= {least}"):
        jm.init(jax.random.key(0), jnp.zeros(x.shape), jnp.zeros(f.shape))


# (preset, mode) → the head's (D, H) and dropout at the published widths;
# for FACT, which has no fused head, a fusion layer's FFN (d, 4d) and its
# dropout
WIDTHS = {("cnn-lstm", "fusion"): (256, 128, 0.5),
          ("ji-3dcnn", "fusion"): (192, 128, 0.5),
          ("quadtree-3d", "fusion"): (1536, 768, 0.6),
          ("quadtree-3d", "image_only"): (1024, 512, 0.6),
          ("resnet3d-video", "fusion"): (512, 256, 0.5),
          ("hybrid-quadtree-3d", "fusion"): (768, 384, 0.6),
          ("hybrid-quadtree-3d", "image_only"): (512, 256, 0.6),
          ("fact", "fusion"): (768, 3072, 0.1),
          ("fact-bs16", "fusion"): (768, 3072, 0.1)}


@pytest.mark.parametrize("key", list(WIDTHS))
def test_registry_builds_the_published_widths(key):
    preset, mode = key
    cfg = get_preset(preset).override({"model.mode": mode})
    model = get_model(cfg.model)
    d, h, rate = WIDTHS[key]
    fact = cfg.model.name == "fact"
    layer = model.fusion0 if fact else model.classifier
    assert tuple((layer.ff1 if fact else layer.fc1).weight.shape) == (h, d)
    assert layer.dropout == rate
    assert fact or d % 8 == 0   # the head kernel's alignment
    if cfg.model.name in ("quadtree_3d", "hybrid_quadtree_3d") and (
            mode == "fusion"):
        lstm = model.numerical_lstm
        assert lstm.num_layers == 2 and lstm.dropout == 0.6
        assert lstm.OptimizedLSTMCell_0.weight_hh.shape == (4 * 188, 188)
    if cfg.model.name in ("resnet3d_video", "hybrid_quadtree_3d"):
        assert cfg.model.freeze_backbone   # layer4 and the head train
        assert model.trunk.train_stages == {"layer4"}
    if fact:
        assert cfg.model.freeze_backbone and model.fusion0.attn.dropout == 0.1
        assert cfg.data.batch_size == (16 if preset == "fact-bs16" else 32)
        # the dropout override at a small width: 96 divides by 12 and 8
        cfg = cfg.override({"model.fusion_dim": "96"})
    dropped = get_model(dataclasses.replace(cfg.model, dropout=0.2),
                        image_size=32 if fact else 224)
    dropped = dropped.fusion0 if fact else dropped.classifier
    assert dropped.dropout == 0.2


def _cnn_lstm_step(freeze):
    from surya_tpu_torch.train import create_train_state, make_train_step

    cfg = get_preset("cnn-lstm").override({
        "model.num_classes": "3", "model.compute_dtype": "float32",
        "model.freeze_backbone": str(freeze).lower(),
        "data.batch_size": "2"})
    model = get_model(cfg.model, seed=1)
    state, tx = create_train_state(model, cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = (rng.random((2, 4, 32, 32, 3)).astype(np.float32),
             rng.normal(size=(2, 4, 47)).astype(np.float32),
             np.array([0, 2], np.int32))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, metrics = make_train_step(model, tx, cfg)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    after = model.state_dict()
    return before, after


def test_frozen_cnn_lstm_trunk_keeps_bn_in_inference_mode():
    """A train step of ``cnn-lstm`` (frozen trunk): the trunk's parameters
    and its BN running statistics are unchanged, the LSTM and the head
    train; unfrozen, the trunk's statistics move (train-mode BN)."""
    before, after = _cnn_lstm_step(freeze=True)
    trunk = [k for k in before if k.startswith("trunk.")]
    assert any("running_mean" in k for k in trunk)
    for k in trunk:
        assert torch.equal(before[k], after[k]), k
    for k in ("lstm.OptimizedLSTMCell_0.weight_ih", "classifier.fc1.weight",
              "num_fc1.weight"):
        assert not torch.equal(before[k], after[k]), k
    before, after = _cnn_lstm_step(freeze=False)
    assert not torch.equal(before["trunk.resnet.bn1.running_mean"],
                           after["trunk.resnet.bn1.running_mean"])


@pytest.mark.parametrize("name", ["cnn_lstm", "ji_3dcnn", "quadtree_3d"])
def test_dropout_draws_from_the_explicit_generator(name):
    model = get_model(ModelConfig(name=name, num_classes=3,
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
