"""The ViT backbone, ``PostLNEncoderLayer`` and ``FactModel`` of the port
against the JAX package at f32 on the CPU, through ``from_jax_variables``
with ``strict=True``: outputs, train-mode outputs at dropout 0 and
parameter gradients (relative L2 1e-4), and one ``fact`` train step
against JAX's (the ViT frozen, as the preset freezes it). Small widths:
32 px, B = 2, T = 4, ``embed_dim`` 64, ``vit_depth`` 2, ``vit_heads`` 4,
``num_heads`` 4, ``num_layers`` 2.

Also the semantics: the attention dropout mask is one (q, k) mask shared
over batch and heads, drawn only from the explicit generator; a clip whose
T is not ``seq_len`` raises in both packages; the frozen ViT runs in eval
mode and the train step leaves it untouched, with no gradient; the
parallel variants are wired as JAX wires them (FACT over a ``cp_mesh`` of
'seq' 2 runs in ``tests/test_torch_ring_attention.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from surya_tpu.core import config as jcfg
from surya_tpu.models.backbones.vit import ViT as JaxViT
from surya_tpu.models.temporal.fact import FactModel as JaxFact
from surya_tpu.models.temporal.fact import (
    PostLNEncoderLayer as JaxPostLN,
)
from surya_tpu.train import steps as jsteps
from surya_tpu_torch.core.config import ModelConfig, get_preset
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.backbones.vit import (
    MultiHeadDotProductAttention,
    ViT,
)
from surya_tpu_torch.models.from_jax import from_jax_variables
from surya_tpu_torch.models.temporal.fact import (
    FactModel,
    PostLNEncoderLayer,
    fact_apply_pipelined,
)
from surya_tpu_torch.train import steps as tsteps
from test_torch_resnet import numpy_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401

GRAD_TOL = 1e-4
# A key projection's bias adds q·b to every logit of a query row, which the
# softmax ignores: its exact gradient is 0, so both frameworks give
# rounding noise. Held instead to a norm of 1e-4 times its kernel's
# gradient (as tests/test_torch_temporal.py holds a bias before a BN).
ZERO_GRAD = "attn.key.bias"
ZERO_GRAD_RATIO = 1e-4
SMALL = dict(embed_dim=64, vit_depth=2, vit_heads=4, num_heads=4,
             num_layers=2)
to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731


def _rel(got, want):
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12))


def _check_grads(tm, jax_grads):
    grads = from_jax_variables({"params": to_np(jax_grads)})
    params = dict(tm.named_parameters())
    assert set(grads) == set(params)
    zero = {n for n in grads if n.endswith(ZERO_GRAD)}
    assert zero
    for n in zero:
        scale = np.linalg.norm(grads[n.replace("bias", "weight")].numpy())
        for g in (params[n].grad.numpy(), grads[n].numpy()):
            assert np.linalg.norm(g) <= ZERO_GRAD_RATIO * scale, n
    errs = {n: _rel(params[n].grad.numpy(), g.numpy())
            for n, g in grads.items() if n not in zero}
    assert max(errs.values()) < GRAD_TOL, sorted(
        errs.items(), key=lambda kv: kv[1])[-3:]


def _loss_and_grads(jm, variables, w, *args, **kw):
    def loss(params):
        out = jm.apply({"params": params}, *args, **kw)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    return np.asarray(out), grads


def test_vit_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.random((3, 32, 32, 3)).astype(np.float32)
    w = rng.normal(size=(3, 64)).astype(np.float32)
    jm = JaxViT(embed_dim=64, depth=2, num_heads=4, mlp_dim=256,
                dtype=jnp.float32)
    variables = numpy_variables(jm, jnp.asarray(x), seed=1)
    want, jax_grads = _loss_and_grads(jm, variables, w, jnp.asarray(x))
    tm = ViT(32, embed_dim=64, depth=2, num_heads=4, mlp_dim=256,
             dtype=torch.float32)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    got = tm.eval()(torch.from_numpy(x))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    _check_grads(tm, jax_grads)
    with pytest.raises(ValueError, match="multiple of the 16-px patch"):
        ViT(40)
    with pytest.raises(ValueError, match="does not give the 4"):
        tm(torch.zeros(1, 48, 48, 3))


def test_post_ln_encoder_layer_matches_jax():
    """Train mode at dropout 0 (no mask) is the eval function."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    w = rng.normal(size=(2, 9, 64)).astype(np.float32)
    jm = JaxPostLN(num_heads=4, ff_dim=256, dropout=0.0, dtype=jnp.float32)
    variables = numpy_variables(jm, jnp.asarray(x), seed=2)
    want, jax_grads = _loss_and_grads(jm, variables, w, jnp.asarray(x),
                                      train=True)
    tm = PostLNEncoderLayer(64, 4, 256, dropout=0.0, dtype=torch.float32)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    got = tm.train()(torch.from_numpy(x))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    _check_grads(tm, jax_grads)


@pytest.mark.parametrize("freeze", [True, False])
def test_fact_model_matches_jax(freeze):
    """Eval logits, train-mode logits at dropout 0 and every gradient
    (JAX differentiates the ViT either way: its freeze is the train
    step's)."""
    rng = np.random.default_rng(2)
    images = rng.random((2, 4, 32, 32, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 4, 47)).astype(np.float32)
    w = rng.normal(size=(2, 5)).astype(np.float32)
    kw = dict(SMALL, num_classes=5, seq_len=4, dropout=0.0,
              freeze_backbone=freeze)
    jm = JaxFact(dtype=jnp.float32, **kw)
    x, f = jnp.asarray(images), jnp.asarray(feats)
    variables = numpy_variables(jm, x, f, seed=3)
    want_eval = jax.jit(lambda v: jm.apply(v, x, f))(variables)
    want_train, jax_grads = _loss_and_grads(jm, variables, w, x, f,
                                            train=True)
    tm = FactModel(dtype=torch.float32, image_size=32, **kw)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    xt, ft = torch.from_numpy(images), torch.from_numpy(feats)
    with torch.no_grad():
        got_eval = tm.eval()(xt, ft)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval),
                               rtol=1e-4, atol=1e-4)
    got = tm.train()(xt, ft)
    assert tm.vit_backbone.training is not freeze
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want_train, rtol=1e-4,
                               atol=1e-4)
    _check_grads(tm, jax_grads)


def test_attention_dropout_is_one_mask_over_batch_and_heads():
    """flax's broadcast dropout: one (q, k) keep mask for every batch row
    and head, the kept weights scaled by 1/keep; drawn from the explicit
    generator only."""
    b, n, d, h, rate = 3, 5, 16, 4, 0.5
    attn = MultiHeadDotProductAttention(d, h, rate, torch.float32)
    for i, layer in enumerate((attn.query, attn.key, attn.value, attn.out)):
        torch.nn.init.normal_(layer.weight, 0, 0.3,
                              generator=torch.Generator().manual_seed(i))
    x = torch.randn(b, n, 16, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        attn.train()(x)
    before = torch.get_rng_state()
    with torch.no_grad():
        got = attn(x, torch.Generator().manual_seed(7))
    assert torch.equal(before, torch.get_rng_state())
    keep = torch.rand((n, n), generator=torch.Generator().manual_seed(7))
    keep = keep >= rate
    assert 0 < keep.sum() < n * n

    def heads(layer):
        return F.linear(x, layer.weight, layer.bias).view(
            b, n, h, -1).transpose(1, 2)

    with torch.no_grad():
        q, k, v = heads(attn.query), heads(attn.key), heads(attn.value)
        weights = torch.softmax(q / 2.0 @ k.transpose(-2, -1), dim=-1)
        dropped = torch.where(keep, weights / (1 - rate), 0.0)  # shared
        want = F.linear((dropped @ v).transpose(1, 2).reshape(b, n, 16),
                        attn.out.weight, attn.out.bias)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    with torch.no_grad():
        other = attn(x, torch.Generator().manual_seed(8))
        plain = attn.eval()(x)
    assert not torch.equal(got, other) and not torch.equal(got, plain)


def test_fact_dropout_draws_from_the_explicit_generator():
    model = FactModel(dtype=torch.float32, image_size=32, **SMALL).train()
    x, f = torch.rand(2, 4, 32, 32, 3), torch.randn(2, 4, 47)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        model(x, f)
    before = torch.get_rng_state()
    with torch.no_grad():
        a = model(x, f, torch.Generator().manual_seed(5))
        b = model(x, f, torch.Generator().manual_seed(5))
        c = model(x, f, torch.Generator().manual_seed(6))
    assert torch.equal(before, torch.get_rng_state())
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_clip_length_must_be_seq_len():
    x, f = np.zeros((1, 3, 32, 32, 3), np.float32), np.zeros((1, 3, 47),
                                                            np.float32)
    tm = FactModel(dtype=torch.float32, image_size=32, seq_len=4, **SMALL)
    with pytest.raises(ValueError, match="got a T=3 sequence"):
        tm(torch.from_numpy(x), torch.from_numpy(f))
    jm = JaxFact(dtype=jnp.float32, seq_len=4, **SMALL)
    with pytest.raises(ValueError, match="got a T=3 sequence"):
        jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(f))


def test_parallel_variants_raise_naming_a11():
    """The parallel variants are wired as JAX wires them: the MoE FFN sits
    at ``fusion{i}.moe``; a ``cp_mesh`` whose 'seq' axis is 1 keeps the
    plain attention (JAX: ring attention only above 1) and one of 2 swaps
    every fusion attention for ring attention with the parameters
    unchanged; the pipelined forward of one stage is the plain forward
    (``tests/test_torch_pipeline.py`` runs the stages)."""
    from surya_tpu_torch.core.mesh import Mesh, single_device_mesh

    tm = FactModel(moe_experts=2, **SMALL)
    assert [n for n, _ in tm.named_modules() if n.endswith(".moe")] == [
        "fusion0.moe", "fusion1.moe"]
    one = FactModel(cp_mesh=single_device_mesh("cpu"), **SMALL)
    assert one.fusion0.attn.attention_fn is None and not one.ring_attention
    two = FactModel(cp_mesh=Mesh({"seq": 2}, {"seq": 0}, {"seq": None}),
                    **SMALL)
    assert two.ring_attention and all(
        getattr(two, f"fusion{i}").attn.attention_fn is not None
        for i in range(2))
    assert two.vit_backbone.block0.attn.attention_fn is None
    assert set(two.state_dict()) == set(one.state_dict())
    model = FactModel(dtype=torch.float32, image_size=32, **SMALL).eval()
    model.reset_parameters(torch.Generator().manual_seed(0))
    x, f = torch.rand(2, 4, 32, 32, 3), torch.randn(2, 4, 47)
    with torch.no_grad():
        torch.testing.assert_close(fact_apply_pipelined(model, x, f, None),
                                   model(x, f), rtol=0, atol=1e-6)


def test_one_fact_train_step_matches_jax():
    """The ``fact`` preset's optimizer (AdamW, weight decay 1e-5, clip 1.0)
    and frozen ViT on the small model built in both packages, the same
    weights and batch, dropout 0: loss 1e-5, the ViT bit-unchanged with no
    gradient, every other parameter within two AdamW steps of JAX's and
    its update to 5e-2 relative L2 but the key biases (their exact gradient
    is 0: held to the two-step bound)."""
    b, t, classes = 2, 4, 5
    overrides = {"model.num_classes": str(classes),
                 "model.compute_dtype": "float32", "model.dropout": "0.0",
                 "data.batch_size": str(b)}
    port = get_preset("fact").override(overrides)
    ref = jcfg.get_preset("fact").override(overrides)
    assert port.model.freeze_backbone and port.train.grad_clip == 1.0
    rng = np.random.default_rng(5)
    batch = (rng.random((b, t, 32, 32, 3)).astype(np.float32),
             rng.normal(size=(b, t, 47)).astype(np.float32),
             np.array([1, 3], np.int32))
    kw = dict(SMALL, num_classes=classes, seq_len=t, dropout=0.0)
    jm = JaxFact(dtype=jnp.float32, **kw)
    jstate, jtx = jsteps.create_train_state(jm, ref, jax.random.key(0), batch)
    tm = FactModel(dtype=torch.float32, image_size=32, **kw)
    tm.load_state_dict(from_jax_variables(
        {"params": to_np(jstate.params)}), strict=True)
    tstate, ttx = tsteps.create_train_state(tm, port, device="cpu")
    start = {k: v.detach().clone() for k, v in tm.named_parameters()}

    jstate, jmet = jsteps.make_train_step(jm, jtx, ref)(
        jstate, batch, jax.random.key(1))
    tstate, tmet = tsteps.make_train_step(tm, ttx, port)(tstate, batch)

    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    lr = port.train.lr
    params = from_jax_variables({"params": to_np(jstate.params)})
    assert set(params) == set(start)
    for key, p in tm.named_parameters():
        w = params[key]
        if key.startswith("vit_backbone."):
            assert not p.requires_grad and p.grad is None, key
            assert torch.equal(p, start[key]) and torch.equal(w, start[key])
            continue
        assert (p.detach() - w).abs().max() <= 2.01 * lr, key
        if not key.endswith(ZERO_GRAD):   # noise: the two-step bound only
            du, dw = p.detach() - start[key], w - start[key]
            assert (du - dw).norm() / dw.norm() < 5e-2, key


def test_registry_fact_is_the_published_model():
    """``fact`` at its published widths: ViT-B/16 (12 blocks, 12 heads,
    224 px → 197 tokens), 4 fusion layers of width 768 with 8 heads,
    dropout 0.1, position embeddings for 2·4 + 1 tokens."""
    cfg = get_preset("fact")
    model = get_model(cfg.model)
    vit = model.vit_backbone
    assert vit.depth == 12 and vit.block0.attn.num_heads == 12
    assert tuple(vit.pos_embed.shape) == (1, 197, 768)
    assert tuple(model.pos_embed.shape) == (1, 9, 768)
    assert model.num_layers == 4 and model.fusion3.attn.num_heads == 8
    assert model.fusion0.dropout == model.fusion0.attn.dropout == 0.1
    n = sum(p.numel() for p in vit.parameters())
    assert 85_000_000 < n < 87_000_000, n
    small = dataclasses.replace(cfg.model, fusion_dim=96, fusion_layers=2)
    assert get_model(small, image_size=32).fusion1.ff1.out_features == 384
