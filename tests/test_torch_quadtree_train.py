"""QuadtreeCNN of the PyTorch port in train mode against JAX
``QuadtreeCNN(dtype=f32, use_pallas=True)`` (whose custom-VJP backwards run
on the CPU's lax path): same weights through ``from_jax_variables``, same
numpy batch, dropout 0. Logits to 1e-4, parameter gradients to 1e-4
relative L2 outside the trunk and 5e-2 inside it (see below), BN running
statistics to 1e-4; and the dropout stream: explicit, reproducible,
never the global generator."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from surya_tpu.models.losses import cross_entropy as jax_cross_entropy
from surya_tpu.models.spatial.quadtree import QuadtreeCNN as JaxQuadtree
from surya_tpu_torch.core.config import ModelConfig
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.from_jax import from_jax_variables
from surya_tpu_torch.models.losses import cross_entropy
from test_torch_resnet import numpy_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401

MODES = ("fusion", "image_only", "numerical_only")
# Relative L2 of a parameter gradient. Outside the trunk (quadrant conv,
# numerical MLP, classifier) the two frameworks differ by summation order
# alone. Inside it the backward through 20 train-mode BN layers on a batch
# of 4 is badly conditioned: BN's backward cancels most of a cotangent, and
# the gradient of a BN bias that the next BN largely undoes is a small
# difference of large sums, so those move by a percent or two between two
# orders of summation.
HEAD_GRAD_TOL, TRUNK_GRAD_TOL = 1e-4, 5e-2


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    return (rng.random((4, 64, 64, 3)).astype(np.float32),
            rng.normal(size=(4, 47)).astype(np.float32),
            rng.integers(0, 5, 4))


@pytest.mark.parametrize("mode", MODES)
def test_train_mode_logits_gradients_and_bn_stats_match_jax(mode, batch):
    images, feats, labels = batch
    jm = JaxQuadtree(num_classes=5, mode=mode, dtype=jnp.float32,
                     dropout=0.0, use_pallas=True)
    variables = numpy_variables(jm, jnp.asarray(images), jnp.asarray(feats),
                                seed=11)
    stats = variables.get("batch_stats", {})

    def loss_fn(params):
        logits, mut = jm.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(images),
            jnp.asarray(feats), train=True, mutable=["batch_stats"])
        return (jax_cross_entropy(logits, jnp.asarray(labels)),
                (logits, mut.get("batch_stats", {})))

    (_, (want_logits, want_stats)), want_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])

    cfg = ModelConfig(num_classes=5, mode=mode, compute_dtype="float32",
                      dropout=0.0)
    tm = get_model(cfg, image_size=64).train()
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    logits = tm(torch.from_numpy(images), torch.from_numpy(feats))
    cross_entropy(logits, torch.from_numpy(labels)).backward()

    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-4, atol=1e-4)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    grads = from_jax_variables({"params": to_np(want_grads)})
    params = dict(tm.named_parameters())
    assert set(grads) == set(params)
    errs = {}
    for name, want in grads.items():
        got, want = params[name].grad.numpy(), want.numpy()
        errs[name] = float(np.linalg.norm(got - want)
                           / (np.linalg.norm(want) + 1e-12))
    heads = {n: e for n, e in errs.items() if not n.startswith("trunk.")}
    assert max(heads.values()) < HEAD_GRAD_TOL, sorted(
        heads.items(), key=lambda kv: kv[1])[-3:]
    assert max(errs.values()) < TRUNK_GRAD_TOL, sorted(
        errs.items(), key=lambda kv: kv[1])[-3:]
    moved = from_jax_variables({"batch_stats": to_np(want_stats)})
    state = tm.state_dict()
    assert len(moved) == (0 if mode == "numerical_only" else 40)
    for name, want in moved.items():
        np.testing.assert_allclose(state[name].numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def dropout_model():
    cfg = ModelConfig(num_classes=5, compute_dtype="float32")  # dropout 0.5
    return get_model(cfg, image_size=64).train()


def test_train_mode_needs_an_explicit_generator(dropout_model, batch):
    images, feats = map(torch.from_numpy, batch[:2])
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        dropout_model(images, feats)
    with torch.no_grad():   # eval mode draws nothing and needs none
        dropout_model.eval()(images, feats)
    dropout_model.train()


def test_dropout_is_reproducible_and_leaves_the_global_generator_alone(
        dropout_model, batch):
    images, feats = map(torch.from_numpy, batch[:2])
    before = torch.get_rng_state()
    with torch.no_grad():
        g = torch.Generator().manual_seed(5)
        a = dropout_model(images, feats, g)
        b = dropout_model(images, feats, g)          # the stream moved on
        c = dropout_model(images, feats, torch.Generator().manual_seed(5))
    assert torch.equal(before, torch.get_rng_state())
    assert torch.equal(a, c) and not torch.equal(a, b)


def test_numerical_mlp_dropout_follows_flax_semantics():
    """Kept with probability 1 - rate and scaled by 1/(1 - rate)."""
    from surya_tpu_torch.models.common import NumericalMLP

    mlp = NumericalMLP(47, 256, dropout=0.25, dtype=torch.float32).train()
    with torch.no_grad():
        mlp.fc1.weight.zero_()
        mlp.fc1.bias.fill_(1.0)          # hidden = 1 everywhere after ReLU
        mlp.fc2.weight.copy_(torch.eye(256, 94))
        mlp.fc2.bias.zero_()
        out = mlp(torch.zeros(512, 47), torch.Generator().manual_seed(0))
    hidden = out[:, :94]
    kept = hidden != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    assert torch.allclose(hidden[kept], torch.tensor(1 / 0.75))
