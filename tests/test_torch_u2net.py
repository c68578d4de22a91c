"""The port's U²-Net (``surya_tpu_torch/models/segmentation/u2net.py``)
against the JAX package's, on the CPU at f32.

Weights: ``tests/torch_mirrors.py::MirrorU2NetP`` with randomised BN
statistics, through JAX's ``import_u2net``; the port takes them through
``from_jax_variables`` and through its own ``import_u2net``. The JAX side
is jitted. Tolerances (max |port − JAX|, on probabilities in [0, 1]):
the fused and side maps 1e-5 in eval mode and 5e-4 in train mode, the BN
running statistics after a train step 1e-4 relative, the loss 1e-6
relative, ``saliency_fn`` 1e-4 (its
resizes antialias when they shrink). Full ``u2net`` is built on ``meta``
only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import one_torch_thread  # noqa: F401

from surya_tpu.models.segmentation import U2Net as JaxU2Net
from surya_tpu.models.segmentation import import_u2net as jax_import
from surya_tpu.models.segmentation import saliency_fn as jax_saliency_fn
from surya_tpu.models.segmentation import u2net_loss as jax_loss
from surya_tpu_torch.models.common import count_parameters
from surya_tpu_torch.models.from_jax import from_jax_variables
from surya_tpu_torch.models.segmentation import (
    U2Net,
    import_u2net,
    saliency_fn,
    u2net_loss,
)
from tests.torch_mirrors import MirrorU2NetP, randomize_bn_stats

TOL = 1e-5


def max_err(got, want):
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


@pytest.fixture(scope="module")
def u2netp():
    torch.manual_seed(0)
    mirror = MirrorU2NetP()
    randomize_bn_stats(mirror, seed=1)
    state = mirror.eval().state_dict()
    variables = jax.device_get(jax_import(state, variant="u2netp"))
    model = JaxU2Net(variant="u2netp")
    port = U2Net("u2netp")
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return state, variables, model, port.eval()


def test_eval_matches_jax(u2netp):
    """66×50 takes every ceil-mode pool through odd sizes; the 7 maps."""
    _, variables, model, port = u2netp
    x = np.random.default_rng(2).normal(size=(2, 66, 50, 3)).astype(
        np.float32)
    fused, sides = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, x)
    with torch.no_grad():
        got, got_sides = port(torch.from_numpy(x))
    assert got.shape == (2, 66, 50, 1) and got.dtype == torch.float32
    assert len(got_sides) == 6
    for g, w in zip([got] + got_sides, [fused] + list(sides)):
        assert g.shape == w.shape and max_err(g, w) <= TOL


def test_train_mode_bn_update_matches_jax(u2netp):
    """One train-mode forward: outputs on batch statistics, and every
    running mean and variance moved as flax moves them (momentum 0.9,
    biased variance). flax takes the batch variance as E[x²] − E[x]² in
    f32, the port (torch) in two passes; the two differ by f32 rounding
    times mean²/var, up to 3.3e-4 on one BN of a map shifted by 30σ, and
    112 layers carry it: the probabilities are held to 5e-4 (2.1e-4
    measured), the bound of the JAX package's own torch-vs-flax U²-Net
    test (``tests/test_u2net.py``); the statistics to 1e-4 relative."""
    _, variables, model, _ = u2netp
    port = U2Net("u2netp")
    port.load_state_dict(from_jax_variables(variables), strict=True)
    port.train()
    x = np.random.default_rng(3).normal(size=(4, 64, 64, 3)).astype(
        np.float32)
    (fused, _), new = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    with torch.no_grad():
        got, _ = port(torch.from_numpy(x))
    assert max_err(got, fused) <= 5e-4
    want = from_jax_variables({"batch_stats": jax.device_get(
        new["batch_stats"])})
    state = port.state_dict()
    assert len(want) == 2 * 112
    for k, w in want.items():
        assert max_err(state[k], w) <= 1e-4 * float(w.abs().max()), k
    before = from_jax_variables(variables)
    assert not torch.equal(state["stage1.rebnconvin.bn_s1.running_mean"],
                           before["stage1.rebnconvin.bn_s1.running_mean"])


def test_loss_matches_jax():
    rng = np.random.default_rng(4)
    probs = [rng.uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)
             for _ in range(7)]
    probs[0][0, 0, 0, 0] = 0.0          # the clip at eps
    target = (rng.uniform(size=(2, 8, 8, 1)) > 0.5).astype(np.float32)
    want = float(jax_loss(probs[0], probs[1:], target))
    t = [torch.from_numpy(p) for p in probs]
    got = float(u2net_loss(t[0], t[1:], torch.from_numpy(target)))
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("src", [48, 96])
def test_saliency_fn_resizes_as_jax(u2netp, src):
    """``saliency_fn(size=64)`` on a 48-px source (the input grows, the
    map shrinks back) and a 96-px one (the input shrinks: antialiased)."""
    _, variables, model, port = u2netp
    img = np.random.default_rng(src).integers(
        0, 256, (src, src - 8, 3), np.uint8)
    want = np.asarray(jax.jit(jax_saliency_fn(model, variables, size=64))(
        img))
    got = saliency_fn(port, size=64)(torch.from_numpy(img))
    assert got.shape == (src, src - 8) and got.dtype == torch.float32
    assert max_err(got, want) <= 1e-4, max_err(got, want)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0 + 1e-6


def test_import_u2net_from_the_mirror(u2netp):
    """A strict load of the canonical names (``num_batches_tracked``
    dropped), equal to the bridged JAX tree bit for bit."""
    state, variables, _, port = u2netp
    imported = import_u2net(state, "u2netp", device="cpu").eval()
    back = from_jax_variables(variables)
    kept = {k: v for k, v in state.items()
            if not k.endswith("num_batches_tracked")}
    assert set(back) == set(kept) == set(imported.state_dict())
    assert all(torch.equal(back[k], kept[k]) for k in kept)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 24, 20, 3)).astype(np.float32))
    with torch.no_grad():
        a, _ = imported(x)
        b, _ = port(x)
    assert torch.equal(a, b)


def test_full_u2net_count_on_meta():
    counts = {}
    for variant in ("u2net", "u2netp"):
        with torch.device("meta"):
            model = U2Net(variant)
        shapes = jax.eval_shape(lambda v=variant: JaxU2Net(variant=v).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
        want = sum(int(np.prod(a.shape))
                   for a in jax.tree_util.tree_leaves(shapes["params"]))
        counts[variant] = (count_parameters(model), want)
    assert counts == {"u2net": (44_009_869, 44_009_869),
                      "u2netp": (1_131_181, 1_131_181)}
