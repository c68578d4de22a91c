"""The port's MoE FFN (``surya_tpu_torch/parallel/moe.py``) against
``surya_tpu/parallel/moe.py`` at f32 on the CPU, unsharded (JAX's
``mesh=None``):

- ``top_k_dispatch`` bit-equal to JAX's (dispatch, combine; the aux term,
  a product of two f32 means, within 1e-6 relative), with capacities
  that drop tokens, k = 1 and 2;
- ``MoEFFN`` through ``from_jax_variables`` (JAX's leaf names): output
  and aux term within 1e-5, the router's gradient of the aux term within
  1e-5 relative L2;
- a small FACT with the MoE FFN in every fusion layer against JAX's
  forward within 1e-5;
- the aux term reaches the port's train step: the step's loss is the
  cross-entropy plus every layer's aux term, and the router's first Adam
  moment is the gradient of that sum.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from surya_tpu.models.temporal.fact import FactModel as JaxFact
from surya_tpu.parallel import moe as jmoe
from surya_tpu_torch.core.config import get_preset
from surya_tpu_torch.models.from_jax import from_jax_variables
from surya_tpu_torch.models.temporal.fact import FactModel
from surya_tpu_torch.parallel import moe as tmoe
from surya_tpu_torch.train import steps as tsteps
from test_torch_resnet import numpy_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401

SMALL = dict(embed_dim=64, vit_depth=1, vit_heads=4, num_heads=4,
             num_layers=2, seq_len=2, moe_experts=4, num_classes=4)


def _probs(n, e, seed):
    logits = np.random.default_rng(seed).normal(size=(n, e)) * 2
    return jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1)


@pytest.mark.parametrize("n,e,k,capacity", [
    (12, 4, 2, 3), (12, 4, 1, 2), (20, 5, 2, 8), (7, 3, 2, 1), (9, 4, 2, 9)])
def test_top_k_dispatch_is_bit_equal_to_jax(n, e, k, capacity):
    probs = _probs(n, e, seed=n + e)
    jd, jc, ja = jmoe.top_k_dispatch(probs, k, capacity)
    td, tc, ta = tmoe.top_k_dispatch(torch.from_numpy(np.asarray(probs)), k,
                                     capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert float(ta) == pytest.approx(float(ja), rel=1e-6)
    if capacity * e < n * k:   # some tokens were dropped
        assert td.sum() < n * k


def _moe_pair(capacity_factor=2.0, d=16, e=4, ff=32):
    jm = jmoe.MoEFFN(num_experts=e, ff_dim=ff, top_k=2,
                     capacity_factor=capacity_factor, dtype=jnp.float32)
    x = np.random.default_rng(0).normal(size=(3, 5, d)).astype(np.float32)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(1),
                                                 jnp.asarray(x)))
    tm = tmoe.MoEFFN(d, e, ff, 2, capacity_factor, dtype=torch.float32)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, variables, tm, x


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_moe_ffn_matches_jax_through_the_bridge(capacity_factor):
    jm, variables, tm, x = _moe_pair(capacity_factor)
    # the init's own sown term is not carried in (a fresh apply's is)
    want, sown = jm.apply({"params": variables["params"]}, jnp.asarray(x),
                          mutable=["losses"])
    got = tm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    assert float(tm.aux_loss) == pytest.approx(
        float(sown["losses"]["moe_aux"]), abs=1e-7)

    def aux(params):
        _, s = jm.apply({"params": params}, jnp.asarray(x),
                        mutable=["losses"])
        return s["losses"]["moe_aux"]

    jgrad = np.asarray(jax.jit(jax.grad(aux))(variables["params"])["router"])
    tm.zero_grad()
    tm(torch.from_numpy(x))
    tm.aux_loss.backward()
    tgrad = tm.router.grad.numpy()
    assert np.linalg.norm(tgrad - jgrad) <= 1e-5 * np.linalg.norm(jgrad)


def _fact_inputs(b=2):
    rng = np.random.default_rng(4)
    return (rng.normal(size=(b, 2, 32, 32, 3)).astype(np.float32),
            rng.normal(size=(b, 2, 47)).astype(np.float32))


def test_fact_moe_forward_matches_jax():
    images, feats = _fact_inputs()
    jm = JaxFact(dtype=jnp.float32, **SMALL)
    x, f = jnp.asarray(images), jnp.asarray(feats)
    variables = numpy_variables(jm, x, f, seed=3)
    want = jax.jit(lambda v: jm.apply(v, x, f))(variables)
    tm = FactModel(dtype=torch.float32, image_size=32, **SMALL)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(images), torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    with pytest.raises(NotImplementedError, match="A11b"):
        FactModel(moe_mesh=type("M", (), {"shape": {"expert": 2}})(),
                  **SMALL)


def test_aux_loss_reaches_the_train_step():
    cfg = get_preset("fact").override({
        "model.moe_experts": "4", "model.num_classes": "4",
        "model.seq_len": "2", "model.fusion_dim": "64",
        "model.fusion_heads": "4", "model.fusion_layers": "2",
        "model.compute_dtype": "float32", "model.dropout": "0.0",
        "train.grad_clip": "0.0"})
    tm = FactModel(dtype=torch.float32, image_size=32, dropout=0.0, **SMALL)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    state, tx = tsteps.create_train_state(tm, cfg, device="cpu")
    images, feats = _fact_inputs()
    labels = np.array([1, 3])
    x, f = torch.from_numpy(images), torch.from_numpy(feats)

    tm.train()
    logits = tm(x, f, state.generator)
    aux = sum(m.aux_loss for m in tm.modules()
              if isinstance(m, tmoe.MoEFFN))
    ce = F.cross_entropy(logits.float(), torch.from_numpy(labels))
    routers = [m.router for m in tm.modules() if isinstance(m, tmoe.MoEFFN)]
    want = torch.autograd.grad(ce + aux, routers)

    _, metrics = tsteps.make_train_step(tm, tx, cfg)(
        state, (images, feats, labels))
    assert float(metrics["loss"]) == pytest.approx(float(ce + aux),
                                                   abs=1e-6)
    for router, g in zip(routers, want):
        torch.testing.assert_close(tx.state[router]["exp_avg"], 0.1 * g,
                                   rtol=1e-5, atol=1e-9)
    assert float(aux) > 0
