"""The port's MoE FFN (``surya_tpu_torch/parallel/moe.py``) against
``surya_tpu/parallel/moe.py`` at f32 on the CPU, unsharded (JAX's
``mesh=None``) and expert-parallel:

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
  moment is the gradient of that sum;
- expert parallelism on two gloo ranks (one spawn): FACT-MoE's logits, aux
  term and gradients against JAX's unsharded model, half the expert
  bytes a rank, the gathered checkpoint, a clipped train step equal to
  one process's, and JAX's ``num_experts % ep`` error.
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
    # a mesh of one device keeps every expert (the unsharded path)
    from surya_tpu_torch.core.mesh import single_device_mesh

    one = FactModel(dtype=torch.float32, image_size=32,
                    moe_mesh=single_device_mesh("cpu", ("expert",)), **SMALL)
    assert one.fusion0.moe.w1.shape[0] == 4
    assert one.fusion0.moe.sharded_leaves() == {}


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


# ---------------------------------------------------------------------------
# expert parallelism: FACT-MoE (JAX's dryrun model, 2 layers, 4 experts) on
# two gloo ranks, each holding two experts, against JAX's unsharded model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    import torch_dist_worker as W
    from torch_fact_reference import FACT_MOE, jax_fact

    tmp = tmp_path_factory.mktemp("ep")
    ref = jax_fact(FACT_MOE, {"batch": 8, "seed": 2}, tmp / "moe.pt")
    spec = {**ref["spec"], "train": 1}
    step = {**ref["spec"], "clip": 0.05}
    forms, steps = W.run([(W.fact_form, {**spec, "form": "ep",
                                         "mesh": {"expert": 2}}),
                          (W.fact_moe_step, {**step, "mesh": {"expert": 2}})],
                         2, tmp / "gloo")
    return ref, forms, steps, W.fact_moe_step(step)


def test_expert_parallel_fact_moe_matches_jax(ep):
    """ep2: logits 1e-5, the aux term 1e-6 and every gradient (the
    router's, through the combine weights and the aux term, included) at
    JAX's EP tolerance (rtol 1e-4, atol 1e-5), the expert leaves gathered
    to (E, …) from each rank's two experts."""
    from torch_fact_reference import assert_grads

    ref, forms, _, _ = ep
    for rank in forms:
        np.testing.assert_allclose(rank["logits"].numpy(), ref["logits"],
                                   rtol=0, atol=1e-5)
        assert rank["aux"] == pytest.approx(ref["aux"], abs=1e-6)
        assert rank["aux"] > 0
        assert_grads(rank["grads"], ref["grads"], rtol=1e-4, atol=1e-5)


def test_each_rank_holds_half_the_experts_and_the_checkpoint_loads(ep):
    """JAX's 8 expert-sharded leaves (w1, b1, w2, b2 of two layers); each
    rank stores half the expert bytes; the gathered state loads strictly
    into a one-device FACT-MoE and is the weights it started from."""
    from torch_fact_reference import FACT_MOE, port_model

    ref, forms, _, _ = ep
    full = torch.load(ref["spec"]["weights"])
    whole = sum(v.numel() * 4 for k, v in full.items()
                if k.rpartition(".")[2] in tmoe.EXPERT_LEAVES)
    model = FactModel(dtype=torch.float32, **port_model(FACT_MOE))
    model.load_state_dict(forms[0]["state"], strict=True)
    for rank in forms:
        assert rank["expert_leaves"] == 8
        assert 2 * rank["expert_bytes"] == whole
        for k, v in rank["state"].items():
            assert torch.equal(v, full[k]), k


def test_expert_parallel_train_step_clips_over_the_expert_axis(ep):
    """``make_train_step`` on the ep2 state: clip 0.05 binds, so the
    gradients in Adam's first moments carry the global norm's factor; the
    expert leaves count once over 'expert' and the step (loss, moments,
    parameters) is the single-device one."""
    _, _, steps, one = ep
    for rank in steps:
        assert rank["loss"] == pytest.approx(one["loss"], abs=1e-6)
        got, want = rank["snap"]["optimizer"], one["snap"]["optimizer"]
        assert set(got["state"]) == set(want["state"])
        for i, st in want["state"].items():
            torch.testing.assert_close(got["state"][i]["exp_avg"],
                                       st["exp_avg"], rtol=1e-4, atol=1e-8)
        for k, v in one["snap"]["model"].items():
            torch.testing.assert_close(rank["snap"]["model"][k], v,
                                       rtol=0, atol=1e-5)


def test_experts_must_divide_the_expert_axis():
    """JAX's error: num_experts % ep != 0."""
    from surya_tpu_torch.core.mesh import Mesh

    mesh = Mesh({"expert": 2}, {"expert": 0}, {"expert": object()})
    with pytest.raises(ValueError, match="num_experts=3 not divisible"):
        tmoe.MoEFFN(16, num_experts=3, mesh=mesh)
