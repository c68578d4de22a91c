"""The port's parallelism (``surya_tpu_torch/parallel``, ``train/steps.py``
on a mesh) against ``surya_tpu/parallel`` and against the port's own
single-device step, on the CPU.

- the tensor-parallel rule: the flagship at model 2 shards 15 of its 70
  parameters, as JAX's ``count_sharded`` (``MULTICHIP_r05.json``); one
  preset of each spatial family counts as JAX does;
- the ZeRO rule (``_leaf_spec``) and its leaf counts (136 moment leaves
  and 68 parameter leaves of the flagship over dp4, as JAX's dryrun);
- one run of two gloo processes (``torch_dist_worker.py``), its jobs each
  held to the one-process run of the same function: the dp2 train step
  with dropout 0.5 (the single-device step on the global batch), the
  model-2 (TP) step, ZeRO-1 and FSDP2 over dp2, their checkpoints loaded
  into a one-device ``TrainState`` and ``Predictor``, the MoE FFN's
  routing over dp2 and ``Predictor(mesh=)``.

Tolerances (f32): loss, BN running statistics and FSDP/ZeRO checkpoint
round trips 1e-5. Parameters after an AdamW step at 1e-5 on every element
whose gradient is resolved: Adam's first update is lr·g/(|g| + 1e-8), ±lr
for any gradient well above 1e-8, so an element whose gradient lies
within rounding of 0 (smaller than 10× the two runs' difference) steps
either way, and one within 100× Adam's eps of 0 moves with the gradient's
rounding; those are held to 2·lr and must stay under 5% of the
elements. The dp2 gradients themselves differ from one process by the
rounding of the merged BN statistics, which flips ReLU masks of
pre-activations within ~1e-7 of 0 (a 64-px random-weight trunk has
some): the trunk's are held to 2e-2 relative L2, the rest to 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_worker as W
from surya_tpu.core import config as jcfg
from surya_tpu.models import get_model as jax_get_model
from surya_tpu.parallel import sharding as jshard
from surya_tpu.parallel import zero as jzero
from surya_tpu_torch.core.checkpoint import load_snapshot
from surya_tpu_torch.core.config import get_preset
from surya_tpu_torch.infer.serve import Predictor
from surya_tpu_torch.models import get_model
from surya_tpu_torch.parallel import count_sharded
from surya_tpu_torch.parallel import zero as tzero
from surya_tpu_torch.train.steps import create_train_state, trainable_mask
from torch_port_fixtures import one_torch_thread  # noqa: F401

ADAM_EPS = 1e-8
BASE = {"size": 64, "batch": 4, "dropout": 0.5, "steps": 1}
MOE = {"dim": 16, "experts": 4, "ff": 32, "top_k": 2,
       "capacity_factor": 0.75, "batch": 4, "tokens": 5}
JOBS = {"dp2": (W.train_steps, {**BASE, "mesh": {"data": 2}}),
        "tp2": (W.train_steps, {**BASE, "mesh": {"data": 1, "model": 2}}),
        "zero1": (W.train_steps, {**BASE, "mesh": {"data": 2},
                                  "zero1": True}),
        "fsdp": (W.train_steps, {**BASE, "mesh": {"data": 2},
                                 "fsdp": True}),
        "apply_zero1": (W.train_steps, {**BASE, "mesh": {"data": 2},
                                        "apply_zero1": True}),
        "remat": (W.train_steps, {**BASE, "mesh": {"data": 2},
                                  "remat": True}),
        "accum2": (W.train_steps, {**BASE, "batch": 8, "accum": 2,
                                   "mesh": {"data": 2}}),
        "moe": (W.moe_forward, {**MOE, "mesh": {"data": 2}}),
        "predict": (W.predict, {**BASE, "chunk": 4, "mesh": {"data": 2}})}


def _jax_mesh(data, model):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:data * model]).reshape(
        data, model, 1), ("data", "model", "seq"))


def _jax_param_shapes(preset, size=224):
    cfg = jcfg.get_preset(preset)
    model = jax_get_model(cfg.model)
    images = jax.ShapeDtypeStruct((1, size, size, 3), np.float32)
    feats = jax.ShapeDtypeStruct((1, 47), np.float32)
    return jax.eval_shape(lambda a, b: model.init(
        jax.random.key(0), a, b, train=False), images, feats)["params"]


def _meta_model(preset, size=224):
    with torch.device("meta"):
        return get_model(get_preset(preset).model, image_size=size)


@pytest.mark.parametrize("preset", [
    "quadtree-fusion", "comparative-resnet18", "comparative-vgg16"])
def test_tp_rule_counts_as_jax(preset):
    """The flagship at model 2 shards JAX's 15 of 70 (a rule reading dim 0
    alone finds 14: ``quadrant_conv_kernel`` is HWIO, its output axis the
    last); the standard family over two backbones counts as JAX does."""
    want = jshard.count_sharded(_jax_param_shapes(preset), _jax_mesh(4, 2))
    got = count_sharded(_meta_model(preset), 2)
    print(f"{preset}: port {got}, JAX {want}")
    assert got == want
    if preset == "quadtree-fusion":
        assert got == (15, 70)


def test_tp_rule_on_other_families_reported():
    """The hierarchical and attention families (no leaves folded by the
    bridge) count as JAX does; FACT's ViT folds per-head kernels and
    cnn-lstm stacks per-gate ones, so their counts are reported only."""
    for name in ("hierarchical_quadtree", "attention_hierarchical"):
        cfg = get_preset("quadtree-fusion").override(
            {"model.name": name})
        jm = jax_get_model(jcfg.get_preset("quadtree-fusion").override(
            {"model.name": name}).model)
        shapes = jax.eval_shape(lambda a, b: jm.init(
            jax.random.key(0), a, b, train=False),
            jax.ShapeDtypeStruct((1, 224, 224, 3), np.float32),
            jax.ShapeDtypeStruct((1, 47), np.float32))["params"]
        with torch.device("meta"):
            tm = get_model(cfg.model, image_size=224)
        assert count_sharded(tm, 2) == jshard.count_sharded(
            shapes, _jax_mesh(4, 2)), name
    print("cnn-lstm port", count_sharded(_meta_model("cnn-lstm"), 2))


@pytest.mark.parametrize("shape", [(3, 3, 256, 128), (128, 256, 3, 3),
                                   (5376, 2688), (2688,), (7, 5), (3,), (),
                                   (4, 6, 8), (2, 8)])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_zero_leaf_spec_is_jax(shape, n):
    want = tuple(jzero._leaf_spec(shape, n))
    assert tzero._leaf_spec(shape, n) == want


def test_zero_counts_of_the_flagship_are_jax():
    """JAX's dryrun: 136 sharded moment leaves (zero1 over dp4, two moments
    a leaf) and 68 sharded parameter leaves (fsdp over dp4); the port's
    OIHW shapes split the same leaves (any divisible axis)."""
    shapes = [tuple(p.shape) for p in _meta_model(
        "quadtree-fusion", 64).parameters()]
    jshapes = [tuple(x.shape) for x in jax.tree.leaves(
        _jax_param_shapes("quadtree-fusion", 64))]
    def count(shapes, rule):
        return sum(bool(tuple(rule(s, 4))) for s in shapes)

    assert count(shapes, tzero._leaf_spec) == count(
        jshapes, jzero._leaf_spec) == 68
    assert 2 * count(shapes, tzero._leaf_spec) == 136


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Every job of ``JOBS`` on two gloo ranks (one spawn), and the
    one-process runs they are held to."""
    names = list(JOBS)
    out = W.run([JOBS[k] for k in names], 2, tmp_path_factory.mktemp("gloo"))
    runs = dict(zip(names, out))
    ref = {"step": W.train_steps(BASE),
           "accum2": W.train_steps({**BASE, "batch": 8, "accum": 2}),
           "moe": W.moe_forward(MOE),
           "predict": W.predict({**BASE, "chunk": 4})}
    return runs, ref


def _trainable_names(spec):
    cfg = W.tiny_config(spec)
    mask = trainable_mask(get_model(cfg.model, image_size=spec["size"]),
                          cfg.model.name, cfg.model.freeze_backbone)
    return [n for n in mask if mask[n]]


def _hold_step(got, want, lr=1e-3, tol=1e-5):
    """Loss, BN statistics, gradients (Adam's first moment is 0.1·g) and
    the parameters after one step (module docstring)."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=tol)
    gm, wm = got["snap"]["model"], want["snap"]["model"]
    assert set(gm) == set(wm)
    for k in wm:
        if "running" in k:
            np.testing.assert_allclose(gm[k], wm[k], rtol=0, atol=tol,
                                       err_msg=k)
    unresolved = total = 0
    for i, name in enumerate(_trainable_names(BASE)):
        g1 = got["snap"]["optimizer"]["state"][i]["exp_avg"]
        g0 = want["snap"]["optimizer"]["state"][i]["exp_avg"]
        rel = float((g1 - g0).norm() / g0.norm().clamp(min=1e-30))
        assert rel <= (2e-2 if name.startswith("trunk.") else 1e-4), (
            name, rel)
        g0, g1 = 10 * g0, 10 * g1
        loose = (g1 != g0) & ((g0.abs() < 10 * (g1 - g0).abs())
                              | (g0.abs() < 100 * ADAM_EPS))
        d = (gm[name] - wm[name]).abs()
        assert float(torch.where(loose, 0.0, d).max()) <= tol, name
        assert float(d.max()) <= 2 * lr + tol, name
        unresolved += int(loose.sum())
        total += loose.numel()
    assert unresolved < 0.05 * total, (unresolved, total)


@pytest.mark.parametrize("job", ["dp2", "tp2", "zero1", "fsdp",
                                 "apply_zero1", "remat", "accum2"])
def test_sharded_step_is_the_single_device_step(gloo, job):
    """dp2 (with dropout 0.5: each rank's masks are its rows of the global
    masks), model-2 TP, ZeRO-1 (built by ``create_train_state(mesh=)`` or
    by ``apply_zero1`` on a one-device state), FSDP2, remat (the
    recomputation redraws the global masks) and grad_accum=2 (each rank
    its rows of each global microbatch) over dp2: the one-process step on
    the global batch, and every rank reports the same global metrics and
    the same gathered state."""
    runs, ref = gloo
    want = ref["accum2" if job == "accum2" else "step"]
    r0, r1 = runs[job]
    assert r0["losses"] == r1["losses"]
    assert r0["accuracy"] == r1["accuracy"] == want["accuracy"]
    for k, v in r0["snap"]["model"].items():
        assert torch.equal(v, r1["snap"]["model"][k]), k
    _hold_step(r0, want)


@pytest.mark.parametrize("job", ["zero1", "fsdp", "tp2"])
def test_sharded_checkpoint_loads_on_one_device(gloo, job):
    """The gathered snapshot is the single-device form: it loads into a
    one-device ``TrainState`` (``load_snapshot``, strict) and serves from a
    ``Predictor``, with the gathered Adam moments in place."""
    runs, _ = gloo
    snap = runs[job][0]["snap"]
    cfg = W.tiny_config(JOBS[job][1])
    model = get_model(cfg.model, image_size=64)
    state, tx = create_train_state(model, cfg, device="cpu")
    load_snapshot(state, snap)
    for k, v in model.state_dict().items():
        assert torch.equal(v, snap["model"][k]), k
    assert len(tx.state) == len(snap["optimizer"]["state"]) > 0
    images, feats, _ = W.batch_of(BASE)
    preds, probs = Predictor(cfg.model, snap["model"], batch_size=4,
                             image_size=64, device="cpu").predict(
        images, feats)
    assert probs.shape == (4, 4) and np.isfinite(probs).all()


def test_moe_routing_over_dp2_is_the_global_one(gloo):
    """Capacity 0.75 drops tokens: each rank's slots start after the lower
    rank's tokens' and the aux term is the global one, so the ranks' rows
    are the one-process output, bit for bit here, and the router's
    gradient (aux included) agrees."""
    runs, ref = gloo
    m0, m1 = runs["moe"]
    torch.testing.assert_close(torch.cat([m0["out"], m1["out"]]),
                               ref["moe"]["out"], rtol=0, atol=1e-6)
    assert m0["aux"] == pytest.approx(ref["moe"]["aux"], abs=1e-7)
    torch.testing.assert_close(m0["router_grad"], ref["moe"]["router_grad"],
                               rtol=0, atol=1e-5)


def test_predictor_over_dp2_returns_the_whole_batch(gloo):
    runs, ref = gloo
    for r in runs["predict"]:
        np.testing.assert_array_equal(r["preds"], ref["predict"]["preds"])
        np.testing.assert_allclose(r["probs"], ref["predict"]["probs"],
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# slow: MULTICHIP_r05.json's dryruns at world size 8, against JAX's sharded
# steps on the conftest's 8 CPU devices as __graft_entry__.dryrun_multichip
# builds them (the flagship at 64 px, batch 16, f32; dropout 0, so the
# two frameworks' streams do not enter)
# ---------------------------------------------------------------------------

DRY = {"size": 64, "batch": 16, "dropout": 0.0, "steps": 1, "seed": 3,
       "mesh": {"data": 4, "model": 2},
       "overrides": {"model.num_classes": "8", "model.use_pallas": "false"}}


def _jax_dryrun_steps(spec):
    """JAX's state and one step of each dryrun form (dp4×tp2, +zero1,
    +fsdp), each from the same initial state → (initial variables,
    {form: (loss, batch_stats)})."""
    from surya_tpu.core import mesh as jmesh
    from surya_tpu.core.prng import PRNG
    from surya_tpu.train import steps as jsteps

    cfg = jcfg.get_preset("quadtree-fusion").override(W.overrides(spec))
    images, feats, labels = W.batch_of(spec)
    batch = (images, feats, labels.astype(np.int32))
    mesh = jmesh.create_mesh(jmesh.MeshSpec(data=4, model=2),
                             devices=jax.devices()[:8])
    model = jax_get_model(cfg.model)
    out = {}
    def placed():   # the step donates its state: a fresh one each form
        state, tx = jsteps.create_train_state(
            model, cfg, PRNG(0).named(0, "init"), batch)
        state = jmesh.replicate(mesh, state)
        return state.replace(params=jshard.partition_params(state.params,
                                                            mesh)), tx

    with mesh:
        state, tx = placed()
        init = jax.tree.map(np.asarray, {"params": state.params,
                                         "batch_stats": state.batch_stats})
        sharded = jmesh.shard_batch(mesh, batch)
        key = PRNG(0).named(0, "dropout")
        forms = {"tp": lambda st: (st, None),
                 "zero1": lambda st: jzero.apply_zero1(st, mesh),
                 "fsdp": lambda st: jzero.apply_fsdp(st, mesh)}
        for form, place in forms.items():
            st, shardings = place(placed()[0])
            step = jsteps.make_train_step(model, tx, cfg, mesh=mesh,
                                          state_shardings=shardings)
            new, metrics = step(st, sharded, key)
            out[form] = (float(metrics["loss"]),
                         jax.tree.map(np.asarray, new.batch_stats))
    return init, out


@pytest.mark.slow
def test_dryrun_forms_at_world_size_8_match_jax(tmp_path):
    """dp4×tp2, zero1 over dp4 and fsdp over dp4 on 8 gloo ranks: each
    step's loss and BN running statistics within 1e-5 of JAX's sharded
    step from the same weights; the fsdp checkpoint loads on one device."""
    from surya_tpu_torch.models.from_jax import from_jax_variables

    init, want = _jax_dryrun_steps(DRY)
    weights = str(tmp_path / "init.pt")
    torch.save(from_jax_variables(init), weights)
    spec = {**DRY, "weights": weights}
    runs = W.run([(W.train_steps, spec),
                  (W.train_steps, {**spec, "zero1": True}),
                  (W.train_steps, {**spec, "fsdp": True})], 8,
                 tmp_path / "gloo")
    for form, ranks in zip(("tp", "zero1", "fsdp"), runs):
        loss, stats = want[form]
        assert ranks[0]["losses"][0] == pytest.approx(loss, abs=1e-5), form
        got = ranks[0]["snap"]["model"]
        flat = from_jax_variables({"batch_stats": stats})
        for k, v in flat.items():
            np.testing.assert_allclose(got[k], v, atol=1e-5,
                                       err_msg=f"{form} {k}")
    snap = runs[2][0]["snap"]
    cfg = W.tiny_config(DRY)
    model = get_model(cfg.model, image_size=64)
    state, _ = create_train_state(model, cfg, device="cpu")
    load_snapshot(state, snap)
    images, feats, _ = W.batch_of(DRY)
    _, probs = Predictor(cfg.model, snap["model"], batch_size=16,
                         image_size=64, device="cpu").predict(images, feats)
    assert np.isfinite(probs).all()


@pytest.mark.slow
def test_cli_under_torchrun_on_two_cpu_ranks(tmp_path):
    """``torchrun --nproc-per-node=2 -m surya_tpu_torch train --mesh.data=2
    --device cpu``: rank 0 alone prints the result and writes the
    checkpoint, which ``eval`` reads on one device."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tiny = ["--synthetic", "--device", "cpu", "--data.image_size=64",
            "--data.synthetic_size=16", "--model.num_classes=4",
            "--model.compute_dtype=float32", "--data.batch_size=4"]
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", "-m", "surya_tpu_torch", "train", "--out",
         str(tmp_path / "run"), "--train.epochs=1", "--mesh.data=2",
         "--train.zero1=true", *tiny],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(x) for x in res.stdout.splitlines()
             if x.startswith('{"best_epoch"')]
    assert len(lines) == 1 and lines[0]["test"]["count"] > 0
    res = subprocess.run(
        [sys.executable, "-m", "surya_tpu_torch", "eval",
         str(tmp_path / "run" / "ckpt"), *tiny],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]


@pytest.mark.slow
def test_fact_parallel_forms_at_world_size_8_match_jax(tmp_path):
    """``MULTICHIP_r05.json``'s four FACT forms on 8 gloo ranks, each held
    to JAX's unsharded result within JAX's own bounds: sp8 ring attention
    (max error < 1e-4, finite gradients), pp4×dp2 FACT pipeline (logits
    1e-4, every gradient rtol 1e-4 / atol 1e-5), ep4×dp2 FACT-MoE (logits
    1e-4, 8 expert-sharded leaves) and pp2×tp2×dp2 + ZeRO-1 (loss 1e-6,
    gradients 1e-5, as ``tests/test_composed_parallel.py``; TP at JAX's
    test threshold of 1,024 elements)."""
    from torch_fact_reference import FACT, FACT_MOE, assert_grads, jax_fact

    from surya_tpu.parallel.ring_attention import (
        full_attention_reference as jax_full,
    )

    ring = {"qkv": (2, 32, 4, 16), "seed": 0, "world": 8,
            "cases": {"plain": {}, "grad": {"grad": True}}}
    dense = jax_fact(FACT, {"batch": 8, "seed": 2}, tmp_path / "fact.pt")
    moe = jax_fact(FACT_MOE, {"batch": 8, "seed": 2}, tmp_path / "moe.pt")
    jobs = [(W.ring_cases, ring),
            (W.fact_form, {**dense["spec"], "form": "pp", "microbatches": 4,
                           "mesh": {"pipe": 4, "data": 2}}),
            (W.fact_form, {**moe["spec"], "form": "ep", "train": 1,
                           "mesh": {"expert": 4, "data": 2}}),
            (W.fact_form, {**dense["spec"], "form": "pp", "microbatches": 4,
                           "mesh": {"pipe": 2, "model": 2, "data": 2},
                           "tp": True, "zero1": True})]
    sp8, pp, ep, comp = W.run(jobs, 8, tmp_path / "gloo")

    q, k, v = W.qkv_of(ring)
    want = np.asarray(jax_full(*(jnp.asarray(a) for a in (q, k, v))))
    for rank in sp8:
        assert float(np.abs(rank["plain"]["out"].numpy() - want).max()) < 1e-4
        assert all(torch.isfinite(g).all() for g in rank["grad"]["grads"])
    for rank in pp:
        rows = np.concatenate([dense["logits"][a:b] for a, b in rank["rows"]])
        assert float(np.abs(rank["logits"].numpy() - rows).max()) < 1e-4
        assert_grads(rank["grads"], dense["grads"], rtol=1e-4, atol=1e-5)
    for rank in ep:
        assert float(np.abs(rank["logits"].numpy() - moe["logits"]).max()) \
            < 1e-4
        assert rank["expert_leaves"] == 8
        assert rank["loss"] == pytest.approx(moe["loss"], abs=1e-5)
    for rank in comp:
        assert rank["loss"] == pytest.approx(dense["loss"], abs=1e-6)
        assert_grads(rank["grads"], dense["grads"], rtol=0, atol=1e-5)
        assert rank["moment_leaves"] > 0
        assert any(not torch.equal(rank["stepped"][k], rank["state"][k])
                   for k in rank["state"])
