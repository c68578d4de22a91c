"""The port's train/eval steps (``surya_tpu_torch/train/steps.py``) against
``surya_tpu/train/steps.py`` on the CPU at f32: same initial weights
(JAX's, through ``from_jax_variables``), same numpy batch, dropout 0.

- a 25-step loss trajectory against JAX ``make_train_step`` with the
  tolerances of ``tests/test_training_dynamics.py`` (first loss 1e-4, the
  trajectory 4e-3: float error grows over coupled Adam steps);
- ``grad_accum=2`` against JAX; the eval step's masking and confusion
  matrix against JAX; the global-norm clip against optax;
- the freeze mask, the NaN guard, remat and the dropout stream.
"""

import copy
import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from surya_tpu.core import config as jcfg
from surya_tpu.models import get_model as jax_get_model
from surya_tpu.train import steps as jsteps
from surya_tpu_torch.core.config import (
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.from_jax import from_jax_variables
from surya_tpu_torch.train import steps as tsteps
from torch_port_fixtures import one_torch_thread  # noqa: F401

IMG, B, CLASSES = 64, 4, 8


def _cfg(**train):
    model = dict(name="quadtree", num_classes=CLASSES,
                 compute_dtype="float32", dropout=0.0, use_pallas=True)
    train = dict(lr=1e-4, weight_decay=1e-4, **train)
    port = Config(model=ModelConfig(**model), data=DataConfig(batch_size=B),
                  train=TrainConfig(**train))
    ref = jcfg.Config(model=jcfg.ModelConfig(**model),
                      data=jcfg.DataConfig(batch_size=B),
                      train=jcfg.TrainConfig(**train))
    assert port.to_dict() == ref.to_dict()
    return port, ref


def _batch(n=B, seed=42):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, IMG, IMG, 3), scale=0.5).astype(np.float32),
            rng.normal(size=(n, 47)).astype(np.float32),
            rng.integers(0, CLASSES, size=(n,)).astype(np.int32))


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(port_cfg, ref_cfg, batch):
    """A JAX train state and the port's, from the same weights."""
    jm = jax_get_model(ref_cfg.model)
    jstate, jtx = jsteps.create_train_state(jm, ref_cfg, jax.random.key(0),
                                            batch)
    tm = get_model(port_cfg.model, image_size=IMG)
    tm.load_state_dict(from_jax_variables(
        {"params": _to_np(jstate.params),
         "batch_stats": _to_np(jstate.batch_stats)}), strict=True)
    tstate, ttx = tsteps.create_train_state(tm, port_cfg, device="cpu")
    return (jm, jstate, jtx), (tm, tstate, ttx)


def _port_state(cfg, seed=0, image_size=IMG):
    model = get_model(cfg.model, image_size=image_size, seed=seed)
    state, tx = tsteps.create_train_state(model, cfg, device="cpu")
    return model, state, tx


def test_loss_trajectory_matches_jax_train_step():
    port_cfg, ref_cfg = _cfg()
    batch = _batch()
    (jm, jstate, jtx), (tm, tstate, ttx) = _pair(port_cfg, ref_cfg, batch)
    jstep = jsteps.make_train_step(jm, jtx, ref_cfg)
    tstep = tsteps.make_train_step(tm, ttx, port_cfg)
    want, got, acc = [], [], []
    for i in range(25):
        jstate, jmet = jstep(jstate, batch, jax.random.key(i))
        tstate, tmet = tstep(tstate, batch)
        want.append(float(jmet["loss"]))
        got.append(float(tmet["loss"]))
        acc.append((float(tmet["accuracy"]), float(jmet["accuracy"])))
    want, got = np.array(want), np.array(got)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=4e-3, atol=4e-3)
    assert want[-1] < want[0] and got[-1] < got[0]
    assert tstate.step == 25 == int(jstate.step)
    assert acc[-1][0] == acc[-1][1]
    # after 25 steps the BN running statistics still agree
    moved = from_jax_variables({"batch_stats": _to_np(jstate.batch_stats)})
    state = tm.state_dict()
    for name, w in moved.items():
        np.testing.assert_allclose(state[name].numpy(), w.numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=name)


def test_grad_accum_matches_jax():
    """Two microbatches: BN statistics move twice in order, gradients and
    loss are averaged, one AdamW update."""
    port_cfg, ref_cfg = _cfg(grad_accum=2)
    batch = _batch(n=8)
    (jm, jstate, jtx), (tm, tstate, ttx) = _pair(port_cfg, ref_cfg, batch)
    start = {k: v.detach().clone() for k, v in tm.named_parameters()}
    jstate, jmet = jsteps.make_train_step(jm, jtx, ref_cfg)(
        jstate, batch, jax.random.key(0))
    tstate, tmet = tsteps.make_train_step(tm, ttx, port_cfg)(tstate, batch)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    assert float(tmet["accuracy"]) == float(jmet["accuracy"])
    state = tm.state_dict()
    for name, w in from_jax_variables(
            {"batch_stats": _to_np(jstate.batch_stats)}).items():
        np.testing.assert_allclose(state[name].numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # AdamW's first step is lr * g / (|g| + eps): a gradient within float
    # noise of 0 may step the other way, so every parameter is held to two
    # steps' size and, outside the badly conditioned trunk, the update as a
    # whole to 5e-2 relative L2.
    lr = port_cfg.train.lr
    for name, w in from_jax_variables(
            {"params": _to_np(jstate.params)}).items():
        got = state[name]
        assert (got - w).abs().max() <= 2.01 * lr, name
        if not name.startswith("trunk."):
            du, dw = got - start[name], w - start[name]
            assert (du - dw).norm() / dw.norm() < 5e-2, name


def test_grad_accum_needs_a_divisible_batch():
    port_cfg, _ = _cfg(grad_accum=3)
    model, state, tx = _port_state(port_cfg)
    with pytest.raises(ValueError, match="divisible"):
        tsteps.make_train_step(model, tx, port_cfg)(state, _batch())


def test_eval_step_masks_padding_and_matches_jax():
    port_cfg, ref_cfg = _cfg()
    images, feats, labels = _batch(n=6)
    labels = labels.copy()
    labels[[1, 4]] = -1                             # padding rows
    batch = (images, feats, labels)
    (jm, jstate, _), (tm, _, _) = _pair(port_cfg, ref_cfg, batch)
    want = jsteps.make_eval_step(jm, CLASSES, 0.1)(
        jstate.params, jstate.batch_stats, batch)
    got = tsteps.make_eval_step(tm, CLASSES, 0.1)(batch)
    assert int(got["count"]) == 4 == int(want["count"])
    assert int(got["correct"]) == int(want["correct"])
    np.testing.assert_allclose(float(got["loss_sum"]),
                               float(want["loss_sum"]), rtol=1e-4)
    np.testing.assert_array_equal(got["confusion"].numpy(),
                                  np.asarray(want["confusion"]))
    assert got["confusion"].sum() == 4 and not tm.training
    # a padded row changes nothing, whatever it holds
    images2 = images.copy()
    images2[1] = 9.0
    again = tsteps.make_eval_step(tm, CLASSES, 0.1)((images2, feats, labels))
    assert float(again["loss_sum"]) == float(got["loss_sum"])


@pytest.mark.parametrize("scale", [0.01, 10.0])   # below and above the clip
def test_clip_matches_optax_global_norm(scale):
    rng = np.random.default_rng(1)
    grads = [(rng.normal(size=s) * scale).astype(np.float32)
             for s in ((3, 4), (7,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    tsteps.clip_by_global_norm_(got, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_clip_is_applied_before_the_update():
    """With a clip far below the gradient norm the first AdamW step is
    unchanged in direction (Adam normalises), so compare the first moment:
    0.1 * clipped gradient has global norm 0.1 * clip."""
    cfg, _ = _cfg(grad_clip=1e-3)
    model, state, tx = _port_state(cfg)
    tsteps.make_train_step(model, tx, cfg)(state, _batch())
    moments = [tx.state[p]["exp_avg"] for p in tx.param_groups[0]["params"]]
    norm = torch.sqrt(sum((m ** 2).sum() for m in moments))
    np.testing.assert_allclose(float(norm), 0.1 * 1e-3, rtol=1e-4)


def test_trainable_mask_follows_jax_rules():
    port_cfg, ref_cfg = _cfg()
    jm = jax_get_model(ref_cfg.model)
    images, feats, _ = _batch()
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(images), jnp.asarray(feats)))
    tm = get_model(port_cfg.model, image_size=IMG)
    for freeze in (False, True):
        want = jsteps.trainable_mask(shapes["params"], "quadtree", freeze)
        want = from_jax_variables({"params": jax.tree.map(
            lambda t: np.full((1, 1, 1, 1), t), want)})
        got = tsteps.trainable_mask(tm, "quadtree", freeze)
        assert set(got) == set(want)
        assert all(got[k] == bool(want[k].flatten()[0]) for k in got)
    assert not any(v for k, v in got.items() if k.startswith("trunk."))
    assert all(v for k, v in got.items() if not k.startswith("trunk."))

    class Fake(torch.nn.Module):   # the partial-unfreeze families come later
        def __init__(self):
            super().__init__()
            self.trunk = torch.nn.ModuleDict({
                "layer3_block0": torch.nn.Linear(2, 2),
                "layer4_block0": torch.nn.Linear(2, 2)})
            self.head = torch.nn.Linear(2, 2)

    mask = tsteps.trainable_mask(Fake(), "resnet3d_video", True)
    assert mask == {"trunk.layer3_block0.weight": False,
                    "trunk.layer3_block0.bias": False,
                    "trunk.layer4_block0.weight": True,
                    "trunk.layer4_block0.bias": True,
                    "head.weight": True, "head.bias": True}
    assert not any(v for k, v in tsteps.trainable_mask(
        Fake(), "quadtree", True).items() if k.startswith("trunk."))


def test_frozen_trunk_keeps_weights_and_moves_bn_statistics():
    cfg, _ = _cfg()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, freeze_backbone=True))
    model, state, tx = _port_state(cfg)
    before = copy.deepcopy(model.state_dict())
    in_opt = {id(p) for g in tx.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        frozen = name.startswith("trunk.")
        assert p.requires_grad != frozen and (id(p) in in_opt) != frozen
    tsteps.make_train_step(model, tx, cfg)(state, _batch())
    after = model.state_dict()
    for name in before:
        same = torch.equal(before[name], after[name])
        if "running_" in name:       # a frozen spatial trunk's BN trains on
            assert not same, name
        elif name.startswith("trunk."):
            assert same, name
        else:
            assert not same, name
    assert all(p.grad is None for p in model.trunk.parameters())


def test_nan_guard_keeps_params_optimizer_and_bn_stats():
    cfg, _ = _cfg()
    model, state, tx = _port_state(cfg)
    step = tsteps.make_train_step(model, tx, cfg)
    images, feats, labels = _batch()
    step(state, (images, feats, labels))            # a good step first
    before = copy.deepcopy(model.state_dict())
    opt_before = copy.deepcopy(tx.state_dict())
    bad = images.copy()
    bad[0, 0, 0, 0] = np.nan
    state, metrics = step(state, (bad, feats, labels))
    assert not np.isfinite(float(metrics["loss"])) and state.step == 2
    for name, v in model.state_dict().items():
        assert torch.equal(v, before[name]), name
    for a, b in zip(tx.state_dict()["state"].values(),
                    opt_before["state"].values()):
        assert all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
                   for k in a)
    state, metrics = step(state, (images, feats, labels))   # and recovers
    assert np.isfinite(float(metrics["loss"])) and state.step == 3

    off = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, nan_guard=False))
    model, state, tx = _port_state(off)
    tsteps.make_train_step(model, tx, off)(state, (bad, feats, labels))
    assert not all(bool(torch.isfinite(p).all()) for p in model.parameters())


def test_remat_step_equals_the_plain_step_with_dropout():
    """Same seed: the recomputation draws the same dropout masks and the BN
    statistics move once."""
    results = []
    for remat in (False, True):
        cfg, _ = _cfg(remat=remat)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, dropout=0.5))
        model, state, tx = _port_state(cfg)
        step = tsteps.make_train_step(model, tx, cfg)
        losses = [float(step(state, _batch())[1]["loss"]) for _ in range(2)]
        results.append((losses, model.state_dict()))
    (loss_a, sd_a), (loss_b, sd_b) = results
    assert loss_a == loss_b
    for name in sd_a:
        np.testing.assert_allclose(sd_a[name].numpy(), sd_b[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_dropout_stream_is_seeded_explicit_and_not_the_global_one():
    cfg, _ = _cfg()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dropout=0.5))

    def run(rng, steps=2, generator=None):
        model = get_model(cfg.model, image_size=IMG)
        state, tx = tsteps.create_train_state(model, cfg, rng, device="cpu")
        step = tsteps.make_train_step(model, tx, cfg)
        before = torch.get_rng_state()   # (nn.Linear's constructor draws)
        losses = [float(step(state, _batch(), generator)[1]["loss"])
                  for _ in range(steps)]
        assert torch.equal(before, torch.get_rng_state())
        return losses

    a, b, c = run(1), run(1), run(2)
    assert a == b and a != c
    assert run(None) == run(cfg.train.seed)   # default: the config's seed
    # a generator handed to the step overrides the state's stream
    assert run(1, 1, torch.Generator().manual_seed(2))[0] == c[0]


def test_sharded_variants_name_their_roadmap_item():
    """zero1 and fsdp on one device (no torchrun) take the single-device
    step, as JAX's sharding over a one-device mesh does; a mesh of more
    than one device outside torchrun names it, the ('data', 'model',
    'seq') ones and the grids of other axes alike
    (tests/test_torch_parallel.py runs the sharded steps)."""
    from surya_tpu_torch.core.mesh import MeshSpec, create_mesh

    batch = _batch()
    losses = []
    for train in ({}, {"zero1": True}, {"fsdp": True}):
        cfg, _ = _cfg(**train)
        model, state, tx = _port_state(cfg)
        assert isinstance(tx, torch.optim.AdamW)
        step = tsteps.make_train_step(model, tx, cfg,
                                      mesh=create_mesh(device="cpu"))
        losses.append(float(step(state, batch)[1]["loss"]))
    assert losses[0] == losses[1] == losses[2]
    with pytest.raises(RuntimeError, match="torchrun"):
        create_mesh(MeshSpec(data=2), device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        create_mesh({"pipe": 2, "data": 1}, device="cpu")
    one = create_mesh({"expert": 1, "data": 1}, device="cpu")
    assert not one.distributed and one.shape["expert"] == 1


def test_optimizer_settings_and_learning_rate_access():
    cfg, _ = _cfg()
    model, state, tx = _port_state(cfg)
    assert isinstance(tx, torch.optim.AdamW) and state.optimizer is tx
    (group,) = tx.param_groups        # one group: everything decays
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == cfg.train.weight_decay
    assert len(group["params"]) == len(list(model.parameters()))
    assert tsteps.get_learning_rate(tx) == pytest.approx(1e-4)
    tsteps.set_learning_rate(tx, 5e-5)
    assert tsteps.get_learning_rate(tx) == pytest.approx(5e-5)
    assert state.generator.device.type == "cpu" and state.step == 0


def test_entry_point_defaults_to_the_card():
    cfg, _ = _cfg()
    if torch.cuda.is_available():
        pytest.skip("checks the error raised without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsteps.create_train_state(get_model(cfg.model, image_size=IMG), cfg)
