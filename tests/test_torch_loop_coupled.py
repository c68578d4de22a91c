"""Both packages' ``train_and_evaluate`` coupled on the CPU at f32, with
dropout and augmentation on, over one small replay pack read through the
*packed* sources (so ``device_transform`` is on the path).

Both loops start from JAX's initial weights (``from_jax_variables``) and
read the same pack: ``data.replay.make_replay_spatial`` images at 72 px
packed by ``data.packed.pack_arrays`` and trained at 64 px (the campaign's
256 → 224 staging, scaled), or ``make_replay_temporal`` windows at 32 px
written by ``write_windows`` and packed by ``pack_sequences``.

**Arm (a), shared draws (tier-1).** The port is fed JAX's draws, injected
by monkeypatching inside the test:

- augmentation: the parameters JAX's ``augment_batch`` draws for the
  step's key, rebuilt with JAX's own key splits
  (``test_torch_augment._jax_params``), go through the port's
  ``apply_augment``;
- dropout: each step, before JAX's train step runs, the same forward is
  applied with ``capture_intermediates`` on the step's dropout key, and
  the output of every flax ``Dropout`` gives its mask (a unit is kept iff
  its output is non-zero; a unit whose input the ReLU already zeroed has
  no effect either way). The numerical MLP's mask replaces the uniforms
  ``flax_dropout`` draws and the head's mask replaces the fused head's
  Philox bits; the port's own thresholds and scaling run on them, and no
  dropout rate is set to 0.

Per-epoch train and validation losses must agree to 4e-3 relative over
3 epochs, the bound of ``test_torch_loop.py``'s coupled loop (float error
grows over coupled Adam steps), for ``experiment-fusion`` (the quadtree
model with its frozen trunk, numerical MLP and fused head) and
``ji-3dcnn`` (3-D convolutions, LSTM and fused head over a sequence
pack).

**Arm (b), each framework's own draws (``slow``).** Both loops start
from JAX's initial weights and epoch order of seed k; each draws its own
augmentation and dropout. ``experiment-fusion`` over 8 seeds: augmentation
only, dropout only, and both; for every epoch the port's mean train loss
over the seeds must lie within 2 standard errors of JAX's, the standard
error being that of the difference of the two means (the test prints one
standard error). ``ji-3dcnn``, whose only draw is its head's dropout,
over 8 seeds of 256 steps on a larger sequence pack: each seed's gap in
train and in validation loss, averaged over the epochs, must average to
within 2 standard errors of 0. ``tests/replay_diag.py`` runs the
full-size rows through both CLIs.
"""

import functools
import json

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from surya_tpu.core import config as jcfg
from surya_tpu.core.metrics import MetricsLogger as JLogger
from surya_tpu.core.prng import PRNG as JPRNG
from surya_tpu.data.packed import PackedDataSource as JPacked
from surya_tpu.data.packed import PackedSequenceSource as JPackedSeq
from surya_tpu.train import loop as jloop
from surya_tpu.train import steps as jsteps
from surya_tpu_torch.core.config import get_preset
from surya_tpu_torch.core.metrics import MetricsLogger
from surya_tpu_torch.core.prng import PRNG
from surya_tpu_torch.data import augment as taug
from surya_tpu_torch.data.packed import (
    PackedDataSource,
    PackedSequenceSource,
    pack_arrays,
    pack_sequences,
)
from surya_tpu_torch.data.replay import (
    make_replay_spatial,
    make_replay_temporal,
)
from surya_tpu_torch.data.sequences import write_windows
from surya_tpu_torch.models import common as tcommon
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.from_jax import from_jax_variables
from surya_tpu_torch.ops.cuda import fusion_head as tfh
from surya_tpu_torch.train import loop as tloop
from replay_diag import head_masks
from test_torch_augment import _jax_params
from torch_port_fixtures import one_torch_thread  # noqa: F401

RTOL = 4e-3
EPOCHS = 3
CLASSES = [f"pose_{i}" for i in range(8)]
SPLIT_SEEDS = {"train": 0, "valid": 1, "test": 2}
# per class: train, valid, test
COUNTS = {"train": 4, "valid": 2, "test": 2}


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """A spatial pack (72-px staging) and a T=5 sequence pack (32 px)."""
    root = tmp_path_factory.mktemp("coupled")
    spatial, windows = {}, {}
    for split, off in SPLIT_SEEDS.items():
        spatial[split] = make_replay_spatial(
            per_class=COUNTS[split], image_size=72, seed=1000 + off,
            amp_pow=0.5)
        windows[split] = make_replay_temporal(
            per_class=COUNTS[split], image_size=32, seq_len=5,
            seed=2000 + off, amp_pow=0.5)
    pack_arrays(str(root / "spatial_packed"), spatial, CLASSES)
    write_windows(str(root / "temporal"), windows, CLASSES)
    pack_sequences(str(root / "temporal"), str(root / "temporal_packed"),
                   seq_len=5, verbose=False)
    return root


def _configs(preset, packs, seed, **extra):
    """The port's and JAX's config of ``preset`` on the small pack."""
    ov = {"model.compute_dtype": "float32", "train.epochs": str(EPOCHS),
          "train.seed": str(seed), "train.early_stop_patience": "0",
          "data.batch_size": "16", "train.checkpoint_dir": "unused"}
    if preset == "ji-3dcnn":
        ov.update({"data.seq_root": str(packs / "temporal"),
                   "data.packed_dir": str(packs / "temporal_packed"),
                   "data.image_size": "32"})
    else:
        ov.update({"data.packed_dir": str(packs / "spatial_packed"),
                   "data.image_size": "64"})
    ov.update(extra)
    cfg, ref = get_preset(preset).override(ov), jcfg.get_preset(
        preset).override(ov)
    assert cfg.to_dict() == ref.to_dict()
    return cfg, ref


def _sources(cfg, ref, seed):
    if cfg.model.name == "ji_3dcnn":
        return (PackedSequenceSource(cfg.data, seed=seed),
                JPackedSeq(ref.data, seed=seed))
    return (PackedDataSource(cfg.data, seed=seed),
            JPacked(ref.data, seed=seed))


def _record_jax_init(monkeypatch, initial):
    """JAX's loop builds its train state with ``model.init`` under
    ``jit`` (eager flax init costs seconds per model) and leaves its
    initial variables in ``initial``."""
    def create(model, cfg, rng, sample):
        images, feats, _ = sample
        variables = jax.jit(functools.partial(model.init, train=False))(
            {"params": rng}, images, feats)
        params = variables["params"]
        tx = jsteps.make_optimizer(cfg, params)
        state = jsteps.TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=variables.get("batch_stats", {}),
            opt_state=tx.init(params))
        initial.update(params=jax.tree.map(np.asarray, state.params),
                       batch_stats=jax.tree.map(np.asarray,
                                                state.batch_stats))
        return state, tx

    monkeypatch.setattr(jloop, "create_train_state", create)


def _from(variables):
    def build(model_cfg, image_size=224, seed=0):
        model = get_model(model_cfg, image_size=image_size, seed=seed)
        model.load_state_dict(from_jax_variables(variables), strict=True)
        return model
    return build


def _losses(summary):
    return np.array([[h["train_loss"], h["val_loss"]]
                     for h in summary["history"]])


def _run_jax(ref, jdata, mesh, monkeypatch, capture=True):
    """JAX's loop → (summary, initial variables, per-step dropout masks).
    With ``capture`` each step first reads its masks off a
    ``capture_intermediates`` forward on the step's dropout key:
    ``{"head": (B, H), "mlp": [(B, U), ...]}`` by step."""
    masks, initial = [], {}
    _record_jax_init(monkeypatch, initial)
    if capture:
        make = jsteps.make_train_step

        def capturing(model, tx, cfg, *args, **kw):
            step = make(model, tx, cfg, *args, **kw)

            @jax.jit
            def dropped(params, batch_stats, images, feats, rng):
                _, cols = model.apply(
                    {"params": params, "batch_stats": batch_stats}, images,
                    feats, train=True, rngs={"dropout": rng},
                    mutable=["batch_stats", "intermediates"],
                    capture_intermediates=lambda m, _: isinstance(
                        m, fnn.Dropout))
                return cols["intermediates"]

            def run(state, batch, rng):
                found = {"head": None, "mlp": []}
                inter = dropped(state.params, state.batch_stats, batch[0],
                                batch[1], rng)
                for path, out in jax.tree_util.tree_flatten_with_path(
                        inter)[0]:
                    keep = np.asarray(out) != 0
                    if path[0].key == "classifier":
                        found["head"] = keep
                    else:
                        found["mlp"].append(keep)
                masks.append(found)
                return step(state, batch, rng)

            return run

        monkeypatch.setattr(jloop, "make_train_step", capturing)
    summary = jloop.train_and_evaluate(ref, jdata, mesh=mesh,
                                       logger=JLogger(echo=False),
                                       checkpoints=False)
    return summary, initial, masks


def _feed_jax_draws(monkeypatch, cfg, masks):
    """The port's draws replaced by JAX's: the augmentation parameters of
    the step's JAX key, and the dropout masks JAX's forward used. The
    step is read off the generator the loop hands over (its seed is
    ``PRNG.seed_of(step, name)``)."""
    prng, jprng = PRNG(cfg.train.seed), JPRNG(cfg.train.seed)
    steps = 64 + len(masks)
    aug_step = {prng.seed_of(s, "augment"): s for s in range(steps)}
    drop_step = {prng.seed_of(s, "dropout"): s for s in range(steps)}
    now = {"step": None, "mlp": 0}

    def draw(generator, b, h, w, *args):
        """JAX's parameters for the step's key (the draw's own ranges)."""
        key = jprng.named(aug_step[generator.initial_seed()], "augment")
        return _jax_params(key, b, h, w, *args)

    real_generator = tcommon.dropout_generator

    def dropout_generator(generator, rate, training):
        g = real_generator(generator, rate, training)
        if g is not None:
            step = drop_step[g.initial_seed()]
            if step != now["step"]:
                now.update(step=step, mlp=0)
        return g

    def draw_rows(draw, n, *rest):
        """The uniforms ``flax_dropout`` compares with the rate: 1 where
        JAX kept the unit, 0 where it dropped it."""
        keep = masks[now["step"]]["mlp"][now["mlp"]]
        assert keep.shape == (n, *rest)
        now["mlp"] += 1
        return torch.from_numpy(keep.astype(np.float32))

    def philox_bits(seed, rows, units, device=None, row_offset=0):
        keep = torch.from_numpy(masks[now["step"]]["head"])
        assert keep.shape == (rows, units) and row_offset == 0
        return torch.where(keep, 2 ** 32 - 1, 0).to(torch.int64)

    monkeypatch.setattr(taug, "draw_augment_params", draw)
    monkeypatch.setattr(tcommon, "dropout_generator", dropout_generator)
    monkeypatch.setattr(tcommon, "draw_rows", draw_rows)
    monkeypatch.setattr(tfh, "philox_bits", philox_bits)


def run_coupled(cfg, ref, pdata, jdata, mesh, monkeypatch):
    """Arm (a): JAX's loop with its dropout masks captured, then the
    port's fed JAX's draws, from JAX's initial weights → (the port's
    summary, JAX's summary, the masks by step)."""
    want, variables, masks = _run_jax(ref, jdata, mesh, monkeypatch)
    _feed_jax_draws(monkeypatch, cfg, masks)
    monkeypatch.setattr(tloop, "get_model", _from(variables))
    got = tloop.train_and_evaluate(cfg, pdata, logger=MetricsLogger(
        echo=False), checkpoints=False, device="cpu")
    return got, want, masks


@pytest.mark.parametrize("preset", ["experiment-fusion", "ji-3dcnn"])
def test_port_fed_jax_draws_tracks_jax_loop(preset, packs, mesh1,
                                            monkeypatch):
    """Arm (a): dropout and augmentation on, the port fed JAX's draws."""
    cfg, ref = _configs(preset, packs, seed=0)
    assert cfg.model.dropout is None   # the families' own rates, not 0
    pdata, jdata = _sources(cfg, ref, 0)
    got, want, masks = run_coupled(cfg, ref, pdata, jdata, mesh1,
                                   monkeypatch)
    assert len(masks) == EPOCHS * len(list(jdata.train_batches(1)))
    # every step drew a head mask with units dropped and kept
    heads = np.stack([m["head"] for m in masks])
    assert 0.2 < heads.mean() < 0.6
    if preset == "experiment-fusion":
        assert all(len(m["mlp"]) == 1 for m in masks)
        assert ref.data.augment
    else:
        # the stand-in that ``replay_diag.py --jax-masks`` draws from: it
        # keeps every unit JAX kept (and the ReLU passed), and half of all
        drawn = head_masks(JPRNG(0), len(masks), *heads.shape[1:], 0.5)
        assert not (heads & ~drawn).any() and 0.45 < drawn.mean() < 0.55
    g, w = _losses(got), _losses(want)
    assert g.shape == w.shape == (EPOCHS, 2)
    np.testing.assert_allclose(g, w, rtol=RTOL)
    np.testing.assert_allclose(got["test"]["loss"], want["test"]["loss"],
                               rtol=RTOL)


# --- arm (b): each framework's own draws -------------------------------------

SEEDS = 8
ARMS = {"augment": {"model.dropout": "0.0"},
        "dropout": {"data.augment": "false"},
        "both": {}}


# ji-3dcnn's only draw is its fused head's dropout. 16 clips per class at
# batch 8 for 16 epochs is 256 steps: the loss falls from 2.08 to about
# 1.80, as the full-size row's does over its first 4 epochs.
JI_COUNTS = {"train": 16, "valid": 8, "test": 2}
JI_RUN = {"train.epochs": "16", "data.batch_size": "8"}


def write_ji_pack(root):
    """The ``ji-3dcnn`` arm's sequence pack (32 px, T=5) under ``root``."""
    windows = {split: make_replay_temporal(
        per_class=JI_COUNTS[split], image_size=32, seq_len=5,
        seed=2000 + off, amp_pow=0.5) for split, off in SPLIT_SEEDS.items()}
    write_windows(str(root / "temporal"), windows, CLASSES)
    pack_sequences(str(root / "temporal"), str(root / "temporal_packed"),
                   seq_len=5, verbose=False)
    return root


@pytest.fixture(scope="module")
def ji_pack(tmp_path_factory):
    return write_ji_pack(tmp_path_factory.mktemp("ji"))


def own_draws(preset, pack, mesh, **extra):
    """Per seed, both loops from JAX's initial weights with their own
    draws → (port, JAX) per-epoch (train, val) losses, (seeds, epochs, 2)."""
    port, ref_losses = [], []
    for seed in range(SEEDS):
        cfg, ref = _configs(preset, pack, seed, **extra)
        pdata, jdata = _sources(cfg, ref, seed)
        with pytest.MonkeyPatch.context() as mp:
            want, variables, _ = _run_jax(ref, jdata, mesh, mp,
                                          capture=False)
            mp.setattr(tloop, "get_model", _from(variables))
            got = tloop.train_and_evaluate(
                cfg, pdata, logger=MetricsLogger(echo=False),
                checkpoints=False, device="cpu")
        port.append(_losses(got))
        ref_losses.append(_losses(want))
    return np.array(port), np.array(ref_losses)


def check_train_loss(name, port, ref_losses):
    """The port's mean train loss per epoch within 2 standard errors of
    the difference of the two means. Prints both means and one standard
    error per epoch, and the mean per-seed validation-loss gap with its
    standard error (the seeds share JAX's weights and order)."""
    port_t, ref_t = port[..., 0], ref_losses[..., 0]
    se = np.sqrt(port_t.var(0, ddof=1) / SEEDS + ref_t.var(0, ddof=1) / SEEDS)
    gap = np.abs(port_t.mean(0) - ref_t.mean(0))
    val = port[..., 1] - ref_losses[..., 1]
    print(json.dumps({"arm": name, "port": port_t.mean(0).tolist(),
                      "jax": ref_t.mean(0).tolist(), "se": se.tolist(),
                      "val_gap": val.mean(0).tolist(),
                      "val_gap_se": (val.std(0, ddof=1)
                                     / np.sqrt(SEEDS)).tolist()}))
    assert (gap <= 2 * se).all(), (port_t.mean(0), ref_t.mean(0), se)


@pytest.mark.slow
@pytest.mark.parametrize("arm", list(ARMS))
def test_own_draws_train_like_jax(arm, packs, mesh1):
    """Arm (b): the port's mean train loss per epoch over 8 seeds within
    2 standard errors of JAX's."""
    check_train_loss(arm, *own_draws("experiment-fusion", packs, mesh1,
                                     **ARMS[arm]))


@pytest.mark.slow
def test_ji3dcnn_own_head_dropout_trains_like_jax(ji_pack, mesh1):
    """Arm (b) for ``ji-3dcnn``, whose only draw is the fused head's
    dropout (Philox bits in the port, flax's ``Dropout`` in JAX), over 8
    seeds and 256 steps. Each seed's gap (port − JAX) in train and in
    validation loss, averaged over the 16 epochs, must average to within
    2 standard errors of 0 over the seeds. One statistic per loss: a
    2-standard-error bound on each of 16 epochs would fail by chance
    about half the time."""
    port, ref_losses = own_draws("ji-3dcnn", ji_pack, mesh1, **JI_RUN)
    per_seed = (port - ref_losses).mean(1)            # (seeds, train/val)
    mean = per_seed.mean(0)
    se = per_seed.std(0, ddof=1) / np.sqrt(SEEDS)
    print(json.dumps({"arm": "ji-3dcnn", "port": port.mean(0).tolist(),
                      "jax": ref_losses.mean(0).tolist(),
                      "gap": mean.tolist(), "se": se.tolist()}))
    assert (np.abs(mean) <= 2 * se).all(), (mean, se)
