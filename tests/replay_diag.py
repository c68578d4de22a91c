"""Replay rows trained through either package's CLI, so that the port's
training is held against JAX's own loop off the TPU, on one pack.

    python tests/replay_diag.py --side jax|port --preset experiment-fusion \\
        --seeds 0,1,2 [--epochs 15] [--root build/replay224] \\
        [--out runs/torch_replay/diag] [--set data.augment=false --tag noaug]
        [--device card] [--init-from DIR [--jax-masks | --plain-head]]

``--root`` is the replay set that ``python -m surya_tpu_torch.bench.replay
--phase data`` writes (byte-equal packs from either CLI). Each run goes to
``OUT/<side>_<where>/<preset>_s<seed>/`` (``<preset>-<epochs>ep-<tag>`` with
``--epochs`` and ``--tag``; ``--set`` adds config overrides, and needs
``--tag``): the CLI's ``config.json`` and ``metrics.jsonl``, and a
``result.json`` in the campaign's layout (``bench.replay.run_job``'s) with
the card, or the host in place of one. ``--side jax`` runs ``python -m
surya_tpu train`` with ``JAX_PLATFORMS=cpu`` (``jax_cpu``); ``--side port``
runs ``python -m surya_tpu_torch train --device cpu`` (``port_cpu``), or on
the card with ``--device card`` (``port_card``). A run with a test result
is skipped. Every run is at f32.

``--side jax --save-inits DIR`` writes JAX's initial variables of each seed,
as its loop makes them, to ``DIR/<preset>_s<seed>_keys.npz`` in key form
(each draw's threefry key and scale, a few hundred kB where the variables
are up to 130 MB; rebuilt bit for bit through ``DIR/``:data:`TN_TABLE`,
checked by a digest), and JAX's draws of every step to
``DIR/<preset>_s<seed>_masks.npz``: the fused head's dropout masks
(``flax`` ``Dropout`` under ``classifier`` on the step's ``dropout`` key,
the draw JAX's replay made with ``use_pallas: false``), and for
``standard_multimodal`` the numerical MLP's masks and the augmentation
parameters. ``--side port
--init-from DIR`` starts the port's CLI run from those weights (the side
gains ``_jaxinit``; ``DIR/<preset>_s<seed>.npz`` is written from the key
form first if missing), so the two loops differ only in their draws and
arithmetic; with ``--jax-masks`` the port also takes JAX's draws (the
side is ``_jaxdraws``): the head drops JAX's units (the plain head) and,
for ``standard_multimodal``, the numerical MLP drops JAX's units and the
augmentation takes JAX's parameters (``augment_batch``'s draw for the
step's key, saved by ``--save-inits``), so only the arithmetic differs.
Any other dropout draw raises. With ``--plain-head`` instead (the side
gains ``_plainhead``) the port keeps its own draws but runs the fused
head's plain version on the card, with the kernel's own mask: paired
with the ``_jaxinit`` run of a seed, only the head's arithmetic differs.

    python tests/replay_diag.py --coupled ji-3dcnn --epochs 1

runs arm (a) of ``tests/test_torch_loop_coupled.py`` on the full replay
set on the CPU: JAX's ``train_and_evaluate`` with its dropout masks
captured and its augmentation run eagerly (the function as written:
jitted on the CPU it gets some pixels' hue wrong), then the port's fed
JAX's augmentation parameters and masks, both from JAX's initial
weights; prints both loss curves, epoch by epoch and step by step, as
one JSON object.

    python tests/replay_diag.py --curves experiment-fusion [--epochs 8 --tag bf16]

prints, as one JSON object, the row's per-epoch train and validation
losses, seed by seed and their mean, from JAX's TPU runs
(``runs/reference_replay``), the port's card runs (``runs/torch_replay``)
and the runs under ``OUT`` (``--epochs``/``--tag`` name a variant).

    python tests/replay_diag.py --mask-law [--preset comparative-vgg16] \
        --seeds 0,1,...,39

trains ``ji-3dcnn`` (or a ``comparative-*`` row) on a small pack inside
the port, each seed from JAX's initial weights twice, with JAX's draws
and with the port's own, and prints the loss gaps (:func:`mask_law`).

    python tests/replay_diag.py --table

writes :func:`vs_jax_cpu` of the runs under ``OUT`` into the campaign's
``table.json`` (beside ``OUT``) as its ``vs_jax_cpu`` block.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import hashlib
import json
import os
import platform
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from surya_tpu_torch.bench.replay import (  # noqa: E402
    JAX_REPLAY,
    T4,
    TEMPORAL_PRESETS,
    _last_json,
    bands,
    card_record,
    load_result,
    overlap,
)

INIT_ENV = "REPLAY_DIAG_INIT"    # the .npz a ``--init-from`` child loads
MASKS_ENV = "REPLAY_DIAG_MASKS"  # the draws a ``--jax-masks`` child uses
PLAIN_ENV = "REPLAY_DIAG_PLAIN_HEAD"   # set: a ``--plain-head`` child
REFERENCE = ("jax_cpu", "jax_tpu")   # what every other side is paired with


def host_record() -> dict:
    model = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return {"card": None, "nvidia_smi": None,
            "host": f"{model}, {os.cpu_count()} logical CPUs"}


def data_overrides(preset: str, root: str) -> dict:
    if preset in TEMPORAL_PRESETS:
        t = 4 if preset in T4 else 5
        return {"data.seq_root": f"{root}/temporal",
                "data.packed_dir": f"{root}/temporal_packed_t{t}"}
    return {"data.data_root": f"{root}/spatial",
            "data.packed_dir": f"{root}/spatial_packed"}


def save_jax_inits(preset: str, seeds, overrides: dict, out_dir: str):
    """JAX's initial variables of each seed, as ``train_and_evaluate``
    makes them (``create_train_state`` on the first batch's transform),
    in the key form of :func:`encode_keys` (``DIR/<preset>_s<seed>_keys.npz``,
    checked here to rebuild them bit for bit; :func:`materialize` writes
    the ``/``-keyed ``.npz`` of ``core.checkpoint.load_params``), and
    JAX's draws of every step of every epoch (``_masks.npz``): the fused
    head's dropout masks and, where the model has them, the numerical
    MLP's masks and the augmentation parameters."""
    import jax

    from surya_tpu.__main__ import _build_data
    from surya_tpu.core.config import get_preset
    from surya_tpu.core.prng import PRNG
    from surya_tpu.models import TEMPORAL_MODELS, get_model
    from surya_tpu.train.steps import create_train_state

    os.makedirs(out_dir, exist_ok=True)
    table = os.path.join(out_dir, TN_TABLE)
    if not os.path.exists(table):
        bits = truncated_normal_table().view(np.int32)
        np.savez_compressed(table, first=bits[:1], step=np.diff(bits))
    for seed in seeds:
        cfg = get_preset(preset).override(
            {**overrides, "train.seed": str(seed)})
        data, prng, model = _build_data(cfg), PRNG(seed), get_model(cfg.model)
        first = next(iter(data.train_batches(0)))
        sample_shape = first[0].shape[:3]
        sample = data.device_transform("train", prng.named(0, "augment"),
                                       first)
        with recorded_draws() as draws:
            state, _ = create_train_state(model, cfg, prng.named(0, "init"),
                                          sample)
        flat = {}
        for col in ("params", "batch_stats"):
            for path, v in jax.tree_util.tree_flatten_with_path(
                    getattr(state, col))[0]:
                flat["/".join([col] + [p.key for p in path])] = np.asarray(v)
        stem = os.path.join(out_dir, f"{preset}_s{seed}")
        np.savez(stem + "_keys.npz", digest=digest(flat),
                 **encode_keys(flat, draws))
        decode_keys(stem + "_keys.npz")   # raises unless bit-equal
        rate = FIXED_RATES.get(cfg.model.name,
                               getattr(model, "dropout", None))
        if rate is None:
            continue
        sizes = [len(b[2]) for b in data.train_batches(1)]
        assert set(sizes) == {cfg.data.batch_size}, sizes
        steps = cfg.train.epochs * len(sizes)
        saved = {"seed": seed, "rate": rate}
        for site in ("classifier", "numerical_mlp"):
            name = f"params/{site}/fc1/kernel"
            if name not in flat:
                continue
            units = flat[name].shape[1]
            keep = head_masks(prng, steps, cfg.data.batch_size, units, rate,
                              module=site)
            prefix = "" if site == "classifier" else "mlp_"
            saved.update({f"{prefix}bits": np.packbits(keep, axis=-1),
                          f"{prefix}units": units})
        if cfg.data.augment and cfg.model.name not in TEMPORAL_MODELS:
            saved.update(augment_draws(cfg, prng, steps, sample_shape))
        np.savez(stem + "_masks.npz", **saved)


# JAX's models whose dropout rates are fixed in the module, not a field
FIXED_RATES = {"standard_multimodal": 0.5}


def augment_draws(cfg, prng, steps: int, shape) -> dict:
    """JAX's augmentation parameters of every step (``augment_batch``'s
    draw for the step's ``augment`` key, as the port's
    ``draw_augment_params`` returns them), stacked as ``aug/<name>``,
    and the (B, H, W) they were drawn for as ``aug_shape``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_augment import _jax_params

    d = cfg.data
    per_step = [_jax_params(prng.named(s, "augment"), *shape,
                            scale_min=d.rrc_scale_min,
                            hflip_prob=d.hflip_prob,
                            jitter=(d.jitter_brightness, d.jitter_contrast,
                                    d.jitter_saturation, d.jitter_hue),
                            rotation_deg=d.rotation_deg,
                            blur_sigma=(d.blur_sigma_min, d.blur_sigma_max))
                for s in range(steps)]
    out = {f"aug/{k}": np.stack([p[k].numpy() for p in per_step])
           for k, v in per_step[0].items() if v is not None}
    out["aug_shape"] = np.array(shape)
    return out


# --- JAX's initial variables in key form --------------------------------------
#
# A trunk's initial variables are 12-130 MB a seed, too many to copy to the
# card for 10 seeds. Every one of them is a constant or flax's
# ``lecun_normal`` draw: ``jax.random.truncated_normal(key, -2, 2)`` times a
# scale. The key form keeps each draw's key and scale; the card rebuilds the
# draw from JAX's threefry bits (integer arithmetic, exact in numpy) through
# a table of JAX's own truncated normal for each of the 2^23 mantissas the
# bits select, then multiplies by the scale (one f32 product, as JAX does).

TN_TABLE = "truncated_normal_table.npz"


def threefry_bits(key, shape) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (uint32, ``jax_threefry_partitionable``)
    from the key's two words: threefry-2x32 of each element's 64-bit
    row-major index, the two output words xor-ed."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    i = np.arange(int(np.prod(shape)), dtype=np.uint64)
    x0 = (i >> np.uint64(32)).astype(np.uint32) + ks[0]
    x1 = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32) + ks[1]
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        for r in range(5):
            for rot in rotations[r % 2]:
                x0 = x0 + x1
                x1 = (x1 << np.uint32(rot)) | (x1 >> np.uint32(32 - rot))
                x1 = x1 ^ x0
            x0 = x0 + ks[(r + 1) % 3]
            x1 = x1 + ks[(r + 2) % 3] + np.uint32(r + 1)
    return (x0 ^ x1).reshape(shape)


def truncated_normal_table(mantissas=None) -> np.ndarray:
    """(2^23,) f32, or one entry for each of ``mantissas``: entry ``m`` is
    ``jax.random.truncated_normal(key, -2, 2)`` of an element whose random
    bits have ``m`` as their top 23 bits (the bits fed in place of
    threefry's)."""
    import jax
    import jax.numpy as jnp
    from jax._src import random as jrandom

    m = (np.arange(2 ** 23) if mantissas is None
         else np.asarray(mantissas)).astype(np.uint32)
    bits = jnp.asarray(m << np.uint32(9))
    real = jrandom._random_bits
    jrandom._random_bits = lambda key, width, shape: bits.reshape(shape)
    try:
        return np.asarray(jrandom._truncated_normal(
            jax.random.key(0), -2, 2, bits.shape, jnp.float32))
    finally:
        jrandom._random_bits = real


@contextlib.contextmanager
def recorded_draws():
    """Within the block, every ``jax.random.truncated_normal`` call is
    recorded as (key words, shape, draw) in the list it yields."""
    import jax
    from jax._src import random as jrandom

    draws, real = [], jrandom.truncated_normal

    def record(key, lower, upper, shape=None, dtype=float, **kw):
        z = real(key, lower, upper, shape, dtype, **kw)
        assert (lower, upper) == (-2, 2), (lower, upper)
        draws.append((np.asarray(jax.random.key_data(key)), tuple(shape),
                      np.asarray(z)))
        return z

    jrandom.truncated_normal = record
    try:
        yield draws
    finally:
        jrandom.truncated_normal = real


def encode_keys(flat: dict, draws: list) -> dict:
    """``flat`` (``/``-keyed f32 arrays) → ``const/<name>`` (the value of a
    constant array), or ``key/<name>`` and ``scale/<name>`` (the recorded
    draw it is a multiple of, and that f32 multiple); ``shape/<name>``
    for each."""
    out = {}
    for name, w in flat.items():
        out[f"shape/{name}"] = np.array(w.shape, np.int64)
        if (w == w.flat[0]).all():
            out[f"const/{name}"] = w.flat[0]
            continue
        for key, shape, z in draws:
            if shape != w.shape:
                continue
            guess = np.float32(np.median(w[z != 0] / z[z != 0]))
            for scale in (guess, np.nextafter(guess, np.float32(np.inf)),
                          np.nextafter(guess, np.float32(-np.inf))):
                if np.array_equal(z * scale, w):
                    out[f"key/{name}"], out[f"scale/{name}"] = key, scale
                    break
            if f"key/{name}" in out:
                break
        else:
            raise ValueError(f"{name} is neither constant nor a recorded "
                             "truncated-normal draw")
    return out


def digest(flat: dict) -> str:
    """sha256 over the names and bytes of ``/``-keyed arrays."""
    h = hashlib.sha256()
    for name in sorted(flat):
        h.update(name.encode())
        h.update(np.ascontiguousarray(flat[name]).tobytes())
    return h.hexdigest()


def decode_keys(path: str) -> dict:
    """The ``/``-keyed arrays of a key-form file (:func:`encode_keys`),
    through the table beside it; raises unless they hash to the digest
    of JAX's arrays stored with them."""
    with np.load(os.path.join(os.path.dirname(path), TN_TABLE)) as t:
        table = np.concatenate([t["first"], t["first"] + np.cumsum(
            t["step"], dtype=np.int32)]).view(np.float32)
    flat = {}
    with np.load(path) as z:
        want = str(z["digest"])
        for entry in z.files:
            if entry == "digest":
                continue
            kind, name = entry.split("/", 1)
            shape = tuple(z[f"shape/{name}"])
            if kind == "const":
                flat[name] = np.full(shape, z[entry], np.float32)
            elif kind == "key":
                draw = table[threefry_bits(z[entry], shape) >> np.uint32(9)]
                flat[name] = draw * z[f"scale/{name}"]
    if digest(flat) != want:
        raise ValueError(f"{path} does not rebuild JAX's variables")
    return flat


def materialize(stem: str) -> str:
    """``<stem>.npz``, written from ``<stem>_keys.npz`` if it is missing."""
    if not os.path.exists(stem + ".npz"):
        np.savez(stem + ".npz", **decode_keys(stem + "_keys.npz"))
    return stem + ".npz"


def head_masks(prng, steps: int, rows: int, units: int, rate: float,
               module: str = "classifier"):
    """(steps, rows, units) bool: the units flax's ``Dropout`` keeps under
    a top-level ``module`` (the fused head's ``classifier``, or
    ``numerical_mlp``) on each step's ``dropout`` key. The ``rngs`` stream
    folds in the module path only, so a two-module stand-in with the same
    names draws the model's mask."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    class Classifier(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dropout(rate, deterministic=False)(x)

    class Model(nn.Module):
        @nn.compact
        def __call__(self, x):
            return Classifier(name=module)(x)

    ones = jnp.ones((rows, units))
    draw = jax.jit(lambda key: Model().apply({}, ones,
                                              rngs={"dropout": key}) != 0)
    return np.stack([np.asarray(draw(prng.named(s, "dropout")))
                     for s in range(steps)])


AUGMENT_PARAMS = ("y0", "x0", "ch", "cw", "cos", "sin", "flip", "brightness",
                  "contrast", "saturation", "hue", "sigma")


def _use_jax_masks(path: str, mp):
    """Patch (``mp.setattr``) the port's draws to JAX's in ``path``, by the
    step the generator was seeded for: the fused head drops JAX's units
    (the plain head), and, where saved, the numerical MLP drops JAX's
    units and the augmentation takes JAX's parameters. Any other dropout
    draw raises."""
    import torch

    from surya_tpu_torch.core.prng import PRNG
    from surya_tpu_torch.data import augment
    from surya_tpu_torch.models import common
    from surya_tpu_torch.ops.cuda.fusion_head import fusion_head_plain

    saved = np.load(path)

    def unpack(prefix):
        return np.unpackbits(saved[f"{prefix}bits"], axis=-1,
                             count=int(saved[f"{prefix}units"])).astype(bool)

    keep = unpack("")
    mlp = unpack("mlp_") if "mlp_bits" in saved.files else None
    prng, rate = PRNG(int(saved["seed"])), float(saved["rate"])
    step_of = {prng.seed_of(s, "dropout"): s for s in range(len(keep))}
    draw = common.dropout_generator
    now = {}

    def forward(self, x, generator=None):
        if draw(generator, self.dropout, self.training) is None:
            return fusion_head_plain(x.to(self.dtype), self.fc1.weight,
                                     self.fc1.bias, self.fc2.weight,
                                     self.fc2.bias)
        assert self.dropout == rate
        mask = torch.from_numpy(keep[step_of[generator.initial_seed()]])
        return fusion_head_plain(x.to(self.dtype), self.fc1.weight,
                                 self.fc1.bias, self.fc2.weight,
                                 self.fc2.bias, rate, mask.to(x.device))

    def mlp_draw(generator, r, training):
        g = draw(generator, r, training)
        if g is not None:
            if mlp is None:
                raise RuntimeError("--jax-masks has no draw for this dropout")
            now["step"] = step_of[g.initial_seed()]
        return g

    def mlp_rows(uniforms, n, *rest):
        """1 where JAX kept the unit, 0 where it dropped it: the values
        ``flax_dropout`` compares with the rate."""
        kept = mlp[now.pop("step")]
        assert kept.shape == (n, *rest)
        return torch.from_numpy(kept.astype(np.float32)).to(
            uniforms((1,)).device)

    mp.setattr(common.FusionClassifier, "forward", forward)
    mp.setattr(common, "dropout_generator", mlp_draw)
    mp.setattr(common, "draw_rows", mlp_rows)
    if "aug_shape" not in saved.files:
        return
    params = {k: saved[f"aug/{k}"] if f"aug/{k}" in saved.files else None
              for k in AUGMENT_PARAMS}
    aug_step = {prng.seed_of(s, "augment"): s for s in range(len(keep))}

    def draw_augment_params(generator, b, h, w, *args, **kw):
        assert (b, h, w) == tuple(saved["aug_shape"])
        s = aug_step[generator.initial_seed()]
        return {k: None if v is None else torch.from_numpy(v[s]).to(
            generator.device) for k, v in params.items()}

    mp.setattr(augment, "draw_augment_params", draw_augment_params)


def _from_init(path: str, mp):
    """Patch the port's loop to build its model from the variables in
    ``path``."""
    from surya_tpu_torch.core.checkpoint import load_params
    from surya_tpu_torch.train import loop

    build = loop.get_model

    def get_model(cfg, image_size=224, seed=0):
        model = build(cfg, image_size=image_size, seed=seed)
        model.load_state_dict(load_params(path), strict=True)
        return model

    mp.setattr(loop, "get_model", get_model)


def train_from_init(argv) -> int:
    """``python tests/replay_diag.py train ...``: the port's CLI ``train``
    whose model starts from the variables in ``$REPLAY_DIAG_INIT`` (and
    whose head drops the units in ``$REPLAY_DIAG_MASKS``, if set)."""
    import pytest

    from surya_tpu_torch.__main__ import main as cli

    mp = pytest.MonkeyPatch()
    _from_init(os.environ[INIT_ENV], mp)
    if os.environ.get(MASKS_ENV):
        _use_jax_masks(os.environ[MASKS_ENV], mp)
    if os.environ.get(PLAIN_ENV):
        # the fused head's plain version on the card's tensors, with the
        # kernel's own Philox mask: the kernel's arithmetic taken out
        from surya_tpu_torch.ops.cuda import fusion_head
        mp.setattr(fusion_head, "on_cuda", lambda x: False)
    return cli(["train", *argv])


# the spatial rows' law pack: per class and split, at 72 px, trained at 64
# px in batches of 16 for 8 epochs (64 steps)
LAW_COUNTS = {"train": 16, "valid": 8, "test": 2}
LAW_RUN = {"train.epochs": "8", "data.batch_size": "16"}


def mask_law(seeds, preset: str = "ji-3dcnn") -> dict:
    """The port's own draws against JAX's, inside the port: ``preset``
    trained from JAX's initial weights and order, each seed once with
    JAX's draws (JAX's loop to float error, as arm (a) shows) and once
    with the port's own. ``ji-3dcnn`` (the head's mask, its only draw)
    runs on the coupled test's arm (b) pack (``JI_COUNTS``, ``JI_RUN``); a
    ``standard_multimodal`` row (the augmentation parameters and the
    numerical MLP's and the head's masks) on a spatial pack of
    :data:`LAW_COUNTS` for :data:`LAW_RUN`. Both sides use the plain head
    on the CPU. → per seed the (train, val) loss gap averaged over the
    epochs (own − JAX's draws), its mean and standard error over all
    seeds and over blocks of 8."""
    import pathlib
    import tempfile

    import pytest

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_loop_coupled as arm

    from surya_tpu_torch.core.metrics import MetricsLogger
    from surya_tpu_torch.train import loop

    root = pathlib.Path(tempfile.mkdtemp())
    if preset == "ji-3dcnn":
        arm.write_ji_pack(root)
        run = arm.JI_RUN
    else:
        arm.pack_arrays(str(root / "spatial_packed"), {
            split: arm.make_replay_spatial(
                per_class=LAW_COUNTS[split], image_size=72,
                seed=1000 + off, amp_pow=0.5)
            for split, off in arm.SPLIT_SEEDS.items()}, arm.CLASSES)
        run = LAW_RUN
    gaps = []
    for seed in seeds:
        cfg, ref = arm._configs(preset, root, seed, **run)
        ov = {"data.seq_root": cfg.data.seq_root,
              "data.packed_dir": cfg.data.packed_dir,
              "data.image_size": str(cfg.data.image_size),
              "data.batch_size": str(cfg.data.batch_size),
              "train.epochs": str(cfg.train.epochs),
              "model.compute_dtype": "float32"}
        save_jax_inits(preset, [seed], ov, str(root))
        stem = str(root / f"{preset}_s{seed}")
        losses = []
        for jax_masks in (True, False):
            with pytest.MonkeyPatch.context() as mp:
                _from_init(materialize(stem), mp)
                if jax_masks:
                    _use_jax_masks(stem + "_masks.npz", mp)
                got = loop.train_and_evaluate(
                    cfg, arm._sources(cfg, ref, seed)[0],
                    logger=MetricsLogger(echo=False), checkpoints=False,
                    device="cpu")
            losses.append(arm._losses(got))
        gaps.append((losses[1] - losses[0]).mean(0).tolist())
        print(json.dumps({"seed": seed, "gap": gaps[-1]}), flush=True)
    g = np.array(gaps)

    def summary(x):
        return {"mean": x.mean(0).tolist(),
                "se": (x.std(0, ddof=1) / np.sqrt(len(x))).tolist()}

    return {"preset": preset, "seeds": list(seeds), "gaps": gaps,
            "all": summary(g),
            "blocks_of_8": [summary(g[i:i + 8])
                            for i in range(0, len(g) - 7, 8)]}


def run_cli(launcher: list, name: str, preset: str, out_dir: str,
            overrides: dict, device=None, card=None) -> dict:
    """One run: ``python <launcher> train`` in a child → the
    ``result.json`` written in ``bench.replay.run_job``'s layout, or an
    error row."""
    os.makedirs(out_dir, exist_ok=True)
    args = [sys.executable, *launcher, "train", "--preset", preset,
            "--out", out_dir, *[f"--{k}={v}" for k, v in overrides.items()]]
    if device is not None:
        args += ["--device", device]
    t0 = time.time()
    proc = subprocess.run(args, cwd=REPO, capture_output=True, text=True)
    wall = time.time() - t0
    seed = int(overrides["train.seed"])
    try:
        if proc.returncode != 0:
            raise RuntimeError(f"exit {proc.returncode}")
        summary = _last_json(proc.stdout)
    except (RuntimeError, ValueError) as e:
        result = {"preset": name, "base_preset": preset, "seed": seed,
                  "error": f"{e}: {proc.stderr[-1500:]}", **card}
    else:
        result = {"best_epoch": summary["best_epoch"],
                  "best_metric": summary["best_metric"],
                  "test": summary["test"], "preset": name,
                  "base_preset": preset,
                  "overrides": {k: v for k, v in overrides.items()
                                if not k.startswith("data.")},
                  "seed": seed, "wall_seconds": round(wall, 1),
                  "runner": f"tests/replay_diag.py: python "
                            f"{' '.join(launcher)} train in a child per run",
                  "kernel_launches": summary.get("kernel_launches"),
                  **card}
        with open(os.path.join(out_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(card) + "\n")
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({"run": out_dir, **result}), flush=True)
    return result


def coupled(preset: str, root: str, epochs: int, extra: dict) -> dict:
    """Arm (a) of ``test_torch_loop_coupled.py`` on the replay set, with
    the config overrides ``extra`` and JAX's augmentation run eagerly
    (``test_torch_loop_coupled.eager_jax_augment``) → each epoch's train
    and validation loss and each step's train loss, both sides."""
    import pytest

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_loop_coupled as arm

    from surya_tpu.core.config import get_preset as jax_preset
    from surya_tpu.core.mesh import single_device_mesh
    from surya_tpu.train import steps as jsteps
    from surya_tpu_torch.core.config import get_preset
    from surya_tpu_torch.train import loop as tloop

    losses = {"port": [], "jax": []}

    def recording(make, side):
        def build(*args, **kw):
            step = make(*args, **kw)

            def run(*a, **k):
                state, metrics = step(*a, **k)
                losses[side].append(float(metrics["loss"]))
                return state, metrics
            return run
        return build

    ov = {**data_overrides(preset, root), "model.compute_dtype": "float32",
          "train.epochs": str(epochs), "train.seed": "0",
          "train.early_stop_patience": "0", "train.checkpoint_dir": "unused",
          **extra}
    cfg = get_preset(preset).override(ov)
    ref = jax_preset(preset).override(ov)
    pdata, jdata = arm._sources(cfg, ref, 0)
    with pytest.MonkeyPatch.context() as mp:
        arm.eager_jax_augment(mp)
        # ``run_coupled`` wraps JAX's step (for its masks) around this one
        mp.setattr(jsteps, "make_train_step",
                   recording(jsteps.make_train_step, "jax"))
        mp.setattr(tloop, "make_train_step",
                   recording(tloop.make_train_step, "port"))
        got, want, masks = arm.run_coupled(cfg, ref, pdata, jdata,
                                           single_device_mesh(), mp)
    return {"preset": preset, "steps": len(masks), "eager_augment": True,
            "port": arm._losses(got).tolist(),
            "jax": arm._losses(want).tolist(),
            "step_loss": losses}


def curves(metrics_jsonl: str) -> list:
    """[(train_loss, val_loss)] by epoch from a loop's metrics.jsonl."""
    rows = {}
    with open(metrics_jsonl) as f:
        for line in f:
            r = json.loads(line)
            if "train_loss" in r:
                rows[r["epoch"]] = (r["train_loss"], r["val_loss"])
    return [rows[e] for e in sorted(rows)]


def compare(preset: str, out: str, name: str) -> dict:
    """Per source: each seed's (train, val) loss by epoch, and the mean
    over the seeds that reached the epoch."""
    runs = os.path.join(REPO, "runs")
    group = "temporal" if preset in TEMPORAL_PRESETS else "spatial"
    sources = {
        "jax_tpu": os.path.join(runs, "reference_replay", group,
                                f"{preset}_s*"),
        "port_card": os.path.join(runs, "torch_replay", group,
                                  f"{preset}_s*")}
    for side in sorted(os.listdir(out)) if os.path.isdir(out) else ():
        sources[f"diag/{side}"] = os.path.join(out, side, f"{name}_s*")
    table = {}
    for src, pattern in sources.items():
        seeds = {os.path.basename(d).rsplit("_s", 1)[1]: curves(
            os.path.join(d, "metrics.jsonl"))
            for d in sorted(glob.glob(pattern))
            if os.path.exists(os.path.join(d, "metrics.jsonl"))}
        if not seeds:
            continue
        longest = max(len(c) for c in seeds.values())
        mean = [np.mean([c[e] for c in seeds.values() if len(c) > e],
                        axis=0).round(4).tolist() for e in range(longest)]
        table[src] = {"seeds": seeds, "mean": mean}
    return table


# --- the vs_jax_cpu block of table.json ---------------------------------------

def _band(b: dict | None) -> dict | None:
    if b is None:
        return None
    return {"mean": b["mean"], "std": b["std"], "accs": b["accs"],
            "interval": [b["mean"] - b["std"], b["mean"] + b["std"]]}


def _mean_se(x) -> dict:
    """Mean and standard error (one, ddof 1) of the per-seed gaps."""
    x = np.asarray(x, dtype=float)
    se = float(x.std(ddof=1) / np.sqrt(len(x))) if len(x) > 1 else None
    return {"mean": float(x.mean()), "se": se}


def variant(row: str) -> str:
    """A row's name without its epoch cut: a cut run's epochs are the
    first epochs of the whole run (the learning rate follows the history
    alone)."""
    return re.sub(r"-\d+ep(?=-|$)", "", row)


def _runs(results: list) -> dict:
    """seed → (row, test accuracy, [(train, val)] by epoch); of two runs
    of one seed, the longer."""
    out = {}
    for path, r in results:
        m = os.path.join(os.path.dirname(path), "metrics.jsonl")
        if os.path.exists(m):
            run = (r["preset"], r["test"]["accuracy"], curves(m))
            if len(run[2]) > len(out.get(r["seed"], (0, 0, ()))[2]):
                out[int(r["seed"])] = run
    return out


def paired(ref: dict, side: dict) -> dict | None:
    """``side`` − ``ref`` seed by seed, at the seeds both ran: the test
    accuracy gaps of the seeds that trained the same row (the same cut)
    and, per epoch both reached, the mean train and validation loss gaps
    with their standard error, and the mean of each seed's gap averaged
    over those epochs (``seed_mean``, with its standard error). Only ``_jaxinit``/``_jaxdraws`` sides
    share JAX's initial weights; elsewhere a seed pairs the epoch order
    alone."""
    seeds = sorted(set(ref) & set(side))
    if not seeds:
        return None
    out = {"seeds": seeds}
    same = [s for s in seeds if ref[s][0] == side[s][0]]
    if same:
        gaps = [side[s][1] - ref[s][1] for s in same]
        out["test_accuracy"] = {"seeds": same, "gaps": gaps,
                                **_mean_se(gaps)}
    epochs = min(min(len(ref[s][2]), len(side[s][2])) for s in seeds)
    for i, key in enumerate(("train_loss", "val_loss")):
        gaps = np.array([[side[s][2][e][i] - ref[s][2][e][i]
                          for e in range(epochs)] for s in seeds])
        per = [_mean_se(gaps[:, e]) for e in range(epochs)]
        # each seed's gap averaged over the epochs: one number a seed
        over = _mean_se(gaps.mean(1))
        out[key] = {"mean_gap": [round(p["mean"], 5) for p in per],
                    "se": [None if p["se"] is None else round(p["se"], 5)
                           for p in per],
                    "seed_mean": round(over["mean"], 5),
                    "seed_mean_se": None if over["se"] is None
                    else round(over["se"], 5)}
    return out


def vs_jax_cpu(diag: str, jax_tpu: dict, port_campaign: dict,
               jax_runs: str = JAX_REPLAY) -> dict:
    """Per row trained under ``diag/<side>/<row>_s<seed>/`` (``jax_cpu``:
    JAX's own CLI on a host CPU; ``port_cpu``, ``port_card``; ``_jaxinit``
    from JAX's initial weights, ``_jaxdraws`` also with JAX's head masks),
    all at f32:

    - ``bands``: each side's test-accuracy band (with each seed's best
      and stop epoch) beside JAX's TPU band and the port's campaign band, and whether each overlaps JAX's TPU band
      (JAX's CPU band also the port's). A row cut short (``<row>-15ep``)
      has neither reference band.
    - ``paired``: per :func:`variant`, every other side against
      ``jax_cpu`` and against JAX's TPU runs of the same seeds
      (``jax_runs``: the variant's own row if JAX's replay has one, else
      its preset's), a ``_jaxinit`` side against its ``_jaxdraws`` side
      (the port's draws against JAX's) and a ``_plainhead`` side against
      the side it suffixes (the fused head's plain version against the
      kernel), by :func:`paired`.
    """
    sides, sources = {}, set()
    for path in sorted(glob.glob(os.path.join(diag, "*", "*",
                                              "result.json"))):
        r = load_result(path)
        if r and "test" in r:
            sides.setdefault(path.split(os.sep)[-3], []).append((path, r))
            sources.add(r.get("host") or r.get("nvidia_smi"))
    rows = {}
    for side, results in sorted(sides.items()):
        for name, b in bands([r for _, r in results]).items():
            tpu, card = jax_tpu.get(name), port_campaign.get(name)
            row = rows.setdefault(name, {"jax_tpu": _band(tpu),
                                         "port_campaign": _band(card)})
            row[side] = _band(b)
            runs = sorted((r["seed"], path, r) for path, r in results
                          if r["preset"] == name)
            row[side]["best_epochs"] = [r.get("best_epoch")
                                        for _, _, r in runs]
            row[side]["stop_epochs"] = [len(curves(os.path.join(
                os.path.dirname(p), "metrics.jsonl"))) - 1
                for _, p, _ in runs]
            row[f"{side}_overlaps_jax_tpu"] = (
                None if tpu is None else overlap(b, tpu))
            if side == "jax_cpu":
                row["jax_cpu_overlaps_port_campaign"] = (
                    None if card is None else overlap(b, card))
    pairs = {}
    for side, results in sides.items():
        for path, r in results:
            pairs.setdefault(variant(r["preset"]), {"base": r[
                "base_preset"]})
    for var, block in sorted(pairs.items()):
        by_side = {side: _runs([(p, r) for p, r in results
                                if variant(r["preset"]) == var])
                   for side, results in sides.items()}
        # a ``--set``/``--tag`` variant that is a replay row of its own
        # (``resnet3d-video-trainable``) pairs with that row's TPU runs
        row = var if glob.glob(os.path.join(jax_runs, "*", f"{var}_s*")) \
            else block["base"]
        tpu = [(p, {**r, "preset": row}) for p in glob.glob(
            os.path.join(jax_runs, "*", f"{row}_s*", "result.json"))
               if "test" in (r := load_result(p) or {})]
        by_side["jax_tpu"] = _runs(tpu)
        for ref in (r for r in REFERENCE if r in by_side):
            for side, runs in sorted(by_side.items()):
                if side in (ref, "jax_tpu"):
                    continue
                p = paired(by_side[ref], runs)
                if p:
                    block[f"{side} - {ref}"] = p
        for side in sorted(by_side):
            # the port's draws against JAX's, and the kernel against the
            # plain head (the same draws)
            base = {"_jaxinit": side.replace("_jaxinit", "_jaxdraws"),
                    "_plainhead": side.removesuffix("_plainhead")}
            for suffix, other in base.items():
                if side.endswith(suffix) and other in by_side:
                    p = paired(by_side[other], by_side[side])
                    if p:
                        block[f"{side} - {other}"] = p
    return {"sources": sorted(x for x in sources if x),
            "bands": dict(sorted(rows.items())),
            "paired": {v: b for v, b in sorted(pairs.items()) if len(b) > 1}}


def write_table_block(out: str) -> dict:
    """Add :func:`vs_jax_cpu` of ``out`` to the campaign's ``table.json``
    beside ``out``."""
    path = os.path.join(os.path.dirname(os.path.abspath(out)), "table.json")
    with open(path) as f:
        table = json.load(f)
    jax_table = load_result(os.path.join(JAX_REPLAY, "table.json")) or {}
    table["vs_jax_cpu"] = vs_jax_cpu(out, jax_table.get("bands", {}),
                                     table.get("bands", {}))
    with open(path, "w") as f:
        json.dump(table, f, indent=2)
    return table["vs_jax_cpu"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tests/replay_diag.py")
    ap.add_argument("--side", choices=("jax", "port"))
    ap.add_argument("--preset")
    ap.add_argument("--curves", metavar="PRESET",
                    help="print the row's loss curves instead of training")
    ap.add_argument("--coupled", metavar="PRESET",
                    help="arm (a) of the coupled test on the replay set")
    ap.add_argument("--table", action="store_true",
                    help="write table.json's vs_jax_cpu block")
    ap.add_argument("--mask-law", action="store_true",
                    help="the port's own draws against JAX's (--preset, "
                    "ji-3dcnn by default), --seeds")
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--epochs", type=int, default=None,
                    help="cut the preset's epochs (the run is "
                         "named <preset>-<N>ep)")
    ap.add_argument("--set", action="append", default=[],
                    help="a config override k=v (repeatable)")
    ap.add_argument("--tag", default="", help="names the --set variant")
    ap.add_argument("--device", choices=("cpu", "card"), default="cpu",
                    help="where the port trains")
    ap.add_argument("--save-inits", metavar="DIR",
                    help="(jax) write each seed's initial variables and "
                         "head masks")
    ap.add_argument("--init-from", metavar="DIR",
                    help="(port) start from JAX's initial variables")
    ap.add_argument("--plain-head", action="store_true",
                    help="(--init-from, card) the fused head's plain version")
    ap.add_argument("--jax-masks", action="store_true",
                    help="(port, with --init-from) drop JAX's head units")
    ap.add_argument("--root", default=os.path.join(REPO, "build",
                                                   "replay224"))
    ap.add_argument("--out", default=os.path.join(
        REPO, "runs", "torch_replay", "diag"))
    args = ap.parse_args(argv)
    name = ((args.preset or args.curves or "")
            + (f"-{args.epochs}ep" if args.epochs else "")
            + (f"-{args.tag}" if args.tag else ""))
    if args.curves:
        print(json.dumps(compare(args.curves, args.out, name)))
        return 0
    if args.table:
        print(json.dumps(write_table_block(args.out)))
        return 0
    if args.mask_law:
        os.environ["JAX_PLATFORMS"] = "cpu"
        print(json.dumps(mask_law([int(s) for s in args.seeds.split(",")],
                                  args.preset or "ji-3dcnn")))
        return 0
    if args.coupled:
        os.environ["JAX_PLATFORMS"] = "cpu"
        print(json.dumps(coupled(args.coupled, os.path.abspath(args.root),
                                 args.epochs or 1,
                                 dict(kv.split("=", 1) for kv in args.set))))
        return 0
    if not (args.side and args.preset):
        ap.error("--side and --preset, --coupled, --curves or --table")
    if args.set and not args.tag:
        ap.error("--set needs --tag")
    if (args.jax_masks or args.plain_head) and not args.init_from:
        ap.error("--jax-masks and --plain-head need --init-from")
    if args.jax_masks and args.plain_head:
        ap.error("--jax-masks already runs the plain head")
    if args.side == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
    root = os.path.abspath(args.root)
    seeds = [int(s) for s in args.seeds.split(",")]
    base = {**data_overrides(args.preset, root),
            "model.compute_dtype": "float32"}
    if args.epochs:
        base["train.epochs"] = str(args.epochs)
    base.update(kv.split("=", 1) for kv in args.set)
    if args.save_inits:
        save_jax_inits(args.preset, seeds, base, args.save_inits)
        return 0
    on_card = args.side == "port" and args.device == "card"
    side = (f"{args.side}_{'card' if on_card else 'cpu'}"
            + ("_jaxdraws" if args.jax_masks
               else "_jaxinit" if args.init_from else "")
            + ("_plainhead" if args.plain_head else ""))
    card = card_record() if on_card else host_record()
    launcher = ["-m", {"jax": "surya_tpu", "port": "surya_tpu_torch"}[
        args.side]]
    if args.init_from:
        launcher = [os.path.abspath(__file__)]
    failed = False
    for seed in seeds:
        out_dir = os.path.join(args.out, side, f"{name}_s{seed}")
        if "test" in (load_result(os.path.join(out_dir, "result.json"))
                      or {}):
            continue
        if args.init_from:
            stem = os.path.abspath(os.path.join(
                args.init_from, f"{args.preset}_s{seed}"))
            os.environ[INIT_ENV] = materialize(stem)
            os.environ[MASKS_ENV] = stem + "_masks.npz" if args.jax_masks \
                else ""
            os.environ[PLAIN_ENV] = "1" if args.plain_head else ""
        res = run_cli(launcher, name, args.preset, out_dir,
                      {**base, "train.seed": str(seed)},
                      device="cpu" if args.side == "port" and not on_card
                      else None, card=card)
        failed |= "test" not in res
    return int(failed)


if __name__ == "__main__":
    if sys.argv[1:2] == ["train"]:
        sys.exit(train_from_init(sys.argv[2:]))
    sys.exit(main())
