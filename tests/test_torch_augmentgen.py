"""The port's generative augmentation stages
(``surya_tpu_torch/augmentgen/{background,multiview}.py``) on the CPU:
background removal against the JAX package's PNGs, the multiview file
contract and resume, both generators against JAX's on tiny models with
JAX's draws injected, and the chain of
``tests/test_multiview_integration.py`` (generated views → sequence
windows → a ``cnn_lstm`` train run) on the port.

Tolerances: the RGB planes equal, the alpha within 1 level of JAX's (the
saliency maps differ by f32 rounding before they are quantised); the
generated grids within 1 level of JAX's, for the same reason.
"""

import csv
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_mirror_unet import MirrorUNet2DCondition
from torch_mirror_vae import MirrorAutoencoderKL
from torch_port_fixtures import one_torch_thread  # noqa: F401

from surya_tpu.augmentgen import background as jax_background
from surya_tpu.augmentgen import multiview as jax_multiview
from surya_tpu.augmentgen.multiview import (
    slice_grid_in_memory as jax_slice,
)
from surya_tpu.data.prep.frame_renaming import rename_frames
from surya_tpu.models.segmentation import import_u2net as jax_import
from surya_tpu_torch.augmentgen import background, multiview
from surya_tpu_torch.data.sequences import (
    FILENAME_PATTERN,
    SequenceDataSource,
    build_sequence_dataset,
)
from surya_tpu_torch.models.from_jax import from_jax_variables
from tests.torch_mirrors import MirrorU2NetP, randomize_bn_stats

LABELS = ("cobra pose", "plank pose")
CLIPS = ("video_clip_001", "video_clip_002")
FRAMES = 6
SIZE = 32


def test_slice_grid_matches_jax():
    grid = Image.fromarray(np.random.default_rng(0).integers(
        0, 256, (30, 22, 3), np.uint8))
    for rows, cols in ((3, 2), (1, 2), (2, 3)):
        got = multiview.slice_grid_in_memory(grid, rows, cols)
        want = jax_slice(grid, rows, cols)
        assert len(got) == rows * cols
        for g, w in zip(got, want):
            assert g.size == w.size
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_gated_backends_raise():
    with pytest.raises(ImportError, match="rembg"):
        background.rembg_remove_fn()
    with pytest.raises(ImportError, match="diffusers"):
        multiview.zero123plus_generate_fn()


def _renamed_tree(tmp_path):
    """A raw clip of two frames (24×20, which U²-Net's 64² input grows,
    and 96×80, which it shrinks), renamed, with a label CSV."""
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw" / "train" / "clip_a"
    raw.mkdir(parents=True)
    names = {"vidA-00001_jpg.rf.x.jpg": (24, 20),
             "vidA-00002_jpg.rf.y.jpg": (96, 80)}
    for nm, (h, w) in names.items():
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            raw / nm, quality=95)
    renamed = str(tmp_path / "renamed")
    rename_frames(str(tmp_path / "raw"), renamed)
    labels_csv = tmp_path / "labels.csv"
    with open(labels_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["filename", "label"])
        w.writeheader()
        for nm in names:
            w.writerow({"filename": nm, "label": "cobra"})
    return renamed, [str(labels_csv)]


def test_process_pipeline_u2net_matches_jax(tmp_path):
    """``process_pipeline`` with both packages' ``u2net_remove_fn``
    (u2netp at 64², one JAX variable tree, bridged for the port): the
    same files, RGB equal, alpha within 1 level; a second run skips."""
    torch.manual_seed(0)
    mirror = MirrorU2NetP()
    randomize_bn_stats(mirror, seed=1)
    variables = jax.device_get(jax_import(mirror.eval().state_dict(),
                                          variant="u2netp"))
    renamed, csvs = _renamed_tree(tmp_path)
    out_jax, out_port = str(tmp_path / "jax"), str(tmp_path / "port")
    r = jax_background.process_pipeline(
        renamed, csvs, out_jax,
        remove_fn=jax_background.u2net_remove_fn(variables, size=64))
    remove = background.u2net_remove_fn(variables, size=64, device="cpu")
    got = background.process_pipeline(renamed, csvs, out_port,
                                      remove_fn=remove)
    assert got == r == {"train": {"done": 2, "skipped": 0}}
    files = sorted(os.listdir(os.path.join(out_jax, "train", "cobra")))
    assert files == sorted(os.listdir(os.path.join(out_port, "train",
                                                   "cobra")))
    for name in files:
        with Image.open(os.path.join(out_jax, "train", "cobra", name)) as a, \
                Image.open(os.path.join(out_port, "train", "cobra",
                                        name)) as b:
            assert a.mode == b.mode == "RGBA" and a.size == b.size
            want, have = np.asarray(a).astype(int), np.asarray(b).astype(int)
        np.testing.assert_array_equal(have[..., :3], want[..., :3])
        assert np.abs(have[..., 3] - want[..., 3]).max() <= 1, name
        assert have[..., 3].max() > have[..., 3].min()
    again = background.process_pipeline(renamed, csvs, out_port,
                                        remove_fn=remove)
    assert again == {"train": {"done": 0, "skipped": 2}}


def test_u2net_remove_fn_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        background.u2net_remove_fn(size=32)


def _clean_png(path, seed=0, size=(20, 20)):
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 255, (*size, 4), np.uint8), mode="RGBA").save(path)


def test_process_augmentation_contract_and_resume(tmp_path):
    """The pixel-space path (TinyDenoiser, 3 steps, 16-px tiles): 6 views
    of 16×16 per image, ``_view_01`` .. ``_view_06``; a second run
    generates none. Then the CLI's torch backend on the CPU."""
    clean = tmp_path / "clean" / "train" / "cobra"
    clean.mkdir(parents=True)
    _clean_png(clean / "f1.png")
    fn = multiview.torch_diffusion_generate_fn(num_steps=3, tile=16,
                                               device="cpu")
    out = str(tmp_path / "aug")
    r = multiview.process_augmentation(str(tmp_path / "clean"), out,
                                       generate_fn=fn)
    assert r["train"] == {"generated": 1, "skipped": 0,
                          "views_per_image": 6}
    views = sorted(os.listdir(os.path.join(out, "train", "cobra")))
    assert views == [f"f1_view_{i:02d}.png" for i in range(1, 7)]
    with Image.open(os.path.join(out, "train", "cobra", views[0])) as im:
        assert im.size == (16, 16) and im.mode == "RGB"
    r2 = multiview.process_augmentation(str(tmp_path / "clean"), out,
                                        generate_fn=fn)
    assert r2["train"]["generated"] == 0 and r2["train"]["skipped"] == 1

    cli_out = tmp_path / "cli"
    multiview.main([str(tmp_path / "clean"), str(cli_out), "--steps", "1",
                    "--backend", "torch", "--device", "cpu"])
    with Image.open(cli_out / "train" / "cobra" / "f1_view_06.png") as im:
        assert im.size == (320, 320)


def _sampler_draws(key, shape, steps):
    """JAX ``sample``'s draws from ``key``: ``split(key)`` for the start,
    then ``k, kn = split(k)`` per step."""
    k, sub = jax.random.split(key)
    init = jax.random.normal(sub, shape, jnp.float32)
    noise = []
    for _ in range(steps):
        k, kn = jax.random.split(k)
        noise.append(jax.random.normal(kn, shape, jnp.float32))
    return t_(init), [t_(n) for n in noise]


def t_(a):
    return torch.from_numpy(np.array(a))


def _grids(monkeypatch):
    """Keep the f32 grid of each generated image before its cast to uint8:
    JAX's as its generator fetches it (``jax.device_get``), the port's as
    it reaches ``multiview.to_image``. → (JAX's list, the port's list)."""
    jax_grids, port_grids = [], []
    device_get, to_image = jax.device_get, multiview.to_image

    def fetch(x):
        out = device_get(x)
        jax_grids.append(np.asarray(out)[0])
        return out

    def image(pixels):
        port_grids.append(pixels[0].numpy())
        return to_image(pixels)

    monkeypatch.setattr(jax, "device_get", fetch)
    monkeypatch.setattr(multiview, "to_image", image)
    return jax_grids, port_grids


def _hold(want_fn, got_fn, images, monkeypatch):
    """Both generators over ``images``: the f32 grids within 1e-5 of JAX's
    (relative to its largest value), the uint8 grids within 1 level."""
    jax_grids, port_grids = _grids(monkeypatch)
    for n, image in enumerate(images):
        w, g = np.asarray(want_fn(image)), np.asarray(got_fn(image))
        assert g.shape == w.shape and g.dtype == w.dtype == np.uint8
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, n
        assert rel(port_grids[n], jax_grids[n]) <= 1e-5, (
            n, rel(port_grids[n], jax_grids[n]))
    return jax_grids


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cond_image(seed, size=(8, 8)):
    return Image.fromarray(np.random.default_rng(seed).integers(
        0, 255, (*size, 3), np.uint8), "RGB")


def test_tiny_denoiser_pipeline_matches_jax(monkeypatch):
    """``torch_diffusion_generate_fn`` (TinyDenoiser at 8-px tiles, 3
    steps) against JAX's ``jax_diffusion_generate_fn`` on the same weights
    (``out_conv`` moved off its zero init), with JAX's draws of image n
    (``fold_in(PRNGKey(seed), n)``) injected, two images: the f32 grids
    within 1e-5 relative, the uint8 ones within 1 level."""
    from surya_tpu.models.diffusion import TinyDenoiser as JaxTiny

    steps, tile, seed = 3, 8, 0
    shape = (1, 3 * tile, 2 * tile, 3)
    x = jnp.zeros(shape)
    variables = jax.device_get(jax.jit(JaxTiny().init)(
        jax.random.PRNGKey(1), x, jnp.float32(0.0), x))
    oc = variables["params"]["out_conv"]
    oc["kernel"] = np.random.default_rng(2).normal(
        0, 0.1, oc["kernel"].shape).astype(np.float32)
    want = jax_multiview.jax_diffusion_generate_fn(
        variables=variables, num_steps=steps, tile=tile, seed=seed)

    def draws(n):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), n)
        init, noise = _sampler_draws(key, shape, steps)
        return multiview.Draws(init, noise)

    got = multiview.torch_diffusion_generate_fn(
        state_dict=from_jax_variables(variables), num_steps=steps,
        tile=tile, seed=seed, device="cpu", draws=draws)
    grids = _hold(want, got, [_cond_image(n, (11, 7)) for n in range(2)],
                  monkeypatch)
    assert grids[0].shape == shape[1:]


def test_zero123plus_latent_pipeline_tiny(monkeypatch):
    """``zero123plus_unet_generate_fn`` on the tiny UNet and VAE (one set
    of mirror weights through JAX's importers, bridged for the port; 8-px
    tiles, 3 steps) against JAX's function of the same name, with JAX's
    draws of image n injected: ``kc, kd, ks = split(fold_in(PRNGKey(seed),
    n), 3)``, the posterior draw from kc, step i's cond noise from
    ``fold_in(kd, i)``, the sampler's from ks. The self-attention query and
    key weights are scaled by 4, so that the reference bank moves the
    output by far more than the tolerance. Two images: the f32 grids within
    1e-5 relative, the uint8 ones within 1 level. Then the port's own
    generator path: the same seed gives the same grid, and the
    conditioning image steers it."""
    from surya_tpu.models.diffusion import unet_cond as juc
    from surya_tpu.models.diffusion import vae as jvae
    from surya_tpu_torch.models.diffusion.unet_cond import (
        UNet2DCondition,
        diffusers_state_dict,
        tiny_config,
    )
    from surya_tpu_torch.models.diffusion.vae import (
        AutoencoderKL,
        tiny_vae_config,
    )

    steps, tile, seed = 3, 8, 0
    torch.manual_seed(0)
    state = MirrorUNet2DCondition().state_dict()
    for k, v in state.items():
        if ".attn1.to_q." in k or ".attn1.to_k." in k:
            v.mul_(4.0)
    unet_vars = jax.device_get(juc.import_unet(state))
    vae_vars = jax.device_get(jvae.import_vae(
        MirrorAutoencoderKL().state_dict()))
    unet = UNet2DCondition(tiny_config())
    unet.load_state_dict(diffusers_state_dict(unet_vars))
    vae = AutoencoderKL(tiny_vae_config())
    vae.load_state_dict(diffusers_state_dict(vae_vars))
    unet, vae = unet.eval(), vae.eval()
    ehs = np.random.default_rng(2).normal(0, 1, (1, 7, 12)).astype(
        np.float32)
    want = jax_multiview.zero123plus_unet_generate_fn(
        juc.tiny_config(), unet_vars, jvae.tiny_vae_config(), vae_vars, ehs,
        num_steps=steps, tile=tile, seed=seed)
    cond_shape, lat_shape = (1, tile // 2, tile // 2, 4), (1, 12, 8, 4)

    def draws(n):
        kc, kd, ks = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(seed), n), 3)
        init, noise = _sampler_draws(ks, lat_shape, steps)
        return multiview.Draws(
            init, noise, t_(jax.random.normal(kc, cond_shape, jnp.float32)),
            [t_(jax.random.normal(jax.random.fold_in(kd, i), cond_shape,
                                  jnp.float32)) for i in range(steps)])

    got = multiview.zero123plus_unet_generate_fn(
        unet, vae, t_(ehs), num_steps=steps, tile=tile, seed=seed,
        draws=draws)
    grids = _hold(want, got, [_cond_image(3 + n) for n in range(2)],
                  monkeypatch)
    assert grids[0].shape == (3 * tile, 2 * tile, 3)
    monkeypatch.undo()

    def grid(image):
        return np.asarray(multiview.zero123plus_unet_generate_fn(
            unet, vae, t_(ehs), num_steps=2, tile=tile, seed=seed)(image))

    g = grid(_cond_image(3))
    np.testing.assert_array_equal(grid(_cond_image(3)), g)
    assert not np.array_equal(grid(_cond_image(4)), g)


def _camera_oracle(image):
    """1×2 grid of in-plane novel views (rotation + scale) of the input:
    the weight-free stand-in of ``tests/test_multiview_integration.py``."""
    w, h = image.size
    views = [
        image.rotate(15, resample=Image.BILINEAR),
        image.resize((int(w * 1.3), int(h * 1.3))).crop(
            (w // 6, h // 6, w // 6 + w, h // 6 + h)),
    ]
    grid = Image.new("RGB", (2 * w, h))
    for i, v in enumerate(views):
        grid.paste(v.resize((w, h)), (i * w, 0))
    return grid


def test_multiview_to_sequences_to_train_step(tmp_path):
    """The port's side of the L2 → L3 → L6 chain: views for the train
    split, the clean frames as view 00, windows of T 4 at stride 2, and
    one ``cnn_lstm`` epoch on the CPU through ``train_and_evaluate``."""
    from surya_tpu_torch.core.config import (
        Config,
        DataConfig,
        ModelConfig,
        TrainConfig,
    )
    from surya_tpu_torch.core.metrics import MetricsLogger
    from surya_tpu_torch.train import train_and_evaluate

    clean, flat = tmp_path / "clean", tmp_path / "flat"
    rng = np.random.default_rng(0)
    for split in ("train", "valid", "test"):
        for li, label in enumerate(LABELS):
            (clean / split / label).mkdir(parents=True)
            (flat / split / label).mkdir(parents=True)
            for clip in CLIPS:
                for t in range(FRAMES):
                    arr = rng.integers(0, 255, (SIZE, SIZE, 3), np.uint8)
                    arr[:, :, li] //= 2
                    Image.fromarray(arr).save(
                        clean / split / label /
                        f"{clip}_frame_{t:05d}.jpg.png")
                    np.save(flat / split / label /
                            f"{clip}_frame_{t:05d}_frame_{t:05d}.npy",
                            rng.normal(size=47).astype(np.float32))
    aug = tmp_path / "aug"
    report = multiview.process_augmentation(
        str(clean), str(aug), generate_fn=_camera_oracle, rows=1, cols=2,
        splits=("train",))
    assert report["train"]["generated"] == len(LABELS) * len(CLIPS) * FRAMES
    for split in ("train", "valid", "test"):
        for label in LABELS:
            dst = aug / split / label
            dst.mkdir(parents=True, exist_ok=True)
            for f in os.listdir(clean / split / label):
                base = os.path.splitext(f)[0]
                shutil.copy(clean / split / label / f,
                            dst / f"{base}_view_00.png")
    for f in os.listdir(aug / "train" / LABELS[0]):
        assert FILENAME_PATTERN.match(f), f

    seq_root = tmp_path / "seq"
    counts = build_sequence_dataset(str(aug), str(flat), str(seq_root),
                                    seq_len=4, stride=2, image_size=SIZE)
    assert counts["train"] == len(LABELS) * len(CLIPS) * 3 * 2
    assert counts["valid"] == counts["test"] == len(LABELS) * len(CLIPS) * 2
    with open(seq_root / "class_to_idx.json") as f:
        assert sorted(json.load(f)) == sorted(LABELS)

    dcfg = DataConfig(seq_root=str(seq_root), batch_size=8,
                      image_size=SIZE, seq_len=4)
    cfg = Config(model=ModelConfig(name="cnn_lstm", num_classes=2,
                                   seq_len=4, compute_dtype="float32",
                                   freeze_backbone=True),
                 data=dcfg, train=TrainConfig(epochs=1, lr=1e-3, seed=0))
    summary = train_and_evaluate(cfg, SequenceDataSource(dcfg),
                                 logger=MetricsLogger(echo=False),
                                 checkpoints=False, device="cpu")
    assert "test" in summary
    assert np.isfinite(summary["history"][0]["val_loss"])
