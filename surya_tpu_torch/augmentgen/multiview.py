"""Offline Zero123-Plus multiview augmentation, ported from
``surya_tpu/augmentgen/multiview.py``.

Parity with ``Zero123/batch_aug.py:20-148``: for each clean
(background-removed) PNG a diffusion pipeline generates a 3×2 grid of novel
viewpoints, sliced into 6 view images ``<base>_view_%02d.png``; a run
resumes by checking the first view's existence (``:110-114``). The default
75 inference steps match ``:136-143`` (``--steps``).

``generate_fn`` backends:

- :func:`zero123plus_unet_generate_fn`: the zero123plus pipeline's shape
  on the card: VAE-encode the conditioning tile, the reference-attention
  SD2 UNet under the trailing Euler-Ancestral v-prediction sampler in
  latent space, VAE-decode the 3×2 grid.
- :func:`torch_diffusion_generate_fn`: the same sampler in pixel space
  over ``TinyDenoiser`` (JAX's ``jax_diffusion_generate_fn``).
- :func:`zero123plus_generate_fn`: the reference's diffusers adapter, a
  gated import that raises without ``diffusers``. It stays
  :func:`process_augmentation`'s default.
- any injected callable (tests).

The conditioning resizes run on the device (``data/resample.py::
pil_bilinear_u8``, Pillow's bilinear); PIL reads, slices and writes.
No pretrained weight ships or is downloaded: the models take random
weights from a seed, or converted ones through ``import_unet`` /
``import_vae``.

    python -m surya_tpu_torch.augmentgen.multiview CLEAN_ROOT OUT \\
        --steps 75 --backend torch [--device cpu]
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from surya_tpu_torch.data.resample import pil_bilinear_u8
from surya_tpu_torch.ops import resolve_device


def slice_grid_in_memory(grid_img, rows: int = 3, cols: int = 2):
    """Slice a (rows×cols) tiled image into row-major crops
    (``batch_aug.py:20-45``)."""
    w, h = grid_img.size
    tile_w, tile_h = w // cols, h // rows
    views = []
    for r in range(rows):
        for c in range(cols):
            box = (c * tile_w, r * tile_h,
                   (c + 1) * tile_w, (r + 1) * tile_h)
            views.append(grid_img.crop(box))
    return views


def zero123plus_generate_fn(num_steps: int = 75) -> Callable:
    try:
        from diffusers import DiffusionPipeline, EulerAncestralDiscreteScheduler
    except ImportError as e:
        raise ImportError(
            "diffusers is required for multiview generation; install it "
            "or inject generate_fn (--backend torch runs the port's "
            "sampler)") from e

    pipeline = DiffusionPipeline.from_pretrained(
        "sudo-ai/zero123plus-v1.1",
        custom_pipeline="sudo-ai/zero123plus-pipeline",
        torch_dtype=torch.float16)
    pipeline.scheduler = EulerAncestralDiscreteScheduler.from_config(
        pipeline.scheduler.config, timestep_spacing="trailing")

    def fn(image):
        return pipeline(image, num_inference_steps=num_steps).images[0]

    return fn


def conditioning_pixels(image, size: tuple[int, int], device
                        ) -> torch.Tensor:
    """A PIL image → (1, h, w, 3) f32 in [−1, 1] on ``device``: RGB,
    resized as Pillow's bilinear does, /127.5 − 1."""
    rgb = torch.from_numpy(np.array(image.convert("RGB"))).to(device)
    return (pil_bilinear_u8(rgb, size).float() / 127.5 - 1.0)[None]


class Draws(NamedTuple):
    """The standard-normal draws of one image's trajectory: the start
    (``init``) and each step's ancestral noise (``steps``), as
    ``euler_ancestral.sample`` takes them; on the zero123plus path also the
    VAE posterior draw of the conditioning latents (``cond_latent``) and
    each step's cond noise (``cond``). A draw left None comes from the
    generator."""
    init: torch.Tensor | None = None
    steps: Sequence[torch.Tensor] | None = None
    cond_latent: torch.Tensor | None = None
    cond: Sequence[torch.Tensor] | None = None


def image_draws(draws: Callable[[int], Draws] | None, device):
    """→ a function that gives the next image's :class:`Draws`, moved to
    ``device`` as f32: ``draws(n)`` for the n-th image (from 0), or no
    draw at all when ``draws`` is None."""
    count = [0]

    def move(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x.to(device, torch.float32)
        return [n.to(device, torch.float32) for n in x]

    def next_draws():
        if draws is None:
            return Draws()
        count[0] += 1
        return Draws(*map(move, draws(count[0] - 1)))

    return next_draws


def to_image(pixels: torch.Tensor):
    """(1, H, W, 3) in [−1, 1] → a PIL image: (x + 1)·127.5 clipped to
    [0, 255] and truncated to uint8, as JAX's ``astype`` does."""
    from PIL import Image

    out = torch.clamp((pixels[0] + 1.0) * 127.5, 0, 255).to(torch.uint8)
    return Image.fromarray(out.cpu().numpy())


def torch_diffusion_generate_fn(denoiser=None, state_dict=None,
                                num_steps: int = 75, tile: int = 320,
                                rows: int = 3, cols: int = 2,
                                prediction_type: str = "v_prediction",
                                seed: int = 0, device=None,
                                draws: Callable[[int], Draws] | None = None
                                ) -> Callable:
    """Grid generation in pixel space: Euler-Ancestral (trailing spacing,
    as the reference configures diffusers at ``batch_aug.py:59-67``) over
    a conditional denoiser, on ``device`` (the card unless named).

    ``denoiser(scaled, t, cond) -> model_output`` where cond is the clean
    input resized to the grid, in [−1, 1]. Defaults to ``TinyDenoiser``
    with ``state_dict`` or random weights from ``seed`` (untrained:
    plumbing only). The n-th image's draws are ``draws(n)``
    (:class:`Draws`), else they come from one generator on the device,
    seeded with ``seed``, consumed image after image."""
    from surya_tpu_torch.models.common import seeded
    from surya_tpu_torch.models.diffusion import (
        EulerAncestralSchedule,
        TinyDenoiser,
        sample,
    )

    dev = resolve_device(device)
    gh, gw = rows * tile, cols * tile
    if denoiser is None:
        if state_dict is None:
            model = seeded(TinyDenoiser, seed, dev)
        else:
            model = TinyDenoiser().to(dev)
            model.load_state_dict(state_dict, strict=True)
        denoiser = model.eval()
    schedule = EulerAncestralSchedule.create(
        num_steps, timestep_spacing="trailing",
        prediction_type=prediction_type)
    generator = torch.Generator(dev).manual_seed(seed)
    next_draws = image_draws(draws, dev)

    def fn(image):
        cond = conditioning_pixels(image, (gh, gw), dev)
        d = next_draws()
        with torch.inference_mode():
            out = sample(schedule,
                         lambda scaled, t, i: denoiser(scaled, t, cond),
                         (1, gh, gw, 3), generator=generator,
                         init_noise=d.init, step_noise=d.steps)
        return to_image(out)

    return fn


def zero123plus_unet_generate_fn(unet, vae, encoder_hidden_states,
                                 num_steps: int = 75, tile: int = 320,
                                 rows: int = 3, cols: int = 2,
                                 seed: int = 0,
                                 draws: Callable[[int], Draws] | None = None
                                 ) -> Callable:
    """The zero123plus pipeline's shape on the models' device: VAE-encode
    the clean conditioning image at ``tile``, sample its latents ×
    ``SD_SCALING_FACTOR``, run the two-pass reference-attention denoiser
    through the trailing-spacing Euler-Ancestral v-prediction trajectory
    over the (rows·tile/f, cols·tile/f, latent) grid, VAE-decode it.

    ``unet`` and ``vae`` are the port's models (random weights from a
    seed, or ``import_unet``/``import_vae`` of converted files);
    ``encoder_hidden_states`` is the (1, S, cross_dim) cross-attention
    context (upstream: the empty-prompt CLIP text embedding plus the
    ramped CLIP vision embedding; no CLIP weights ship, so it is an
    explicit input). The n-th image's draws are ``draws(n)``
    (:class:`Draws`), else they come from one generator on the device,
    seeded with ``seed``."""
    from surya_tpu_torch.models.diffusion import (
        EulerAncestralSchedule,
        reference_conditioned_denoiser,
        sample,
    )
    from surya_tpu_torch.models.diffusion.vae import (
        SD_SCALING_FACTOR,
        sample_latents,
    )

    dev = next(unet.parameters()).device
    factor = 2 ** (len(vae.config.block_out_channels) - 1)
    gh, gw = rows * tile, cols * tile
    lat_shape = (1, gh // factor, gw // factor, vae.config.latent_channels)
    schedule = EulerAncestralSchedule.create(
        num_steps, timestep_spacing="trailing",
        prediction_type="v_prediction")
    ehs = torch.as_tensor(encoder_hidden_states, device=dev)
    generator = torch.Generator(dev).manual_seed(seed)
    next_draws = image_draws(draws, dev)

    def fn(image):
        cond_px = conditioning_pixels(image, (tile, tile), dev)
        d = next_draws()
        with torch.inference_mode():
            mean, logvar = vae.encode(cond_px)
            cond_lat = sample_latents(
                mean, logvar, noise=d.cond_latent,
                generator=generator) * SD_SCALING_FACTOR
            denoiser = reference_conditioned_denoiser(
                unet, schedule, ehs, cond_lat, generator=generator,
                cond_noise=None if d.cond is None else d.cond.__getitem__)
            latents = sample(schedule, denoiser, lat_shape,
                             generator=generator, init_noise=d.init,
                             step_noise=d.steps)
            out = vae.decode(latents / SD_SCALING_FACTOR)
        return to_image(out)

    return fn


def process_augmentation(clean_root: str, out_root: str,
                         generate_fn: Callable | None = None,
                         num_steps: int = 75, rows: int = 3,
                         cols: int = 2,
                         splits=("train", "valid", "test")) -> dict:
    """Walk <clean_root>/<split>/<label>/*.png; write 6 view crops per
    image under the same relative layout. Resumable via the first view's
    existence. Returns {split: {"generated": n, "skipped": n}}."""
    from PIL import Image

    generate_fn = generate_fn or zero123plus_generate_fn(num_steps)
    report: dict = {}
    n_views = rows * cols
    for split in splits:
        split_dir = os.path.join(clean_root, split)
        if not os.path.isdir(split_dir):
            continue
        generated = skipped = 0
        for label in sorted(os.listdir(split_dir)):
            ldir = os.path.join(split_dir, label)
            if not os.path.isdir(ldir):
                continue
            out_dir = os.path.join(out_root, split, label)
            os.makedirs(out_dir, exist_ok=True)
            for fname in sorted(os.listdir(ldir)):
                if not fname.lower().endswith(".png"):
                    continue
                base = os.path.splitext(fname)[0]
                first = os.path.join(out_dir, f"{base}_view_01.png")
                if os.path.exists(first):   # resume (ref :110-114)
                    skipped += 1
                    continue
                with Image.open(os.path.join(ldir, fname)) as im:
                    grid = generate_fn(im.convert("RGB"))
                for vi, view in enumerate(
                        slice_grid_in_memory(grid, rows, cols)):
                    view.save(os.path.join(
                        out_dir, f"{base}_view_{vi + 1:02d}.png"))
                generated += 1
        report[split] = {"generated": generated, "skipped": skipped,
                         "views_per_image": n_views}
    return report


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m surya_tpu_torch.augmentgen.multiview")
    ap.add_argument("clean_root")
    ap.add_argument("out_root")
    ap.add_argument("--steps", type=int, default=75)
    ap.add_argument("--backend", choices=("diffusers", "torch"),
                    default="diffusers",
                    help="torch = the port's Euler-Ancestral sampler over "
                         "TinyDenoiser (random weights from seed 0); "
                         "diffusers = the reference's pipeline")
    ap.add_argument("--device", default=None,
                    help="torch backend: the card unless 'cpu'")
    args = ap.parse_args(argv)
    gen = (torch_diffusion_generate_fn(num_steps=args.steps,
                                       device=args.device)
           if args.backend == "torch" else None)
    print(process_augmentation(args.clean_root, args.out_root,
                               generate_fn=gen, num_steps=args.steps))


if __name__ == "__main__":
    main()
