"""Offline background removal, ported from
``surya_tpu/augmentgen/background.py``.

Parity with ``Background_remove/batch_remove_background.py:22-128``: for
the target clips, look up each frame's label through the master label CSVs
and the per-clip frame maps, remove the background, and save a transparent
PNG to ``<out>/<split>/<label>/``, skipping outputs that already exist
(restartable, ``:106-107``).

``remove_fn`` backends:

- :func:`u2net_remove_fn`: U²-Net (``models/segmentation/u2net.py``) on
  the card. The resize to the model's input, the saliency map, the alpha
  and its resize back (Pillow's bilinear, ``data/resample.py::
  pil_bilinear_u8``) all run on the device; PIL only reads and writes the
  files.
- :func:`rembg_remove_fn`: the reference's own dependency, a gated import
  that raises without ``rembg``. It stays :func:`process_pipeline`'s
  default: U²-Net is used only when the caller passes it.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from surya_tpu_torch.data.prep.frame_renaming import load_frame_map
from surya_tpu_torch.data.prep.still_image_dataset import load_labels
from surya_tpu_torch.data.resample import pil_bilinear_u8
from surya_tpu_torch.ops import resolve_device


def rembg_remove_fn() -> Callable:
    try:
        from rembg import remove
    except ImportError as e:
        raise ImportError(
            "rembg is required for background removal; install it or "
            "inject remove_fn (u2net_remove_fn runs U²-Net on the card)"
        ) from e

    from PIL import Image

    def fn(src_path: str, dst_path: str):
        with Image.open(src_path) as im:
            out = remove(im)
            out.save(dst_path)

    return fn


def u2net_remove_fn(variables=None, variant: str = "u2netp",
                    size: int = 320, seed: int = 0, device=None) -> Callable:
    """Background removal with U²-Net on ``device`` (the card unless
    named): ``remove(src_path, dst_path)`` writes an RGBA PNG whose alpha
    is the min-max-normalised fused saliency map, rembg's basic
    (non-alpha-matting) output for ``rembg.remove()`` (ref
    ``batch_remove_background.py:114``). The image is resized to size² as
    PIL's bilinear does, the map is quantised to 8 bits and resized back
    the same way, all on the device.

    ``variables``: the port's state_dict, or a JAX variable tree (with
    ``"params"``, bridged by ``models.from_jax``); without, random weights
    from ``seed`` (untrained: the pipeline's plumbing; no pretrained file
    ships)."""
    from PIL import Image

    from surya_tpu_torch.models.common import seeded
    from surya_tpu_torch.models.from_jax import from_jax_variables
    from surya_tpu_torch.models.segmentation.u2net import (
        U2Net,
        import_u2net,
        saliency,
    )

    dev = resolve_device(device)
    if variables is None:
        model = seeded(lambda: U2Net(variant), seed, dev)
    else:
        if "params" in variables:
            variables = from_jax_variables(variables)
        model = import_u2net(variables, variant, dev)
    model.eval()

    def remove(src_path: str, dst_path: str):
        with Image.open(src_path) as im:
            rgb = torch.from_numpy(np.array(im.convert("RGB"))).to(dev)
        h, w, _ = rgb.shape
        small = pil_bilinear_u8(rgb, (size, size))
        with torch.inference_mode():
            alpha = saliency(model, small[None], size)[0]
        a8 = torch.clamp(torch.round(alpha * 255.0), 0, 255).to(torch.uint8)
        a8 = pil_bilinear_u8(a8[..., None], (h, w))
        out = torch.cat([rgb, a8], -1).cpu().numpy()
        Image.fromarray(out, mode="RGBA").save(dst_path)

    return remove


def process_pipeline(renamed_root: str, label_csvs: list[str],
                     out_root: str, target_clips: list[str] | None = None,
                     remove_fn: Callable | None = None,
                     splits=("train", "valid", "test")) -> dict:
    """Returns {split: {"done": n, "skipped": n}}. Resumable."""
    remove_fn = remove_fn or rembg_remove_fn()
    labels = load_labels(label_csvs)
    report: dict = {}
    for split in splits:
        split_dir = os.path.join(renamed_root, split)
        if not os.path.isdir(split_dir):
            continue
        done = skipped = 0
        for clip in sorted(os.listdir(split_dir)):
            if target_clips and clip not in target_clips:
                continue
            clip_dir = os.path.join(split_dir, clip)
            if not os.path.isdir(clip_dir):
                continue
            try:
                fmap = load_frame_map(clip_dir, clip)
            except FileNotFoundError:
                continue
            for new_name, original in sorted(fmap.items()):
                label = labels.get(original)
                if label is None:
                    continue
                dest_dir = os.path.join(out_root, split, label)
                os.makedirs(dest_dir, exist_ok=True)
                stem = os.path.splitext(new_name)[0]
                dst = os.path.join(dest_dir, f"{clip}_{stem}.png")
                if os.path.exists(dst):   # resume (ref :106-107)
                    skipped += 1
                    continue
                remove_fn(os.path.join(clip_dir, new_name), dst)
                done += 1
        report[split] = {"done": done, "skipped": skipped}
    return report
