"""Hierarchical feature maps, mirroring ``surya_tpu/interpret/featmaps.py``:
the layer2 base map and its level-1 and level-2 quadrants as channel-mean
heatmaps, and a headless matplotlib plot of the three with quadrant grid
lines. The maps come from the trunk alone (its ``upto="layer2"``)."""

from __future__ import annotations

import numpy as np
import torch

from surya_tpu_torch.core.config import ModelConfig
from surya_tpu_torch.models.backbones.resnet import make_resnet, stem_is_s2d
from surya_tpu_torch.ops import resolve_device
from surya_tpu_torch.ops.quadtree import quadrant_split


@torch.no_grad()
def hierarchy_maps(cfg: ModelConfig, state_dict, images, device=None):
    """→ {"base": (B, 28, 28), "level1": (B, 4, 14, 14), "level2": (B, 16,
    7, 7)} channel means at 224 px, numpy, from a model state_dict whose
    trunk is ``trunk.*``; f32, eval mode, on the card unless
    ``device="cpu"``."""
    device = resolve_device(device)
    trunk_sd = {k[len("trunk."):]: v for k, v in state_dict.items()
                if k.startswith("trunk.")}
    trunk = make_resnet(cfg.backbone, dtype=torch.float32,
                        stem_s2d=stem_is_s2d(trunk_sd))
    trunk.load_state_dict(trunk_sd, strict=True)
    trunk = trunk.to(device, memory_format=torch.channels_last).eval()
    x = torch.as_tensor(images, dtype=torch.float32).to(device)
    base = trunk(x, upto="layer2")["out"]
    b = base.shape[0]
    l1 = quadrant_split(base)
    l2 = quadrant_split(l1)

    def cmean(t, k):
        m = t.mean(dim=-1)
        return m.reshape(b, k, *m.shape[1:]).cpu().numpy()

    return {"base": base.mean(dim=-1).cpu().numpy(),
            "level1": cmean(l1, 4), "level2": cmean(l2, 16)}


def plot_hierarchy(maps: dict, sample: int = 0, out_path: str | None = None):
    """Render the base / level-1 / level-2 heatmaps of one sample side by
    side with quadrant grid lines (headless); save to ``out_path`` if given
    (and return it), else return the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    base = maps["base"][sample]
    l1 = maps["level1"][sample]          # (4, h, w)
    grid1 = np.block([[l1[0], l1[1]], [l1[2], l1[3]]])
    l2 = maps["level2"][sample]          # (16, h, w)
    # index q1*4 + q2 (quadrant, then sub-quadrant, raster order) → its
    # cell (row, col), so the panel lines up with the other two
    cells = np.empty((4, 4), object)
    for q1 in range(4):
        for q2 in range(4):
            cells[(q1 // 2) * 2 + q2 // 2,
                  (q1 % 2) * 2 + q2 % 2] = l2[q1 * 4 + q2]
    grid2 = np.block(cells.tolist())
    for ax, img, title in zip(axes, (base, grid1, grid2),
                              ("base map (layer2)", "level-1 quadrants",
                               "level-2 sub-quadrants")):
        ax.imshow(img, cmap="viridis")
        ax.axhline(img.shape[0] / 2 - 0.5, color="w", lw=1)
        ax.axvline(img.shape[1] / 2 - 0.5, color="w", lw=1)
        ax.set_title(title)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
        return out_path
    return fig
