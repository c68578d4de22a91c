"""torchvision / timm backbone checkpoints ↔ the port's parameter names,
the counterpart of ``surya_tpu/models/backbones/torch_import.py``.

The reference initialises its backbones from torchvision ImageNet and
Kinetics weights and timm's ViT-B/16. The port keeps torch's own weight
layouts (OIHW convolutions, (out, in) Linear weights), so a converter
renames modules and leaves the values alone, except where the layouts do
differ:

- timm's fused ``attn.qkv`` (3·D, D) splits into the port's ``query``,
  ``key`` and ``value`` (D, D) Linear weights (``models/backbones/vit.py``);
- the space-to-depth stem (``stem_s2d``) folds the 7×7 stem kernel into a
  (CO, 4C, 4, 4) one (``resnet.stem_kernel_to_s2d``; the exporter unfolds
  it with :func:`stem_kernel_from_s2d`);
- BatchNorm's ``num_batches_tracked`` has no counterpart in the port: the
  importer drops it and the exporter writes 0.

A *module map* is a list of ``(reference module, port module, kind)``:
kind ``"bn"`` is a BatchNorm (weight, bias, running mean and variance),
kind ``"p"`` any other module whose ``weight`` (and ``bias``, where it has
one) keeps its layout. :func:`import_modules` and :func:`export_modules`
apply one map in the two directions, so an exporter is the importer's exact
inverse. Imported values are f32 copies, as
``models.from_jax.from_jax_variables`` gives them.
"""

from __future__ import annotations

import torch

from surya_tpu_torch.models.backbones.resnet import stem_kernel_to_s2d

BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
_LEAVES = {"bn": BN_LEAVES, "p": ("weight", "bias")}


def f32(t) -> torch.Tensor:
    """A contiguous f32 copy of a tensor or an array."""
    return torch.as_tensor(t).detach().to(torch.float32, copy=True) \
        .contiguous()


def copy(t) -> torch.Tensor:
    """A contiguous copy in the tensor's own dtype."""
    return torch.as_tensor(t).detach().clone().contiguous()


def _move(sd, modules, src, dst, out, convert, flip: bool) -> dict:
    for ref, port, kind in modules:
        a, b = (port, ref) if flip else (ref, port)
        for leaf in _LEAVES[kind]:
            key = f"{src}{a}.{leaf}"
            if key in sd:
                out[f"{dst}{b}.{leaf}"] = convert(sd[key])
            elif kind == "bn" or leaf == "weight":
                raise KeyError(f"missing {key!r}")
        if flip and kind == "bn":
            out[f"{dst}{b}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64)
    return out


def import_modules(sd: dict, modules, src: str = "", dst: str = "",
                   out: dict | None = None) -> dict:
    """Reference keys ``src + ref`` → port keys ``dst + port`` (f32)."""
    return _move(sd, modules, src, dst, {} if out is None else out, f32,
                 flip=False)


def export_modules(sd: dict, modules, src: str = "", dst: str = "",
                   out: dict | None = None) -> dict:
    """Port keys ``src + port`` → reference keys ``dst + ref``, with
    ``num_batches_tracked`` = 0 for each BatchNorm."""
    return _move(sd, modules, src, dst, {} if out is None else out, copy,
                 flip=True)


def reroot(modules, roots: dict) -> list:
    """The map with each reference module's first path component renamed
    (``{"conv1": "features_extractor.0", ...}``), for a reference model that
    holds a backbone's children in an ``nn.Sequential``."""
    out = []
    for ref, port, kind in modules:
        head, _, rest = ref.partition(".")
        out.append((roots[head] + (f".{rest}" if rest else ""), port, kind))
    return out


# --------------------------------------------------------------------------
# ResNet (torchvision resnet18/34/50)

STAGES = {"resnet18": ((2, 2, 2, 2), False), "resnet34": ((3, 4, 6, 3), False),
          "resnet50": ((3, 4, 6, 3), True)}


def resnet_modules(stage_sizes=(2, 2, 2, 2), bottleneck: bool = False):
    """torchvision ``conv1``/``bn1``/``layerX.Y.*`` → the port's
    ``conv1``/``bn1``/``layerX_blockY.*`` (``downsample.0``/``.1`` →
    ``downsample_conv``/``downsample_bn``)."""
    mods = [("conv1", "conv1", "p"), ("bn1", "bn1", "bn")]
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            ref, port = f"layer{i + 1}.{j}", f"layer{i + 1}_block{j}"
            for k in range(1, 4 if bottleneck else 3):
                mods += [(f"{ref}.conv{k}", f"{port}.conv{k}", "p"),
                         (f"{ref}.bn{k}", f"{port}.bn{k}", "bn")]
            if j == 0 and (i > 0 or bottleneck):
                mods += [(f"{ref}.downsample.0", f"{port}.downsample_conv",
                          "p"),
                         (f"{ref}.downsample.1", f"{port}.downsample_bn",
                          "bn")]
    return mods


def stem_kernel_from_s2d(w4: torch.Tensor) -> torch.Tensor:
    """(CO, 4C, 4, 4) space-to-depth stem weight → the (CO, C, 7, 7) one
    (the inverse of ``resnet.stem_kernel_to_s2d``)."""
    co, c = w4.shape[0], w4.shape[1] // 4
    w8 = w4.reshape(co, 2, 2, c, 4, 4).permute(0, 3, 4, 1, 5, 2)
    return w8.reshape(co, c, 8, 8)[:, :, 1:, 1:].contiguous()


def import_resnet(sd: dict, stage_sizes=(2, 2, 2, 2),
                  bottleneck: bool = False, stem_s2d: bool = False) -> dict:
    """A torchvision resnet state_dict → the port's ``ResNet`` one (the
    unused ``fc`` dropped). ``stem_s2d`` folds the stem for the
    space-to-depth variant."""
    out = import_modules(sd, resnet_modules(stage_sizes, bottleneck))
    if stem_s2d:
        out["conv1.weight"] = stem_kernel_to_s2d(out["conv1.weight"])
    return out


def import_resnet18(sd: dict) -> dict:
    return import_resnet(sd, *STAGES["resnet18"])


def import_resnet50(sd: dict) -> dict:
    return import_resnet(sd, *STAGES["resnet50"])


def export_resnet(sd: dict, stage_sizes=(2, 2, 2, 2),
                  bottleneck: bool = False, src: str = "",
                  dst: str = "", out: dict | None = None) -> dict:
    """The port's ``ResNet`` keys under ``src`` → torchvision names under
    ``dst``; a space-to-depth stem is unfolded to 7×7."""
    out = export_modules(sd, resnet_modules(stage_sizes, bottleneck), src,
                         dst, out)
    w = out[f"{dst}conv1.weight"]
    if w.shape[-1] == 4:
        out[f"{dst}conv1.weight"] = stem_kernel_from_s2d(w)
    return out


# --------------------------------------------------------------------------
# r3d_18 (torchvision video)


def r3d18_modules():
    """torchvision ``stem.0``/``stem.1`` and ``layerX.Y.convK.0``/``.1``
    → the port's ``stem_conv``/``stem_bn`` and ``layerX_blockY.convK``/
    ``bnK``."""
    mods = [("stem.0", "stem_conv", "p"), ("stem.1", "stem_bn", "bn")]
    for i in range(4):
        for j in range(2):
            ref, port = f"layer{i + 1}.{j}", f"layer{i + 1}_block{j}"
            for k in (1, 2):
                mods += [(f"{ref}.conv{k}.0", f"{port}.conv{k}", "p"),
                         (f"{ref}.conv{k}.1", f"{port}.bn{k}", "bn")]
            if j == 0 and i > 0:
                mods += [(f"{ref}.downsample.0", f"{port}.downsample_conv",
                          "p"),
                         (f"{ref}.downsample.1", f"{port}.downsample_bn",
                          "bn")]
    return mods


def import_r3d18(sd: dict) -> dict:
    """A torchvision r3d_18 state_dict → the port's ``ResNet3D`` one."""
    return import_modules(sd, r3d18_modules())


def export_r3d18(sd: dict, src: str = "", dst: str = "",
                 out: dict | None = None) -> dict:
    return export_modules(sd, r3d18_modules(), src, dst, out)


# --------------------------------------------------------------------------
# ViT-B/16 (timm)

_QKV = ("query", "key", "value")


def vit_modules(depth: int):
    """timm names → the port's ``ViT`` (all but qkv, cls and position)."""
    mods = [("patch_embed.proj", "patch_embed", "p"),
            ("norm", "ln_final", "p")]
    for i in range(depth):
        ref, port = f"blocks.{i}", f"block{i}"
        mods += [(f"{ref}.norm1", f"{port}.ln1", "p"),
                 (f"{ref}.norm2", f"{port}.ln2", "p"),
                 (f"{ref}.attn.proj", f"{port}.attn.out", "p"),
                 (f"{ref}.mlp.fc1", f"{port}.mlp.fc1", "p"),
                 (f"{ref}.mlp.fc2", f"{port}.mlp.fc2", "p")]
    return mods


def count_indexed(sd: dict, prefix: str) -> int:
    """How many indices ``i`` the keys ``prefix{i}...`` hold."""
    seen = {k[len(prefix):].split(".")[0] for k in sd if k.startswith(prefix)}
    return len({s for s in seen if s.isdigit()})


def split_packed(out: dict, port: str, weight, bias) -> None:
    """A packed (3·D, D) projection and its bias → the port's ``query``,
    ``key`` and ``value`` Linears under ``port``."""
    for name, w, b in zip(_QKV, f32(weight).chunk(3), f32(bias).chunk(3)):
        out[f"{port}.{name}.weight"] = w.clone()
        out[f"{port}.{name}.bias"] = b.clone()


def pack_qkv(sd: dict, port: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The inverse of :func:`split_packed`: (3·D, D) weight, (3·D,) bias."""
    return (torch.cat([copy(sd[f"{port}.{n}.weight"]) for n in _QKV]),
            torch.cat([copy(sd[f"{port}.{n}.bias"]) for n in _QKV]))


def import_vit_base(sd: dict) -> dict:
    """A timm ``vit_base_patch16_224`` state_dict (any depth and width)
    → the port's ``ViT`` one."""
    depth = count_indexed(sd, "blocks.")
    out = import_modules(sd, vit_modules(depth))
    d = sd["cls_token"].shape[-1]
    out["cls_token"] = f32(sd["cls_token"]).reshape(1, 1, d)
    out["pos_embed"] = f32(sd["pos_embed"])
    for i in range(depth):
        split_packed(out, f"block{i}.attn", sd[f"blocks.{i}.attn.qkv.weight"],
                     sd[f"blocks.{i}.attn.qkv.bias"])
    return out


def export_vit_base(sd: dict, src: str = "", dst: str = "",
                    out: dict | None = None) -> dict:
    """The port's ``ViT`` keys under ``src`` → timm names under ``dst``."""
    depth = count_indexed(sd, f"{src}block")
    out = export_modules(sd, vit_modules(depth), src, dst, out)
    d = sd[f"{src}cls_token"].shape[-1]
    out[f"{dst}cls_token"] = copy(sd[f"{src}cls_token"]).reshape(1, 1, d)
    out[f"{dst}pos_embed"] = copy(sd[f"{src}pos_embed"])
    for i in range(depth):
        w, b = pack_qkv(sd, f"{src}block{i}.attn")
        out[f"{dst}blocks.{i}.attn.qkv.weight"] = w
        out[f"{dst}blocks.{i}.attn.qkv.bias"] = b
    return out
