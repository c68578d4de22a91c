"""The port's state_dicts → the reference's own PyTorch names, for all 11
families: the counterpart of ``surya_tpu/models/full_export.py`` and the
inverse of ``models/full_import.py``.

Every exporter takes the state_dict of the port's model of that family
and returns a flat dict of tensors keyed with the reference's module
naming, so a model trained here goes back to a reference user as a
``.pth`` that the reference's own ``get_model`` loads with
``load_state_dict`` (``python -m surya_tpu_torch export-torch``). The
exporters apply the importers' own module maps the other way, so
``IMPORTERS[name](EXPORTERS[name](sd))`` gives ``sd`` back bit for bit.

What the reference's ``load_state_dict`` expects and the port has no
counterpart for is written out: ``num_batches_tracked`` = 0 for each
BatchNorm, the summed LSTM gate bias as ``bias_ih`` with ``bias_hh`` = 0
(torch always adds the two), and zeros for the unused 1000-class ``fc`` of
the models that hold a whole torchvision resnet (:func:`tv_fc_zeros`). A
space-to-depth stem is unfolded to 7×7.
"""

from __future__ import annotations

import torch

from surya_tpu_torch.models.backbones.torch_import import (
    copy,
    count_indexed,
    export_modules,
    export_resnet,
    export_vit_base,
    pack_qkv,
    stem_kernel_from_s2d,
)
from surya_tpu_torch.models.full_import import (
    FACT_LAYERS,
    _multimodal_stages,
    chw_to_hwc_columns,
    cnn_lstm_modules,
    fact_modules,
    head_modules,
    hierarchical_modules,
    hybrid_modules,
    ji_3dcnn_modules,
    quadrant_side,
    quadtree_3d_modules,
    resnet3d_video_modules,
)

def export_lstm(sd: dict, port: str, ref: str, out: dict) -> None:
    """The port's stacked cells at ``port`` → ``nn.LSTM`` keys at ``ref``."""
    for k in range(count_indexed(sd, f"{port}.OptimizedLSTMCell_")):
        cell = f"{port}.OptimizedLSTMCell_{k}"
        bias = copy(sd[f"{cell}.bias"])
        out[f"{ref}.weight_ih_l{k}"] = copy(sd[f"{cell}.weight_ih"])
        out[f"{ref}.weight_hh_l{k}"] = copy(sd[f"{cell}.weight_hh"])
        out[f"{ref}.bias_ih_l{k}"] = bias
        out[f"{ref}.bias_hh_l{k}"] = torch.zeros_like(bias)


def _unfold_stem(out: dict, key: str) -> None:
    if out[key].shape[-1] == 4:    # the space-to-depth stem variant
        out[key] = stem_kernel_from_s2d(out[key])


def tv_fc_zeros(out: dict, prefix: str, in_features: int,
                classes: int = 1000) -> None:
    """Reference models that wrap a whole torchvision resnet
    (``base_cnn = models.resnet18(...)``) carry its unused 1000-class ``fc``
    in their state_dicts: zeros, so the exported dict loads with torch's
    default ``strict=True``. No reference forward reads it."""
    out[f"{prefix}fc.weight"] = torch.zeros((classes, in_features))
    out[f"{prefix}fc.bias"] = torch.zeros((classes,))


def _trunk_width(sd: dict, prefix: str) -> int:
    blocks = count_indexed(sd, f"{prefix}layer4_block")
    last = f"{prefix}layer4_block{blocks - 1}"
    conv = "conv3" if f"{last}.conv3.weight" in sd else "conv2"
    return sd[f"{last}.{conv}.weight"].shape[0]


# --------------------------------------------------------------------------
# spatial families


def export_quadtree(sd: dict, mode: str = "fusion") -> dict:
    """Inverse of ``import_quadtree``."""
    num_mlp = None if mode == "image_only" else ("0", "3")
    out = export_modules(sd, head_modules(num_mlp))
    if mode == "numerical_only":   # the port's model has no trunk here
        return out
    export_resnet(sd, src="trunk.", dst="base_cnn.", out=out)
    tv_fc_zeros(out, "base_cnn.", _trunk_width(sd, "trunk."))
    k = sd["quadrant_conv_kernel"]                          # HWIO
    out["quadrant_processor.0.weight"] = copy(k.permute(3, 2, 0, 1))
    out["quadrant_processor.0.bias"] = copy(sd["quadrant_conv_bias"])
    fc1, cout = out["classifier.0.weight"], k.shape[3]
    num_dim = 0 if num_mlp is None else \
        out["numerical_mlp.3.weight"].shape[0]
    side = quadrant_side(fc1.shape[1], cout, num_dim)
    out["classifier.0.weight"] = chw_to_hwc_columns(fc1, cout, side,
                                                    inverse=True)
    return out


def export_hierarchical(sd: dict) -> dict:
    out = export_modules(sd, hierarchical_modules(False))
    _unfold_stem(out, "features_extractor.0.weight")
    return out


def export_attention_hierarchical(sd: dict) -> dict:
    out = export_modules(sd, hierarchical_modules(True))
    _unfold_stem(out, "features_extractor.0.weight")
    return out


def export_standard_resnet(sd: dict) -> dict:
    out = export_modules(sd, head_modules())
    export_resnet(sd, src="trunk.resnet.", dst="base_cnn.", out=out)
    tv_fc_zeros(out, "base_cnn.", _trunk_width(sd, "trunk.resnet."))
    return out


def export_standard_multimodal(sd: dict, backbone: str = "resnet18") -> dict:
    out = export_modules(sd, head_modules(("0", "3")))
    return export_resnet(sd, *_multimodal_stages(backbone),
                         src="trunk.resnet.", dst="backbone.", out=out)


# --------------------------------------------------------------------------
# temporal families


def export_cnn_lstm(sd: dict) -> dict:
    out = export_modules(sd, cnn_lstm_modules())
    _unfold_stem(out, "cnn_backbone.0.weight")
    export_lstm(sd, "lstm", "lstm", out)
    return out


def export_ji_3dcnn(sd: dict) -> dict:
    out = export_modules(sd, ji_3dcnn_modules())
    export_lstm(sd, "numerical_lstm", "numerical_lstm", out)
    return out


def export_quadtree_3d(sd: dict, mode: str = "fusion") -> dict:
    out = export_modules(sd, quadtree_3d_modules(mode))
    if mode == "fusion":
        export_lstm(sd, "numerical_lstm", "numerical_lstm", out)
    return out


def export_resnet3d_video(sd: dict) -> dict:
    return export_modules(sd, resnet3d_video_modules())


def export_hybrid_quadtree_3d(sd: dict, mode: str = "fusion") -> dict:
    out = export_modules(sd, hybrid_modules(mode))
    if mode == "fusion":
        export_lstm(sd, "numerical_lstm", "numerical_lstm", out)
    return out


def export_fact(sd: dict) -> dict:
    layers = count_indexed(sd, "fusion")
    out = export_modules(sd, fact_modules(layers))
    export_vit_base(sd, src="vit_backbone.", dst="vit_backbone.", out=out)
    d = sd["cls_token"].shape[-1]
    out["token_type_embed.weight"] = copy(sd["token_type_embed"])
    out["cls_token"] = copy(sd["cls_token"]).reshape(1, 1, d)
    out["pos_embed"] = copy(sd["pos_embed"])
    for i in range(layers):
        w, b = pack_qkv(sd, f"fusion{i}.attn")
        out[f"{FACT_LAYERS}{i}.self_attn.in_proj_weight"] = w
        out[f"{FACT_LAYERS}{i}.self_attn.in_proj_bias"] = b
    return out


EXPORTERS = {
    "quadtree": export_quadtree,
    "hierarchical_quadtree": export_hierarchical,
    "attention_hierarchical": export_attention_hierarchical,
    "standard_resnet": export_standard_resnet,
    "standard_multimodal": export_standard_multimodal,
    "cnn_lstm": export_cnn_lstm,
    "ji_3dcnn": export_ji_3dcnn,
    "quadtree_3d": export_quadtree_3d,
    "resnet3d_video": export_resnet3d_video,
    "hybrid_quadtree_3d": export_hybrid_quadtree_3d,
    "fact": export_fact,
}


def export_reference_state_dict(name: str, sd: dict, **kw) -> dict:
    """The port's state_dict of family ``name`` → reference-named tensors;
    ``kw`` as for ``full_import.load_reference_state_dict``."""
    if name not in EXPORTERS:
        raise ValueError(f"no reference exporter for model {name!r}; "
                         f"families: {sorted(EXPORTERS)}")
    return EXPORTERS[name](sd, **kw)
