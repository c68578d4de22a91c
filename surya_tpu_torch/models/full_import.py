"""The reference's own PyTorch checkpoints → the port's state_dicts, for
all 11 families: the counterpart of ``surya_tpu/models/full_import.py``.

Every importer takes a ``state_dict`` with the reference's module naming
(so a real reference checkpoint loads directly) and returns the state_dict
that the port's model of that family loads with ``strict=True``;
:func:`load_reference_state_dict` picks the importer by family name. The
mapping goes straight from the reference's names to the port's, with the
backbone maps of ``models/backbones/torch_import.py``, and gives the same
values as JAX's importer followed by ``models.from_jax.from_jax_variables``
(``tests/test_torch_reference_weights.py`` holds them bit-equal, and the
port's logits to the reference mirrors').

Reference key roots per family (as in JAX's module):

- quadtree            base_cnn.*, quadrant_processor.0, numerical_mlp.{0,3},
  classifier.{0,3}
- hierarchical        features_extractor.{0,1,4,5}, global_processor.{0,1},
  quadrant_processor.0, sub_quadrant_processor.0, numerical_mlp.0,
  classifier.{0,3}
- attention           hierarchical + attention_gate.{0,2}
- standard_resnet     base_cnn.*, classifier.{0,3}
- standard_multimodal backbone.*, numerical_mlp.{0,3}, classifier.{0,3}
- cnn_lstm            cnn_backbone.{0,1,4..7}, numerical_mlp.{0,2}, lstm.*,
  classifier.{0,3}
- ji_3dcnn            visual_stream.{0,2,4}, numerical_lstm.*,
  classifier.{0,3}
- quadtree_3d         conv3d_block{1..3}, conv3d_block4_new,
  conv3d_final_features, numerical_lstm, numerical_projection.0,
  classifier.{0,3}
- resnet3d_video      r3d_model.* (+ fc.{0,3})
- hybrid_quadtree_3d  pretrained_image_extractor.{0..4}, numerical_lstm,
  numerical_projection.0, classifier.{0,3}
- fact                vit_backbone.*, numerical_projector.{0,2},
  fusion_transformer.layers.*, cls_token, pos_embed, token_type_embed,
  classification_head.{0,1}

Where the layouts differ:

- the quadrant block's conv weight is OIHW in the reference and HWIO
  (``quadrant_conv_kernel``, the layout the quadrant kernel reads) here;
- the quadtree classifier's first Linear reads four flattened (C, H, W)
  quadrant maps in the reference and (H, W, C) ones here (the model
  flattens NHWC): its input columns are permuted block by block
  (:func:`chw_to_hwc_columns`);
- ``nn.LSTM``'s ``weight_ih_l{k}``/``weight_hh_l{k}`` become layer k's
  ``OptimizedLSTMCell_{k}.weight_ih``/``weight_hh`` and its two biases one
  ``bias = bias_ih + bias_hh`` (torch always adds them);
- an ``nn.TransformerEncoderLayer``'s packed ``in_proj_weight`` splits into
  ``query``/``key``/``value`` (``models/temporal/fact.py``).

The port's numerical-only quadtree has no trunk and no quadrant block, so
its importer leaves the reference's unused ones out.
"""

from __future__ import annotations

import math

import torch

from surya_tpu_torch.models.backbones.torch_import import (
    STAGES,
    count_indexed,
    f32,
    import_modules,
    import_vit_base,
    r3d18_modules,
    resnet_modules,
    reroot,
    split_packed,
)

QUADRANT_OFFSET = 512   # the global-pool features come first


def head_modules(num_mlp=None):
    """The classifier ``Sequential(Linear, ReLU, Dropout, Linear)`` at
    ``classifier.{0,3}`` → ``classifier.fc1``/``fc2``; with ``num_mlp``
    (reference indices), the numerical MLP's Linears too."""
    mods = [("classifier.0", "classifier.fc1", "p"),
            ("classifier.3", "classifier.fc2", "p")]
    if num_mlp:
        mods += [(f"numerical_mlp.{i}", f"numerical_mlp.fc{k + 1}", "p")
                 for k, i in enumerate(num_mlp)]
    return mods


def quadrant_side(fc1_in: int, cout: int, num_dim: int) -> int:
    """The side of one pooled quadrant map, from the classifier's input
    width: 512 global features, four (side, side, cout) maps, ``num_dim``
    numerical features."""
    span = (fc1_in - QUADRANT_OFFSET - num_dim) // 4
    side = math.isqrt(span // cout)
    if side * side * cout != span:
        raise ValueError(f"classifier input {fc1_in} does not hold four "
                         f"square {cout}-channel quadrant maps")
    return side


def _column_order(c: int, side: int, inverse: bool) -> torch.Tensor:
    # idx[j_hwc] = j_chw of the same (h, w, c) element
    idx = torch.arange(c * side * side).reshape(c, side, side) \
        .permute(1, 2, 0).reshape(-1)
    return torch.argsort(idx) if inverse else idx


def chw_to_hwc_columns(w: torch.Tensor, c: int, side: int,
                       inverse: bool = False) -> torch.Tensor:
    """Permute the input columns of a (out, in) weight: the four quadrant
    blocks after the first 512 go from CHW-flat to HWC-flat order (or back,
    with ``inverse``)."""
    w = w.clone()
    span, order = c * side * side, _column_order(c, side, inverse)
    for q in range(4):
        s = QUADRANT_OFFSET + q * span
        w[:, s:s + span] = w[:, s:s + span][:, order]
    return w


def import_lstm(sd: dict, ref: str, port: str, out: dict) -> None:
    """``nn.LSTM`` at ``ref`` → the port's stacked cells at ``port``."""
    for k in range(count_indexed(sd, f"{ref}.weight_ih_l")):
        cell = f"{port}.OptimizedLSTMCell_{k}"
        out[f"{cell}.weight_ih"] = f32(sd[f"{ref}.weight_ih_l{k}"])
        out[f"{cell}.weight_hh"] = f32(sd[f"{ref}.weight_hh_l{k}"])
        out[f"{cell}.bias"] = (f32(sd[f"{ref}.bias_ih_l{k}"])
                               + f32(sd[f"{ref}.bias_hh_l{k}"]))


def encoder_modules(ref: str, port: str):
    """``nn.TransformerEncoderLayer`` (post-LN) → ``PostLNEncoderLayer``,
    all but the packed input projection."""
    return [(f"{ref}.self_attn.out_proj", f"{port}.attn.out", "p"),
            (f"{ref}.norm1", f"{port}.ln1", "p"),
            (f"{ref}.norm2", f"{port}.ln2", "p"),
            (f"{ref}.linear1", f"{port}.ff1", "p"),
            (f"{ref}.linear2", f"{port}.ff2", "p")]


# --------------------------------------------------------------------------
# spatial families


def import_quadtree(sd: dict, mode: str = "fusion") -> dict:
    """QuadtreeCNN (``Quadtree_from scratch/models.py:214-305`` naming; the
    ablation variant ``experiment/models_cnn.py:6-116`` uses the same)."""
    out = {}
    num_mlp = None if mode == "image_only" else ("0", "3")
    import_modules(sd, head_modules(num_mlp), out=out)
    if mode == "numerical_only":
        return out
    import_modules(sd, resnet_modules(), "base_cnn.", "trunk.", out)
    w = f32(sd["quadrant_processor.0.weight"])               # OIHW
    out["quadrant_conv_kernel"] = w.permute(2, 3, 1, 0).contiguous()
    out["quadrant_conv_bias"] = f32(sd["quadrant_processor.0.bias"])
    fc1 = out["classifier.fc1.weight"]
    num_dim = 0 if num_mlp is None else \
        out["numerical_mlp.fc2.weight"].shape[0]
    side = quadrant_side(fc1.shape[1], w.shape[0], num_dim)
    out["classifier.fc1.weight"] = chw_to_hwc_columns(fc1, w.shape[0], side)
    return out


HIER_ROOTS = {"conv1": "features_extractor.0", "bn1": "features_extractor.1",
              "layer1": "features_extractor.4",
              "layer2": "features_extractor.5",
              "layer3": "global_processor.0", "layer4": "global_processor.1"}


def hierarchical_modules(attention: bool):
    mods = reroot(resnet_modules(), HIER_ROOTS)
    mods = [(ref, f"trunk.{port}", kind) for ref, port, kind in mods]
    mods += [("quadrant_processor.0", "level1_conv", "p"),
             ("sub_quadrant_processor.0", "level2_conv", "p"),
             *head_modules(("0",))]
    if attention:
        mods += [("attention_gate.0", "attn_fc1", "p"),
                 ("attention_gate.2", "attn_fc2", "p")]
    return mods


def import_hierarchical(sd: dict) -> dict:
    """HierarchicalQuadtreeCNN (``models.py:105-210``): every level's
    feature is a pooled channel vector, so no column permutation."""
    return import_modules(sd, hierarchical_modules(False))


def import_attention_hierarchical(sd: dict) -> dict:
    """AttentionHierarchicalCNN (``models.py:6-101``)."""
    return import_modules(sd, hierarchical_modules(True))


def import_standard_resnet(sd: dict) -> dict:
    """StandardResNetCNN (``3dcnn/models.py:49-93``)."""
    out = import_modules(sd, head_modules())
    return import_modules(sd, resnet_modules(), "base_cnn.", "trunk.resnet.",
                          out)


def _multimodal_stages(backbone: str):
    if backbone not in STAGES:
        raise NotImplementedError(
            f"full-model import for backbone {backbone!r}; the reference "
            f"publishes ResNet checkpoints ({sorted(STAGES)})")
    return STAGES[backbone]


def import_standard_multimodal(sd: dict, backbone: str = "resnet18") -> dict:
    """StandardMultimodalCNN (``comparative analysis/model.py:8-71``), the
    ResNet backbones."""
    out = import_modules(sd, head_modules(("0", "3")))
    return import_modules(sd, resnet_modules(*_multimodal_stages(backbone)),
                          "backbone.", "trunk.resnet.", out)


# --------------------------------------------------------------------------
# temporal families

CNN_LSTM_ROOTS = {"conv1": "cnn_backbone.0", "bn1": "cnn_backbone.1",
                  "layer1": "cnn_backbone.4", "layer2": "cnn_backbone.5",
                  "layer3": "cnn_backbone.6", "layer4": "cnn_backbone.7"}


def cnn_lstm_modules():
    mods = [(ref, f"trunk.resnet.{port}", kind) for ref, port, kind in
            reroot(resnet_modules(), CNN_LSTM_ROOTS)]
    return mods + [("numerical_mlp.0", "num_fc1", "p"),
                   ("numerical_mlp.2", "num_fc2", "p"), *head_modules()]


def import_cnn_lstm(sd: dict) -> dict:
    """CnnLstm (``cnn+lstm/models.py:14-89``); cnn_backbone is
    ``Sequential(*resnet.children()[:-1])``."""
    out = import_modules(sd, cnn_lstm_modules())
    import_lstm(sd, "lstm", "lstm", out)
    return out


def ji_3dcnn_modules():
    mods = []
    for i, name in ((0, "block1"), (2, "block2"), (4, "block3")):
        mods += [(f"visual_stream.{i}.0", f"{name}_conv", "p"),
                 (f"visual_stream.{i}.1", f"{name}_bn", "bn")]
    return mods + head_modules()


def import_ji_3dcnn(sd: dict) -> dict:
    """Ji3DCNN (``cnn+lstm/models.py:93-142``)."""
    out = import_modules(sd, ji_3dcnn_modules())
    import_lstm(sd, "numerical_lstm", "numerical_lstm", out)
    return out


QUADTREE_3D_BLOCKS = (("conv3d_block1", "block1"), ("conv3d_block2", "block2"),
                      ("conv3d_block3", "block3"),
                      ("conv3d_block4_new", "block4"),
                      ("conv3d_final_features", "final"))


def quadtree_3d_modules(mode: str):
    mods = []
    for ref, port in QUADTREE_3D_BLOCKS:
        mods += [(f"{ref}.0", f"{port}_conv", "p"),
                 (f"{ref}.1", f"{port}_bn", "bn")]
    if mode == "fusion":
        mods.append(("numerical_projection.0", "numerical_projection", "p"))
    return mods + head_modules()


def import_quadtree_3d(sd: dict, mode: str = "fusion") -> dict:
    """Quadtree3DCNN (``3dcnn/models.py:96-214``)."""
    out = import_modules(sd, quadtree_3d_modules(mode))
    if mode == "fusion":
        import_lstm(sd, "numerical_lstm", "numerical_lstm", out)
    return out


def resnet3d_video_modules():
    # the classifier lives in the torchvision model's own ``fc``
    return [(f"r3d_model.{ref}", f"trunk.{port}", kind)
            for ref, port, kind in r3d18_modules()] + [
        ("r3d_model.fc.0", "classifier.fc1", "p"),
        ("r3d_model.fc.3", "classifier.fc2", "p")]


def import_resnet3d_video(sd: dict) -> dict:
    """ResNet3DVideo (``3dcnn/models.py:220-259``): torchvision r3d_18 with
    ``fc`` replaced by ``Sequential(Linear, ReLU, Dropout, Linear)``."""
    return import_modules(sd, resnet3d_video_modules())


HYBRID_ROOTS = {"stem": "pretrained_image_extractor.0",
                **{f"layer{i}": f"pretrained_image_extractor.{i}"
                   for i in range(1, 5)}}


def hybrid_modules(mode: str):
    mods = [(ref, f"trunk.{port}", kind) for ref, port, kind in
            reroot(r3d18_modules(), HYBRID_ROOTS)]
    if mode == "fusion":
        mods.append(("numerical_projection.0", "numerical_projection", "p"))
    return mods + head_modules()


def import_hybrid_quadtree_3d(sd: dict, mode: str = "fusion") -> dict:
    """HybridQuadtree3DCNN (``3dcnn/models.py:265-375``);
    pretrained_image_extractor is ``Sequential(stem, layer1..layer4)``."""
    out = import_modules(sd, hybrid_modules(mode))
    if mode == "fusion":
        import_lstm(sd, "numerical_lstm", "numerical_lstm", out)
    return out


FACT_LAYERS = "fusion_transformer.layers."


def fact_modules(num_layers: int):
    mods = [("numerical_projector.0", "num_proj1", "p"),
            ("numerical_projector.2", "num_proj2", "p"),
            ("classification_head.0", "head_ln", "p"),
            ("classification_head.1", "head_fc", "p")]
    for i in range(num_layers):
        mods += encoder_modules(f"{FACT_LAYERS}{i}", f"fusion{i}")
    return mods


def import_fact(sd: dict) -> dict:
    """FactModel (``VIT/fact_model.py:7-147``); the ViT's depth and the
    fusion transformer's layer count are read from the keys."""
    layers = count_indexed(sd, FACT_LAYERS)
    out = import_modules(sd, fact_modules(layers))
    vit = {k.removeprefix("vit_backbone."): v for k, v in sd.items()
           if k.startswith("vit_backbone.")}
    out.update({f"vit_backbone.{k}": v
                for k, v in import_vit_base(vit).items()})
    d = sd["cls_token"].shape[-1]
    out["token_type_embed"] = f32(sd["token_type_embed.weight"])
    out["cls_token"] = f32(sd["cls_token"]).reshape(1, 1, d)
    out["pos_embed"] = f32(sd["pos_embed"])
    for i in range(layers):
        ref = f"{FACT_LAYERS}{i}.self_attn"
        split_packed(out, f"fusion{i}.attn", sd[f"{ref}.in_proj_weight"],
                     sd[f"{ref}.in_proj_bias"])
    return out


IMPORTERS = {
    "quadtree": import_quadtree,
    "hierarchical_quadtree": import_hierarchical,
    "attention_hierarchical": import_attention_hierarchical,
    "standard_resnet": import_standard_resnet,
    "standard_multimodal": import_standard_multimodal,
    "cnn_lstm": import_cnn_lstm,
    "ji_3dcnn": import_ji_3dcnn,
    "quadtree_3d": import_quadtree_3d,
    "resnet3d_video": import_resnet3d_video,
    "hybrid_quadtree_3d": import_hybrid_quadtree_3d,
    "fact": import_fact,
}

# the families whose importer and exporter take the ablation mode
MODE_FAMILIES = ("quadtree", "quadtree_3d", "hybrid_quadtree_3d")


def family_kwargs(cfg) -> dict:
    """The converter keywords a model config implies (mode, backbone)."""
    kw = {}
    if cfg.name in MODE_FAMILIES:
        kw["mode"] = cfg.mode
    if cfg.name == "standard_multimodal":
        kw["backbone"] = cfg.backbone
    return kw


def load_reference_state_dict(name: str, sd: dict, **kw) -> dict:
    """A reference checkpoint of family ``name`` → the port's state_dict
    (``strict=True``). ``kw``: ``mode`` for the quadtree, quadtree_3d and
    hybrid families, ``backbone`` for standard_multimodal."""
    if name not in IMPORTERS:
        raise ValueError(f"no reference importer for model {name!r}; "
                         f"families: {sorted(IMPORTERS)}")
    return IMPORTERS[name](sd, **kw)
