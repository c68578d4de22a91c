"""Reference-checkpoint interchange of the PyTorch port against the JAX
package's, for all 11 families and the four backbones.

Each case builds the reference-named torch mirror (``torch_mirrors.py``)
with randomised BN statistics, at the sizes of
``test_full_model_equivalence.py``, and holds:

- import: ``models.full_import`` gives a state_dict bit-equal to JAX's
  importer followed by ``from_jax_variables``, which the port's model loads
  with ``strict=True`` and whose logits match the mirror's at f32 (that
  file's tolerances);
- export: ``models.full_export`` gives the dict JAX's exporter gives on the
  same weights, bit for bit, keys and dtypes included, and export∘import
  is the identity on the port's state_dict.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

from surya_tpu.models import full_export as jax_export
from surya_tpu.models import full_import as jax_import
from surya_tpu.models.backbones import torch_import as jax_backbones
from surya_tpu_torch.core.config import ModelConfig
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.backbones import make_resnet, r3d_18
from surya_tpu_torch.models.backbones import torch_import as backbones
from surya_tpu_torch.models.backbones.vit import ViT
from surya_tpu_torch.models.from_jax import from_jax_variables
from surya_tpu_torch.models.full_export import EXPORTERS
from surya_tpu_torch.models.full_import import (
    IMPORTERS,
    load_reference_state_dict,
)
from surya_tpu_torch.models.temporal.fact import FactModel
from torch_mirrors import (
    MirrorAttentionHierarchical,
    MirrorCnnLstm,
    MirrorFact,
    MirrorHierarchical,
    MirrorHybridQuadtree3D,
    MirrorJi3DCNN,
    MirrorQuadtree,
    MirrorQuadtree3D,
    MirrorResNet3DVideo,
    MirrorStandardMultimodal,
    MirrorStandardResNet,
    TimmViT,
    TVResNet18,
    randomize_bn_stats,
    tv_r3d18_parts,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401

B, NUM_DIM = 2, 47
FACT = dict(d=64, heads=4, layers=2)


def _port_model(name, image_size, **kw):
    return get_model(ModelConfig(name=name, compute_dtype="float32", **kw),
                     image_size=image_size)


def _fact_model(t):
    return FactModel(seq_len=t, embed_dim=FACT["d"],
                     num_layers=FACT["layers"], num_heads=FACT["heads"],
                     vit_depth=2, vit_heads=FACT["heads"],
                     dtype=torch.float32, image_size=32)


# family, mode, mirror, port model, (image side, T or None), seed, tol
CASES = {
    "quadtree-fusion": ("quadtree", "fusion",
                        lambda: MirrorQuadtree(mode="fusion", img=128),
                        lambda: _port_model("quadtree", 128), (128, None),
                        0, 2e-4),
    "quadtree-image_only": (
        "quadtree", "image_only",
        lambda: MirrorQuadtree(mode="image_only", img=128),
        lambda: _port_model("quadtree", 128, mode="image_only"),
        (128, None), 0, 2e-4),
    "quadtree-numerical_only": (
        "quadtree", "numerical_only",
        lambda: MirrorQuadtree(mode="numerical_only", img=128),
        lambda: _port_model("quadtree", 128, mode="numerical_only"),
        (128, None), 0, 2e-4),
    "hierarchical_quadtree": (
        "hierarchical_quadtree", None, MirrorHierarchical,
        lambda: _port_model("hierarchical_quadtree", 64), (64, None), 1,
        2e-4),
    "attention_hierarchical": (
        "attention_hierarchical", None, MirrorAttentionHierarchical,
        lambda: _port_model("attention_hierarchical", 64), (64, None), 2,
        2e-4),
    "standard_resnet": ("standard_resnet", None, MirrorStandardResNet,
                        lambda: _port_model("standard_resnet", 64),
                        (64, None), 3, 2e-4),
    "standard_multimodal": (
        "standard_multimodal", None, MirrorStandardMultimodal,
        lambda: _port_model("standard_multimodal", 64), (64, None), 4,
        2e-4),
    "cnn_lstm": ("cnn_lstm", None, MirrorCnnLstm,
                 lambda: _port_model("cnn_lstm", 64, seq_len=2), (64, 2), 5,
                 2e-4),
    "ji_3dcnn": ("ji_3dcnn", None, MirrorJi3DCNN,
                 lambda: _port_model("ji_3dcnn", 16, seq_len=4), (16, 4), 6,
                 2e-4),
    "quadtree_3d-fusion": (
        "quadtree_3d", "fusion", lambda: MirrorQuadtree3D(mode="fusion"),
        lambda: _port_model("quadtree_3d", 32, seq_len=4), (32, 4), 7,
        3e-4),
    "quadtree_3d-image_only": (
        "quadtree_3d", "image_only",
        lambda: MirrorQuadtree3D(mode="image_only"),
        lambda: _port_model("quadtree_3d", 32, seq_len=4, mode="image_only"),
        (32, 4), 7, 3e-4),
    "resnet3d_video": ("resnet3d_video", None, MirrorResNet3DVideo,
                       lambda: _port_model("resnet3d_video", 16, seq_len=4),
                       (16, 4), 8, 3e-4),
    "hybrid_quadtree_3d-fusion": (
        "hybrid_quadtree_3d", "fusion",
        lambda: MirrorHybridQuadtree3D(mode="fusion"),
        lambda: _port_model("hybrid_quadtree_3d", 16, seq_len=4), (16, 4),
        9, 3e-4),
    "hybrid_quadtree_3d-image_only": (
        "hybrid_quadtree_3d", "image_only",
        lambda: MirrorHybridQuadtree3D(mode="image_only"),
        lambda: _port_model("hybrid_quadtree_3d", 16, seq_len=4,
                            mode="image_only"), (16, 4), 9, 3e-4),
    "fact": ("fact", None,
             lambda: MirrorFact(vit_depth=2, patch=16, img=32, seq_len=2,
                                **FACT),
             lambda: _fact_model(2), (32, 2), 10, 3e-4),
}


def _kw(mode):
    return {} if mode is None else {"mode": mode}


def _jax_kw(name, mode):
    if name == "fact":
        return {"num_layers": FACT["layers"], "num_heads": FACT["heads"],
                "vit_heads": FACT["heads"]}
    return _kw(mode)


def _mirror(case):
    name, mode, make_mirror, _, _, seed, _ = CASES[case]
    torch.manual_seed(seed)
    tm = make_mirror().eval()
    if name != "fact":
        randomize_bn_stats(tm, seed)
    return tm


def _jax_variables(name, mode, sd):
    params, stats = jax_import.IMPORTERS[name](sd, **_jax_kw(name, mode))
    return {"params": params, "batch_stats": stats}


def _bit_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k]
        w = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


def _inputs(seed, side, t):
    rng = np.random.default_rng(seed)
    shape = (B, side, side, 3) if t is None else (B, t, side, side, 3)
    images = rng.normal(size=shape, scale=0.5).astype(np.float32)
    feats = rng.normal(size=(B, NUM_DIM) if t is None
                       else (B, t, NUM_DIM)).astype(np.float32)
    return images, feats


@pytest.mark.parametrize("case", sorted(CASES))
def test_import_matches_jax_and_mirror(case):
    name, mode, _, make_port, (side, t), seed, tol = CASES[case]
    tm = _mirror(case)
    sd = tm.state_dict()
    got = load_reference_state_dict(name, sd, **_kw(mode))
    want = from_jax_variables(_jax_variables(name, mode, sd))
    model = make_port().eval()
    if mode == "numerical_only":
        # JAX's tree carries the reference's unused trunk and quadrant
        # block; the port's numerical-only model has neither
        extra = set(want) - set(model.state_dict())
        assert extra and all(k.startswith(("trunk.", "quadrant_conv_"))
                             for k in extra)
        want = {k: v for k, v in want.items() if k not in extra}
    _bit_equal(got, want)
    model.load_state_dict(got, strict=True)

    images, feats = _inputs(seed, side, t)
    perm = (0, 3, 1, 2) if t is None else (0, 1, 4, 2, 3)
    with torch.no_grad():
        ref = tm(torch.from_numpy(images.transpose(perm)),
                 torch.from_numpy(feats))
        out = model(torch.from_numpy(images), torch.from_numpy(feats))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_matches_jax_and_inverts_import(case):
    name, mode, *_ = CASES[case]
    sd = _mirror(case).state_dict()
    variables = _jax_variables(name, mode, sd)
    port_sd = load_reference_state_dict(name, sd, **_kw(mode))
    exported = EXPORTERS[name](port_sd, **_kw(mode))
    _bit_equal(exported, jax_export.EXPORTERS[name](variables, **_kw(mode)))
    _bit_equal(IMPORTERS[name](exported, **_kw(mode)), port_sd)


# --------------------------------------------------------------------------
# backbones


class TVBottleneck(nn.Module):
    """torchvision resnet Bottleneck naming."""

    def __init__(self, cin, width, stride=1):
        super().__init__()
        cout = 4 * width
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        return torch.relu(self.bn3(self.conv3(y)) + idt)


class TVResNet50(TVResNet18):
    """torchvision-named resnet50 (the stem, stages and fc of TVResNet18's
    layout, bottleneck blocks)."""

    def __init__(self):
        super().__init__()
        stages, cin = [], 64
        for width, n, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2),
                                 (512, 3, 2)):
            blocks = [TVBottleneck(cin, width, stride)]
            blocks += [TVBottleneck(4 * width, width) for _ in range(n - 1)]
            stages.append(nn.Sequential(*blocks))
            cin = 4 * width
        self.layer1, self.layer2, self.layer3, self.layer4 = stages
        self.fc = nn.Linear(2048, 1000)


class TVR3D18(nn.Module):
    def __init__(self):
        super().__init__()
        (self.stem, self.layer1, self.layer2, self.layer3,
         self.layer4) = tv_r3d18_parts()

    def forward(self, x):
        for m in (self.stem, self.layer1, self.layer2, self.layer3,
                  self.layer4):
            x = m(x)
        return x


def _resnet_feats(tm, x):
    x = tm.maxpool(tm.relu(tm.bn1(tm.conv1(x))))
    for layer in (tm.layer1, tm.layer2, tm.layer3, tm.layer4):
        x = layer(x)
    return x.permute(0, 2, 3, 1)          # NHWC, as the port's "out"


def _jax_out(fn, *args):
    out = {}
    fn(*args, out)
    return out


# name → (mirror, port trunk, JAX importer → (params, stats), JAX
# exporter of (params, stats), port importer, port exporter, input NHWC
# or NTHWC shape, mirror forward, port forward)
BACKBONES = {
    "resnet18": (TVResNet18, lambda: make_resnet("resnet18", torch.float32),
                 jax_backbones.import_resnet18,
                 lambda p, s: _jax_out(jax_export.export_resnet, p, s),
                 backbones.import_resnet18, backbones.export_resnet,
                 (B, 64, 64, 3), _resnet_feats, lambda m, x: m(x)["out"]),
    "resnet50": (TVResNet50, lambda: make_resnet("resnet50", torch.float32),
                 jax_backbones.import_resnet50,
                 lambda p, s: _jax_out(jax_export.export_resnet, p, s),
                 backbones.import_resnet50,
                 lambda sd: backbones.export_resnet(sd, (3, 4, 6, 3), True),
                 (B, 64, 64, 3), _resnet_feats, lambda m, x: m(x)["out"]),
    "r3d_18": (TVR3D18, lambda: r3d_18(torch.float32),
               jax_backbones.import_r3d18,
               lambda p, s: _jax_out(jax_export.export_r3d18, p, s),
               backbones.import_r3d18, backbones.export_r3d18,
               (B, 4, 16, 16, 3), lambda tm, x: tm(x),
               lambda m, x: m(x)["out"]),
    "vit": (lambda: TimmViT(d=64, heads=4, depth=2, patch=16, img=32),
            lambda: ViT(image_size=32, patch=16, embed_dim=64, depth=2,
                        num_heads=4, mlp_dim=256, dtype=torch.float32),
            lambda sd: (jax_backbones.import_vit_base(sd, heads=4), {}),
            lambda p, s: _jax_out(jax_export.export_vit_base, p),
            backbones.import_vit_base, backbones.export_vit_base,
            (B, 32, 32, 3), lambda tm, x: tm(x), lambda m, x: m(x)),
}


def _backbone(name):
    torch.manual_seed(11)
    tm = BACKBONES[name][0]().eval()
    randomize_bn_stats(tm, 11)
    return tm


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_import_matches_jax_and_mirror(name):
    _, make_port, jax_fn, _, port_fn, _, shape, ref_fwd, port_fwd = \
        BACKBONES[name]
    tm = _backbone(name)
    sd = tm.state_dict()
    params, stats = jax_fn(sd)
    got = port_fn(sd)
    _bit_equal(got, from_jax_variables({"params": params,
                                        "batch_stats": stats}))
    model = make_port().eval()
    model.load_state_dict(got, strict=True)
    x = np.random.default_rng(11).normal(size=shape, scale=0.5).astype(
        np.float32)
    perm = (0, 3, 1, 2) if len(shape) == 4 else (0, 4, 1, 2, 3)
    with torch.no_grad():
        ref = ref_fwd(tm, torch.from_numpy(x.transpose(perm)))
        out = port_fwd(model, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_export_matches_jax_and_inverts_import(name):
    _, _, jax_fn, jax_out, port_fn, export_fn, *_ = BACKBONES[name]
    sd = _backbone(name).state_dict()
    exported = export_fn(port_fn(sd))
    _bit_equal(exported, jax_out(*jax_fn(sd)))
    _bit_equal(exported, {k: v for k, v in sd.items()
                          if not k.startswith("fc.")})


def test_s2d_stem_round_trip():
    """The space-to-depth stem: imported as JAX folds it, unfolded back
    to the reference's 7×7 kernel on export."""
    sd = _backbone("resnet18").state_dict()
    params, stats = jax_backbones.import_resnet(sd, stem_s2d=True)
    got = backbones.import_resnet(sd, stem_s2d=True)
    _bit_equal(got, from_jax_variables({"params": params,
                                        "batch_stats": stats}))
    assert got["conv1.weight"].shape == (64, 12, 4, 4)
    back = backbones.export_resnet(got)
    assert torch.equal(back["conv1.weight"], sd["conv1.weight"])
