"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips without a CUDA card (decided inside the
fixture, never at import). The file imports no JAX, so on a machine with
a card and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from surya_tpu_torch.core.config import ModelConfig
from surya_tpu_torch.infer.serve import Predictor
from surya_tpu_torch.models import get_model
from surya_tpu_torch.ops.cuda import fusion_head as thead
from surya_tpu_torch.ops.cuda import quadrant as tquad
from surya_tpu_torch.ops.cuda import stem_bn as tbn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,cin,cout", [(2, 14, 256, 128),
                                          (3, 28, 32, 16),
                                          (2, 4, 64, 32),
                                          (2, 8, 16, 8),
                                          # edges of the wgmma tilings
                                          (1, 14, 256, 128),
                                          (64, 14, 256, 128),
                                          (256, 14, 256, 128),
                                          (3, 8, 32, 16),
                                          (2, 14, 256, 64),
                                          (2, 14, 256, 256),
                                          (2, 28, 1024, 64)])
def test_quadrant_kernel_matches_plain(cuda, b, h, cin, cout, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    fmap = torch.randn(b, h, h, cin, device=cuda, generator=g).to(dtype)
    kernel = (torch.randn(3, 3, cin, cout, device=cuda, generator=g)
              * 0.05).to(dtype)
    bias = torch.randn(cout, device=cuda, generator=g)
    before = tquad.launches
    got = tquad.quadrant_process(fmap, kernel, bias)
    assert tquad.launches == before + 1 and got.dtype == dtype
    want = tquad.quadrant_process_plain(fmap.float(), kernel.float(), bias)
    assert _rel_err(got, want) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,d,h,c", [(64, 5376, 2688, 8), (5, 256, 128, 3),
                                     (70, 264, 40, 5),
                                     # edges of the wgmma tiling and split
                                     (1, 5376, 2688, 8), (63, 256, 128, 8),
                                     (100, 264, 40, 5), (256, 5376, 2688, 8),
                                     (257, 512, 2688, 3),
                                     # the temporal families' heads
                                     (32, 256, 128, 8), (8, 192, 128, 8),
                                     (8, 1536, 768, 8), (8, 1024, 512, 8),
                                     # the r3d_18 families' heads
                                     (8, 512, 256, 8), (8, 768, 384, 8)])
def test_fusion_head_kernel_matches_plain(cuda, b, d, h, c, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(b, d, device=cuda, generator=g) * 0.1).to(dtype)
    w1 = (torch.randn(h, d, device=cuda, generator=g) * 0.02).to(dtype)
    b1 = torch.randn(h, device=cuda, generator=g)
    w2 = (torch.randn(c, h, device=cuda, generator=g) * 0.02).to(dtype)
    b2 = torch.randn(c, device=cuda, generator=g)
    before = thead.launches
    got = thead.fusion_head(x, w1, b1, w2, b2)
    assert thead.launches == before + 1 and got.dtype == torch.float32
    want = thead.fusion_head_plain(x.float(), w1.float(), b1, w2.float(), b2)
    assert _rel_err(got, want) <= tol
    with pytest.raises(ValueError, match="seed"):
        thead.fusion_head(x, w1, b1, w2, b2, rate=0.5)


def test_predictor_on_card_matches_cpu(cuda):
    cfg = ModelConfig(num_classes=5, compute_dtype="float32")
    state = get_model(cfg, image_size=64).state_dict()
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (5, 64, 64, 3), dtype=np.uint8)
    feats = rng.normal(size=(5, 47)).astype(np.float32)
    kw = dict(batch_size=4, image_size=64, input_dtype="uint8")
    before = (tquad.launches, thead.launches)
    _, p_gpu = Predictor(cfg, state, **kw).predict(raw, feats)
    assert (tquad.launches, thead.launches) == (before[0] + 2,
                                                before[1] + 2)
    _, p_cpu = Predictor(cfg, state, device="cpu", **kw).predict(raw, feats)
    np.testing.assert_allclose(p_gpu, p_cpu, atol=1e-4)


def _rel_l2(got, want):
    got, want = got.float(), want.float()
    return ((got - want).norm() / (want.norm() + 1e-30)).item()


def _leaves(*tensors):
    return [t.detach().clone().requires_grad_(True) for t in tensors]


@pytest.mark.parametrize("b,h,cin,cout", [(16, 14, 256, 128),
                                          (2, 6, 4, 2), (2, 30, 16, 16),
                                          (1, 14, 256, 128), (3, 8, 32, 64)])
def test_quadrant_training_form_matches_plain(cuda, b, h, cin, cout):
    """f32: (out, act) to 1e-4 and the three gradients of the autograd
    Function (kernel forward, hand-written backward) against autograd
    through the plain version to 1e-5 relative L2."""
    g = torch.Generator(device=cuda).manual_seed(2)
    fmap = torch.randn(b, h, h, cin, device=cuda, generator=g)
    kernel = torch.randn(3, 3, cin, cout, device=cuda, generator=g) * 0.05
    bias = torch.randn(cout, device=cuda, generator=g)
    out, act = tquad.quadrant_process_with_act(fmap, kernel, bias)
    want_out, want_act = tquad.quadrant_process_plain(fmap, kernel, bias,
                                                      with_act=True)
    assert act.shape == (b, h, h, cout)
    assert _rel_err(out, want_out) <= 1e-4
    assert _rel_err(act, want_act) <= 1e-4
    got, ref = _leaves(fmap, kernel, bias), _leaves(fmap, kernel, bias)
    before = tquad.launches
    (tquad.quadrant_process(*got) ** 2).sum().backward()
    assert tquad.launches == before + 1
    (tquad.quadrant_process_plain(*ref) ** 2).sum().backward()
    for a, r in zip(got, ref):
        assert _rel_l2(a.grad, r.grad) <= 1e-5


def test_quadrant_training_form_bf16(cuda):
    """bf16 (the tensor-core body writes act too): against the plain
    version's outputs to 2e-2, and the backward against the same backward
    fed by the plain version's act to 5e-2 relative L2."""
    g = torch.Generator(device=cuda).manual_seed(3)
    fmap = torch.randn(8, 14, 14, 256, device=cuda, generator=g).bfloat16()
    kernel = (torch.randn(3, 3, 256, 128, device=cuda, generator=g)
              * 0.05).bfloat16().float()
    bias = torch.randn(128, device=cuda, generator=g)
    out, act = tquad.quadrant_process_with_act(fmap, kernel, bias)
    want_out, want_act = tquad.quadrant_process_plain(
        fmap.float(), kernel, bias, with_act=True)
    assert out.dtype == act.dtype == torch.bfloat16
    assert _rel_err(out, want_out) <= 2e-2
    assert _rel_err(act, want_act) <= 2e-2
    got = _leaves(fmap, kernel, bias)
    (tquad.quadrant_process(*got).float() ** 2).sum().backward()
    want = tquad.quadrant_backward(fmap, kernel, bias, want_act.bfloat16(),
                                   2 * want_out.bfloat16().float())
    assert got[0].grad.dtype == torch.bfloat16
    assert got[1].grad.dtype == got[2].grad.dtype == torch.float32
    for a, w in zip(got, want):
        assert _rel_l2(a.grad, w) <= 5e-2


@pytest.mark.parametrize("dtype,tol,gtol", [(torch.float32, 1e-4, 1e-5),
                                            (torch.bfloat16, 2e-2, 5e-2)])
@pytest.mark.parametrize("b,d,h,c", [(64, 256, 512, 8), (70, 264, 40, 5),
                                     (1, 5376, 2688, 8), (257, 512, 2688, 8),
                                     (8, 1536, 768, 8), (32, 256, 128, 8),
                                     (8, 512, 256, 8), (8, 768, 384, 8)])
def test_fusion_head_training_form_matches_plain(cuda, b, d, h, c, dtype,
                                                 tol, gtol):
    """Rate 0.5: the kernel's mask is the Philox reference's, the dropped
    share is near the rate, and with that mask as ``keep`` the plain
    version gives the same logits, h and five gradients."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = (torch.randn(b, d, device=cuda, generator=g) * 0.1).to(dtype)
    w1 = (torch.randn(h, d, device=cuda, generator=g) * 0.02).to(
        dtype).float()
    b1 = torch.randn(h, device=cuda, generator=g)
    w2 = (torch.randn(c, h, device=cuda, generator=g) * 0.02).to(
        dtype).float()
    b2 = torch.randn(c, device=cuda, generator=g)
    rate, seed = 0.5, 1234
    logits, hid = thead.fusion_head_with_h(x, w1, b1, w2, b2, rate=rate,
                                           seed=seed)
    keep = thead.philox_bits(seed, b, h, cuda) >= thead.dropout_threshold(
        rate)
    pre = torch.addmm(b1, x.float(), w1.t())
    decided = pre.abs() > 1e-3
    assert bool(((hid > 0) == (keep & (pre > 0)))[decided].all())
    frac = ((hid == 0) & (pre > 0)).sum() / (pre > 0).sum()
    assert 0.4 < frac.item() < 0.6
    want_logits, want_h = thead.fusion_head_plain(
        x.float(), w1, b1, w2, b2, rate, keep, with_h=True)
    assert hid.dtype == dtype
    assert _rel_err(logits, want_logits) <= tol
    assert _rel_err(hid, want_h) <= tol
    _, again = thead.fusion_head_with_h(
        x, w1, b1, w2, b2, rate=rate,
        seed=torch.tensor([seed], dtype=torch.int64, device=cuda))
    _, other = thead.fusion_head_with_h(x, w1, b1, w2, b2, rate=rate,
                                        seed=99)
    assert torch.equal(hid, again) and not torch.equal(hid, other)
    got = _leaves(x, w1, b1, w2, b2)
    before = thead.launches
    (thead.fusion_head(*got, rate=rate, seed=seed) ** 2).sum().backward()
    assert thead.launches == before + 1
    ref = _leaves(x.float(), w1, b1, w2, b2)
    (thead.fusion_head_plain(*ref, rate, keep) ** 2).sum().backward()
    for a, r in zip(got, ref):
        assert _rel_l2(a.grad, r.grad) <= gtol


@pytest.mark.parametrize("b,h,cin,cout", [(1, 14, 256, 128),
                                          (64, 14, 256, 128),
                                          (256, 14, 256, 128),
                                          (3, 8, 32, 64),
                                          (2, 14, 1024, 256),
                                          (2, 28, 256, 16)])
def test_quadrant_training_form_bf16_edges(cuda, b, h, cin, cout):
    """The wgmma body's training form at the edges of its tilings: (out,
    act) against the plain version to 2e-2."""
    g = torch.Generator(device=cuda).manual_seed(6)
    fmap = torch.randn(b, h, h, cin, device=cuda, generator=g).bfloat16()
    kernel = (torch.randn(3, 3, cin, cout, device=cuda, generator=g)
              * 0.05).bfloat16()
    bias = torch.randn(cout, device=cuda, generator=g)
    out, act = tquad.quadrant_process_with_act(fmap, kernel, bias)
    want_out, want_act = tquad.quadrant_process_plain(
        fmap.float(), kernel.float(), bias, with_act=True)
    assert out.dtype == act.dtype == torch.bfloat16
    assert _rel_err(out, want_out) <= 2e-2
    assert _rel_err(act, want_act) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["quadrant", "quadrant_act", "head",
                                  "head_dropout"])
def test_two_launches_give_identical_bits(cuda, form, dtype):
    """No atomics, fixed-order sums: the same inputs give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(7)
    if form.startswith("quadrant"):
        args = (torch.randn(64, 14, 14, 256, device=cuda, generator=g).to(
            dtype), (torch.randn(3, 3, 256, 128, device=cuda, generator=g)
                     * 0.05).to(dtype), torch.randn(128, device=cuda,
                                                    generator=g))
        run = (tquad.quadrant_process_with_act if form == "quadrant_act"
               else lambda *a: (tquad.quadrant_process(*a),))
    else:
        args = ((torch.randn(256, 5376, device=cuda, generator=g) * 0.1).to(
            dtype), (torch.randn(2688, 5376, device=cuda, generator=g)
                     * 0.02).to(dtype), torch.randn(2688, device=cuda,
                                                    generator=g),
            (torch.randn(8, 2688, device=cuda, generator=g) * 0.02).to(dtype),
            torch.randn(8, device=cuda, generator=g))
        rate = 0.5 if form == "head_dropout" else 0.0
        run = lambda *a: thead.fusion_head_with_h(  # noqa: E731
            *a, rate=rate, seed=11)
    first, second = run(*args), run(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("shape,dtype,tol", [
    ((4, 16, 16, 64), torch.float32, 1e-5),
    ((2, 14, 14, 64), torch.bfloat16, 2e-2),
    ((3, 7, 5, 24), torch.float32, 1e-5),     # C != 64, odd row count
    ((3, 7, 5, 5), torch.bfloat16, 2e-2),     # rows without 16-byte groups
])
def test_stem_bn_kernels_match_plain(cuda, shape, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(5)
    c = shape[-1]
    x = (torch.randn(*shape, device=cuda, generator=g) * 3 + 0.5).to(dtype)
    scale = torch.rand(c, device=cuda, generator=g) * 1.5 + 0.5
    bias = torch.randn(c, device=cuda, generator=g)
    before = dict(tbn.launches)
    y, mean, var = tbn.fused_bn_relu_train(x, scale, bias)
    assert tbn.launches == {k: v + 1 for k, v in before.items()}
    yr, mr, vr = tbn.reference_bn_relu_train(x, scale, bias)
    assert y.dtype == dtype and y.shape == x.shape
    for got, want in ((y, yr), (mean, mr), (var, vr)):
        assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    sums, sumsq = tbn.channel_stats(x)
    ps, pss = tbn.channel_stats_plain(x)
    assert _rel_err(sums, ps) <= 1e-5 and _rel_err(sumsq, pss) <= 1e-5


def test_train_step_on_card_launches_both_kernels_and_learns(cuda):
    from surya_tpu_torch.core.config import Config, TrainConfig
    from surya_tpu_torch.train import create_train_state, make_train_step

    cfg = Config(model=ModelConfig(num_classes=5),       # bf16, dropout 0.5
                 train=TrainConfig(lr=1e-3))
    model = get_model(cfg.model, image_size=64)
    state, tx = create_train_state(model, cfg)
    step = make_train_step(model, tx, cfg)
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(8, 64, 64, 3)).astype(np.float32),
             rng.normal(size=(8, 47)).astype(np.float32),
             rng.integers(0, 5, 8))
    before = (tquad.launches, thead.launches)
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(10)]
    assert (tquad.launches, thead.launches) == (before[0] + 10,
                                                before[1] + 10)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert state.generator.device.type == "cuda"


def _synthetic_pack(root, size, counts):
    from surya_tpu_torch.data import make_synthetic_spatial
    from surya_tpu_torch.data.packed import pack_arrays

    splits = {}
    for i, (name, n) in enumerate(counts.items()):
        imgs, feats, labels = make_synthetic_spatial(
            num_classes=4, per_class=n // 4, image_size=size, seed=i)
        feats[::5, 3] = np.nan
        splits[name] = (np.clip((imgs + 1.5) * 85 + 0.5, 0, 255).astype(
            np.uint8), feats, labels)
    pack_arrays(str(root), splits, ["a", "b", "c", "d"])
    return splits


def test_device_transform_on_card_matches_cpu(cuda, tmp_path):
    """The train (augment) and eval (resize) transform at 256 → 224 on
    the card against the same call on the CPU: the same CPU generator on
    both sides, so the same drawn parameters; 1e-5 absolute."""
    from surya_tpu_torch.core.config import DataConfig
    from surya_tpu_torch.data.packed import PackedDataSource

    _synthetic_pack(tmp_path, 256, {"train": 8})
    src = PackedDataSource(DataConfig(), packed_dir=str(tmp_path))
    host = src._load_batch("train", np.arange(8))
    dev = tuple(torch.from_numpy(a).to(cuda) for a in host)
    for split, seed in (("train", 3), ("valid", None)):
        gen = (lambda: None if seed is None  # noqa: E731
               else torch.Generator().manual_seed(seed))
        got = src.device_transform(split, gen(), dev)
        want = src.device_transform(split, gen(), host)
        assert got[0].device.type == "cuda" and got[0].shape == (8, 224,
                                                                 224, 3)
        for g, w in zip(got, want):
            assert (g.cpu().float() - w.float()).abs().max().item() <= 1e-5


def test_loop_on_card_launches_both_forms_of_both_kernels(cuda, tmp_path):
    """Two epochs of train_and_evaluate from a synthetic pack whose host
    batches are pinned: each train step launches the training forms, each
    eval batch the inference forms."""
    from surya_tpu_torch.core.config import get_preset
    from surya_tpu_torch.core.metrics import MetricsLogger
    from surya_tpu_torch.data.packed import PackedDataSource
    from surya_tpu_torch.train import train_and_evaluate

    _synthetic_pack(tmp_path / "pack", 72, {"train": 32, "valid": 16,
                                            "test": 16})
    cfg = get_preset("quadtree-fusion").override({
        "model.num_classes": "4", "data.image_size": "64",
        "train.epochs": "2", "train.lr": "1e-3",
        "train.checkpoint_dir": str(tmp_path / "ckpt")})
    data = PackedDataSource(cfg.data, packed_dir=str(tmp_path / "pack"),
                            pin_memory=True)
    assert all(t.is_pinned() for t in next(iter(data.train_batches(0))))
    before = {m: (m.launches, m.training_launches) for m in (tquad, thead)}
    summary = train_and_evaluate(cfg, data, logger=MetricsLogger(echo=False))
    for m, (total, training) in before.items():
        assert m.training_launches - training == 4      # 2 epochs x 2 steps
        assert (m.launches - total) - (m.training_launches - training) == 3
    assert summary["test"]["count"] == 16
    assert summary["state"].model.classifier.fc1.weight.device.type == "cuda"
    assert os.listdir(tmp_path / "ckpt")


@pytest.mark.parametrize("name,backbone,mode", [
    ("hierarchical_quadtree", "resnet18", "fusion"),
    ("attention_hierarchical", "resnet18", "image_only"),
    ("standard_resnet", "resnet18", "image_only"),
    ("standard_multimodal", "vgg16", "fusion"),
    ("standard_multimodal", "mobilenet_v2", "fusion"),
    ("standard_multimodal", "densenet121", "image_only")])
def test_spatial_family_on_card_matches_cpu(cuda, name, backbone, mode):
    """The other spatial families' f32 logits on the card against the CPU
    (64 px, the same weights), each forward one head launch."""
    cfg = ModelConfig(name=name, backbone=backbone, mode=mode,
                      num_classes=5, compute_dtype="float32")
    model = get_model(cfg, image_size=64)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((4, 64, 64, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.normal(size=(4, 47)).astype(np.float32))
    with torch.no_grad():
        want = model(images, feats)
        model = model.to(cuda)
        before = thead.launches
        got = model(images.to(cuda), feats.to(cuda))
    assert thead.launches == before + 1
    assert _rel_err(got.cpu(), want) <= 1e-4


@pytest.mark.parametrize("name,mode,t", [("cnn_lstm", "fusion", 4),
                                        ("ji_3dcnn", "fusion", 5),
                                        ("quadtree_3d", "fusion", 5),
                                        ("quadtree_3d", "image_only", 4),
                                        ("resnet3d_video", "fusion", 5),
                                        ("hybrid_quadtree_3d", "fusion", 5),
                                        ("hybrid_quadtree_3d", "image_only",
                                         4),
                                        ("fact", "fusion", 4)])
def test_temporal_family_on_card_matches_cpu(cuda, name, mode, t):
    """The temporal families' f32 logits on the card against the CPU
    (32 px clips, the same weights), each forward one head launch (none
    for FACT, whose head is LN + Dense); and a bf16 train-mode forward
    with dropout draws on the card's generator. FACT at fusion width 96,
    which its 12 ViT heads and 8 fusion heads divide."""
    small = dict(fusion_dim=96, fusion_layers=2) if name == "fact" else {}
    cfg = ModelConfig(name=name, mode=mode, num_classes=5, seq_len=t,
                      compute_dtype="float32", **small)
    model = get_model(cfg, image_size=32)
    rng = np.random.default_rng(0)
    clips = torch.from_numpy(rng.random((2, t, 32, 32, 3)).astype(
        np.float32))
    feats = torch.from_numpy(rng.normal(size=(2, t, 47)).astype(np.float32))
    with torch.no_grad():
        want = model(clips, feats)
        model = model.to(cuda)
        before = thead.launches
        got = model(clips.to(cuda), feats.to(cuda))
    assert thead.launches == before + (name != "fact")
    assert _rel_err(got.cpu(), want) <= 1e-4
    bf = get_model(ModelConfig(name=name, mode=mode, num_classes=5,
                               seq_len=t, **small), image_size=32).to(cuda)
    out = bf.train()(clips.to(cuda), feats.to(cuda),
                     torch.Generator(device=cuda).manual_seed(0))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.mark.parametrize("name,target", [("quadtree", "layer3"),
                                         ("hierarchical_quadtree", "level2")])
def test_grad_cam_on_card_matches_cpu_from_the_same_activation(cuda, name,
                                                               target):
    """Grad-CAM's tail (kernels in their training forms, autograd, the
    quadrant merges) on the card against the CPU from the card's own
    target activation: heatmaps to 2e-4, preds equal."""
    from surya_tpu_torch.interpret.gradcam import (
        cam_from,
        cam_model,
        cam_split,
    )

    cfg = ModelConfig(name=name, num_classes=5)
    state = get_model(cfg, image_size=64).state_dict()
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.normal(size=(2, 64, 64, 3)).astype(
        np.float32))
    feats = torch.from_numpy(rng.normal(size=(2, 47)).astype(np.float32))
    card, cpu = (cam_model(cfg, state, 64, d) for d in (cuda, "cpu"))
    act, consts, merges = cam_split(cfg, card, images.to(cuda), target)
    cam_g, pred_g, _ = cam_from(cfg, card, act, consts, merges,
                                feats.to(cuda), target)
    cam_c, pred_c, _ = cam_from(cfg, cpu, act.cpu(),
                                {k: v.cpu() for k, v in consts.items()},
                                merges, feats, target)
    assert (cam_g.cpu() - cam_c).abs().max().item() <= 2e-4
    assert torch.equal(pred_g.cpu(), pred_c)


def test_operators_launch_the_inference_kernels(cuda):
    """``torch.ops.surya_tpu_torch.*`` on the card: one inference-form
    launch each, the plain version's result."""
    g = torch.Generator(device=cuda).manual_seed(0)
    fmap = torch.randn(2, 14, 14, 256, device=cuda, generator=g)
    kernel = torch.randn(3, 3, 256, 128, device=cuda, generator=g) * 0.05
    bias = torch.randn(128, device=cuda, generator=g)
    x = torch.randn(2, 5376, device=cuda, generator=g)
    w1 = torch.randn(2688, 5376, device=cuda, generator=g) * 0.02
    b1 = torch.randn(2688, device=cuda, generator=g)
    w2 = torch.randn(8, 2688, device=cuda, generator=g) * 0.02
    b2 = torch.randn(8, device=cuda, generator=g)
    for mod, op, plain, args in (
            (tquad, torch.ops.surya_tpu_torch.quadrant_process,
             tquad.quadrant_process_plain, (fmap, kernel, bias)),
            (thead, torch.ops.surya_tpu_torch.fusion_head,
             thead.fusion_head_plain, (x, w1, b1, w2, b2))):
        before = (mod.launches, mod.training_launches)
        got = op(*args)
        assert (mod.launches, mod.training_launches) == (before[0] + 1,
                                                         before[1])
        assert _rel_err(got, plain(*args)) <= 1e-4


def test_exported_artifact_on_the_card(cuda, tmp_path):
    """An f32 artifact traced on the card: the Predictor's probabilities
    (1e-5) with one launch of each kernel a chunk; loaded on the CPU, the
    plain versions' (1e-4). ``cost_analysis`` launches nothing."""
    from surya_tpu_torch.infer.serve import export_model, load_exported

    cfg = ModelConfig(name="quadtree", num_classes=5,
                      compute_dtype="float32")
    state = get_model(cfg, image_size=64).state_dict()
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    feats = rng.normal(size=(4, 47)).astype(np.float32)
    path = str(tmp_path / "q.pt2")
    export_model(cfg, state, path, batch_size=4, image_size=64,
                 input_dtype="uint8")
    loaded = load_exported(path)
    before = (tquad.launches, thead.launches, tquad.training_launches,
              thead.training_launches)
    preds, probs = loaded.call(raw, feats)
    assert (tquad.launches, thead.launches, tquad.training_launches,
            thead.training_launches) == (before[0] + 1, before[1] + 1,
                                         *before[2:])
    predictor = Predictor(cfg, state, batch_size=4, image_size=64,
                          input_dtype="uint8")
    want_preds, want_probs = predictor.predict(raw, feats)
    assert np.abs(probs.cpu().numpy() - want_probs).max() <= 1e-5
    assert np.array_equal(preds.cpu().numpy(), want_preds)
    _, cpu_probs = load_exported(path, device="cpu").call(raw, feats)
    assert (cpu_probs - probs.cpu()).abs().max().item() <= 1e-4
    # the flop count of a chunk is the CPU's (fake tensors, no launch)
    launched = (tquad.launches, thead.launches)
    assert predictor.cost_analysis() == Predictor(
        cfg, state, batch_size=4, image_size=64, input_dtype="uint8",
        device="cpu").cost_analysis()
    assert (tquad.launches, thead.launches) == launched
