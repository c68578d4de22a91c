"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips without a CUDA card (decided inside the
fixture, never at import). The file imports no JAX, so on a machine with
a card and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

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
                                          (2, 8, 16, 8)])
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
                                     (70, 264, 40, 5)])
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
                                          (2, 6, 4, 2), (2, 30, 16, 16)])
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
@pytest.mark.parametrize("b,d,h,c", [(64, 256, 512, 8), (70, 264, 40, 5)])
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
