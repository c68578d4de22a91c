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
    with pytest.raises(NotImplementedError):
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
