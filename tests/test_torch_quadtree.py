"""QuadtreeCNN of the PyTorch port against JAX ``QuadtreeCNN(dtype=f32)``
in eval mode: same weights (through ``from_jax_variables``), same numpy
inputs, logits to 1e-4 in all three modes, with the JAX model on its
lax path and on its Pallas path (which takes the lax fallback on CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surya_tpu.models.spatial.quadtree import QuadtreeCNN as JaxQuadtree
from surya_tpu_torch.core.config import ModelConfig
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.from_jax import from_jax_variables
from surya_tpu_torch.models.spatial.quadtree import QuadtreeCNN
from test_torch_resnet import numpy_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401

MODES = ("fusion", "image_only", "numerical_only")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    return (rng.random((3, 64, 64, 3)).astype(np.float32),
            rng.normal(size=(3, 47)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_variables(inputs):
    """One variable tree per mode, built once for the module."""
    images, feats = map(jnp.asarray, inputs)
    return {mode: numpy_variables(
        JaxQuadtree(num_classes=5, mode=mode, dtype=jnp.float32),
        images, feats, seed=i) for i, mode in enumerate(MODES)}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_logits_match_jax(mode, use_pallas, inputs, jax_variables):
    images, feats = inputs
    variables = jax_variables[mode]
    jm = JaxQuadtree(num_classes=5, mode=mode, dtype=jnp.float32,
                     use_pallas=use_pallas)
    want = np.asarray(jm.apply(variables, jnp.asarray(images),
                               jnp.asarray(feats), train=False))

    cfg = ModelConfig(num_classes=5, mode=mode, compute_dtype="float32",
                      use_pallas=use_pallas)
    tm = get_model(cfg, image_size=64)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(images), torch.from_numpy(feats))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode,hidden", [("fusion", 2688),
                                         ("image_only", 2560),
                                         ("numerical_only", 128)])
def test_classifier_width_at_224(mode, hidden):
    """Hidden width is in_dim // 2 at the flagship resolution."""
    m = QuadtreeCNN(mode=mode, image_size=224)
    assert m.classifier.fc1.weight.shape == (hidden, 2 * hidden)
    assert m.classifier.fc2.weight.shape == (8, hidden)


def test_registry_names_roadmap_items():
    """Every family of the JAX registry builds: the spatial ones (the
    comparative one over each backbone, and the space-to-depth stem) and
    all six temporal ones; FACT's MoE variant raises, naming ROADMAP A11;
    an unknown name is a ValueError."""
    from surya_tpu_torch.models import TEMPORAL_MODELS, list_models

    assert list_models() == ["attention_hierarchical", "cnn_lstm", "fact",
                             "hierarchical_quadtree", "hybrid_quadtree_3d",
                             "ji_3dcnn", "quadtree", "quadtree_3d",
                             "resnet3d_video", "standard_multimodal",
                             "standard_resnet"]
    assert TEMPORAL_MODELS < set(list_models())
    with pytest.raises(NotImplementedError, match="A11"):
        get_model(ModelConfig(name="fact", moe_experts=2))
    for name in list_models():
        get_model(ModelConfig(name=name, compute_dtype="float32"),
                  image_size=64)
    for backbone in ("resnet18", "resnet50", "vgg16", "mobilenet_v2",
                     "densenet121"):
        get_model(ModelConfig(name="standard_multimodal", backbone=backbone,
                              compute_dtype="float32"), image_size=64)
    assert get_model(ModelConfig(stem_space_to_depth=True),
                     image_size=64).trunk.conv1.weight.shape == (64, 12, 4, 4)
    with pytest.raises(ValueError, match="unknown model"):
        get_model(ModelConfig(name="nope"))
