"""The spatial families of the port against the JAX package at f32 on the
CPU, eval mode: same weights through ``from_jax_variables`` with
``strict=True``, same numpy inputs, logits to rtol = atol = 1e-4 in every
mode, for ``hierarchical_quadtree`` and ``attention_hierarchical`` (64 px:
level-2 quadrants of 2×2), ``standard_resnet`` and
``standard_multimodal`` over all five backbones (32 px). The JAX side is
jitted (eager DenseNet costs ten times its compile).

Also: the classifier widths at 224 px, the numerical branch's dropout,
and a frozen-trunk ``experiment-image-only`` train step (trunk parameters
fixed, its BN statistics moving, as JAX's rule for spatial families).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from surya_tpu.core.config import ModelConfig as JaxModelConfig
from surya_tpu.models import get_model as jax_get_model
from surya_tpu_torch.core.config import ModelConfig, get_preset
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.from_jax import from_jax_variables
from surya_tpu_torch.train import create_train_state, make_train_step
from test_torch_resnet import numpy_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401

MODES = ("fusion", "image_only", "numerical_only")
BACKBONES = ("resnet18", "resnet50", "vgg16", "mobilenet_v2", "densenet121")
CASES = ([(n, "resnet18", m, 64) for n in ("hierarchical_quadtree",
                                           "attention_hierarchical")
          for m in MODES]
         + [("standard_resnet", "resnet18", "image_only", 32)]
         + [("standard_multimodal", b, m, 32) for b in BACKBONES
            for m in MODES])


def _inputs(size, b=3, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.random((b, size, size, 3)).astype(np.float32),
            rng.normal(size=(b, 47)).astype(np.float32))


@pytest.mark.parametrize("name,backbone,mode,size", CASES)
def test_logits_match_jax(name, backbone, mode, size):
    images, feats = _inputs(size)
    kw = dict(name=name, backbone=backbone, mode=mode, num_classes=5,
              compute_dtype="float32")
    jm = jax_get_model(JaxModelConfig(**kw))
    variables = numpy_variables(jm, jnp.asarray(images), jnp.asarray(feats))
    want = np.asarray(jax.jit(lambda v, x, f: jm.apply(v, x, f, train=False))(
        variables, jnp.asarray(images), jnp.asarray(feats)))

    tm = get_model(ModelConfig(**kw), image_size=size)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(images), torch.from_numpy(feats))
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# (family, backbone, mode) → the head's (D, H) at 224 px, 8 classes
WIDTHS = {("hierarchical_quadtree", "resnet18", "fusion"): (2176, 1024),
          ("hierarchical_quadtree", "resnet18", "image_only"): (2048, 1024),
          ("hierarchical_quadtree", "resnet18", "numerical_only"): (128, 1024),
          ("attention_hierarchical", "resnet18", "fusion"): (1216, 1024),
          ("attention_hierarchical", "resnet18", "image_only"): (1088, 1024),
          ("standard_resnet", "resnet18", "image_only"): (512, 256),
          ("standard_multimodal", "resnet50", "fusion"): (2304, 512),
          ("standard_multimodal", "vgg16", "fusion"): (25344, 512),
          ("standard_multimodal", "vgg16", "image_only"): (25088, 512),
          ("standard_multimodal", "mobilenet_v2", "fusion"): (1536, 512),
          ("standard_multimodal", "densenet121", "fusion"): (1280, 512),
          ("standard_multimodal", "resnet18", "numerical_only"): (256, 512)}


@pytest.mark.parametrize("key", list(WIDTHS))
def test_classifier_widths_at_224(key):
    name, backbone, mode = key
    model = get_model(ModelConfig(name=name, backbone=backbone, mode=mode))
    d, h = WIDTHS[key]
    assert tuple(model.classifier.fc1.weight.shape) == (h, d)
    assert tuple(model.classifier.fc2.weight.shape) == (8, h)


@pytest.mark.parametrize("preset,overrides", [
    ("comparative-mobilenet-v2", {}),
    ("quadtree-fusion", {"model.name": "attention_hierarchical"}),
    ("experiment-numerical-only", {})])
def test_predictor_serves_the_family(preset, overrides):
    """``Predictor`` (uint8 wire, chunks of 4 with a padded tail, the
    mode's ablation) gives the model's own argmax and softmax."""
    from surya_tpu_torch.infer.serve import Predictor
    from surya_tpu_torch.models.common import apply_mode_ablation

    cfg = get_preset(preset).override(overrides)
    model_cfg = dataclasses.replace(cfg.model, compute_dtype="float32")
    model = get_model(model_cfg, image_size=32, seed=1)
    predictor = Predictor(model_cfg, model.state_dict(), batch_size=4,
                          image_size=32, input_dtype="uint8", device="cpu")
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    feats = rng.normal(size=(6, 47)).astype(np.float32)
    preds, probs = predictor.predict(images, feats)
    x, f = apply_mode_ablation(model_cfg.mode, torch.from_numpy(
        images).float() / 255.0, torch.from_numpy(feats))
    with torch.no_grad():
        want = torch.softmax(model(x, f), -1).numpy()
    np.testing.assert_allclose(probs, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(preds, want.argmax(-1))


def test_single_layer_mlp_dropout_is_the_last_op():
    from surya_tpu_torch.models.common import SingleLayerNumericalMLP

    mlp = SingleLayerNumericalMLP(47, 128, dropout=0.25,
                                  dtype=torch.float32).train()
    with torch.no_grad():
        mlp.fc1.weight.zero_()
        mlp.fc1.bias.fill_(1.0)          # ReLU(1) = 1 on every unit
        out = mlp(torch.zeros(512, 47), torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    assert torch.allclose(out[kept], torch.tensor(1 / 0.75))
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        mlp(torch.zeros(2, 47))


def test_frozen_trunk_step_moves_bn_stats_only():
    """``experiment-image-only``: the trunk is frozen, its BN stays in
    train mode (JAX's rule for spatial families), so a step leaves the
    trunk's parameters as they were and moves its running statistics;
    the quadrant conv and the head train."""
    cfg = get_preset("experiment-image-only")
    assert cfg.model.freeze_backbone
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32", num_classes=5))
    model = get_model(cfg.model, image_size=64, seed=0)
    state, tx = create_train_state(model, cfg, device="cpu")
    params0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    stats0 = {k: v.clone() for k, v in model.state_dict().items()
              if "running_" in k}
    images, feats = _inputs(64, b=4)
    batch = (images, feats, np.array([0, 1, 2, 3]))
    state, metrics = make_train_step(model, tx, cfg)(state, batch)
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    for name, p in model.named_parameters():
        moved = not torch.equal(p, params0[name])
        assert moved == (not name.startswith("trunk.")), name
        assert p.requires_grad == (not name.startswith("trunk.")), name
    state_dict = model.state_dict()
    assert stats0 and all(not torch.equal(state_dict[k], v)
                          for k, v in stats0.items())
