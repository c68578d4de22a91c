"""Grad-CAM and the hierarchical feature maps of the port
(``surya_tpu_torch/interpret``) against ``surya_tpu.interpret`` at f32 on
the CPU: same weights through ``from_jax_variables`` with ``strict=True``,
same numpy inputs (64 px, B = 2). Heatmaps, preds and logits to 2e-4 (the
tolerance of ``tests/test_gradcam.py``) for every target: ``layer3`` and
``layer4`` of the quadtree, ``layer4`` of the standard families on a
ResNet, ``layer2``, ``level1`` and ``level2`` of both hierarchical
families. Plus what raises, the bilinear resize, and the ``cam`` command.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surya_tpu.core.config import ModelConfig as JaxModelConfig
from surya_tpu.interpret.featmaps import hierarchy_maps as jax_maps
from surya_tpu.interpret.gradcam import (
    grad_cam as jax_grad_cam,
    resize_bilinear as jax_resize,
)
from surya_tpu.models import get_model as jax_get_model
from surya_tpu_torch.__main__ import main
from surya_tpu_torch.core.config import ModelConfig
from surya_tpu_torch.interpret import (
    batch_grad_cam,
    grad_cam,
    overlay_heatmap,
    resize_bilinear,
)
from surya_tpu_torch.interpret.featmaps import hierarchy_maps, plot_hierarchy
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.from_jax import from_jax_variables
from test_torch_resnet import numpy_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401

TOL = 2e-4
CASES = [("quadtree", "fusion", "layer3"), ("quadtree", "fusion", "layer4"),
         ("quadtree", "image_only", "layer3"),
         ("standard_multimodal", "fusion", "layer4"),
         ("standard_resnet", "image_only", "layer4")]
CASES += [(name, mode, target)
          for name in ("hierarchical_quadtree", "attention_hierarchical")
          for mode, target in (("fusion", "layer2"), ("fusion", "level1"),
                               ("fusion", "level2"), ("image_only", "level2"))]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
            rng.normal(size=(2, 47)).astype(np.float32))


def _weights(name, mode, inputs, seed=0):
    kw = dict(name=name, mode=mode, num_classes=6, compute_dtype="float32")
    jm = jax_get_model(JaxModelConfig(**kw))
    variables = numpy_variables(jm, *map(jnp.asarray, inputs), seed=seed)
    return JaxModelConfig(**kw), ModelConfig(**kw), variables


@pytest.mark.parametrize("name,mode,target", CASES)
def test_heatmaps_preds_and_logits_match_jax(name, mode, target, inputs):
    jcfg, cfg, variables = _weights(name, mode, inputs)
    want = [np.asarray(a) for a in jax_grad_cam(jcfg, variables, *inputs,
                                                target_layer=target)]
    got = [t.numpy() for t in grad_cam(
        cfg, from_jax_variables(variables), *inputs, target_layer=target,
        device="cpu")]
    assert got[0].shape == want[0].shape and want[0].shape[0] == 2
    np.testing.assert_allclose(got[2], want[2], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
    assert got[0].min() >= 0 and got[0].max() <= 1 + 1e-6


def test_target_class_and_the_model_logits(inputs):
    """The tail's logits are the model's own, and another target class
    gives another map."""
    _, cfg, variables = _weights("quadtree", "fusion", inputs, seed=1)
    sd = from_jax_variables(variables)
    cam0, _, logits = grad_cam(cfg, sd, *inputs, target_class=0,
                               device="cpu")
    cam1, _, _ = grad_cam(cfg, sd, *inputs, target_class=1, device="cpu")
    model = get_model(cfg, image_size=64)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        want = model(*map(torch.from_numpy, inputs))
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    assert not torch.allclose(cam0, cam1)


def test_what_raises(inputs):
    sd = get_model(ModelConfig(mode="numerical_only")).state_dict()
    with pytest.raises(ValueError, match="numerical_only"):
        grad_cam(ModelConfig(mode="numerical_only"), sd, *inputs,
                 device="cpu")
    with pytest.raises(ValueError, match="numerical_only"):
        next(batch_grad_cam(ModelConfig(mode="numerical_only"), sd, []))
    cfg = ModelConfig(name="standard_multimodal", backbone="mobilenet_v2")
    with pytest.raises(NotImplementedError, match="resnet"):
        grad_cam(cfg, {}, *inputs, device="cpu")
    cfg = ModelConfig(compute_dtype="float32")
    sd = get_model(cfg, image_size=64).state_dict()
    with pytest.raises(ValueError, match="quadtree targets"):
        grad_cam(cfg, sd, *inputs, target_layer="level1", device="cpu")


def test_hierarchy_maps_match_jax(inputs, tmp_path):
    jcfg, cfg, variables = _weights("hierarchical_quadtree", "fusion",
                                    inputs)
    want = jax_maps(jcfg, variables, inputs[0])
    got = hierarchy_maps(cfg, from_jax_variables(variables), inputs[0],
                         device="cpu")
    assert set(got) == {"base", "level1", "level2"}
    assert got["level2"].shape == (2, 16, 2, 2)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    path = str(tmp_path / "hier.png")
    assert plot_hierarchy(got, out_path=path) == path and os.path.exists(path)


def test_resize_and_overlay():
    cam = np.random.default_rng(1).uniform(0, 1, (2, 4, 5)).astype(
        np.float32)
    np.testing.assert_allclose(resize_bilinear(cam, (16, 20)).numpy(),
                               np.asarray(jax_resize(jnp.asarray(cam),
                                                     (16, 20))),
                               rtol=1e-5, atol=1e-6)
    out = overlay_heatmap(np.zeros((64, 64, 3), np.uint8), cam[0])
    assert out.shape == (64, 64, 3) and out.dtype == np.uint8


def test_cam_command_writes_overlays(tmp_path, capsys):
    """``python -m surya_tpu_torch cam --synthetic --device cpu --limit 1``
    on a ``.pt`` state_dict, as the JAX CLI's test does."""
    cfg = ModelConfig(num_classes=4, compute_dtype="float32")
    ckpt = str(tmp_path / "model.pt")
    torch.save(get_model(cfg, image_size=64).state_dict(), ckpt)
    out = str(tmp_path / "cams")
    assert main(["cam", ckpt, "--preset", "quadtree-fusion", "--synthetic",
                 "--out", out, "--limit", "1", "--device", "cpu",
                 "--data.image_size=64", "--data.synthetic_size=16",
                 "--data.batch_size=4", "--model.num_classes=4",
                 "--model.compute_dtype=float32"]) == 0
    jpgs = [f for _, _, fs in os.walk(out) for f in fs
            if f.endswith("_cam.jpg")]
    assert len(jpgs) == 4
    assert "wrote 4 CAM overlays" in capsys.readouterr().out
