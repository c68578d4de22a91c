"""The port's serving artifact (``infer/serve.py``: ``export_model`` →
``load_exported``) on the CPU, against the JAX package's on the same
weights (the bridge: ``from_jax_variables``), and the two kernels'
operators that ``torch.export`` keeps in the graph."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax.numpy as jnp

from surya_tpu.core.config import ModelConfig as JaxModelConfig
from surya_tpu.infer.serve import export_model as jax_export_model
from surya_tpu.infer.serve import load_exported as jax_load_exported
from surya_tpu.models import get_model as jax_get_model
from surya_tpu_torch.core.config import ModelConfig
from surya_tpu_torch.infer.serve import (
    Predictor,
    export_model,
    load_exported,
)
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.from_jax import from_jax_variables
from surya_tpu_torch.ops.cuda import fusion_head, quadrant
from test_torch_resnet import numpy_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401

SIZE, B = 64, 3
OPS = (torch.ops.surya_tpu_torch.quadrant_process.default,
       torch.ops.surya_tpu_torch.fusion_head.default)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, size=(B, SIZE, SIZE, 3), dtype=np.uint8)
    feats = rng.normal(size=(B, 47)).astype(np.float32)
    jcfg = JaxModelConfig(name="quadtree", num_classes=5,
                          compute_dtype="float32")
    variables = numpy_variables(jax_get_model(jcfg), jnp.asarray(raw / 255.),
                                jnp.asarray(feats), train=False)
    cfg = ModelConfig(name="quadtree", num_classes=5,
                      compute_dtype="float32")
    return jcfg, cfg, variables, from_jax_variables(variables), raw, feats


@pytest.fixture(scope="module")
def f32_artifact(setup, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "quadtree.pt2")
    export_model(setup[1], setup[3], path, batch_size=B, image_size=SIZE,
                 device="cpu")
    return path


def _numpy(out):
    preds, probs = out
    assert preds.dtype == torch.int32 and probs.dtype == torch.float32
    return preds.numpy(), probs.numpy()


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_artifact_matches_jax(setup, f32_artifact, tmp_path, wire):
    jcfg, cfg, variables, sd, raw, feats = setup
    images = raw if wire == "uint8" else (raw / 255.0).astype(np.float32)
    jpath = str(tmp_path / "jax.stablehlo")
    jax_export_model(jcfg, variables, jpath, batch_size=B, image_size=SIZE,
                     input_dtype=jnp.dtype(wire))
    want_preds, want_probs = jax_load_exported(jpath).call(
        jnp.asarray(images), jnp.asarray(feats))
    path = f32_artifact
    if wire == "uint8":
        path = str(tmp_path / "port.pt2")
        export_model(cfg, sd, path, batch_size=B, image_size=SIZE,
                     input_dtype=wire, device="cpu")
    loaded = load_exported(path, device="cpu")
    assert (loaded.meta["input_dtype"], loaded.meta["batch_size"]) == (wire, B)
    preds, probs = _numpy(loaded.call(images, feats))
    np.testing.assert_allclose(probs, np.asarray(want_probs), atol=1e-5)
    np.testing.assert_array_equal(preds, np.asarray(want_preds))


def test_bf16_artifact_matches_bf16_predictor(setup, tmp_path):
    _, _, _, sd, raw, feats = setup
    cfg = ModelConfig(name="quadtree", num_classes=5)     # bf16 compute
    path = str(tmp_path / "bf16.pt2")
    export_model(cfg, sd, path, batch_size=B, image_size=SIZE,
                 param_dtype=torch.bfloat16, input_dtype="uint8",
                 device="cpu")
    preds, probs = _numpy(load_exported(path, device="cpu").call(raw, feats))
    want_preds, want_probs = Predictor(
        cfg, sd, batch_size=B, image_size=SIZE, param_dtype=torch.bfloat16,
        input_dtype="uint8", device="cpu").predict(raw, feats)
    # the same aten calls on the same CPU: the same bits
    np.testing.assert_array_equal(probs, want_probs)
    np.testing.assert_array_equal(preds, want_preds)


def test_temporal_artifact_matches_predictor(tmp_path):
    cfg = ModelConfig(name="cnn_lstm", num_classes=4, seq_len=2,
                      compute_dtype="float32")
    torch.manual_seed(0)
    sd = get_model(cfg, image_size=32).state_dict()
    rng = np.random.default_rng(1)
    clips = rng.random((2, 2, 32, 32, 3), dtype=np.float32)
    feats = rng.normal(size=(2, 2, 47)).astype(np.float32)
    path = str(tmp_path / "cnn_lstm.pt2")
    export_model(cfg, sd, path, batch_size=2, image_size=32, device="cpu")
    loaded = load_exported(path, device="cpu")
    targets = {n.target for n in loaded.program.graph.nodes}
    assert OPS[1] in targets and OPS[0] not in targets   # no quadrant block
    preds, probs = _numpy(loaded.call(clips, feats))
    want_preds, want_probs = Predictor(cfg, sd, batch_size=2, image_size=32,
                                       device="cpu").predict(clips, feats)
    np.testing.assert_array_equal(probs, want_probs)
    np.testing.assert_array_equal(preds, want_preds)


def test_graph_holds_the_inference_ops(setup, f32_artifact):
    """Each kernel is one node of its inference operator; no training
    form was traced (it would inline the plain quadrant convolution next to
    the trunk's and carry no operator node)."""
    loaded = load_exported(f32_artifact, device="cpu")
    nodes = [n for n in loaded.program.graph.nodes
             if n.op == "call_function"]
    assert [sum(n.target == op for n in nodes) for op in OPS] == [1, 1]
    convs = sum(n.target == torch.ops.aten.conv2d.default for n in nodes)
    trunk = get_model(setup[1], image_size=SIZE).trunk
    assert convs == sum(p.dim() == 4 for p in trunk.parameters())
    assert not any("autograd" in str(n.target) or "higher_order"
                   in str(n.target) for n in nodes)


def test_a_trace_with_gradients_misses_the_operators(setup):
    """Why ``export_model`` traces frozen weights under ``no_grad``: with
    a gradient wanted the wrappers take the training forms, and the trace
    inlines their plain versions where the operators should be."""
    from surya_tpu_torch.infer.serve import serving_forward

    _, cfg, _, sd, _, feats = setup
    forward = serving_forward(cfg, sd, SIZE, None, torch.device("cpu"))
    forward.requires_grad_(True)
    program = torch.export.export(forward, (
        torch.zeros(B, SIZE, SIZE, 3), torch.from_numpy(feats)))
    targets = [n.target for n in program.graph.nodes]
    assert not any(op in targets for op in OPS)
    trunk = get_model(cfg, image_size=SIZE).trunk
    assert sum(t == torch.ops.aten.conv2d.default for t in targets) == sum(
        p.dim() == 4 for p in trunk.parameters()) + 1


def test_call_refuses_other_inputs(setup, f32_artifact, tmp_path):
    raw, feats = setup[4], setup[5]
    loaded = load_exported(f32_artifact, device="cpu")
    with pytest.raises(ValueError, match="takes images"):
        loaded.call(raw, feats)                       # uint8 on an f32 wire
    with pytest.raises(ValueError, match="takes images"):
        loaded.call((raw[:2] / 255.0).astype(np.float32), feats[:2])
    other = tmp_path / "other.pt2"
    torch.export.save(torch.export.export(torch.nn.ReLU(),
                                          (torch.zeros(2),)), str(other))
    with pytest.raises(ValueError, match="not an export_model artifact"):
        load_exported(str(other), device="cpu")


def test_move_to_device_pass_round_trips(setup, f32_artifact):
    """save → load → ``move_to_device_pass(…, "cpu")`` gives the program
    that was traced, to the bit."""
    from surya_tpu_torch.infer.serve import input_shapes, serving_forward

    _, cfg, _, sd, raw, feats = setup
    forward = serving_forward(cfg, sd, SIZE, None, torch.device("cpu"))
    images = torch.from_numpy((raw / 255.0).astype(np.float32))
    img, _ = input_shapes(cfg, B, SIZE)
    assert tuple(images.shape) == img
    with torch.no_grad():
        program = torch.export.export(forward, (images,
                                                torch.from_numpy(feats)))
        want = program.module()(images, torch.from_numpy(feats))
    got = load_exported(f32_artifact, device="cpu").call(images, feats)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_flop_formulas_match_the_plain_versions():
    g = torch.Generator().manual_seed(0)
    fmap = torch.randn(2, 8, 8, 16, generator=g)
    kernel, bias = torch.randn(3, 3, 16, 12, generator=g), torch.randn(12)
    x = torch.randn(3, 40, generator=g)
    w1, b1 = torch.randn(24, 40, generator=g), torch.randn(24)
    w2, b2 = torch.randn(5, 24, generator=g), torch.randn(5)
    for op, plain, args, want in (
            (quadrant.quadrant_op, quadrant.quadrant_process_plain,
             (fmap, kernel, bias), 2 * 2 * 4 * 4 ** 2 * 9 * 16 * 12),
            (fusion_head.fusion_head_op, fusion_head.fusion_head_plain,
             (x, w1, b1, w2, b2), 2 * 3 * (40 * 24 + 24 * 5))):
        with FlopCounterMode(display=False) as on_op:
            out = op(*args)
        with FlopCounterMode(display=False) as on_plain:
            ref = plain(*args)
        assert torch.equal(out, ref)
        assert on_op.get_total_flops() == on_plain.get_total_flops() == want


def test_cost_analysis_counts_one_chunk(setup):
    _, cfg, _, sd, raw, feats = setup
    pred = Predictor(cfg, sd, batch_size=B, image_size=SIZE, device="cpu")
    cost = pred.cost_analysis()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        pred.serving(torch.from_numpy((raw / 255.0).astype(np.float32)),
                     torch.from_numpy(feats))
    assert set(cost) == {"flops"}
    assert cost["flops"] == counter.get_total_flops() > 0
