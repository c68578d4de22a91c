"""Serving tier of the PyTorch port against the JAX one on the same
weights and numpy inputs: Predictor padding and chunking, the uint8
wire, the empty request, the wire-dtype errors, the HTTP request handler,
the device rule and the .npz checkpoint bridge."""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import traverse_util

from surya_tpu.core.config import ModelConfig as JaxModelConfig
from surya_tpu.infer.http_server import PredictionServer as JaxServer
from surya_tpu.infer.serve import Predictor as JaxPredictor
from surya_tpu.models import get_model as jax_get_model
from surya_tpu_torch.core.config import ModelConfig
from surya_tpu_torch.infer.http_server import PredictionServer, load_state_dict
from surya_tpu_torch.infer.serve import Predictor
from surya_tpu_torch.models.from_jax import (
    from_jax_variables,
    load_npz_variables,
)
from test_torch_resnet import numpy_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401

SIZE, CLASSES = 64, ["c0", "c1", "c2", "c3", "c4"]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, size=(5, SIZE, SIZE, 3), dtype=np.uint8)
    feats = rng.normal(size=(5, 47)).astype(np.float32)
    jcfg = JaxModelConfig(name="quadtree", num_classes=5,
                          compute_dtype="float32")
    variables = numpy_variables(jax_get_model(jcfg), jnp.asarray(raw / 255.),
                                jnp.asarray(feats), train=False)
    cfg = ModelConfig(name="quadtree", num_classes=5,
                      compute_dtype="float32")
    return jcfg, cfg, variables, from_jax_variables(variables), raw, feats


def _pair(setup, **kw):
    jcfg, cfg, variables, sd, _, _ = setup
    jkw = {k: (jnp.uint8 if v == "uint8" else v) for k, v in kw.items()}
    return (JaxPredictor(jcfg, variables, image_size=SIZE, **jkw),
            Predictor(cfg, sd, image_size=SIZE, device="cpu", **kw))


@pytest.mark.parametrize("batch_size,n", [(4, 3),    # one padded chunk
                                          (2, 5),    # chunks + padded tail
                                          (4, 0)])   # empty request
def test_predictor_matches_jax(setup, batch_size, n):
    raw, feats = setup[4][:n], setup[5][:n]
    jp, tp = _pair(setup, batch_size=batch_size)
    want_preds, want_probs = jp.predict(raw / 255.0, feats)
    preds, probs = tp.predict(raw / 255.0, feats)
    assert preds.dtype == np.int32 and probs.dtype == np.float32
    assert probs.shape == (n, 5) and preds.shape == (n,)
    np.testing.assert_allclose(probs, want_probs, atol=1e-5)
    np.testing.assert_array_equal(preds, want_preds)


def test_uint8_wire_matches_jax(setup):
    raw, feats = setup[4], setup[5]
    jp, tp = _pair(setup, batch_size=4, input_dtype="uint8")
    want_preds, want_probs = jp.predict(raw, feats)
    preds, probs = tp.predict(raw, feats)
    np.testing.assert_allclose(probs, want_probs, atol=1e-5)
    np.testing.assert_array_equal(preds, want_preds)
    # the same as sending the normalised floats to a float wire
    _, probs_f = _pair(setup, batch_size=4)[1].predict(raw / 255.0, feats)
    np.testing.assert_allclose(probs, probs_f, atol=1e-6)


def test_predict_rejects_wire_dtype_mismatch(setup):
    _, cfg, _, sd, raw, feats = setup
    p_f32 = Predictor(cfg, sd, batch_size=4, image_size=SIZE, device="cpu")
    with pytest.raises(ValueError, match="integer dtype"):
        p_f32.predict(raw, feats)
    p_u8 = Predictor(cfg, sd, batch_size=4, image_size=SIZE,
                     input_dtype=np.uint8, device="cpu")
    with pytest.raises(ValueError, match="wire format is uint8"):
        p_u8.predict(raw / 255.0, feats)


def test_bf16_params_keep_f32_bn_stats(setup):
    _, cfg, _, sd, raw, feats = setup
    jp, tp = _pair(setup, batch_size=4)
    _, want = jp.predict(raw / 255.0, feats)
    p = Predictor(cfg, sd, batch_size=4, image_size=SIZE, device="cpu",
                  param_dtype=torch.bfloat16)
    _, probs = p.predict(raw / 255.0, feats)
    np.testing.assert_allclose(probs, want, atol=0.05)
    assert all(b.dtype == torch.float32 for b in p.model.buffers())
    assert all(q.dtype == torch.bfloat16 for q in p.model.parameters())


def test_default_device_is_the_card(setup, monkeypatch):
    """No device given → CUDA; without a card that raises, never runs
    silently on the CPU."""
    _, cfg, _, sd, _, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg, sd, image_size=SIZE)


def _npz_bytes(images, feats):
    buf = io.BytesIO()
    np.savez(buf, images=images, features=feats)
    return buf.getvalue()


@pytest.fixture(scope="module")
def servers(setup):
    jp, tp = _pair(setup, batch_size=4, input_dtype="uint8")
    return JaxServer(jp, CLASSES), PredictionServer(tp, CLASSES)


def test_info_matches_jax(servers):
    jsrv, tsrv = servers
    assert tsrv.info() == jsrv.info()


@pytest.mark.parametrize("kind", ["npz", "json"])
def test_handle_bytes_matches_jax(servers, setup, kind):
    jsrv, tsrv = servers
    raw, feats = setup[4], setup[5]
    if kind == "npz":
        body, ctype = _npz_bytes(raw, feats), "application/x-npz"
    else:
        body = json.dumps({"images": raw.tolist(),
                           "features": feats.tolist()}).encode()
        ctype = "application/json"
    want, got = jsrv.handle_bytes(body, ctype), tsrv.handle_bytes(body, ctype)
    assert got["n"] == want["n"] and got["labels"] == want["labels"]
    assert got["predictions"] == want["predictions"]
    np.testing.assert_allclose(got["probabilities"], want["probabilities"],
                               atol=1e-5)


@pytest.mark.parametrize("body,ctype,match", [
    (b"not a zip", "application/x-npz", "npz"),
    (b'{"images": [[1, 2]]}', "application/json", "features"),
    (b'{"images": [[0.5]], "features": [[1]]}', "application/json",
     "integers"),
])
def test_bad_requests_raise_like_jax(servers, body, ctype, match):
    jsrv, tsrv = servers
    for srv in (jsrv, tsrv):
        with pytest.raises(ValueError, match=match):
            srv.handle_bytes(body, ctype)


def test_http_round_trip(servers, setup):
    _, tsrv = servers
    raw, feats = setup[4][:2], setup[5][:2]
    httpd = tsrv.make_server("127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["input_dtype"] == "uint8"
        req = urllib.request.Request(
            url + "/predict", data=_npz_bytes(raw, feats),
            headers={"Content-Type": "application/x-npz"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert out["n"] == 2 and len(out["probabilities"]) == 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_npz_checkpoint_from_jax_variables_loads(setup, tmp_path):
    """The README's bridge: flatten_dict(sep="/") → np.savez → the port's
    load_npz_variables / load_state_dict give the same state_dict."""
    variables, sd = setup[2], setup[3]
    flat = traverse_util.flatten_dict(variables, sep="/")
    path = str(tmp_path / "ckpt.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})
    tree = load_npz_variables(path)
    loaded = from_jax_variables(tree)
    assert loaded.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(loaded[k], sd[k], rtol=0, atol=0)
    assert load_state_dict(path).keys() == sd.keys()
    pt = str(tmp_path / "ckpt.pt")
    torch.save(sd, pt)
    assert load_state_dict(pt).keys() == sd.keys()
