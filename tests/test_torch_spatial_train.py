"""One train step of the hierarchical families against JAX's
``make_train_step`` at f32 on the CPU (64 px, B = 4): same initial
weights through ``from_jax_variables``, same numpy batch, dropout 0.

Both packages fix these families' dropout at 0.5 (JAX's registry passes
them no ``cfg.dropout``), so the JAX modules are built here with dropout 0
by patching the two heads' constructors in the test, and the port's
modules get their ``dropout`` attribute set to 0: masks drawn by two
frameworks cannot match.

Compared, with the tolerances of ``tests/test_torch_train_steps.py``: the
loss (1e-5), the BN running statistics (rtol 1e-4, atol 1e-5), every
updated parameter (AdamW's first step moves each by lr·g/(|g| + eps), so
a gradient within float noise of 0 may step the other way: two steps'
size) and, outside the badly conditioned trunk, each parameter's update
to 5e-2 relative L2 (but for ``ZERO_GRADIENT``).
"""

import numpy as np
import pytest

import jax

from surya_tpu.core import config as jcfg
from surya_tpu.models import get_model as jax_get_model
from surya_tpu.models.spatial import hierarchical as jax_hier
from surya_tpu.train import steps as jsteps
from surya_tpu_torch.core.config import (
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.from_jax import from_jax_variables
from surya_tpu_torch.train import steps as tsteps
from torch_port_fixtures import one_torch_thread  # noqa: F401

IMG, B, CLASSES = 64, 4, 5
# The attention gate's last bias shifts all 16 scores alike, and a softmax
# does not move under a shift: its exact gradient is 0, so both frameworks
# step it on rounding noise (Adam's lr·g/|g|) in any direction. It is held
# to the two-step bound alone.
ZERO_GRADIENT = {"attn_fc2.bias"}


def _no_dropout(cls):
    return lambda **kw: cls(**{**kw, "dropout": 0.0})


@pytest.mark.parametrize("name", ["hierarchical_quadtree",
                                  "attention_hierarchical"])
def test_one_train_step_matches_jax(name, monkeypatch):
    monkeypatch.setattr(jax_hier, "FusionClassifier",
                        _no_dropout(jax_hier.FusionClassifier))
    monkeypatch.setattr(jax_hier, "SingleLayerNumericalMLP",
                        _no_dropout(jax_hier.SingleLayerNumericalMLP))
    model = dict(name=name, num_classes=CLASSES, compute_dtype="float32")
    train = dict(lr=1e-4, weight_decay=1e-4)
    port = Config(model=ModelConfig(**model), data=DataConfig(batch_size=B),
                  train=TrainConfig(**train))
    ref = jcfg.Config(model=jcfg.ModelConfig(**model),
                      data=jcfg.DataConfig(batch_size=B),
                      train=jcfg.TrainConfig(**train))
    rng = np.random.default_rng(42)
    batch = (rng.normal(size=(B, IMG, IMG, 3), scale=0.5).astype(np.float32),
             rng.normal(size=(B, 47)).astype(np.float32),
             rng.integers(0, CLASSES, size=(B,)).astype(np.int32))

    jm = jax_get_model(ref.model)
    jstate, jtx = jsteps.create_train_state(jm, ref, jax.random.key(0), batch)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    tm = get_model(port.model, image_size=IMG)
    tm.load_state_dict(from_jax_variables(
        {"params": to_np(jstate.params),
         "batch_stats": to_np(jstate.batch_stats)}), strict=True)
    tm.classifier.dropout = tm.numerical_mlp.dropout = 0.0
    tstate, ttx = tsteps.create_train_state(tm, port, device="cpu")
    start = {k: v.detach().clone() for k, v in tm.named_parameters()}

    jstate, jmet = jsteps.make_train_step(jm, jtx, ref)(
        jstate, batch, jax.random.key(1))
    tstate, tmet = tsteps.make_train_step(tm, ttx, port)(tstate, batch)

    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    assert float(tmet["accuracy"]) == float(jmet["accuracy"])
    state = tm.state_dict()
    stats = from_jax_variables({"batch_stats": to_np(jstate.batch_stats)})
    assert len(stats) == 40
    for key, w in stats.items():
        np.testing.assert_allclose(state[key].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    lr = port.train.lr
    params = from_jax_variables({"params": to_np(jstate.params)})
    assert set(params) == set(start)
    for key, w in params.items():
        got = state[key]
        assert (got - w).abs().max() <= 2.01 * lr, key
        if not key.startswith("trunk.") and key not in ZERO_GRADIENT:
            du, dw = got - start[key], w - start[key]
            assert (du - dw).norm() / dw.norm() < 5e-2, key
