"""One ``quadtree-3d`` train step of the port against JAX's
``make_train_step`` at f32 on the CPU (32 px, B = 4, T = 5): the preset's
optimizer (AdamW, weight decay 5e-4, global-norm clip 1.0), the same
initial weights through ``from_jax_variables``, the same numpy batch,
dropout 0 (masks drawn by two frameworks cannot match).

Compared, with the tolerances of ``tests/test_torch_spatial_train.py``: the
loss (1e-5), the BN running statistics (rtol 1e-4, atol 1e-5), every
updated parameter (AdamW's first step moves each by lr·g/(|g| + eps), so a
gradient within float noise of 0 may step the other way: two steps' size)
and each parameter's update to 5e-2 relative L2 but the conv biases before
train-mode BN, whose exact gradient is 0 (held to the two-step bound).
"""

import numpy as np

import jax

from surya_tpu.core import config as jcfg
from surya_tpu.models import get_model as jax_get_model
from surya_tpu.train import steps as jsteps
from surya_tpu_torch.core.config import get_preset
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.from_jax import from_jax_variables
from surya_tpu_torch.train import steps as tsteps
from torch_port_fixtures import one_torch_thread  # noqa: F401

IMG, B, T, CLASSES = 32, 4, 5, 5


def test_one_quadtree_3d_train_step_matches_jax():
    overrides = {"model.num_classes": str(CLASSES),
                 "model.compute_dtype": "float32", "model.dropout": "0.0",
                 "data.batch_size": str(B)}
    port = get_preset("quadtree-3d").override(overrides)
    ref = jcfg.get_preset("quadtree-3d").override(overrides)
    assert port.train.grad_clip == 1.0 and port.data.seq_len == T
    rng = np.random.default_rng(42)
    batch = (rng.normal(size=(B, T, IMG, IMG, 3), scale=0.5).astype(
                 np.float32),
             rng.normal(size=(B, T, 47)).astype(np.float32),
             rng.integers(0, CLASSES, size=(B,)).astype(np.int32))

    jm = jax_get_model(ref.model)
    jstate, jtx = jsteps.create_train_state(jm, ref, jax.random.key(0), batch)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    tm = get_model(port.model)
    tm.load_state_dict(from_jax_variables(
        {"params": to_np(jstate.params),
         "batch_stats": to_np(jstate.batch_stats)}), strict=True)
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
    assert len(stats) == 10
    for key, w in stats.items():
        np.testing.assert_allclose(state[key].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    lr = port.train.lr
    params = from_jax_variables({"params": to_np(jstate.params)})
    assert set(params) == set(start)
    for key, w in params.items():
        got = state[key]
        assert (got - w).abs().max() <= 2.01 * lr, key
        if not key.endswith("_conv.bias"):
            du, dw = got - start[key], w - start[key]
            assert (du - dw).norm() / dw.norm() < 5e-2, key
