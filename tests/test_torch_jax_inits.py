"""The key form of JAX's initial variables (``tests/replay_diag.py``), which
carries 10 seeds of a trunk's initial weights to the card in kilobytes:
numpy's threefry bits equal ``jax.random.bits``, and a flax model's
``init`` comes back bit for bit from its draws' keys and scales, while a
changed scale is refused by the digest."""

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp

from replay_diag import (
    TN_TABLE,
    decode_keys,
    digest,
    encode_keys,
    recorded_draws,
    threefry_bits,
    truncated_normal_table,
)
from surya_tpu.models.common import FusionClassifier


@pytest.mark.parametrize("shape", [(7,), (5, 7, 3), (3, 3, 16, 32)])
def test_threefry_bits_are_jax_bits(shape):
    key = jax.random.fold_in(jax.random.key(3), 77)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    assert np.array_equal(threefry_bits(jax.random.key_data(key), shape),
                          want)


class Trunk(nn.Module):
    """The layer kinds of the trainable trunks: a conv, a depthwise conv,
    a 3-D conv, train-mode BN, and the fused head's two kernels."""

    @nn.compact
    def __call__(self, x, clip):
        x = nn.Conv(8, (3, 3), use_bias=False)(x)
        x = nn.BatchNorm(use_running_average=False)(x)
        x = nn.Conv(8, (3, 3), feature_group_count=8, use_bias=False)(x)
        c = nn.Conv(4, (3, 3, 3))(clip).mean((1, 2, 3))
        h = jnp.concatenate([x.reshape(x.shape[0], -1), c], -1)
        h = FusionClassifier(num_classes=5, hidden_dim=16,
                             dtype=jnp.float32, name="classifier")(h)
        return h


def write_table(out, draws):
    """The table beside the key form, with only the entries ``draws``
    select (the rest 0: a wrong pick fails the digest)."""
    used = np.unique(np.concatenate([
        threefry_bits(key, shape).ravel() >> np.uint32(9)
        for key, shape, _ in draws]))
    table = np.zeros(2 ** 23, np.float32)
    table[used] = truncated_normal_table(used)
    bits = table.view(np.int32)
    np.savez_compressed(out / TN_TABLE, first=bits[:1], step=np.diff(bits))


def test_table_entries_are_jax_truncated_normals():
    """An entry is the draw of an element whose bits select it: JAX's own
    draw, rebuilt through the entries its bits pick."""
    key = jax.random.key(9)
    want = np.asarray(jax.random.truncated_normal(key, -2, 2, (4, 50)))
    picked = threefry_bits(jax.random.key_data(key), (4, 50)) >> np.uint32(9)
    assert np.array_equal(truncated_normal_table(picked.ravel()).reshape(
        4, 50).view(np.uint32), want.view(np.uint32))


def test_key_form_rebuilds_a_flax_init(tmp_path):
    """Initialised as flax does, through the key form and back."""
    with recorded_draws() as draws:
        variables = Trunk().init({"params": jax.random.key(4)},
                                 jnp.zeros((2, 6, 6, 3)),
                                 jnp.zeros((2, 3, 6, 6, 3)))
    write_table(tmp_path, draws)
    flat = {"/".join([col] + [p.key for p in path]): np.asarray(v)
            for col in ("params", "batch_stats")
            for path, v in jax.tree_util.tree_flatten_with_path(
                variables[col])[0]}
    form = encode_keys(flat, draws)
    assert sum(k.startswith("key/") for k in form) == len(draws) == 5
    path = tmp_path / "m_s4_keys.npz"
    np.savez(path, digest=digest(flat), **form)
    rebuilt = decode_keys(str(path))
    assert set(rebuilt) == set(flat)
    for name, w in flat.items():
        assert np.array_equal(rebuilt[name].view(np.uint32),
                              w.view(np.uint32)), name

    name = next(k for k in form if k.startswith("scale/"))
    form[name] = np.nextafter(form[name], np.float32(np.inf))
    np.savez(path, digest=digest(flat), **form)
    with pytest.raises(ValueError, match="does not rebuild"):
        decode_keys(str(path))
