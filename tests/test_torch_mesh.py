"""The port's mesh and the global batch (``surya_tpu_torch/core/mesh.py``)
against ``surya_tpu/core/mesh.py``, and the layers that must see the
global batch, on the CPU without processes:

- ``MeshSpec.resolve`` (results and error texts) and each rank's rows
  against JAX's sharding of the batch on the conftest's 8 CPU devices;
  a mesh of several devices outside ``torchrun`` names ``torchrun``;
- **the BatchNorm finding**: on maps shifted by 0, 3, 10 and 30σ the
  port's train-mode ``BatchNorm`` (two-pass variance) stays within 2e-5
  of an f64 reference, where flax's ``E[x²] − E[x]²`` drifts to ~4e-3 at
  30σ (reported beside it); Chan's merge of two halves' (count, mean, M2)
  is the one-process statistics within 1e-6;
- a rank's rows of every draw: the head's Philox bits at a row offset,
  ``flax_dropout`` (also with frames folded into the rows), the fused
  head in train mode and the augmentation's parameters are the rows of
  the global batch's.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from surya_tpu.core import mesh as jmesh
from surya_tpu_torch.core import mesh as tmesh
from surya_tpu_torch.data.augment import augment_batch
from surya_tpu_torch.models.backbones.resnet import (
    BatchNorm,
    global_batch_stats,
    merge_moments,
)
from surya_tpu_torch.models.common import FusionClassifier, flax_dropout
from surya_tpu_torch.ops.cuda.fusion_head import philox_bits
from torch_port_fixtures import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("spec,n", [
    ((-1, 1, 1), 8), ((-1, 2, 1), 8), ((2, 2, 2), 8), ((-1, 3, 1), 8),
    ((4, 1, 1), 8), ((-1, 1, 1), 1), ((1, 2, 1), 2)])
def test_mesh_spec_resolve_is_jax(spec, n):
    def outcome(cls):
        try:
            return cls(*spec).resolve(n)
        except ValueError as e:
            return str(e)

    assert outcome(tmesh.MeshSpec) == outcome(jmesh.MeshSpec)


@pytest.mark.parametrize("shape", [(8, 1, 1), (4, 2, 1), (2, 2, 2),
                                   (1, 8, 1), (2, 1, 4)])
def test_row_span_of_each_rank_is_jax(shape):
    """Every grid position's rows are the rows JAX's batch sharding gives
    the device there (a replicated batch axis: all of them)."""
    n = 16
    grid = np.asarray(jax.devices()).reshape(shape)
    mesh = jax.sharding.Mesh(grid, jmesh.AXES)
    index = jmesh.data_sharding(mesh, 2).devices_indices_map((n, 3))
    for pos in np.ndindex(*shape):
        rows = index[grid[pos]][0]
        want = ((rows.start or 0, n if rows.stop is None else rows.stop),)
        port = tmesh.Mesh(dict(zip(tmesh.AXES, shape)),
                          dict(zip(tmesh.AXES, pos)),
                          {a: None for a in tmesh.AXES})
        assert port.row_shard(n).spans == want, pos
        x = np.arange(n * 3).reshape(n, 3)
        np.testing.assert_array_equal(tmesh.shard_batch(port, (x,))[0],
                                      x[slice(*want[0])])


def test_row_shard_of_microbatches_and_jax_errors():
    port = tmesh.Mesh({"data": 2, "model": 1, "seq": 1},
                      {"data": 1, "model": 0, "seq": 0},
                      {a: None for a in tmesh.AXES})
    # grad_accum=2 of a 8-row batch: rank 1 holds rows 2-3 and 6-7
    assert port.row_shard(8, 2).spans == ((2, 4), (6, 8))
    with pytest.raises(ValueError,
                       match="global batch 7 not divisible by data-axis "
                             "size 2"):
        port.row_shard(7)


def test_mesh_of_several_devices_outside_torchrun_names_torchrun():
    assert tmesh.create_mesh(device="cpu").shape == {
        "data": 1, "model": 1, "seq": 1}
    with pytest.raises(RuntimeError, match="torchrun.*single-controller"):
        tmesh.create_mesh(tmesh.MeshSpec(data=2), device="cpu")
    tmesh.maybe_initialize_distributed("cpu")   # no WORLD_SIZE: no-op
    assert not torch.distributed.is_initialized()


def _shifted(shape, shift, seed):
    return (np.random.default_rng(seed).normal(size=shape) + shift).astype(
        np.float32)


def _f64_batch_norm(x):
    x = x.astype(np.float64)
    axes = tuple(range(x.ndim - 1))
    mean = x.mean(axes)
    var = ((x - mean) ** 2).mean(axes)
    return (x - mean) / np.sqrt(var + 1e-5)


@pytest.mark.parametrize("shape", [(4, 64, 64, 16), (4, 16, 16, 64)])
@pytest.mark.parametrize("shift", [0.0, 3.0, 10.0, 30.0])
def test_train_mode_batch_norm_against_f64(shape, shift):
    """The BN finding (ROADMAP §C): the port's two-pass variance stays
    within 2e-5 of f64 at every shift; flax's fast variance does not (its
    error is printed, not asserted: a finding on the JAX side)."""
    x = _shifted(shape, shift, seed=int(shift) + shape[-1])
    want = _f64_batch_norm(x)
    bn = BatchNorm(shape[-1]).train()
    with torch.no_grad():
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    err = float(np.abs(got - want).max())
    flax = nn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    y, _ = flax.apply(flax.init(jax.random.key(0), jnp.asarray(x)),
                      jnp.asarray(x), mutable=["batch_stats"])
    flax_err = float(np.abs(np.asarray(y) - want).max())
    print(f"shift {shift}σ {shape}: port {err:.2e}, flax {flax_err:.2e}")
    assert err <= 2e-5


def test_merged_statistics_are_the_one_process_ones():
    """dp2's merge of (count, mean, M2) against the statistics of the whole
    batch in one process, on a map shifted by 10σ: the variance within
    1e-6, the mean within 1e-6 of itself (an f32 mean near 10 has an ulp
    of 9.5e-7); and both against f64."""
    x = torch.from_numpy(_shifted((8, 12, 12, 16), 10.0, 1)).permute(
        0, 3, 1, 2)
    halves = [global_batch_stats(h, None) for h in x.split(4)]
    parts = torch.stack([torch.stack([c, m, v * c]) for c, m, v in halves])
    count, mean, var = merge_moments(parts)
    whole = global_batch_stats(x, None)
    assert torch.equal(count, whole[0])
    torch.testing.assert_close(mean, whole[1], rtol=1e-6, atol=0)
    torch.testing.assert_close(var, whole[2], rtol=0, atol=1e-6)
    x64 = x.double()
    torch.testing.assert_close(mean.double(), x64.mean((0, 2, 3)),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(var.double(), x64.var((0, 2, 3),
                                                     correction=0),
                               rtol=0, atol=1e-6)


def _rows(total, start, stop):
    return tmesh.RowShard(total, ((start, stop),))


def test_philox_bits_at_a_row_offset_are_global_rows():
    full = philox_bits(1234, 10, 40)
    assert torch.equal(philox_bits(1234, 4, 40, row_offset=6), full[6:])
    assert torch.equal(philox_bits(1234, 3, 40, row_offset=2), full[2:5])


@pytest.mark.parametrize("per", [1, 3])
def test_flax_dropout_keeps_the_rows_of_the_global_mask(per):
    """A rank's mask is its rows of the global batch's, drawn whole from
    the shared generator; ``per`` frames folded into each row (a clip)."""
    x = torch.ones(6 * per, 5)
    want = flax_dropout(x, 0.5, torch.Generator().manual_seed(3), True)
    with tmesh.batch_rows(_rows(6, 2, 4)):
        got = flax_dropout(x[2 * per:4 * per], 0.5,
                           torch.Generator().manual_seed(3), True)
        shared = flax_dropout(torch.ones(4, 4), 0.5,
                              torch.Generator().manual_seed(3), True,
                              shape=(4, 4))   # broadcast: no batch axis
    assert torch.equal(got, want[2 * per:4 * per])
    assert torch.equal(shared, flax_dropout(
        torch.ones(4, 4), 0.5, torch.Generator().manual_seed(3), True,
        shape=(4, 4)))


def test_fused_head_in_train_mode_computes_global_rows():
    torch.manual_seed(0)
    head = FusionClassifier(24, 3, dropout=0.5, dtype=torch.float32).train()
    x = torch.randn(6, 24)
    want = head(x, torch.Generator().manual_seed(9))
    with tmesh.batch_rows(_rows(6, 3, 6)):
        got = head(x[3:], torch.Generator().manual_seed(9))
    torch.testing.assert_close(got, want[3:], rtol=0, atol=0)


def test_augmentation_draw_is_the_global_batch_rows():
    images = torch.rand(4, 40, 40, 3)
    want = augment_batch(torch.Generator().manual_seed(5), images,
                         out_size=32)
    with tmesh.batch_rows(tmesh.RowShard(4, ((1, 2), (3, 4)))):
        got = augment_batch(torch.Generator().manual_seed(5),
                            images[[1, 3]], out_size=32)
    torch.testing.assert_close(got, want[[1, 3]], rtol=0, atol=0)
