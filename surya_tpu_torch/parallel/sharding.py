"""Tensor-parallel parameter placement over the 'model' axis, mirroring
``surya_tpu/parallel/sharding.py``.

JAX's rule: a parameter with ndim ≥ 2 and at least ``min_elements``
entries is split over 'model' on its output axis when that axis divides
by the axis size; everything else is replicated. JAX's output axis is a
leaf's last; the port's is where the bridge puts it
(``models.from_jax.output_axis``): dim 0 of an OIHW conv or an
``nn.Linear`` weight, the last axis of the HWIO ``quadrant_conv_kernel``.

Each rank keeps its slice of such a parameter (``parametrizations.<name>.
original``, what the optimizer updates). A parametrization gathers the
full weight whenever the model reads it: the hand kernels take the whole
weight, as XLA hands a custom call its operands whole, and every kernel
then runs as on one device. Ranks on the 'model' axis take the same batch
rows (``core.mesh.shard_batch``), so each computes the same full gradient
and keeps its slice of it. The cost is one all-gather per sharded leaf
per forward (an ``all_reduce`` of the full size); the saving is the
leaf's bytes at rest, and its gradient's and Adam moments', over the
'model' axis.
"""

from __future__ import annotations

import re

import torch
import torch.nn as nn
from torch.nn.utils import parametrize

from surya_tpu_torch.core.mesh import MODEL_AXIS, gather
from surya_tpu_torch.models.from_jax import output_axis

MIN_ELEMENTS = 1 << 16


def param_partition_axis(name: str, shape, model_size: int,
                         min_elements: int = MIN_ELEMENTS) -> int | None:
    """The axis the rule splits ``name`` on over 'model', or None."""
    shape = tuple(shape)
    if len(shape) < 2 or model_size <= 1:
        return None
    axis = output_axis(name, len(shape))
    if (torch.Size(shape).numel() >= min_elements
            and shape[axis] % model_size == 0):
        return axis
    return None


def count_sharded(model: nn.Module, model_size: int,
                  min_elements: int = MIN_ELEMENTS) -> tuple[int, int]:
    """(parameters the rule shards, parameters) — for logs and tests;
    works on a model built on ``meta``."""
    named = list(model.named_parameters())
    return sum(param_partition_axis(n, p.shape, model_size, min_elements)
               is not None for n, p in named), len(named)


def canonical_name(name: str) -> str:
    """A parametrized parameter's name as the unsharded model has it."""
    return re.sub(r"(^|\.)parametrizations\.", r"\1", name).removesuffix(
        ".original")


class ModelShard(nn.Module):
    """The parametrization of one sharded leaf: ``right_inverse`` keeps
    this rank's slice, ``forward`` gathers the full tensor (the gradient of
    the slice is its part of the full gradient: ``core.mesh.gather``)."""

    def __init__(self, axis: int, group):
        super().__init__()
        self.axis, self.group = axis, group
        self.index = torch.distributed.get_rank(group)
        self.parts = torch.distributed.get_world_size(group)

    def forward(self, shard):
        full = gather(shard, self.group, self.axis)
        if shard.dim() == 4 and shard.is_contiguous(
                memory_format=torch.channels_last) and not \
                shard.is_contiguous():
            full = full.contiguous(memory_format=torch.channels_last)
        return full

    def right_inverse(self, full):
        size = full.shape[self.axis] // self.parts
        return full.narrow(self.axis, self.index * size, size).clone()


def partition_params(model: nn.Module, mesh,
                     min_elements: int = MIN_ELEMENTS) -> dict[str, int]:
    """Shard ``model``'s parameters over the mesh's 'model' axis by the
    rule, in place → {name: axis} of the sharded ones (none at model 1)."""
    size = mesh.shape[MODEL_AXIS]
    sharded = {name: axis for name, p in model.named_parameters()
               if (axis := param_partition_axis(name, p.shape, size,
                                                min_elements)) is not None}
    for name, axis in sharded.items():
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        parametrize.register_parametrization(
            module, leaf, ModelShard(axis, mesh.group(MODEL_AXIS)),
            unsafe=True)
    return sharded
