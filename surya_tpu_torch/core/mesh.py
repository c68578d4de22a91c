"""The device mesh and the batch's rows, mirroring ``surya_tpu/core/mesh.py``.

JAX builds a ``Mesh`` over every device of one program and lets XLA place
the collectives. torch runs one process per device (``torchrun``), so here
the mesh is this process's place in a grid of ranks, ``arange(world).
reshape(*sizes)`` as JAX reshapes its devices, with one process group per
axis. The grid takes any ordered ``{axis: size}``: JAX's ('data', 'model',
'seq') ``MeshSpec`` and the ad-hoc ('pipe', 'data'), ('expert', 'data')
and ('pipe', 'model', 'data') meshes of the parallel FACT. Running every
device from one process is JAX's single-controller model, not torch's: a
mesh of more than one device outside ``torchrun`` raises.

**The batch.** Every rank builds the same global batch (the sources are
seeded alike) and keeps its rows: :func:`shard_batch`, JAX's
``_addressable_row_span`` rule. Ranks that differ only on the 'model',
'seq', 'pipe' or 'expert' axis take the same rows; with ``data=1`` every
rank takes all of them. The layers that must see the global batch read the
rows through :func:`current_rows` (a :class:`RowShard`, set with
:func:`batch_rows`): dropout and the augmentation draw the global batch's
values and keep their rows; train-mode BatchNorm merges its statistics
over the data axis; the head's Philox counter starts at the rank's first
row.

**Collectives** are written as ``all_reduce``, ``broadcast`` and the ring
shift :func:`ppermute`: an all-gather is the ``all_reduce`` of a zero
buffer in which each rank writes its own slot (exact). gloo has only
``broadcast``, ``all_reduce`` and ``barrier`` for CUDA tensors and no
``send``/``recv`` for them, and NCCL refuses two ranks on one device, so a
gloo group shifts a CUDA tensor through a host copy (gloo's own CUDA
``all_reduce`` copies to the host inside too). In this form the same code
runs on NCCL, on gloo over CPU tensors and on gloo over CUDA tensors.
``collective_bytes`` counts what they move.

**The two gradient rules** of a value that crosses between replicated
(every rank on an axis holds the same) and split (each rank its part).
Every rank's objective is the same replicated loss, so a replicated
tensor's cotangent is the same on every rank of the axis:

1. When a rank takes its part of a tensor that is replicated over an axis
   (its slice, or the whole of it for a partial use), the backward **sums**
   the cotangent over the axis: each rank's use saw only its part, and
   every rank needs the whole gradient (:func:`split`; JAX's ``pvary``,
   whose transpose is ``psum``).
2. When split parts are made replicated (a gather, a sum, a broadcast from
   one rank), the backward takes **only this rank's part** of the
   cotangent, unsummed: every rank holds the same full cotangent already
   (:func:`gather`, :func:`combine_sum`; JAX's ``psum`` of a varying value,
   whose transpose is the identity).

Getting either wrong multiplies the gradients by the axis size (JAX's
"4× gradient error", ``tests/test_composed_parallel.py``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)

# bytes of tensor data this process handed to each collective
collective_bytes = {"all_reduce": 0, "broadcast": 0, "ppermute": 0}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int = -1
    model: int = 1
    seq: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        d, m, s = self.data, self.model, self.seq
        if d == -1:
            if n_devices % (m * s) != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by model*seq={m * s}")
            d = n_devices // (m * s)
        if d * m * s != n_devices:
            raise ValueError(
                f"mesh {d}x{m}x{s} != {n_devices} devices")
        return d, m, s


def maybe_initialize_distributed(device=None) -> None:
    """``init_process_group`` from ``torchrun``'s environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``LOCAL_RANK``): nccl for the card, gloo for
    ``device="cpu"``. A no-op without ``WORLD_SIZE`` or when a group
    exists already (JAX keys on ``JAX_COORDINATOR_ADDRESS``)."""
    if not os.environ.get("WORLD_SIZE") or dist.is_initialized():
        return
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the grid. ``shape`` and ``coords`` map each
    axis to its size and to this rank's index on it; ``groups`` to the
    process group of the ranks that differ only on that axis (None without
    ``torch.distributed``). 'data', 'model' and 'seq' are always there (of
    size 1 and no group where the grid lacks them)."""

    shape: dict
    coords: dict
    groups: dict
    device_type: str = "cpu"

    @property
    def distributed(self) -> bool:
        return any(g is not None for g in self.groups.values())

    @property
    def is_main(self) -> bool:
        """Rank 0 writes checkpoints, records and results."""
        return not self.distributed or dist.get_rank() == 0

    def group(self, axis: str):
        return self.groups[axis]

    def device_mesh(self, axis: str = DATA_AXIS):
        """A one-dimensional ``DeviceMesh`` over ``axis`` (FSDP2's)."""
        from torch.distributed.device_mesh import DeviceMesh

        group = self.groups[axis]
        return DeviceMesh.from_group(group, self.device_type,
                                     mesh=dist.get_process_group_ranks(group),
                                     mesh_dim_names=(axis,))

    def row_shard(self, n: int, microbatches: int = 1) -> RowShard:
        """The rows of an ``n``-row global batch this rank takes: its
        span of each of the ``microbatches`` consecutive microbatches.
        One microbatch is JAX's contiguous span."""
        d = self.shape[DATA_AXIS]
        if n % d:
            raise ValueError(
                f"global batch {n} not divisible by data-axis size {d}")
        micro = n // microbatches
        if n % microbatches or micro % d:
            raise ValueError(
                f"global batch {n} not divisible into {microbatches} "
                f"microbatches of a multiple of the data-axis size {d}")
        per, i = micro // d, self.coords[DATA_AXIS]
        spans = tuple((k * micro + i * per, k * micro + (i + 1) * per)
                      for k in range(microbatches))
        return RowShard(n, spans, self.groups[DATA_AXIS] if d > 1 else None)


def _axis_groups(sizes: dict) -> dict:
    """One ``new_group`` per line of the grid along each axis, created in
    the same order on every rank; → this rank's group on each axis."""
    grid = np.arange(int(np.prod(list(sizes.values())))).reshape(
        tuple(sizes.values()))
    me = dist.get_rank()
    mine = {}
    for k, axis in enumerate(sizes):
        lines = np.moveaxis(grid, k, -1).reshape(-1, grid.shape[k])
        for line in lines:
            ranks = [int(r) for r in line]
            group = (dist.group.WORLD if len(ranks) == grid.size
                     else dist.new_group(ranks))
            if me in ranks:
                mine[axis] = group
    return mine


def create_mesh(spec: MeshSpec | dict | None = None, device=None) -> Mesh:
    """The mesh over this job's ranks: JAX's ('data', 'model', 'seq') mesh
    of a ``MeshSpec``, or the grid of an ordered ``{axis: size}`` (e.g.
    ``{"pipe": 2, "data": 2}``), whose sizes multiply to the world size.
    Without ``torch.distributed`` only a mesh of one device can be
    built."""
    spec = MeshSpec() if spec is None else spec
    device_type = torch.device("cuda" if device is None else device).type
    world = dist.get_world_size() if dist.is_initialized() else 1
    try:
        sizes = (dict(zip(AXES, spec.resolve(world)))
                 if isinstance(spec, MeshSpec) else dict(spec))
        if int(np.prod(list(sizes.values()))) != world:
            raise ValueError(f"mesh {sizes} != {world} devices")
    except ValueError as e:
        if dist.is_initialized():
            raise
        raise RuntimeError(
            f"a mesh of more than one device ({spec}) needs one process "
            "per device: launch it with torchrun (torch.distributed). "
            "Running every device from one process is JAX's "
            "single-controller model, not torch's") from e
    if not dist.is_initialized():
        return single_device_mesh(device_type, sizes)
    coords = dict(zip(sizes, (int(c) for c in np.unravel_index(
        dist.get_rank(), tuple(sizes.values())))))
    groups = _axis_groups(sizes)
    return Mesh({**{a: 1 for a in AXES}, **sizes},
                {**{a: 0 for a in AXES}, **coords},
                {**{a: None for a in AXES}, **groups}, device_type)


def single_device_mesh(device=None, axes=()) -> Mesh:
    """A mesh of this process's device alone (every axis of size 1, also
    those of ``axes``): no collectives, also inside a job of several
    ranks."""
    names = (*AXES, *(a for a in axes if a not in AXES))
    return Mesh({a: 1 for a in names}, {a: 0 for a in names},
                {a: None for a in names},
                torch.device("cuda" if device is None else device).type)


# ---------------------------------------------------------------------------
# The batch's rows
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RowShard:
    """The rows of a ``total``-row global batch this rank holds, as
    ``spans`` of [start, stop), in order; ``group`` is the data axis' process
    group (None when the data axis has one device)."""

    total: int
    spans: tuple
    group: object = None

    @property
    def rows(self) -> int:
        return sum(b - a for a, b in self.spans)

    @property
    def ranks(self) -> int:
        """Ranks on the data axis: the global batch over this one."""
        return self.total // self.rows

    @property
    def start(self) -> int:
        """The first row of a one-span shard (the head's Philox offset)."""
        if len(self.spans) != 1:
            raise ValueError(f"rows {self.spans} are not one span")
        return self.spans[0][0]

    def take(self, x, per: int = 1):
        """This rank's rows of ``x``, whose leading axis holds the global
        batch's rows ``per`` entries each (a clip's frames folded in)."""
        if self.spans == ((0, self.total),):
            return x
        parts = [x[a * per:b * per] for a, b in self.spans]
        if len(parts) == 1:
            return parts[0]
        return (torch.cat(parts) if torch.is_tensor(x)
                else np.concatenate(parts))


_ROWS: contextvars.ContextVar = contextvars.ContextVar("rows", default=None)


@contextlib.contextmanager
def batch_rows(shard: RowShard | None):
    """Inside, :func:`current_rows` is ``shard``."""
    token = _ROWS.set(shard)
    try:
        yield shard
    finally:
        _ROWS.reset(token)


def current_rows() -> RowShard | None:
    """The rows of the global batch this rank computes, or None (one
    device: the batch is the global one)."""
    return _ROWS.get()


def draw_rows(draw, n: int, *rest):
    """``draw((rows,) + rest)`` for an ``n``-row local batch: with a shard
    in place, the global batch's draw and this rank's rows of it (``n``
    may fold several entries per row), else ``draw((n,) + rest)``."""
    shard = current_rows()
    if shard is None or shard.rows == shard.total:
        return draw((n,) + tuple(rest))
    per, left = divmod(n, shard.rows)
    if left:
        raise ValueError(f"{n} rows do not fold the rank's {shard.rows}")
    return shard.take(draw((shard.total * per,) + tuple(rest)), per)


def shard_batch(mesh: Mesh, batch: Sequence, microbatches: int = 1):
    """This rank's rows of a global host batch (every rank builds the same
    one); a tuple of arrays in, a tuple out. The rows of a replicated batch
    axis (data=1) are all of them."""
    shard = mesh.row_shard(np.shape(batch[0])[0], microbatches)
    return tuple(shard.take(x) for x in batch)


# ---------------------------------------------------------------------------
# Collectives, as all_reduce and broadcast
# ---------------------------------------------------------------------------

def _count(kind: str, t: torch.Tensor) -> None:
    collective_bytes[kind] += t.numel() * t.element_size()


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM):
    """In place over ``group``; nothing without one."""
    if group is not None:
        _count("all_reduce", t)
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """(size, *t.shape): every rank's ``t`` in group-rank order, as the
    all_reduce of a zero buffer holding ``t`` in this rank's slot."""
    if group is None:
        return t[None]
    buf = t.new_zeros((dist.get_world_size(group),) + tuple(t.shape))
    buf[dist.get_rank(group)] = t
    return all_reduce_(buf, group)


def broadcast_(t: torch.Tensor, src_group_rank: int, group):
    """In place from the group's rank ``src_group_rank``."""
    if group is not None:
        _count("broadcast", t)
        dist.broadcast(t, src=dist.get_global_rank(group, src_group_rank),
                       group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the gradients over it too, so a
    value every rank computes alike (a global mean) sends each rank's
    inputs the gradient of the sum of the ranks' objectives."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group`` (``x`` itself without one)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def ring_shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """``x`` sent to the group rank ``shift`` places up the ring, the one
    ``shift`` places down received: one ``batch_isend_irecv`` holding both,
    so a ring of two does not deadlock. A gloo group moves a CUDA tensor
    through a host copy (gloo has no ``send``/``recv`` for CUDA tensors)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    host = x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO
    send = x.detach().contiguous()
    if host:
        send = send.cpu()
    recv = torch.empty_like(send)
    _count("ppermute", send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (me - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device) if host else recv


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return ring_shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """JAX's ``lax.ppermute`` on a ring: every rank of ``group`` sends ``x``
    to the rank ``shift`` places up and returns what the rank ``shift``
    places down sent. Differentiable: the backward is the reverse shift.
    ``x`` itself without a group or for a shift of a whole turn."""
    if group is None or shift % dist.get_world_size(group) == 0:
        return x
    return _PPermute.apply(x, group, shift)


def _part(x: torch.Tensor, group, dim: int | None) -> torch.Tensor:
    if dim is None:
        return x
    size = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * size, size)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.shape = group, dim, x.shape
        return _part(x, group, dim).clone()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        _part(full, ctx.group, ctx.dim).copy_(g)
        return all_reduce_(full, ctx.group), None, None


def split(x: torch.Tensor, group, dim: int | None = None) -> torch.Tensor:
    """Rule 1: this rank's part of ``x``, replicated over ``group``: its
    equal slice along ``dim``, or the whole of ``x`` (``dim`` None) where
    the rank uses only a part of it (its experts' slots). The backward
    sums the cotangent over the group."""
    if group is None:
        return x
    if dim is not None and x.shape[dim] % dist.get_world_size(group):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {dist.get_world_size(group)} ranks")
    return _Split.apply(x, group, dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(all_gather_stack(x, group).unbind(0), dim)

    @staticmethod
    def backward(ctx, g):
        return _part(g, ctx.group, ctx.dim).contiguous(), None, None


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Rule 2: every rank's equal part along ``dim``, concatenated in group
    rank order (replicated); the backward is this rank's slot."""
    return x if group is None else _Gather.apply(x, group, dim)


class _CombineSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def combine_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Rule 2: the sum of the ranks' partial results (replicated); the
    backward hands each rank the cotangent as it is."""
    return x if group is None else _CombineSum.apply(x, group)
