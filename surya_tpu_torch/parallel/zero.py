"""ZeRO-1 and FSDP over the 'data' axis, and the sharded state's full form,
mirroring ``surya_tpu/parallel/zero.py``.

JAX annotates the state's placement and lets GSPMD derive the
collectives; it splits each leaf's first axis that divides by the data
size (:func:`_leaf_spec`). torch has both forms as libraries, with their
own layouts; the update is the single-device one either way:

- **ZeRO-1** (``train.zero1``): ``ZeroRedundancyOptimizer`` over the
  port's ``AdamW(eps=1e-8)``. Each data rank owns whole parameters' Adam
  moments and updates those, then broadcasts them. The gradients it reads
  are the step's all-reduced ones.
- **FSDP** (``train.fsdp``, which supersedes ``zero1``): FSDP2's
  ``fully_shard`` over the data axis, each top-level child and the root.
  Parameters, gradients and moments are sharded on dim 0; the forward and
  backward gather the parameters, the backward reduce-scatters the
  gradients.

Either form composes with the tensor-parallel slices of
``parallel/sharding.py``. A checkpoint is always the single-device form
(:func:`full_snapshot`: the unsharded model's ``state_dict`` and its
``AdamW.state_dict``), so it loads into a one-device ``TrainState`` and a
``Predictor``; :func:`load_full_snapshot` puts one back into a sharded
state. The gathers are ``all_reduce``/``broadcast`` (``core/mesh.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn

from surya_tpu_torch.core.mesh import (
    DATA_AXIS,
    all_reduce_,
    broadcast_,
)
from surya_tpu_torch.parallel.sharding import canonical_name, partition_params


def _leaf_spec(shape: tuple, n: int) -> tuple:
    """JAX's ZeRO rule: split the first axis divisible by n over 'data'
    (a PartitionSpec as a tuple), else replicate (``()``)."""
    for d, size in enumerate(shape):
        if size >= n and size % n == 0:
            return (None,) * d + ("data",)
    return ()


def zero1_shardings(tree: dict, mesh) -> dict:
    """JAX's spec of each leaf of a {name: tensor} tree over the mesh's data
    axis (for reports: torch's ZeRO-1 gives each rank whole parameters'
    moments, not a slice of each)."""
    n = mesh.shape[DATA_AXIS]
    return {k: _leaf_spec(tuple(getattr(v, "shape", ())), n)
            for k, v in tree.items()}


def apply_zero1(state, mesh):
    """A one-device ``TrainState`` (``create_train_state`` without a mesh)
    with its AdamW replaced, in place, by ``ZeroRedundancyOptimizer`` over
    the mesh's data axis, its moments carried over (each rank keeps those
    it owns) → ``(state, zero1_shardings of the parameters)``. Build the
    step after it: ``make_train_step(model, state.optimizer, cfg, mesh)``."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    full = state.optimizer.state_dict()
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    by_id = {id(p): n for n, p in state.model.named_parameters()}
    state.mesh, state.param_names = mesh, tuple(by_id[id(p)] for p in params)
    state.optimizer = ZeroRedundancyOptimizer(
        params, optimizer_class=torch.optim.AdamW,
        process_group=mesh.group(DATA_AXIS),
        **{k: _hyper(state.optimizer)[k]
           for k in ("lr", "betas", "eps", "weight_decay")})
    load_full_optimizer_state(state, full)
    return state, zero1_shardings(dict(state.model.named_parameters()), mesh)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _dim0_span(n: int, parts: int, index: int) -> tuple[int, int]:
    """FSDP2's dim-0 chunk of rank ``index`` (``torch.chunk``'s sizes)."""
    chunk = -(-n // parts)
    start = min(index * chunk, n)
    return start, min(start + chunk, n)


def _full_data(t: torch.Tensor) -> torch.Tensor:
    """A DTensor sharded on dim 0 over the data axis → the full tensor
    (an all_reduce of a zero buffer holding this rank's chunk)."""
    if not _is_dtensor(t):
        return t.detach()
    group = t.device_mesh.get_group()
    local = t.to_local().detach()
    full = local.new_zeros(t.shape)
    start, stop = _dim0_span(t.shape[0], t.device_mesh.size(),
                             t.device_mesh.get_local_rank())
    full[start:stop] = local
    return all_reduce_(full, group)


def _full_model(t: torch.Tensor, where) -> torch.Tensor:
    """A slice split over a group (``where`` = (dim, group): a TP slice over
    'model', an expert-parallel leaf over 'expert') → the full tensor."""
    if where is None:
        return t
    axis, group = where
    parts, index = dist.get_world_size(group), dist.get_rank(group)
    size = t.shape[axis]
    shape = list(t.shape)
    shape[axis] = size * parts
    full = t.new_zeros(shape)
    full.narrow(axis, index * size, size).copy_(t)
    return all_reduce_(full, group)


def _local_of(full: torch.Tensor, like: torch.Tensor, where) -> torch.Tensor:
    """This rank's part of a full tensor shaped like ``like`` (a TP or
    expert slice, then FSDP's dim-0 chunk)."""
    if where is not None:
        axis, group = where
        size = full.shape[axis] // dist.get_world_size(group)
        full = full.narrow(axis, dist.get_rank(group) * size, size)
    if _is_dtensor(like):
        start, stop = _dim0_span(like.shape[0], like.device_mesh.size(),
                                 like.device_mesh.get_local_rank())
        full = full[start:stop]
    return full


def _copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    local = dst.to_local() if _is_dtensor(dst) else dst
    with torch.no_grad():
        local.copy_(src.to(local.device, local.dtype))


def _sharded_axes(model: nn.Module) -> dict[str, tuple]:
    """Canonical name → (dim, group) of every leaf split over a group: the
    tensor-parallel slices and the expert-parallel leaves."""
    out = {}
    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        for leaf, plist in getattr(module, "parametrizations", {}).items():
            if getattr(plist[0], "axis", None) is not None:
                out[prefix + leaf] = (plist[0].axis, plist[0].group)
        if hasattr(module, "sharded_leaves"):
            out.update({prefix + leaf: where for leaf, where in
                        module.sharded_leaves().items()})
    return out


def parallelize(model: nn.Module, cfg, mesh, names: list[str]):
    """Shard ``model`` (on its device, ``requires_grad`` set by the freeze
    mask) over ``mesh`` in place: the TP rule over 'model', then FSDP2
    over 'data' when ``cfg.train.fsdp``. → the optimizer over the trainable
    parameters in the order of ``names`` (their single-device order):
    ``ZeroRedundancyOptimizer`` when ``cfg.train.zero1`` (and not fsdp),
    else ``AdamW``."""
    trainable = {n: p.requires_grad for n, p in model.named_parameters()}
    partition_params(model, mesh)
    for n, p in model.named_parameters():
        p.requires_grad_(trainable[canonical_name(n)])
    if cfg.train.fsdp:
        from torch.distributed.fsdp import fully_shard

        with torch.no_grad():   # FSDP2 shards contiguous parameters only
            for p in model.parameters():
                p.data = p.data.contiguous()
        dm = mesh.device_mesh(DATA_AXIS)
        for child in model.children():   # each layer with a forward
            if not isinstance(child, (nn.ModuleDict, nn.ModuleList)) and any(
                    True for _ in child.parameters()):
                fully_shard(child, mesh=dm)
        fully_shard(model, mesh=dm)
    by_name = {canonical_name(n): p for n, p in model.named_parameters()}
    params = [by_name[n] for n in names]
    kw = dict(lr=cfg.train.lr, betas=(0.9, 0.999), eps=1e-8,
              weight_decay=cfg.train.weight_decay)
    if cfg.train.zero1 and not cfg.train.fsdp:
        from torch.distributed.optim import ZeroRedundancyOptimizer

        return ZeroRedundancyOptimizer(
            params, optimizer_class=torch.optim.AdamW,
            process_group=mesh.group(DATA_AXIS), **kw)
    return torch.optim.AdamW(params, **kw)


def _hyper(optimizer) -> dict:
    group = optimizer.param_groups[0]
    return {k: v for k, v in group.items() if k != "params"}


def _owner_state(optimizer, p):
    """(data rank owning ``p``'s moments, its state or None here)."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    if isinstance(optimizer, ZeroRedundancyOptimizer):
        owner = optimizer._param_to_rank[p]
        return owner, optimizer.optim.state.get(p)
    return None, optimizer.state.get(p)


def full_optimizer_state(state) -> dict:
    """The sharded optimizer's state as the single-device ``AdamW.
    state_dict()`` (moments gathered; ZeRO's broadcast from each owner)."""
    mesh, where = state.mesh, _sharded_axes(state.model)
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    out = {}
    for i, (name, p) in enumerate(zip(state.param_names, params)):
        owner, st = _owner_state(state.optimizer, p)
        if owner is not None:   # ZeRO: the owner has it, the others learn it
            local = p.to_local() if _is_dtensor(p) else p
            has = torch.tensor([float(st is not None)], device=local.device)
            broadcast_(has, owner, mesh.group(DATA_AXIS))
            if not has.item():
                continue
            st = st or {"step": torch.zeros(()),
                        "exp_avg": torch.zeros_like(local),
                        "exp_avg_sq": torch.zeros_like(local)}
            st = {k: broadcast_(v.detach().clone().to(local.device), owner,
                                mesh.group(DATA_AXIS)).to(v.device)
                  for k, v in st.items()}
        if st is None:
            continue
        out[i] = {k: (v.detach().clone() if k == "step" else
                      _full_model(_full_data(v), where.get(name)))
                  for k, v in st.items()}
    return {"state": out,
            "param_groups": [{**_hyper(state.optimizer),
                              "params": list(range(len(params)))}]}


def full_model_state(model: nn.Module, mesh) -> dict:
    """The unsharded model's ``state_dict``: TP slices, expert-parallel
    leaves and FSDP shards gathered, parametrized names back to the plain
    ones."""
    where = _sharded_axes(model)
    out = {}
    for name, t in model.state_dict().items():
        cname = canonical_name(name)
        out[cname] = _full_model(_full_data(t), where.get(cname))
    return out


def full_gradients(model: nn.Module) -> dict:
    """Canonical name → the full gradient of every parameter that has one
    (TP slices and expert-parallel leaves gathered)."""
    where = _sharded_axes(model)
    return {canonical_name(n): _full_model(p.grad, where.get(
        canonical_name(n))) for n, p in model.named_parameters()
        if p.grad is not None}


def load_full_model_state(model: nn.Module, full: dict, mesh) -> None:
    """Copy a single-device ``state_dict`` into a sharded ``model``."""
    where = _sharded_axes(model)
    own = model.state_dict()
    names = {canonical_name(n) for n in own}
    if names != set(full):
        raise KeyError(f"state_dict keys differ: missing "
                       f"{sorted(names - set(full))[:5]}, unexpected "
                       f"{sorted(set(full) - names)[:5]}")
    for name, t in own.items():
        cname = canonical_name(name)
        _copy_into(t, _local_of(full[cname], t, where.get(cname)))


def load_full_optimizer_state(state, full: dict) -> None:
    """Put a single-device ``AdamW.state_dict()`` into the sharded
    optimizer (each rank its part; ZeRO: the owners)."""
    mesh, where = state.mesh, _sharded_axes(state.model)
    opt = state.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    for group in opt.param_groups:
        group.update({k: v for k, v in full["param_groups"][0].items()
                      if k != "params"})
    for i, (name, p) in enumerate(zip(state.param_names, params)):
        st = full["state"].get(i, full["state"].get(str(i)))
        if st is None:
            continue
        owner, _ = _owner_state(opt, p)
        target = opt if owner is None else opt.optim
        if owner is not None and owner != mesh.coords[DATA_AXIS]:
            continue
        local = {}
        for k, v in st.items():
            if k == "step":
                local[k] = v.clone()
                continue
            part = _local_of(v, p, where.get(name)).to(
                p.device, p.dtype if not _is_dtensor(p) else
                p.to_local().dtype)
            if _is_dtensor(p):
                from torch.distributed.tensor import DTensor

                part = DTensor.from_local(part.contiguous(), p.device_mesh,
                                          p.placements, shape=p.shape,
                                          stride=p.stride())
            local[k] = part
        target.state[p] = local


def full_snapshot(state) -> dict:
    """:func:`core.checkpoint.snapshot` of a sharded state: every rank
    takes part in the gathers; the result is the single-device form."""
    from surya_tpu_torch.core.checkpoint import _cpu

    return {"model": _cpu(full_model_state(state.model, state.mesh)),
            "optimizer": _cpu(full_optimizer_state(state)),
            "step": int(state.step),
            "generator": state.generator.get_state()}


def load_full_snapshot(state, snap: dict) -> None:
    """:func:`core.checkpoint.load_snapshot` into a sharded state."""
    load_full_model_state(state.model, snap["model"], state.mesh)
    load_full_optimizer_state(state, snap["optimizer"])
    state.step = int(snap["step"])
    state.generator.set_state(snap["generator"])


def sharded_param_groups(model: nn.Module) -> dict[int, object]:
    """``id`` → group of every parameter split over a group (a TP slice over
    'model', an expert-parallel leaf over 'expert')."""
    where = _sharded_axes(model)
    return {id(p): where[canonical_name(n)][1]
            for n, p in model.named_parameters()
            if canonical_name(n) in where}


def global_grad_sq_norm(params, sharded: dict[int, object],
                        mesh) -> torch.Tensor:
    """The squared global norm of the parameters' gradients on a sharded
    state: each rank's sums of squares, FSDP shards added over 'data' and
    each split leaf's over its group (``sharded``: ``id`` → group, from
    :func:`sharded_param_groups`); replicated leaves counted once."""
    parts = {}
    fsdp = False
    for p in params:
        g = p.grad
        if g is None:
            continue
        if _is_dtensor(g):
            fsdp, g = True, g.to_local()
        parts.setdefault(sharded.get(id(p)), []).append(g)
    dev = params[0].device if not _is_dtensor(params[0]) else \
        params[0].to_local().device
    groups = [None, *(k for k in parts if k is not None)]
    sums = torch.stack([
        torch.stack(torch._foreach_norm(parts[k])).float().pow(2).sum()
        if parts.get(k) else torch.zeros((), device=dev) for k in groups])
    if fsdp:
        all_reduce_(sums, mesh.group(DATA_AXIS))
    total = sums[0]
    for i, group in enumerate(groups[1:], 1):
        total = total + all_reduce_(sums[i:i + 1].clone(), group)[0]
    return total
