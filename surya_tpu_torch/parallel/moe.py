"""Mixture-of-Experts FFN with expert parallelism, mirroring
``surya_tpu/parallel/moe.py``.

JAX's design is kept: a router in f32 scores the tokens; each token goes to
its top-k experts with the gate values renormalised over the k; tokens take
per-expert capacity slots in priority order (gate order, then token order)
and the overflow is dropped (its combine weight is 0, so the encoder's
residual carries it); dispatch and combine are (tokens, experts, capacity)
one-hot einsums and the experts three batched matmuls; the Switch
load-balancing term ``E·Σ_e f_e·P_e``, times ``aux_loss_weight``, goes
into the objective (the train step adds every module's ``aux_loss``, as
JAX's step adds every sown ``losses`` entry). The einsums are torch's, as
JAX's are XLA's (no Pallas kernel).

**Under data parallelism** the routing is the global batch's, as in JAX's
one program: the capacity counts every rank's tokens, a rank's slots
start after those the lower ranks' tokens took (their per-expert counts,
gathered), and the aux term's f and P are global means. Each rank then
fills only its own tokens' slots; a token's output depends only on its
slots, so each rank's rows are the single-device ones.

**Expert parallelism** (a ``mesh`` with an 'expert' axis): each rank of
the axis stores and runs only its E/ep experts (``w1``, ``b1``, ``w2``,
``b2`` hold rows [e·E/ep, (e+1)·E/ep) of the single-device leaves), the
memory saving JAX's EP exists for. The tokens are replicated over
'expert' (JAX's dryrun feeds an unsharded batch to its ('expert', 'data')
mesh) and the routing is the global one on every rank; each rank fills
its experts' (E/ep, C, d) slots, and the combine sums the ranks' partial
outputs over 'expert' with the ``all_reduce`` XLA emits for that layout.
The backward follows ``core/mesh.py``'s two rules: the tokens and the
combine weights a rank uses in part are summed over 'expert'
(``split``), the summed output hands each rank its cotangent as it is
(``combine_sum``). No all-to-all arises: that needs tokens split over the
expert axis too, which no JAX layout does. The expert dropout draws the
whole (E, C, ff) mask on every rank and keeps the rank's experts.
:func:`expert_shardings` names the leaves; ``parallel/zero.py`` gathers
them into the single-device checkpoint.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.core.mesh import (
    all_gather_stack,
    all_reduce_sum,
    combine_sum,
    current_rows,
    split,
)

EXPERT_AXIS = "expert"
EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


def top_k_dispatch(probs: torch.Tensor, k: int, capacity: int,
                   offsets: torch.Tensor | None = None):
    """Route each token to its top-k experts with capacity limits.

    probs: (N, E) router probabilities (f32) → (dispatch, combine, aux):
    dispatch (N, E, C) 0/1, combine (N, E, C) gate-weighted, aux the Switch
    load-balance scalar over these tokens. Priority is gate order (k=0
    choices fill slots before k=1), then token order. ``offsets`` (k, E):
    each expert's slots taken before these tokens' choice ``k`` (on a
    data-parallel rank: every token's earlier choices and the lower
    ranks' tokens' choice ``k``)."""
    n, e = probs.shape
    # ties go to the lower index, as jax.lax.top_k's do
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    gate_idx = order[:, :k]
    gate_vals = probs.gather(1, gate_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    counts = torch.zeros((e,), dtype=torch.int64, device=probs.device)
    dispatch = probs.new_zeros((n, e, capacity))
    combine = probs.new_zeros((n, e, capacity))
    for kk in range(k):
        oh = F.one_hot(gate_idx[:, kk], e)
        base = counts if offsets is None else offsets[kk]
        pos = torch.cumsum(oh, 0) - 1 + base[None, :]
        counts = counts + oh.sum(0)
        within = ((pos < capacity) & (oh > 0)).to(probs.dtype)
        d_k = F.one_hot(pos.clamp(0, capacity - 1), capacity).to(
            probs.dtype) * within[..., None]
        dispatch = dispatch + d_k
        combine = combine + d_k * gate_vals[:, kk][:, None, None]

    top1 = F.one_hot(gate_idx[:, 0], e).to(probs.dtype)
    aux = e * torch.sum(top1.mean(0) * probs.mean(0))
    return dispatch, combine, aux


def _lecun_normal_3d(w: torch.Tensor, generator=None) -> None:
    """flax ``lecun_normal`` of an (E, in, out) kernel: fan_in = in · E
    (flax counts the leading axis as receptive field)."""
    from surya_tpu_torch.models.backbones.resnet import lecun_normal_

    lecun_normal_(w, w.shape[0] * w.shape[1], generator)


class MoEFFN(nn.Module):
    """Drop-in MoE replacement for a d→ff→d ReLU FFN; the leaves are JAX's
    (``router`` (d, E) f32, ``w1`` (E, d, ff), ``b1`` (E, ff), ``w2`` (E, ff,
    d), ``b2`` (E, d)), so ``from_jax_variables`` carries them over as they
    are. After a train-mode forward ``aux_loss`` holds the weighted Switch
    term (the train step takes it). With a ``mesh`` of several ranks that
    has an 'expert' axis, the expert leaves hold this rank's E/ep experts
    (module docstring)."""

    def __init__(self, dim: int, num_experts: int = 4, ff_dim: int = 3072,
                 top_k: int = 2, capacity_factor: float = 2.0,
                 aux_loss_weight: float = 0.01, dropout: float = 0.0,
                 dtype=torch.bfloat16, mesh=None):
        super().__init__()
        if top_k > num_experts:
            raise ValueError(f"top_k={top_k} > num_experts={num_experts}")
        e = num_experts
        self.expert_group, ep, rank = None, 1, 0
        if mesh is not None and mesh.distributed and EXPERT_AXIS in mesh.shape:
            ep = mesh.shape[EXPERT_AXIS]
            if e % ep:
                raise ValueError(f"num_experts={e} not divisible by mesh "
                                 f"axis {EXPERT_AXIS!r}={ep}")
            self.expert_group, rank = (mesh.group(EXPERT_AXIS),
                                       mesh.coords[EXPERT_AXIS])
        local = e // ep
        self.experts = slice(rank * local, (rank + 1) * local)
        self.router = nn.Parameter(torch.zeros(dim, e))
        self.w1 = nn.Parameter(torch.zeros(local, dim, ff_dim))
        self.b1 = nn.Parameter(torch.zeros(local, ff_dim))
        self.w2 = nn.Parameter(torch.zeros(local, ff_dim, dim))
        self.b2 = nn.Parameter(torch.zeros(local, dim))
        self.num_experts, self.top_k = e, top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight, self.dropout, self.dtype = (
            aux_loss_weight, dropout, dtype)
        self.aux_loss = None

    def sharded_leaves(self) -> dict:
        """{leaf: (dim, group)} of the expert-parallel leaves (none
        unsharded): what ``parallel/zero.py`` gathers and the clip sums."""
        if self.expert_group is None:
            return {}
        return {leaf: (0, self.expert_group) for leaf in EXPERT_LEAVES}

    def reset_parameters(self, generator=None):
        """flax's init of the single-device leaves (an expert-parallel rank
        draws them whole and keeps its experts, so every layout starts from
        the same weights)."""
        with torch.no_grad():
            self.router.normal_(0.0, 0.02, generator=generator)
            for w in (self.w1, self.w2):
                full = w.new_empty((self.num_experts,) + tuple(w.shape[1:]))
                _lecun_normal_3d(full, generator)
                w.copy_(full[self.experts])
            self.b1.zero_()
            self.b2.zero_()

    def _routing(self, probs: torch.Tensor):
        """(capacity, per-rank slot offsets, global f·P aux) for this rank's
        probs; the single-device ones without a data-parallel shard."""
        n, e, k = probs.shape[0], self.num_experts, self.top_k
        rows = current_rows()
        if rows is None or rows.group is None:
            return math.ceil(k * n / e * self.capacity_factor), None, None
        total = n * rows.ranks
        order = torch.sort(probs.detach(), dim=-1, descending=True,
                           stable=True).indices[:, :k]
        counts = F.one_hot(order, e).sum(0).float()          # (k, E)
        every = all_gather_stack(counts, rows.group)          # (ranks, k, E)
        me = torch.distributed.get_rank(rows.group)
        before = every[:me].sum(0)                            # lower ranks
        earlier_k = torch.cumsum(every.sum(0), 0) - every.sum(0)
        offsets = (before + earlier_k).long()
        f = every[:, 0].sum(0) / total                        # top-1 share
        p = all_reduce_sum(probs.sum(0), rows.group) / total
        return (math.ceil(k * total / e * self.capacity_factor), offsets,
                e * torch.sum(f * p))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        b, t, d = x.shape
        tokens = x.reshape(b * t, d)
        probs = torch.softmax(tokens.float() @ self.router.float(), dim=-1)
        capacity, offsets, global_aux = self._routing(probs)
        dispatch, combine, aux = top_k_dispatch(probs, self.top_k, capacity,
                                                offsets)
        if global_aux is not None:
            aux = global_aux
        if self.training:
            self.aux_loss = aux * self.aux_loss_weight

        cd, group, mine = self.dtype, self.expert_group, self.experts
        if group is not None:   # this rank's experts (module docstring)
            dispatch, combine = dispatch[:, mine], split(combine, group)[
                :, mine]
            tokens = split(tokens, group)
        xin = torch.einsum("nec,nd->ecd", dispatch.to(cd), tokens.to(cd))
        h = torch.einsum("ecd,edf->ecf", xin, self.w1.to(cd))
        h = torch.relu(h + self.b1.to(cd)[:, None])
        if self.dropout and self.training:
            from surya_tpu_torch.models.common import dropout_generator

            # the mask is over expert slots, not batch rows: every rank
            # draws the whole (E, C, ff) mask, as the single device does,
            # and keeps its experts' part
            g = dropout_generator(generator, self.dropout, True)
            keep = torch.rand((self.num_experts,) + tuple(h.shape[1:]),
                              generator=g, device=h.device)[mine]
            h = torch.where(keep >= self.dropout, h / (1.0 - self.dropout),
                            torch.zeros_like(h))
        out_e = torch.einsum("ecf,efd->ecd", h, self.w2.to(cd))
        out_e = out_e + self.b2.to(cd)[:, None]
        out = torch.einsum("nec,ecd->nd", combine.to(cd), out_e)
        return combine_sum(out, group).reshape(b, t, d)


def expert_shardings(model: nn.Module, mesh) -> dict:
    """{parameter name: spec} placing the MoE expert leaves (``w1``, ``b1``,
    ``w2``, ``b2`` under a ``moe`` module) over 'expert' as
    ``("expert",)``, everything else replicated ``()``, as JAX's
    ``expert_shardings`` places them (a 2-layer FACT-MoE has 8)."""
    out = {}
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        expert = (leaf in EXPERT_LEAVES and owner.split(".")[-1] == "moe"
                  and mesh.shape.get(EXPERT_AXIS, 1) > 1)
        out[name] = (EXPERT_AXIS,) if expert else ()
    return out
