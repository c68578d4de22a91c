"""Mixture-of-Experts FFN, mirroring ``surya_tpu/parallel/moe.py`` without
its expert sharding.

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

Expert parallelism (an 'expert' mesh axis > 1) is ROADMAP A11b.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.core.mesh import (
    all_gather_stack,
    all_reduce_sum,
    current_rows,
)


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
    term (the train step takes it)."""

    def __init__(self, dim: int, num_experts: int = 4, ff_dim: int = 3072,
                 top_k: int = 2, capacity_factor: float = 2.0,
                 aux_loss_weight: float = 0.01, dropout: float = 0.0,
                 dtype=torch.bfloat16):
        super().__init__()
        if top_k > num_experts:
            raise ValueError(f"top_k={top_k} > num_experts={num_experts}")
        e = num_experts
        self.router = nn.Parameter(torch.zeros(dim, e))
        self.w1 = nn.Parameter(torch.zeros(e, dim, ff_dim))
        self.b1 = nn.Parameter(torch.zeros(e, ff_dim))
        self.w2 = nn.Parameter(torch.zeros(e, ff_dim, dim))
        self.b2 = nn.Parameter(torch.zeros(e, dim))
        self.num_experts, self.top_k = e, top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight, self.dropout, self.dtype = (
            aux_loss_weight, dropout, dtype)
        self.aux_loss = None

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.router.normal_(0.0, 0.02, generator=generator)
            _lecun_normal_3d(self.w1, generator)
            _lecun_normal_3d(self.w2, generator)
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

        cd = self.dtype
        xin = torch.einsum("nec,nd->ecd", dispatch.to(cd), tokens.to(cd))
        h = torch.einsum("ecd,edf->ecf", xin, self.w1.to(cd))
        h = torch.relu(h + self.b1.to(cd)[:, None])
        if self.dropout and self.training:
            from surya_tpu_torch.models.common import flax_dropout

            # the mask is over expert slots, not batch rows: every rank
            # draws the whole (E, C, ff) mask, as the single device does
            h = flax_dropout(h, self.dropout, generator, True,
                             shape=h.shape)
        out_e = torch.einsum("ecf,efd->ecd", h, self.w2.to(cd))
        out_e = out_e + self.b2.to(cd)[:, None]
        out = torch.einsum("nec,ecd->nd", combine.to(cd), out_e)
        return out.reshape(b, t, d)
