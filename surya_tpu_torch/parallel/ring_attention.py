"""Ring attention: sequence (context) parallelism over the 'seq' mesh axis,
mirroring ``surya_tpu/parallel/ring_attention.py``.

Each rank of the 'seq' axis takes its T/n slice of Q, K and V (the tensors
are replicated over the axis: every rank projected the whole sequence) and
attends to every K/V block as the blocks rotate around the ring
(``core.mesh.ppermute``), with a flash-style online softmax in f32; the
output slices are gathered back to (B, T, H, D). The two gradient rules of
``core/mesh.py`` make the backward the single-device one: the slices'
cotangents are summed over the axis, the gathered output hands each rank
its own slot.

JAX's numerics and semantics are kept; they are not flax's plain
attention:

- q, k and v are cast to f32, the logits scaled by 1/√D in f32, and the
  softmax runs online in f32 (m from −inf, l, acc); the output is cast back
  to q's dtype. (The plain path of ``models/backbones/vit.py`` divides q by
  √D and runs its softmax in the compute dtype: in bf16 the two differ.)
- T need not divide the axis: q, k and v are padded, the pad keys get the
  finite ``NEG`` (not −inf, which keeps the backward NaN-free) and the pad
  query rows are sliced away.
- an additive ``bias`` and a boolean ``mask`` (True = attend, made a NEG
  bias), both broadcastable to (B, H, T, T): the rows go with Q; at ring
  step s the columns of the K/V block from rank (idx − s) mod n are taken.
- attention dropout on the un-normalised p, inverted scaling, with the
  denominator l summed undropped (flax's dropout on the normalised
  weights). The mask of each (row block, column block) is a pure function
  of one draw from the caller's generator and the two block indices (JAX's
  ``fold_in(fold_in(rng, idx), src)``): :func:`block_keep`. It is shared
  over batch and heads when ``broadcast_dropout``.
- an axis of size 1 runs the same loop.

Layout (B, T, H, D). Bidirectional (encoder) attention unless a mask says
otherwise, as FACT's fusion encoder.
"""

from __future__ import annotations

import torch

from surya_tpu_torch.core.mesh import SEQ_AXIS, gather, ppermute, split
from surya_tpu_torch.core.prng import fold_in

NEG = -1e9   # a finite "-inf": keeps the gradients NaN-free


def dropout_seed(generator: torch.Generator) -> int:
    """The one draw a ring-attention call takes from the caller's stream."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))


def block_keep(seed: int, row_block: int, col_block: int, shape,
               rate: float, device) -> torch.Tensor:
    """The keep mask of one (row block, column block) of the scores: a
    function of ``seed`` and the two indices only, so every rank draws the
    same mask for the same block."""
    g = fold_in(seed, row_block, col_block, device=device)
    return torch.rand(shape, generator=g, device=device) >= rate


def _ring_local(q, kv, bias, group, n, idx, scale, rate, seed, broadcast):
    """This rank's (B, tq, H, D) block of the output: its q against every
    K/V block as ``kv`` (2, B, tk, H, D) rotates around the ring."""
    qf = q.float()
    b, tq, h, d = qf.shape
    tk = kv.shape[2]
    m = qf.new_full((b, h, tq), float("-inf"))   # running max
    l = qf.new_zeros((b, h, tq))                 # running denominator
    acc = qf.new_zeros((b, h, tq, d))
    for step in range(n):
        src = (idx - step) % n
        kf, vf = kv[0].float(), kv[1].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        if bias is not None:
            s = s + bias[..., src * tk:(src + 1) * tk]
        # the output does not depend on m: no gradient flows through it
        m_new = torch.maximum(m, s.detach().amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)                          # undropped
        if rate > 0.0:
            shape = (1, 1, tq, tk) if broadcast else (b, h, tq, tk)
            keep = block_keep(seed, idx, src, shape, rate, q.device)
            p = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vf)
        m = m_new
        if step < n - 1:   # the block the next step reads
            kv = ppermute(kv, group, 1)
    out = acc / l[..., None]
    return out.transpose(1, 2).to(q.dtype)                # (B, tq, H, D)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   seq_axis: str = SEQ_AXIS, bias: torch.Tensor | None = None,
                   mask: torch.Tensor | None = None,
                   dropout_rate: float = 0.0,
                   generator: torch.Generator | None = None,
                   broadcast_dropout: bool = True) -> torch.Tensor:
    """(B, T, H, D) q, k, v, replicated over ``seq_axis`` of ``mesh`` →
    the (B, T, H, D) attention output, replicated; each rank computes its
    T-slice. ``bias`` additive and ``mask`` boolean (True = attend), both
    broadcastable to (B, H, T, T); ``dropout_rate`` > 0 draws one seed from
    ``generator`` (module docstring)."""
    group = mesh.group(seq_axis)
    n = mesh.shape[seq_axis]
    idx = mesh.coords[seq_axis]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    b, t, h, d = q.shape
    pad = (-t) % n
    if dropout_rate > 0.0 and generator is None:
        raise ValueError("dropout_rate > 0 requires a generator")
    seed = dropout_seed(generator) if dropout_rate > 0.0 else 0

    if mask is not None:
        mbias = torch.where(mask, 0.0, NEG).float()
        bias = mbias if bias is None else bias + mbias
    if pad and bias is None:
        bias = q.new_zeros((1, 1, t, t), dtype=torch.float32)
    if bias is not None:
        bias = bias.float()
        bias = bias.reshape((1,) * (4 - bias.dim()) + tuple(bias.shape))
        bias = bias.expand(bias.shape[0], bias.shape[1], t, t)
        # pad rows (pad queries, sliced away) with 0; pad columns (pad
        # keys) with NEG, so no real query attends to them
        bias = torch.nn.functional.pad(bias, (0, pad, 0, pad))
        if pad:
            cols = torch.arange(t + pad, device=bias.device) >= t
            bias = torch.where(cols, NEG, bias)
        bias = split(bias, group, 2)
    qkv = torch.stack([q, k, v])
    if pad:
        qkv = torch.nn.functional.pad(qkv, (0, 0, 0, 0, 0, pad))
    qkv = split(qkv, group, 2)
    out = _ring_local(qkv[0], qkv[1:], bias, group, n, idx, scale,
                      dropout_rate, seed, broadcast_dropout)
    out = gather(out, group, 1)
    return out[:, :t] if pad else out


def shard_qkv(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's T-slice of a (B, T, H, D) tensor replicated over
    'seq' (T padded to a multiple of the axis); its backward sums
    the cotangent over the axis."""
    pad = (-x.shape[1]) % mesh.shape[SEQ_AXIS]
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    return split(x, mesh.group(SEQ_AXIS), 1)


def make_attention_fn(mesh):
    """The ``attention_fn`` of ``MultiHeadDotProductAttention``: ring
    attention over the mesh's seq axis, so a model's attention becomes
    sequence-parallel with its parameters unchanged (``FactModel(cp_mesh=)``).
    In eval mode the dropout rate is 0."""

    def attention_fn(query, key, value, dropout_rate=0.0, generator=None,
                     training=False):
        return ring_attention(query, key, value, mesh,
                              dropout_rate=dropout_rate if training else 0.0,
                              generator=generator)

    return attention_fn


def full_attention_reference(q, k, v, bias=None, mask=None):
    """The unsharded oracle: plain softmax attention in f32."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, NEG)
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return out.transpose(1, 2).to(q.dtype)
