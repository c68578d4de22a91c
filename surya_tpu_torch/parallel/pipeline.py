"""Pipeline parallelism: the GPipe schedule over a mesh axis, mirroring
``surya_tpu/parallel/pipeline.py``.

JAX stacks the L layers' parameters, shards the stack over 'pipe' and runs
``M + S − 1`` ticks of a ``lax.scan`` inside ``shard_map``; ``jax.grad``
of the scan gives the reverse pipeline. torch runs one process per stage,
so each of the S stages holds only its own L/S layers (the single-device
names kept: :func:`keep_stage_layers`, :func:`gather_stages`) and the
schedule is an autograd function with both directions written out:

- **forward**, ticks t = 0 … M+S−2: stage 0 takes microbatch t; stage s
  applies its layers to microbatch t − s when there is one (a bubble tick
  computes nothing) and hands its activation to stage s+1 with the ring
  shift of ``core.mesh.ppermute``; stage S−1's outputs at ticks
  S−1 … S+M−2 are the M microbatches, broadcast to every stage
  (replicated over 'pipe');
- **backward**, the ticks in reverse: each stage takes its output's
  cotangent from stage s+1 (the reverse shift), back-propagates its
  tick's saved graph and sends its input's cotangent to stage s−1.

Every rank issues the same shifts in the same order, whatever its stage,
so the ring never waits on a shift that one rank skipped. The two
gradient rules (``core/mesh.py``): the input is replicated over 'pipe' and
only stage 0 uses it, so its cotangent is summed over 'pipe'; the output
is made replicated from stage S−1, so stage S−1 takes the replicated
cotangent once, not S times.

The bubble is (S−1)/(M+S−1) of the ticks. Activations of every tick are
kept for the backward (GPipe's stashing).
"""

from __future__ import annotations

import torch

from surya_tpu_torch.core.mesh import all_reduce_, broadcast_, ring_shift

PIPE = "pipe"


def stage_range(num_layers: int, mesh) -> range:
    """The global indices of this stage's layers (L/S consecutive ones)."""
    s = mesh.shape.get(PIPE, 1)
    if num_layers % s:
        raise ValueError(f"{num_layers} layers not divisible by {s} stages")
    per = num_layers // s
    stage = mesh.coords.get(PIPE, 0)
    return range(stage * per, (stage + 1) * per)


def keep_stage_layers(model: torch.nn.Module, prefix: str, num_layers: int,
                      mesh) -> range:
    """Delete from ``model``, in place, the layers ``{prefix}{i}`` that other
    stages hold → this stage's indices. The kept layers keep their
    single-device names, so :func:`gather_stages` of the stages' state is
    the one-device ``state_dict`` (JAX's ``stack_layer_params`` view)."""
    mine = stage_range(num_layers, mesh)
    for i in range(num_layers):
        if i not in mine:
            delattr(model, f"{prefix}{i}")
    return mine


def gather_stages(state: dict, prefix: str, num_layers: int, mesh) -> dict:
    """A ``{name: tensor}`` of one stage (its layers ``{prefix}{i}.*``,
    everything else replicated) → the same with every stage's layers, each
    broadcast from its stage. The layers are alike, so this stage's own
    tensors give the shapes of the others'."""
    mine = stage_range(num_layers, mesh)
    s = mesh.shape.get(PIPE, 1)
    if s == 1:
        return dict(state)
    group = mesh.group(PIPE)
    out = {k: v for k, v in state.items() if not k.startswith(prefix)}
    per = len(mine)
    for stage in range(s):
        for k in range(per):
            here = f"{prefix}{mine[k]}."
            there = f"{prefix}{stage * per + k}."
            for name in sorted(n for n in state if n.startswith(here)):
                t = (state[name].detach().clone() if stage == mine[0] // per
                     else torch.empty_like(state[name]))
                out[there + name[len(here):]] = broadcast_(t, stage, group)
    return out


def _schedule(x, stage_fn, group, s, stage, m, graphs):
    """The forward ticks. With ``graphs`` (a dict), each computing tick's
    detached input, which requires grad, and output are kept there."""
    mbs = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
    ticks = m + s - 1
    outs, recv = [], None
    for t in range(ticks):
        j = t - stage
        if 0 <= j < m:
            inp = mbs[j] if stage == 0 else recv
            if graphs is not None:
                inp = inp.detach().requires_grad_()
                with torch.enable_grad():
                    out = stage_fn(inp, j)
                graphs[t] = (inp, out)
            else:
                out = stage_fn(inp, j)
            if out.shape != inp.shape or out.dtype != inp.dtype:
                raise ValueError(
                    f"a pipelined layer must keep its input's shape and "
                    f"dtype: {tuple(inp.shape)} {inp.dtype} → "
                    f"{tuple(out.shape)} {out.dtype}")
            send = out.detach()
            if stage == s - 1:
                outs.append(send)
        else:   # a bubble: nothing to compute, the shift still runs
            send = torch.zeros_like(mbs[0])
        if t < ticks - 1 and s > 1:
            recv = ring_shift(send, group, 1)
    full = (torch.cat(outs) if stage == s - 1 else torch.zeros_like(x))
    return broadcast_(full, s - 1, group) if s > 1 else full


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, stage_fn, sched, *params):
        group, s, stage, m = sched
        ctx.sched, ctx.params = sched, params
        ctx.graphs, ctx.x_shape = {}, x.shape
        return _schedule(x, stage_fn, group, s, stage, m, ctx.graphs)

    @staticmethod
    def backward(ctx, g):
        group, s, stage, m = ctx.sched
        params, graphs = ctx.params, ctx.graphs
        micro = ctx.x_shape[0] // m
        g_params = [None] * len(params)
        g_x = g.new_zeros(ctx.x_shape)
        g_in = None   # the cotangent of the input this stage took a tick later
        for t in reversed(range(m + s - 1)):
            if t < m + s - 2 and s > 1:
                g_out = ring_shift(g_in if g_in is not None else
                                   g.new_zeros((micro,) + tuple(g.shape[1:])),
                                   group, -1)
            else:
                g_out = g.new_zeros((micro,) + tuple(g.shape[1:]))
            j = t - stage
            if stage == s - 1 and 0 <= j < m:   # rule 2: this stage's copy
                g_out = g_out + g[j * micro:(j + 1) * micro]
            g_in = None
            if t in graphs:
                inp, out = graphs.pop(t)
                grads = torch.autograd.grad(out, (inp, *params), g_out,
                                            allow_unused=True)
                for i, gp in enumerate(grads[1:]):
                    if gp is not None:
                        g_params[i] = gp if g_params[i] is None else \
                            g_params[i] + gp
                if stage == 0:
                    g_x[j * micro:(j + 1) * micro] = grads[0]
                else:
                    g_in = grads[0]
        if s > 1 and ctx.needs_input_grad[0]:   # rule 1: summed over 'pipe'
            all_reduce_(g_x, group)
        return (g_x if ctx.needs_input_grad[0] else None, None, None,
                *g_params)


def pipeline_apply(stage_fn, params, x: torch.Tensor, mesh, *,
                   num_microbatches: int | None = None) -> torch.Tensor:
    """Run ``x`` (B, ...), replicated over 'pipe', through the GPipe
    schedule → the (B, ...) output, replicated. ``stage_fn(act, j)``
    applies this stage's layers to microbatch ``j`` (keeping its shape and
    dtype); ``params`` are the tensors it reads that need gradients (this
    stage's parameters). B must divide by ``num_microbatches`` (default S).
    A batch split over 'data' is the caller's: ``x`` is this rank's rows
    (``fact_apply_pipelined(batch_spec=)``)."""
    s = mesh.shape.get(PIPE, 1) if mesh is not None else 1
    stage = mesh.coords.get(PIPE, 0) if mesh is not None else 0
    group = mesh.group(PIPE) if s > 1 else None
    m = num_microbatches or s
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"microbatches {m}")
    params = [p for p in params if p.requires_grad]
    if torch.is_grad_enabled() and (x.requires_grad or params):
        return _GPipe.apply(x, stage_fn, (group, s, stage, m), *params)
    return _schedule(x, stage_fn, group, s, stage, m, None)
