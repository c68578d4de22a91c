"""JAX variable tree → the port's ``state_dict`` (the reverse of
``surya_tpu/models/full_export.py``'s direction).

The port's module names follow the flax tree, so the mapping is by leaf:

- conv ``kernel`` (H, W, I, O) → ``weight`` (O, I, H, W), and a 3-D conv
  ``kernel`` (D, H, W, I, O) → ``weight`` (O, I, D, H, W); a depthwise
  kernel (3, 3, 1, C) becomes the (C, 1, 3, 3) weight of a
  ``groups=C`` conv, and the biases of convs with one (VGG, the
  hierarchical levels, a folded trunk) stay ``bias``
- Dense ``kernel`` (in, out) → ``weight`` (out, in)
- BN ``scale``/``bias`` → ``weight``/``bias``;
  ``batch_stats`` ``mean``/``var`` → ``running_mean``/``running_var``
- ``quadrant_conv_kernel`` stays (3, 3, Cin, Cout) HWIO: the layout the
  quadrant CUDA kernel reads.
- an LSTM layer ``OptimizedLSTMCell_{k}`` (per-gate ``i{g}`` kernels and
  ``h{g}`` kernels with biases, g in i, f, g, o) → its ``weight_ih``
  (4H, D), ``weight_hh`` (4H, H) and ``bias`` (4H), the gates stacked in
  that order (``models/temporal/recurrent.py``).
- flax ``MultiHeadDotProductAttention`` leaves (modules ``query``, ``key``,
  ``value``, ``out``): the per-head kernels (d, heads, d/heads) and
  (heads, d/heads, d) → the (d, d) ``weight`` of an ``nn.Linear``, the
  biases (heads, d/heads) → (d,) (``models/backbones/vit.py``).
- bare parameters (``cls_token``, ``pos_embed``, ``token_type_embed``)
  and LayerNorm ``scale``/``bias`` → the same name / ``weight``/``bias``.
- the pose net (``models/pose/landmark_net.py``): GroupNorm ``scale``/
  ``bias`` → ``weight``/``bias``, its bias-free convs, the 1×1 ``heatmap``
  conv with its bias, ``head_dense`` and ``head_out``, by the same rules;
  :func:`to_jax_params` maps such a params-only state_dict back.
- the generative tier: U²-Net and ``TinyDenoiser`` take the flax names
  (U²-Net's are the canonical torch ones); the zero123plus UNet and the
  VAE take diffusers' names, which JAX flattened (``down_blocks_0_resnets_0``,
  ``to_out_0``, ``net_0_proj``): ``unet_cond.diffusers_state_dict``
  puts the dots back in the names this module gives.

Inputs are numpy arrays (or anything ``np.asarray`` takes), so nothing of
JAX is needed: :func:`load_npz_variables` rebuilds the tree from an
``.npz`` whose keys are ``/``-joined paths, as written by
``flax.traverse_util.flatten_dict(variables, sep="/")``.
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


_TO_OUT_IN = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_ATTENTION = ("query", "key", "value", "out")
_GATES = "ifgo"


def _lstm_cell(prefix: str, cell: dict, out: dict) -> None:
    """One flax ``OptimizedLSTMCell``'s per-gate leaves → the stacked
    ``weight_ih``/``weight_hh``/``bias`` of the port's ``LSTMCell``."""
    def stack(kind, leaf):   # kernels (in, H) → (H, in); .T keeps a bias
        return np.concatenate([np.asarray(cell[f"{kind}{g}"][leaf],
                                          np.float32).T for g in _GATES])

    for name, kind, leaf in (("weight_ih", "i", "kernel"),
                             ("weight_hh", "h", "kernel"),
                             ("bias", "h", "bias")):
        out[f"{prefix}.{name}"] = torch.from_numpy(
            np.ascontiguousarray(stack(kind, leaf)))


def output_axis(name: str, ndim: int) -> int:
    """The axis of the port's parameter ``name`` that holds its flax
    leaf's last (output) axis, by this module's mapping: a ``kernel``
    becomes a ``weight`` through ``_TO_OUT_IN``, which moves that axis
    first, as does the LSTM gates' stacking; every other leaf
    (``quadrant_conv_kernel`` in HWIO, bare parameters, the MoE experts'
    ``w1``/``w2``) keeps JAX's layout, so its last axis."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and ndim in _TO_OUT_IN:
        return _TO_OUT_IN[ndim].index(ndim - 1)
    if leaf in ("weight_ih", "weight_hh"):
        return 0
    return ndim - 1


def from_jax_variables(variables) -> dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` → the port's state_dict."""
    out = {}
    for collection in ("params", "batch_stats"):
        cells = {}
        for path, value in _flatten(variables.get(collection, {})):
            *mods, leaf = path
            cell = next((i for i, m in enumerate(mods)
                         if m.startswith("OptimizedLSTMCell_")), None)
            if cell is not None:   # gathered whole, stacked below
                node = cells.setdefault(tuple(mods[:cell + 1]), {})
                node.setdefault(mods[cell + 1], {})[leaf] = value
                continue
            a = np.array(value, np.float32)   # a writable copy
            if mods and mods[-1] in _ATTENTION:   # heads folded into d
                a = (a.reshape(-1) if leaf != "kernel" else
                     a.reshape(-1, a.shape[-1]) if mods[-1] == "out" else
                     a.reshape(a.shape[0], -1))
            if leaf == "kernel":
                a = a.transpose(_TO_OUT_IN[a.ndim])
                name = "weight"
            else:
                name = _LEAF.get(leaf, leaf)
            out[".".join([*mods, name])] = torch.from_numpy(
                np.ascontiguousarray(a))
        for mods, cell in cells.items():
            _lstm_cell(".".join(mods), cell, out)
    return out


def to_jax_params(state_dict) -> dict:
    """The inverse of :func:`from_jax_variables` for a params-only tree of
    convs, dense layers and norms (no running statistics): a 4-D
    ``weight`` → conv ``kernel`` (H, W, I, O), a 2-D one → Dense ``kernel``
    (in, out), a 1-D one → norm ``scale``; ``bias`` stays. → a nested dict
    of f32 numpy arrays."""
    tree: dict = {}
    for key, value in state_dict.items():
        *mods, leaf = key.split(".")
        a = value.detach().float().cpu().numpy()
        if leaf == "weight":
            leaf = "kernel" if a.ndim > 1 else "scale"
            a = a.transpose({4: (2, 3, 1, 0), 2: (1, 0), 1: (0,)}[a.ndim])
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree


def load_npz_variables(path: str) -> dict:
    """Rebuild the nested variable tree from a ``/``-keyed ``.npz``."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree
