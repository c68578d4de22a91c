"""JAX variable tree → the port's ``state_dict`` (the reverse of
``surya_tpu/models/full_export.py``'s direction).

The port's module names follow the flax tree, so the mapping is by leaf:

- conv ``kernel`` (H, W, I, O) → ``weight`` (O, I, H, W); a depthwise
  kernel (3, 3, 1, C) becomes the (C, 1, 3, 3) weight of a
  ``groups=C`` conv, and the biases of convs with one (VGG, the
  hierarchical levels, a folded trunk) stay ``bias``
- Dense ``kernel`` (in, out) → ``weight`` (out, in)
- BN ``scale``/``bias`` → ``weight``/``bias``;
  ``batch_stats`` ``mean``/``var`` → ``running_mean``/``running_var``
- ``quadrant_conv_kernel`` stays (3, 3, Cin, Cout) HWIO: the layout the
  quadrant CUDA kernel reads.

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


def from_jax_variables(variables) -> dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` → the port's state_dict."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            a = np.array(value, np.float32)   # a writable copy
            *mods, leaf = path
            if leaf == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                name = "weight"
            else:
                name = _LEAF.get(leaf, leaf)
            out[".".join([*mods, name])] = torch.from_numpy(
                np.ascontiguousarray(a))
    return out


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
