"""The msgpack that ``flax.serialization`` writes, through the ``msgpack``
package and without flax, so the port reads and writes the JAX package's
pose artifacts.

flax packs numpy arrays as extension type 1 and numpy scalars as type 3,
each a packed ``(shape, dtype name, C-order bytes)``, with strict types
and each dict's keys sorted (it maps the tree with ``jax.tree_util``,
which sorts them). Arrays come back as read-only views of the input bytes,
as ``np.frombuffer`` gives them; copy before writing to one.
"""

from __future__ import annotations

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3


def _array_from(payload: bytes) -> np.ndarray:
    import msgpack

    shape, dtype, buf = msgpack.unpackb(payload, raw=True)
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)


def _ext_hook(code: int, payload: bytes):
    if code == EXT_NDARRAY:
        return _array_from(payload)
    if code == EXT_NPSCALAR:
        return _array_from(payload)[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


def _array_payload(a: np.ndarray) -> bytes:
    import msgpack

    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError(f"cannot serialise an array of dtype {a.dtype}")
    return msgpack.packb((a.shape, a.dtype.name, a.tobytes("C")))


def _default(v):
    import msgpack

    if isinstance(v, np.ndarray):
        return msgpack.ExtType(EXT_NDARRAY, _array_payload(v))
    if isinstance(v, np.generic):
        return msgpack.ExtType(EXT_NPSCALAR, _array_payload(np.asarray(v)))
    raise TypeError(f"cannot serialise {type(v).__name__} to msgpack")


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_sorted(x) for x in tree]
    return tree


def unpackb(data: bytes):
    """msgpack bytes → Python tree (dict, list, str, bytes, int, float,
    bool, None, numpy arrays and scalars)."""
    import msgpack

    return msgpack.unpackb(data, ext_hook=_ext_hook, raw=False)


def packb(tree) -> bytes:
    """Python tree → the bytes ``flax.serialization.msgpack_serialize``
    writes for it."""
    import msgpack

    return msgpack.packb(_sorted(tree), default=_default, strict_types=True)
