"""Deterministic random streams, mirroring ``surya_tpu/core/prng.py``.

JAX folds ``(step, name)`` into one root key. Here each ``(seed, step,
name)`` gives a fresh ``torch.Generator`` whose seed is a stateless
function of the three: FNV-1a of the name (the JAX hash) and a fixed
64-bit mix. A run resumed at step ``s`` therefore draws the same streams
as one that never stopped. Nothing draws from torch's global generator.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


class PRNG:
    """A seed dispenser: stateless given (seed, step, name)."""

    def __init__(self, seed: int):
        self.seed = int(seed) & _MASK64

    def seed_of(self, step: int, name: str) -> int:
        """The 64-bit seed of stream ``name`` at ``step``."""
        h = _mix64(self.seed ^ _mix64(int(step) & _MASK64))
        return _mix64(h ^ _stable_hash(name))

    def named(self, step: int, name: str, device="cpu") -> torch.Generator:
        """A generator on ``device`` seeded by :meth:`seed_of`."""
        g = torch.Generator(device=device)
        g.manual_seed(self.seed_of(step, name))
        return g


def _stable_hash(name: str) -> int:
    # Python's hash() is salted per process; use a stable FNV-1a instead.
    h = 2166136261
    for b in name.encode():
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


def _mix64(x: int) -> int:
    """SplitMix64's finaliser: a bijection of 64-bit integers."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)
