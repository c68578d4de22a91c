"""Device dispatch for the port's hand-written kernels.

Counterpart of ``surya_tpu/ops/pallas/__init__.py::on_tpu``. There the
backend picks Pallas kernel or lax path; here the tensor's device picks:
a CUDA tensor goes to the hand-written kernel (``ops/cuda``), a CPU tensor
to the kernel's plain PyTorch version. Entry points resolve their device
with :func:`resolve_device`, so nothing runs silently on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raise if a CUDA device is asked for and
    there is none; the CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def on_cuda(t: torch.Tensor) -> bool:
    """Single owner of the kernel-vs-plain dispatch rule: True for a CUDA
    tensor (launch the kernel), False for a CPU tensor (plain version)."""
    if t.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"no kernel or plain path for device {t.device}")
    return t.device.type == "cuda"
