"""Hand-written CUDA kernels for Hopper (sources in ``surya_tpu_torch/csrc``).

- ``quadrant``    — replaces ``ops/pallas/quadrant.py::_quadrant_kernel``
- ``fusion_head`` — replaces ``ops/pallas/fusion_head.py::_fusion_head_kernel``
- ``stem_bn``     — replaces ``ops/pallas/stem_bn.py::_stats_kernel`` and
  ``::_affine_relu_kernel``

The first two have an inference and a training form; the training form
runs under a ``torch.autograd.Function`` whose backward mirrors the JAX
custom VJP (library convolutions and matrix products, as XLA's there).

Each wrapper launches its kernel for a CUDA tensor, runs its plain PyTorch
version for a CPU tensor, and counts its kernel launches in ``launches``
(``quadrant`` and ``fusion_head`` also count those of the training form
in ``training_launches``).
``_build`` compiles the sources with nvcc at first use.
"""

KERNELS = ("quadrant", "fusion_head", "stem_bn")  # csrc/<name>.cu
