"""Hand-written CUDA kernels for Hopper (sources in ``surya_tpu_torch/csrc``).

- ``quadrant``    — replaces ``ops/pallas/quadrant.py::_quadrant_kernel``
- ``fusion_head`` — replaces ``ops/pallas/fusion_head.py::_fusion_head_kernel``

Each wrapper launches its kernel for a CUDA tensor, runs its plain PyTorch
version for a CPU tensor, and counts its kernel launches in ``launches``.
``_build`` compiles the sources with nvcc at first use.
"""

KERNELS = ("quadrant", "fusion_head")  # csrc/<name>.cu
