"""Parallelism over the ('data', 'model', 'seq') mesh of ``core/mesh.py``,
mirroring ``surya_tpu/parallel``:

- DP: each rank's rows of the global batch (``core.mesh.shard_batch``),
  BatchNorm statistics merged over 'data', gradients all-reduced
  (``train/steps.py``);
- TP: the tensor-parallel placement rule over 'model' (``sharding.py``);
- ZeRO-1 and FSDP over 'data' (``zero.py``);
- the MoE FFN (``moe.py``), unsharded; expert parallelism, ring attention
  over 'seq' and the pipelined FACT are ROADMAP A11b.
"""

from surya_tpu_torch.parallel.sharding import (  # noqa: F401
    count_sharded,
    partition_params,
)
from surya_tpu_torch.parallel.zero import (  # noqa: F401
    apply_zero1,
    zero1_shardings,
)
