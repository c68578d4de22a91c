"""Parallelism over the meshes of ``core/mesh.py``, mirroring
``surya_tpu/parallel``:

- DP: each rank's rows of the global batch (``core.mesh.shard_batch``),
  BatchNorm statistics merged over 'data', gradients all-reduced
  (``train/steps.py``);
- TP: the tensor-parallel placement rule over 'model' (``sharding.py``);
- ZeRO-1 and FSDP over 'data' (``zero.py``);
- the MoE FFN with expert parallelism over 'expert' (``moe.py``);
- ring attention over 'seq' (``ring_attention.py``);
- the GPipe schedule over 'pipe' (``pipeline.py``; FACT's
  ``fact_apply_pipelined``).
"""

from surya_tpu_torch.parallel.moe import expert_shardings  # noqa: F401
from surya_tpu_torch.parallel.pipeline import (  # noqa: F401
    gather_stages,
    keep_stage_layers,
    pipeline_apply,
    stage_range,
)
from surya_tpu_torch.parallel.ring_attention import (  # noqa: F401
    full_attention_reference,
    make_attention_fn,
    ring_attention,
    shard_qkv,
)
from surya_tpu_torch.parallel.sharding import (  # noqa: F401
    count_sharded,
    partition_params,
)
from surya_tpu_torch.parallel.zero import (  # noqa: F401
    apply_zero1,
    zero1_shardings,
)
