"""Parallelism of the port over the ranks of a ``torch.distributed`` job
(counterpart of ``byteps_tpu/parallel``): the mesh of named axes, the
partitioner's logical-axis rules, Megatron tensor parallelism over tp,
ring attention over sp, GPipe pipelining over pp, the MoE FFN with its
experts over ep, ZeRO-3 FSDP over the slice_ or dp axis, and remat."""

from byteps_tpu_torch.parallel.mesh import (  # noqa: F401
    Axis,
    Mesh,
    MeshAxes,
    factor_devices,
    make_mesh,
)
from byteps_tpu_torch.parallel.moe import (  # noqa: F401
    moe_ffn,
    moe_init,
    moe_logical_specs,
    moe_specs,
    top1_dispatch,
    topk_dispatch,
)
from byteps_tpu_torch.parallel.partitioner import (  # noqa: F401
    FAMILY_RULES,
    LOGICAL_AXES,
    Partitioner,
    resolve_spec,
    resolve_specs,
    rules_from_axes,
    stacked_logical_specs,
)
from byteps_tpu_torch.parallel.pipeline import (  # noqa: F401
    last_stage_value,
    pipeline_apply,
    stack_blocks,
    stacked_specs,
)
from byteps_tpu_torch.parallel.ring_attention import (  # noqa: F401
    plain_attention,
    ring_attention,
    zigzag_inverse,
    zigzag_local_positions,
    zigzag_permutation,
    zigzag_ring_attention,
)
from byteps_tpu_torch.parallel.sharding import opt_state_specs  # noqa: F401
from byteps_tpu_torch.parallel.zero3 import (  # noqa: F401
    make_gpt_zero3_train_step,
    zero3_gather_params,
)
from byteps_tpu_torch.parallel.tp import (  # noqa: F401
    col_parallel_matmul,
    copy_to_tp,
    maybe_psum,
    pmean,
    row_parallel_matmul,
)
