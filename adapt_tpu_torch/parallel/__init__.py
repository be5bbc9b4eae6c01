"""Pipeline schedule (``pipeline_spmd``), training step (``train``),
tensor-parallel sharding over a mesh of shards driven by one process, with
the reshard plan of elastic recovery (``sharding``), and expert placement
(``expert``) of the port."""

from adapt_tpu_torch.parallel.expert import (
    expert_shardings,
    expert_utilization,
    place_experts,
)
from adapt_tpu_torch.parallel.pipeline_spmd import (
    spmd_pipeline,
    stack_stage_params,
)
from adapt_tpu_torch.parallel.sharding import (
    batch_sharding,
    lm_tp_rules,
    merge_specs,
    replicate,
    shard_batch,
    tree_shardings,
    vit_tp_rules,
)

__all__ = [
    "batch_sharding",
    "expert_shardings",
    "expert_utilization",
    "lm_tp_rules",
    "merge_specs",
    "place_experts",
    "replicate",
    "shard_batch",
    "spmd_pipeline",
    "stack_stage_params",
    "tree_shardings",
    "vit_tp_rules",
]
