"""Pipeline schedule over the ranks of a mesh (``pipeline_spmd``), pipelined
KV-cache generation over them (``pipeline_decode``), training step over a
dp x pp mesh (``train``),
tensor-parallel sharding over a mesh of shards driven by one process, with
the reshard plan of elastic recovery (``sharding``), expert placement
(``expert``), and sequence parallelism over a ring of ranks driven by one
process: ring attention, Ulysses and the sp-sharded prefill
(``ring_attention``, ``ulysses``, ``sp_prefill``) of the port."""

from adapt_tpu_torch.parallel.expert import (
    expert_shardings,
    expert_utilization,
    place_experts,
)
from adapt_tpu_torch.parallel.pipeline_decode import (
    pipelined_generate,
    shard_for_pipeline,
)
from adapt_tpu_torch.parallel.pipeline_spmd import (
    spmd_pipeline,
    stack_stage_params,
)
from adapt_tpu_torch.parallel.ring_attention import (
    ring_attention,
    stripe_sequence,
    unstripe_sequence,
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
from adapt_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "batch_sharding",
    "expert_shardings",
    "expert_utilization",
    "lm_tp_rules",
    "merge_specs",
    "pipelined_generate",
    "place_experts",
    "replicate",
    "ring_attention",
    "shard_batch",
    "shard_for_pipeline",
    "spmd_pipeline",
    "stack_stage_params",
    "stripe_sequence",
    "tree_shardings",
    "ulysses_attention",
    "unstripe_sequence",
    "vit_tp_rules",
]
