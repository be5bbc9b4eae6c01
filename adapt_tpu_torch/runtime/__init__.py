"""Serving runtime of the port: the continuous batcher (``continuous``,
``paged`` with the host KV tier, ``scheduler``, ``capacity``), the
disaggregated prefill tier (``disagg``), the fleet router and autoscaler
over several replicas (``router``), fault-tolerant pipelined decode
(``decode_pipeline``) and the partitioned pipelines (``pipeline``)."""

from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
from adapt_tpu_torch.runtime.decode_pipeline import PipelinedDecoder
from adapt_tpu_torch.runtime.disagg import DisaggServer, PrefillWorker
from adapt_tpu_torch.runtime.paged import Pager
from adapt_tpu_torch.runtime.pipeline import LocalPipeline, ServingPipeline
from adapt_tpu_torch.runtime.scheduler import (
    AdmissionQueue,
    DegradationController,
    QueueFullError,
)

__all__ = [
    "AdmissionQueue",
    "ContinuousBatcher",
    "DegradationController",
    "DisaggServer",
    "LocalPipeline",
    "Pager",
    "PipelinedDecoder",
    "PrefillWorker",
    "QueueFullError",
    "ServingPipeline",
]
