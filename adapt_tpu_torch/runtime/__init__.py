"""Serving runtime of the port: the continuous batcher (``continuous``,
``paged`` with the host KV tier, ``scheduler``, ``capacity``), the
disaggregated prefill tier (``disagg``), the fleet router and autoscaler
over several replicas (``router``), fault-tolerant pipelined decode
(``decode_pipeline``) and the partitioned pipelines (``pipeline``)."""
