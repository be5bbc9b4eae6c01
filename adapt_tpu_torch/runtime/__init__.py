"""Serving runtime of the port: the continuous batcher (``continuous``,
``paged`` with the host KV tier, ``scheduler``, ``capacity``), the
disaggregated prefill tier (``disagg``), fault-tolerant pipelined decode
(``decode_pipeline``) and the partitioned pipelines (``pipeline``)."""
