"""Serving runtime of the port: the continuous batcher (``continuous``,
``paged``, ``scheduler``) and the partitioned pipelines (``pipeline``)."""
