"""Pipeline schedule (``pipeline_spmd``), training step (``train``) and the
head-axis tiling of KV tensors (``sharding.head_tiles``) of the port, on
one rank."""
