"""Pipeline schedule (``pipeline_spmd``) and training step (``train``) of the
port, on one rank."""
