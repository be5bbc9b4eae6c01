"""Attention ops of the port: each hand-written CUDA kernel beside its plain
PyTorch version (K1 in ``attention``, K2 / K2-split in
``decode_attention``; sources under ``adapt_tpu_torch/csrc``)."""
