"""Attention ops of the port: each hand-written CUDA kernel beside its plain
PyTorch version (K1 and its backward K7 in ``attention``, K2 / K2-split in
``decode_attention``, K3 / K3-split and K4 in ``paged_attention``, each
with its int8 / int4 branch; KV quantization in ``quantize``; sources
under ``adapt_tpu_torch/csrc``)."""
