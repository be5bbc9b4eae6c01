"""Models of the port: the decoder LM (``transformer_lm``, ``speculative``)
and the ViT (``vit``)."""
