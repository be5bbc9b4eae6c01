"""Models of the port: the decoder LM (``transformer_lm``, ``speculative``),
the ViT (``vit``) and the CNN zoo (``layers``, ``resnet``,
``efficientnet``)."""
