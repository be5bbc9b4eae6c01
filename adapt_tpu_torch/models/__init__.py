"""Models of the port: the decoder LM (``transformer_lm``, ``speculative``),
the ViT (``vit``) and the CNN zoo (``layers``, ``resnet``,
``efficientnet``).

:data:`MODEL_REGISTRY` names the image models a remote worker rebuilds by
name (``comm.remote``), with the JAX package's names and canonical input
shapes (HWC). Each factory takes ``num_classes``, ``dtype``, ``device``
and ``seed``."""

from adapt_tpu_torch.models.efficientnet import efficientnet_b0, efficientnet_b4
from adapt_tpu_torch.models.resnet import resnet50, resnet101, resnet152
from adapt_tpu_torch.models.vit import vit_b16, vit_tiny

#: name -> (graph factory, canonical input shape HWC).
MODEL_REGISTRY = {
    "resnet50": (resnet50, (224, 224, 3)),
    "resnet101": (resnet101, (224, 224, 3)),
    "resnet152": (resnet152, (224, 224, 3)),
    "efficientnet_b0": (efficientnet_b0, (224, 224, 3)),
    "efficientnet_b4": (efficientnet_b4, (380, 380, 3)),
    "vit_b16": (vit_b16, (224, 224, 3)),
    "vit_tiny": (vit_tiny, (32, 32, 3)),
}

__all__ = ["MODEL_REGISTRY", "resnet50", "resnet101", "resnet152",
           "efficientnet_b0", "efficientnet_b4", "vit_b16", "vit_tiny"]
