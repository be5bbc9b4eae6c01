"""adapt_tpu_torch: the PyTorch / CUDA port of ``adapt_tpu`` for one NVIDIA
H100 (Hopper, sm_90a).

The port keeps the JAX package's module paths and public names where that
helps a reader find a counterpart; inside it is PyTorch idiom. Every TPU
kernel on a ported path is a hand-written CUDA kernel under ``csrc/``,
launched on CUDA tensors; on CPU tensors each wrapper runs the kernel's
plain PyTorch version instead. Entry points run on the card unless the
caller passes ``device="cpu"``: with no card and no explicit CPU request
they raise, and they never quietly fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card and
    raises when there is none; anything else is taken as asked, and a CUDA
    request without a card raises too."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: adapt_tpu_torch runs on the GPU; pass "
                "device='cpu' to run the plain versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is absent")
    return dev
