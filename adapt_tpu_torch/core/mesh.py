"""Device lists for pipeline stages.

Counterpart of ``adapt_tpu/core/mesh.py``. The device pool is a list of
``torch.device``; stage -> device binding is late (the control plane
decides at run time which device hosts which stage), so the helpers here
are small and stateless. ``build_mesh`` (a named multi-axis mesh over
several cards) waits for the multi-GPU slice, which ports
``parallel/sharding.py`` over ``torch.distributed``.
"""

from __future__ import annotations

import dataclasses
import math
import torch

from adapt_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A named logical mesh shape, e.g. (dp=2, pp=4) over 8 devices."""

    axes: tuple[tuple[str, int], ...]

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(size for _, size in self.axes)

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)


def device_list(devices=None) -> list[torch.device]:
    """``devices`` as a list of ``torch.device``: None is the CUDA card
    (raising without one), a single device or name is a list of one, and
    each entry of a list is taken as asked (a CUDA entry without a card
    raises)."""
    if devices is None or isinstance(devices, (str, torch.device)):
        return [resolve_device(devices)]
    return [resolve_device(d) for d in devices]


def stage_devices(num_stages: int, devices=None) -> list[torch.device]:
    """Round-robin device assignment for pipeline stages (the initial
    binding; the control plane may rebind later on failure)."""
    devices = device_list(devices)
    if not devices:
        raise RuntimeError("no devices")
    return [devices[i % len(devices)] for i in range(num_stages)]
