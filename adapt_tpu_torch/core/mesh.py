"""Device lists for pipeline stages and named meshes for tensor-parallel
shards.

Counterpart of ``adapt_tpu/core/mesh.py``. The device pool is a list of
``torch.device``; stage -> device binding is late (the control plane
decides at run time which device hosts which stage), so the helpers here
are small and stateless. :func:`build_mesh` arranges devices into a named
:class:`Mesh`; a device may appear more than once, so a tp mesh of four
shards on one card is ``build_mesh(MeshSpec((("tp", 4),)), ["cuda:0"] *
4)`` (or ``devices=None``). One process drives every shard of a mesh
(``parallel/sharding``): nothing here starts a process group.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np
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


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices arranged by a :class:`MeshSpec`: ``devices`` is an object
    array of ``torch.device`` shaped by the spec, ``axis_names`` the axes
    in order and ``shape`` an ordered name -> size mapping (``dict(
    mesh.shape)`` reads as in JAX). Entries may repeat: shards that share a
    card."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> collections.OrderedDict:
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    def axis_positions(self, axis: str) -> list[int]:
        """Flat (row-major) positions along ``axis`` at index 0 of every
        other axis: the shard order of a split over ``axis``."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no {axis!r} axis (axes: "
                             f"{self.axis_names})")
        i = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for j in range(self.devices.shape[i]):
            idx[i] = j
            out.append(int(np.ravel_multi_index(idx, self.devices.shape)))
        return out

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices at :meth:`axis_positions`."""
        flat = list(self.devices.flat)
        return [flat[k] for k in self.axis_positions(axis)]

    def along(self, axis: str) -> "Mesh":
        """The one-axis mesh of :meth:`axis_devices`."""
        arr = np.empty(self.shape[axis], dtype=object)
        arr[:] = self.axis_devices(axis)
        return Mesh(arr, (axis,))


def build_mesh(spec: MeshSpec, devices=None) -> Mesh:
    """A :class:`Mesh` from the first ``spec.num_devices`` of ``devices``
    (each resolved as :func:`device_list` resolves it). ``None`` is the
    CUDA card at every position, raising without one; the CPU only when
    asked for."""
    n = spec.num_devices
    if devices is None:
        devs = [resolve_device(None)] * n
    else:
        devs = device_list(devices)
    if len(devs) < n:
        raise ValueError(
            f"mesh {spec} needs {n} devices, only {len(devs)} given")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devs[:n]):
        arr[i] = d
    return Mesh(arr.reshape(spec.shape), spec.axis_names)


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
