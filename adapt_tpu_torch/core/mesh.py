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

Since the entries of such a mesh all name one card, a device cannot tell
its shards apart. Each entry therefore carries a member id, its flat
position in the mesh it was first built as (:class:`MeshMember`):
``control.registry.DeviceHealthMonitor`` keys a shard by it, and
:meth:`Mesh.survivors` builds the shrunk mesh of an elastic recovery with
the survivors keeping their ids.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import NamedTuple

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


class MeshMember(NamedTuple):
    """One entry of a :class:`Mesh`: its stable member ``id`` and its
    ``device``. ``id`` plays the part of a ``jax.Device``'s id (a health
    monitor's key, a reshard plan's accounting), so that shards sharing a
    card stay distinct."""

    id: int
    device: torch.device

    @property
    def platform(self) -> str:
        return self.device.type


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices arranged by a :class:`MeshSpec`: ``devices`` is an object
    array of ``torch.device`` shaped by the spec, ``axis_names`` the axes
    in order and ``shape`` an ordered name -> size mapping (``dict(
    mesh.shape)`` reads as in JAX). Entries may repeat: shards that share a
    card. ``ids`` (same shape) are the entries' member ids, by default
    their flat positions."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    ids: np.ndarray | None = None

    def __post_init__(self):
        if self.ids is None:
            object.__setattr__(self, "ids", np.arange(
                self.devices.size).reshape(self.devices.shape))

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

    def members(self, axis: str | None = None) -> list[MeshMember]:
        """Every entry as a :class:`MeshMember`, in flat order, or only
        those at :meth:`axis_positions` of ``axis``."""
        flat = list(zip(self.ids.flat, self.devices.flat))
        pos = range(len(flat)) if axis is None else self.axis_positions(axis)
        return [MeshMember(int(flat[k][0]), flat[k][1]) for k in pos]

    def along(self, axis: str) -> "Mesh":
        """The one-axis mesh of :meth:`axis_devices`, member ids kept."""
        return _one_axis(self.members(axis), axis)

    def survivors(self, axis: str, dead_ids, size: int | None = None
                  ) -> "Mesh":
        """The one-axis mesh of the members along ``axis`` whose ids are
        not in ``dead_ids``, in the old axis order, the first ``size`` of
        them (all by default), each keeping its member id: the shrunk mesh
        of an elastic recovery."""
        dead = {int(i) for i in dead_ids}
        alive = [m for m in self.members(axis) if m.id not in dead]
        if size is not None:
            if not 1 <= size <= len(alive):
                raise ValueError(f"{len(alive)} surviving members cannot "
                                 f"make a mesh of {size}")
            alive = alive[:size]
        if not alive:
            raise ValueError(f"no member of the {axis!r} axis survives")
        return _one_axis(alive, axis)


def _one_axis(members: list[MeshMember], axis: str) -> Mesh:
    devs = np.empty(len(members), dtype=object)
    devs[:] = [m.device for m in members]
    return Mesh(devs, (axis,), np.asarray([m.id for m in members]))


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
