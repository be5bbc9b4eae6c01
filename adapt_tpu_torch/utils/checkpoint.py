"""Checkpoints: one weights snapshot with a metadata sidecar, and
step-numbered train state with retention and resume.

Counterpart of ``adapt_tpu/utils/checkpoint.py``, saved with
``torch.save`` / ``torch.load(weights_only=True)`` (no orbax).

``save_variables(path, variables, metadata)`` writes a tree of tensors
(a ``state_dict``, or the per-stage ``{node: state dict}`` of a plan) to
``path/variables.pt`` with every tensor on the host, and ``metadata``
(model name, partition cuts, step: anything JSON takes) to
``path/adapt_meta.json``, the JAX package's sidecar name.
``restore_variables(path)`` gives both back, the tensors on the CPU:
placement is the caller's (a pipeline's stages, a dispatcher's workers),
so a snapshot restores onto any device list.

``TrainCheckpointer`` writes one file ``step_<n>.pt`` per step
under the directory, holding ``{"params", "opt_state"}`` with every tensor
on the host, and only the newest ``max_to_keep`` steps kept. Restores are
host-first, as in the JAX package: ``restore`` loads the saved parameters
into the caller's (``load_state_dict``, which copies onto their device)
and hands the optimizer state back as saved, for the train step to load.
Nothing stays open between calls; ``close()`` (and leaving a ``with``
block) ends the checkpointer's use, as the JAX package's closes its
manager: a later call raises.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")
_META_NAME = "adapt_meta.json"
_VARIABLES_NAME = "variables.pt"


def _to_host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _state(obj: Any) -> Any:
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def _replace(path: str, write) -> None:
    """Write ``path`` through a temporary file and an atomic rename."""
    tmp = f"{path}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, path)


def save_variables(path: str | os.PathLike, variables: Any,
                   metadata: dict | None = None) -> None:
    """Write one tree of tensors (+ JSON metadata sidecar) under the
    directory ``path``."""
    path = os.path.abspath(os.fspath(path))
    os.makedirs(path, exist_ok=True)
    _replace(os.path.join(path, _VARIABLES_NAME),
             lambda tmp: torch.save(_to_host(variables), tmp))
    if metadata is not None:
        def dump(tmp):
            with open(tmp, "w") as f:
                json.dump(metadata, f)
        _replace(os.path.join(path, _META_NAME), dump)


def restore_variables(path: str | os.PathLike) -> tuple[Any, dict]:
    """``(variables, metadata)`` saved under ``path``, the tensors on the
    CPU (``{}`` when no metadata was saved)."""
    path = os.path.abspath(os.fspath(path))
    variables = torch.load(os.path.join(path, _VARIABLES_NAME),
                           map_location="cpu", weights_only=True)
    metadata: dict = {}
    meta_path = os.path.join(path, _META_NAME)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)
    return variables, metadata


class TrainCheckpointer:
    """Step-numbered train-state checkpoints with retention + resume."""

    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self._dir = os.path.abspath(os.fspath(directory))
        self._keep = max_to_keep
        self._closed = False
        os.makedirs(self._dir, exist_ok=True)

    def _open_dir(self) -> str:
        if self._closed:
            raise ValueError(f"checkpointer of {self._dir} is closed")
        return self._dir

    def _path(self, step: int) -> str:
        return os.path.join(self._open_dir(), f"step_{step}.pt")

    def steps(self) -> list[int]:
        """The saved steps, oldest first."""
        found = (_NAME.match(n) for n in os.listdir(self._open_dir()))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, params: Any, opt_state: Any) -> None:
        """Write step ``step`` (params: a module-like object with a
        ``state_dict``, or a tree of tensors) atomically, then drop all but
        the newest ``max_to_keep`` steps."""
        _replace(self._path(step), lambda tmp: torch.save(
            {"params": _to_host(_state(params)),
             "opt_state": _to_host(opt_state)}, tmp))
        for old in self.steps()[:-self._keep]:
            os.remove(self._path(old))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, params: Any, step: int | None = None
                ) -> tuple[Any, Any, int]:
        """``(params, opt_state, step)`` of ``step`` (the latest if not
        given). The saved parameters load into ``params`` when it has a
        ``load_state_dict``; otherwise the saved tree is returned."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self._dir}")
        saved = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        if hasattr(params, "load_state_dict"):
            params.load_state_dict(saved["params"])
        else:
            params = saved["params"]
        return params, saved["opt_state"], step

    def close(self) -> None:
        self._closed = True

    def __enter__(self) -> "TrainCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
