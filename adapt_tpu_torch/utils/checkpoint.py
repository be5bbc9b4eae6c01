"""Step-numbered train-state checkpoints with retention and resume.

Counterpart of ``adapt_tpu/utils/checkpoint.py``'s ``TrainCheckpointer``,
saved with ``torch.save`` (no orbax): one file ``step_<n>.pt`` per step
under the directory, holding ``{"params", "opt_state"}`` with every tensor
on the host, and only the newest ``max_to_keep`` steps kept. Restores are
host-first, as in the JAX package: ``restore`` loads the saved parameters
into the caller's (``load_state_dict``, which copies onto their device)
and hands the optimizer state back as saved, for the train step to load.
Nothing stays open between calls, so there is nothing to close.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


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


class TrainCheckpointer:
    """Step-numbered train-state checkpoints with retention + resume."""

    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self._dir = os.path.abspath(os.fspath(directory))
        self._keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}.pt")

    def steps(self) -> list[int]:
        """The saved steps, oldest first."""
        found = (_NAME.match(n) for n in os.listdir(self._dir))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, params: Any, opt_state: Any) -> None:
        """Write step ``step`` (params: a module-like object with a
        ``state_dict``, or a tree of tensors) atomically, then drop all but
        the newest ``max_to_keep`` steps."""
        tmp = self._path(step) + f".{os.getpid()}.tmp"
        torch.save({"params": _to_host(_state(params)),
                    "opt_state": _to_host(opt_state)}, tmp)
        os.replace(tmp, self._path(step))
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
