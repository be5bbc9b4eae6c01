"""Expert parallelism: split the expert axis of MoE parameters over an
``ep`` mesh axis — the port of ``adapt_tpu/parallel/expert.py``.

MoE parameters are expert-stacked (leading ``E`` axis, the JAX layout the
port keeps: ``models/moe.py``). :func:`expert_shardings` splits that axis
over ``ep`` and replicates everything else; an expert stack's spec
composes with ``parallel/sharding.lm_tp_rules``' hidden split through
``merge_specs``. A model built from the placed tensors
(``models/transformer_lm.shard_lm``) runs each shard's own experts in
masked-dense form and sums the shards' contributions in shard order; the
JAX package leaves that exchange to GSPMD.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from adapt_tpu_torch.core.mesh import Mesh
from adapt_tpu_torch.parallel.sharding import P, Shards, Sharding, _flat


def _is_expert_stacked(name: str, leaf, num_experts: int,
                       exclude: tuple[str, ...]) -> bool:
    if any(e in name for e in exclude):
        return False
    return (hasattr(leaf, "ndim") and leaf.ndim >= 1
            and leaf.shape[0] == num_experts)


def expert_shardings(params: Mapping, mesh: Mesh, num_experts: int,
                     axis: str = "ep", exclude: tuple[str, ...] = ("gate",)
                     ) -> dict[str, Sharding]:
    """name -> :class:`Sharding` for a state dict: tensors whose leading
    dim is the expert count get ``P(axis, ...)``, everything else is
    replicated. ``exclude`` lists name substrings that are never
    expert-stacked: the router's ``gate`` ``(D, E)`` by default, which
    would otherwise be split whenever D equals the expert count."""
    out = {}
    for name, leaf in _flat(params):
        if _is_expert_stacked(name, leaf, num_experts, exclude):
            out[name] = Sharding(mesh, P(axis, *([None] * (leaf.ndim - 1))))
        else:
            out[name] = Sharding(mesh, P())
    return out


def place_experts(params: Mapping, mesh: Mesh, num_experts: int,
                  axis: str = "ep", exclude: tuple[str, ...] = ("gate",)
                  ) -> dict[str, Shards]:
    """Cut a state dict per :func:`expert_shardings`: name ->
    :class:`Shards` on the mesh's devices."""
    shardings = expert_shardings(params, mesh, num_experts, axis, exclude)
    return {name: shardings[name].shard(leaf)
            for name, leaf in _flat(params)}


def expert_utilization(gates) -> np.ndarray:
    """Fraction of top-1 routed tokens per expert — the load-balance
    reading beside an MoE layer's ``aux_loss``."""
    g = torch.as_tensor(gates)
    idx = g.argmax(dim=-1).reshape(-1).cpu().numpy()
    counts = np.bincount(idx, minlength=g.shape[-1])
    return counts / max(1, idx.size)
