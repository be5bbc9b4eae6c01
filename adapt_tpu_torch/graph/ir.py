"""Layer-graph IR: models as a DAG of named modules.

Counterpart of ``adapt_tpu/graph/ir.py``. A model is a declared DAG of
named nodes, each wrapping an ``nn.Module``; named nodes give the
partitioner stable cut points. In torch idiom the graph is itself an
``nn.Module`` whose node modules sit in an insertion-ordered
``nn.ModuleDict`` (``layers``), so ``.parameters()``, ``.to()`` and
``state_dict()`` work on the whole model (keys ``layers.<node>.<param>``).
flax's ``init`` becomes construction plus the model's seeded init; the
parameters live in the modules, so ``apply`` takes only the input.

Nodes must be added in topological order (every input must already exist),
which makes insertion order a valid execution order.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Mapping, Sequence

import torch
from torch import nn

#: Sentinel name for the graph's input tensor.
INPUT = "__input__"


@dataclasses.dataclass(frozen=True)
class LayerNode:
    """One named node of the model DAG: ``module`` maps the outputs of the
    nodes named in ``inputs`` (or :data:`INPUT`) to this node's output."""

    name: str
    module: nn.Module
    inputs: tuple[str, ...]

    def apply(self, *args: torch.Tensor) -> torch.Tensor:
        return self.module(*args)


class LayerGraph(nn.Module):
    """A DAG of named layers with a single input and a single output node.

    ``apply(x)`` (and ``forward``) runs the whole graph; note that this
    ``apply`` is the graph's, not ``nn.Module.apply(fn)``."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        self.layers = nn.ModuleDict()
        self._nodes: dict[str, LayerNode] = {}
        self._output: str | None = None

    # -- construction -------------------------------------------------------

    def add(
        self,
        name: str,
        module: nn.Module,
        inputs: str | Sequence[str] = INPUT,
    ) -> str:
        """Add a named node; returns the name so calls can be chained."""
        if isinstance(inputs, str):
            inputs = (inputs,)
        inputs = tuple(inputs)
        if name in self._nodes or name == INPUT:
            raise ValueError(f"duplicate layer name: {name!r}")
        for dep in inputs:
            if dep != INPUT and dep not in self._nodes:
                raise ValueError(
                    f"layer {name!r} depends on unknown layer {dep!r} "
                    "(nodes must be added in topological order)"
                )
        self.layers[name] = module
        self._nodes[name] = LayerNode(name=name, module=module, inputs=inputs)
        self._output = name
        return name

    def set_output(self, name: str) -> None:
        if name not in self._nodes:
            raise ValueError(f"unknown layer: {name!r}")
        self._output = name

    # -- introspection ------------------------------------------------------

    @property
    def output(self) -> str:
        if self._output is None:
            raise ValueError("empty graph")
        return self._output

    @property
    def nodes(self) -> Mapping[str, LayerNode]:
        return self._nodes

    def node(self, name: str) -> LayerNode:
        try:
            return self._nodes[name]
        except KeyError:
            raise KeyError(
                f"no layer {name!r} in graph {self.name!r}; "
                f"known layers: {list(self._nodes)[:8]}..."
            ) from None

    def topo_order(self) -> list[str]:
        return list(self._nodes)

    def consumers(self, name: str) -> list[str]:
        return [n.name for n in self._nodes.values() if name in n.inputs]

    # -- execution ----------------------------------------------------------

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Run the full graph (un-partitioned); the single-device path."""
        return self.apply_subset(
            self.topo_order(), {INPUT: x}, output=self.output
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    def apply_subset(
        self,
        node_names: Sequence[str],
        boundary: Mapping[str, torch.Tensor],
        output: str | None = None,
    ) -> torch.Tensor:
        """Execute ``node_names`` (a topo-ordered subset) given boundary
        tensors; the primitive that stage functions build on."""
        cache: dict[str, torch.Tensor] = dict(boundary)
        for name in node_names:
            node = self._nodes[name]
            cache[name] = node.apply(*(cache[dep] for dep in node.inputs))
        return cache[output if output is not None else node_names[-1]]

    def extra_repr(self) -> str:
        return f"{self.name!r}, nodes={len(self._nodes)}, output={self._output!r}"


class Lambda(nn.Module):
    """Wrap a pure parameterless function as a node module (merge ops like
    residual add, concat)."""

    def __init__(self, fn: Callable[..., torch.Tensor], name: str = "lambda"):
        super().__init__()
        self._fn = fn
        self.name = name

    def forward(self, *args: torch.Tensor) -> torch.Tensor:
        return self._fn(*args)

    def extra_repr(self) -> str:
        return self.name
