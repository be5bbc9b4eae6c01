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

A node module that subclasses :class:`NodeModule` records its constructor
arguments (``spec_args``): :func:`rebuild` makes a fresh module of the same
kind on another device from them (a pipeline stage, a worker's binding, the
meta-device pass of :meth:`LayerGraph.eval_shapes`), and ``graph.spec``
writes them into a graph's spec. :class:`Lambda` nodes hold no state and are
shared, not rebuilt.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
from collections.abc import Callable, Mapping, Sequence

import torch
from torch import nn

#: Sentinel name for the graph's input tensor.
INPUT = "__input__"


class NodeModule(nn.Module):
    """A node module that records the arguments it was constructed with as
    ``spec_args`` (every argument but ``device``; defaults filled in).
    Subclasses take a ``device=`` argument and allocate their parameters
    and buffers there; ``type(m)(**m.spec_args, device=d)`` builds the same
    node, with uninitialised weights, on ``d``."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        init = cls.__dict__.get("__init__")
        if init is None:
            return
        sig = inspect.signature(init)

        @functools.wraps(init)
        def recording_init(self, *args, **kw):
            init(self, *args, **kw)
            if type(self).__init__ is recording_init:  # the outermost class
                bound = sig.bind(self, *args, **kw)
                bound.apply_defaults()
                spec_args = dict(bound.arguments)
                del spec_args["self"]
                spec_args.pop("device", None)
                self.spec_args = spec_args

        cls.__init__ = recording_init


def rebuild(module: nn.Module, device) -> nn.Module:
    """A fresh module of ``module``'s kind and arguments on ``device``
    (weights uninitialised: load a state into it); a :class:`Lambda` is
    returned as it is."""
    if isinstance(module, Lambda):
        return module
    spec_args = getattr(module, "spec_args", None)
    if spec_args is None:
        raise TypeError(
            f"cannot rebuild {type(module).__qualname__}: node modules must "
            "subclass graph.ir.NodeModule (or be a Lambda)"
        )
    return type(module)(**spec_args, device=device)


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

    def eval_shapes(self, x) -> dict[str, torch.Tensor]:
        """Per-node outputs as meta tensors (shape and dtype, no storage),
        without running the model: every node is rebuilt on the meta device
        and fed meta tensors. ``x`` is a tensor or a meta tensor of the
        input's shape and dtype."""
        shapes = {INPUT: torch.empty(x.shape, dtype=x.dtype, device="meta")}
        with torch.no_grad():
            for node in self._nodes.values():
                meta = rebuild(node.module, "meta")
                shapes[node.name] = meta(*(shapes[d] for d in node.inputs))
        del shapes[INPUT]
        return shapes

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
