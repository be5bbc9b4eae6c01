"""DAG partitioner: slice a :class:`LayerGraph` into sequential pipeline
stages.

Counterpart of ``adapt_tpu/graph/partition.py``: K named cut points make
K+1 stages; "cut at layer L" means L's *output* is the stage boundary.
Slicing is a backward traversal from a stage's end layer that stops at the
boundary, and a cut is rejected unless it dominates the downstream graph
(a skip connection crossing it would need a second activation hop).

The parameters live in the modules here, not in a variables tree, so the
per-stage "variables" are state dicts: :meth:`PartitionPlan.
extract_variables` gives ``{node: {name: tensor}}`` per stage on the CPU
(buffers included: BatchNorm's running statistics are buffers). A stage
runs through a :class:`StageModule` of its own, built fresh from the
graph's node modules (``graph.ir.rebuild``) and loaded with a stage state;
nothing here swaps parameters into a shared module, so two threads can run
the same stage, each on a module of its own.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence

import torch
from torch import nn

from adapt_tpu_torch.graph.ir import INPUT, LayerGraph, rebuild

#: ``{node name: {state-dict key: tensor}}`` — one stage's weights.
StageState = Mapping[str, Mapping[str, torch.Tensor]]


class InvalidCutError(ValueError):
    """A requested cut does not dominate its downstream stage (a skip
    connection crosses the boundary) or names an unknown layer."""


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One pipeline stage: the sub-DAG spanning ``(output of start) ->
    end``. ``start`` is :data:`INPUT` for stage 0; ``node_names`` is
    topo-ordered and excludes ``start``."""

    index: int
    name: str
    start: str
    end: str
    node_names: tuple[str, ...]

    @property
    def num_nodes(self) -> int:
        return len(self.node_names)


class StageModule(nn.Module):
    """A stage's node modules, built anew on ``device`` (weights
    uninitialised until a stage state is loaded), run from the stage's
    boundary tensor to its end node."""

    def __init__(self, graph: LayerGraph, stage: StageSpec, device):
        super().__init__()
        self.stage = stage
        self.layers = nn.ModuleDict(
            (n, rebuild(graph.node(n).module, device))
            for n in stage.node_names)
        self._inputs = {n: graph.node(n).inputs for n in stage.node_names}

    def load_stage_state(self, state: StageState, assign: bool = False):
        """Load ``{node: {name: tensor}}`` (copied onto this module's
        device, or with ``assign`` taken as they are)."""
        self.load_state_dict(
            {f"layers.{n}.{k}": t for n, sd in state.items()
             for k, t in sd.items()}, assign=assign)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cache = {self.stage.start: x}
        for name, module in self.layers.items():
            cache[name] = module(*(cache[d] for d in self._inputs[name]))
        return cache[self.stage.end]


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """An ordered list of stages covering the whole graph exactly once."""

    graph: LayerGraph
    stages: tuple[StageSpec, ...]

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def cuts(self) -> tuple[str, ...]:
        return tuple(s.start for s in self.stages[1:])

    def build_stage(self, stage: StageSpec, device) -> StageModule:
        """A fresh :class:`StageModule` for ``stage`` on ``device``."""
        return StageModule(self.graph, stage, device)

    def stage_apply(self, stage: StageSpec):
        """A pure ``(stage_state, x) -> y`` function for one stage. Each
        call builds the stage's modules on the meta device and takes the
        state's tensors as their weights (on ``x``'s device), so calls
        share no module and no weight is copied when the state already lies
        there."""

        def apply_fn(stage_state: StageState, x: torch.Tensor):
            state = {n: {k: t.to(x.device) for k, t in sd.items()}
                     for n, sd in stage_state.items()}
            module = self.build_stage(stage, "meta")
            return module.load_stage_state(state, assign=True)(x)

        apply_fn.__name__ = f"{self.graph.name}_stage{stage.index}"
        return apply_fn

    def extract_variables(
        self, variables: Mapping[str, Mapping] | None = None
    ) -> list[dict[str, dict[str, torch.Tensor]]]:
        """Per-stage ``{node: {name: tensor}}`` on the CPU, buffers
        included: from ``variables`` (a ``{node: state dict}`` mapping) or,
        by default, from the graph's own modules."""
        if variables is None:
            variables = {n: node.module.state_dict()
                         for n, node in self.graph.nodes.items()}
        return [
            {name: {k: t.detach().cpu() for k, t in variables[name].items()}
             for name in stage.node_names}
            for stage in self.stages
        ]

    def compose(self, stage_variables: Sequence[StageState],
                x: torch.Tensor) -> torch.Tensor:
        """Run all stages in turn on ``x``'s device: the correctness oracle,
        ``compose(extract_variables(), x) == graph.apply(x)``."""
        if len(stage_variables) != len(self.stages):
            raise ValueError(
                f"plan has {len(self.stages)} stages but got "
                f"{len(stage_variables)} variable sets (stale plan?)"
            )
        for stage, svars in zip(self.stages, stage_variables):
            x = self.stage_apply(stage)(svars, x)
        return x

    def describe(self) -> str:
        lines = [f"PartitionPlan({self.graph.name}, {self.num_stages} stages)"]
        for s in self.stages:
            lines.append(
                f"  stage {s.index}: [{s.start} -> {s.end}] "
                f"({s.num_nodes} nodes)"
            )
        return "\n".join(lines)


def stage_weight_keys(stage_state: Mapping[str, Mapping]) -> list[
        tuple[str, str]]:
    """The order in which a stage's weights travel as separate arrays (a
    remote configure): node by node in the state's order (the stage's
    topological order), each node's state-dict keys sorted. The sender
    applies it to ``extract_variables()``'s state and the receiver to the
    state dict of the stage module it built, so both agree on which array
    is which."""
    return [(n, k) for n, sd in stage_state.items() for k in sorted(sd)]


def _backward_slice(graph: LayerGraph, end: str,
                    boundary: str) -> tuple[str, ...]:
    """All nodes needed to compute ``end`` from ``boundary``'s output,
    topo-ordered; raises :class:`InvalidCutError` if a backward path
    escapes the boundary."""
    needed: set[str] = set()
    stack = [end]
    while stack:
        name = stack.pop()
        if name in needed or name == boundary:
            continue
        if name == INPUT:
            raise InvalidCutError(
                f"cut at {boundary!r} does not dominate {end!r}: a path "
                "reaches the graph input without passing through the cut "
                "(a skip connection crosses the stage boundary)"
            )
        needed.add(name)
        stack.extend(graph.node(name).inputs)
    return tuple(n for n in graph.topo_order() if n in needed)


def partition(graph: LayerGraph, cuts: Sequence[str]) -> PartitionPlan:
    """Split ``graph`` at named layers into ``len(cuts)+1`` stages; every
    stage's node set is disjoint and their union is the whole graph."""
    for c in cuts:
        if c not in graph.nodes:
            raise InvalidCutError(
                f"unknown cut layer {c!r} in graph {graph.name!r}"
            )
        if c == graph.output:
            raise InvalidCutError(
                f"cut at {c!r} is the graph output; it would create an "
                "empty final stage"
            )
    if len(set(cuts)) != len(cuts):
        raise InvalidCutError(f"duplicate cut layers: {list(cuts)}")

    bounds = [INPUT, *cuts, graph.output]
    stages: list[StageSpec] = []
    seen: set[str] = set()
    for i in range(len(bounds) - 1):
        start, end = bounds[i], bounds[i + 1]
        node_names = _backward_slice(graph, end, start)
        overlap = seen.intersection(node_names)
        if overlap:
            raise InvalidCutError(
                f"cuts {list(cuts)} are not in topological order: stage "
                f"{i} recomputes {sorted(overlap)[:4]}"
            )
        seen.update(node_names)
        stages.append(StageSpec(index=i, name=f"{graph.name}_stage{i}",
                                start=start, end=end, node_names=node_names))
    uncovered = set(graph.topo_order()) - seen
    if uncovered:
        raise InvalidCutError(
            f"cuts {list(cuts)} leave layers unreached from the output "
            f"boundaries: {sorted(uncovered)[:4]} (dead branches are not "
            "supported)"
        )
    return PartitionPlan(graph=graph, stages=tuple(stages))


def valid_cut_points(graph: LayerGraph) -> list[str]:
    """Layers whose output is a legal single-tensor stage boundary (the
    DAG's articulation points, the output layer excluded): L is valid iff
    no earlier output is still awaited by a node after L."""
    order = graph.topo_order()
    position = {name: i for i, name in enumerate(order)}
    last_use: dict[str, int] = {}
    for name in order:
        for dep in graph.node(name).inputs:
            last_use[dep] = position[name]  # includes INPUT
    valid = []
    running = last_use.get(INPUT, -1)
    for i, name in enumerate(order[:-1]):
        if running <= i:
            valid.append(name)
        running = max(running, last_use.get(name, -1))
    return valid


def balanced_cuts(
    graph: LayerGraph,
    num_stages: int,
    costs: Mapping[str, float] | None = None,
) -> list[str]:
    """``num_stages - 1`` valid cut points that balance per-stage cost
    (uniform node count by default, or per-layer ``costs``)."""
    if num_stages < 1:
        raise ValueError("num_stages must be >= 1")
    if num_stages == 1:
        return []
    candidates = valid_cut_points(graph)
    if len(candidates) < num_stages - 1:
        raise InvalidCutError(
            f"graph {graph.name!r} has only {len(candidates)} valid cut "
            f"points; cannot make {num_stages} stages"
        )
    order = graph.topo_order()
    position = {name: i for i, name in enumerate(order)}
    if costs is None:
        costs = {name: 1.0 for name in order}
    total = sum(costs.get(n, 0.0) for n in order)
    prefix: dict[str, float] = {}
    acc = 0.0
    for n in order:
        acc += costs.get(n, 0.0)
        prefix[n] = acc
    cuts: list[str] = []
    for k in range(1, num_stages):
        target = total * k / num_stages
        floor = position[cuts[-1]] if cuts else -1
        remaining_after = num_stages - 1 - k
        avail = [
            c
            for j, c in enumerate(candidates)
            if position[c] > floor and len(candidates) - 1 - j >= remaining_after
        ]
        if not avail:
            raise InvalidCutError(
                f"cannot place {num_stages - 1} distinct balanced cuts in "
                f"graph {graph.name!r} ({len(candidates)} valid cut points)"
            )
        cuts.append(min(avail, key=lambda c: abs(prefix[c] - target)))
    return cuts
