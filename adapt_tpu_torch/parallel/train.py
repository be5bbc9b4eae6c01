"""The training step of the ViT pipeline.

Counterpart of ``adapt_tpu/parallel/train.py``: split a ViT ``LayerGraph``
into patch embedding, a stack of encoder blocks and a head; run the blocks
through the SPMD pipeline schedule over microbatches; take a mean
integer-label cross-entropy and one optimizer update. On the card every
attention forward runs K1 and every attention backward K7
(``ops.attention.flash_attention``).

What differs from the JAX package:

- Parameters live in the graph's modules. :class:`PipelinedViT` holds
  those modules (no copy); its ``state_dict`` gives the JAX package's
  stacked layout of the blocks.
- ``train_step(params, opt_state, x, y) -> (params, opt_state, loss)``
  keeps its shape, but updates ``params`` in place (``loss.backward()``
  then ``optimizer.step()``; each parameter's gradient stays in
  ``.grad``). ``opt_state`` is the optimizer's ``state_dict()``; ``None``
  starts fresh, and a state the step did not return (a restored
  checkpoint) is loaded first. ``optax.sgd(lr)`` is
  ``functools.partial(torch.optim.SGD, lr=lr)``.
- One rank: ``vit_shardings`` has no counterpart until the pipeline runs
  on several cards (ROADMAP.md item 11).
"""

from __future__ import annotations

from collections.abc import Callable, Mapping
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from adapt_tpu_torch.parallel.pipeline_spmd import (
    pipeline_microbatch,
    pipeline_unmicrobatch,
    spmd_pipeline,
    stack_stage_params,
)


class PipelinedViT(NamedTuple):
    """A ViT's modules split into the pipelined layout."""

    embed: nn.Module  # patch_embed
    blocks: nn.ModuleList  # the encoder blocks, in order
    head: nn.Module

    def parameters(self) -> list[nn.Parameter]:
        return [p for m in self for p in m.parameters()]

    def state_dict(self) -> dict[str, dict[str, torch.Tensor]]:
        """``{"embed", "blocks", "head"}``; the blocks stacked along a
        leading dim L, as ``split_vit_variables`` lays them out in JAX."""
        return {
            "embed": self.embed.state_dict(),
            "blocks": stack_stage_params(
                [b.state_dict() for b in self.blocks]),
            "head": self.head.state_dict(),
        }

    def load_state_dict(self, sd: Mapping[str, Mapping]) -> None:
        self.embed.load_state_dict(sd["embed"])
        for i, blk in enumerate(self.blocks):
            blk.load_state_dict({k: t[i] for k, t in sd["blocks"].items()})
        self.head.load_state_dict(sd["head"])


def split_vit_variables(graph, depth: int) -> PipelinedViT:
    """The modules of a ``models.vit`` LayerGraph in the pipelined layout
    (the graph's own modules: a step on one updates the other)."""
    return PipelinedViT(
        embed=graph.node("patch_embed").module,
        blocks=nn.ModuleList(
            graph.node(f"encoder_block_{i}").module for i in range(depth)),
        head=graph.node("head").module,
    )


def make_pipelined_vit_apply(graph, mesh: Mapping[str, int] | None = None,
                             num_micro: int = 1):
    """Forward: embed -> pipelined blocks over ``num_micro`` microbatches
    -> head. ``mesh`` maps axis names to sizes; more than one rank on an
    axis raises (see ``pipeline_spmd``)."""
    for name in ("patch_embed", "encoder_block_0", "head"):
        graph.node(name)  # raises on a graph that is not a ViT

    def apply_fn(params: PipelinedViT, x: torch.Tensor) -> torch.Tensor:
        h = params.embed(x)
        xs = pipeline_microbatch(h, num_micro)
        ys = spmd_pipeline(
            lambda blk, a: blk(a), params.blocks, xs, mesh, axis="pp",
            batch_axis="dp" if mesh is not None and "dp" in mesh else None,
        )
        return params.head(pipeline_unmicrobatch(ys))

    return apply_fn


def make_train_step(apply_fn,
                    optimizer: Callable[[list], torch.optim.Optimizer]):
    """``(params, opt_state, x, y) -> (params, opt_state, loss)``.
    ``optimizer`` builds a ``torch.optim`` optimizer from a parameter list
    (``functools.partial(torch.optim.SGD, lr=1e-3)``); the step builds it
    for the parameters it is first given, and again for other ones."""
    bound: dict = {"key": None, "opt": None, "state": None}

    def loss_fn(params, x, y):
        logits = apply_fn(params, x)
        return F.cross_entropy(logits.float(), y.long())

    def train_step(params, opt_state, x, y):
        leaves = params.parameters()
        key = tuple(id(p) for p in leaves)
        if bound["key"] != key:
            bound.update(key=key, opt=optimizer(leaves), state=None)
        opt = bound["opt"]
        if opt_state is not None and opt_state is not bound["state"]:
            opt.load_state_dict(opt_state)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, x, y)
        loss.backward()
        opt.step()
        bound["state"] = opt.state_dict()
        return params, bound["state"], loss.detach()

    return train_step
