"""The training step of the ViT pipeline over a dp x pp mesh.

Counterpart of ``adapt_tpu/parallel/train.py``: split a ViT ``LayerGraph``
into patch embedding, a stack of encoder blocks and a head; run the blocks
through the SPMD pipeline schedule (``pipeline_spmd``) over microbatches,
the blocks over the mesh's ``pp`` ranks and each microbatch's rows over its
``dp`` shards; take a mean integer-label cross-entropy and one optimizer
update. On the card every attention forward runs K1 and every attention
backward K7 (``ops.attention.flash_attention``).

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
- One process drives every rank, so the dp gradient reduction is
  autograd's sum over the rows of the whole batch: the dp shards of a
  rank run its one copy of the blocks (``pipeline_spmd.rank_devices``).
  ``vit_shardings`` gives the JAX package's placement as
  ``parallel.sharding.Sharding``s and :func:`place_vit` applies it, as
  ``jax.device_put`` does.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from adapt_tpu_torch.core.mesh import Mesh
from adapt_tpu_torch.parallel.pipeline_spmd import (
    pipeline_microbatch,
    pipeline_unmicrobatch,
    rank_devices,
    spmd_pipeline,
    stack_stage_params,
)
from adapt_tpu_torch.parallel.sharding import P, Sharding


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


def vit_shardings(params: PipelinedViT, mesh: Mesh) -> PipelinedViT:
    """:class:`~adapt_tpu_torch.parallel.sharding.Sharding`s for the
    pipelined layout, keyed as ``params.state_dict()``: the stacked blocks
    ``P("pp")`` on the stack dim, the ends replicated."""
    sd = params.state_dict()
    rep, pp = Sharding(mesh, P()), Sharding(mesh, P("pp"))
    return PipelinedViT(embed={k: rep for k in sd["embed"]},
                        blocks={k: pp for k in sd["blocks"]},
                        head={k: rep for k in sd["head"]})


def place_vit(params: PipelinedViT, shardings: PipelinedViT
              ) -> PipelinedViT:
    """Move ``params``' modules where ``shardings`` (:func:`vit_shardings`)
    put them, in place: block ``i`` to the device of the shard whose stack
    slice holds ``i``, the ends to the mesh's first device. A module
    already there is not copied."""
    sharding = next(iter(shardings.blocks.values()))
    lead = sharding.devices[0]
    params.embed.to(lead)
    params.head.to(lead)
    depth = len(params.blocks)
    for ix, dev in zip(sharding.index((depth,)), sharding.devices):
        for i in range(ix[0].start, ix[0].stop):
            params.blocks[i].to(dev)
    return params


def make_pipelined_vit_apply(graph, mesh: Mesh | None = None,
                             num_micro: int = 1):
    """Forward: embed -> blocks pipelined over the mesh's ``pp`` ranks in
    ``num_micro`` microbatches, their rows over its ``dp`` shards when it
    has that axis -> head (``mesh=None``: one rank)."""
    for name in ("patch_embed", "encoder_block_0", "head"):
        graph.node(name)  # raises on a graph that is not a ViT
    batch_axis = ("dp" if mesh is not None and "dp" in mesh.axis_names
                  else None)
    if mesh is not None:
        rank_devices(mesh, "pp", batch_axis)  # raises on a mesh it cannot run

    def apply_fn(params: PipelinedViT, x: torch.Tensor) -> torch.Tensor:
        h = params.embed(x)
        xs = pipeline_microbatch(h, num_micro)
        ys = spmd_pipeline(lambda blk, a: blk(a), params.blocks, xs, mesh,
                           axis="pp", batch_axis=batch_axis)
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
