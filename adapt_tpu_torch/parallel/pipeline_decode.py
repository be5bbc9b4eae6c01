"""Pipelined KV-cache generation: decode an LM over the ranks of a ``pp``
mesh axis — the port of ``adapt_tpu/parallel/pipeline_decode.py``.

``models.transformer_lm.generate`` is one loop over every block, whose
weights and KV caches sit on one device. Here the decoder is cut by block
over the ranks of a :class:`~adapt_tpu_torch.core.mesh.Mesh` axis: rank p
holds blocks ``[p L/P, (p + 1) L/P)`` and their KV caches on its mesh
entry's device (:func:`shard_for_pipeline`), so weights and caches larger
than one device's memory generate across P of them. One process drives
every rank (``parallel/sharding``'s single controller), and the activation
hop is ``parallel.ring_attention.ring_pass``, the one transport. Not to be
confused with ``runtime/decode_pipeline.py`` (``PipelinedDecoder``), the
fault-tolerant pipeline over stage workers.

Schedule — a token ring, as in the reference:

- The batch is split into M = P microbatches (each of its rows further
  over ``dp_axis`` shards, when given).
- Prefill first, by the shift schedule: at tick t rank p runs microbatch
  t - p over its blocks, building its caches; the last rank runs the head
  on the prompt's last position and samples the microbatch's first token.
- Decode: at tick t rank p runs microbatch ``(t - p) mod P`` at pass
  ``(t - p) div P`` through its blocks' cached ``decode_step``. The last
  rank runs the head, samples, and puts the embedding of the sampled token
  on the ring; one hop later rank 0 consumes it as that microbatch's next
  pass. Rank 0's first pass embeds the prefill-sampled token.

The reference's trash cache slot and garbage bubble ticks exist because a
lockstep program cannot skip a tick; one controller can, so a (rank, tick)
with no valid microbatch runs nothing. What stays is ``generate()``'s
shapes, so that tokens match it exactly: strips of ``max_len + 1``, the
prompt right-padded to ``prompt_bucket``, decode rows padded to a multiple
of ``ROW_QUANTUM``; sampling keys a row by its GLOBAL index
(``sample_next_tokens(..., row_offset=m * mb + dp_off)``) and the token
index, as ``generate()`` does.

Parity contract (tested): token for token identical to ``generate`` with
the same arguments — greedy and sampled, ragged, EOS-padded, int8 AND int4
caches. (The reference passes ``kv_quant = kv_cache_dtype == "int8"``, so
its int4 request runs native caches; the port runs int4 caches.)
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from adapt_tpu_torch.core.mesh import Mesh
# A module import: ``models.transformer_lm`` imports ``parallel`` (its
# sharding), whose package imports this module.
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.parallel.pipeline_spmd import rank_devices
from adapt_tpu_torch.parallel.ring_attention import ring_pass


@dataclasses.dataclass(frozen=True)
class PipelinedVariables:
    """Weights placed for pipelined decode. ``stages[p]`` is pp rank p's
    piece of the LM on ``devices[p]``: a :class:`TransformerLM` of depth
    L/P holding blocks ``[p L/P, (p + 1) L/P)``, with the embedding and the
    head, which every rank holds and ranks on one device share (one copy a
    device). Build once with :func:`shard_for_pipeline`, reuse across
    calls."""

    stages: tuple[T.TransformerLM, ...]
    devices: tuple[torch.device, ...]


def _placed(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``: itself when it is there, else a copy staged
    through host memory."""
    return t if t.device == dev else t.detach().cpu().to(dev)


def shard_for_pipeline(lm: T.TransformerLM, mesh: Mesh, axis: str = "pp",
                       variables: Mapping[str, torch.Tensor] | None = None
                       ) -> PipelinedVariables:
    """Place ``variables`` (a ``state_dict`` of ``lm``'s structure; None is
    ``lm``'s own) for pipelined decode over ``mesh``'s ``axis``: each rank
    receives only its own L/P blocks on its device, staged through host
    memory when they lie elsewhere (so the whole block set never lands on
    one device), and the embedding and head once a distinct device. Tensors
    already on a rank's device are used, not copied."""
    devices = rank_devices(mesh, axis)[0]
    ranks = len(devices)
    if lm.depth % ranks:
        raise ValueError(
            f"depth {lm.depth} not divisible by pipeline size {ranks}")
    sd = lm.state_dict() if variables is None else dict(variables)
    per = lm.depth // ranks
    ends = {}  # device -> the embedding and head tensors there
    stages = []
    for p, dev in enumerate(devices):
        if dev not in ends:
            ends[dev] = {k: _placed(t, dev) for k, t in sd.items()
                         if k.startswith(("embed.", "head."))}
        state = dict(ends[dev])
        for j in range(per):
            src, dst = f"decoder_block_{p * per + j}.", f"decoder_block_{j}."
            state.update({dst + k[len(src):]: _placed(t, dev)
                          for k, t in sd.items() if k.startswith(src)})
        stage = T.TransformerLM(**dict(T.lm_config(lm), depth=per),
                                device="meta")
        stage.load_state_dict(state, assign=True)
        stages.append(stage.eval())
    return PipelinedVariables(tuple(stages), tuple(devices))


@torch.no_grad()
def pipelined_generate(
    lm: T.TransformerLM,
    variables,
    prompt,
    steps: int,
    mesh: Mesh,
    axis: str = "pp",
    dp_axis: str | None = None,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    eos_id: int | None = None,
    rng: int | None = None,
    prompt_lengths=None,
    kv_cache_dtype: str = "native",
) -> torch.Tensor:
    """``generate`` semantics, pipelined over ``mesh.shape[axis]`` ranks.

    ``prompt``: (b, s0) ids with b divisible by the pipeline size (the
    microbatch split) and ``lm.depth`` divisible by it (the block split);
    returns (b, steps) ids on the first rank's device, identical to
    ``generate(lm, prompt, steps, ...)`` with the same arguments: every
    sampling knob, ragged prompts (``prompt_lengths``) and
    ``kv_cache_dtype`` ``"int8"`` / ``"int4"``.

    ``variables`` is a :class:`PipelinedVariables` from
    :func:`shard_for_pipeline` (place once, reuse), or a ``state_dict`` /
    None (``lm``'s own), placed on each call.

    ``dp_axis`` composes data parallelism on a 2-D mesh: every
    microbatch's rows split over it (batch divisible by pipeline size x dp
    size); a rank's dp shards share its device and blocks. Sampling stays
    per GLOBAL row, so the output is still ``generate()``'s.
    """
    grid = rank_devices(mesh, axis, dp_axis)
    ranks, dp = len(grid[0]), len(grid)
    dev0 = grid[0][0]
    prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(
        prompt) else prompt).to(dev0, torch.int64)
    b, s0 = prompt.shape
    lengths, rng, do_sample = T.validate_generate_args(
        lm, prompt, steps, temperature, top_k, rng, prompt_lengths,
        kv_cache_dtype, top_p=top_p,
    )
    if lm.depth % ranks:
        raise ValueError(
            f"depth {lm.depth} not divisible by pipeline size {ranks}")
    if b % ranks:
        raise ValueError(
            f"batch {b} not divisible by pipeline size {ranks} "
            "(the microbatch split); pad the batch")
    if (b // ranks) % dp:
        raise ValueError(
            f"per-microbatch rows {b // ranks} not divisible by dp size {dp}")
    if not isinstance(variables, PipelinedVariables):
        variables = shard_for_pipeline(lm, mesh, axis, variables)
    stages = variables.stages

    num_micro = ranks  # M == P: the ring keeps every rank busy
    mb = b // num_micro  # global rows a microbatch
    mb_loc = mb // dp  # rows of a microbatch a dp shard holds
    pad_rows = -(-mb_loc // T.ROW_QUANTUM) * T.ROW_QUANTUM - mb_loc
    bucket = T.prompt_bucket(s0, lm.max_len)
    ragged = prompt_lengths is not None
    if ragged:
        aligned, pos_ids, vf_all = T._left_align(prompt, lengths)
        ids = F.pad(aligned, (0, bucket - s0))
        tail = pos_ids[:, -1:] + torch.arange(
            1, bucket - s0 + 1, device=dev0)[None, :]
        pos_all = torch.cat([pos_ids, tail], 1)
    else:
        ids = F.pad(prompt, (0, bucket - s0))
    quant = kv_cache_dtype if kv_cache_dtype != "native" else False

    def rows(m, i):
        lo = m * mb + i * mb_loc
        return slice(lo, lo + mb_loc)

    def pick(logits, m, i, t):
        return T.sample_next_tokens(
            logits, rng, t, temperature, do_sample=do_sample, top_k=top_k,
            top_p=top_p, row_offset=m * mb + i * mb_loc)

    # Keyed (rank, microbatch, dp shard): the rank's caches of its blocks
    # and its valid_from rows, padded to the decode rows as generate()
    # pads them. Keyed (microbatch, dp shard): the last rank's tokens and
    # EOS latch.
    caches, vf, toks, done = {}, {}, {}, {}

    # -- prefill: prompt activations shift down the chain --------------
    sent = [[None] * ranks for _ in range(dp)]
    for t in range(num_micro + ranks - 1):
        for i in range(dp):
            devs = grid[i]
            recv = ring_pass(sent[i], devs)
            sent[i] = [None] * ranks
            for p in range(ranks):
                m = t - p
                if not 0 <= m < num_micro:
                    continue
                dev, stage, r = devs[p], stages[p], rows(m, i)
                v = vf_all[r].to(dev) if ragged else None
                if p == 0:
                    h = (stage.embed.embed_positions(ids[r], pos_all[r])
                         if ragged else stage.embed(ids[r]))
                else:
                    h = recv[p]
                kv = []
                for block in stage.blocks:
                    h, ck, cv = block.prefill(h, lm.max_len + 1, v, quant)
                    kv.append(tuple(T.map_cache(lambda c: F.pad(
                        c, (0, 0, 0, 0, 0, 0, 0, pad_rows)), c)
                        for c in (ck, cv)))
                caches[p, m, i] = kv
                vf[p, m, i] = None if v is None else F.pad(v, (0, pad_rows))
                if p < ranks - 1:
                    sent[i][p] = h
                    continue
                first = pick(stage.head(h[:, s0 - 1:s0])[:, 0], m, i, 0)
                toks[m, i] = [first]
                if eos_id is not None:
                    done[m, i] = F.pad(first == eos_id, (0, pad_rows))

    # -- decode: a single-token ring ----------------------------------
    passes = (steps - 1) * num_micro
    sent = [[None] * ranks for _ in range(dp)]
    for t in range(passes + ranks - 1 if steps > 1 else 0):
        for i in range(dp):
            devs = grid[i]
            recv = ring_pass(sent[i], devs)
            sent[i] = [None] * ranks
            for p in range(ranks):
                j = t - p
                if not 0 <= j < passes:
                    continue
                m, sp = j % num_micro, j // num_micro
                dev, stage = devs[p], stages[p]
                v = vf[p, m, i]
                idx = torch.full((mb_loc + pad_rows,), s0 + sp,
                                 dtype=torch.int32, device=dev)
                if p == 0 and sp == 0:
                    tok = F.pad(toks[m, i][0], (0, pad_rows)).to(dev)
                    pos = idx if v is None else idx - v
                    x = stage.embed.embed_positions(tok[:, None],
                                                    pos[:, None])
                else:
                    x = recv[p]
                for block, (ck, cv) in zip(stage.blocks, caches[p, m, i]):
                    x, _, _ = block.decode_step(x, ck, cv, idx, v)
                if p < ranks - 1:
                    sent[i][p] = x
                    continue
                nxt = pick(stage.head(x)[:, 0], m, i, sp + 1)
                if eos_id is not None:
                    nxt = torch.where(done[m, i], eos_id, nxt)
                    done[m, i] = done[m, i] | (nxt == eos_id)
                toks[m, i].append(nxt[:mb_loc])
                if sp + 1 < steps - 1:
                    pos = idx + 1 if v is None else idx + 1 - v
                    sent[i][p] = stage.embed.embed_positions(nxt[:, None],
                                                             pos[:, None])
    out = torch.empty((b, steps), dtype=torch.int64, device=dev0)
    for (m, i), ts in toks.items():
        out[rows(m, i)] = torch.stack(ts, 1).to(dev0)
    return out
