"""Speculative decoding: draft cheap, verify in one cached pass — the port
of ``adapt_tpu/models/speculative.py``.

A cheap DRAFT model proposes ``draft_k`` tokens, the target scores all of
them in ONE cached forward (``verify_chunk``: K causal logits against the
KV cache for one weight stream instead of K), and the longest agreeing
prefix is accepted plus one correction token from the target's own logits.
Greedy speculative decoding is lossless: the emitted stream is the
target's greedy stream whatever the draft proposes; the draft only changes
how fast it is produced.

The per-round work is two fixed-shape passes — a ``draft_k + 1``-step draft
scan (:func:`draft_chunk`, one ``decode_step`` per token over the draft's
dense strips, K2 on CUDA) and a ``draft_k + 1``-token verify-and-accept
chunk. Both are batch-shaped: ``index`` may be a ``(b,)`` tensor, each row
at its own position, which is what the continuous batcher's speculative
mode runs over desynchronised slots. Rejected speculation needs no rollback
on either cache: entries past the accepted position are never admitted by
the position masks and are overwritten by later rounds. Caches carry
``draft_k + 1`` slack positions so overshoot writes land in masked space.

Acceptance is computed on the device; each round fetches ONE packed
``(draft_k + 2,)`` vector and stages nothing back (``host_fetches ==
rounds + 1``).

The draft's weights may be held blockwise int8
(``SpeculativeConfig.draft_weight_dtype="int8"``,
``ops.quantize.quantize_params`` of its ``state_dict``): every draft scan
and draft prefill dequantizes them at entry (K6 on CUDA) and runs the draft
with the restored tensors swapped in (:func:`swapped_weights`), so the float
copies live only for that call.

Numerics: "token-equal" assumes the chunked verify and the sequential decode
produce equal logits. On the CPU in f32 they do. On the card a verify pass
runs its matmuls on ``b * K`` rows where decode runs ``b``, so the matmul
library may pick another summation order and a bf16 near-tie can flip a
token; the card's check is tie-aware.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adapt_tpu_torch.models.transformer_lm import (
    TransformerLM,
    gumbel_noise,
    prompt_bucket,
    uniform_draw,
)
from adapt_tpu_torch.ops.quantize import dequantize_params

__all__ = [
    "accept_speculation",
    "draft_chunk",
    "swapped_weights",
    "speculative_generate",
    "speculative_sample",
]

#: Domain separators of the two draws a sampled speculative commit takes
#: off its counter: the acceptance uniform and the residual draw.
_SALT_ACCEPT = 0x5BD1E995
_SALT_RESAMPLE = 0x1B873593


@contextlib.contextmanager
def swapped_weights(lm: TransformerLM, weights):
    """Run ``lm`` on ``weights`` for the length of the block: a flat
    ``{parameter name: tensor or QuantizedTensor}`` mapping
    (``quantize_params(lm.state_dict())``), dequantized HERE and swapped in
    for the module's own parameters, which come back on exit. ``None``
    leaves the module as it is."""
    if weights is None:
        yield
        return
    restored = dequantize_params(weights)
    saved = []
    for name, t in restored.items():
        path, _, leaf = name.rpartition(".")
        mod = lm.get_submodule(path) if path else lm
        saved.append((mod, leaf, mod._parameters[leaf]))
        mod._parameters[leaf] = nn.Parameter(t, requires_grad=False)
    try:
        yield
    finally:
        for mod, leaf, p in saved:
            mod._parameters[leaf] = p


def _prefill(lm: TransformerLM, prompt, s0: int, cache_len: int):
    """Prompt forward (right-padded to the batcher's power-of-two bucket,
    as ``generate`` pads it) building caches of ``cache_len``; returns
    (greedy first token (b,), caches)."""
    bucket = prompt_bucket(s0, lm.max_len)
    h = lm.embed(F.pad(prompt, (0, bucket - s0)))
    caches = []
    for block in lm.blocks:
        h, ck, cv = block.prefill(h, cache_len)
        caches.append((ck, cv))
    logits = lm.head(h[:, s0 - 1:s0])[:, 0]
    return torch.argmax(logits, dim=-1), caches


@torch.no_grad()
def draft_chunk(lm: TransformerLM, tok, index, caches, *, n: int,
                tail_w: int = 0, weights=None, attn_impl=None, split=None):
    """``n`` greedy decode steps of the draft model: consumes ``tok`` (b,)
    at ``index``, returns its next-token chain (n, b); the caches are
    updated in place.

    ``index`` is a scalar (every row at one position) or (b,) (each slot
    drafts from its OWN position; negative rows are dead slots whose writes
    clamp into their own row's masked space). ``tail_w`` > 0 (tree drafts)
    also returns each step's top-``tail_w`` token ids (n, b, tail_w), from
    logits the scan computes anyway. ``weights`` may carry int8-quantized
    matrix leaves: they dequantize here (:func:`swapped_weights`)."""
    b = tok.shape[0]
    idx = torch.as_tensor(index, device=tok.device).to(torch.int32)
    idx = idx.reshape(-1).expand(b).contiguous()
    toks, tops = [], []
    with swapped_weights(lm, weights):
        for _ in range(n):
            x = lm.embed.embed_positions(tok[:, None], idx[:, None])
            for block, (ck, cv) in zip(lm.blocks, caches):
                x, _, _ = block.decode_step(x, ck, cv, idx,
                                            attn_impl=attn_impl, split=split)
            logits = lm.head(x)[:, 0]
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
            if tail_w:
                tops.append(torch.topk(logits, tail_w, dim=-1).indices)
            idx = idx + 1
    if tail_w:
        return torch.stack(toks), torch.stack(tops)
    return torch.stack(toks)


def accept_speculation(props, preds):
    """Per-row longest-agreeing-prefix acceptance, on the device: ``props``
    (b, d) draft proposals, ``preds`` (b, d + 1) target greedy predictions
    after each chunk position. Returns (b,) accepted counts ``a`` — the
    round commits ``preds[:, :a + 1]`` (the agreeing prefix IS the target's
    own predictions, plus its correction token)."""
    d = props.shape[1]
    agree = torch.cumprod((preds[:, :d] == props).to(torch.int64), dim=1)
    return agree.sum(dim=1)


def speculative_sample(lgp, props, seeds, kbase):
    """The accept / resample arithmetic of speculative SAMPLING, on
    tensors: ``lgp`` (B, d + 1, V) are the target's PROCESSED logits
    (temperature, top-k, top-p applied) after each chunk position,
    ``props`` (B, d) the draft's proposals (its argmax — a delta proposal,
    so ``min(1, p / q)`` reduces to ``p(token)``), ``seeds`` / ``kbase``
    (B,) each request's seed and the counter of its next commit. The token
    committed at stream offset j uses counter ``kbase + j`` (the lockstep
    sampler's discipline, as row 0 of the request's key stream) for two
    domain-separated draws: the acceptance uniform ``u < p(proposal)`` and
    a Gumbel-max draw from the RESIDUAL (the proposal masked to ``-inf``);
    position d, which has no proposal, draws from the full processed
    distribution. Returns ((B, d + 1) tokens, (B,) accepted counts): the
    round commits ``tokens[:, :a + 1]`` — provably the target's
    per-position sampling distribution."""
    B, nd, vocab = lgp.shape
    d = nd - 1
    counters = (kbase[:, None]
                + torch.arange(nd, device=lgp.device)[None, :]).reshape(-1)
    seeds_r = seeds.repeat_interleave(nd)
    rows0 = torch.zeros_like(seeds_r)
    u = uniform_draw(seeds_r, rows0, counters, _SALT_ACCEPT).reshape(B, nd)
    p_prop = torch.gather(
        torch.log_softmax(lgp[:, :d], dim=-1), 2, props[:, :, None]
    )[..., 0]  # (B, d): log p_target(proposal_j)
    ok = u[:, :d] < torch.exp(p_prop)
    cum = torch.cumprod(ok.to(torch.int64), dim=1)
    acc = cum.sum(dim=1)
    # A proposal that is the only surviving token has p = 1, is always
    # accepted, and its empty residual is never read.
    res = lgp[:, :d].masked_fill(
        torch.arange(vocab, device=lgp.device)[None, None, :]
        == props[:, :, None], float("-inf"))
    g = gumbel_noise(seeds_r, rows0, counters, vocab, _SALT_RESAMPLE)
    alt = torch.argmax(
        torch.cat([res, lgp[:, d:]], dim=1) + g.reshape(B, nd, vocab), dim=-1)
    out = torch.cat(
        [torch.where(cum.bool(), props, alt[:, :d]), alt[:, d:]], dim=1)
    return out, acc


def _verify_accept(lm: TransformerLM, t0, dtoks, index, caches, d: int):
    """One verify-and-accept round of the single-request loop: build the
    (1, d + 1) chunk ``[t0, proposals]`` on the device, run
    ``verify_chunk``, reduce the agreeing prefix and return ONE packed
    (d + 2,) vector ``[a, preds_0 .. preds_d]`` plus the next round's
    device-resident carry (next token, next index)."""
    props = dtoks[:d].transpose(0, 1)  # (1, d)
    chunk = torch.cat([t0[:, None], props], dim=1)
    kc = d + 1
    pos = index + torch.arange(kc, device=t0.device)[None, :]
    x = lm.embed.embed_positions(chunk, pos)
    for block, (ck, cv) in zip(lm.blocks, caches):
        x, _, _ = block.verify_chunk(x, ck, cv, index)
    preds = torch.argmax(lm.head(x), dim=-1)  # (1, d + 1)
    a = accept_speculation(props, preds)
    packed = torch.cat([a, preds[0]])
    nxt = torch.gather(preds, 1, a[:, None])[:, 0]
    return packed, nxt, (index + a + 1).to(torch.int32)


@torch.no_grad()
def speculative_generate(lm: TransformerLM, prompt, steps: int,
                         draft_lm: TransformerLM, draft_k: int = 4,
                         eos_id: int | None = None,
                         return_stats: bool = False, draft_weights=None):
    """Greedy generation accelerated by a draft model; the output is
    token-for-token ``generate(lm, prompt, steps)`` (EOS-padded identically
    when ``eos_id`` is set), as a (1, steps) int32 numpy array.

    ``prompt`` (1, s0) ids. ``draft_lm`` must share the vocabulary; its
    quality only affects speed (the per-round acceptance), never the
    output. ``draft_weights`` optionally holds the draft's parameters
    quantized (``quantize_params(draft_lm.state_dict())``). With
    ``return_stats`` the array comes with {"rounds", "drafted", "accepted",
    "acceptance", "host_fetches"}; ``host_fetches`` counts every
    device->host transfer of the loop (one packed vector per round plus the
    prefill token: ``rounds + 1``)."""
    dev = lm.device
    prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(
        prompt) else prompt).to(dev, torch.int64)
    b, s0 = prompt.shape
    if b != 1:
        raise ValueError(
            f"speculative_generate is single-request (b=1), got b={b}; "
            "batched speculation lives in the continuous batcher "
            "(ContinuousBatcher(draft_lm=...))"
        )
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if draft_k < 1:
        raise ValueError(f"draft_k must be >= 1, got {draft_k}")
    if s0 + steps > lm.max_len:
        raise ValueError(
            f"prompt {s0} + steps {steps} exceeds max_len {lm.max_len}"
        )
    if s0 + steps > draft_lm.max_len:
        raise ValueError(
            f"prompt {s0} + steps {steps} exceeds draft max_len "
            f"{draft_lm.max_len}"
        )
    if draft_lm.vocab != lm.vocab:
        raise ValueError(
            f"draft vocab {draft_lm.vocab} != target vocab {lm.vocab}"
        )
    if draft_lm.device != dev:
        raise ValueError(
            f"draft on {draft_lm.device} but the target on {dev}")
    d = draft_k
    # draft_k + 1 slack: a round's chunk writes up to index + draft_k
    # positions, of which only the accepted prefix ever becomes live.
    first, caches = _prefill(lm, prompt, s0, lm.max_len + d + 1)
    with swapped_weights(draft_lm, draft_weights):
        _, dcaches = _prefill(draft_lm, prompt, s0, draft_lm.max_len + d + 1)

    fetches = 1  # the prefill token below
    emitted = [int(first[0])]
    tok_dev = first
    # One position cursor serves both models: their caches cover the same
    # committed stream.
    index_dev = torch.full((1,), s0, dtype=torch.int32, device=dev)
    rounds = drafted = accepted = 0
    while len(emitted) < steps:
        # d proposals plus one throwaway step, so the draft's own cache
        # covers every token the next round may start after.
        dtoks = draft_chunk(draft_lm, tok_dev, index_dev, dcaches, n=d + 1,
                            weights=draft_weights)
        packed, tok_dev, index_dev = _verify_accept(
            lm, tok_dev, dtoks, index_dev, caches, d)
        packed = packed.cpu().numpy()  # THE round's one device->host sync
        fetches += 1
        a = int(packed[0])
        new = [int(t) for t in packed[1: a + 2]]
        rounds += 1
        drafted += d
        accepted += a
        emitted.extend(new)
        if eos_id is not None and eos_id in new:
            break
    emitted = emitted[:steps]
    while len(emitted) < steps:
        emitted.append(eos_id)
    out = np.asarray(emitted, np.int32)[None, :]
    if eos_id is not None:
        # generate()'s convention: a finished row pads with EOS forever.
        hits = np.nonzero(out[0] == eos_id)[0]
        if hits.size:
            out[0, hits[0]:] = eos_id
    if return_stats:
        return out, {
            "rounds": rounds,
            "drafted": drafted,
            "accepted": accepted,
            "acceptance": accepted / drafted if drafted else 0.0,
            "host_fetches": fetches,
        }
    return out
