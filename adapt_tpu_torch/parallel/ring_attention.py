"""Ring attention: sequence parallelism for long contexts — the port of
``adapt_tpu/parallel/ring_attention.py``.

A sequence too long for one device is sharded over an ``sp`` mesh axis:
each rank holds a [S/P] slice of Q, K and V, the K/V blocks rotate around
the ring (:func:`ring_pass`, the port's ``lax.ppermute``) and each rank
accumulates its Q block's attention with the streaming (online-softmax)
update, so the S x S score matrix never materializes. Causal masking uses
global positions recovered from the ring step and the rank, so the result
matches single-device causal attention.

One process drives every rank, as it drives the shards of a tensor-parallel
mesh (``core/mesh``): rank r's blocks are tensors on its mesh entry's
device, and the entries may repeat (every rank names the one card). The
ring's transport is :func:`ring_pass` alone; a machine with several cards
would put a peer copy or a collective behind it, as behind
``parallel.sharding.reduce_shards``.
"""

from __future__ import annotations

import torch

from adapt_tpu_torch.ops.attention import (
    _wants_grad,
    attention_reference,
    flash_attention_with_lse,
)

_NEG_INF = -1e30


def ring_pass(blocks: list, devices: list) -> list:
    """THE ring hop: rank r's block handed to rank (r + 1) mod P, on that
    rank's device. After ``i`` hops rank r holds the block that originated
    at rank r - i (mod P). Blocks of ranks sharing a device move no
    bytes. A ``None`` block (a pipeline rank with nothing to send this
    tick) arrives as ``None``."""
    n = len(blocks)
    return [None if blocks[(r - 1) % n] is None
            else blocks[(r - 1) % n].to(devices[r]) for r in range(n)]


def _shards(x, devices, s_local: int) -> list:
    """Rank r's [r * s_local, (r + 1) * s_local) slice of the sequence axis
    (dim 2) on its device."""
    return [x[:, :, r * s_local:(r + 1) * s_local].to(d)
            for r, d in enumerate(devices)]


def _attention_block(q, k, v, mask, m, l, o, scale: float):
    """One online-softmax accumulation step, in the accumulators' dtype.

    q: [B, H, Sq, D]; k, v: [B, H, Skv, D]; mask: [Sq, Skv] additive.
    m, l: [B, H, Sq, 1]; o: [B, H, Sq, D].
    """
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(o.dtype), k.to(o.dtype)) * scale
    s = s + mask
    m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l_new = l * corr + torch.sum(p, dim=-1, keepdim=True)
    o_new = o * corr + torch.einsum("bhqk,bhkd->bhqd", p, v.to(o.dtype))
    return m_new, l_new, o_new


def stripe_sequence(x: torch.Tensor, num_ranks: int, axis: int = 2
                    ) -> torch.Tensor:
    """Permute a sequence axis into the STRIPED ring layout: rank r's shard
    holds tokens {r, r + P, r + 2P, ...} instead of a contiguous block.
    ``stripe(x)[..., r*s_local + i, ...] = x[..., i*P + r, ...]``. Apply to
    q/k/v before ``ring_attention(..., layout="striped")`` and
    :func:`unstripe_sequence` to the output."""
    s = x.shape[axis]
    if s % num_ranks:
        raise ValueError(f"sequence {s} not divisible by {num_ranks}")
    moved = x.movedim(axis, 0)
    rest = tuple(moved.shape[1:])
    parts = moved.reshape(s // num_ranks, num_ranks, *rest)
    return parts.transpose(0, 1).reshape(s, *rest).movedim(0, axis)


def unstripe_sequence(x: torch.Tensor, num_ranks: int, axis: int = 2
                      ) -> torch.Tensor:
    """Inverse of :func:`stripe_sequence`, which is striping by the
    complementary factor (out[i*P + r] = x[r*(S/P) + i] both ways), so one
    permutation body serves both."""
    s = x.shape[axis]
    if s % num_ranks:
        raise ValueError(f"sequence {s} not divisible by {num_ranks}")
    return stripe_sequence(x, s // num_ranks, axis)


def _positions(rank: int, s_local: int, num_ranks: int, striped: bool,
               device):
    local = torch.arange(s_local, device=device)
    return local * num_ranks + rank if striped else rank * s_local + local


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = False,
                   block_impl: str = "jnp", layout: str = "contiguous"):
    """Sequence-parallel attention over ``mesh``'s ``axis``.

    q, k, v: [B, H, S, D] global tensors with S divisible by the axis size;
    rank r computes on its [S/P] slice on its mesh entry's device, and the
    global output comes back on q's device.

    ``block_impl`` picks the per-rank block compute:

    - ``"jnp"`` (default) — the online-softmax update in plain tensor
      operations; differentiable through autograd (training and serving).
      Materializes one (S/P, S/P) score block per ring step. Its scores and
      accumulators are f32 for 16-bit inputs (the JAX package keeps the
      input dtype; in bf16 the rounding of o and l over the steps reached
      2.3e-2 of a unit-scale output) and the input dtype otherwise.
    - ``"flash"`` — K1 (``ops/attention.flash_attention_with_lse``) on
      every live block, the per-step results merged by logsumexp: the
      kernel on CUDA tensors, its plain version on CPU ones. FORWARD-ONLY:
      its backward raises a ``NotImplementedError`` naming ``block_impl``.
    - ``"auto"`` — ``"flash"`` on CUDA tensors when no gradient is wanted,
      ``"jnp"`` otherwise. The JAX package decides by a score-memory budget
      (``FLASH_SCORE_BYTES_BUDGET``), which the port does not carry: on the
      card K1 serves every size.

    ``layout`` is how global token positions map to ranks:

    - ``"contiguous"`` (default) — rank r holds tokens [r*S/P, (r+1)*S/P).
      Under ``causal`` the ring is load-imbalanced: rank 0's queries see
      only their own block, rank P-1's see everything. The flash path knows
      the dead steps (src > rank) on the host and launches nothing for
      them.
    - ``"striped"`` — rank r holds tokens {r, r+P, ...} (pre-permute q/k/v
      with :func:`stripe_sequence`, un-permute the output with
      :func:`unstripe_sequence`; this function's output is in striped
      order). Every causal ring step is then a triangular block with
      diagonal shift 0 (src <= rank) or 1 (src > rank): the flash path
      passes the shift to K1's ``causal_shift`` as a device int32 built
      once a call, and K1's tile skip does about half the work at every
      step on every rank.
    """
    num_ranks = int(mesh.shape[axis])
    seq = q.shape[2]
    if seq % num_ranks:
        raise ValueError(
            f"sequence {seq} not divisible by ring size {num_ranks}")
    if block_impl not in ("auto", "jnp", "flash"):
        raise ValueError(
            f"block_impl={block_impl!r}: expected 'auto', 'jnp' or 'flash'")
    if layout not in ("contiguous", "striped"):
        raise ValueError(
            f"layout={layout!r}: expected 'contiguous' or 'striped'")
    if block_impl == "auto":
        block_impl = ("flash" if q.is_cuda and not _wants_grad(q, k, v)
                      else "jnp")
    devices = mesh.axis_devices(axis)
    striped = layout == "striped"
    if block_impl == "flash":
        return _FlashRing.apply(q, k, v, devices, causal, striped)
    s_local = seq // num_ranks
    qs, ks, vs = (_shards(t, devices, s_local) for t in (q, k, v))
    b, h, _, d = q.shape
    acc = torch.promote_types(q.dtype, torch.float32)
    # 1 / sqrt(d) rounded as the JAX package rounds it: sqrt in f32, then
    # the accumulators' dtype (a host value: a ring step stages nothing).
    scale = float(1.0 / torch.sqrt(torch.tensor(float(d))).to(acc))
    m = [torch.full((b, h, s_local, 1), _NEG_INF, dtype=acc, device=dv)
         for dv in devices]
    l = [torch.zeros((b, h, s_local, 1), dtype=acc, device=dv)
         for dv in devices]
    o = [torch.zeros((b, h, s_local, d), dtype=acc, device=dv)
         for dv in devices]
    k_cur, v_cur = ks, vs
    for i in range(num_ranks):
        for r, dv in enumerate(devices):
            src = (r - i) % num_ranks
            if causal:
                q_pos = _positions(r, s_local, num_ranks, striped, dv)
                kv_pos = _positions(src, s_local, num_ranks, striped, dv)
                mask = torch.where(q_pos[:, None] >= kv_pos[None, :], 0.0,
                                   _NEG_INF).to(acc)
            else:
                mask = torch.zeros((s_local, s_local), dtype=acc, device=dv)
            m[r], l[r], o[r] = _attention_block(qs[r], k_cur[r], v_cur[r],
                                                mask, m[r], l[r], o[r],
                                                scale)
        if i < num_ranks - 1:
            k_cur, v_cur = ring_pass(k_cur, devices), ring_pass(v_cur, devices)
    return torch.cat([(o[r] / torch.clamp(l[r], min=1e-20)).to(
        q.dtype).to(q.device) for r in range(num_ranks)], dim=2)


class _FlashRing(torch.autograd.Function):
    """The flash ring as an autograd node whose backward raises: the JAX
    package's ``custom_vjp`` around ``_ring_attention_flash``, so that
    differentiating fails at this boundary with a message naming
    ``block_impl``."""

    @staticmethod
    def forward(ctx, q, k, v, devices, causal, striped):
        return _ring_attention_flash(q, k, v, devices, causal, striped)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "ring_attention block_impl='flash' (including 'auto' resolving "
            "to flash on CUDA tensors) is forward-only: K1's lse entry "
            "point has no VJP. Use block_impl='jnp' for training.")


def _ring_attention_flash(q, k, v, devices, causal, striped):
    """Ring attention whose per-rank block compute is K1; per-step
    normalized results combine exactly by the logsumexp merge (see
    ``flash_attention_with_lse``).

    Under causal masking every (rank, step) block of the contiguous layout
    is all or nothing except the diagonal: the K/V block that originated at
    ``src`` is fully visible when ``src < rank``, fully masked when ``src >
    rank`` and plain causal at step 0. The host knows which, so a dead step
    launches nothing (the JAX package's SPMD ring pays the kernel on its
    dead steps too: its ``lax.cond`` runs both branches). A dead step's
    merge would be the identity (weight exp(-1e30 - lse) = 0), so skipping
    it leaves every value as it was. The striped layout's steps are all
    shift-0/1 triangles and all launch."""
    num_ranks = len(devices)
    s_local = q.shape[2] // num_ranks
    qs, ks, vs = (_shards(t, devices, s_local) for t in (q, k, v))
    # The diagonal shifts of the striped ring, one device int32 each per
    # device, made once: a ring step stages nothing to the device.
    shifts = {}
    if causal and striped:
        for dv in dict.fromkeys(devices):
            shifts[dv] = (torch.zeros((), dtype=torch.int32, device=dv),
                          torch.ones((), dtype=torch.int32, device=dv))
    o, lse = [], []
    for r in range(num_ranks):
        o0, l0 = flash_attention_with_lse(qs[r], ks[r], vs[r], causal=causal)
        o.append(o0.float())
        lse.append(l0)
    k_cur, v_cur = ks, vs
    for i in range(1, num_ranks):
        k_cur, v_cur = ring_pass(k_cur, devices), ring_pass(v_cur, devices)
        for r, dv in enumerate(devices):
            src = (r - i) % num_ranks
            if causal and striped:
                o_j, lse_j = flash_attention_with_lse(
                    qs[r], k_cur[r], v_cur[r], causal=True,
                    causal_shift=shifts[dv][int(src > r)])
            elif causal and src > r:
                continue  # dead: fully masked, nothing to merge
            else:
                o_j, lse_j = flash_attention_with_lse(
                    qs[r], k_cur[r], v_cur[r], causal=False)
            mx = torch.maximum(lse[r], lse_j)
            w_a = torch.exp(lse[r] - mx)
            w_b = torch.exp(lse_j - mx)
            denom = w_a + w_b
            o[r] = (o[r] * w_a[..., None] + o_j.float() * w_b[..., None]
                    ) / denom[..., None]
            lse[r] = mx + torch.log(denom)
    return torch.cat([t.to(q.dtype).to(q.device) for t in o], dim=2)


def full_attention(q, k, v, causal: bool = False):
    """Single-device oracle: the one canonical reference in
    :mod:`adapt_tpu_torch.ops.attention` (absolute position i attends j <=
    i)."""
    return attention_reference(q, k, v, causal=causal)


__all__ = ["full_attention", "ring_attention", "ring_pass",
           "stripe_sequence", "unstripe_sequence"]
