"""Decoder-only transformer LM with KV-cache decoding — the port of
``adapt_tpu/models/transformer_lm.py`` (dense or mixture-of-experts
blocks; MHA with a fused ``qkv`` projection, or GQA with ``q`` + ``kv``;
learned or rotary positions; sliding window).

The model is an ``nn.Module`` whose submodules carry the JAX graph's node
names (``embed``, ``decoder_block_{i}``, ``head``), so ``convert.from_flax``
maps a flax ``variables`` tree onto its ``state_dict`` by name. Seven
schedules share one set of weights: the full causal forward
(:func:`logits_full`), ``prefill`` (K1 on CUDA), the cached
``decode_step`` over dense strips (K2), over a paged pool
``decode_step_paged`` (K3) and the chunk pass ``prefill_chunk_paged``
(K4), and the speculative verify passes ``verify_chunk`` (dense strips,
plain tensor operations as in the JAX package) and ``verify_chunk_paged``
(K5). A KV cache is a tensor or a quantized ``(values, scales)`` pair
(``ops/quantize``: int8, or int4 packed two per byte, with one f32 scale
per vector); every cache write quantizes through one definition
(:meth:`CausalSelfAttention._write_kv_pair`) and the kernels read the
quantized bytes (K2q, K3q, K4q). flax's numerics are kept: LayerNorm with
eps 1e-6 and f32 statistics, tanh-approximate GELU, logits in f32, rotary
embedding in f32.

Sampling keys cannot be JAX's threefry. A token is drawn by Gumbel-max
from a counter-based hash keyed by ``(seed, row, t)`` — request seed,
batch row, token index — computed with batched integer tensor ops on the
device. :func:`generate` keys row ``i`` as ``(seed, i, t)`` and the
continuous batcher keys every request as row 0, so a request's stream
through the batcher equals :func:`generate` for it alone.

Batch invariance. A request's arithmetic must not depend on its company,
or greedy streams split at near-ties. On the card the matmul kernel (and
so its summation order) is picked by shape, so :func:`generate` prefills
the prompt right-padded to the batcher's power-of-two bucket and decodes
with its rows padded to a multiple of ``ROW_QUANTUM``: a prompt alone
then runs the same shapes as in an 8-slot batcher. K1 and K2 themselves
compute each row from its own tiles, whatever the batch or strip length.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adapt_tpu_torch import resolve_device
from adapt_tpu_torch.ops.attention import flash_attention
from adapt_tpu_torch.ops.decode_attention import (
    _row_index,
    append_kv,
    decode_attention,
    verify_attention,
)
from adapt_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_chunk_attention,
    paged_verify_attention,
    pool_values,
)
from adapt_tpu_torch.models.moe import MoEDecoderMlp
from adapt_tpu_torch.ops.quantize import quantize_kv_vectors

#: Decode row count is rounded up to a multiple of this (see module doc).
ROW_QUANTUM = 8


# -- sampling ----------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix32(x):
    """32-bit integer finaliser on int64 tensors holding values < 2**32
    (multipliers < 2**31, so products never leave int64)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x446CA68B) & _M32
    return x ^ (x >> 16)


def _row_keys(seeds, rows, counters):
    """(n,) int64 seeds/rows/counters -> (n,) 32-bit keys."""
    k = _mix32((seeds & _M32) ^ 0x9E3779B9)
    k = _mix32(k ^ ((seeds >> 32) & _M32))
    k = _mix32(k ^ (rows & _M32))
    return _mix32(k ^ (counters & _M32))


def _salted(key, salt: int):
    """A domain-separated key stream off the same (seed, row, t)."""
    return _mix32(key ^ salt) if salt else key


def uniform_draw(seeds, rows, counters, salt: int = 0):
    """(n,) f32 uniforms in (0, 1), a pure function of (seed, row, t) and
    the ``salt`` that separates this draw from the others off the key."""
    h = _mix32(_salted(_row_keys(seeds, rows, counters), salt) ^ 0x2545F491)
    return ((h >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)


def gumbel_noise(seeds, rows, counters, vocab: int, salt: int = 0):
    """(n, vocab) f32 Gumbel noise, a pure function of (seed, row, t,
    column): the same on any batch that holds the row. A non-zero ``salt``
    gives an independent stream off the same key."""
    key = _salted(_row_keys(seeds, rows, counters), salt)
    cols = _mix32(torch.arange(vocab, device=key.device) ^ 0x632BE5AB)
    h = _mix32(key[:, None] ^ cols[None, :])
    u = ((h >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)  # (0, 1)
    return -torch.log(-torch.log(u))


def chosen_logprob(logits, tokens):
    """log-softmax of the RAW pre-temperature logits at the chosen token:
    logits (n, V), tokens (n,) -> (n,) f32."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, 1, tokens.reshape(-1, 1).long())[:, 0]


def truncate_rows(lg, top_ks):
    """Per-row top-k with a tensor k: keep logits >= the k-th largest
    (k == V keeps everything)."""
    v = lg.shape[-1]
    sorted_lg = torch.sort(lg, dim=-1).values  # ascending
    idx = torch.clamp(v - top_ks.long(), 0, v - 1)
    kth = torch.gather(sorted_lg, 1, idx[:, None])
    return torch.where(lg >= kth, lg, float("-inf"))


def nucleus_filter(lg, top_p):
    """Top-p truncation: keep the smallest descending-probability prefix
    whose mass reaches ``top_p`` (crossing token included; p >= 1 is an
    exact identity). ``top_p`` is a float or (n,)."""
    sorted_desc = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    p = torch.as_tensor(top_p, dtype=torch.float32, device=lg.device)
    if p.ndim:
        p = p[:, None]
    keep = ((cum - probs) < p) | (p >= 1.0)
    kth = torch.amin(
        torch.where(keep, sorted_desc, float("inf")), dim=-1, keepdim=True
    )
    return torch.where(lg >= kth, lg, float("-inf"))


def sample_rows(logits, temps, top_ks, top_ps, seeds, rows, counters, *,
                do_sample, truncate, nucleus):
    """THE token pick of :func:`generate` and the batcher: per row, argmax
    where ``temps == 0``; else Gumbel-max over ``logits / temp`` after the
    row's top-k then top-p. ``do_sample``/``truncate``/``nucleus`` only
    skip work no row needs (identity knobs leave a row unchanged)."""
    pick_greedy = torch.argmax(logits, dim=-1)
    if not do_sample:
        return pick_greedy
    lg = logits / torch.clamp(temps, min=1e-6)[:, None]
    if truncate:
        lg = truncate_rows(lg, top_ks)
    if nucleus:
        lg = nucleus_filter(lg, top_ps)
    g = gumbel_noise(seeds, rows, counters, lg.shape[-1])
    sampled = torch.argmax(lg + g, dim=-1)
    return torch.where(temps == 0.0, pick_greedy, sampled)


def sample_next_tokens(logits, seed, step, temperature, *, do_sample, top_k,
                       top_p=None, row_offset=0):
    """logits (n, V) -> (n,) ids for token index ``step``: greedy argmax,
    or a draw keyed by ``(seed, row_offset + i, step)`` per row."""
    n, v = logits.shape
    dev = logits.device
    full = lambda x, dt: torch.full((n,), x, dtype=dt, device=dev)  # noqa
    return sample_rows(
        logits, full(float(temperature), torch.float32),
        full(top_k if top_k is not None else v, torch.int64),
        full(1.0 if top_p is None else float(top_p), torch.float32),
        full(int(seed), torch.int64),
        row_offset + torch.arange(n, device=dev), full(int(step), torch.int64),
        do_sample=do_sample, truncate=top_k is not None,
        nucleus=top_p is not None,
    )


# -- layers ------------------------------------------------------------------


def map_cache(fn, cache):
    """Apply ``fn`` to a cache tensor, or to each member of a quantized
    ``(values, scales)`` pair (returning a pair)."""
    if isinstance(cache, tuple):
        return tuple(fn(m) for m in cache)
    return fn(cache)


def apply_rope(x, positions, base: float = 10000.0):
    """Rotary embedding over (b, heads, s, hd) with ``positions`` (s,)
    shared or (b, s) per row; rotate-half, computed in f32."""
    hd = x.shape[-1]
    half = hd // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = torch.pow(torch.tensor(base, dtype=torch.float32), -ar / half)
    pos = torch.as_tensor(positions, device=x.device).to(torch.float32)
    if pos.ndim == 1:
        angles = pos[None, :, None] * freqs
    else:
        angles = pos[:, :, None] * freqs
    cos = torch.cos(angles)[:, None]
    sin = torch.sin(angles)[:, None]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).to(
        x.dtype
    )


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: eps 1e-6, f32 statistics with the fast
    variance (``E[x^2] - E[x]^2``), f32 scale/bias, output in ``dtype``."""

    def __init__(self, dim, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0)
        y = (xf - mu) * (torch.rsqrt(var + 1e-6) * self.scale) + self.bias
        return y.to(self.dtype)


class CausalSelfAttention(nn.Module):
    """Causal MHA/GQA sharing weights between the full-sequence path (K1)
    and the cached decode path (K2). Query head ``i`` uses KV head
    ``i // group``; decode folds each group into query rows against the
    un-repeated (b, kv_h, L, hd) cache."""

    def __init__(self, dim, heads, dtype=torch.float32, kv_heads=None,
                 window=None, rope=False, device=None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"model dim {dim} not divisible by {heads} heads")
        if rope and (dim // heads) % 2:
            raise ValueError(f"rope needs an even head_dim, got {dim // heads}")
        if kv_heads is not None:
            if not 1 <= kv_heads <= heads:
                raise ValueError(f"kv_heads {kv_heads} outside [1, heads={heads}]")
            if heads % kv_heads:
                raise ValueError(
                    f"heads {heads} not divisible by kv_heads {kv_heads}"
                )
        self.dim, self.heads, self.kv_heads = dim, heads, kv_heads
        self.window, self.rope, self.dtype = window, rope, dtype
        hd = dim // heads
        kw = dict(dtype=dtype, device=device)
        if self._group == 1:
            self.qkv = nn.Linear(dim, 3 * heads * hd, **kw)
        else:
            self.q = nn.Linear(dim, heads * hd, **kw)
            self.kv = nn.Linear(dim, 2 * kv_heads * hd, **kw)
        self.out = nn.Linear(dim, dim, **kw)

    @property
    def _group(self) -> int:
        return self.heads // (self.kv_heads or self.heads)

    @property
    def cache_heads(self) -> int:
        return self.kv_heads or self.heads

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    def _project(self, x):
        """-> q (b, h, s, hd); k, v (b, kv_h, s, hd)."""
        b, s, _ = x.shape
        hd = self.head_dim
        if self._group == 1:
            q, k, v = self.qkv(x).view(b, s, 3, self.heads, hd).unbind(2)
        else:
            q = self.q(x).view(b, s, self.heads, hd)
            k, v = self.kv(x).view(b, s, 2, self.kv_heads, hd).unbind(2)
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def _repeat_kv(self, t):
        g = self._group
        return t if g == 1 else torch.repeat_interleave(t, g, dim=1)

    def _group_q(self, q):
        b, h, s, hd = q.shape
        g = self._group
        return q.reshape(b, h // g, g * s, hd)

    def _ungroup_o(self, o, s):
        b, kvh, gs, hd = o.shape
        return o.reshape(b, kvh * (gs // s), s, hd)

    def _rope_qk(self, q, k, positions):
        if not self.rope:
            return q, k
        return apply_rope(q, positions), apply_rope(k, positions)

    def forward(self, x):
        b, s, d = x.shape
        q, k, v = self._project(x)
        q, k = self._rope_qk(q, k, torch.arange(s, device=x.device))
        o = flash_attention(
            q, self._repeat_kv(k), self._repeat_kv(v), causal=True,
            window=self.window,
        )
        return self.out(o.transpose(1, 2).reshape(b, s, d))

    def _window_from(self, index, b, valid_from):
        """Effective ``valid_from`` of cached decode under a sliding
        window (max-composed with ragged left padding)."""
        if self.window is None:
            return valid_from
        idx = _row_index(index, b, self.out.weight.device)
        w_from = torch.clamp(idx - self.window + 1, min=0)
        if valid_from is not None:
            w_from = torch.maximum(w_from, torch.as_tensor(
                valid_from, device=w_from.device).to(w_from.dtype))
        return w_from

    def _write_kv_pair(self, cache_k, cache_v, k, v, write):
        """THE cache write: a quantized ``(values, scales)`` cache
        quantizes ``k``/``v`` with the shared absmax scheme and applies
        ``write(member, new)`` to both members; a native cache is written
        directly. The value member's width decides the dtype: ``head_dim
        // 2`` is packed int4. ``write`` is each call site's own primitive
        (strip append, page scatter, chunk scatter)."""
        if isinstance(cache_k, tuple):
            dt = "int4" if cache_k[0].shape[-1] * 2 == k.shape[-1] else "int8"
            kq, ks = quantize_kv_vectors(k, dt)
            vq, vs = quantize_kv_vectors(v, dt)
            return ((write(cache_k[0], kq), write(cache_k[1], ks)),
                    (write(cache_v[0], vq), write(cache_v[1], vs)))
        return write(cache_k, k), write(cache_v, v)

    def prefill(self, x, max_len: int, valid_from=None, quantize_cache=False):
        """Full causal attention over the prompt; returns the output and
        K/V caches padded to ``max_len``. ``valid_from`` (b,) masks each
        row's left padding. ``quantize_cache`` (``"int8"`` or True, or
        ``"int4"``) returns the caches as ``(values, scales)`` pairs,
        quantized after the native attention."""
        b, s, d = x.shape
        q, k, v = self._project(x)
        pos = torch.arange(s, device=x.device)
        if valid_from is not None:
            pos = pos[None, :] - torch.as_tensor(
                valid_from, device=x.device)[:, None]
        q, k = self._rope_qk(q, k, pos)
        o = flash_attention(
            q, self._repeat_kv(k), self._repeat_kv(v), causal=True,
            valid_from=valid_from, window=self.window,
        )
        out = self.out(o.transpose(1, 2).reshape(b, s, d))
        pad = (0, 0, 0, max_len - s)
        if quantize_cache:
            dt = "int4" if quantize_cache == "int4" else "int8"
            k, v = quantize_kv_vectors(k, dt), quantize_kv_vectors(v, dt)
        return (out, map_cache(lambda t: F.pad(t, pad), k),
                map_cache(lambda t: F.pad(t, pad), v))

    def decode_step(self, x_t, cache_k, cache_v, index, valid_from=None,
                    quantized=False, attn_impl=None, split=None):
        """One token: write its K/V at ``index`` (in place — the caches are
        updated and returned; a quantized pair quantizes first), attend its
        q over the cache."""
        del quantized
        b = x_t.shape[0]
        q, k, v = self._project(x_t)
        if self.rope:
            logical = _row_index(index, b, x_t.device)
            if valid_from is not None:
                logical = logical - torch.as_tensor(
                    valid_from, device=x_t.device)
            q, k = self._rope_qk(q, k, logical[:, None])
        q = self._group_q(q)
        cache_k, cache_v = self._write_kv_pair(
            cache_k, cache_v, k, v, lambda c, t: append_kv(c, t, index))
        o = decode_attention(
            q, cache_k, cache_v, index,
            self._window_from(index, b, valid_from), prefer=attn_impl,
            split=split,
        ).to(x_t.dtype)
        o = self._ungroup_o(o, 1).transpose(1, 2).reshape(b, 1, self.dim)
        return self.out(o), cache_k, cache_v

    def decode_step_paged(self, x_t, k_pool, v_pool, page_table, index,
                          valid_from=None, attn_impl=None, split=None):
        """One token against a PAGED cache: write this step's K/V in place
        into the slot's physical page at ``index``'s (page, offset), then
        attend over the table-mapped window (K3 on CUDA). Pools are
        (num_pages, kv_h, P, hd) or quantized pairs of them;
        ``page_table`` (b, pages_per_slot) int32. A negative ``index`` is a
        dead row (an idle or mid-prefill slot): its write goes to trash page 0 — never ``table[row, 0]``,
        which a prefilling row owns — and attention masks every position;
        so does a position past the table (a finished request's garbage
        tail)."""
        b = x_t.shape[0]
        page = pool_values(k_pool).shape[2]
        width = page_table.shape[1] * page
        q, k, v = self._project(x_t)
        idx = _row_index(index, b, x_t.device)
        if self.rope:
            logical = idx
            if valid_from is not None:
                logical = idx - torch.as_tensor(valid_from, device=x_t.device)
            q, k = self._rope_qk(q, k, logical[:, None])
        q = self._group_q(q)
        # Clamp BEFORE the gather: a negative index is a device assert in
        # a CUDA gather (JAX clamps out-of-range gathers).
        live_row = (idx >= 0) & (idx < width)
        safe = torch.clamp(idx, 0, width - 1).long()
        phys = torch.gather(page_table, 1, (safe // page)[:, None])[:, 0]
        phys = torch.where(live_row, phys.long(), 0)
        # Pool rows (phys[i], h, safe[i] % page) <- token i's head h, one
        # index_copy_ into the (pages * kv_h * page, width) view of each
        # pool (an indexed setitem costs the host several times more). Dead
        # rows all land on the trash page, unordered (never accumulate).
        kvh = k.shape[1]
        heads = torch.arange(kvh, device=x_t.device)
        rows = ((phys[:, None] * kvh + heads) * page
                + (safe % page)[:, None]).reshape(-1)

        def write(pool, t):
            w = pool.shape[-1]
            return pool.view(-1, w).index_copy_(
                0, rows, t[:, :, 0, :].reshape(-1, w).to(pool.dtype))

        self._write_kv_pair(k_pool, v_pool, k, v, write)
        o = paged_attention(
            q, k_pool, v_pool, page_table, idx,
            self._window_from(idx, b, valid_from), prefer=attn_impl,
            split=split,
        ).to(x_t.dtype)
        o = self._ungroup_o(o, 1).transpose(1, 2).reshape(b, 1, self.dim)
        return self.out(o), k_pool, v_pool

    def prefill_chunk_paged(self, x, k_pool, v_pool, pages, pos0: int,
                            attn_impl=None):
        """Incremental prefill of a CHUNK of positions [pos0, pos0 + C)
        directly against a paged window: write the chunk's K/V in place
        into its own pages (one scatter), then attend the whole window
        page by page (K4 on CUDA) — no gathered strip. ``pages`` (n,)
        covers [0, pos0 + C) (pow2 trash padding allowed); ``pos0`` (a
        host int) is page-aligned and C a whole number of pages. Batch 1.
        The model's ``window`` bands the chunk's rows."""
        b, c, _ = x.shape
        page = pool_values(k_pool).shape[2]
        q, k, v = self._project(x)
        q, k = self._rope_qk(q, k, pos0 + torch.arange(c, device=x.device))
        q = self._group_q(q)
        n_chunk = c // page
        pages_t = torch.as_tensor(pages, device=x.device).long().reshape(-1)
        chunk_pages = pages_t[pos0 // page: pos0 // page + n_chunk]
        kvh = k.shape[1]

        def write(pool, t):
            return pool.index_copy_(0, chunk_pages, t[0].reshape(
                kvh, n_chunk, page, t.shape[3]).transpose(0, 1).to(pool.dtype))

        # A quantized pass quantizes its chunk, then attends the already
        # quantized window, as the JAX package's pass does.
        self._write_kv_pair(k_pool, v_pool, k, v, write)
        o = paged_chunk_attention(
            q, k_pool, v_pool, pages, pos0, c, prefer=attn_impl,
            window=self.window,
        ).to(x.dtype)
        o = self._ungroup_o(o, c).transpose(1, 2).reshape(b, c, self.dim)
        return self.out(o), k_pool, v_pool


    def _verify_offsets(self, kc, tree_tail, device):
        """Logical offsets of a verify chunk's rows: chain rows at their
        own, tree leaves sharing the position after the chain."""
        offs = torch.arange(kc, device=device)
        return torch.clamp(offs, max=kc - tree_tail) if tree_tail else offs

    def verify_chunk(self, x, cache_k, cache_v, index, tree_tail=0):
        """Append a CHUNK of K tokens at positions ``index .. index + K -
        1`` in one cached pass — the speculative verify primitive over
        dense strips: row t attends the cache up to ``index + t``, so the
        K outputs equal K sequential ``decode_step`` calls. ``index`` is a
        scalar or (b,) (each slot at its own position; a negative row is
        dead). One ``append_kv`` scatter writes the chunk (quantized pairs
        quantize first); rejected suffixes need no rollback, the position
        mask never admits them. ``tree_tail`` = w marks the last w rows as
        tree leaves: they embed / rotate at the shared logical position
        ``index + K - w``, write at their own physical slots ``index +
        row`` and attend the chain plus themselves only."""
        b, kc, _ = x.shape
        q, k, v = self._project(x)
        if self.rope:
            offs = self._verify_offsets(kc, tree_tail, x.device)
            pos = _row_index(index, b, x.device)[:, None] + offs[None, :]
            q, k = self._rope_qk(q, k, pos)
        q = self._group_q(q)
        cache_k, cache_v = self._write_kv_pair(
            cache_k, cache_v, k, v, lambda c, t: append_kv(c, t, index))
        o = verify_attention(
            q, cache_k, cache_v, index, kc, window=self.window,
            tree_tail=tree_tail,
        ).to(x.dtype)
        o = self._ungroup_o(o, kc).transpose(1, 2).reshape(b, kc, self.dim)
        return self.out(o), cache_k, cache_v

    def verify_chunk_paged(self, x, k_pool, v_pool, page_table, index,
                           attn_impl=None, tree_tail=0, split=None):
        """Batched verify over a PAGED cache: scatter each slot's K chunk
        tokens into its own pages at ``index[b] .. index[b] + K - 1`` (one
        table-mapped scatter), then attend each row's paged window up to
        its own diagonal (K5 on CUDA). ``index`` (b,); a negative row is
        dead (an idle or mid-prefill slot): its writes go to trash page 0
        and its positions all mask. Quantized pools scatter the chunk's
        quantized K/V into both members. ``tree_tail`` as in
        :meth:`verify_chunk`."""
        b, kc, _ = x.shape
        page = pool_values(k_pool).shape[2]
        pps = page_table.shape[1]
        q, k, v = self._project(x)
        idx = _row_index(index, b, x.device)
        if self.rope:
            offs = self._verify_offsets(kc, tree_tail, x.device)
            q, k = self._rope_qk(q, k, idx[:, None] + offs[None, :])
        q = self._group_q(q)
        live_row = idx >= 0
        pos = (torch.clamp(idx, min=0)[:, None]
               + torch.arange(kc, device=x.device)[None, :]).long()
        # Clamp BEFORE the gather, as decode_step_paged does.
        phys = torch.gather(page_table, 1,
                            torch.clamp(pos // page, max=pps - 1))
        phys = torch.where(live_row[:, None], phys.long(), 0)  # dead -> trash
        kvh = k.shape[1]
        heads = torch.arange(kvh, device=x.device)
        # Pool rows (phys[b, t], h, pos[b, t] % page) <- token t of slot b.
        rows = ((phys[:, :, None] * kvh + heads) * page
                + (pos % page)[:, :, None]).reshape(-1)

        def write(pool, t):
            w = pool.shape[-1]
            return pool.view(-1, w).index_copy_(
                0, rows, t.transpose(1, 2).reshape(-1, w).to(pool.dtype))

        self._write_kv_pair(k_pool, v_pool, k, v, write)
        o = paged_verify_attention(
            q, k_pool, v_pool, page_table, idx, kc, prefer=attn_impl,
            window=self.window, tree_tail=tree_tail, split=split,
        ).to(x.dtype)
        o = self._ungroup_o(o, kc).transpose(1, 2).reshape(b, kc, self.dim)
        return self.out(o), k_pool, v_pool


class DecoderBlock(nn.Module):
    """Pre-LN decoder block: the dense GELU MLP, or with ``moe_experts`` a
    dropless per-token mixture of that many experts (``moe_top_k`` active
    a token, ``mlp_dim`` each; ``models/moe.MoEDecoderMlp``), which every
    schedule serves with the dense block's cache parity."""

    def __init__(self, dim, heads, mlp_dim, dtype=torch.float32,
                 kv_heads=None, moe_experts=None, moe_top_k=1, window=None,
                 rope=False, device=None):
        super().__init__()
        self.dim, self.heads, self.mlp_dim = dim, heads, mlp_dim
        self.kv_heads = kv_heads
        kw = dict(dtype=dtype, device=device)
        self.ln1 = LayerNorm(dim, dtype, device)
        self.attn = CausalSelfAttention(
            dim, heads, dtype, kv_heads, window, rope, device
        )
        self.ln2 = LayerNorm(dim, dtype, device)
        self.moe_experts = moe_experts
        if moe_experts is not None:
            self.moe = MoEDecoderMlp(dim, moe_experts, mlp_dim, moe_top_k,
                                     dtype, device)
        else:
            self.mlp_in = nn.Linear(dim, mlp_dim, **kw)
            self.mlp_out = nn.Linear(mlp_dim, dim, **kw)

    @property
    def cache_heads(self) -> int:
        return self.kv_heads or self.heads

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    def _mlp(self, x):
        if self.moe_experts is not None:
            return self.moe(x)
        return self.mlp_out(F.gelu(self.mlp_in(x), approximate="tanh"))

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self._mlp(self.ln2(x))

    def prefill(self, x, max_len, valid_from=None, quantize_cache=False):
        a, ck, cv = self.attn.prefill(
            self.ln1(x), max_len, valid_from, quantize_cache
        )
        x = x + a
        return x + self._mlp(self.ln2(x)), ck, cv

    def decode_step(self, x_t, cache_k, cache_v, index, valid_from=None,
                    quantized=False, attn_impl=None, split=None):
        a, ck, cv = self.attn.decode_step(
            self.ln1(x_t), cache_k, cache_v, index, valid_from, quantized,
            attn_impl, split,
        )
        x_t = x_t + a
        return x_t + self._mlp(self.ln2(x_t)), ck, cv

    def decode_step_paged(self, x_t, k_pool, v_pool, page_table, index,
                          valid_from=None, attn_impl=None, split=None):
        a, kp, vp = self.attn.decode_step_paged(
            self.ln1(x_t), k_pool, v_pool, page_table, index, valid_from,
            attn_impl, split,
        )
        x_t = x_t + a
        return x_t + self._mlp(self.ln2(x_t)), kp, vp

    def prefill_chunk_paged(self, x, k_pool, v_pool, pages, pos0,
                            attn_impl=None):
        a, kp, vp = self.attn.prefill_chunk_paged(
            self.ln1(x), k_pool, v_pool, pages, pos0, attn_impl
        )
        x = x + a
        return x + self._mlp(self.ln2(x)), kp, vp


    def verify_chunk(self, x, cache_k, cache_v, index, tree_tail=0):
        a, ck, cv = self.attn.verify_chunk(
            self.ln1(x), cache_k, cache_v, index, tree_tail
        )
        x = x + a
        return x + self._mlp(self.ln2(x)), ck, cv

    def verify_chunk_paged(self, x, k_pool, v_pool, page_table, index,
                           attn_impl=None, tree_tail=0, split=None):
        a, kp, vp = self.attn.verify_chunk_paged(
            self.ln1(x), k_pool, v_pool, page_table, index, attn_impl,
            tree_tail, split,
        )
        x = x + a
        return x + self._mlp(self.ln2(x)), kp, vp


class TokenEmbed(nn.Module):
    """Token + (optionally) learned positional embeddings. Position ids
    clamp to ``[0, max_len - 1]`` (JAX clamps out-of-range gathers; an
    unclamped index is a device assert in CUDA — the batcher's trash row
    sits at ``max_len``)."""

    def __init__(self, vocab, dim, max_len, dtype=torch.float32,
                 use_pos=True, device=None):
        super().__init__()
        self.max_len, self.dtype, self.use_pos = max_len, dtype, use_pos
        self.tok = nn.Embedding(vocab, dim, dtype=dtype, device=device)
        if use_pos:
            self.pos_embed = nn.Parameter(
                torch.zeros(max_len, dim, device=device)
            )

    def forward(self, ids):
        out = self.tok(ids)
        if self.use_pos:
            out = out + self.pos_embed[: ids.shape[1]].to(self.dtype)
        return out

    def embed_at(self, ids_t, index):
        out = self.tok(ids_t)
        if self.use_pos:
            i = min(max(int(index), 0), self.max_len - 1)
            out = out + self.pos_embed[i:i + 1].to(self.dtype)
        return out

    def embed_positions(self, ids, pos_ids):
        out = self.tok(ids)
        if self.use_pos:
            p = torch.clamp(pos_ids.long(), 0, self.max_len - 1)
            out = out + self.pos_embed[p].to(self.dtype)
        return out


class LMHead(nn.Module):
    """Final LN + vocab projection, logits in f32."""

    def __init__(self, vocab, dim, dtype=torch.float32, device=None):
        super().__init__()
        self.vocab = vocab
        self.ln = LayerNorm(dim, dtype, device)
        self.logits = nn.Linear(dim, vocab, dtype=torch.float32, device=device)

    def forward(self, x):
        return self.logits(self.ln(x).float())


class TransformerLM(nn.Module):
    """A built LM: ``embed``, ``decoder_block_{i}``, ``head``."""

    def __init__(self, vocab, dim, depth, heads, mlp_dim, max_len=1024,
                 dtype=torch.float32, name="transformer_lm", kv_heads=None,
                 moe_experts=None, moe_top_k=1, window=None, pos="learned",
                 device=None):
        super().__init__()
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if pos not in ("learned", "rope"):
            raise ValueError(f"pos={pos!r}: expected 'learned' or 'rope'")
        rope = pos == "rope"
        self.name, self.depth, self.max_len, self.dtype = (
            name, depth, max_len, dtype)
        self.embed = TokenEmbed(vocab, dim, max_len, dtype, not rope, device)
        for i in range(depth):
            self.add_module(f"decoder_block_{i}", DecoderBlock(
                dim, heads, mlp_dim, dtype, kv_heads, moe_experts, moe_top_k,
                window, rope, device,
            ))
        self.head = LMHead(vocab, dim, dtype, device)

    @property
    def vocab(self) -> int:
        return self.head.vocab

    @property
    def block_names(self) -> list[str]:
        return [f"decoder_block_{i}" for i in range(self.depth)]

    @property
    def blocks(self) -> list[DecoderBlock]:
        return [getattr(self, n) for n in self.block_names]

    @property
    def device(self) -> torch.device:
        return self.head.logits.weight.device

    def forward(self, ids):
        h = self.embed(ids)
        for block in self.blocks:
            h = block(h)
        return self.head(h)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "TransformerLM":
        """Random weights from ``seed``, drawn on the CPU (the same numbers
        on any device): matrices N(0, 1/fan_in), embeddings N(0, 1/dim),
        learned positions N(0, 0.02^2), zero biases, unit LN scales. MoE
        blocks keep the JAX layout (``gate`` (d, E), ``w1`` (E, d, h),
        ``w2`` (E, h, d)): their fan-in is the second-to-last axis."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("bias", "b1", "b2"):
                p.zero_()
                continue
            if leaf == "scale":
                p.fill_(1.0)
                continue
            # nn.Linear weights are (out, in); embeddings (vocab, dim).
            if leaf == "pos_embed":
                std = 0.02
            elif leaf in ("gate", "w1", "w2"):
                std = 1 / math.sqrt(p.shape[-2])
            else:
                std = 1 / math.sqrt(p.shape[1])
            p.copy_(torch.randn(p.shape, generator=gen) * std)
        return self


def transformer_lm(vocab, dim, depth, heads, mlp_dim, max_len=1024,
                   dtype=torch.float32, name="transformer_lm", kv_heads=None,
                   moe_experts=None, moe_top_k=1, window=None, pos="learned",
                   device=None, seed=0) -> TransformerLM:
    """Build a decoder LM on ``device`` (the CUDA card unless ``"cpu"`` is
    asked for) with random weights from ``seed``; load trained ones with
    ``load_state_dict`` (``convert.from_flax`` for a JAX checkpoint)."""
    dev = resolve_device(device)
    lm = TransformerLM(vocab, dim, depth, heads, mlp_dim, max_len, dtype,
                       name, kv_heads, moe_experts, moe_top_k, window, pos,
                       device=dev)
    return lm.init_weights(seed).eval()


def lm_tiny(vocab: int = 256, max_len: int = 64, device=None,
            seed=0) -> TransformerLM:
    """Small LM for tests."""
    return transformer_lm(vocab, 64, 4, 4, 128, max_len, name="lm_tiny",
                          device=device, seed=seed)


# -- generation --------------------------------------------------------------


def prompt_bucket(s0: int, max_len: int) -> int:
    """The batcher's default prefill bucket for a prompt of ``s0``: the
    smallest power of two >= max(s0, 8), capped at ``max_len``."""
    b = 8
    while b < s0:
        b *= 2
    return min(b, max_len)


def _left_align(prompt, lengths):
    """Right-padded ragged rows -> (left-aligned buffer, per-row logical
    position ids, per-row left-pad counts)."""
    _, s0 = prompt.shape
    pad = (s0 - lengths)[:, None]
    cols = torch.arange(s0, device=prompt.device)[None, :]
    src = torch.clamp(cols - pad, min=0)
    return torch.gather(prompt, 1, src), cols - pad, pad[:, 0]


def validate_generate_args(lm, prompt, steps, temperature, top_k, rng,
                           prompt_lengths, kv_cache_dtype, top_p=None):
    """Shared request validation; returns ``(lengths, rng, do_sample)``."""
    b, s0 = prompt.shape
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if s0 + steps > lm.max_len:
        raise ValueError(
            f"prompt {s0} + steps {steps} exceeds max_len {lm.max_len}"
        )
    do_sample = bool(temperature > 0.0)
    if do_sample and rng is None:
        raise ValueError("temperature > 0 requires an rng seed")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_k is not None and top_k > lm.vocab:
        raise ValueError(f"top_k {top_k} exceeds vocab size {lm.vocab}")
    if top_p is not None and not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if kv_cache_dtype not in ("native", "int8", "int4"):
        raise ValueError(
            f"kv_cache_dtype={kv_cache_dtype!r}: expected 'native', "
            "'int8' or 'int4'"
        )
    if rng is None:
        rng = 0  # unused by the greedy path
    if prompt_lengths is None:
        lengths = np.full((b,), s0, np.int64)
    else:
        lengths = np.asarray(
            prompt_lengths.cpu() if torch.is_tensor(prompt_lengths)
            else prompt_lengths, np.int64,
        )
        if lengths.shape != (b,):
            raise ValueError(f"prompt_lengths shape {lengths.shape} != ({b},)")
        if (lengths < 1).any() or (lengths > s0).any():
            raise ValueError(
                f"prompt_lengths must be in [1, {s0}], got {lengths}"
            )
    return torch.as_tensor(lengths, device=prompt.device), int(rng), do_sample


@torch.no_grad()
def generate(lm: TransformerLM, prompt, steps: int, temperature: float = 0.0,
             top_k: int | None = None, top_p: float | None = None,
             eos_id: int | None = None, rng: int | None = None,
             prompt_lengths=None, kv_cache_dtype: str = "native",
             decode_attn: str | None = None, return_logprobs: bool = False,
             decode_split: int | None = None):
    """Prefill over the prompt, then ``steps - 1`` cached decode steps;
    returns (b, steps) token ids (and (b, steps) f32 logprobs with
    ``return_logprobs``) on the model's device.

    ``prompt`` (b, s0) ints; ragged batches pass right-padded prompts plus
    ``prompt_lengths`` (rows are left-aligned, positions are row-logical,
    padding is masked). ``temperature > 0`` samples, keyed by ``(rng, row,
    t)``, after ``top_k`` then ``top_p``; ``eos_id`` pads a finished row
    with EOS. ``kv_cache_dtype`` ``"int8"`` / ``"int4"`` keeps the cache
    quantized (one f32 scale per vector; int4 packed two per byte; an odd
    head_dim raises for int4): the prompt is prefilled on native K/V and
    quantized after, every decode step quantizes its K/V before the write,
    and attention reads the quantized cache (K2q). ``decode_attn`` /
    ``decode_split`` are ``KernelConfig``'s ``attn_impl`` /
    ``decode_split``."""
    dev = lm.device
    prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(
        prompt) else prompt).to(dev, torch.int64)
    lengths, rng, do_sample = validate_generate_args(
        lm, prompt, steps, temperature, top_k, rng, prompt_lengths,
        kv_cache_dtype, top_p=top_p,
    )
    if decode_attn not in (None, "xla", "pallas"):
        raise ValueError(
            f"decode_attn={decode_attn!r}: expected None, 'xla' or 'pallas'"
        )
    b, s0 = prompt.shape
    vocab = lm.vocab
    valid_from = None
    bucket = prompt_bucket(s0, lm.max_len)
    ids = F.pad(prompt, (0, bucket - s0))
    if prompt_lengths is not None:
        aligned, pos_ids, valid_from = _left_align(prompt, lengths)
        ids = F.pad(aligned, (0, bucket - s0))
        tail = pos_ids[:, -1:] + torch.arange(
            1, bucket - s0 + 1, device=dev)[None, :]
        h = lm.embed.embed_positions(ids, torch.cat([pos_ids, tail], 1))
    else:
        h = lm.embed(ids)
    # Strips of max_len + 1, the batcher's length: K2-split cuts the
    # strip into the same per-split tile ranges in both, so a split decode
    # matches the batcher bit for bit too.
    quant = kv_cache_dtype if kv_cache_dtype != "native" else False
    caches = []
    for block in lm.blocks:
        h, ck, cv = block.prefill(h, lm.max_len + 1, valid_from, quant)
        caches.append((ck, cv))
    logits = lm.head(h[:, s0 - 1:s0])[:, 0]

    B = -(-b // ROW_QUANTUM) * ROW_QUANTUM
    i64 = dict(dtype=torch.int64, device=dev)
    knobs = dict(
        temps=torch.full((B,), float(temperature), dtype=torch.float32,
                         device=dev),
        top_ks=torch.full((B,), top_k if top_k is not None else vocab, **i64),
        top_ps=torch.full((B,), 1.0 if top_p is None else float(top_p),
                          dtype=torch.float32, device=dev),
        seeds=torch.full((B,), rng, **i64),
        rows=torch.arange(B, **i64),
    )
    flags = dict(do_sample=do_sample, truncate=top_k is not None,
                 nucleus=top_p is not None)

    def pick(lg, t):
        n = lg.shape[0]
        return sample_rows(
            lg, *(knobs[k][:n] for k in ("temps", "top_ks", "top_ps",
                                         "seeds", "rows")),
            torch.full((n,), t, **i64), **flags,
        )

    first = pick(logits, 0)
    toks, lps = [first], [chosen_logprob(logits, first)]
    done = (first == eos_id) if eos_id is not None else None
    if steps > 1:
        pad_rows = B - b
        caches = [tuple(map_cache(
            lambda t: F.pad(t, (0, 0, 0, 0, 0, 0, 0, pad_rows)), c)
            for c in kv) for kv in caches]
        tok = F.pad(first, (0, pad_rows))
        if done is not None:
            done = F.pad(done, (0, pad_rows))
        vf = None if valid_from is None else F.pad(valid_from, (0, pad_rows))
        idx = torch.full((B,), s0, dtype=torch.int32, device=dev)
        for t in range(1, steps):
            pos = idx if vf is None else idx - vf
            x = lm.embed.embed_positions(tok[:, None], pos[:, None])
            for block, (ck, cv) in zip(lm.blocks, caches):
                x, _, _ = block.decode_step(
                    x, ck, cv, idx, vf, attn_impl=decode_attn,
                    split=decode_split,
                )
            lg = lm.head(x)[:, 0]
            nxt = pick(lg, t)
            if done is not None:
                nxt = torch.where(done, eos_id, nxt)
                done = done | (nxt == eos_id)
            toks.append(nxt[:b])
            lps.append(chosen_logprob(lg, nxt)[:b])
            tok, idx = nxt, idx + 1
    tokens = torch.stack(toks, 1)
    if return_logprobs:
        return tokens, torch.stack(lps, 1)
    return tokens


@torch.no_grad()
def logits_full(lm: TransformerLM, ids):
    """Full-sequence causal logits — the oracle cached decode must match
    position for position."""
    ids = torch.as_tensor(np.asarray(ids) if not torch.is_tensor(ids)
                          else ids).to(lm.device, torch.int64)
    return lm(ids)
