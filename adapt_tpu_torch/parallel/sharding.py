"""Sharding of tensors over a :class:`~adapt_tpu_torch.core.mesh.Mesh` of
shards driven by ONE process — the port of ``adapt_tpu/parallel/sharding.py``.

The JAX package annotates shardings and lets GSPMD insert the collectives.
The port has no compiler to do that, and its card is one: NCCL refuses two
ranks of one communicator on one device. So a mesh here is a list of
shards, each with its own device (a device may repeat), and a
:class:`Sharding` cuts a tensor into one CONTIGUOUS piece per shard on
that shard's device (a :class:`Shards` list). The model runs its shards in
lockstep and sums their partial products with :func:`reduce_shards`, the
one reduction, in shard order. The sharded model and the batcher take a
mesh that names one device tp times; only :func:`reduce_shards` speaks of
distinct devices, the seam where a collective across cards would go.

The rules are written against the port's own parameter names and torch
layouts: an ``nn.Linear`` weight is ``(out, in)``, so the JAX package's row
split of a ``(in, out)`` kernel on its contracted axis is a column split
here (``P(None, "tp")``), and its column split a row split. A fused
projection (the MHA ``qkv``, the GQA ``kv``) splits on a head axis that is
not the weight's leading axis; its entry is :class:`Blocks`: shard ``i``
takes its slice of each of the q / k / v row blocks.

A mesh shrink (elastic recovery: a shard lost, tp=4 -> tp=2) moves live
state by an explicit :class:`KVReshardPlan`: each new shard is the ordered
concatenation of the old shards' ranges, per shard, never a global
gather; the lost shard's pieces go through host memory."""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Callable, Mapping

import numpy as np
import torch

from adapt_tpu_torch.core.mesh import Mesh


class P(tuple):
    """A partition spec: one entry per tensor dim — a mesh axis name, a
    :class:`Blocks` entry, or None (whole); missing trailing entries are
    None."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(d) for d in self) + ")"


@dataclasses.dataclass(frozen=True)
class Blocks:
    """A spec entry for a dim made of ``n`` equal blocks, each split over
    ``axis``: shard ``i`` takes its slice of every block, concatenated in
    block order (a fused ``nn.Linear``'s q / k / v rows; the JAX spec
    ``(None, None, "tp", None)`` on a ``(d, 3, heads, hd)`` kernel)."""

    axis: str
    n: int


def _axis_of(entry):
    return entry.axis if isinstance(entry, Blocks) else entry


class Sharding:
    """``spec`` over ``mesh``: one shard per mesh position (row-major), its
    piece of a tensor cut by the entries that name an axis (its index on
    that axis picks the chunk), whole on every other dim."""

    def __init__(self, mesh: Mesh, spec: P = P()):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)
        for e in self.spec:
            ax = _axis_of(e)
            if ax is not None and ax not in mesh.axis_names:
                raise ValueError(f"spec {self.spec} names axis {ax!r}; the "
                                 f"mesh has {mesh.axis_names}")
        self.devices = list(mesh.devices.flat)
        shape = mesh.devices.shape
        self._coords = [dict(zip(mesh.axis_names, np.unravel_index(k, shape)))
                        for k in range(len(self.devices))]

    def __repr__(self) -> str:
        return f"Sharding({dict(self.mesh.shape)}, {self.spec})"

    def _dims(self, shape):
        shape = tuple(int(d) for d in shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has {len(self.spec)} entries "
                             f"for a {len(shape)}-dim tensor")
        return shape, list(self.spec) + [None] * (len(shape) - len(self.spec))

    def index(self, shape) -> list[tuple[slice, ...]]:
        """Per shard, per dim: the slice its piece holds (within each block
        for a :class:`Blocks` dim)."""
        shape, spec = self._dims(shape)
        out = []
        for co in self._coords:
            idx = []
            for size, e in zip(shape, spec):
                ax = _axis_of(e)
                if ax is None:
                    idx.append(slice(0, size))
                    continue
                n = int(self.mesh.shape[ax])
                nb = e.n if isinstance(e, Blocks) else 1
                if size % (nb * n):
                    raise ValueError(f"dim of {size} does not split into "
                                     f"{nb} x {n} equal pieces")
                w = size // nb // n
                i = int(co[ax])
                idx.append(slice(i * w, (i + 1) * w))
            out.append(tuple(idx))
        return out

    def piece_shape(self, shape) -> tuple[int, ...]:
        shape, spec = self._dims(shape)
        ix = self.index(shape)[0]
        return tuple(
            (s.stop - s.start) * (e.n if isinstance(e, Blocks) else 1)
            for s, e in zip(ix, spec))

    def _cut(self, t: torch.Tensor, idx) -> torch.Tensor:
        _, spec = self._dims(t.shape)
        for dim, (s, e) in enumerate(zip(idx, spec)):
            if s.start == 0 and s.stop == t.shape[dim] and not isinstance(
                    e, Blocks):
                continue
            if isinstance(e, Blocks):
                bsize = t.shape[dim] // e.n
                t = torch.cat([t.narrow(dim, b * bsize + s.start,
                                        s.stop - s.start)
                               for b in range(e.n)], dim)
            else:
                t = t.narrow(dim, s.start, s.stop - s.start)
        return t

    def shard(self, t: torch.Tensor) -> "Shards":
        """``t`` cut into one contiguous piece per shard on the shard's
        device. A whole piece of a contiguous ``t`` already on its device
        is ``t`` itself (a replicated tensor costs no copy on a shared
        card)."""
        pieces = [self._cut(t, idx).contiguous().to(dev)
                  for idx, dev in zip(self.index(t.shape), self.devices)]
        return Shards(pieces, self, tuple(t.shape))

    def map_pieces(self, fn, shape) -> "Shards":
        """A :class:`Shards` whose piece ``i`` is ``fn(piece_shape,
        device_i)`` (allocation: KV caches, quantized pairs)."""
        ps = self.piece_shape(shape)
        return Shards([fn(ps, d) for d in self.devices], self, tuple(shape))


class Shards(list):
    """The per-shard pieces of one logical tensor, in mesh order, or any
    per-shard values (a quantized cache's ``(values, scales)`` pair a
    shard). ``sharding`` and ``shape`` describe the cut; ``index`` is each
    piece's slices of the logical tensor (given explicitly, or read off the
    sharding)."""

    def __init__(self, pieces=(), sharding: Sharding | None = None,
                 shape=None, index=None):
        super().__init__(pieces)
        self.sharding = sharding
        self.shape = None if shape is None else tuple(shape)
        self._index = index

    @property
    def index(self):
        if self._index is not None:
            return self._index
        if self.sharding is None or self.shape is None:
            return None
        return self.sharding.index(self.shape)

    def like(self, pieces) -> "Shards":
        """New pieces under the same cut (the same logical geometry)."""
        return Shards(pieces, self.sharding, self.shape, self._index)


def reduce_shards(parts: list) -> list:
    """THE reduction of shard partial sums: ``parts[0] + parts[1] + ...``
    in shard order (so a row's bits never depend on its company), handed to
    every shard. Shards on one device share one sum; a part on another
    device is copied to shard 0's device and the sum back. A collective
    across cards would live here."""
    lead = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + (p if p.device == lead else p.to(lead))
    return [total if p.device == lead else total.to(p.device)
            for p in parts]


def batch_sharding(mesh: Mesh, axis: str = "dp") -> Sharding:
    """Shard the leading (batch) dimension over ``axis``."""
    return Sharding(mesh, P(axis))


def shard_batch(x: torch.Tensor, mesh: Mesh, axis: str = "dp") -> Shards:
    return batch_sharding(mesh, axis).shard(x)


def replicate(tree, mesh: Mesh):
    """Every tensor of ``tree`` (a tensor, or a mapping / list / tuple of
    them) whole on every shard."""
    sharding = Sharding(mesh, P())
    if isinstance(tree, torch.Tensor):
        return sharding.shard(tree)
    if isinstance(tree, Mapping):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return tree


def kv_head_sharding(mesh: Mesh, axis: str = "tp") -> Sharding:
    """THE KV-cache placement under tensor parallelism: dim 1, the head
    axis, split over ``axis``. Dense slot strips ``(slots, kv_heads, L,
    hd)``, paged pools ``(pages, kv_heads, P, hd)`` and the scale planes of
    quantized ones ``(..., kv_heads, ..., 1)`` all put heads on dim 1, so
    both members of a ``(values, scales)`` pair split alike."""
    return Sharding(mesh, P(None, axis))


def _rules(patterns, path: str, value_ndim: int, axis: str) -> P:
    for pattern, spec in patterns:
        if re.fullmatch(pattern, path) and len(spec) == value_ndim:
            return P(*(Blocks(axis, e.n) if isinstance(e, Blocks)
                       else (axis if e == "tp" else e) for e in spec))
    return P()


#: Tensor-parallel placement of the port's ViT encoder blocks
#: (``models/vit.py``, ``layers.encoder_block_i.*``): qkv / mlp-in split
#: their output rows, attn-out / mlp-out their input columns (the JAX
#: package's ``_VIT_TP_PATTERNS`` in torch layout).
_VIT_TP_PATTERNS: list[tuple[str, tuple]] = [
    (r"(.*\.)?encoder_block_\d+\.attn\.qkv\.weight", (Blocks("tp", 3), None)),
    (r"(.*\.)?encoder_block_\d+\.attn\.qkv\.bias", (Blocks("tp", 3),)),
    (r"(.*\.)?encoder_block_\d+\.attn\.out\.weight", (None, "tp")),
    (r"(.*\.)?encoder_block_\d+\.mlp_in\.weight", ("tp", None)),
    (r"(.*\.)?encoder_block_\d+\.mlp_in\.bias", ("tp",)),
    (r"(.*\.)?encoder_block_\d+\.mlp_out\.weight", (None, "tp")),
]


def vit_tp_rules(path: str, value_ndim: int, axis: str = "tp") -> P:
    """A ViT state-dict name -> its tp spec (default: replicated)."""
    return _rules(_VIT_TP_PATTERNS, path, value_ndim, axis)


#: Tensor-parallel placement of the port's decoder LM
#: (``models/transformer_lm.py`` state-dict names), megatron-style: each
#: block sums shard partials twice (attn-out, mlp-out) and the head once.
#:
#: - ``attn.qkv`` (MHA, ``(3 * heads * hd, d)``): each shard's q, k and v
#:   rows of its heads/tp heads (:class:`Blocks` of 3), so the KV cache's
#:   head axis splits with it;
#: - GQA ``attn.q`` ``(heads * hd, d)``: contiguous row blocks;
#:   ``attn.kv`` ``(2 * kv_heads * hd, d)``: Blocks of 2. kv_heads % tp
#:   == 0 keeps each shard's query-head groups on its own KV heads (the
#:   ``_group_q`` fold), so attention needs no exchange;
#: - ``attn.out`` ``(d, heads * hd)`` and ``mlp_out`` ``(d, hidden)``:
#:   column split on the contracted axis, partials summed;
#: - ``mlp_in`` ``(hidden, d)``: row split;
#: - MoE ``w1`` ``(E, d, hidden)``, ``b1`` ``(E, hidden)``, ``w2`` ``(E,
#:   hidden, d)`` (JAX layout kept): the HIDDEN axis splits; the expert
#:   axis stays whole so ``parallel/expert``'s ``ep`` split composes
#:   (:func:`merge_specs`); the ``gate`` replicates;
#: - ``head.logits`` ``(vocab, d)``: column split on the model dim, the
#:   logits summed (replicated after the reduction, so sampling is
#:   sharding-blind). Embeddings, LayerNorms and the out / mlp_out / head
#:   biases replicate; the biases add once, after the sum.
_LM_TP_PATTERNS: list[tuple[str, tuple]] = [
    (r"decoder_block_\d+\.attn\.qkv\.weight", (Blocks("tp", 3), None)),
    (r"decoder_block_\d+\.attn\.qkv\.bias", (Blocks("tp", 3),)),
    (r"decoder_block_\d+\.attn\.q\.weight", ("tp", None)),
    (r"decoder_block_\d+\.attn\.q\.bias", ("tp",)),
    (r"decoder_block_\d+\.attn\.kv\.weight", (Blocks("tp", 2), None)),
    (r"decoder_block_\d+\.attn\.kv\.bias", (Blocks("tp", 2),)),
    (r"decoder_block_\d+\.attn\.out\.weight", (None, "tp")),
    (r"decoder_block_\d+\.mlp_in\.weight", ("tp", None)),
    (r"decoder_block_\d+\.mlp_in\.bias", ("tp",)),
    (r"decoder_block_\d+\.mlp_out\.weight", (None, "tp")),
    (r"decoder_block_\d+\.moe\.w1", (None, None, "tp")),
    (r"decoder_block_\d+\.moe\.b1", (None, "tp")),
    (r"decoder_block_\d+\.moe\.w2", (None, "tp", None)),
    (r"head\.logits\.weight", (None, "tp")),
]


def lm_tp_rules(path: str, value_ndim: int, axis: str = "tp") -> P:
    """An LM state-dict name -> its tp spec (default: replicated).
    ``axis`` renames the mesh axis (``config.ParallelConfig.axis``)."""
    return _rules(_LM_TP_PATTERNS, path, value_ndim, axis)


def merge_specs(a: P, b: P) -> P:
    """Compose two specs for ONE tensor (an MoE expert stack's ``ep``
    split with its ``tp`` hidden split: ``P('ep', None, 'tp')``). Each dim
    takes whichever spec splits it; both splitting one dim differently is
    a conflict and raises."""
    out = []
    for i in range(max(len(a), len(b))):
        x = a[i] if i < len(a) else None
        y = b[i] if i < len(b) else None
        if x is not None and y is not None and x != y:
            raise ValueError(f"specs conflict on dim {i}: {a} vs {b} "
                             f"({x!r} != {y!r})")
        out.append(x if x is not None else y)
    return P(*out)


def _flat(variables: Mapping, prefix: str = ""):
    for k, v in variables.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _flat(v, name + ".")
        else:
            yield name, v


def tree_shardings(variables: Mapping, mesh: Mesh, rules=vit_tp_rules
                   ) -> dict[str, Sharding]:
    """name -> :class:`Sharding` for a state dict (nested mappings join
    their keys with dots) from name-based ``rules(name, ndim)``."""
    return {name: Sharding(mesh, rules(name, v.ndim))
            for name, v in _flat(variables)}


@dataclasses.dataclass
class KVHandoffPlan:
    """Placement of KV pages that arrive from outside the pool — the
    disaggregated handoff and the host-tier readmit — onto the pool's
    layout. The pages come as host page-major ``(n, kv_heads, page, w)``
    tensors holding every head; under a head-split pool each shard's heads
    are a contiguous slice of them, so each shard receives only its own
    heads (logical bytes / tp each), never the whole page. No sharding
    (``None``) is one ordinary placement. Both members of a quantized pair
    place under one plan."""

    #: The destination pool's :class:`Sharding` (:func:`kv_head_sharding`),
    #: or None for an unsplit pool.
    sharding: Sharding | None
    #: Bytes handed to :meth:`place` / :meth:`split` (the logical bytes,
    #: once per placed leaf; each shard stages only its slice of them).
    staged_bytes: int = 0

    def split(self, kv_host) -> Shards | torch.Tensor:
        """Per-shard host slices (views, no copy) of ONE page-major host
        tensor; the tensor itself without a sharding."""
        kv_host = torch.as_tensor(np.asarray(kv_host)) if not isinstance(
            kv_host, torch.Tensor) else kv_host
        self.staged_bytes += kv_host.numel() * kv_host.element_size()
        if self.sharding is None:
            return kv_host
        return Shards([self.sharding._cut(kv_host, idx)
                       for idx in self.sharding.index(kv_host.shape)],
                      self.sharding, tuple(kv_host.shape))

    def place(self, leaves: list, stage) -> list:
        """Land host ``leaves`` (page-major tensors; a quantized pool's
        values and scales are two leaves) on the pool: each leaf cut by
        :meth:`split`, every slice of every leaf handed to ONE
        ``stage(slices) -> device tensors`` call (the batcher's counted,
        pinned staging). Returns per leaf a :class:`Shards` of its landed
        slices, or the landed tensor without a sharding."""
        parts = [self.split(t) for t in leaves]
        landed = iter(stage([p for ps in parts for p in (
            ps if isinstance(ps, Shards) else [ps])]))
        return [ps.like([next(landed) for _ in ps])
                if isinstance(ps, Shards) else next(landed) for ps in parts]


def plan_kv_handoff(sharding: Sharding | None) -> KVHandoffPlan:
    """The :class:`KVHandoffPlan` for a destination pool's sharding (None
    for an unsplit pool)."""
    return KVHandoffPlan(sharding=sharding)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def member_shards(x: Shards, head_dim: int = 1) -> list[Shards]:
    """A :class:`Shards` whose pieces are tuples (a quantized cache's
    ``(values, scales)`` a shard) as one ``Shards`` per member, each over
    the member's own logical shape (the pieces' shape with the whole
    ``head_dim``); a ``Shards`` of tensors as itself."""
    if not isinstance(x[0], tuple):
        return [x]
    out = []
    for m in range(len(x[0])):
        pieces = [p[m] for p in x]
        shape = list(pieces[0].shape)
        shape[head_dim] = x.shape[head_dim]
        out.append(Shards(pieces, x.sharding, shape))
    return out


def _tree_map(fn: Callable, tree):
    """``fn`` over every tensor of ``tree`` (mappings, lists, tuples and
    dataclass instances such as ``ops.quantize.QuantizedTensor``)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    return tree


@dataclasses.dataclass
class KVReshardPlan:
    """Explicit redistribution plan for live head-sharded state across a
    mesh SHRINK (elastic recovery: tp=4 -> tp=2 after a shard is lost) —
    the ``runtime/continuous`` migration executor, the port of the JAX
    package's plan.

    Per SHARD, never a global gather: each new shard's range is an aligned
    union of old shard ranges (``new_tp`` divides ``old_tp``, both divide
    the head count), built as their ordered concatenation, and every old
    piece moves by the route its source allows —

    - a **surviving** member's piece is re-placed onto the new owner
      (counted in :attr:`moved_bytes` when the owner's member id differs
      from its own: the bytes a link between cards would carry);
    - the **lost** member's piece goes through HOST memory, a
      device->host copy and back onto the card
      (:attr:`host_staged_bytes`): under the simulated kill this reads the
      lost shard's still-resident buffer, and in a real deployment it is
      the seam where a host-side recovery source (a KV mirror, a KV store,
      a recompute from the journal) plugs in. Requests that do not pay it
      replay from the journal instead (``config.RecoveryConfig.policy``).

    Members are ``core.mesh.MeshMember``s, told apart by their member ids
    (shards of one card share a device). Replicated state (the sampling
    state, the draft, staged tables) moves through
    :meth:`migrate_replicated`, read from a SURVIVING member."""

    #: Old tp-axis members in order (member i held range i).
    old_devices: tuple
    #: New tp-axis members (the shrunk mesh's; one for the tp=1 remnant).
    new_devices: tuple
    #: Member ids whose shards are lost (host-staged sources).
    lost_ids: frozenset
    #: Mesh axis the splits live on.
    axis: str = "tp"
    #: Bytes re-placed from a surviving member onto another member.
    moved_bytes: int = 0
    #: Bytes staged through the host (the lost members' pieces).
    host_staged_bytes: int = 0

    def __post_init__(self):
        old_n, new_n = len(self.old_devices), len(self.new_devices)
        if new_n < 1:
            raise ValueError("plan needs at least one new device")
        if old_n % new_n:
            raise ValueError(
                f"new tp {new_n} must divide old tp {old_n} — head "
                "ranges only tile exactly for divisor shrinks"
            )
        survivors = {int(d.id) for d in self.old_devices} - set(
            self.lost_ids)
        for d in self.new_devices:
            if int(d.id) not in survivors:
                raise ValueError(
                    f"new device {d} is not a surviving old-mesh device"
                )

    @staticmethod
    def _route(x: Shards, new_sharding: Sharding, dim: int) -> list:
        """Per new shard, the old piece numbers whose ranges on ``dim``
        tile its range, in order; raises on misaligned or uncovered
        ranges."""
        spans = sorted((s[dim].start, s[dim].stop, i)
                       for i, s in enumerate(x.index))
        routes = []
        for nidx in new_sharding.index(x.shape):
            lo, hi = nidx[dim].start, nidx[dim].stop
            got, cover = [], lo
            for slo, shi, i in spans:
                if slo < lo or shi > hi:
                    continue  # outside this new shard's range
                if slo != cover:
                    raise ValueError(
                        f"head ranges misaligned: need [{lo},{hi}), next "
                        f"source starts at {slo}, covered to {cover}")
                got.append(i)
                cover = shi
            if cover != hi:
                raise ValueError(
                    f"head range [{lo},{hi}) not covered (reached {cover}) "
                    "— old/new shardings do not tile")
            routes.append(got)
        return routes

    def migrate_leaves(self, xs: list, shardings: list, dims: list
                       ) -> list[Shards]:
        """Move every ``Shards`` of ``xs`` (split on its ``dims`` entry)
        onto its entry of ``shardings``; the lost members' pieces of ALL of
        them go to the host in one device->host copy."""
        routes, lost, host_src = [], {}, []
        for li, (x, sh, dim) in enumerate(zip(xs, shardings, dims)):
            old_ids = [int(i) for i in x.sharding.mesh.ids.flat]
            new_ids = [int(i) for i in sh.mesh.ids.flat]
            r = self._route(x, sh, dim)
            for j, route in enumerate(r):
                for i in route:
                    if old_ids[i] in self.lost_ids:
                        # Host staging: the ONLY read of a lost shard.
                        lost[li, i] = len(host_src)
                        host_src.append(x[i])
                    elif old_ids[i] != new_ids[j]:
                        self.moved_bytes += _nbytes(x[i])
            routes.append(r)
        staged = host_copy(host_src) if host_src else []
        self.host_staged_bytes += sum(_nbytes(t) for t in staged)
        out = []
        for li, (x, sh, dim, r) in enumerate(zip(xs, shardings, dims,
                                                 routes)):
            e = x.sharding.spec[dim] if dim < len(x.sharding.spec) else None
            nb = e.n if isinstance(e, Blocks) else 1
            pieces = []
            for j, route in enumerate(r):
                parts = [(staged[lost[li, i]] if (li, i) in lost else x[i])
                         .to(sh.devices[j]) for i in route]
                if len(parts) == 1:
                    pieces.append(parts[0])
                elif nb == 1:
                    pieces.append(torch.cat(parts, dim))
                else:
                    # Each block's slices concatenate within the block.
                    pieces.append(torch.cat(
                        [p.unflatten(dim, (nb, -1)) for p in parts],
                        dim + 1).flatten(dim, dim + 1))
            out.append(Shards(pieces, sh, x.shape))
        return out

    def migrate(self, x: Shards, new_sharding: Sharding, head_dim: int = 1):
        """Move ONE leaf split on ``head_dim`` (the KV convention: dense
        strips, pools and scale planes put heads on dim 1; a weight passes
        its split dim, a :class:`Blocks` entry concatenating within each
        block) onto ``new_sharding``. The result holds the same bytes
        re-placed. A one-shard layout (the tp=1 remnant) gives the lone
        tensor."""
        out = self.migrate_leaves([x], [new_sharding], [head_dim])[0]
        return out[0] if len(out) == 1 else out

    def migrate_tree(self, tree, new_sharding: Sharding, head_dim: int = 1):
        """:meth:`migrate` over every ``Shards`` of a KV tree (lists,
        tuples, mappings); a ``Shards`` of ``(values, scales)`` pairs moves
        both members under the SAME plan, so a page's scales travel with
        its payload. All the lost pieces share one device->host copy."""
        leaves: list[Shards] = []

        def collect(t):
            if isinstance(t, Shards):
                leaves.append(t)
            elif isinstance(t, Mapping):
                for v in t.values():
                    collect(v)
            elif isinstance(t, (list, tuple)):
                for v in t:
                    collect(v)

        collect(tree)
        members, spans = [], []
        for x in leaves:
            ms = member_shards(x, head_dim)
            spans.append((len(members), len(ms)))
            members.extend(ms)
        moved = self.migrate_leaves(members, [new_sharding] * len(members),
                              [head_dim] * len(members))
        new = {}
        for x, (a, n) in zip(leaves, spans):
            ms = moved[a:a + n]
            pieces = ([tuple(m[j] for m in ms) for j in range(len(ms[0]))]
                      if isinstance(x[0], tuple) else list(ms[0]))
            new[id(x)] = (pieces[0] if len(pieces) == 1
                          else Shards(pieces, new_sharding, x.shape))

        def rebuild(t):
            if isinstance(t, Shards):
                return new[id(t)]
            if isinstance(t, Mapping):
                return {k: rebuild(v) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(rebuild(v) for v in t)
            return t

        return rebuild(tree)

    def migrate_replicated(self, tree, new_sharding: Sharding):
        """Re-place replicated state (the sampling state, the draft's
        weights and caches) onto the new layout's lead device, read from a
        SURVIVING member. The port keeps one physical copy of it, on the
        lead device; every old member holds it logically, so the source is
        the first surviving member in old order (a lost lead is never
        read), and the bytes count once per new member other than the
        source, the JAX plan's formula."""
        new_ids = [int(i) for i in new_sharding.mesh.ids.flat]
        lead = new_sharding.devices[0]
        src = next((int(m.id) for m in self.old_devices
                    if int(m.id) not in self.lost_ids), None)

        def one(x):
            if src is None:  # every replica lost: the host fallback
                h = host_copy([x])[0]
                self.host_staged_bytes += _nbytes(h)
                return h.to(lead)
            self.moved_bytes += _nbytes(x) * sum(1 for i in new_ids
                                                 if i != src)
            return x.to(lead)

        return _tree_map(one, tree)

    def summary(self) -> dict:
        """Accounting for flight events and logs."""
        return {
            "old_tp": len(self.old_devices),
            "new_tp": len(self.new_devices),
            "lost": sorted(self.lost_ids),
            "moved_bytes": self.moved_bytes,
            "host_staged_bytes": self.host_staged_bytes,
        }


def plan_kv_reshard(old_devices, new_devices, lost_ids, axis: str = "tp"
                    ) -> KVReshardPlan:
    """The :class:`KVReshardPlan` of a mesh shrink: ``old_devices`` the old
    tp-axis members in order, ``new_devices`` the survivors chosen for the
    shrunk axis, ``lost_ids`` the dead member ids."""
    return KVReshardPlan(
        old_devices=tuple(old_devices),
        new_devices=tuple(new_devices),
        lost_ids=frozenset(int(i) for i in lost_ids),
        axis=axis,
    )


def _head_order(x: Shards, head_dim: int) -> list[int]:
    """Shard numbers whose head ranges tile ``x``'s head axis in order
    (replicated duplicates skipped); raises on ranges that overlap without
    nesting, leave a gap or stop short."""
    h = x.shape[head_dim]
    spans = sorted((idx[head_dim].start, idx[head_dim].stop, i)
                   for i, idx in enumerate(x.index))
    order, cover = [], 0
    for lo, hi, i in spans:
        if lo < cover:
            if hi <= cover:
                continue  # a replicated duplicate of a covered range
            raise ValueError(f"head ranges overlap without nesting: "
                             f"[{lo},{hi}) vs covered [0,{cover})")
        if lo != cover:
            raise ValueError(f"head ranges misaligned: next shard starts at "
                             f"{lo}, covered to {cover}")
        order.append(i)
        cover = hi
    if cover != h:
        raise ValueError(f"head axis not covered: reached {cover} of {h}")
    return order


def host_copy(tensors: list) -> list:
    """Host copies of ``tensors`` (any dtypes and shapes, on one device).
    From a card: their bytes packed into one buffer on the device and
    fetched with ONE device->host copy, then cut and viewed back; on the
    CPU, clones."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.clone() for t in tensors]
    parts, offs, off = [], [], 0
    for t in tensors:
        f = t.contiguous().view(-1).view(torch.uint8)
        pad = -f.numel() % 16  # keeps every view's offset aligned
        parts.append(f)
        if pad:
            parts.append(f.new_zeros(pad))
        offs.append(off)
        off += f.numel() + pad
    host = torch.cat(parts).cpu()
    return [host[o:o + t.numel() * t.element_size()].view(t.dtype).view(
        t.shape) for t, o in zip(tensors, offs)]


def fetch_head_shards(x, index, head_dim: int = 1):
    """Host copy of ``x[index]`` assembled per shard along the head axis:
    the device->host counterpart of :meth:`KVHandoffPlan.place`, the
    host-tier spill's read. Each shard ships only its own heads and the
    head range is concatenated on the HOST, never gathered on a device.
    ``x`` is a pool leaf ``(pages, kv_heads, P, w)`` split on ``head_dim``
    (a plain tensor is one piece), or a list of such leaves: then a list
    comes back. Every piece of every leaf moves in ONE device->host copy
    (:func:`host_copy`); head ranges that do not tile the axis raise."""
    many = isinstance(x, list) and not isinstance(x, Shards)
    pieces = [[y[i][index] for i in _head_order(y, head_dim)]
              if isinstance(y, Shards) else [y[index]]
              for y in (x if many else [x])]
    host = iter(host_copy([p for ps in pieces for p in ps]))
    axis = head_dim - 1 if isinstance(index, int) else head_dim
    out = []
    for ps in pieces:
        got = [next(host) for _ in ps]
        out.append(got[0] if len(got) == 1 else torch.cat(got, axis))
    return out if many else out[0]


def head_tiles(kv_heads: int, parts: int) -> list[tuple[int, int]]:
    """Contiguous even ``(lo, hi)`` tiles of a ``kv_heads`` head axis over
    ``parts`` destination shards: the slices :func:`kv_head_sharding` gives
    each shard, computable without the destination's mesh (a sender knows
    only the peer's tp). A sender framing KV pages per tile ships exactly
    the bytes each destination shard receives."""
    kv_heads, parts = int(kv_heads), int(parts)
    if parts < 1:
        raise ValueError(f"parts must be >= 1, got {parts}")
    if kv_heads < 1 or kv_heads % parts:
        raise ValueError(
            f"{parts} tiles must evenly cover {kv_heads} kv heads")
    w = kv_heads // parts
    return [(i * w, (i + 1) * w) for i in range(parts)]
