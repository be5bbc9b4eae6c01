"""Disaggregated prefill / decode serving: a prefill tier streams KV pages
to the decode batcher, so decode ticks never run a long prompt's prefill
inline — the port of ``adapt_tpu/runtime/disagg.py``.

The collocated ``ContinuousBatcher`` runs every admission's prefill inside
its tick, so a long prompt's prefill wall lands on every decoding
request's inter-token latency (``continuous.prefill_stall_s``). This
module splits the two phases:

- :class:`PrefillWorker`, the prefill tier: admission and CHUNKED prefill
  against its own paged pool (one page-aligned chunk pass per active slot
  a :meth:`~PrefillWorker.step`, each a ``prefill_chunk_paged`` of every
  block: K4, or K4q on a quantized pool), then one device->host copy of
  the prompt's FULL pages: a :class:`KVHandoff`.
- The wire: a handoff is one ``comm.framing.Message`` (``MSG_KV_PAGES``)
  whose payload is the tensors' codec frames, described by the
  ``FLAG_PAGE_ANNEX`` page annex (request id, geometry, frame lengths, a
  crc over the payload); byte-equal to the JAX package's, with and
  without a ``wire_codec``. :func:`loopback` is the in-process transport:
  it gathers the frame and re-parses it through ``frame_parts`` /
  ``parse_frame``, so corruption behaves as off a socket.
- The landing: ``ContinuousBatcher.adopt_prefill_pages`` registers the
  pages in the decode pool's PREFIX CACHE, and the request then enters
  through the ordinary ``submit``: admission sees a prefix hit and
  prefills only the suffix (K4 / K4q), decode runs K3 / K3q. A
  tensor-parallel decode batcher (``mesh=`` + ``ParallelConfig(tp)``)
  gets its frames cut into its head tiles (:func:`head_ranges_for`), and
  each shard's pool receives only its own heads.
- :class:`DisaggServer`: the placement policy (``config.DisaggConfig``)
  decides collocated vs disaggregated PER REQUEST; every fallback is
  collocated, counted (``disagg.collocated_total``) and logged. With a
  ``control.registry.WorkerRegistry`` the prefill tier holds a
  ``role="prefill"`` lease the pipeline dispatcher's acquisition skips.
  The server attaches itself to the decode batcher's
  ``DegradationController`` (its ``busy_threshold`` rung) and calls the
  batcher's ``admission_check`` before it spends a prefill.

Observability: ``disagg.{handoff_bytes,handoff_bytes_raw,handoff_s,
pages_streamed}`` and the ``kv_handoff`` flight event per landing.

Scope: one process, one card (a tp decode batcher's shards may share it);
the server drives both tiers from one thread. With ``config.PrefillConfig``
(``sp_width`` above 1) the prefill tier runs a long job's whole span over
a sequence-parallel ring (``parallel/sp_prefill``) in one :meth:`step`,
outside its pool: a prompt longer than the pool still hands off.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import time
import zlib
from typing import Callable

import numpy as np
import torch

from adapt_tpu_torch import resolve_device
from adapt_tpu_torch.comm import codec
from adapt_tpu_torch.comm.framing import (
    MSG_KV_PAGES,
    Message,
    frame_parts,
    parse_frame,
)
from adapt_tpu_torch.config import DisaggConfig, PrefillConfig, SLOSpec
from adapt_tpu_torch.models.transformer_lm import TransformerLM
from adapt_tpu_torch.ops.quantize import PAGE_CODECS, decode_page, encode_page
from adapt_tpu_torch.parallel.sharding import head_tiles, host_copy
from adapt_tpu_torch.parallel.sp_prefill import SPPrefiller, build_sp_mesh
from adapt_tpu_torch.runtime.capacity import prefill_tier_book
from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
from adapt_tpu_torch.runtime.paged import Pager
from adapt_tpu_torch.runtime.scheduler import QueueFullError
from adapt_tpu_torch.utils.logging import get_logger
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.tracing import global_flight_recorder, global_tracer

log = get_logger("disagg")

_LEN_PREFIX = 8  # the frame's length prefix (comm.framing)


class HandoffError(RuntimeError):
    """A KV handoff frame could not be decoded or landed (corrupt or
    truncated bytes, a geometry mismatch). The server fails the REQUEST
    cleanly (empty result, ``request_failed`` flight event) and serves
    on."""


@dataclasses.dataclass
class KVHandoff:
    """One prefilled request's streamable state: the prompt, the page
    geometry and per-block page-major K/V covering the prompt's first
    ``n_pages`` FULL pages, ``(n_pages, kv_heads, page_size, head_dim)``
    CPU tensors per member (``(values, scales)`` tuples on a quantized
    pool: the scale plane is part of the page)."""

    req_id: int
    prompt: np.ndarray
    page_size: int
    n_pages: int
    quantized: bool
    #: One ``(K, V)`` pair per decoder block.
    blocks: list
    #: KV dtype on the wire: "native", "int8" or "int4" (int4 members carry
    #: packed ``head_dim // 2`` lanes). Defaults from ``quantized``.
    kv_dtype: str = ""

    def __post_init__(self):
        if not self.kv_dtype:
            self.kv_dtype = "int8" if self.quantized else "native"


def _leaves(handoff: KVHandoff) -> list:
    """The handoff's tensors in WIRE ORDER: the prompt (int32), then each
    block's K members then V members (a quantized pair as values,
    scales)."""
    out: list = [np.ascontiguousarray(handoff.prompt, np.int32)]
    for k, v in handoff.blocks:
        for member in (k, v):
            if isinstance(member, tuple):
                out.extend(member)
            else:
                out.append(member)
    return out


def handoff_raw_nbytes(handoff: KVHandoff) -> int:
    """Uncompressed payload bytes of a handoff (every wire tensor's
    bytes): ``disagg.handoff_bytes_raw``'s increment."""
    return sum(int(a.nbytes) if isinstance(a, np.ndarray)
               else a.numel() * a.element_size() for a in _leaves(handoff))


def _wire_tensors(handoff: KVHandoff,
                  head_ranges: list[tuple[int, int]] | None) -> list:
    """The tensors framed, in wire order: :func:`_leaves`, or with
    ``head_ranges`` every KV leaf (never the prompt) as one contiguous
    slice per ``(lo, hi)`` destination head tile (sender-side resharding;
    ``parallel.sharding.head_tiles`` builds legal tiles). Tiles that do
    not cover the head axis contiguously raise :class:`HandoffError`."""
    leaves = _leaves(handoff)
    if not head_ranges:
        return leaves
    out = [leaves[0]]
    for arr in leaves[1:]:
        h = int(arr.shape[1])
        cover = 0
        for lo, hi in head_ranges:
            if int(lo) != cover or hi <= lo:
                raise HandoffError(f"head_ranges {head_ranges} do not tile "
                                   f"the {h}-head axis contiguously")
            cover = int(hi)
        if cover != h:
            raise HandoffError(f"head_ranges cover {cover} of {h} kv heads")
        for lo, hi in head_ranges:
            piece = arr[:, lo:hi]
            out.append(np.ascontiguousarray(piece)
                       if isinstance(piece, np.ndarray)
                       else piece.contiguous())
    return out


def head_ranges_for(engine, handoff: KVHandoff):
    """The destination head tiles of ``handoff`` for the decode batcher
    ``engine``: its tp shards' ``head_tiles``, or None (whole-leaf frames)
    for an unsharded batcher, an empty handoff or heads that do not
    tile."""
    mesh = getattr(engine, "_mesh", None)
    if mesh is None:
        return None
    tp = int(dict(mesh.shape).get(getattr(engine, "_axis", "tp"), 1))
    if tp <= 1 or not handoff.blocks:
        return None
    k0 = handoff.blocks[0][0]
    kv_heads = int((k0[0] if isinstance(k0, tuple) else k0).shape[1])
    if kv_heads % tp:
        return None
    return head_tiles(kv_heads, tp)


def pack_handoff(handoff: KVHandoff, wire_codec: str = "raw",
                 head_ranges: list[tuple[int, int]] | None = None) -> Message:
    """Frame a handoff: every tensor one zero-copy codec frame
    (``comm.codec.pack_frames`` with the raw codec: scatter-write parts,
    no payload copy) concatenated in wire order, and a page annex with the
    geometry, per-tensor frame lengths and a crc32 over the payload.

    ``wire_codec`` other than "raw" encodes each tensor with the
    ``ops/quantize`` page codecs first (lossless "lz", or lossy "int8" /
    "int4" / "zfp" on floating tensors only); the annex then carries each
    tensor's codec meta and the crc covers the encoded payload.
    ``head_ranges`` frames each KV tensor as one slice per head tile, in
    tile order, recorded in the annex."""
    parts: list = []
    frame_lens: list[int] = []
    crc = 0
    leaf_meta: list[dict] | None = None
    wire = _wire_tensors(handoff, head_ranges)
    if wire_codec != "raw":
        leaf_meta = []
        for arr in wire:
            payload, meta = encode_page(arr, wire_codec)
            frame_lens.append(len(payload))
            leaf_meta.append(meta)
            crc = zlib.crc32(payload, crc)
            parts.append(memoryview(payload))
    else:
        raw = codec.get_codec("none")
        for arr in wire:
            frames = codec.pack_frames(raw, arr)
            frame_lens.append(codec.frames_nbytes(frames))
            for p in frames:
                # Integrity: flipped bits in a KV page would otherwise
                # scatter silently into a live pool.
                crc = zlib.crc32(p, crc)
            parts.extend(frames)
    meta = {
        "req_id": int(handoff.req_id),
        "page_size": int(handoff.page_size),
        "n_pages": int(handoff.n_pages),
        "quantized": bool(handoff.quantized),
        "kv_dtype": handoff.kv_dtype,
        "blocks": len(handoff.blocks),
        "prompt_len": int(handoff.prompt.shape[0]),
        "frame_lens": frame_lens,
        "crc32": crc,
    }
    if head_ranges:
        meta["head_ranges"] = [[int(lo), int(hi)] for lo, hi in head_ranges]
    if leaf_meta is not None:
        meta["wire_codec"] = wire_codec
        meta["leaf_meta"] = leaf_meta
    return Message(msg_type=MSG_KV_PAGES, stage_index=0,
                   request_id=int(handoff.req_id), attempt=0, payload=parts,
                   page_annex=json.dumps(meta).encode())


def unpack_handoff(msg: Message) -> KVHandoff:
    """Decode a ``MSG_KV_PAGES`` message into a :class:`KVHandoff`. On the
    raw wire the tensors VIEW the message's receive buffer (no payload
    copy). Any malformed annex, frame or geometry raises
    :class:`HandoffError`."""
    try:
        if msg.msg_type != MSG_KV_PAGES:
            raise ValueError(f"not a KV-pages message: {msg.msg_type}")
        if msg.page_annex is None:
            raise ValueError("missing page annex")
        meta = json.loads(msg.page_annex.decode())
        n_blocks = int(meta["blocks"])
        quantized = bool(meta["quantized"])
        got_crc = zlib.crc32(msg.payload)
        if got_crc != int(meta["crc32"]):
            raise ValueError(
                f"payload crc mismatch ({got_crc:#x} != "
                f"{int(meta['crc32']):#x}) — corrupt KV pages")
        if meta.get("wire_codec"):
            mv = memoryview(msg.payload)
            lens = [int(x) for x in meta["frame_lens"]]
            if sum(lens) != len(mv):
                raise ValueError(f"frame lengths sum to {sum(lens)}, payload "
                                 f"is {len(mv)} bytes")
            arrs, off = [], 0
            for ln, lmeta in zip(lens, meta["leaf_meta"]):
                arrs.append(decode_page(mv[off:off + ln], lmeta))
                off += ln
        else:
            arrs = codec.unpack_many(msg.payload, meta["frame_lens"])
        per_block = 4 if quantized else 2
        ranges = meta.get("head_ranges")
        if ranges:
            # Reassemble each KV tensor's head tiles on the host.
            r = len(ranges)
            if len(arrs) != 1 + n_blocks * per_block * r:
                raise ValueError(f"{len(arrs)} tensors for {n_blocks} blocks "
                                 f"x {r} head tiles (quantized={quantized})")
            widths = [int(hi) - int(lo) for lo, hi in ranges]
            joined = [arrs[0]]
            for i in range(n_blocks * per_block):
                pieces = arrs[1 + i * r: 1 + (i + 1) * r]
                for p, w in zip(pieces, widths):
                    if p.ndim < 2 or p.shape[1] != w:
                        raise ValueError(f"head tile shape {tuple(p.shape)} "
                                         f"!= declared width {w}")
                joined.append(pieces[0] if r == 1 else torch.cat(pieces, 1))
            arrs = joined
        if len(arrs) != 1 + n_blocks * per_block:
            raise ValueError(f"{len(arrs)} tensors for {n_blocks} blocks "
                             f"(quantized={quantized})")
        prompt = np.asarray(arrs[0].numpy(), np.int32).reshape(-1)
        if prompt.shape[0] != int(meta["prompt_len"]):
            raise ValueError("prompt length mismatch")
        blocks = []
        it = iter(arrs[1:])
        for _ in range(n_blocks):
            if quantized:
                blocks.append(((next(it), next(it)), (next(it), next(it))))
            else:
                blocks.append((next(it), next(it)))
        return KVHandoff(
            req_id=int(meta["req_id"]), prompt=prompt,
            page_size=int(meta["page_size"]), n_pages=int(meta["n_pages"]),
            quantized=quantized, blocks=blocks,
            kv_dtype=str(meta.get("kv_dtype")
                         or ("int8" if quantized else "native")),
        )
    except HandoffError:
        raise
    except Exception as e:  # noqa: BLE001 — any decode failure is one error
        raise HandoffError(f"malformed KV handoff: {e!r}") from e


def loopback(msg: Message) -> Message:
    """The in-process transport: gather the frame as ``send_msg`` would
    hand it to the socket (``frame_parts``), then re-parse it through
    ``parse_frame`` (``recv_msg``'s body). The returned payload views the
    gathered buffer."""
    wire = bytearray(b"".join(frame_parts(msg)))
    body = memoryview(wire)[_LEN_PREFIX:]
    expect = int.from_bytes(wire[:_LEN_PREFIX], "big")
    if len(body) != expect:
        raise HandoffError(f"truncated frame: {len(body)} of {expect} bytes")
    try:
        return parse_frame(body)
    except ConnectionError as e:
        raise HandoffError(str(e)) from e


@dataclasses.dataclass
class _PrefillJob:
    req_id: int
    prompt: np.ndarray
    #: Positions to prefill: the prompt's full pages only ([0, m * P)); the
    #: partial last page prefills decode-side as the suffix pass.
    target: int
    slot: int = -1
    pf_done: int = 0
    #: Set when its sp dispatch failed: the sp scan never picks it again.
    no_sp: bool = False


class PrefillWorker:
    """The prefill tier: admission and chunked prefill against its OWN
    paged pool, producing :class:`KVHandoff` s.

    Drives like a small batcher: :meth:`submit` queues a request; each
    :meth:`step` admits waiting jobs into free slots (FIFO, all-or-nothing
    page reservation), runs ONE page-aligned chunk pass per active slot
    (``prefill_chunk`` bounds any single pass; None = the whole span in
    one), then copies finished jobs' pages to the host and frees them. The
    chunk pass is the decode batcher's chunked-prefill body (the model's
    ``prefill_chunk_paged`` over the power-of-two padded window), so the
    pages it hands off are what the decode side's own chunked prefill
    writes with the same chunk schedule.

    ``lm`` must sit on ``device`` (None: the CUDA card, raising without
    one). ``prefill`` (``sp_width`` above 1) sends jobs of at least
    ``sp_threshold`` tokens through a sequence-parallel ring instead
    (``parallel/sp_prefill.SPPrefiller`` on ``sp_mesh``, by default a ring
    naming ``device`` ``sp_width`` times): the whole span in one dispatch,
    never in the pool. A failed sp dispatch falls back to the chunk path
    when the pool can hold the job, else the job lands in
    :attr:`failed_jobs`."""

    def __init__(self, lm: TransformerLM, page_size: int = 128,
                 slots: int = 2, pool_pages: int | None = None,
                 prefill_chunk: int | None = None,
                 kv_cache_dtype: str = "native", name: str = "prefill0",
                 prefill: PrefillConfig | None = None, device=None,
                 sp_mesh=None):
        if kv_cache_dtype not in ("native", "int8", "int4"):
            raise ValueError(f"kv_cache_dtype={kv_cache_dtype!r}: expected "
                             "'native', 'int8' or 'int4'")
        if prefill_chunk is not None and (
                prefill_chunk < page_size or prefill_chunk % page_size):
            raise ValueError(
                f"prefill_chunk must be a positive multiple of page_size "
                f"{page_size}, got {prefill_chunk}")
        self.device = resolve_device(device)
        if lm.device != self.device:
            raise ValueError(f"the prefill tier's model is on {lm.device}, "
                             f"not on {self.device}")
        self.lm = lm
        self.name = name
        self.page_size = page_size
        self.kv_cache_dtype = kv_cache_dtype
        self.quantized = kv_cache_dtype != "native"
        self._chunk = prefill_chunk
        block0 = lm.blocks[0]
        heads, hd = block0.cache_heads, block0.head_dim
        if kv_cache_dtype == "int4" and hd % 2:
            raise ValueError(
                f"kv_cache_dtype='int4' needs an even head_dim, got {hd}")
        pps = -(-lm.max_len // page_size)
        if pool_pages is None:
            pool_pages = slots * pps + 1
        self._pager = Pager(pool_pages, slots, pps)
        vw = hd // 2 if kv_cache_dtype == "int4" else hd
        dev = self.device

        def one_pool():
            if self.quantized:
                return (torch.zeros(pool_pages, heads, page_size, vw,
                                    dtype=torch.int8, device=dev),
                        torch.zeros(pool_pages, heads, page_size, 1,
                                    dtype=torch.float32, device=dev))
            return torch.zeros(pool_pages, heads, page_size, hd,
                               dtype=lm.dtype, device=dev)

        self._pools = [(one_pool(), one_pool()) for _ in lm.block_names]
        self._queue: collections.deque[_PrefillJob] = collections.deque()
        self._slots: list[_PrefillJob | None] = [None] * slots
        self.prefill_tokens = 0
        self.handoffs = 0
        #: The sequence-parallel state: the config and the prefiller that
        #: runs a whole span over the ranks (None: off).
        self._sp_cfg = prefill
        self._sp: SPPrefiller | None = None
        self.sp_prefills = 0
        #: Failed sp dispatches (each fell back to the chunk path or landed
        #: in failed_jobs).
        self.sp_failures = 0
        #: ``(req_id, reason)`` of jobs that could neither run nor fall back
        #: to the chunk path; the server (or router) driving this tier
        #: drains it every tick and fails each request cleanly. Only the
        #: sequence-parallel path appends to it.
        self.failed_jobs: list[tuple[int, str]] = []
        if prefill is not None and prefill.enabled:
            if sp_mesh is None:
                sp_mesh = build_sp_mesh(prefill.sp_width, 1, prefill.sp_axis,
                                        devices=[dev] * prefill.sp_width)
            self._sp = SPPrefiller(
                lm, sp_mesh, page_size, kv_cache_dtype=kv_cache_dtype,
                sp_axis=prefill.sp_axis,
                tp_axis="tp" if "tp" in sp_mesh.shape else None,
                name=f"{name}-sp")
            global_metrics().set_gauge("prefill.sp_width", float(self._sp.sp))

    # -- request lifecycle -------------------------------------------------

    def submit(self, req_id: int, prompt) -> int:
        """Queue one prompt; returns the full pages its handoff will cover.
        Raises ``ValueError`` for a prompt with no full page or more pages
        than the pool holds (the placement policy screens both)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        s0 = prompt.shape[0]
        m = (s0 - 1) // self.page_size
        if m < 1:
            raise ValueError(f"prompt of {s0} tokens has no full "
                             f"{self.page_size}-token page to hand off")
        # sp-eligible jobs never touch the pool: the bound does not apply.
        if m > self._pager.num_allocatable and not self.sp_eligible(s0):
            raise ValueError(f"prompt needs {m} pages but the prefill pool "
                             f"holds {self._pager.num_allocatable}")
        self._queue.append(_PrefillJob(req_id=req_id, prompt=prompt,
                                       target=m * self.page_size))
        return m

    def cancel(self, req_id: int) -> bool:
        """Drop a queued or mid-prefill job (its pages free at once); False
        when the job is not here."""
        for i, job in enumerate(self._queue):
            if job.req_id == req_id:
                del self._queue[i]
                return True
        for i, job in enumerate(self._slots):
            if job is not None and job.req_id == req_id:
                self._pager.free_slot(i)
                self._slots[i] = None
                return True
        return False

    def pending(self) -> int:
        """Jobs queued or mid-prefill."""
        return len(self._queue) + sum(1 for j in self._slots if j is not None)

    def sp_eligible(self, s0: int) -> bool:
        """Whether a prompt of ``s0`` tokens takes the sequence-parallel
        path (``PrefillConfig.sp_threshold``). The placement policy asks
        too: sp jobs are exempt from the pool-capacity bound."""
        return (self._sp is not None
                and s0 >= self._sp_cfg.sp_threshold
                and (s0 - 1) // self.page_size >= 1)

    def _sp_pass(self, job: _PrefillJob) -> KVHandoff | None:
        """One sp-eligible job through the sequence-parallel ring: the
        whole prefill in ONE dispatch, the handoff built straight from its
        page-major output; the job never touches the pool. On failure: the
        chunk path when the pool can cover the job (front re-queue), else
        the request fails cleanly through :attr:`failed_jobs`."""
        tracer = global_tracer()
        t0 = tracer.now() if tracer.enabled else 0.0
        try:
            m, blocks = self._sp.prefill(job.prompt)
        except Exception as e:  # noqa: BLE001 — degrade, never wedge
            self.sp_failures += 1
            global_metrics().inc("prefill.sp_failures_total")
            global_flight_recorder().record(
                "sp_prefill", request=job.req_id, pages=0, sp=self._sp.sp,
                tier="prefill", ok=False)
            if job.target // self.page_size <= self._pager.num_allocatable:
                log.exception("sp prefill failed for request %d; falling "
                              "back to the chunked path", job.req_id)
                job.no_sp = True
                self._queue.appendleft(job)
            else:
                log.exception("sp prefill failed for request %d, which the "
                              "pool cannot hold", job.req_id)
                self.failed_jobs.append((job.req_id, str(e)[:200]))
            return None
        toks = m * self.page_size
        self.prefill_tokens += toks
        self.sp_prefills += 1
        self.handoffs += 1
        reg = global_metrics()
        reg.inc("disagg.prefill_tokens_total", float(toks))
        reg.inc("disagg.sp_prefills_total")
        if tracer.enabled:
            tracer.add_span("disagg.sp_prefill", start=t0, end=tracer.now(),
                            request=job.req_id, pages=m, sp=self._sp.sp)
        global_flight_recorder().record(
            "sp_prefill", request=job.req_id, pages=m, sp=self._sp.sp,
            tier="prefill", ok=True)
        return KVHandoff(req_id=job.req_id, prompt=job.prompt,
                         page_size=self.page_size, n_pages=m,
                         quantized=self.quantized, blocks=blocks,
                         kv_dtype=self.kv_cache_dtype)

    def _admit(self) -> None:
        for i, job in enumerate(self._slots):
            if job is not None or not self._queue:
                continue
            nxt = self._queue[0]
            # FIFO head-of-line, all-or-nothing: the batcher's discipline.
            if not self._pager.alloc(i, nxt.target // self.page_size):
                self._pager.free_slot(i)
                return
            nxt = self._queue.popleft()
            nxt.slot, nxt.pf_done = i, 0
            self._slots[i] = nxt

    @torch.no_grad()
    def _pass(self, job: _PrefillJob) -> None:
        """One chunk pass: positions [pf_done, pf_done + chunk) of the
        job's full pages through every block's ``prefill_chunk_paged``
        (K4 / K4q on the card), the window padded to a power-of-two page
        count with trash page 0."""
        P = self.page_size
        pos0 = job.pf_done
        clen = min(self._chunk or job.target, job.target - pos0)
        n_strip = (pos0 + clen) // P
        owned = self._pager.owned(job.slot)
        n_pad = 1 << (n_strip - 1).bit_length()
        pages = torch.as_tensor(owned[:n_strip] + [0] * (n_pad - n_strip),
                                dtype=torch.int32).to(self.device)
        ids = torch.as_tensor(job.prompt[pos0:pos0 + clen][None],
                              dtype=torch.int64).to(self.device)
        pos_ids = pos0 + torch.arange(clen, device=self.device)[None]
        h = self.lm.embed.embed_positions(ids, pos_ids)
        for block, (kp, vp) in zip(self.lm.blocks, self._pools):
            h, _, _ = block.prefill_chunk_paged(h, kp, vp, pages, pos0)
        job.pf_done = pos0 + clen
        self.prefill_tokens += clen
        global_metrics().inc("disagg.prefill_tokens_total", float(clen))

    def _finish(self, job: _PrefillJob) -> KVHandoff:
        """Copy the job's full pages off every block's pool in ONE
        device->host copy, free them, and build the handoff."""
        m = job.target // self.page_size
        pages = torch.as_tensor(self._pager.owned(job.slot)[:m],
                                dtype=torch.int64).to(self.device)
        members = [mem.index_select(0, pages) for pair in self._pools
                   for c in pair
                   for mem in (c if isinstance(c, tuple) else (c,))]
        it = iter(host_copy(members))
        blocks = [tuple(tuple(next(it) for _ in c) if isinstance(c, tuple)
                        else next(it) for c in pair) for pair in self._pools]
        self._pager.free_slot(job.slot)
        self._slots[job.slot] = None
        self.handoffs += 1
        return KVHandoff(req_id=job.req_id, prompt=job.prompt,
                         page_size=self.page_size, n_pages=m,
                         quantized=self.quantized, blocks=blocks,
                         kv_dtype=self.kv_cache_dtype)

    def step(self) -> list[KVHandoff]:
        """One scheduling round: at most ONE sp-eligible job through the
        sequence-parallel ring (its whole span: the sp counterpart of the
        chunk pass's stall bound), then admit waiting jobs, run ONE chunk
        pass per active slot, and hand off the finished ones. Returns this
        round's handoffs (possibly none)."""
        done: list[KVHandoff] = []
        if self._sp is not None:
            for i, job in enumerate(self._queue):
                if not job.no_sp and self.sp_eligible(job.prompt.shape[0]):
                    del self._queue[i]
                    h = self._sp_pass(job)
                    if h is not None:
                        done.append(h)
                    break
        self._admit()
        tracer = global_tracer()
        for job in list(self._slots):
            if job is None:
                continue
            t0 = tracer.now() if tracer.enabled else 0.0
            self._pass(job)
            if tracer.enabled:
                tracer.add_span("disagg.prefill_chunk", start=t0,
                                end=tracer.now(), request=job.req_id,
                                pos0=int(job.pf_done))
            if job.pf_done >= job.target:
                done.append(self._finish(job))
        return done

    def stats(self) -> dict:
        ps = self._pager.stats()
        return {
            "queued": len(self._queue),
            "active": sum(1 for j in self._slots if j is not None),
            "prefill_tokens": self.prefill_tokens,
            "handoffs": self.handoffs,
            "sp_prefills": self.sp_prefills,
            "sp_width": self._sp.sp if self._sp is not None else 1,
            "sp_failures": self.sp_failures,
            "pool_pages": ps.num_pages,
            "pages_in_use": ps.in_use,
        }


@dataclasses.dataclass
class _Routed:
    """Server-side request state: where the request lives now."""

    tier: str  # "prefill" | "decode" | "done"
    rid: int | None = None  # decode-batcher id once submitted there
    kwargs: dict | None = None  # deferred decode.submit arguments
    t_submit: float = 0.0


class DisaggServer:
    """The disaggregated submit path: one placement policy in front of a
    :class:`PrefillWorker` and a paged decode
    :class:`~adapt_tpu_torch.runtime.continuous.ContinuousBatcher` on the
    same ``device`` (None: the CUDA card, raising without one).

    Mirrors the batcher's synchronous serving surface (``submit`` / ``tick``
    / ``cancel`` / ``run`` / ``result`` / ``logprobs`` / ``stats``). Each
    :meth:`tick` keeps the prefill tier's role-tagged lease alive, runs one
    prefill round, lands finished handoffs over the loopback wire, submits
    the landed requests to the decode batcher (prefix-hit admission) and
    runs one decode tick."""

    def __init__(self, decode: ContinuousBatcher, prefill: PrefillWorker,
                 config: DisaggConfig | None = None, registry=None,
                 lease_ttl_s: float = 2.0, telemetry_url: str | None = None,
                 wire_codec: str | None = None, device=None):
        dev = resolve_device(device)
        for tier, d in (("decode", decode.device),
                        ("prefill", prefill.device)):
            if d != dev:
                raise ValueError(f"the {tier} tier is on {d}, not on {dev}")
        if not decode._paged:
            raise ValueError(
                "DisaggServer requires a paged decode batcher "
                "(kv_layout='paged'): the handoff lands through the prefix "
                "cache")
        if prefill.page_size != decode._page:
            raise ValueError(f"prefill page size {prefill.page_size} != "
                             f"decode page size {decode._page}")
        dec_dt = decode._kv_quant or "native"
        if prefill.kv_cache_dtype != dec_dt:
            raise ValueError(
                "prefill/decode kv_cache_dtype mismatch (prefill "
                f"{prefill.kv_cache_dtype!r}, decode {dec_dt!r})")
        if prefill.lm.vocab != decode.lm.vocab:
            raise ValueError("prefill/decode vocab mismatch")
        self.decode = decode
        self.prefill = prefill
        self.cfg = config or DisaggConfig()
        if wire_codec is None:
            # One config names every tier boundary's codec: the decode
            # batcher's CacheTierConfig.wire_codec, else the raw frames.
            tier_cfg = decode._tier_cfg
            wire_codec = tier_cfg.wire_codec if tier_cfg else "raw"
        if wire_codec not in PAGE_CODECS:
            raise ValueError(f"wire_codec={wire_codec!r}: expected one of "
                             f"{PAGE_CODECS}")
        self.wire_codec = wire_codec
        if self.cfg.busy_prompt_threshold <= decode._page:
            log.warning(
                "busy_prompt_threshold %d <= page size %d: busy-tier prompts "
                "just over the threshold may have no full page and will "
                "collocate anyway", self.cfg.busy_prompt_threshold,
                decode._page)
        self._registry = registry
        self._lease_ttl = lease_ttl_s
        self._lease_key = f"prefill:{prefill.name}"
        #: Lease metadata; ``telemetry_url`` advertises the tier's exporter
        #: for a dispatcher that polls the registry.
        self._lease_meta = {"role": "prefill"}
        if telemetry_url is not None:
            self._lease_meta["telemetry"] = telemetry_url
        self._lease_token = None
        if registry is not None:
            # Role-tagged: the dispatcher's acquisition skips it, and the
            # policy stops routing to the tier when it expires.
            self._lease_token = registry.register(
                self._lease_key, meta=dict(self._lease_meta),
                ttl_s=lease_ttl_s)
        cap = decode._capacity
        self._cap_lease_s = cap.cfg.lease_refresh_s if cap is not None else 0.0
        self._cap_last_lease = 0.0
        #: Drain switch (close()): no lease keepalive, every placement
        #: collocates from then on.
        self._closed = False
        self._route: dict[int, _Routed] = {}
        self._done: dict[int, np.ndarray] = {}
        #: sid -> decode rid of CLAIMED requests (bounded), so logprobs()
        #: resolves after result().
        self._claimed_rids: collections.OrderedDict[int, int] = (
            collections.OrderedDict())
        self._next_sid = 0
        self.disaggregated = 0
        self.collocated = 0
        self.failed = 0
        #: Placements the threshold chose but the prefill tier could not
        #: take (pool bound, dead lease): collocated instead.
        self.fallbacks = 0
        ctrl = decode._controller
        if ctrl is not None:
            # The controller's busy_threshold rung acts on this server
            # (held weakly) from now on.
            ctrl.attach_disagg(self)

    # -- placement ---------------------------------------------------------

    def _prefill_alive(self) -> bool:
        if self._registry is None:
            return True
        return self._lease_key in self._registry.alive(role="prefill")

    def _fallback(self, s0: int, why: str) -> bool:
        """A prompt the threshold sent to the prefill tier collocates
        because the tier cannot take it: counted and logged."""
        self.fallbacks += 1
        log.info("prompt of %d tokens collocated: %s", s0, why)
        return False

    def _placement(self, s0: int, slo: SLOSpec | None = None) -> bool:
        """True = disaggregate. A high-priority request (> 0) always sees
        the busy threshold; every fallback is collocated."""
        m = (s0 - 1) // self.decode._page
        if m < 1:
            return False  # nothing to hand off
        slots = self.decode.slots
        occupancy = sum(1 for s in slots if s.req is not None) / len(slots)
        busy = occupancy >= self.cfg.busy_occupancy or (
            slo is not None and slo.priority > 0)
        threshold = (self.cfg.busy_prompt_threshold if busy
                     else self.cfg.prompt_threshold)
        if s0 < threshold:
            return False
        if (m > self.prefill._pager.num_allocatable
                and not self.prefill.sp_eligible(s0)):
            # Unless the tier's sequence-parallel ring takes it: sp jobs
            # hold their span on the ring, never in the pool.
            return self._fallback(s0, f"{m} pages exceed the prefill pool")
        if not self._prefill_alive():
            return self._fallback(s0, "the prefill tier's lease expired")
        return True

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt, steps: int, temperature: float = 0.0,
               top_k: int | None = None, top_p: float | None = None,
               eos_id: int | None = None, rng=None, stop: list | None = None,
               on_token: Callable[[int, int, int], None] | None = None,
               slo: SLOSpec | None = None) -> int:
        """Queue one request; returns the SERVER-side id (for
        :meth:`cancel` / :meth:`result`). Collocated requests go to the
        decode batcher at once; disaggregated ones enter the prefill tier
        and reach the batcher when their pages land. TTFT, queue wait and
        SLOs measure from THIS call."""
        dec = self.decode
        # The decode side's validation, so a disaggregated request fails
        # here, synchronously, as a collocated submit would.
        prompt, _ = dec.validate_request(
            prompt, steps, temperature=temperature, top_k=top_k,
            top_p=top_p, rng=rng, stop=stop, slo=slo)
        s0 = prompt.shape[0]
        if s0 > self.prefill.lm.max_len:
            raise ValueError(f"prompt {s0} exceeds the prefill tier's "
                             f"max_len {self.prefill.lm.max_len}")
        sid = self._next_sid
        self._next_sid += 1
        if on_token is not None:
            # Callbacks see the SERVER id, the one cancel() / result()
            # take, not the decode batcher's own.
            user_cb = on_token

            def on_token(rid, tok, idx, _sid=sid, _cb=user_cb):
                _cb(_sid, tok, idx)

        kwargs = dict(steps=steps, temperature=temperature, top_k=top_k,
                      top_p=top_p, eos_id=eos_id, rng=rng, stop=stop,
                      on_token=on_token, slo=slo)
        now = time.perf_counter()
        if self._placement(s0, slo):
            # A request the decode queue would reject now fails now, before
            # its prefill runs.
            dec.admission_check(slo, request=sid)
            self.disaggregated += 1
            global_metrics().inc("disagg.disaggregated_total")
            self._route[sid] = _Routed(tier="prefill", kwargs=kwargs,
                                       t_submit=now)
            self.prefill.submit(sid, prompt)
            self._route[sid].kwargs["prompt"] = prompt
        else:
            self.collocated += 1
            global_metrics().inc("disagg.collocated_total")
            rid = dec.submit(prompt, t_submit=now, **kwargs)
            self._route[sid] = _Routed(tier="decode", rid=rid, t_submit=now)
        return sid

    def cancel(self, sid: int) -> bool:
        r = self._route.get(sid)
        if r is None or r.tier == "done":
            return False
        if r.tier == "decode":
            return self.decode.cancel(r.rid)
        # Still in the prefill tier: nothing streamed yet.
        if self.prefill.cancel(sid):
            self._done[sid] = np.zeros((0,), np.int32)
            r.tier = "done"
            r.kwargs = None
            global_flight_recorder().record("cancel", request=sid,
                                            state="prefill")
            global_flight_recorder().record("finish", request=sid,
                                            reason="cancelled", tokens=0)
            return True
        return False

    def _fail(self, sid: int, err: Exception) -> None:
        """A handoff that cannot land fails the REQUEST: an empty result,
        loud flight events, serving goes on."""
        self.failed += 1
        self._done[sid] = np.zeros((0,), np.int32)
        r = self._route.get(sid)
        if r is not None:
            r.tier = "done"
            r.kwargs = None
        global_metrics().inc("disagg.handoff_failed_total")
        global_flight_recorder().record("request_failed", request=sid,
                                        reason=str(err)[:200])
        global_flight_recorder().record("finish", request=sid,
                                        reason="failed", tokens=0)
        log.error("KV handoff failed for request %d: %s", sid, err)

    def _land(self, handoff: KVHandoff) -> None:
        """Stream one handoff and land it: frame -> loopback -> parse ->
        adopt into the decode pool -> decode submit (a prefix hit)."""
        sid = handoff.req_id
        r = self._route.get(sid)
        if r is None or r.tier != "prefill":
            return  # cancelled between the last chunk and the handoff
        t0 = time.perf_counter()
        try:
            ranges = head_ranges_for(self.decode, handoff)
            msg = pack_handoff(handoff, wire_codec=self.wire_codec,
                               head_ranges=ranges)
            wire_bytes = sum(p.nbytes for p in frame_parts(msg))
            raw_bytes = handoff_raw_nbytes(handoff)
            landed = unpack_handoff(loopback(msg))
            adopted = self.decode.adopt_prefill_pages(
                landed.prompt, landed.blocks, landed.page_size,
                landed.kv_dtype)
        except (HandoffError, ValueError) as e:
            self._fail(sid, e)
            return
        wall = time.perf_counter() - t0
        reg = global_metrics()
        reg.inc("disagg.handoff_bytes", float(wire_bytes))
        reg.inc("disagg.handoff_bytes_raw", float(raw_bytes))
        reg.inc("disagg.pages_streamed", float(handoff.n_pages))
        reg.observe("disagg.handoff_s", wall)
        global_flight_recorder().record(
            "kv_handoff", request=sid, pages=handoff.n_pages, adopted=adopted,
            bytes=wire_bytes, blocks=len(handoff.blocks),
            tiles=len(ranges) if ranges else 1,
            wall_s=round(wall, 6))
        kwargs = dict(r.kwargs)
        prompt = kwargs.pop("prompt")
        try:
            rid = self.decode.submit(prompt, t_submit=r.t_submit, **kwargs)
        except (ValueError, TypeError, QueueFullError) as e:
            # Admission control filled up while the prefill ran: the
            # adopted pages stay rc=0 in the prefix LRU; only this request
            # fails.
            self._fail(sid, e)
            return
        r.tier, r.rid, r.kwargs = "decode", rid, None

    def tick(self) -> int:
        """One server round: lease keepalive, prefill step, land handoffs,
        decode tick. Returns the decode tick's committed slots. Under the
        batcher's pipelined tick the handoffs landed here still enter this
        call's admission; only result delivery lags a round."""
        if (self._registry is not None and not self._closed
                and not self._registry.heartbeat(self._lease_key,
                                                 self._lease_ttl)):
            # Expired between ticks: the tier is ticking, so it is alive;
            # re-register (close() is the drain switch).
            self._lease_token = self._registry.register(
                self._lease_key, meta=dict(self._lease_meta),
                ttl_s=self._lease_ttl)
        if (self._registry is not None and not self._closed
                and self._cap_lease_s > 0):
            cap_now = time.monotonic()
            if cap_now - self._cap_last_lease >= self._cap_lease_s:
                self._cap_last_lease = cap_now
                self._lease_meta["capacity"] = prefill_tier_book(self.prefill)
                self._lease_token = self._registry.register(
                    self._lease_key, meta=dict(self._lease_meta),
                    ttl_s=self._lease_ttl)
        for handoff in self.prefill.step():
            self._land(handoff)
        if self.prefill.failed_jobs:
            # A job the prefill tier could neither run nor fall back on
            # fails its REQUEST cleanly, as a corrupt handoff does.
            for sid, err in self.prefill.failed_jobs:
                self._fail(sid, RuntimeError(err))
            self.prefill.failed_jobs.clear()
        return self.decode.tick()

    def drain(self) -> int:
        """Commit the decode tier's tick in flight, if any."""
        return self.decode.drain()

    def _busy(self) -> bool:
        if self.prefill.pending():
            return True
        st = self.decode.stats()
        return bool(st["active"] or st["queued"])

    def run(self, max_ticks: int = 100_000) -> dict[int, np.ndarray]:
        """Tick until every submitted request completed; returns
        ``{server_id: tokens}`` (failed or prefill-cancelled requests map to
        empty arrays) and clears the finished set."""
        ticks = 0
        while self._busy():
            self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(f"run() exceeded {max_ticks} ticks")
        return self._collect()

    def _collect(self) -> dict[int, np.ndarray]:
        self.decode.drain()
        dec_done = self.decode.run(max_ticks=1)  # drained: returns the dict
        out = dict(self._done)
        self._done = {}
        claimed = list(out)
        for sid, r in self._route.items():
            if r.tier == "decode" and r.rid in dec_done:
                out[sid] = dec_done[r.rid]
                claimed.append(sid)
        for sid in claimed:
            self._remember_rid(sid)
        return out

    def result(self, sid: int, max_ticks: int = 100_000) -> np.ndarray:
        """Drive ticks until ``sid`` finishes; returns (and claims) its
        tokens, empty for a failed or prefill-cancelled request."""
        ticks = 0
        while True:
            if sid in self._done:
                self._remember_rid(sid)
                return self._done.pop(sid)
            r = self._route.get(sid)
            if r is None:
                raise KeyError(f"unknown request {sid}")
            if r.tier == "decode":
                with self.decode._cv:
                    if r.rid in self.decode._done:
                        out = self.decode._done.pop(r.rid)
                        self._remember_rid(sid)
                        return out
            if r.tier == "done":
                raise KeyError(f"request {sid} already claimed")
            self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(f"result({sid}) exceeded {max_ticks} ticks")

    def _remember_rid(self, sid: int) -> None:
        r = self._route.pop(sid, None)
        if r is not None and r.rid is not None:
            self._claimed_rids[sid] = r.rid
            while len(self._claimed_rids) > 4096:
                self._claimed_rids.popitem(last=False)

    def logprobs(self, sid: int) -> np.ndarray:
        r = self._route.get(sid)
        rid = r.rid if r is not None else self._claimed_rids.get(sid)
        if rid is None:
            raise KeyError(f"no logprobs for request {sid}")
        return self.decode.logprobs(rid)

    @property
    def lm(self):
        return self.decode.lm

    @property
    def prompt_buckets(self):
        return self.decode.prompt_buckets

    def capacity_book(self) -> dict | None:
        """The decode batcher's capacity book with the prefill tier's
        nested under ``"prefill"`` (None when the capacity plane is
        off)."""
        book = self.decode.capacity_book()
        if book is None:
            return None
        book = dict(book)
        book["prefill"] = prefill_tier_book(self.prefill)
        return book

    def stats(self) -> dict:
        out = self.decode.stats()
        pf = self.prefill.stats()
        out.update(
            prefill_queued=pf["queued"],
            prefill_active=pf["active"],
            prefill_tier_tokens=pf["prefill_tokens"],
            handoffs=pf["handoffs"],
            disaggregated=self.disaggregated,
            collocated_submits=self.collocated,
            handoff_failed=self.failed,
            placement_fallbacks=self.fallbacks,
            sp_prefills=pf["sp_prefills"],
            sp_width=pf["sp_width"],
        )
        # The whole server's queue, so a drain loop waits for the prefill
        # tier too.
        out["queued"] += pf["queued"] + pf["active"]
        return out

    def close(self) -> None:
        """Drain switch: release the prefill tier's lease and stop
        renewing it; every later placement collocates. The decode
        batcher's own close() is the caller's."""
        self._closed = True
        if self._registry is not None:
            self._registry.deregister(self._lease_key, self._lease_token)
