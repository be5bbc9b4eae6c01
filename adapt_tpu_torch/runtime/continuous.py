"""Continuous batching: requests join and leave a RUNNING decode batch —
the dense core of ``adapt_tpu/runtime/continuous.py``'s
:class:`ContinuousBatcher` (``kv_layout="slots"``, ``kv_cache_dtype=
"native"``: the JAX package's defaults).

- A fixed number of SLOTS decode in lockstep. Each slot owns a dense KV
  strip of ``max_len + 1`` positions per block; position ``max_len`` is
  the trash slot where idle rows park their garbage writes (K2 masks by
  each row's own index, and serves the odd strip length directly).
- One tick admits queued requests into free slots (a prefill per
  admission, padded to a power-of-two bucket, through K1), then runs
  ``chunk`` decode steps (K2) over every slot and syncs with the host
  ONCE, to fetch the chunk's tokens and logprobs. Requests finishing
  mid-chunk decode a garbage tail the host drops.
- Per-slot sampling state (last token, position, temperature, top-k,
  top-p, seed, key counter, active mask) lives in device tensors, written
  at admission and retirement only; every host->device copy goes through
  :meth:`_h2d`, so ``stats()["h2d_transfers"]`` shows a steady tick
  stages nothing.
- Exact per-request streams: a token is keyed by (request seed, row 0,
  token index), as ``models.transformer_lm.generate`` keys a prompt run
  alone, so a request's stream equals ``generate()`` for it alone.

Lifecycle: ``submit`` / ``tick`` / ``run`` / ``cancel`` / ``result`` /
``logprobs`` / ``stats``, and ``start`` / ``stop`` for a server thread.
Request timelines feed the SLO histograms ``continuous.queue_wait_s``,
``continuous.ttft_s``, ``continuous.itl_s`` and
``continuous.request_latency_s``; admit/finish/cancel go to the flight
recorder. The paged pool, quantized caches, speculation, tensor
parallelism, recovery, the pipelined tick and traffic control are later
slices.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections.abc import Callable

import numpy as np
import torch

from adapt_tpu_torch.config import KernelConfig, SchedulerConfig
from adapt_tpu_torch.models.transformer_lm import (
    TransformerLM,
    chosen_logprob,
    sample_rows,
)
from adapt_tpu_torch.runtime.scheduler import AdmissionQueue, QueueFullError
from adapt_tpu_torch.utils.logging import get_logger
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.tracing import global_flight_recorder, global_tracer

log = get_logger("continuous")

__all__ = ["ContinuousBatcher", "QueueFullError"]


@dataclasses.dataclass
class _Request:
    req_id: int
    prompt: np.ndarray  # (s0,) int64
    steps: int
    temperature: float
    top_k: int  # == vocab -> no truncation
    top_p: float  # == 1.0 -> no nucleus truncation
    eos_id: int | None
    seed: int
    stop: tuple[tuple[int, ...], ...] = ()
    on_token: Callable[[int, int, int], None] | None = None
    t_submit: float = 0.0


@dataclasses.dataclass
class _Slot:
    idx: int = -1
    req: _Request | None = None
    s0: int = 0
    emitted: int = 0
    last_token: int = 0
    tokens: list = dataclasses.field(default_factory=list)
    lps: list = dataclasses.field(default_factory=list)
    t_first: float = 0.0
    t_last: float = 0.0
    obs_count: int = 0


class ContinuousBatcher:
    """Slot-based continuous batching over one LM on one device (the LM's
    device). ``top_k`` is the default for requests that pass none."""

    #: Max UNCLAIMED logprob streams retained (oldest evicted past it).
    _LPS_CAP = 4096

    def __init__(
        self,
        lm: TransformerLM,
        slots: int = 8,
        top_k: int | None = None,
        prompt_buckets: tuple[int, ...] | None = None,
        chunk: int = 8,
        kv_cache_dtype: str = "native",
        kv_layout: str = "slots",
        kernel: KernelConfig | None = None,
        scheduler: SchedulerConfig | None = None,
    ):
        if kv_cache_dtype not in ("native", "int8", "int4"):
            raise ValueError(
                f"kv_cache_dtype={kv_cache_dtype!r}: expected 'native', "
                "'int8' or 'int4'"
            )
        if kv_layout not in ("slots", "paged"):
            raise ValueError(
                f"kv_layout={kv_layout!r}: expected 'slots' or 'paged'"
            )
        if kv_cache_dtype != "native" or kv_layout != "slots":
            raise NotImplementedError(
                "only the dense native-cache batcher is ported so far "
                "(paged pool and quantized KV are later slices)"
            )
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if top_k is not None and not (1 <= top_k <= lm.vocab):
            raise ValueError(f"top_k {top_k} outside [1, {lm.vocab}]")
        self.lm = lm
        self.device = lm.device
        self._kernel = kernel or KernelConfig()
        if self._kernel.attn_impl == "xla" and self.device.type == "cuda":
            raise ValueError(
                "KernelConfig(attn_impl='xla') selects the plain attention, "
                "which the card's path refuses"
            )
        self.slots = [_Slot(idx=i) for i in range(slots)]
        self.top_k = top_k
        self.chunk = chunk
        if prompt_buckets is None:
            prompt_buckets, b = [], 8
            while b < lm.max_len:
                prompt_buckets.append(b)
                b *= 2
            prompt_buckets.append(lm.max_len)
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self._cache_len = lm.max_len + 1
        self._trash = lm.max_len
        block0 = lm.blocks[0]
        shape = (slots, block0.cache_heads, self._cache_len, block0.head_dim)
        dev, dt = self.device, lm.dtype
        self._caches = [
            (torch.zeros(shape, dtype=dt, device=dev),
             torch.zeros(shape, dtype=dt, device=dev))
            for _ in lm.block_names
        ]
        self._h2d_count = 0
        i64 = dict(dtype=torch.int64, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        #: Device-resident per-slot sampling state, written only by
        #: _stage_slot / _clear_slot and the decode chunk itself.
        self._dstate = {
            "tok": torch.zeros(slots, **i64),
            "pos": torch.full((slots,), self._trash, dtype=torch.int32,
                              device=dev),
            "seed": torch.zeros(slots, **i64),
            "kbase": torch.zeros(slots, **i64),
            "temp": torch.zeros(slots, **f32),
            "top_k": torch.full((slots,), lm.vocab, **i64),
            "top_p": torch.ones(slots, **f32),
            "active": torch.zeros(slots, dtype=torch.bool, device=dev),
        }
        #: Every request samples as row 0 of its own key stream.
        self._rows0 = torch.zeros(slots, **i64)
        self._queue = AdmissionQueue(scheduler)
        self._done: dict[int, np.ndarray] = {}
        self._done_lps: dict[int, np.ndarray] = {}
        self._cancelled: set[int] = set()
        #: req_id popped by the ticking thread but not yet slot-bound.
        self._admitting: int | None = None
        self._next_id = 0
        self._admitted = 0
        self._completed = 0
        self._ticks = 0
        self._rejected = 0
        self._prefill_tokens = 0
        #: Request-timeline SLO histograms (one perf_counter stamp per
        #: committed token; ITL samples flush once per tick).
        self.obs_timeline = True
        self._itl_pending: list[float] = []
        self._ttft_pending: list[float] = []
        self._tick_tokens = 0
        self._cv = threading.Condition()
        self._server: threading.Thread | None = None
        self._stopping = False
        self._server_error: BaseException | None = None

    # -- device-side pieces ------------------------------------------------

    def _h2d(self, x, dtype):
        """THE host->device staging funnel: counts every transfer, so the
        0-per-steady-tick contract is asserted, not assumed."""
        self._h2d_count += 1
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    def _stage_slot(self, ints, floats) -> None:
        """Write one admitted request's sampling row: ``ints`` (6,) =
        [slot, tok, pos, top_k, kbase, seed], ``floats`` (2,) = [temp,
        top_p] — two staged transfers per admission, not one per field."""
        d, i = self._dstate, ints[0:1]
        d["tok"].index_copy_(0, i, ints[1:2])
        d["pos"].index_copy_(0, i, ints[2:3].to(torch.int32))
        d["top_k"].index_copy_(0, i, ints[3:4])
        d["kbase"].index_copy_(0, i, ints[4:5])
        d["seed"].index_copy_(0, i, ints[5:6])
        d["temp"].index_copy_(0, i, floats[0:1])
        d["top_p"].index_copy_(0, i, floats[1:2])
        d["active"].index_fill_(0, i, True)

    def _clear_slot(self, idx: int) -> None:
        """Retire one slot's device row: park it at the trash position,
        identity sampling knobs, out of the active mask."""
        d = self._dstate
        d["pos"][idx] = self._trash
        for key, val in (("tok", 0), ("kbase", 0), ("seed", 0), ("temp", 0.0),
                         ("top_k", self.lm.vocab), ("top_p", 1.0),
                         ("active", False)):
            d[key][idx] = val

    def _step_chunk(self, *, do_sample, truncate, nucleus):
        """``chunk`` lockstep decode steps over the device-resident slot
        state; returns ((chunk, B) tokens, (chunk, B) logprobs) without a
        host sync. Active rows advance pos/kbase/tok by the whole chunk
        (a mid-chunk finish is cleared host-side); idle rows re-park."""
        d, lm, C = self._dstate, self.lm, self.chunk
        tokens, pos = d["tok"], d["pos"]
        toks, lps = [], []
        for j in range(C):
            x = lm.embed.embed_positions(tokens[:, None], pos[:, None])
            for block, (ck, cv) in zip(lm.blocks, self._caches):
                x, _, _ = block.decode_step(
                    x, ck, cv, pos, None,
                    attn_impl=self._kernel.attn_impl,
                    split=self._kernel.decode_split,
                )
            logits = lm.head(x)[:, 0]
            nxt = sample_rows(
                logits, d["temp"], d["top_k"], d["top_p"], d["seed"],
                self._rows0, d["kbase"] + j, do_sample=do_sample,
                truncate=truncate, nucleus=nucleus,
            )
            toks.append(nxt)
            lps.append(chosen_logprob(logits, nxt))
            tokens, pos = nxt, pos + 1
        active = d["active"]
        d["pos"] = torch.where(active, d["pos"] + C, self._trash).to(
            torch.int32)
        d["tok"] = torch.where(active, toks[-1], 0)
        d["kbase"] = torch.where(active, d["kbase"] + C, 0)
        return torch.stack(toks), torch.stack(lps)

    def _prefill(self, slot_idx: int, req: _Request, bucket: int):
        """Prefill ``req``'s prompt padded to ``bucket`` (K1), insert its
        K/V into slot ``slot_idx``'s strips, and pick the first token.
        Returns (token, logprob) with one host sync."""
        lm = self.lm
        s0 = req.prompt.shape[0]
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :s0] = req.prompt
        ids_t = self._h2d(ids, torch.int64)
        ints = self._h2d([req.top_k, req.seed], torch.int64)
        floats = self._h2d([req.temperature, req.top_p], torch.float32)
        h = lm.embed(ids_t)
        for block, (ck, cv) in zip(lm.blocks, self._caches):
            h, k, v = block.prefill(h, bucket)
            ck[slot_idx, :, :bucket] = k[0]
            cv[slot_idx, :, :bucket] = v[0]
        logits = lm.head(h[:, s0 - 1:s0])[:, 0]
        first = sample_rows(
            logits, floats[0:1], ints[0:1], floats[1:2], ints[1:2],
            self._rows0[:1], self._rows0[:1],
            do_sample=req.temperature > 0.0,
            truncate=req.top_k < lm.vocab, nucleus=req.top_p < 1.0,
        )
        lp = chosen_logprob(logits, first)
        host = torch.stack([first.double(), lp.double()]).cpu()
        self._prefill_tokens += s0
        if self.obs_timeline:
            global_metrics().inc("continuous.prefill_tokens_total", float(s0))
        return int(host[0, 0]), float(host[1, 0])

    # -- request lifecycle -------------------------------------------------

    def validate_request(self, prompt, steps, temperature=0.0, top_k=None,
                         top_p=None, rng=None, stop=None):
        """Raise exactly the errors :meth:`submit` would; returns the
        normalised prompt and effective ``top_k``."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        s0 = prompt.shape[0]
        if s0 < 1:
            raise ValueError("empty prompt")
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if s0 + steps > self.lm.max_len:
            raise ValueError(
                f"prompt {s0} + steps {steps} exceeds max_len "
                f"{self.lm.max_len}"
            )
        if s0 > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt {s0} exceeds largest bucket {self.prompt_buckets[-1]}"
            )
        if temperature > 0.0 and rng is None:
            raise ValueError("temperature > 0 requires an rng seed")
        top_k_eff = top_k if top_k is not None else self.top_k
        if top_k_eff is not None and not (1 <= top_k_eff <= self.lm.vocab):
            raise ValueError(f"top_k {top_k_eff} outside [1, {self.lm.vocab}]")
        if top_p is not None and not (0.0 < top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if stop is not None and any(len(seq) == 0 for seq in stop):
            raise ValueError("stop sequences must be non-empty")
        return prompt, top_k_eff

    def submit(self, prompt, steps: int, temperature: float = 0.0,
               top_k: int | None = None, top_p: float | None = None,
               eos_id: int | None = None, rng: int | None = None,
               stop: list | None = None,
               on_token: Callable[[int, int, int], None] | None = None,
               t_submit: float | None = None) -> int:
        """Queue one request; returns its id. ``rng`` is the integer seed
        of a sampled request's key stream (the same as ``generate``'s for
        it alone). ``stop`` token sequences end the stream (inclusive);
        ``on_token(req_id, token, index)`` streams each commit on the
        ticking thread. Raises :class:`QueueFullError` at the bound."""
        prompt, top_k_eff = self.validate_request(
            prompt, steps, temperature, top_k, top_p, rng, stop
        )
        do_sample = temperature > 0.0
        with self._cv:
            req_id = self._next_id
            self._next_id += 1
        req = _Request(
            req_id=req_id,
            prompt=prompt,
            steps=steps,
            temperature=float(temperature) if do_sample else 0.0,
            # Greedy requests normalise their knobs to identity values so
            # they never force the top-k/top-p sorts onto a tick.
            top_k=(top_k_eff if do_sample and top_k_eff is not None
                   else self.lm.vocab),
            top_p=top_p if do_sample and top_p is not None else 1.0,
            eos_id=eos_id,
            seed=int(rng) if rng is not None else 0,
            stop=tuple(tuple(int(t) for t in seq) for seq in (stop or ())),
            on_token=on_token,
            t_submit=t_submit if t_submit is not None else time.perf_counter(),
        )
        try:
            with self._cv:
                self._queue.append(req)
                self._cv.notify_all()
        except QueueFullError as e:
            with self._cv:
                self._rejected += 1
            global_metrics().inc("scheduler.rejected_total")
            global_flight_recorder().record(
                "request_rejected", request=req_id, reason=str(e)
            )
            raise
        global_metrics().inc("scheduler.admitted_total")
        return req_id

    def cancel(self, req_id: int) -> bool:
        """Queued -> dropped with an empty result; live -> retired at the
        next commit boundary with its partial stream as the result.
        False for ids never issued or already finished."""
        with self._cv:
            if req_id in self._done or not 0 <= req_id < self._next_id:
                return False
            req = self._queue.remove_id(req_id)
            if req is not None:
                self._cancelled.discard(req_id)
                self._done[req_id] = np.zeros((0,), np.int32)
                self._done_lps[req_id] = np.zeros((0,), np.float32)
                self._cv.notify_all()
                global_flight_recorder().record(
                    "cancel", request=req_id, state="queued"
                )
                return True
            live = req_id == self._admitting or any(
                s.req is not None and s.req.req_id == req_id
                for s in self.slots
            )
            if not live:
                return False
            self._cancelled.add(req_id)
            global_flight_recorder().record(
                "cancel", request=req_id, state="live"
            )
            return True

    def _release_slot(self, slot: _Slot) -> None:
        slot.req = None
        slot.tokens = []
        slot.lps = []
        slot.t_first = 0.0
        slot.obs_count = 0

    def _finish(self, slot: _Slot, reason: str = "completed") -> None:
        req = slot.req
        if self.obs_timeline:
            global_metrics().observe(
                "continuous.request_latency_s",
                time.perf_counter() - req.t_submit,
            )
        toks = np.asarray(slot.tokens, np.int32)
        lps = np.asarray(slot.lps, np.float32)
        stamps = {}
        if slot.t_first:
            stamps["ttft_s"] = round(slot.t_first - req.t_submit, 6)
        global_flight_recorder().record(
            "finish", request=req.req_id, reason=reason, tokens=len(toks),
            **stamps,
        )
        with self._cv:
            self._done[req.req_id] = toks
            self._done_lps[req.req_id] = lps
            while len(self._done_lps) > self._LPS_CAP:
                self._done_lps.pop(next(iter(self._done_lps)))
            self._cancelled.discard(req.req_id)
            self._completed += 1
            self._release_slot(slot)
            self._cv.notify_all()
        self._clear_slot(slot.idx)
        global_metrics().inc("continuous.completed")

    def _commit(self, slot: _Slot, token: int, lp: float) -> None:
        """Append one emitted token; EOS, a stop sequence, the step budget
        or a pending cancel finishes the request."""
        req = slot.req
        with self._cv:
            cancelled = req.req_id in self._cancelled
            self._cancelled.discard(req.req_id)
        if cancelled:
            self._finish(slot, reason="cancelled")
            return
        if self.obs_timeline:
            now = time.perf_counter()
            emitted_before = len(slot.tokens)
            if slot.t_first == 0.0:
                slot.t_first = now
                if emitted_before == 0:
                    self._ttft_pending.append(now - req.t_submit)
            elif slot.obs_count == emitted_before:
                self._itl_pending.append(now - slot.t_last)
            slot.t_last = now
            slot.obs_count = emitted_before + 1
            self._tick_tokens += 1
        slot.tokens.append(token)
        slot.lps.append(lp)
        if req.on_token is not None:
            req.on_token(req.req_id, token, len(slot.tokens) - 1)
        if req.eos_id is not None and token == req.eos_id:
            self._finish(slot, reason="eos")
            return
        slot.emitted += 1
        slot.last_token = token
        for seq in req.stop:
            n = len(seq)
            if len(slot.tokens) >= n and tuple(slot.tokens[-n:]) == seq:
                self._finish(slot, reason="stop")
                return
        if slot.emitted >= req.steps:
            self._finish(slot)

    def _stage_decode_row(self, slot: _Slot) -> None:
        req = slot.req
        # The next step consumes last_token (stream index emitted - 1) at
        # cache position s0 + emitted - 1.
        ints = [slot.idx, slot.last_token, slot.s0 + slot.emitted - 1,
                req.top_k, slot.emitted, req.seed]
        self._stage_slot(
            self._h2d(ints, torch.int64),
            self._h2d([req.temperature, req.top_p], torch.float32),
        )

    def _admit(self) -> None:
        for slot in self.slots:
            if slot.req is not None:
                continue
            with self._cv:
                if not self._queue:
                    return
                req = self._queue.popleft()
                self._admitting = req.req_id
            s0 = req.prompt.shape[0]
            bucket = next(b for b in self.prompt_buckets if b >= s0)
            tracer = global_tracer()
            t0 = tracer.now() if tracer.enabled else 0.0
            tok0, lp0 = self._prefill(slot.idx, req, bucket)
            if tracer.enabled:
                tracer.add_span("batcher.prefill", start=t0, end=tracer.now(),
                                request=req.req_id, bucket=bucket)
            slot.req, slot.s0 = req, s0
            slot.emitted, slot.tokens, slot.lps = 0, [], []
            slot.t_first, slot.obs_count = 0.0, 0
            with self._cv:
                self._admitting = None
                self._admitted += 1
            global_metrics().inc("continuous.admitted")
            queue_wait = time.perf_counter() - req.t_submit
            if self.obs_timeline:
                global_metrics().observe("continuous.queue_wait_s", queue_wait)
            global_flight_recorder().record(
                "admit", request=req.req_id, slot=slot.idx, prompt_len=s0,
                queue_wait_s=round(queue_wait, 6),
            )
            self._commit(slot, tok0, lp0)
            if slot.req is req:
                self._stage_decode_row(slot)

    def _obs_flush(self) -> None:
        reg = global_metrics()
        if self._ttft_pending:
            reg.observe_many("continuous.ttft_s", self._ttft_pending)
            self._ttft_pending = []
        if self._itl_pending:
            reg.observe_many("continuous.itl_s", self._itl_pending)
            self._itl_pending = []
        if self._tick_tokens:
            reg.inc("continuous.tokens_total", float(self._tick_tokens))
            self._tick_tokens = 0

    @torch.no_grad()
    def tick(self) -> int:
        """Admit into free slots, then decode one chunk over every slot
        with ONE host sync. Returns the number of active slots committed
        (0 = idle tick)."""
        self._admit()
        for slot in self.slots:
            if slot.req is None:
                continue
            with self._cv:
                cancelled = slot.req.req_id in self._cancelled
                self._cancelled.discard(slot.req.req_id)
            if cancelled:
                self._finish(slot, reason="cancelled")
        active = [s for s in self.slots if s.req is not None]
        reg = global_metrics()
        reg.set_gauge("continuous.active_slots", float(len(active)))
        reg.set_gauge("continuous.queue_depth", float(len(self._queue)))
        reg.set_gauge("continuous.h2d_transfers", float(self._h2d_count))
        if not active:
            if self.obs_timeline:
                self._obs_flush()
            return 0
        vocab = self.lm.vocab
        tracer = global_tracer()
        t_chunk = tracer.now() if tracer.enabled else 0.0
        reqs = [s.req for s in self.slots]
        lives = [s.tokens for s in self.slots]
        toks, lps = self._step_chunk(
            do_sample=any(s.req.temperature > 0.0 for s in active),
            truncate=any(s.req.top_k < vocab for s in active),
            nucleus=any(s.req.top_p < 1.0 for s in active),
        )
        # The tick's one device->host fetch.
        host = torch.stack([toks.double(), lps.double()]).cpu().numpy()
        with self._cv:
            self._ticks += 1
        reg.inc("continuous.ticks")
        if tracer.enabled:
            tracer.add_span("batcher.decode_chunk", start=t_chunk,
                            end=tracer.now(), slots=len(active),
                            chunk=self.chunk)
        for i, slot in enumerate(self.slots):
            req = reqs[i]
            if req is None or slot.req is not req or slot.tokens is not lives[i]:
                continue
            for j in range(self.chunk):
                self._commit(slot, int(host[0, j, i]), float(host[1, j, i]))
                if slot.req is not req:
                    break
        if self.obs_timeline:
            self._obs_flush()
        reg.set_gauge(
            "continuous.active_slots",
            float(sum(1 for s in self.slots if s.req is not None)),
        )
        return len(active)

    def stats(self) -> dict:
        """Slot occupancy, queue depth and this batcher's lifetime
        counts."""
        with self._cv:
            return {
                "slots": len(self.slots),
                "active": sum(1 for s in self.slots if s.req is not None),
                "queued": len(self._queue),
                "finished_unclaimed": len(self._done),
                "admitted": self._admitted,
                "completed": self._completed,
                "ticks": self._ticks,
                "prefill_tokens": self._prefill_tokens,
                "h2d_transfers": self._h2d_count,
                "cache_bytes": sum(
                    t.numel() * t.element_size()
                    for pair in self._caches for t in pair
                ),
                "rejected": self._rejected,
            }

    def logprobs(self, req_id: int) -> np.ndarray:
        """Per-token model logprobs of a FINISHED request (claims them)."""
        with self._cv:
            if req_id not in self._done_lps:
                raise KeyError(
                    f"no logprobs for request {req_id} "
                    "(not finished, or already claimed)"
                )
            return self._done_lps.pop(req_id)

    def run(self, max_ticks: int = 100_000) -> dict[int, np.ndarray]:
        """Tick until every submitted request completed; returns
        {req_id: tokens} and clears the finished set."""
        ticks = 0
        while self._queue or any(s.req is not None for s in self.slots):
            self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(f"run() exceeded {max_ticks} ticks")
        with self._cv:
            done, self._done = self._done, {}
        return done

    # -- threaded serving --------------------------------------------------

    def start(self) -> "ContinuousBatcher":
        """Serve on a background thread: :meth:`submit` from any thread,
        block on :meth:`result`."""
        with self._cv:
            if self._server is not None:
                raise RuntimeError("batcher already started")
            self._stopping = False

            def loop():
                while True:
                    with self._cv:
                        while (not self._stopping and not self._queue
                               and all(s.req is None for s in self.slots)):
                            self._cv.wait(timeout=0.1)
                        if self._stopping:
                            break
                    try:
                        self.tick()
                    except BaseException as e:  # noqa: BLE001 — re-raised
                        with self._cv:
                            self._server_error = e
                            self._stopping = True
                            self._cv.notify_all()
                        log.error("server tick failed: %r", e)
                        return
                    with self._cv:
                        self._cv.notify_all()

            self._server = threading.Thread(
                target=loop, name="continuous-batcher", daemon=True
            )
            self._server.start()
        return self

    def stop(self) -> None:
        with self._cv:
            server = self._server
            if server is None:
                return
            self._stopping = True
            self._cv.notify_all()
        server.join(timeout=30.0)
        if server.is_alive():
            raise RuntimeError(
                "batcher server thread did not stop within 30s; retry stop()"
            )
        with self._cv:
            self._server = None

    def __enter__(self) -> "ContinuousBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def result(self, req_id: int, timeout: float = 300.0) -> np.ndarray:
        """Block until ``req_id`` finishes (requires :meth:`start`);
        returns and claims its tokens."""
        with self._cv:
            if not self._cv.wait_for(
                lambda: req_id in self._done or self._stopping,
                timeout=timeout,
            ):
                raise TimeoutError(f"request {req_id} not done within {timeout}s")
            if req_id not in self._done:
                if self._server_error is not None:
                    raise RuntimeError(
                        "batcher server thread died mid-tick"
                    ) from self._server_error
                raise RuntimeError("batcher stopped before completion")
            return self._done.pop(req_id)
