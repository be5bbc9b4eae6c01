"""Fleet router: the decision half of the capacity plane — the port of
``adapt_tpu/runtime/router.py``.

Every replica publishes a capacity book (``runtime/capacity``: headroom, a
self-calibrating TTFT forecaster, a bounded prefix-affinity sketch, a
health score). A :class:`FleetRouter` owns N decode replicas and places
every submit by scoring each live replica's book::

    cost(r) = ttft_forecast_r(len, affinity_tokens_r)   # 0 when unpriced
            + queue_cost_s * queue_depth_r
            + queue_cost_s * [no free slot]
            + degraded_penalty_s * [health == degraded]
            - rendezvous_bias_s * [r is HOME and no sketch speaks]
            - 1e-6 * affinity_tokens_r                  # pure tiebreak

    place on argmin cost; "critical" replicas sort behind every other.

The hit tokens shorten the forecast's prefill suffix, so the router
compares "prefill what is missing here" against "prefill everything
there". Until every candidate's forecaster has learned a prefill wall, the
forecasts cannot price that difference and stay out of the cost: such a
fleet ranks least-loaded with affinity as the tiebreak (the JAX router
ranks on them from the first queue-wait sample; ROADMAP.md §3). While
every candidate's sketch is silent on a
prompt, its first full page rendezvous-hashes (highest-random-weight over
the live replica names) to a HOME replica, so a prefix's repeats co-locate
from the first occurrence; placement memory (where this router last sent
the prefix) comes before the hash.

Overload sheds synchronously through the replicas' admission books: the
router runs the chosen replica's ``admission_check`` first, walks to the
next-best replica on a rejection, and raises ``QueueFullError`` only when
every live replica says no (``router.shed_total``).

Cross-replica prefill rides the disaggregated wire: a
:class:`~adapt_tpu_torch.runtime.disagg.PrefillWorker` tier streams each
finished prefill to the CHOSEN decode replica as ``MSG_KV_PAGES`` frames
over the loopback transport, landing through ``adopt_prefill_pages`` as
an ordinary prefix hit. :meth:`FleetRouter._head_ranges` cuts the wire
into a tensor-parallel destination's head tiles (a replica built with
``mesh=`` + ``ParallelConfig(tp)``: tp tiles a leaf, each landing on its
shard); an unsharded replica gets whole leaves.

Membership: every replica holds a ``WorkerRegistry`` TTL lease
(``decode:<name>``, its book in ``meta["capacity"]``). An external
deregister, a lapsed lease or a Python exception out of a replica's tick
is a LEAVE EDGE: the router cancels the replica's work and re-places it on
the survivors within ``RouterConfig.recovery_budget_s``; each request's
delivered-token watermark suppresses the replayed prefix, so greedy
streams stay the same and delivery exactly-once. A
:class:`FleetAutoscaler` spawns a replica on sustained queue pressure and
retires a drained idle one, on the same books.

On one card every replica is a batcher on the same device, usually over
one shared model (one weight copy). A leave edge there is a lease event or
an exception raised in Python: a CUDA fault is sticky and poisons every
replica of the card, so re-placement cannot recover from one.

Single-threaded, like :class:`~adapt_tpu_torch.runtime.disagg.DisaggServer`:
the replicas are ticked by :meth:`FleetRouter.tick` and never ``start()``
ed. One tick is: leave edges, lease heartbeats, the prefill step and its
landings, the autoscaler, one tick per live replica.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Callable

import numpy as np

from adapt_tpu_torch.comm.framing import frame_parts
from adapt_tpu_torch.config import DisaggConfig, RouterConfig, SLOSpec
from adapt_tpu_torch.control.registry import weak_watch
from adapt_tpu_torch.runtime.capacity import (
    affinity_score,
    forecast_from_snapshot,
    prefill_tier_book,
)
from adapt_tpu_torch.runtime.disagg import (
    HandoffError,
    KVHandoff,
    PrefillWorker,
    head_ranges_for,
    loopback,
    pack_handoff,
    unpack_handoff,
)
from adapt_tpu_torch.runtime.scheduler import QueueFullError
from adapt_tpu_torch.utils.logging import get_logger
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.tracing import global_flight_recorder

log = get_logger("router")

#: /fleet/placements payload version.
PLACEMENTS_V = 1

#: Placement-memory LRU bound (first-page prefix key -> replica last placed
#: on). Keys are one page of int32 tokens, so the worst case is a few MB.
_PREFIX_MEMO_CAP = 4096


@dataclasses.dataclass
class _Replica:
    """Router-side view of one decode replica."""

    name: str
    engine: object  # ContinuousBatcher (or a duck-typed equivalent)
    lease_key: str
    lease_token: object | None = None
    alive: bool = True
    #: Router ids currently owned by this replica.
    sids: set = dataclasses.field(default_factory=set)
    #: Monotonic time since the replica last had work: the autoscaler's
    #: scale-down clock.
    idle_since: float | None = None
    #: Last lease-meta capacity refresh (monotonic).
    cap_last: float = 0.0


@dataclasses.dataclass
class _Tracked:
    """Router-side request state: where the request lives and how many
    tokens its caller has ALREADY seen (the exactly-once watermark a
    re-placement replays against)."""

    sid: int
    tier: str  # "prefill" | "decode" | "done"
    replica: str | None = None
    rid: int | None = None  # engine-side id once decode-submitted
    prompt: np.ndarray | None = None
    kwargs: dict | None = None
    user_cb: Callable | None = None
    t_submit: float = 0.0
    delivered: int = 0
    replaced: int = 0


class FleetRouter:
    """A serving front end over N decode replicas (see the module
    docstring), with the batcher's synchronous serving surface (``submit``
    / ``tick`` / ``cancel`` / ``run`` / ``result`` / ``stats`` /
    ``drain``), so a caller runs a fleet as it runs one replica.

    ``replicas`` maps name -> decode engine (a paged ``ContinuousBatcher``
    when a ``prefill`` tier is attached: the handoff lands through the
    prefix cache). ``registry`` (a ``control.registry.WorkerRegistry``)
    turns membership on: each replica holds a ``decode:<name>`` TTL lease
    carrying its capacity book, and a leave edge on one triggers
    re-placement. ``seed`` seeds the "random" policy's numpy generator."""

    def __init__(self, replicas: dict[str, object], *,
                 prefill: PrefillWorker | None = None,
                 config: RouterConfig | None = None,
                 disagg: DisaggConfig | None = None, registry=None,
                 wire_codec: str = "raw", seed: int = 0,
                 name: str = "router0"):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        self.cfg = config or RouterConfig()
        self.disagg_cfg = disagg or DisaggConfig()
        self.prefill = prefill
        self.wire_codec = wire_codec
        self.name = name
        self._registry = registry
        self._rng = np.random.RandomState(seed)
        self._replicas: dict[str, _Replica] = {}
        self._tracked: dict[int, _Tracked] = {}
        self._done: dict[int, np.ndarray] = {}
        self._next_sid = 0
        self._closed = False
        #: Leave edges seen by the registry watcher (it fires on the
        #: deregistering thread), drained at the top of every tick.
        self._pending_leaves: list[str] = []
        #: Lease keys this router is deregistering right now (a graceful
        #: detach must not read as a crash in its own watcher).
        self._our_deregs: set = set()
        #: The placement-decision ring ``GET /fleet/placements`` serves.
        self._decisions: collections.deque = collections.deque(
            maxlen=self.cfg.placements_capacity)
        self._autoscaler = None
        #: Placement memory: first-page prefix key -> the replica this
        #: router LAST placed it on (a bounded LRU; entries naming a left
        #: replica are purged on its leave edge, so those prefixes re-home).
        self._placed_prefix: collections.OrderedDict = (
            collections.OrderedDict())
        self.placed = 0
        self.shed = 0
        self.replaced = 0
        self.failed = 0
        self._affinity_hits = 0
        for rname, engine in replicas.items():
            self.add_replica(rname, engine, _join_event=False)
        if self._registry is not None:
            # Weakly: watcher lists have no unwatch and outlive subscribers.
            weak_watch(self._registry, self, "_on_watch")

    # -- membership --------------------------------------------------------

    def _check_compat(self, name: str, engine) -> None:
        if self.prefill is None:
            return
        if not getattr(engine, "_paged", False):
            raise ValueError(
                f"replica {name!r} is not paged — a prefill-tier router "
                "lands handoffs through the prefix cache")
        if self.prefill.page_size != engine._page:
            raise ValueError(f"prefill page size {self.prefill.page_size} "
                             f"!= replica {name!r} page size {engine._page}")
        if self.prefill.kv_cache_dtype != (engine._kv_quant or "native"):
            raise ValueError(
                f"prefill/replica kv_cache_dtype mismatch on {name!r}")
        if self.prefill.lm.vocab != engine.lm.vocab:
            raise ValueError(f"prefill/replica vocab mismatch on {name!r}")

    def add_replica(self, name: str, engine, _join_event: bool = True):
        """Join edge: validate, lease, place-eligible from the next submit.
        The autoscaler's scale-up lands here too."""
        if name in self._replicas and self._replicas[name].alive:
            raise ValueError(f"replica {name!r} already attached")
        self._check_compat(name, engine)
        rep = _Replica(name=name, engine=engine, lease_key=f"decode:{name}")
        if self._registry is not None:
            rep.lease_token = self._registry.register(
                rep.lease_key, meta=self._lease_meta(rep),
                ttl_s=self.cfg.lease_ttl_s)
        self._replicas[name] = rep
        if _join_event:
            global_flight_recorder().record("replica_join", replica=name,
                                            fleet=len(self._live()))
        return rep

    def _lease_meta(self, rep: _Replica) -> dict:
        meta = {"role": "decode", "router": self.name}
        cap_book = getattr(rep.engine, "capacity_book", None)
        book = cap_book() if callable(cap_book) else None
        if book is not None:
            meta["capacity"] = book
        return meta

    def _on_watch(self, event: str, worker_id) -> None:
        if event != "leave":
            return
        wid = str(worker_id)
        if not wid.startswith("decode:") or wid in self._our_deregs:
            return
        name = wid.split(":", 1)[1]
        rep = self._replicas.get(name)
        if rep is not None and rep.alive:
            self._pending_leaves.append(name)

    def _live(self) -> list[_Replica]:
        return [r for r in self._replicas.values() if r.alive]

    def detach(self, name: str) -> None:
        """Graceful leave (the autoscaler's scale-down): release the lease,
        stop placing. The replica must hold no work (:meth:`mark_failed`
        models a crash)."""
        rep = self._replicas.get(name)
        if rep is None or not rep.alive:
            return
        st = rep.engine.stats()
        if st.get("active") or st.get("queued") or rep.sids:
            raise ValueError(f"replica {name!r} still holds work — detach "
                             "is for drained replicas")
        rep.alive = False
        self._drop_lease(rep)
        global_flight_recorder().record("replica_leave", replica=name,
                                        reason="drain", moved=0,
                                        fleet=len(self._live()))

    def mark_failed(self, name: str) -> None:
        """Crash-model leave edge: mark the replica dead now and re-place
        its unfinished work on the survivors (the path a lease-expiry watch
        event takes at the next tick)."""
        self._leave_edge(name)

    def _drop_lease(self, rep: _Replica) -> None:
        if self._registry is None or rep.lease_token is None:
            return
        self._our_deregs.add(rep.lease_key)
        try:
            self._registry.deregister(rep.lease_key, rep.lease_token)
        finally:
            self._our_deregs.discard(rep.lease_key)
            rep.lease_token = None

    # -- placement scoring -------------------------------------------------

    def _book(self, rep: _Replica) -> dict | None:
        cap_book = getattr(rep.engine, "capacity_book", None)
        book = cap_book() if callable(cap_book) else None
        if book is None:
            return None
        age = time.time() - float(book.get("wall") or 0.0)
        if age > self.cfg.book_max_age_s:
            return None  # a stale book is no capacity signal at all
        return book

    def _prefix_key(self, prompt, cands: list[_Replica]) -> bytes | None:
        """The prompt's first full page as int32 bytes (the JAX router's
        key, whatever integer type the prompt arrives in): the identity
        co-location is remembered and rendezvous-hashed under. None when
        the prompt has no full page or the engines are not paged."""
        page = getattr(cands[0].engine, "_page", 0) if cands else 0
        if not page or int(prompt.shape[0]) < page:
            return None
        return np.asarray(prompt[:page], np.int32).tobytes()

    def _home(self, key: bytes, cands: list[_Replica]) -> str | None:
        """The prefix's HOME among ``cands``: the replica this router last
        placed it on, if still a candidate, else the rendezvous
        (highest-random-weight) hash of (key, replica name), which a
        replica joining or leaving changes only for the prefixes that
        hashed to it."""
        placed = self._placed_prefix.get(key)
        if placed is not None and any(r.name == placed for r in cands):
            return placed
        return max(cands, key=lambda r: hashlib.blake2b(
            key + r.name.encode(), digest_size=8).digest()).name

    def _remember_placement(self, prompt, name: str) -> None:
        key = self._prefix_key(prompt, self._live())
        if key is None:
            return
        self._placed_prefix[key] = name
        self._placed_prefix.move_to_end(key)
        while len(self._placed_prefix) > _PREFIX_MEMO_CAP:
            self._placed_prefix.popitem(last=False)

    def _cost(self, rep: _Replica, prompt, s0: int, book: dict | None,
              priced: bool) -> dict:
        """One replica's placement cost and its WHY (the
        ``/fleet/placements`` record). ``priced``: every candidate's
        forecast can price a prefill (see :meth:`_rank`)."""
        cfg = self.cfg
        if book is None:
            # No (or a stale) book: least-loaded on live stats.
            st = rep.engine.stats()
            queued = int(st.get("queued", 0)) + int(st.get("active", 0))
            return {"health": "unknown", "affinity_tokens": 0,
                    "forecast_s": 0.0, "queue_depth": queued, "home": False,
                    "cost": cfg.queue_cost_s * queued}
        hr = book.get("headroom") or {}
        health = str(book.get("health", "ok"))
        aff = 0.0
        if cfg.policy == "affinity":
            aff = affinity_score(book.get("sketch") or {}, prompt)
        hit_tokens = int(aff)
        queued = int(hr.get("queue_depth", 0))
        slots_free = int(hr.get("slots_free", 0))
        fc = 0.0
        if cfg.policy != "random" and priced:
            snap = book.get("forecast") or {}
            if queued == 0 and slots_free > 0 and snap.get("queue_wait_s"):
                # An idle engine (empty queue, free slots) cannot also
                # claim a queue wait: that EWMA is memory of traffic it no
                # longer gets, and would starve it of the traffic that
                # would prove otherwise.
                snap = dict(snap, queue_wait_s=0.0)
            fc = forecast_from_snapshot(snap, s0, hit_tokens)
        cost = fc + cfg.queue_cost_s * queued
        if slots_free <= 0:
            cost += cfg.queue_cost_s
        if health == "degraded":
            cost += cfg.degraded_penalty_s
        cost -= 1e-6 * hit_tokens
        return {"health": health, "affinity_tokens": hit_tokens,
                "forecast_s": round(fc, 6), "queue_depth": queued,
                "home": False, "cost": cost}

    @staticmethod
    def _priced(books: list) -> bool:
        """Whether the forecasts enter the cost: every live book has
        learned a prefill wall. A forecast prices a resident prefix only
        through its walls (the hit shortens the suffix it prices); one that
        has learned none (every admission it saw was chunked, and chunked
        admissions teach none) prices any prefill at 0 and ranks on its
        queue-wait and tick-gap memory alone, which a hit cannot move. On
        one host those differ between replicas by more than a hit saves,
        and a prefix's repeats go where it is not. Until then the ranking
        is the cold one: least-loaded, affinity the tiebreak. (The JAX
        router ranks on such forecasts: ROADMAP.md §3.)"""
        return all((b.get("forecast") or {}).get("walls")
                   for b in books if b is not None)

    def _rank(self, prompt, s0: int, exclude: set | None = None):
        """Live replicas in placement order (best first) with their scoring
        records. Critical replicas sort behind every other one; the random
        policy shuffles instead (its scores are still computed, so the
        decision ring shows what affinity would have said)."""
        cands = [r for r in self._live()
                 if not exclude or r.name not in exclude]
        books = [self._book(r) for r in cands]
        priced = self._priced(books)
        scored = [(r, self._cost(r, prompt, s0, b, priced))
                  for r, b in zip(cands, books)]
        if (self.cfg.policy == "affinity" and self.cfg.rendezvous_bias_s > 0
                and len(scored) > 1
                and all(w["affinity_tokens"] == 0 for _, w in scored)):
            # Cold window: no sketch has seen this prefix yet. Pull the
            # placement toward its HOME so back-to-back repeats co-locate.
            key = self._prefix_key(prompt, cands)
            home = self._home(key, cands) if key is not None else None
            for r, w in scored:
                if r.name == home:
                    w["home"] = True
                    w["cost"] -= self.cfg.rendezvous_bias_s
        if self.cfg.policy == "random":
            order = self._rng.permutation(len(scored))
            return [scored[i] for i in order]
        scored.sort(key=lambda t: (t[1]["health"] == "critical",
                                   t[1]["cost"]))
        return scored

    def _record_decision(self, kind: str, sid: int, chosen: str, why: dict,
                         ranked) -> None:
        self._decisions.append({
            "kind": kind, "sid": sid, "replica": chosen,
            "policy": self.cfg.policy, "why": why,
            "alternatives": {r.name: round(w["cost"], 6)
                             for r, w in ranked if r.name != chosen},
            "wall": time.time(),
        })

    def placements(self) -> dict:
        """The ``GET /fleet/placements`` payload (pass this method to
        ``serve_metrics(placements_provider=...)``): the bounded decision
        ring and the fleet roster."""
        return {
            "v": PLACEMENTS_V,
            "router": self.name,
            "policy": self.cfg.policy,
            "replicas": {r.name: {"alive": r.alive, "requests": len(r.sids)}
                         for r in self._replicas.values()},
            "decisions": list(self._decisions),
        }

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt, steps: int, temperature: float = 0.0,
               top_k: int | None = None, top_p: float | None = None,
               eos_id: int | None = None, rng=None, stop: list | None = None,
               on_token: Callable[[int, int, int], None] | None = None,
               slo: SLOSpec | None = None) -> int:
        """Place one request; returns the ROUTER-side id (for
        :meth:`cancel` / :meth:`result`; callbacks see it too). Raises
        ``QueueFullError`` only when every live replica's admission book
        rejects: the synchronous shed."""
        t0 = time.perf_counter()
        live = self._live()
        if not live:
            raise RuntimeError("no live replicas")
        # The decode side's validation, once, against any replica (the
        # fleet serves one model): a bad request fails here, before routing.
        prompt, _ = live[0].engine.validate_request(
            prompt, steps, temperature=temperature, top_k=top_k,
            top_p=top_p, rng=rng, stop=stop, slo=slo)
        s0 = int(prompt.shape[0])
        sid = self._next_sid
        self._next_sid += 1
        t = _Tracked(sid=sid, tier="decode", prompt=prompt, user_cb=on_token,
                     t_submit=time.perf_counter())
        t.kwargs = dict(steps=steps, temperature=temperature, top_k=top_k,
                        top_p=top_p, eos_id=eos_id, rng=rng, stop=stop,
                        slo=slo)
        ranked = self._rank(prompt, s0)
        chosen, why, rejection = None, None, None
        for rep, score in ranked:
            try:
                rep.engine.admission_check(slo, request=sid)
            except QueueFullError as e:
                rejection = e
                continue
            chosen, why = rep, score
            break
        if chosen is None:
            # Every live replica's admission book said no (each recorded
            # its own rejection): shed synchronously.
            self.shed += 1
            global_metrics().inc("router.shed_total")
            self._record_decision("shed", sid, "", {"cost": 0.0}, ranked)
            raise rejection if rejection is not None else QueueFullError(
                "all replicas rejected")
        self._tracked[sid] = t
        t.replica = chosen.name
        chosen.sids.add(sid)
        chosen.idle_since = None
        if self.cfg.policy == "affinity":
            self._remember_placement(prompt, chosen.name)
        if self.prefill is not None and self._disaggregate(chosen, s0, slo):
            t.tier = "prefill"
            self.prefill.submit(sid, prompt)
        else:
            self._decode_submit(t, chosen)
        self.placed += 1
        if why.get("affinity_tokens", 0) > 0:
            self._affinity_hits += 1
        reg = global_metrics()
        reg.inc("router.placed_total")
        reg.set_gauge("router.affinity_hit_ratio",
                      self._affinity_hits / self.placed)
        reg.observe("router.placement_s", time.perf_counter() - t0)
        self._record_decision("placed", sid, chosen.name, why, ranked)
        return sid

    def _disaggregate(self, rep: _Replica, s0: int,
                      slo: SLOSpec | None) -> bool:
        """``DisaggServer``'s placement policy for the chosen replica: full
        pages to hand off, a prompt over the (busy-sensitive) threshold,
        and a prefill pool that can cover it."""
        page = rep.engine._page
        m = (s0 - 1) // page
        if m < 1:
            return False
        slots = rep.engine.slots
        occupancy = sum(1 for s in slots if s.req is not None) / len(slots)
        busy = occupancy >= self.disagg_cfg.busy_occupancy or (
            slo is not None and slo.priority > 0)
        threshold = (self.disagg_cfg.busy_prompt_threshold if busy
                     else self.disagg_cfg.prompt_threshold)
        if s0 < threshold:
            return False
        if (m > self.prefill._pager.num_allocatable
                and not self.prefill.sp_eligible(s0)):
            return False
        return True

    def _make_cb(self, t: _Tracked):
        """Exactly-once delivery across re-placements: the engine calls
        this with its OWN id and in-order token indices; the caller sees
        the router id, and an index below the delivered watermark (a
        re-placed greedy request replaying its prefix) is suppressed."""

        def cb(rid, tok, idx, _t=t):
            if idx < _t.delivered:
                return
            _t.delivered = idx + 1
            if _t.user_cb is not None:
                _t.user_cb(_t.sid, tok, idx)

        return cb

    def _decode_submit(self, t: _Tracked, rep: _Replica) -> None:
        kwargs = dict(t.kwargs)
        kwargs["on_token"] = self._make_cb(t)
        t.rid = rep.engine.submit(t.prompt, t_submit=t.t_submit, **kwargs)
        t.tier = "decode"
        t.replica = rep.name
        rep.sids.add(t.sid)

    def cancel(self, sid: int) -> bool:
        t = self._tracked.get(sid)
        if t is None or t.tier == "done":
            return False
        if t.tier == "decode":
            rep = self._replicas.get(t.replica)
            if rep is None:
                return False
            if rep.engine.cancel(t.rid):
                rep.sids.discard(sid)
                return True
            return False
        if self.prefill is not None and self.prefill.cancel(sid):
            self._finish_empty(t)
            global_flight_recorder().record("cancel", request=sid,
                                            state="prefill")
            global_flight_recorder().record("finish", request=sid,
                                            reason="cancelled", tokens=0)
            return True
        return False

    def _finish_empty(self, t: _Tracked) -> None:
        self._done[t.sid] = np.zeros((0,), np.int32)
        rep = self._replicas.get(t.replica or "")
        if rep is not None:
            rep.sids.discard(t.sid)
        t.tier = "done"
        t.kwargs = t.prompt = None

    def _fail(self, sid: int, err: Exception) -> None:
        """A request that can no longer be served fails cleanly: an empty
        result, loud flight events, and the fleet serves on."""
        t = self._tracked.get(sid)
        self.failed += 1
        if t is not None:
            self._finish_empty(t)
        else:
            self._done[sid] = np.zeros((0,), np.int32)
        global_flight_recorder().record("request_failed", request=sid,
                                        reason=str(err)[:200])
        global_flight_recorder().record("finish", request=sid,
                                        reason="failed", tokens=0)
        log.error("router failed request %d: %s", sid, err)

    # -- cross-replica handoff landing -------------------------------------

    def _head_ranges(self, rep: _Replica, handoff: KVHandoff):
        """Destination head tiles for sender-side resharding: the chosen
        replica's tp cuts the wire (``disagg.head_ranges_for``: one tile a
        shard). None (whole-leaf frames) for an unsharded destination or
        heads that do not tile."""
        return head_ranges_for(rep.engine, handoff)

    def _land(self, handoff: KVHandoff) -> None:
        """Stream one finished prefill to its CHOSEN replica: frame ->
        loopback wire -> parse -> adopt -> decode submit. A replica lost
        since placement re-scores here: the handoff follows the work."""
        sid = handoff.req_id
        t = self._tracked.get(sid)
        if t is None or t.tier != "prefill":
            return  # cancelled between the last chunk and the handoff
        rep = self._replicas.get(t.replica or "")
        if rep is None or not rep.alive:
            ranked = self._rank(t.prompt, int(t.prompt.shape[0]))
            if not ranked:
                self._fail(sid, RuntimeError("no live replicas"))
                return
            rep, why = ranked[0]
            self._record_decision("replaced", sid, rep.name, why, ranked)
        t0 = time.perf_counter()
        try:
            ranges = self._head_ranges(rep, handoff)
            msg = pack_handoff(handoff, wire_codec=self.wire_codec,
                               head_ranges=ranges)
            wire_bytes = sum(p.nbytes for p in frame_parts(msg))
            landed = unpack_handoff(loopback(msg))
            adopted = rep.engine.adopt_prefill_pages(
                landed.prompt, landed.blocks, landed.page_size,
                landed.kv_dtype)
        except (HandoffError, ValueError) as e:
            self._fail(sid, e)
            return
        wall = time.perf_counter() - t0
        reg = global_metrics()
        # The single-replica DisaggServer's wire books: one dashboard
        # reads both deployments.
        reg.inc("disagg.handoff_bytes", float(wire_bytes))
        reg.inc("disagg.pages_streamed", float(handoff.n_pages))
        reg.observe("disagg.handoff_s", wall)
        global_flight_recorder().record(
            "kv_handoff", request=sid, replica=rep.name,
            pages=handoff.n_pages, adopted=adopted, bytes=wire_bytes,
            tiles=len(ranges) if ranges else 1, wall_s=round(wall, 6))
        try:
            self._decode_submit(t, rep)
        except (ValueError, TypeError, QueueFullError) as e:
            self._fail(sid, e)

    # -- leave edges / re-placement ----------------------------------------

    def _leave_edge(self, name: str) -> None:
        rep = self._replicas.get(name)
        if rep is None or not rep.alive:
            return
        t0 = time.perf_counter()
        rep.alive = False
        self._drop_lease(rep)
        # Forget placements onto the lost replica: those prefixes re-home.
        for k in [k for k, v in self._placed_prefix.items() if v == name]:
            del self._placed_prefix[k]
        moved = 0
        stranded = [self._tracked[sid] for sid in sorted(rep.sids)
                    if sid in self._tracked]
        rep.sids.clear()
        for t in stranded:
            if t.tier == "done":
                continue
            if t.tier == "decode":
                try:
                    rep.engine.cancel(t.rid)
                except Exception:  # noqa: BLE001 — a dead engine may
                    pass  # refuse; the re-place below is the recovery
            if t.tier == "prefill":
                # The prefill tier outlives the replica; the handoff
                # re-scores at its landing (_land).
                t.replica = None
                continue
            ranked = self._rank(t.prompt, int(t.prompt.shape[0]),
                                exclude={name})
            placed = False
            for cand, why in ranked:
                try:
                    cand.engine.admission_check(t.kwargs.get("slo"),
                                                request=t.sid)
                    self._decode_submit(t, cand)
                except (QueueFullError, ValueError) as e:  # noqa: PERF203
                    last = e
                    continue
                t.replaced += 1
                moved += 1
                if self.cfg.policy == "affinity":
                    self._remember_placement(t.prompt, cand.name)
                self._record_decision("replaced", t.sid, cand.name, why,
                                      ranked)
                placed = True
                break
            if not placed:
                self._fail(t.sid, last if ranked
                           else RuntimeError("no live replicas"))
        wall = time.perf_counter() - t0
        self.replaced += moved
        if moved:
            global_metrics().inc("router.replaced_total", float(moved))
        global_flight_recorder().record(
            "replica_leave", replica=name, reason="lost", moved=moved,
            wall_s=round(wall, 6), fleet=len(self._live()))
        if wall > self.cfg.recovery_budget_s:
            log.error("leave-edge re-place for %s took %.3fs (budget %.3fs)",
                      name, wall, self.cfg.recovery_budget_s)

    # -- tick loop ---------------------------------------------------------

    def attach_autoscaler(self, autoscaler: "FleetAutoscaler") -> None:
        self._autoscaler = autoscaler

    def tick(self) -> int:
        """One fleet round; returns the fleet's active-slot count. Leave
        edges first (a lost replica must not receive this round's
        landings), then leases, prefill landings, the autoscaler and one
        tick per live replica."""
        while self._pending_leaves:
            self._leave_edge(self._pending_leaves.pop(0))
        now = time.monotonic()
        if self._registry is not None and not self._closed:
            for rep in self._live():
                if not self._registry.heartbeat(rep.lease_key,
                                                self.cfg.lease_ttl_s):
                    # The TTL lapsed between ticks, but the engine is
                    # ticking, so alive: re-register (etcd's keepalive).
                    # An EXTERNAL deregister queued a leave edge above
                    # and the replica is no longer live.
                    rep.lease_token = self._registry.register(
                        rep.lease_key, meta=self._lease_meta(rep),
                        ttl_s=self.cfg.lease_ttl_s)
                cap = getattr(rep.engine, "_capacity", None)
                lease_s = cap.cfg.lease_refresh_s if cap else 0.0
                if lease_s > 0 and now - rep.cap_last >= lease_s:
                    rep.cap_last = now
                    rep.lease_token = self._registry.register(
                        rep.lease_key, meta=self._lease_meta(rep),
                        ttl_s=self.cfg.lease_ttl_s)
        if self.prefill is not None:
            for handoff in self.prefill.step():
                self._land(handoff)
            if self.prefill.failed_jobs:
                for sid, err in self.prefill.failed_jobs:
                    self._fail(sid, RuntimeError(err))
                self.prefill.failed_jobs.clear()
        if self._autoscaler is not None:
            self._autoscaler.step(now)
        active = 0
        failed: list[str] = []
        for rep in self._live():
            try:
                active += rep.engine.tick()
            except Exception as e:  # noqa: BLE001 — one replica's failure
                # must not take the fleet down: the same leave edge as a
                # lost lease.
                log.exception("replica %s tick failed: %s", rep.name, e)
                failed.append(rep.name)
            st = rep.engine.stats()
            if st.get("active") or st.get("queued"):
                rep.idle_since = None
            elif rep.idle_since is None:
                rep.idle_since = now
        for name in failed:
            self._leave_edge(name)
        self._claim_finished()
        return active

    def _claim_finished(self) -> None:
        """Move engine-finished results into the router's done map, so the
        replicas' ``_done`` dicts do not grow while a caller polls only
        the router."""
        for rep in self._live():
            if not rep.sids:
                continue
            cv = getattr(rep.engine, "_cv", None)
            eng_done = getattr(rep.engine, "_done", None)
            if cv is None or eng_done is None:
                continue
            with cv:
                for sid in list(rep.sids):
                    t = self._tracked.get(sid)
                    if t is None or t.tier != "decode":
                        continue
                    if t.rid in eng_done:
                        self._done[sid] = eng_done.pop(t.rid)
                        rep.sids.discard(sid)
                        t.tier = "done"
                        t.kwargs = t.prompt = None

    def drain(self) -> int:
        """Commit every live replica's tick in flight."""
        return sum(rep.engine.drain() for rep in self._live())

    def _busy(self) -> bool:
        if self.prefill is not None and self.prefill.pending():
            return True
        for rep in self._live():
            st = rep.engine.stats()
            if st.get("active") or st.get("queued"):
                return True
        return any(t.tier != "done" for t in self._tracked.values()
                   if t.sid not in self._done)

    def run(self, max_ticks: int = 100_000) -> dict[int, np.ndarray]:
        """Tick until every submitted request completed; returns
        ``{router_id: tokens}`` (failed or cancelled requests map to empty
        arrays) and clears the finished set."""
        ticks = 0
        while self._busy():
            self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(f"run() exceeded {max_ticks} ticks")
        self.drain()
        self.tick()  # claim the drained round's results
        out = dict(self._done)
        self._done = {}
        for sid in out:
            self._tracked.pop(sid, None)
        return out

    def result(self, sid: int, max_ticks: int = 100_000) -> np.ndarray:
        """Drive ticks until ``sid`` finishes; returns (and claims) its
        tokens, empty for a failed or cancelled request."""
        ticks = 0
        while True:
            if sid in self._done:
                self._tracked.pop(sid, None)
                return self._done.pop(sid)
            if sid not in self._tracked:
                raise KeyError(f"unknown request {sid}")
            self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(f"result({sid}) exceeded {max_ticks} "
                                   "ticks")

    # -- serving / exporter surface ----------------------------------------

    @property
    def lm(self):
        return self._live()[0].engine.lm

    @property
    def prompt_buckets(self):
        return self._live()[0].engine.prompt_buckets

    def capacity_book(self) -> dict | None:
        """The fleet as ONE capacity source (what a router process hands
        ``serve_metrics(capacity_provider=...)``): the first live book's
        shape with fleet-summed headroom, the prefill tier nested as a
        ``DisaggServer``'s."""
        live = self._live()
        books = [b for b in (self._book(r) for r in live) if b is not None]
        if not books:
            return None
        book = dict(books[0])
        hr: dict = {"replicas": len(live)}
        for b in books:
            for k, v in (b.get("headroom") or {}).items():
                if isinstance(v, (int, float)):
                    hr[k] = hr.get(k, 0) + v
        book["headroom"] = hr
        if self.prefill is not None:
            book["prefill"] = prefill_tier_book(self.prefill)
        return book

    def stats(self) -> dict:
        """Fleet-summed serving stats and the router's own books.
        ``queued`` covers the whole fleet, the prefill tier included (a
        caller's drain loop must see tiered work)."""
        live = self._live()
        out: dict = {}
        for rep in live:
            for k, v in rep.engine.stats().items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out[k] = out.get(k, 0) + v
        if live:
            out["ticks"] = max(rep.engine.stats().get("ticks", 0)
                               for rep in live)
        if self.prefill is not None:
            pf = self.prefill.stats()
            out["prefill_queued"] = pf["queued"]
            out["prefill_active"] = pf["active"]
            out["queued"] = out.get("queued", 0) + pf["queued"] + pf["active"]
        out.update(replicas_live=len(live), replicas_total=len(self._replicas),
                   placed=self.placed, shed=self.shed, replaced=self.replaced,
                   router_failed=self.failed)
        return out

    def close(self, close_engines: bool = False) -> None:
        """Release every lease and stop. The engines are the caller's
        unless ``close_engines`` (autoscaler-spawned fleets)."""
        self._closed = True
        for rep in self._replicas.values():
            if rep.alive:
                self._drop_lease(rep)
        if close_engines:
            for rep in self._replicas.values():
                try:
                    rep.engine.close()
                except Exception:  # noqa: BLE001
                    pass


class FleetAutoscaler:
    """Scale the fleet on the books the router places by.

    UP: fleet queue occupancy (queued over the summed queue bound) holds
    at or above ``RouterConfig.scale_up_queue_frac`` for
    ``autoscale_dwell_s`` with the fleet below ``max_replicas``:
    ``spawn(i)`` builds a replica ``(name, engine)`` and the router joins
    it. DOWN: a replica sits fully idle for ``scale_down_idle_s`` with the
    fleet above ``min_replicas``: a graceful detach. Both edges land in the
    flight stream (``scale_up`` / ``scale_down``)."""

    def __init__(self, router: FleetRouter,
                 spawn: Callable[[int], tuple[str, object]],
                 config: RouterConfig | None = None):
        self.router = router
        self.spawn = spawn
        self.cfg = config or router.cfg
        self._pressure_since: float | None = None
        self._spawned = 0
        self.scale_ups = 0
        self.scale_downs = 0
        router.attach_autoscaler(self)

    def _pressure(self) -> float:
        queued = bound = 0
        for rep in self.router._live():
            st = rep.engine.stats()
            queued += int(st.get("queued", 0))
            # The queue bound lives in the book's headroom; slots stand in
            # when the capacity plane is off.
            cap_book = getattr(rep.engine, "capacity_book", None)
            book = cap_book() if callable(cap_book) else None
            hr = (book or {}).get("headroom") or {}
            bound += int(hr.get("queue_bound", 0)) or len(rep.engine.slots)
        return queued / bound if bound else 0.0

    def step(self, now: float) -> None:
        router, cfg = self.router, self.cfg
        live = router._live()
        frac = self._pressure()
        if frac >= cfg.scale_up_queue_frac and len(live) < cfg.max_replicas:
            if self._pressure_since is None:
                self._pressure_since = now
            elif now - self._pressure_since >= cfg.autoscale_dwell_s:
                self._pressure_since = None
                self._spawned += 1
                name, engine = self.spawn(self._spawned)
                router.add_replica(name, engine)
                self.scale_ups += 1
                global_flight_recorder().record(
                    "scale_up", replica=name, queue_frac=round(frac, 4),
                    fleet=len(router._live()))
        else:
            self._pressure_since = None
        if len(router._live()) > cfg.min_replicas:
            for rep in router._live():
                if rep.idle_since is None or rep.sids:
                    continue
                if now - rep.idle_since < cfg.scale_down_idle_s:
                    continue
                router.detach(rep.name)
                self.scale_downs += 1
                global_flight_recorder().record(
                    "scale_down", replica=rep.name,
                    fleet=len(router._live()))
                break  # at most one retirement a tick
