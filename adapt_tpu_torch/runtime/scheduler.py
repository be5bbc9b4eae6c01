"""Multi-tenant traffic control in front of the continuous batcher — the
port of ``adapt_tpu/runtime/scheduler.py``: bounded admission, weighted
fair queueing and the closed-loop degradation ladder. Host code only; no
tensor passes through this module.

- :class:`AdmissionQueue` — the submit queue. Every request lands in its
  tenant's FIFO inside its PRIORITY CLASS (``config.SLOSpec.priority``;
  higher drains strictly first); each class drains its tenants by DEFICIT
  ROUND-ROBIN (``config.TenantQuota`` weights: a weight-2 tenant drains
  twice the requests a round), and two bounds reject synchronously with
  :class:`QueueFullError`: the global ``max_queue_depth`` and the
  tenant's ``burst`` cap. Without a config the queue is the strict FIFO a
  scheduler-less batcher runs, bounded. With
  ``SchedulerConfig.cache_aware`` the pop scans a bounded window of the
  selected tenant's queue for the candidate whose prompt prefix is most
  resident in the pager's radix index (a probe the paged batcher
  installs); classes and DRR are untouched.
- **Preemption** lives in ``runtime/continuous`` (it needs the slots):
  when the top class has waited past its TTFT headroom, the batcher
  replays the lowest-priority decode slot; this module only nominates the
  waiting request (:meth:`AdmissionQueue.preempt_candidate`).
- :class:`DegradationController` — reads queue depth, slot occupancy and
  windowed TTFT attainment once a tick and walks a fixed ladder with
  hysteresis, cheapest shed first: shrink ``draft_k``, raise the
  disaggregated busy threshold (a no-op until a ``DisaggServer`` attaches:
  the port has none yet), evict cold prefix pages, reject best-effort
  (``priority < 0``) submits. Each step records a ``degradation_step``
  flight event and moves ``scheduler.degraded_total`` and the
  ``scheduler.degradation_level`` gauge; the ladder retraces in reverse as
  the backlog drains.

Thread-safety: the queue is mutated only under the batcher's handoff
condition (``_cv``); the controller runs on the ticking thread. The
``scheduler.*`` metric names and flight kinds are the JAX package's
(``docs/OBSERVABILITY.md``).
"""

from __future__ import annotations

import collections
import dataclasses
import time
import weakref
from typing import Any

from adapt_tpu_torch.config import SchedulerConfig
from adapt_tpu_torch.utils.logging import get_logger
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.tracing import global_flight_recorder

log = get_logger("scheduler")


class QueueFullError(RuntimeError):
    """Admission control rejected a submit SYNCHRONOUSLY: the global
    ``max_queue_depth`` bound, the tenant's ``burst`` cap, or the
    degradation ladder's best-effort shed. The request was never
    accepted — no id to wait on, nothing journaled as pending,
    ``result()`` cannot wedge. Recorded as a ``request_rejected``
    flight event + ``scheduler.rejected_total``."""


def request_priority(req) -> int:
    """Scheduling class of a request-shaped object (anything carrying
    ``.slo``): ``SLOSpec.priority``, or 0 without an SLO."""
    slo = getattr(req, "slo", None)
    return int(slo.priority) if slo is not None else 0


def request_tenant(req) -> str:
    slo = getattr(req, "slo", None)
    return slo.tenant if slo is not None else "default"


class AdmissionQueue:
    """Bounded, weighted-fair admission queue: per-tenant FIFO queues
    inside strict priority classes, drained by deficit round-robin.

    API mirrors the ``collections.deque`` the batcher used, so the
    integration seams stay small: ``append`` (checked — raises
    :class:`QueueFullError`), ``appendleft`` (unchecked front
    re-insert for pool-pressure retries / recovery replays /
    preemption victims), ``popleft`` (the scheduler's pick),
    ``remove_id`` (cancel), ``clear``/``extend`` (recovery's FIFO
    rebuild), ``len``/iteration.

    Constructed WITHOUT a config (``cfg=None`` — the scheduler-less
    batcher default), the queue is STRICT FIFO: priority and tenant
    labels on requests are carried but inert, so a batcher that never
    opted into traffic control keeps its exact pre-scheduler admission
    order — the only behavioral change is the (default, generous)
    depth bound. An explicit config turns the classes/DRR machinery
    on; one tenant + one priority class still degrades to FIFO."""

    def __init__(self, cfg: SchedulerConfig | None = None):
        #: FIFO mode: no explicit config -> priority/tenant inert.
        self._fifo = cfg is None
        self.cfg = cfg or SchedulerConfig()
        #: priority -> tenant -> FIFO deque of requests.
        self._classes: dict[int, dict[str, collections.deque]] = {}
        #: priority -> DRR ring of tenants with queued work.
        self._rings: dict[int, collections.deque[str]] = {}
        #: (priority, tenant) -> outstanding DRR credit.
        self._deficit: dict[tuple[int, str], float] = {}
        self._depth = 0
        #: Queued requests per tenant (all classes) — burst-cap
        #: accounting and the ``scheduler.queue_depth.<tenant>``
        #: gauges. Tenants stay as zero entries once seen (so gauges
        #: drop to 0 instead of going stale) up to ``_MAX_TENANTS``;
        #: past it, drained tenants are evicted — a client minting a
        #: fresh tenant label per request must not grow this map (or
        #: the gauge registry, which the batcher prunes in step) for
        #: the process lifetime.
        self._tenant_depth: dict[str, int] = {}
        #: Degradation rung 4: reject ``priority < 0`` admits.
        self.shed_best_effort = False
        #: Cache-aware pick (``SchedulerConfig.cache_aware``): the
        #: batcher installs a callable ``req -> orderable score``
        #: (radix-resident prefix length, heat) and ``_pick`` scans a
        #: bounded window of the selected tenant queue for the hottest
        #: candidate instead of taking the head. None -> strict FIFO
        #: within the tenant queue, exactly the pre-radix behavior.
        self.prefix_probe = None
        #: req_ids re-inserted at the front (``appendleft``): pool-
        #: pressure put-backs and preemption victims must keep strict
        #: head-of-line service — the cache-aware scan is suppressed
        #: while one waits, else a hotter newcomer could starve a
        #: request the batcher already promised to retry next.
        self._front: set[int] = set()

    # -- bounds ------------------------------------------------------------

    def _weight(self, tenant: str) -> float:
        q = self.cfg.quotas.get(tenant)
        return q.weight if q is not None else self.cfg.default_weight

    def check(self, tenant: str, priority: int) -> None:
        """Raise :class:`QueueFullError` iff an admit for
        ``(tenant, priority)`` would be rejected right now — the one
        bound-check body ``append`` and the disaggregated pre-check
        share."""
        if self.shed_best_effort and priority < 0:
            raise QueueFullError(
                "best-effort admission shed (degradation ladder)"
            )
        if self._depth >= self.cfg.max_queue_depth:
            raise QueueFullError(
                f"queue depth {self._depth} at max_queue_depth="
                f"{self.cfg.max_queue_depth}"
            )
        q = self.cfg.quotas.get(tenant)
        if (
            q is not None
            and q.burst is not None
            and self._tenant_depth.get(tenant, 0) >= q.burst
        ):
            raise QueueFullError(
                f"tenant {tenant!r} at burst cap {q.burst}"
            )

    # -- deque-shaped mutation ---------------------------------------------

    def _key(self, req) -> tuple[str, int]:
        """Scheduling key of a request: FIFO mode folds everything
        into one class/queue (insertion order IS the pop order)."""
        if self._fifo:
            return "default", 0
        return request_tenant(req), request_priority(req)

    def _push(self, req, *, front: bool) -> None:
        tenant, prio = self._key(req)
        tenants = self._classes.setdefault(prio, {})
        q = tenants.get(tenant)
        if q is None:
            q = tenants[tenant] = collections.deque()
        ring = self._rings.setdefault(prio, collections.deque())
        if tenant not in ring:
            ring.append(tenant)
        if front:
            q.appendleft(req)
        else:
            q.append(req)
        self._depth += 1
        self._tenant_depth[tenant] = (
            self._tenant_depth.get(tenant, 0) + 1
        )

    def append(self, req) -> None:
        """Checked admit — raises :class:`QueueFullError` at a bound."""
        self.check(*self._key(req))
        self._push(req, front=False)

    def appendleft(self, req) -> None:
        """UNCHECKED front re-insert (its tenant queue's head): pool-
        pressure retries put back a request they just popped, and
        recovery replays / preemption victims re-queue work already
        accepted — a bound here would drop an in-flight request.

        The re-insert also restores the tenant's SERVICE TURN: it
        jumps to the front of its class ring and gets the DRR unit
        its earlier pop charged refunded — classic DRR charges only
        service actually rendered, and every front re-insert is a pop
        whose service did not happen (pool-pressure put-back) or was
        undone (replay / preemption). Without both, a large request
        that fails allocation loses its turn to every other tenant's
        smaller requests each tick and can starve indefinitely; with
        them, the next pop in its class returns exactly this request
        — the head-of-line discipline FIFO mode gets for free."""
        tenant, prio = self._key(req)
        self._push(req, front=True)
        self._front.add(req.req_id)
        if self._fifo:
            return
        ring = self._rings[prio]
        if ring and ring[0] != tenant:
            ring.remove(tenant)
            ring.appendleft(tenant)
        self._deficit[(prio, tenant)] = (
            self._deficit.get((prio, tenant), 0.0) + 1.0
        )

    #: Drained-tenant zero entries retained for gauge continuity.
    _MAX_TENANTS = 256

    def _account_pop(self, tenant: str) -> None:
        self._depth -= 1
        self._tenant_depth[tenant] -= 1
        if (
            self._tenant_depth[tenant] == 0
            and len(self._tenant_depth) > self._MAX_TENANTS
        ):
            del self._tenant_depth[tenant]

    def popleft(self):
        """The scheduler's pick: highest priority class first; within
        it, deficit round-robin over the tenant ring (one visit refills
        ``quantum * weight`` credit; a request costs 1; an exhausted
        tenant rotates to the back). Raises ``IndexError`` when empty,
        like the deque."""
        for prio in sorted(self._classes, reverse=True):
            req = self._pop_class(prio)
            if req is not None:
                return req
        raise IndexError("pop from an empty AdmissionQueue")

    def _pop_class(self, prio: int):
        tenants = self._classes.get(prio)
        ring = self._rings.get(prio)
        while ring:
            t = ring[0]
            q = tenants.get(t)
            if not q:
                # Stale ring entry (emptied by remove_id/clear).
                ring.popleft()
                self._deficit.pop((prio, t), None)
                tenants.pop(t, None)
                continue
            d = self._deficit.get((prio, t), 0.0)
            if d < 1.0:
                # Start of this tenant's turn: one refill per turn.
                d += self.cfg.quantum * self._weight(t)
                if d < 1.0:
                    # Fractional weight: credit accumulates across
                    # rounds until it covers one request.
                    self._deficit[(prio, t)] = d
                    ring.rotate(-1)
                    continue
            req = self._pick(q)
            self._account_pop(t)
            d -= 1.0
            if not q:
                # Tenant drained: leave the ring, reset its credit
                # (idle tenants must not bank service).
                ring.popleft()
                self._deficit.pop((prio, t), None)
                tenants.pop(t, None)
            elif d < 1.0:
                # Turn exhausted: rotate to the back of the round.
                self._deficit[(prio, t)] = d
                ring.rotate(-1)
            else:
                self._deficit[(prio, t)] = d
            return req
        # Class fully drained.
        self._classes.pop(prio, None)
        self._rings.pop(prio, None)
        return None

    def _pick(self, q):
        """Take one request from tenant queue ``q``: strict FIFO head,
        unless cache-aware ordering is on AND a probe is installed AND
        the head is not a front re-insert — then scan the first
        ``cache_aware_window`` entries and take the one with the
        hottest/longest radix-resident prefix (STRICTLY greater score
        wins, so equal-score candidates keep arrival order and a cold
        queue degrades to exact FIFO). The window bounds the scan cost
        per pop and the queue-jump distance: entry ``window`` onward
        can be bypassed at most ``window - 1`` times per pop, so no
        request waits unboundedly behind an endless hot stream."""
        probe = self.prefix_probe
        if (
            probe is None
            or not self.cfg.cache_aware
            or len(q) < 2
            or q[0].req_id in self._front
        ):
            req = q.popleft()
        else:
            n = min(len(q), max(1, self.cfg.cache_aware_window))
            best, best_score = 0, None
            for i in range(n):
                try:
                    score = probe(q[i])
                except Exception:  # probe must never break admission
                    score = None
                if score is not None and (
                    best_score is None or score > best_score
                ):
                    best, best_score = i, score
            if best == 0:
                req = q.popleft()
            else:
                req = q[best]
                del q[best]
        self._front.discard(req.req_id)
        return req

    def remove_id(self, req_id: int):
        """Remove and return the queued request with ``req_id``
        (cancel path), or None."""
        for prio, tenants in self._classes.items():
            for t, q in tenants.items():
                for i, req in enumerate(q):
                    if req.req_id == req_id:
                        del q[i]
                        self._account_pop(t)
                        self._front.discard(req_id)
                        return req
        return None

    def clear(self) -> None:
        self._classes.clear()
        self._rings.clear()
        self._deficit.clear()
        self._front.clear()
        self._depth = 0
        for t in list(self._tenant_depth):
            if len(self._tenant_depth) > self._MAX_TENANTS:
                del self._tenant_depth[t]
            else:
                self._tenant_depth[t] = 0

    def extend(self, reqs) -> None:
        """UNCHECKED bulk append in order — recovery's FIFO rebuild of
        already-accepted work."""
        for r in reqs:
            self._push(r, front=False)

    def __len__(self) -> int:
        return self._depth

    def __iter__(self):
        for prio in sorted(self._classes, reverse=True):
            for q in list(self._classes[prio].values()):
                yield from list(q)

    # -- scheduler views ---------------------------------------------------

    def depths(self) -> dict[str, int]:
        """Queued requests per tenant (zero entries for tenants seen
        before) — the ``scheduler.queue_depth.<tenant>`` gauges."""
        return dict(self._tenant_depth)

    def pressure(self) -> tuple[int, int, dict[str, int]]:
        """``(depth, bound, per-tenant depths)`` in one call — the
        capacity book's queue-pressure read (``runtime/capacity``),
        kept here so the book and the admission bound can never read
        different notions of "full"."""
        return (
            self._depth,
            int(self.cfg.max_queue_depth),
            dict(self._tenant_depth),
        )

    def preempt_candidate(self):
        """The waiting request preemption would serve: the tenant-queue
        head in the highest non-empty priority class that has burned
        the LARGEST FRACTION of its TTFT budget (no budget -> nothing
        to protect -> never a reason to preempt). Fraction, not raw
        wait: an old head with a lax 10s budget must not shadow a
        younger head already past 80% of a 0.5s one — the trigger
        compares against the budget, so the nomination must too.
        Returns ``(request, priority)`` or None. Non-mutating — DRR
        state does not advance. FIFO mode (no scheduler config) never
        nominates anyone."""
        if self._fifo:
            return None
        now = time.perf_counter()
        for prio in sorted(self._classes, reverse=True):
            tenants = self._classes[prio]
            best, best_frac = None, -1.0
            for q in tenants.values():
                if not q:
                    continue
                r = q[0]
                if r.slo is None or not r.slo.ttft_budget_s:
                    continue
                waited = now - (
                    getattr(r, "t_requeued", 0.0) or r.t_submit
                )
                frac = waited / r.slo.ttft_budget_s
                if frac > best_frac:
                    best, best_frac = r, frac
            if any(tenants.values()):
                # Only the TOP non-empty class may preempt; a budgeted
                # request in a lower class never preempts past it.
                return (best, prio) if best is not None else None
        return None


class DegradationController:
    """The closed loop: per-tick pressure evaluation + the shed ladder
    (see the module docstring). Owned by a scheduler-configured
    ``ContinuousBatcher``; a ``DisaggServer`` fronting that batcher
    attaches itself so the busy-threshold rung has a target."""

    #: Fixed rung order, cheapest shed first. Rungs whose capability
    #: is absent (no draft model, no disagg tier, dense layout) apply
    #: as no-ops, so the level number always means the same thing.
    LADDER = (
        "draft_k",
        "busy_threshold",
        "evict_cached",
        "reject_best_effort",
    )

    @property
    def rung(self) -> str:
        """Name of the deepest rung currently applied (``""`` at level
        0) — the capacity book's human-readable degradation field."""
        return self.LADDER[self.level - 1] if self.level > 0 else ""

    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.level = 0
        self._t_change = 0.0
        self._t_att = 0.0
        self._att_low = False
        self._slo_seen = (0, 0)
        self._disagg: Any = None  # weakref.ref when attached
        self._saved_disagg_cfg = None
        #: Which server _saved_disagg_cfg belongs to (weakref): a
        #: revert must never clobber a DIFFERENT server — one attached
        #: after the save — with a retired server's stale config.
        self._saved_disagg_for: Any = None

    def attach_disagg(self, server) -> None:
        """Give the busy-threshold rung a target (weakly held — the
        controller must never pin a retired server). Attaching while
        the rung is HELD applies it to the new server immediately
        (saving ITS config), so a server swapped in mid-overload
        degrades like the one it replaced instead of serving the
        undegraded thresholds until the next escalation."""
        self._disagg = weakref.ref(server)
        if self.level > self.LADDER.index("busy_threshold"):
            self._saved_disagg_cfg = server.cfg
            self._saved_disagg_for = weakref.ref(server)
            server.cfg = dataclasses.replace(
                server.cfg,
                busy_prompt_threshold=server.cfg.prompt_threshold,
            )

    # -- pressure ----------------------------------------------------------

    def _windowed_attainment_low(self, bat, now: float) -> bool:
        """Windowed TTFT attainment below the floor? Window = one dwell
        period of the batcher's met/missed totals (cheap deltas of ints
        the commit path already keeps)."""
        if now - self._t_att < self.cfg.degrade_dwell_s:
            return self._att_low
        tot = bat._slo_totals
        met = tot["ttft_met"] - self._slo_seen[0]
        missed = tot["ttft_missed"] - self._slo_seen[1]
        self._slo_seen = (tot["ttft_met"], tot["ttft_missed"])
        self._t_att = now
        if met + missed >= 4:
            self._att_low = (
                met / (met + missed) < self.cfg.degrade_attainment
            )
        else:
            self._att_low = False
        return self._att_low

    def step(self, bat) -> None:
        """One control evaluation (ticking thread, host arithmetic
        only): escalate/de-escalate at most one rung per dwell.

        Staleness bound under the pipelined tick runtime
        (``config.RuntimeConfig(pipeline_depth=2)``): this runs at the
        top of the DISPATCH half, so the occupancy/attainment inputs
        read here predate the in-flight tick's commit — slots that
        tick retires still count occupied, and its SLO verdicts are
        not yet in ``_slo_totals``. The error is bounded by exactly
        ONE tick (at most ``chunk`` tokens per slot of pending
        retirement, one tick of attainment movement), which is well
        inside the controller's own ``degrade_dwell_s`` smoothing —
        the ladder can react one tick late, never wrongly-direction.
        Queue depth is exact (submissions are immediate, not
        pipelined)."""
        cfg = self.cfg
        now = time.perf_counter()
        with bat._cv:
            queued = len(bat._queue)
        occupancy = sum(
            1 for s in bat.slots if s.req is not None
        ) / max(1, len(bat.slots))
        qfrac = queued / max(1, cfg.max_queue_depth)
        att_low = self._windowed_attainment_low(bat, now)
        overload = occupancy >= cfg.degrade_occupancy and (
            qfrac >= cfg.degrade_queue_high or (att_low and queued > 0)
        )
        calm = qfrac <= cfg.degrade_queue_low and not att_low
        if now - self._t_change >= cfg.degrade_dwell_s:
            if overload and self.level < len(self.LADDER):
                step = self.LADDER[self.level]
                self._apply(bat, step)
                self.level += 1
                self._t_change = now
                global_metrics().inc("scheduler.degraded_total")
                global_metrics().set_gauge(
                    "scheduler.degradation_level", float(self.level)
                )
                global_flight_recorder().record(
                    "degradation_step",
                    level=self.level,
                    step=step,
                    direction="up",
                    queued=queued,
                    occupancy=round(occupancy, 3),
                )
                log.warning(
                    "degradation up -> level %d (%s): queued=%d "
                    "occupancy=%.2f attainment_low=%s",
                    self.level, step, queued, occupancy, att_low,
                )
            elif calm and self.level > 0:
                self.level -= 1
                step = self.LADDER[self.level]
                self._revert(bat, step)
                self._t_change = now
                global_metrics().set_gauge(
                    "scheduler.degradation_level", float(self.level)
                )
                global_flight_recorder().record(
                    "degradation_step",
                    level=self.level,
                    step=step,
                    direction="down",
                    queued=queued,
                    occupancy=round(occupancy, 3),
                )
                log.info(
                    "degradation down -> level %d (reverted %s)",
                    self.level, step,
                )

    # -- the rungs ---------------------------------------------------------

    def _apply(self, bat, step: str) -> None:
        if step == "draft_k" and bat._spec is not None:
            bat.set_draft_k(max(1, bat._spec.draft_k // 2))
        elif step == "busy_threshold":
            srv = self._disagg() if self._disagg is not None else None
            if srv is not None:
                self._saved_disagg_cfg = srv.cfg
                self._saved_disagg_for = weakref.ref(srv)
                srv.cfg = dataclasses.replace(
                    srv.cfg,
                    busy_prompt_threshold=srv.cfg.prompt_threshold,
                )
        elif step == "evict_cached" and bat._paged:
            # ONE-SHOT sweep at escalation, deliberately not re-run
            # while the rung holds: allocation already evicts cold
            # pages on demand (Pager.can_alloc counts the LRU), so
            # this rung is capacity-NEUTRAL by construction — what it
            # sheds is the cache's speculative value (prefix-hit
            # prefill savings) in exchange for keeping the allocator
            # on its free-list fast path through the overload, and it
            # is the operator-visible signal that residency has been
            # sacrificed. A per-tick sweep would additionally wipe
            # preemption victims' prompt pages before their
            # re-admission could prefix-hit them — strictly more
            # prefill work, exactly when the system can least afford
            # it.
            bat._pager.evict_cached()
        elif step == "reject_best_effort":
            bat._queue.shed_best_effort = True

    def _revert(self, bat, step: str) -> None:
        if step == "draft_k" and bat._spec is not None:
            bat.set_draft_k(bat._spec.draft_k)
        elif step == "busy_threshold":
            srv = self._disagg() if self._disagg is not None else None
            saved_for = (
                self._saved_disagg_for()
                if self._saved_disagg_for is not None
                else None
            )
            if (
                srv is not None
                and self._saved_disagg_cfg is not None
                and saved_for is srv  # never clobber a DIFFERENT server
            ):
                srv.cfg = self._saved_disagg_cfg
            self._saved_disagg_cfg = None
            self._saved_disagg_for = None
        elif step == "reject_best_effort":
            bat._queue.shed_best_effort = False
        # "evict_cached" has nothing to restore: the cache refills
        # from traffic.
