"""Replica capacity, TTFT-forecast and prefix-affinity signal plane —
the port of ``adapt_tpu/runtime/capacity.py`` (host-side Python; the
books, gauges and wire form are the JAX package's).

- **Headroom book** — free slots, free + cached pages, admission-queue
  depth against its bound, per-tenant queue pressure and the current
  degradation rung, in one JSON-safe dict.
- **TTFT forecaster** (:class:`TTFTForecaster`) — EWMAs of queue wait,
  per-pow2-bucket prefill walls (learned from the suffix tokens each
  admission computes) and the tick gap, under a multiplicative bias that
  every realized TTFT nudges toward realized / forecast; the within-2x
  fraction is the ``capacity.forecast_calibration`` gauge and the
  absolute error the ``capacity.ttft_forecast_abs_err_s`` histogram.
- **Prefix-affinity sketch** — the top-K radix nodes by token-weighted
  heat (``Pager.radix_sketch``) as blake2b-8 digests of their content
  keys; :func:`affinity_score` scores a prompt against a shipped sketch
  with no round trip to the replica.
- **Health score** — ``ok | degraded | critical`` with dwell hysteresis,
  from the degradation rung, recovery, unexpected compiles, windowed TTFT
  attainment and queue saturation (``capacity.health`` gauge,
  ``health_transition`` flight events).

Books ride the ``TelemetryReporter`` -> ``FederatedStore`` wire (a
report's ``capacity`` section, served at ``GET /fleet/capacity``). Every
feed is O(1) attribute work on the batcher's submit / admit / commit
sites; rebuilds happen in :meth:`CapacityModel.update` on the
``_obs_flush`` seam, rate-limited by ``CapacityConfig.refresh_s``.
"""

from __future__ import annotations

import collections
import hashlib
import time

import numpy as np

from adapt_tpu_torch.config import CapacityConfig
from adapt_tpu_torch.runtime.scheduler import DegradationController
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.tracing import global_flight_recorder

#: Book schema version (a router must reject books from a newer peer
#: loudly, not half-parse them — same stance as telemetry.REPORT_V).
BOOK_V = 1

#: Health levels, gauge encoding and wire names. Order IS severity.
HEALTH_NAMES = ("ok", "degraded", "critical")

#: Sketch-entry hash: blake2b-8 of the radix node's content key. 8
#: bytes keeps a book small at sketch_k entries while a cross-replica
#: collision stays ~2^-64 per pair — a wrong AFFINITY score on
#: collision costs one suboptimal placement, never correctness.
_DIGEST_SIZE = 8


def _key_hash(key: bytes) -> str:
    return hashlib.blake2b(key, digest_size=_DIGEST_SIZE).hexdigest()


def _pow2_bucket(n: int) -> int:
    """Smallest power of two >= max(1, n) — the forecaster's prefill
    wall buckets, mirroring the batcher's pow2 prompt buckets (walls
    are a property of the padded bucket a prefill actually runs at,
    not the raw token count)."""
    b = 1
    n = max(1, int(n))
    while b < n:
        b *= 2
    return b


class TTFTForecaster:
    """EWMA-learned TTFT estimate with online self-calibration.

    ``forecast = bias * (queue_wait + prefill_wall(bucket) + tick_gap)``

    where every term is an EWMA of measured walls and ``bias`` is a
    multiplicative corrector updated from realized/forecast ratios
    (log-free power update, clamped), so structural costs the additive
    model misses — chunked prefill spreading over ticks, pipelined
    commit lag, queue depth the wait EWMA lags — are absorbed instead
    of becoming permanent error."""

    def __init__(self, alpha: float = 0.2, window: int = 256):
        self._a = float(alpha)
        self._queue_wait: float | None = None
        #: pow2 suffix bucket -> EWMA prefill wall seconds.
        self._walls: dict[int, float] = {}
        #: EWMA seconds per prefilled position (the cold-bucket
        #: fallback before any wall lands in a bucket).
        self._per_token: float | None = None
        #: EWMA gap between an admission's prefill end and its first
        #: committed token (decode dispatch + commit latency).
        self._tick_gap: float | None = None
        self._bias = 1.0
        #: Rolling within-2x verdicts (the calibration fraction).
        self._within: collections.deque[bool] = collections.deque(
            maxlen=max(1, int(window))
        )
        self._samples = 0

    # -- feeds (O(1); admission / commit sites) -------------------------

    def _ewma(self, old: float | None, v: float) -> float:
        """Fast-down, slow-up: a sample 4x UNDER the EWMA snaps the
        estimate to it instead of decaying there over dozens of
        admissions. Queue waits and prefill walls are floor-like —
        their outliers are structural one-offs that only inflate
        (warmup admissions measure kernel builds through the same host
        sync as real walls) — so the steady-state value is the floor
        and an inflated estimate should not take 1/alpha admissions
        to forget."""
        if old is None:
            return v
        if v < old / 4:
            return v
        return old + self._a * (v - old)

    def observe_queue_wait(self, s: float) -> None:
        self._queue_wait = self._ewma(self._queue_wait, max(0.0, s))

    def observe_prefill(self, tokens: int, wall_s: float) -> None:
        """One admission's in-tick prefill: ``tokens`` positions
        actually computed (the suffix past any prefix-cache hit) took
        ``wall_s``."""
        if tokens <= 0 or wall_s < 0:
            return
        b = _pow2_bucket(tokens)
        self._walls[b] = self._ewma(self._walls.get(b), wall_s)
        self._per_token = self._ewma(self._per_token, wall_s / tokens)

    def observe_tick_gap(self, s: float) -> None:
        self._tick_gap = self._ewma(self._tick_gap, max(0.0, s))

    # -- forecast --------------------------------------------------------

    def _wall_for(self, suffix_tokens: int) -> float:
        if suffix_tokens <= 0:
            return 0.0
        b = _pow2_bucket(suffix_tokens)
        w = self._walls.get(b)
        if w is not None:
            return w
        if self._walls:
            # Nearest learned bucket, scaled by the token ratio — a
            # coarse interpolation beats pretending an unseen bucket
            # costs nothing.
            near = min(self._walls, key=lambda k: abs(k - b))
            return self._walls[near] * (b / near)
        if self._per_token is not None:
            return self._per_token * suffix_tokens
        return 0.0

    def forecast(
        self, prompt_len: int, prefix_hit_tokens: int = 0
    ) -> float:
        """Seconds from submit to first committed token. Returns 0.0
        when NOTHING has been learned yet (a cold replica honestly has
        no estimate; callers treat 0 as "no forecast" and such
        admissions never enter the calibration books)."""
        suffix = max(0, int(prompt_len) - int(prefix_hit_tokens))
        raw = (
            (self._queue_wait or 0.0)
            + self._wall_for(suffix)
            + (self._tick_gap or 0.0)
        )
        return self._bias * raw if raw > 0 else 0.0

    # -- self-calibration ------------------------------------------------

    def record_realized(self, forecast_s: float, realized_s: float) -> bool:
        """Fold one (submit-time forecast, realized TTFT) pair in;
        returns the within-2x verdict. The bias corrector moves
        toward the realized/forecast ratio (clamped: one outlier tick
        must not swing every later forecast 10x)."""
        if forecast_s <= 0 or realized_s <= 0:
            return False
        ratio = realized_s / forecast_s
        within = 0.5 <= ratio <= 2.0
        self._within.append(within)
        self._samples += 1
        step = min(4.0, max(0.25, ratio)) ** self._a
        self._bias = min(8.0, max(0.125, self._bias * step))
        return within

    def calibration(self) -> float:
        """Fraction of the rolling window's forecasts within 2x of
        realized (1.0 when no samples yet — an unmeasured forecaster
        is unproven, not failing; the gauge only becomes meaningful
        with samples, which the book reports alongside)."""
        if not self._within:
            return 1.0
        return sum(self._within) / len(self._within)

    def reset_calibration(self) -> None:
        """Drop the rolling verdict window (learned walls and bias
        survive) — the train-then-measure seam of a load generator."""
        self._within.clear()

    def snapshot(self) -> dict:
        return {
            "queue_wait_s": round(self._queue_wait or 0.0, 6),
            "tick_gap_s": round(self._tick_gap or 0.0, 6),
            "bias": round(self._bias, 4),
            "calibration": round(self.calibration(), 4),
            "samples": self._samples,
            "walls": {
                str(b): round(w, 6)
                for b, w in sorted(self._walls.items())
            },
        }


def sketch_from_pager(pager, k: int) -> dict:
    """The bounded prefix-affinity sketch: ``pager``'s top-``k`` radix
    nodes by token-weighted heat, content keys hashed. Entries carry
    the node's page depth, covered tokens, and lifetime hit heat —
    everything :func:`affinity_score` needs, nothing else leaves the
    replica."""
    page_tokens = int(getattr(pager, "page_tokens", 0) or 0)
    entries = []
    if page_tokens:
        for key, depth, hits in pager.radix_sketch(k):
            entries.append(
                {
                    "h": _key_hash(key),
                    "d": int(depth),
                    "t": int(depth) * page_tokens,
                    "heat": int(hits),
                }
            )
    return {"v": BOOK_V, "page_tokens": page_tokens, "entries": entries}


def affinity_score(sketch: dict, prompt) -> float:
    """Score ``prompt``'s affinity for the replica that shipped
    ``sketch`` — STATIC: hashes the prompt's page prefixes locally and
    intersects with the sketch's hashed keys, no replica round-trip.

    Returns the deepest matched prefix in TOKENS plus a sub-token heat
    tiebreak (two replicas holding the same depth rank by how hot the
    matched path runs there). 0.0 = cold. The walk mirrors the
    admission probe: the page holding the last prompt token is never
    shareable, so the scan caps at ``(len - 1) // page_tokens``."""
    if not isinstance(sketch, dict) or int(sketch.get("v", -1)) != BOOK_V:
        return 0.0
    page_tokens = int(sketch.get("page_tokens", 0) or 0)
    entries = sketch.get("entries") or ()
    if not page_tokens or not entries:
        return 0.0
    by_hash = {e["h"]: e for e in entries if "h" in e}
    tokens = np.ascontiguousarray(np.asarray(prompt, np.int32).reshape(-1))
    raw = tokens.tobytes()
    step = 4 * page_tokens
    best_tokens, heat = 0, 0
    # No break on a miss: the sketch is top-K, so a hot deep node can
    # survive while its (resident) ancestor was squeezed out — the
    # deepest HASH PRESENT is still evidence of that resident path.
    for j in range((tokens.shape[0] - 1) // page_tokens):
        e = by_hash.get(_key_hash(raw[: (j + 1) * step]))
        if e is not None:
            best_tokens = (j + 1) * page_tokens
            heat += int(e.get("heat", 0))
    if not best_tokens:
        return 0.0
    return float(best_tokens) + min(float(heat), 999.0) * 1e-3


def forecast_from_snapshot(
    snap: dict, prompt_len: int, prefix_hit_tokens: int = 0
) -> float:
    """Router-side TTFT forecast from a SHIPPED book's ``forecast``
    section (:meth:`TTFTForecaster.snapshot`) — the static sibling of
    :func:`affinity_score`: the same bucket-walk
    :meth:`TTFTForecaster.forecast` runs replica-side, replayed from
    the wire snapshot with no replica round-trip. Returns seconds;
    0.0 = the replica has learned nothing yet (callers fall back to
    headroom — least-loaded — exactly as a cold replica deserves)."""
    if not isinstance(snap, dict) or not snap:
        return 0.0
    suffix = max(0, int(prompt_len) - int(prefix_hit_tokens))
    wall = 0.0
    walls = snap.get("walls") or {}
    if suffix > 0 and walls:
        by_bucket = {int(k): float(v) for k, v in walls.items()}
        b = _pow2_bucket(suffix)
        w = by_bucket.get(b)
        if w is None:
            # Nearest learned bucket scaled by the token ratio — the
            # forecaster's own coarse interpolation, mirrored.
            near = min(by_bucket, key=lambda k: abs(k - b))
            w = by_bucket[near] * (b / near)
        wall = w
    raw = (
        float(snap.get("queue_wait_s") or 0.0)
        + wall
        + float(snap.get("tick_gap_s") or 0.0)
    )
    bias = float(snap.get("bias") or 1.0)
    return bias * raw if raw > 0 else 0.0


class HealthScore:
    """``ok | degraded | critical`` with dwell hysteresis.

    Worsening applies IMMEDIATELY (a router must back off fast);
    improvement must hold ``dwell_s`` before the published level
    follows (flapping signals — a degradation controller oscillating
    around its threshold — must not make placement oscillate with
    them). Every published change records a ``health_transition``
    flight event."""

    def __init__(self, dwell_s: float = 1.0):
        self._dwell = float(dwell_s)
        self.level = 0
        #: (candidate better level, since-monotonic) — pending
        #: improvement being dwelled on.
        self._pending: tuple[int, float] | None = None

    def update(self, target: int, now: float | None = None) -> int:
        now = time.monotonic() if now is None else now
        target = max(0, min(len(HEALTH_NAMES) - 1, int(target)))
        if target >= self.level:
            self._pending = None
            if target > self.level:
                self._transition(target)
            return self.level
        if self._pending is None or self._pending[0] != target:
            self._pending = (target, now)
        if now - self._pending[1] >= self._dwell:
            self._pending = None
            self._transition(target)
        return self.level

    def _transition(self, to: int) -> None:
        global_flight_recorder().record(
            "health_transition",
            from_level=HEALTH_NAMES[self.level],
            to_level=HEALTH_NAMES[to],
        )
        self.level = to

    @property
    def name(self) -> str:
        return HEALTH_NAMES[self.level]


class CapacityModel:
    """The self-describing replica: one per ``ContinuousBatcher``.

    Hot-path feeds are O(1) attribute work (submit-time forecast,
    admission EWMA observes, commit-time realized compare appending to
    a pending list); everything else — headroom/sketch/health rebuild,
    gauge + histogram flush — happens in :meth:`update`, called from
    the batcher's ``_obs_flush`` seam and rate-limited by
    ``CapacityConfig.refresh_s``. ``update`` runs on the ticking
    thread; ``forecast_ttft`` may run on client threads (submit), so
    the forecaster's feeds touch only per-field scalars (GIL-atomic
    swaps, same stance as the batcher's _slo_pending ints)."""

    def __init__(
        self,
        cfg: CapacityConfig | None = None,
        *,
        kind: str = "decode",
        window_s: float = 2.0,
    ):
        self.cfg = cfg or CapacityConfig()
        self.kind = kind
        self.window_s = float(window_s)
        self.forecaster = TTFTForecaster(
            alpha=self.cfg.ewma_alpha,
            window=self.cfg.calibration_window,
        )
        self.health = HealthScore(dwell_s=self.cfg.health_dwell_s)
        #: (forecast_s, realized_s) pairs committed since the last
        #: update() — folded into the calibration books and the
        #: abs-err histogram there (ticking thread only: appended at
        #: commit, drained at flush).
        self._pending_ttft: list[tuple[float, float]] = []
        self._book: dict = {
            "v": BOOK_V,
            "kind": kind,
            "wall": time.time(),
            "health": self.health.name,
            "health_level": 0,
            "headroom": {},
            "forecast": self.forecaster.snapshot(),
            "sketch": {"v": BOOK_V, "page_tokens": 0, "entries": []},
        }
        self._last_refresh = 0.0
        #: Compile-sentinel event count at the last refresh (health
        #: reads the DELTA: a recompile long ago is not a reason to
        #: stay degraded forever).
        self._compile_seen: int | None = None
        self._recent_recompile = False
        #: SLO totals at the last refresh (windowed attainment reads
        #: the delta, same stance as DegradationController).
        self._slo_seen = {"ttft_met": 0, "ttft_missed": 0}

    # -- hot-path feeds --------------------------------------------------

    def forecast_ttft(
        self, prompt_len: int, prefix_hit_tokens: int = 0
    ) -> float:
        """Submit-time TTFT forecast (seconds; 0.0 = nothing learned
        yet). Stored on the request and compared against its realized
        TTFT at first-token commit."""
        return self.forecaster.forecast(prompt_len, prefix_hit_tokens)

    def on_queue_wait(self, s: float) -> None:
        self.forecaster.observe_queue_wait(s)

    def on_prefill(self, tokens: int, wall_s: float) -> None:
        self.forecaster.observe_prefill(tokens, wall_s)

    def on_tick_gap(self, s: float) -> None:
        self.forecaster.observe_tick_gap(s)

    def on_ttft(self, forecast_s: float, realized_s: float) -> None:
        """One admission's realized TTFT against its submit-time
        forecast (commit site; cheap append — the verdict and
        histogram work happen at flush)."""
        if forecast_s > 0 and realized_s > 0:
            self._pending_ttft.append((forecast_s, realized_s))

    def reset_calibration(self) -> None:
        self._pending_ttft.clear()
        self.forecaster.reset_calibration()

    def calibration(self) -> float:
        return self.forecaster.calibration()

    # -- refresh (off the critical path) ---------------------------------

    def update(self, bat, now: float | None = None) -> bool:
        """Drain pending calibration pairs, then (rate-limited)
        rebuild the book and publish the capacity gauges. ``bat`` is
        the owning ``ContinuousBatcher``; returns True when a rebuild
        ran."""
        now = time.monotonic() if now is None else now
        reg = global_metrics()
        if self._pending_ttft:
            errs = []
            for f, r in self._pending_ttft:
                self.forecaster.record_realized(f, r)
                errs.append(abs(r - f))
            self._pending_ttft.clear()
            reg.observe_many("capacity.ttft_forecast_abs_err_s", errs)
        if now - self._last_refresh < self.cfg.refresh_s:
            return False
        self._last_refresh = now
        self.refresh_book(bat, now=now)
        book = self._book
        hr = book["headroom"]
        reg.set_gauge("capacity.health", float(self.health.level))
        reg.set_gauge(
            "capacity.forecast_calibration",
            self.forecaster.calibration(),
        )
        reg.set_gauge(
            "capacity.slots_free", float(hr.get("slots_free", 0))
        )
        reg.set_gauge(
            "capacity.pages_free", float(hr.get("pages_free", 0))
        )
        reg.set_gauge(
            "capacity.queue_frac", float(hr.get("queue_frac", 0.0))
        )
        reg.set_gauge(
            "capacity.sketch_entries",
            float(len(book["sketch"]["entries"])),
        )
        return True

    def refresh_book(self, bat, now: float | None = None) -> dict:
        """Rebuild the book from the batcher's live books (ticking
        thread; every read here is a host-side attribute or dict
        snapshot — no device work, no locks beyond the pager's
        C-speed list() snapshots)."""
        now = time.monotonic() if now is None else now
        free_slots = sum(1 for s in bat.slots if s.req is None)
        queue_len, bound, tenant_depths = bat._queue.pressure()
        queue_frac = queue_len / bound if bound > 0 else 0.0
        level = int(bat._controller.level) if bat._controller else 0
        rung = bat._controller.rung if bat._controller else ""
        headroom: dict = {
            "slots_free": free_slots,
            "slots_total": len(bat.slots),
            "queue_depth": queue_len,
            "queue_bound": bound,
            "queue_frac": round(queue_frac, 4),
            "tenants": {
                str(t): int(d) for t, d in tenant_depths.items()
            },
            "degradation_level": level,
            "degradation_rung": rung,
        }
        sketch = {"v": BOOK_V, "page_tokens": 0, "entries": []}
        if bat._pager is not None:
            ps = bat._pager.stats()
            headroom["pages_free"] = ps.free
            headroom["pages_in_use"] = ps.in_use
            headroom["pages_cached"] = ps.cached
            headroom["pages_total"] = ps.num_pages
            sketch = sketch_from_pager(bat._pager, self.cfg.sketch_k)
        # -- health target from existing signals -------------------------
        recovering = bool(getattr(bat, "_lost_pending", False))
        sentinel_events = int(bat._sentinel.events)
        if self._compile_seen is None:
            self._compile_seen = sentinel_events
        self._recent_recompile = sentinel_events > self._compile_seen
        self._compile_seen = sentinel_events
        totals = bat._slo_totals
        met = totals["ttft_met"] - self._slo_seen["ttft_met"]
        missed = totals["ttft_missed"] - self._slo_seen["ttft_missed"]
        self._slo_seen = {
            "ttft_met": totals["ttft_met"],
            "ttft_missed": totals["ttft_missed"],
        }
        attainment_low = (met + missed) >= 4 and (
            met / (met + missed) < 0.5
        )
        target = 0
        if (
            level > 0
            or self._recent_recompile
            or attainment_low
            or queue_frac >= 0.9
        ):
            target = 1
        if recovering or level >= len(DegradationController.LADDER):
            target = 2
        self.health.update(target, now=now)
        self._book = {
            "v": BOOK_V,
            "kind": self.kind,
            "wall": time.time(),
            "health": self.health.name,
            "health_level": self.health.level,
            "headroom": headroom,
            "forecast": self.forecaster.snapshot(),
            "sketch": sketch,
        }
        return self._book

    def book(self) -> dict:
        """The last rebuilt book (JSON-safe; ``wall`` is the rebuild's
        wall clock, so any consumer can age it)."""
        return self._book


def prefill_tier_book(prefill) -> dict:
    """Capacity book for a disaggregated prefill tier
    (``runtime/disagg.PrefillWorker``): queue/pool headroom from the
    tier's own stats, plus its pager's affinity sketch — the pages a
    handoff would find already resident. Rides the tier's registry
    lease (``meta["capacity"]``)."""
    st = prefill.stats()
    pool = int(st.get("pool_pages", 0))
    in_use = int(st.get("pages_in_use", 0))
    book = {
        "v": BOOK_V,
        "kind": "prefill",
        "wall": time.time(),
        "health": "ok",
        "health_level": 0,
        "headroom": {
            "queue_depth": int(st.get("queued", 0)),
            "active": int(st.get("active", 0)),
            "pages_total": pool,
            "pages_in_use": in_use,
            "pages_free": max(0, pool - in_use),
        },
        "forecast": {},
        "sketch": {"v": BOOK_V, "page_tokens": 0, "entries": []},
    }
    pager = getattr(prefill, "_pager", None)
    if pager is not None and getattr(pager, "page_tokens", None):
        book["sketch"] = sketch_from_pager(pager, CapacityConfig().sketch_k)
    return book


def stage_book(n_stages: int, backlog: int = 0) -> dict:
    """Minimal capacity book for a remote pipeline-stage worker
    (``comm/remote.RemoteStageServer``): which stages it holds and how
    deep its work backlog runs — enough for the fleet view to show the
    worker as a capacity source with first-class staleness."""
    return {
        "v": BOOK_V,
        "kind": "stage",
        "wall": time.time(),
        "health": "ok",
        "health_level": 0,
        "headroom": {"stages": int(n_stages), "backlog": int(backlog)},
        "forecast": {},
        "sketch": {"v": BOOK_V, "page_tokens": 0, "entries": []},
    }
