"""TTL-lease worker membership registry.

Counterpart of ``adapt_tpu/control/registry.py`` (the reference's etcd
control plane: workers own ``/workers/<ip>`` under a lease, the dispatcher
reads and watches the live pool). Membership is an in-process key space
with TTL leases, an expiry reaper and watch callbacks. The device-health
monitor of the JAX package (``DeviceHealthMonitor``) waits for the
multi-GPU slice.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections.abc import Callable

from adapt_tpu_torch.utils.logging import get_logger

log = get_logger("registry")


class WorkerRegistry:
    """KV membership with TTL leases, expiry reaper, and join/leave
    watches."""

    def __init__(self, default_ttl_s: float = 2.0, reap_period_s: float = 0.1):
        self._lock = threading.Lock()
        self._leases: dict[str, float] = {}  # worker_id -> expiry time
        self._meta: dict[str, dict] = {}
        # Lease ownership: each register() bumps the id's token, and a
        # holder passing its token to deregister() can only revoke its OWN
        # lease — a stale holder dying late cannot evict the replacement
        # that re-registered under the same id.
        self._tokens: dict[str, int] = {}
        self._token_counter = 0
        self._watchers: list[Callable[[str, str], None]] = []
        self._default_ttl = default_ttl_s
        self._reap_period = reap_period_s
        self._stop = threading.Event()
        self._reaper: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "WorkerRegistry":
        if self._reaper is None:
            self._reaper = threading.Thread(
                target=self._reap_loop, name="registry-reaper", daemon=True
            )
            self._reaper.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._reaper is not None:
            self._reaper.join(timeout=2.0)
            self._reaper = None

    # -- worker API ---------------------------------------------------------

    def register(self, worker_id: str, meta: dict | None = None,
                 ttl_s: float | None = None) -> int:
        """Create/renew a lease; returns an ownership token for
        :meth:`deregister` (the latest registration owns the id)."""
        with self._lock:
            fresh = worker_id not in self._leases
            self._leases[worker_id] = time.monotonic() + (
                ttl_s or self._default_ttl)
            self._meta[worker_id] = dict(meta or {})
            self._token_counter += 1
            token = self._token_counter
            self._tokens[worker_id] = token
            watchers = list(self._watchers) if fresh else []
        for cb in watchers:
            try:
                cb("join", worker_id)
            except Exception:  # noqa: BLE001 — a watcher bug must not
                log.exception("join watcher failed")  # break membership
        if fresh:
            log.info("worker joined: %s", worker_id)
        return token

    def heartbeat(self, worker_id: str, ttl_s: float | None = None) -> bool:
        """Renew a lease; False if it already expired (the worker must
        re-register)."""
        with self._lock:
            if worker_id not in self._leases:
                return False
            self._leases[worker_id] = time.monotonic() + (
                ttl_s or self._default_ttl)
            return True

    def deregister(self, worker_id: str, token: int | None = None) -> None:
        """Remove a lease. With ``token``, only if the caller still owns
        the id (checked under the lock that deletes)."""
        self._expire([worker_id], reason="deregister", token=token)

    # -- dispatcher API -----------------------------------------------------

    def alive(self, role: str | None = None) -> list[str]:
        """Live lease holders; ``role`` keeps those whose lease carries
        ``meta["role"] == role`` (None: every live lease)."""
        now = time.monotonic()
        with self._lock:
            return [w for w, exp in self._leases.items()
                    if exp > now
                    and (role is None or self._meta[w].get("role") == role)]

    def alive_meta(self) -> dict[str, dict]:
        """Every live lease's metadata in one lock hold (``{worker_id:
        meta copy}``): the telemetry store's scan for lease-advertised
        pull endpoints (``meta["telemetry"]``)."""
        now = time.monotonic()
        with self._lock:
            return {w: dict(self._meta[w])
                    for w, exp in self._leases.items() if exp > now}

    def alive_untagged(self) -> list[str]:
        """Live leases with no role tag: the pool the pipeline dispatcher
        acquires from."""
        now = time.monotonic()
        with self._lock:
            return [w for w, exp in self._leases.items()
                    if exp > now and self._meta[w].get("role") is None]

    def watch(self, callback: Callable[[str, str], None]) -> None:
        """callback(event, worker_id) with event in {'join', 'leave'}."""
        with self._lock:
            self._watchers.append(callback)

    def wait_for_workers(self, n: int, timeout_s: float) -> bool:
        """Bounded startup wait."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if len(self.alive()) >= n:
                return True
            time.sleep(0.02)
        return len(self.alive()) >= n

    # -- internals ----------------------------------------------------------

    def _expire(self, worker_ids: list[str], reason: str,
                token: int | None = None) -> None:
        fired = []
        with self._lock:
            for w in worker_ids:
                if token is not None and self._tokens.get(w) != token:
                    continue  # superseded holder: the id is not ours to kill
                if w in self._leases:
                    del self._leases[w]
                    self._meta.pop(w, None)
                    self._tokens.pop(w, None)
                    fired.append(w)
            watchers = list(self._watchers)
        for w in fired:
            log.info("worker left (%s): %s", reason, w)
            for cb in watchers:
                try:
                    cb("leave", w)
                except Exception:  # noqa: BLE001
                    log.exception("leave watcher failed")

    def _reap_loop(self) -> None:
        while not self._stop.wait(self._reap_period):
            now = time.monotonic()
            with self._lock:
                dead = [w for w, exp in self._leases.items() if exp <= now]
            if dead:
                self._expire(dead, reason="lease expired")


def weak_watch(watchable, obj, method_name: str) -> None:
    """Subscribe ``obj.<method_name>(event, key)`` to ``watchable.watch``
    WEAKLY: watcher lists have no unwatch and outlive subscribers, so a
    bound method there would pin a retired subscriber forever. The shim
    no-ops once ``obj`` is collected or sets ``_retired``."""
    wr = weakref.ref(obj)

    def _cb(event: str, key: str, _wr=wr) -> None:
        o = _wr()
        if o is not None and not getattr(o, "_retired", False):
            getattr(o, method_name)(event, key)

    watchable.watch(_cb)
