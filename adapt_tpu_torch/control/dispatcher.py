"""Adaptive dispatcher: the hub-and-spoke control loop.

Counterpart of ``adapt_tpu/control/dispatcher.py``'s hub path: registry
watch callbacks (the reference's ``_worker_monitor``), late binding of
stages to live workers (``_acquire`` + a bounded configure handshake), the
result loop every worker posts to (forward to the next stage or complete
the request), the deadline watchdog with strikes, quarantine and canary
probes, and exactly-once completion under re-dispatch (requests carry ids
and attempt counters, so a late result from a presumed-dead attempt is
dropped).

Stage programs: the JAX dispatcher shares one jitted function per stage
and prewarms its executables on every device, so a failover re-bind is a
weight move and never a compile. Here a worker's binding is a stage module
of its own (``graph.partition.StageModule``); building one is the port's
"compile". :meth:`Dispatcher.prewarm_executables` builds, for every stage
and live worker, a module on the meta device (no device memory) for a
later configure to take, so a failover configure only moves weights; every
build is counted in :attr:`Dispatcher.stage_builds` (and the
``dispatcher.stage_builds`` counter).

Remote workers (``comm.remote.RemoteWorkerProxy``) join the same pool:
they build their own stage modules, so no module is built here for them.
Over remote workers the dispatcher also offers chain forwarding
(:meth:`Dispatcher.setup_chain`: stage outputs hop worker to worker, only
the tail's result returns, and any chain failure falls back to the hub
and replays the request from its retained input) and crash recovery from
a write-ahead journal (``journal=``, :meth:`Dispatcher.recover`: the
journaled dial-out workers are re-adopted and every accepted request that
never completed is replayed exactly once).
"""

from __future__ import annotations

import itertools
import os
import queue
import random
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any

from adapt_tpu_torch.config import ObservabilityConfig, ServeConfig
from adapt_tpu_torch.control.registry import WorkerRegistry
from adapt_tpu_torch.control.worker import (
    PING_STAGE,
    StageWorker,
    Task,
    TaskResult,
    WorkerState,
)
from adapt_tpu_torch.graph.partition import PartitionPlan, StageModule
from adapt_tpu_torch.utils.logging import get_logger
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.tracing import global_flight_recorder, global_tracer

log = get_logger("dispatcher")


class RequestFailed(RuntimeError):
    """A request exhausted its retries (or no workers remain)."""


class PipelineFuture:
    """Completion handle for one submitted request."""

    def __init__(self, request_id: int):
        self.request_id = request_id
        self.submit_time = time.monotonic()
        self._event = threading.Event()
        self._value: Any = None
        self._error: str | None = None

    def _complete(self, value: Any = None, error: str | None = None) -> bool:
        if self._event.is_set():
            return False  # exactly-once: late duplicates dropped
        self._value, self._error = value, error
        self._event.set()
        return True

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not done within {timeout}s")
        if self._error is not None:
            raise RequestFailed(self._error)
        return self._value


@dataclass
class _Inflight:
    """One in-flight stage task, with its payload kept for re-sending."""

    request_id: int
    stage_index: int
    attempt: int
    payload: Any
    worker_id: str
    start_time: float
    retries: int = 0
    future: PipelineFuture = field(default=None)  # type: ignore[assignment]
    #: Workers that already failed or stalled this request: a re-dispatch
    #: excludes all of them, not only the latest.
    tried: set[str] = field(default_factory=set)
    #: Chain mode: the stage whose result completes the request (None: hub
    #: routing). A chain entry keeps the request's stage-0 input, so any
    #: chain failure replays it end to end through the hub.
    final_stage: int | None = None


class Dispatcher:
    """Hub dispatcher over in-process stage workers."""

    def __init__(self, plan: PartitionPlan, variables=None,
                 registry: WorkerRegistry | None = None,
                 config: ServeConfig | None = None, journal=None):
        """``variables``: ``{node: state dict}`` of the plan's graph (None:
        the graph's own weights), kept on the host per stage for every
        configure. ``journal``: a ``control.journal.DispatcherJournal``:
        accepted requests and the dial-out worker table survive a crash of
        this process, and :meth:`recover` rebuilds a dispatcher from them
        (one host fetch and fsync per submit)."""
        self.plan = plan
        self._journal = journal
        self.config = config or ServeConfig()
        # Observability knobs onto the process-global tracer / recorder:
        # tracing is enable-only, and a default capacity never clobbers a
        # ring another component sized.
        obs = self.config.obs
        if obs.trace_enabled:
            global_tracer().enabled = True
        defaults = ObservabilityConfig()
        if obs.trace_capacity != defaults.trace_capacity:
            global_tracer().set_capacity(obs.trace_capacity)
        if obs.flight_capacity != defaults.flight_capacity:
            global_flight_recorder().set_capacity(obs.flight_capacity)
        self.registry = registry or WorkerRegistry(
            default_ttl_s=self.config.fault.lease_ttl_s)
        self._stage_host_vars = plan.extract_variables(variables)
        # Stage modules built ahead of a configure (prewarm), per (stage,
        # worker id), on the meta device.
        self._shells: dict[tuple[int, str], StageModule] = {}
        self._shell_lock = threading.Lock()
        self._stage_builds = 0
        # Configures in progress per (stage, worker id): a second configure
        # of the same pair waits for the first instead of building and
        # copying the same stage again.
        self._configuring: dict[tuple[int, str], threading.Event] = {}
        self._workers: dict[str, StageWorker] = {}
        self._workers_lock = threading.Lock()
        self.result_queue: queue.Queue[TaskResult] = queue.Queue()
        self._inflight: dict[int, _Inflight] = {}
        self._inflight_lock = threading.Lock()
        self._sem = threading.Semaphore(self.config.max_inflight)
        # Over an existing journal, start past every id it holds: a
        # recycled id would clear a crashed request's pending mark.
        self._req_ids = itertools.count(
            journal.next_request_id if journal is not None else 0)
        self._watchdog_paused = False
        # Strike-based quarantine: a worker that keeps missing deadlines
        # while heartbeating (a hang) is never evicted by lease expiry;
        # after `quarantine_strikes` misses the scheduler stops acquiring
        # it except as a last resort. Once rank demotes a struck worker,
        # strikes accrue from canary probes (PING_STAGE) sent to silent
        # workers; an answered probe forgives probe strikes (and, under
        # quarantine, decays one real-task strike), so a recovered worker
        # returns. _health_lock guards the maps below (result loop,
        # watchdog and forward pool touch them concurrently).
        self._health_lock = threading.Lock()
        self._strikes: dict[str, int] = {}
        self._probe_strikes: dict[str, int] = {}
        self._quarantined: set[str] = set()
        self._last_ok: dict[str, float] = {}
        self._probes: dict[str, tuple[int, float]] = {}
        # Only the newest probe's answer earns forgiveness, so a hung
        # worker's backlog of pings cannot replay as a burst on revive.
        self._last_probe_id: dict[str, int] = {}
        self._probe_ids = itertools.count(-2, -1)  # never a request id
        self._boot_time = time.monotonic()
        # One RNG per thread for the tie-break shuffle.
        self._tls = threading.local()
        self._rng_seeds = itertools.count(0x5EED)
        # Forward / re-dispatch pool: _acquire can block on a configure,
        # which must never stall the result loop or the registry reaper.
        self._forward_pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="dispatcher-forward")
        self._shutdown = threading.Event()
        self._threads: list[threading.Thread] = []
        self._started = False
        #: Chain forwarding: worker ids in stage order (None: hub routing).
        self._chain: list[str] | None = None
        self._chain_lock = threading.Lock()

    @property
    def stage_builds(self) -> int:
        """Stage modules this dispatcher has built (prewarm shells and
        configures that found none). A failover after :meth:`warmup` builds
        none: it only moves weights."""
        with self._shell_lock:
            return self._stage_builds

    def _build_stage(self, stage_index: int) -> StageModule:
        module = self.plan.build_stage(self.plan.stages[stage_index], "meta")
        with self._shell_lock:
            self._stage_builds += 1
        global_metrics().inc("dispatcher.stage_builds")
        return module

    def _take_module(self, stage_index: int, worker_id: str) -> StageModule:
        with self._shell_lock:
            shell = self._shells.pop((stage_index, worker_id), None)
        return shell if shell is not None else self._build_stage(stage_index)

    # -- worker pool --------------------------------------------------------

    def spawn_workers(self, devices) -> list[StageWorker]:
        """One in-process worker per entry of ``devices`` (a device may
        appear several times: several workers on one card)."""
        workers = []
        for i, dev in enumerate(devices):
            w = StageWorker(worker_id=f"worker-{i}", device=dev,
                            registry=self.registry,
                            result_queue=self.result_queue,
                            fault=self.config.fault)
            self.attach_worker(w)
            workers.append(w)
        return workers

    def attach_worker(self, worker: StageWorker) -> None:
        with self._workers_lock:
            self._workers[worker.worker_id] = worker
        # A remote worker with a listen address outlives this process and
        # can be re-adopted: journal its address and configure recipe.
        # In-process workers die with this process.
        addr = getattr(worker, "chain_address", None)
        if self._journal is not None and addr is not None:
            self._journal.record_worker(
                worker.worker_id, addr[0], addr[1],
                meta={"model_config": worker._model_config,
                      "codec": worker._codec_name,
                      "weights_codec": worker._wcodec.name})

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Dispatcher":
        if self._started:
            return self
        self.registry.start()
        with self._workers_lock:
            workers = list(self._workers.values())
        for w in workers:
            w.start()
        if not self.registry.wait_for_workers(
                1, self.config.fault.startup_wait_s):
            self.shutdown()
            raise RequestFailed(
                f"no workers registered within "
                f"{self.config.fault.startup_wait_s}s")
        self.registry.watch(self._on_membership)
        for name, target in (("results", self._result_loop),
                             ("watchdog", self._watchdog_loop)):
            t = threading.Thread(target=target, name=f"dispatcher-{name}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        self._started = True
        return self

    def hard_stop(self) -> None:
        """Crash simulation: abandon everything NOW — no draining, no
        future completion, no journal marks, no deregistration. Remote
        worker processes keep running; :meth:`recover` is the other
        half."""
        # Detach the journal first: threads failing on the closed links
        # must not write done marks a real crash could not write.
        self._journal = None
        self._shutdown.set()
        self.result_queue.put(None)  # type: ignore[arg-type]
        with self._workers_lock:
            workers = list(self._workers.values())
        for w in workers:
            sock = getattr(w, "_sock", None)  # a remote worker's link
            if sock is not None:
                for end in (lambda: sock.shutdown(socket.SHUT_RDWR),
                            sock.close):
                    try:
                        end()
                    except OSError:
                        pass
        self._forward_pool.shutdown(wait=False, cancel_futures=True)
        self.registry.stop()

    @classmethod
    def recover(cls, plan: PartitionPlan, variables, journal,
                config: ServeConfig | None = None, result_device=None,
                ) -> tuple["Dispatcher", dict[int, PipelineFuture]]:
        """Rebuild a serving dispatcher from a crashed one's journal:
        re-adopt every journaled worker whose server still answers (the
        unreachable are pruned from the journal), seed the request ids past
        every journaled one and replay each request that was accepted and
        never completed. Returns ``(dispatcher, {request id: future})`` for
        the replayed requests, each completing exactly once.
        ``result_device``: where the re-adopted proxies dequantize
        ``int8dev`` results. Weights come from ``plan`` / ``variables``;
        the journal holds control-plane state only."""
        from adapt_tpu_torch.comm.remote import RemoteWorkerProxy

        workers, pending, _ = journal.load()
        disp = cls(plan, variables, config=config, journal=journal)
        proxies = []
        for worker_id, info in workers.items():
            meta = info.get("meta", {})
            proxies.append(RemoteWorkerProxy(
                worker_id, (info["host"], info["port"]), disp.registry,
                disp.result_queue, model_config=meta.get("model_config", {}),
                codec_name=meta.get("codec", "none"),
                weights_codec=meta.get("weights_codec", "lz"),
                fault=disp.config.fault, result_device=result_device))
        if not proxies:
            raise RequestFailed(
                "journal holds no re-adoptable workers; nothing to recover")

        def _dial(proxy):
            try:
                return proxy, proxy.start(), None
            except Exception as e:  # noqa: BLE001
                return proxy, None, e

        alive = []
        with ThreadPoolExecutor(max_workers=min(16, len(proxies)),
                                thread_name_prefix="recover-dial") as pool:
            for proxy, started, err in pool.map(_dial, proxies):
                if err is not None:
                    log.warning("recovery: worker %s at %s not re-adoptable "
                                "(%s); pruned from the journal",
                                proxy.worker_id, proxy.address, err)
                    journal.forget_worker(proxy.worker_id)
                    continue
                with disp._workers_lock:
                    disp._workers[proxy.worker_id] = started
                alive.append(started)
        if not alive:
            raise RequestFailed(
                "no journaled worker answered; cannot recover the pool")
        disp.start()
        futures: dict[int, PipelineFuture] = {}
        for rid, payload in pending.items():
            disp._sem.acquire()
            futures[rid] = future = PipelineFuture(rid)
            try:
                disp._dispatch(rid, 0, payload, future, attempt=0, retries=0)
            except Exception as e:  # noqa: BLE001
                disp._finish(future, error=str(e))
        log.info("recovered: %d workers re-adopted, %d requests replayed",
                 len(alive), len(futures))
        global_metrics().inc("dispatcher.recovered")
        recorder = global_flight_recorder()
        recorder.record("recovery", workers=len(alive), replayed=len(futures))
        if disp.config.obs.snapshot_on_recovery:
            # The fault timeline before the crash, beside the journal.
            try:
                recorder.snapshot_to(os.path.join(
                    journal.root, f"flight-{int(time.time())}.json"))
            except Exception as e:  # noqa: BLE001 — best effort
                log.warning("flight-recorder snapshot failed: %s", e)
        return disp, futures

    # -- chain forwarding ---------------------------------------------------

    def setup_chain(self, worker_ids: list[str] | None = None) -> list[str]:
        """Direct worker-to-worker forwarding for a static healthy pool of
        remote workers: stage i's output hops straight to stage i + 1's
        worker and only the tail's result returns to the hub. The hub keeps
        the control plane (probes, deadlines, exactly-once, re-dispatch);
        any chain failure disables the chain and replays the request end
        to end through the hub. ``worker_ids``: one per stage, in stage
        order (default: the workers with a listen address, in attach
        order); every member past the head needs a listen address."""
        with self._workers_lock:
            pool = {wid: w for wid, w in self._workers.items()
                    if w.state is not WorkerState.DEAD}
        if worker_ids is None:
            worker_ids = [wid for wid, w in pool.items()
                          if getattr(w, "chain_address", None) is not None
                          ][:self.plan.num_stages]
        if len(worker_ids) != self.plan.num_stages:
            raise ValueError(f"chain needs exactly {self.plan.num_stages} "
                             f"workers (one per stage), got "
                             f"{len(worker_ids)}")
        workers = []
        for i, wid in enumerate(worker_ids):
            w = pool.get(wid)
            if w is None:
                raise ValueError(f"worker {wid!r} is not in the live pool")
            if not hasattr(w, "send_route"):
                raise TypeError(
                    f"worker {wid!r} cannot chain (in-process workers share "
                    "the hub's memory; chaining is a cross-process "
                    "topology)")
            if i > 0 and w.chain_address is None:
                raise ValueError(f"worker {wid!r} has no listen address for "
                                 "its predecessor to dial")
            workers.append(w)
        for i, w in enumerate(workers):
            if not w.is_configured(i):
                self._configure_with_timeout(w, i)
        # Tail first: no hop forwards into a worker without its route.
        for i in reversed(range(len(workers))):
            nxt = workers[i + 1].chain_address if i + 1 < len(workers) else None
            workers[i].send_route(i, nxt, i + 1 if nxt else -1)
        with self._chain_lock:
            self._chain = list(worker_ids)
        log.info("chain forwarding enabled: %s", " -> ".join(worker_ids))
        global_metrics().inc("dispatcher.chain_enabled")
        return list(worker_ids)

    def disable_chain(self, reason: str = "requested") -> None:
        """Back to hub routing. Route clears are best effort: hub traffic
        is plain MSG_DATA, which ignores any stale route."""
        with self._chain_lock:
            chain, self._chain = self._chain, None
        if chain is None:
            return
        log.warning("chain forwarding disabled (%s); hub routing resumes",
                    reason)
        global_metrics().inc("dispatcher.chain_disabled")
        global_flight_recorder().record("chain_disabled", reason=reason)
        with self._workers_lock:
            pool = dict(self._workers)

        def _clear(stage: int, worker) -> None:
            try:
                worker.send_route(stage, None, clear=True)
            except Exception:  # noqa: BLE001 — the link may be down
                pass

        for i, wid in enumerate(chain):
            w = pool.get(wid)
            if w is not None and hasattr(w, "send_route"):
                try:
                    self._forward_pool.submit(_clear, i, w)
                except RuntimeError:  # pool shut down
                    break

    def shutdown(self) -> None:
        self._shutdown.set()
        self.result_queue.put(None)  # type: ignore[arg-type]
        for t in self._threads:
            t.join(timeout=2.0)
        # Fail outstanding futures promptly instead of letting callers
        # sleep out their timeouts.
        self._forward_pool.shutdown(wait=False, cancel_futures=True)
        with self._inflight_lock:
            abandoned = list(self._inflight.values())
            self._inflight.clear()
        for e in abandoned:
            self._finish(e.future, error="dispatcher shut down")
        with self._workers_lock:
            workers = list(self._workers.values())
        for w in workers:
            w.stop()
        self.registry.stop()
        if self._journal is not None:
            self._journal.close()

    # -- request API --------------------------------------------------------

    def submit(self, x) -> PipelineFuture:
        """Enqueue one request, bounded by the ``max_inflight``
        semaphore."""
        if self._shutdown.is_set():
            raise RequestFailed("dispatcher is shut down")
        self._sem.acquire()
        request_id = next(self._req_ids)
        future = PipelineFuture(request_id)
        if self._journal is not None:
            # Write-ahead, before dispatch: a submit the journal cannot
            # record is refused, not silently volatile.
            try:
                self._journal.record_submit(request_id, x)
            except Exception as e:
                self._sem.release()
                raise RequestFailed(f"journal write failed: {e}") from e
        try:
            self._dispatch(request_id, 0, x, future, attempt=0, retries=0)
        except Exception as e:  # no worker at all -> fail fast
            self._finish(future, error=str(e))
        return future

    def infer(self, x, timeout: float | None = 60.0) -> Any:
        return self.submit(x).result(timeout)

    def warmup(self, example, timeout: float | None = 300.0) -> None:
        """Run one request end to end with the watchdog paused (first
        calls pay one-time costs: cuDNN / cuBLAS handles, kernel builds),
        then build every (stage, worker) module a failover could need."""
        self._watchdog_paused = True
        try:
            self.infer(example, timeout)
            self.prewarm_executables()
        finally:
            self._watchdog_paused = False

    def prewarm_executables(self) -> None:
        """Build a stage module on the meta device for every (stage, live
        worker) pair that has neither a binding nor such a module yet, for
        a later configure to take: a failover then moves weights and builds
        nothing. Meta modules hold no device memory. Remote workers build
        their own."""
        if self._shutdown.is_set():
            return
        with self._workers_lock:
            workers = [w for w in self._workers.values()
                       if w.state is not WorkerState.DEAD
                       and getattr(w, "device", None) is not None]
        for w in workers:
            for stage_index in range(self.plan.num_stages):
                key = (stage_index, w.worker_id)
                with self._shell_lock:
                    if key in self._shells:
                        continue
                if w.is_configured(stage_index):
                    continue
                module = self._build_stage(stage_index)
                with self._shell_lock:
                    self._shells.setdefault(key, module)
                global_metrics().inc("dispatcher.prewarmed")

    def serve_stream(self, inputs, timeout_per_request: float = 120.0):
        """Pump a stream through the pipeline, preserving order."""
        futures = [self.submit(x) for x in inputs]
        return [f.result(timeout_per_request) for f in futures]

    def metrics_snapshot(self) -> dict:
        return global_metrics().snapshot()

    # -- scheduling ---------------------------------------------------------

    def _acquire(self, stage_index: int, exclude: set[str]) -> StageWorker:
        """Late binding: pick a live worker for this stage *now*.
        Preference: already-configured idle > idle > shallowest queue;
        excluded (suspect) workers only as a last resort."""
        alive = set(self.registry.alive_untagged())
        with self._workers_lock:
            pool = [w for wid, w in self._workers.items()
                    if wid in alive and w.state is not WorkerState.DEAD]
        if not pool:
            raise RequestFailed("no live workers")
        with self._health_lock:
            strikes = dict(self._strikes)
            quarantined = set(self._quarantined)
        # Healthy & untried > quarantined & untried > anyone.
        healthy = [w for w in pool if w.worker_id not in quarantined]
        candidates = (
            [w for w in healthy if w.worker_id not in exclude]
            or [w for w in pool if w.worker_id not in exclude]
            or healthy
            or pool
        )

        def rank(w: StageWorker):
            return (
                # Any missed deadline demotes a worker: a hung worker looks
                # idle and configured, the most attractive rank.
                1 if strikes.get(w.worker_id, 0) else 0,
                0 if w.is_configured(stage_index) else 1,
                0 if w.state is WorkerState.IDLE else 1,
                w.queue_depth,
            )

        # Random tie-break: concurrent re-dispatch waves scatter over
        # equal-rank candidates instead of herding onto one.
        self._shuffle(candidates)
        last_error: Exception | None = None
        for worker in sorted(candidates, key=rank):
            if worker.is_configured(stage_index):
                return worker
            try:
                self._configure_with_timeout(worker, stage_index)
                return worker
            except Exception as e:  # noqa: BLE001 — try the next candidate
                log.warning("configure of stage %d on %s failed: %s",
                            stage_index, worker.worker_id, e)
                last_error = e
        raise RequestFailed(
            f"no worker could be configured for stage {stage_index}: "
            f"{last_error}")

    def _shuffle(self, seq: list) -> None:
        rng = getattr(self._tls, "rng", None)
        if rng is None:
            rng = self._tls.rng = random.Random(next(self._rng_seeds))
        rng.shuffle(seq)

    def _configure_with_timeout(self, worker: StageWorker,
                                stage_index: int) -> None:
        """Bounded configure handshake. On timeout the worker thread is
        abandoned and *cancelled*: its ``abort`` token is checked just
        before the binding is installed, so a timed-out configure never
        installs state (or holds weight memory) after this dispatcher
        reported it failed."""
        key = (stage_index, worker.worker_id)
        timeout = self.config.fault.configure_timeout_s
        with self._shell_lock:
            done = self._configuring.get(key)
            leader = done is None
            if leader:
                if worker.is_configured(stage_index):
                    return  # installed while this caller was choosing
                done = self._configuring[key] = threading.Event()
        if not leader:
            if not (done.wait(timeout) and worker.is_configured(stage_index)):
                raise RequestFailed(
                    f"concurrent configure of stage {stage_index} on "
                    f"{worker.worker_id} did not install it")
            return
        abandoned = threading.Event()
        errors: list[Exception] = []
        # A remote worker builds its own module from the recipe.
        module = (self._take_module(stage_index, worker.worker_id)
                  if getattr(worker, "device", None) is not None else None)

        def _cfg():
            try:
                gen = worker.configure(
                    stage_index, module, self._stage_host_vars[stage_index],
                    spec=self.plan.stages[stage_index],
                    abort=abandoned.is_set)
                if abandoned.is_set():
                    # The install won the race with the timeout by a hair:
                    # undo it (generation-scoped: a newer binding stays).
                    worker.unconfigure(stage_index, gen)
            except Exception as e:  # noqa: BLE001
                errors.append(e)
            finally:
                with self._shell_lock:
                    del self._configuring[key]
                done.set()

        t = threading.Thread(target=_cfg, daemon=True)
        t.start()
        if not done.wait(timeout):
            abandoned.set()
            raise RequestFailed(
                f"configure of stage {stage_index} on {worker.worker_id} "
                f"timed out after {self.config.fault.configure_timeout_s}s")
        if errors:
            raise errors[0]

    def _dispatch(self, request_id: int, stage_index: int, payload,
                  future: PipelineFuture, attempt: int, retries: int,
                  exclude: set[str] | None = None) -> None:
        exclude = exclude or set()
        with self._chain_lock:
            chain = self._chain
        if chain is not None and stage_index == 0 and not retries \
                and not exclude:
            # Chain fast path: one submit to the head; the result arrives
            # on the tail's link. Retries never take it.
            with self._workers_lock:
                head = self._workers.get(chain[0])
            if head is not None and head.state is not WorkerState.DEAD:
                entry = _Inflight(
                    request_id=request_id, stage_index=0, attempt=attempt,
                    payload=payload, worker_id=head.worker_id,
                    start_time=time.monotonic(), retries=retries,
                    future=future, tried={head.worker_id},
                    final_stage=self.plan.num_stages - 1)
                with self._inflight_lock:
                    self._inflight[request_id] = entry
                try:
                    head.submit(Task(request_id=request_id, stage_index=0,
                                     attempt=attempt, payload=payload,
                                     chained=True))
                except Exception as e:  # noqa: BLE001 — the link died
                    with self._inflight_lock:
                        self._inflight.pop(request_id, None)
                    self.disable_chain(f"chain head submit failed: {e}")
                else:
                    global_metrics().inc("dispatcher.tasks_sent")
                    global_metrics().inc("dispatcher.chain_dispatched")
                    return
            else:
                self.disable_chain("chain head worker gone")
        worker = self._acquire(stage_index, exclude)
        entry = _Inflight(
            request_id=request_id, stage_index=stage_index, attempt=attempt,
            payload=payload, worker_id=worker.worker_id,
            start_time=time.monotonic(), retries=retries, future=future,
            tried=exclude | {worker.worker_id})
        with self._inflight_lock:
            self._inflight[request_id] = entry
        try:
            worker.submit(Task(request_id=request_id, stage_index=stage_index,
                               attempt=attempt, payload=payload))
        except Exception as e:  # noqa: BLE001 — a remote link died under us
            # The request is not lost with the link: whoever takes the
            # entry out of the in-flight table re-dispatches it, this
            # thread or the membership handler the dropped link fired.
            with self._inflight_lock:
                ours = self._inflight.get(request_id) is entry
                if ours:
                    del self._inflight[request_id]
            if ours:
                self._redispatch(entry, f"submit to {worker.worker_id} "
                                        f"failed: {e}")
            return
        global_metrics().inc("dispatcher.tasks_sent")

    def _forward(self, result: TaskResult, entry: _Inflight,
                 next_stage: int) -> None:
        """Forward a stage output to the next stage (on the forward pool:
        _acquire may block on a configure)."""
        try:
            self._dispatch(result.request_id, next_stage, result.output,
                           entry.future, attempt=0, retries=0)
        except Exception as e:  # noqa: BLE001
            self._finish(entry.future, error=str(e))

    def _redispatch(self, entry: _Inflight, reason: str) -> None:
        """Watchdog / failure path: re-send the kept payload to a worker
        that has not tried it yet. A chain entry replays its stage-0 input
        through the hub, the chain disabled first."""
        if entry.final_stage is not None:
            self.disable_chain(f"chain request replay: {reason}")
        if entry.retries + 1 > self.config.fault.max_retries:
            with self._inflight_lock:
                self._inflight.pop(entry.request_id, None)
            global_flight_recorder().record(
                "request_failed", request=entry.request_id,
                stage=entry.stage_index, retries=entry.retries, reason=reason)
            self._finish(entry.future, error=(
                f"request {entry.request_id} stage {entry.stage_index} "
                f"failed after {entry.retries} retries ({reason})"))
            return
        global_metrics().inc("dispatcher.redispatched")
        global_flight_recorder().record(
            "redispatch", request=entry.request_id, stage=entry.stage_index,
            attempt=entry.attempt + 1, worker=entry.worker_id, reason=reason)
        log.warning("re-dispatching request %d stage %d (%s), attempt %d",
                    entry.request_id, entry.stage_index, reason,
                    entry.attempt + 1)
        try:
            self._dispatch(entry.request_id, entry.stage_index,
                           entry.payload, entry.future,
                           attempt=entry.attempt + 1,
                           retries=entry.retries + 1, exclude=entry.tried)
        except Exception as e:
            with self._inflight_lock:
                self._inflight.pop(entry.request_id, None)
            self._finish(entry.future, error=str(e))

    def _finish(self, future: PipelineFuture, value=None, error=None) -> None:
        if not future._complete(value, error):
            return
        journal = self._journal
        if journal is not None:
            # Terminal either way: replay is for requests that never
            # completed. A crash before this mark replays it once.
            try:
                journal.record_done(future.request_id)
            except Exception:  # noqa: BLE001 — worst case: one replay
                log.warning("journal done-mark failed for request %d",
                            future.request_id)
        self._sem.release()
        global_metrics().inc("dispatcher.completed" if error is None
                             else "dispatcher.failed")
        latency = time.monotonic() - future.submit_time
        if error is None:
            global_metrics().observe("request.latency_s", latency)
        tracer = global_tracer()
        if tracer.enabled:
            end = tracer.now()
            tracer.add_span("request", start=end - latency, end=end,
                            request=future.request_id, ok=error is None)

    # -- loops --------------------------------------------------------------

    def _on_probe_answer(self, result: TaskResult) -> None:
        """A canary answer: the exec loop drains again. Forgives probe-miss
        strikes (not real-task ones), decays one real strike under
        quarantine, and lifts quarantine when what remains is below the
        threshold. Ignored if the worker left membership since."""
        wid = result.worker_id
        if wid not in self.registry.alive():
            global_metrics().inc("dispatcher.probes_ignored")
            return
        threshold = self.config.fault.quarantine_strikes
        with self._health_lock:
            self._last_ok[wid] = time.monotonic()
            if result.request_id == self._last_probe_id.get(wid):
                self._probes.pop(wid, None)
                forgiven = self._probe_strikes.pop(wid, 0)
                remaining = max(self._strikes.get(wid, 0) - forgiven, 0)
                if wid in self._quarantined and remaining >= threshold:
                    remaining -= 1
                if remaining > 0:
                    self._strikes[wid] = remaining
                else:
                    self._strikes.pop(wid, None)
                if remaining < threshold:
                    self._quarantined.discard(wid)
        global_metrics().inc("dispatcher.probes_ok")

    def _result_loop(self) -> None:
        """Every stage output returns here: forward it to the next stage
        or complete the request."""
        while not self._shutdown.is_set():
            result = self.result_queue.get()
            if result is None:
                break
            if result.stage_index < 0:
                self._on_probe_answer(result)
                continue
            with self._inflight_lock:
                entry = self._inflight.get(result.request_id)
                if entry is not None and entry.final_stage is not None:
                    # Chain entry: success comes from the tail, an error
                    # from any hop.
                    matches = entry.attempt == result.attempt and (
                        result.error is not None
                        or result.stage_index == entry.final_stage)
                else:
                    matches = (entry is not None
                               and entry.stage_index == result.stage_index
                               and entry.attempt == result.attempt)
                if not matches:
                    # A stale duplicate (late completion after re-dispatch).
                    global_metrics().inc("dispatcher.stale_results")
                    continue
                del self._inflight[result.request_id]
            if result.error is not None:
                if entry.final_stage is not None:
                    self.disable_chain(f"chain error at stage "
                                       f"{result.stage_index}: {result.error}")
                self._forward_pool.submit(self._redispatch, entry,
                                          f"error: {result.error}")
                continue
            # A timely result clears the worker's strikes and refreshes its
            # liveness evidence (which defers the watchdog's probes).
            with self._health_lock:
                self._last_ok[result.worker_id] = time.monotonic()
                self._probe_strikes.pop(result.worker_id, None)
                if self._strikes.pop(result.worker_id, None) is not None:
                    self._quarantined.discard(result.worker_id)
            next_stage = result.stage_index + 1
            if next_stage < self.plan.num_stages:
                self._forward_pool.submit(self._forward, result, entry,
                                          next_stage)
            else:
                self._finish(entry.future, value=result.output)
            stage_latency = time.monotonic() - entry.start_time
            global_metrics().observe(f"stage{result.stage_index}.latency_s",
                                     stage_latency)
            tracer = global_tracer()
            if tracer.enabled:
                end = tracer.now()
                tracer.add_span(
                    "dispatch.stage_rtt", start=end - stage_latency, end=end,
                    request=result.request_id, attempt=result.attempt,
                    stage=result.stage_index, worker=result.worker_id)

    def _add_strike_locked(self, worker_id: str,
                           from_probe: bool = False) -> bool:
        """Record one missed deadline (caller holds ``_health_lock``);
        True when this strike crosses the quarantine threshold."""
        strikes = self._strikes.get(worker_id, 0) + 1
        self._strikes[worker_id] = strikes
        if from_probe:
            self._probe_strikes[worker_id] = (
                self._probe_strikes.get(worker_id, 0) + 1)
        newly = (strikes >= self.config.fault.quarantine_strikes
                 and worker_id not in self._quarantined)
        if newly:
            self._quarantined.add(worker_id)
        return newly

    def _quarantine_drain(self, worker_id: str, why: str) -> None:
        """A just-quarantined worker's other in-flight tasks are almost
        certainly doomed too: re-dispatch them now."""
        global_metrics().inc("dispatcher.quarantined")
        global_flight_recorder().record("quarantine", worker=worker_id,
                                        why=why)
        log.warning("worker %s quarantined (%s)", worker_id, why)
        with self._inflight_lock:
            doomed = [e for e in self._inflight.values()
                      if e.worker_id == worker_id]
            for e in doomed:
                del self._inflight[e.request_id]
        for e in doomed:
            self._forward_pool.submit(self._redispatch, e,
                                      "co-resident with quarantine")

    def _add_strike(self, worker_id: str, why: str) -> None:
        with self._health_lock:
            newly = self._add_strike_locked(worker_id)
        if newly:
            self._quarantine_drain(worker_id, why)

    def _probe_silent_workers(self, now: float, deadline: float) -> None:
        """Canary probes: a hung worker heartbeats and, once struck, is
        rank-demoted, so probes are how further strikes accrue and
        quarantine stays reachable."""
        silence = self.config.fault.probe_silence_s
        if silence is None:
            silence = self.config.fault.task_deadline_s
        # Overdue probes cost a strike each; detection and strike are one
        # critical section, so a racing answer lands before or after.
        with self._health_lock:
            missed = [wid for wid, (_, sent) in self._probes.items()
                      if now - sent > deadline]
            quarantine_now = []
            for wid in missed:
                del self._probes[wid]
                if self._add_strike_locked(wid, from_probe=True):
                    quarantine_now.append(wid)
        for wid in missed:
            global_metrics().inc("dispatcher.probes_missed")
            global_flight_recorder().record("probe_miss", worker=wid)
        for wid in quarantine_now:
            self._quarantine_drain(wid, "probe missed")
        alive = set(self.registry.alive())
        with self._workers_lock:
            pool = [w for wid, w in self._workers.items()
                    if wid in alive and w.state is not WorkerState.DEAD]
        for w in pool:
            with self._health_lock:
                if w.worker_id in self._probes:
                    continue
                last = self._last_ok.get(w.worker_id, self._boot_time)
                if now - last <= silence:
                    continue
                if w.worker_id not in self.registry.alive():
                    # Evicted since the snapshot: inserting now would
                    # resurrect health state the leave just cleared.
                    continue
                pid = next(self._probe_ids)
                self._probes[w.worker_id] = (pid, now)
                self._last_probe_id[w.worker_id] = pid
            w.submit(Task(request_id=pid, stage_index=PING_STAGE, attempt=0,
                          payload=None))
            global_metrics().inc("dispatcher.probes_sent")

    def _watchdog_loop(self) -> None:
        """Deadline scan over the in-flight tasks (the reference's
        ``_task_watchdog``), plus canary probing of silent workers."""
        period = self.config.fault.watchdog_period_s
        deadline = self.config.fault.task_deadline_s
        while not self._shutdown.wait(period):
            if self._watchdog_paused:
                continue
            # The one recovery mechanism for hangs must outlive any
            # per-iteration surprise: skip the tick, never die.
            try:
                now = time.monotonic()
                with self._inflight_lock:
                    # A chain entry spans the whole pipeline: its deadline
                    # scales with the stage count.
                    overdue = [e for e in self._inflight.values()
                               if now - e.start_time > deadline * (
                                   self.plan.num_stages
                                   if e.final_stage is not None else 1)]
                    for e in overdue:
                        del self._inflight[e.request_id]
                for entry in overdue:
                    if entry.final_stage is None:
                        # A chain stall may be at any hop: the probes find
                        # the hung worker, not a strike on the head.
                        self._add_strike(entry.worker_id,
                                         "task deadline exceeded")
                    self._forward_pool.submit(self._redispatch, entry,
                                              "deadline exceeded")
                self._probe_silent_workers(now, deadline)
            except Exception:  # noqa: BLE001
                log.exception("watchdog iteration failed; continuing")

    def _on_membership(self, event: str, worker_id: str) -> None:
        """On a worker's death re-dispatch its in-flight tasks at once
        (don't wait for deadlines); on a join, build its stage modules."""
        if event == "join":
            self.prewarm_executables()
            return
        if event != "leave":
            return
        global_flight_recorder().record("worker_leave", worker=worker_id)
        # A departed worker's record dies with it.
        with self._health_lock:
            for health in (self._strikes, self._probe_strikes, self._last_ok,
                           self._probes, self._last_probe_id):
                health.pop(worker_id, None)
            self._quarantined.discard(worker_id)
        with self._shell_lock:
            for key in [k for k in self._shells if k[1] == worker_id]:
                del self._shells[key]
        # A chain member's death breaks every in-flight chain request,
        # whatever hop each is at.
        with self._chain_lock:
            in_chain = self._chain is not None and worker_id in self._chain
        if in_chain:
            self.disable_chain(f"chain member {worker_id} left")
        with self._inflight_lock:
            orphaned = [e for e in self._inflight.values()
                        if e.worker_id == worker_id
                        or (in_chain and e.final_stage is not None)]
            for e in orphaned:
                del self._inflight[e.request_id]
        for e in orphaned:
            try:
                self._forward_pool.submit(self._redispatch, e,
                                          f"worker {worker_id} left")
            except RuntimeError:  # pool shut down
                break
