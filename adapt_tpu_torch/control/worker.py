"""Stage workers: device-owning executors with heartbeats and kill modes.

Counterpart of ``adapt_tpu/control/worker.py`` (the reference's ``Node``):
a worker owns a device, accepts stage configurations, runs data tasks and
posts every result back to the dispatcher hub.

A binding is a module of the worker's own: the dispatcher hands over a
stage module built on the meta device (``PartitionPlan.build_stage``), and
:meth:`StageWorker.configure` allocates its storage on the worker's device
and copies the stage's host weights in. That is a weight move; nothing is
built. No module is shared between workers, so several workers can run the
same stage on one card at once (``ServingPipeline(devices=[cuda:0] * 4)``
makes four workers there, and a worker may hold several stages).

Workers run on threads and launch on the device's default stream, so a
stage output handed to another worker needs no event wait or
``record_stream``: every worker's work is ordered on that one stream. A
worker waits for its stage's work to finish (a CUDA event) before it posts
the result, as the JAX worker's ``block_until_ready`` does, so task
deadlines and stage latencies measure host time up to the device's
completion.

Kill modes for fault injection:

- ``crash``: stop heartbeating AND stop processing; the exec loop
  deregisters the worker at once (the lease TTL is the backstop).
- ``hang``: keep heartbeating but stop processing: only the task-deadline
  watchdog can catch it, and the worker is never marked ``DEAD``.
"""

from __future__ import annotations

import enum
import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import torch

from adapt_tpu_torch.config import FaultConfig
from adapt_tpu_torch.control.registry import WorkerRegistry
from adapt_tpu_torch.utils.logging import get_logger
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.tracing import global_flight_recorder, global_tracer

log = get_logger("worker")


class WorkerState(enum.Enum):
    """Reference ``StateEnum``."""

    IDLE = "idle"
    BUSY = "busy"
    DEAD = "dead"


#: Stage index of liveness-probe (canary) tasks: the worker answers without
#: touching any binding. A hung exec loop swallows a ping like a real task,
#: which is the signal the dispatcher's watchdog turns into a strike.
PING_STAGE = -1


@dataclass
class Task:
    """One stage-execution request."""

    request_id: int
    stage_index: int
    attempt: int
    payload: Any  # a tensor on any device
    #: A chain-mode head submit to a remote worker
    #: (``Dispatcher.setup_chain``): the result returns on another
    #: worker's link.
    chained: bool = False
    #: Stamped by StageWorker.submit (perf-counter clock): the inbox wait
    #: feeds the ``worker.queue_wait_s`` histogram.
    t_enqueue: float = 0.0


@dataclass
class TaskResult:
    request_id: int
    stage_index: int
    attempt: int
    worker_id: str
    output: Any = None
    error: str | None = None


@dataclass
class _StageBinding:
    module: Any  # this worker's StageModule, weights on its device
    device: torch.device
    spec: Any = field(default=None)
    generation: int = 0  # which configure installed this binding


def _wait_for_device(device: torch.device) -> None:
    """Block this thread until the work queued so far on ``device``'s
    current stream is done (the JAX worker's ``block_until_ready``);
    nothing to wait for on the CPU."""
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()


class StageWorker:
    """In-process worker bound to one device."""

    def __init__(
        self,
        worker_id: str,
        device,
        registry: WorkerRegistry,
        result_queue: "queue.Queue[TaskResult]",
        fault: FaultConfig | None = None,
    ):
        self.worker_id = worker_id
        self.device = torch.device(device)
        self._registry = registry
        self._results = result_queue
        self._fault = fault or FaultConfig()
        self._inbox: queue.Queue[Task | None] = queue.Queue()
        self._bindings: dict[int, _StageBinding] = {}
        self._bind_gen = itertools.count(1)
        self._bind_lock = threading.Lock()
        self._state = WorkerState.IDLE
        self._state_lock = threading.Lock()
        self._crashed = threading.Event()
        self._stopping = threading.Event()  # clean stop() vs crash
        self._hung = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "StageWorker":
        self._registry.register(self.worker_id,
                                meta={"device": str(self.device)},
                                ttl_s=self._fault.lease_ttl_s)
        for name, target in (("exec", self._exec_loop),
                             ("heartbeat", self._heartbeat_loop)):
            t = threading.Thread(target=target,
                                 name=f"{self.worker_id}-{name}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stopping.set()
        self._crashed.set()
        self._inbox.put(None)
        for t in self._threads:
            t.join(timeout=2.0)
        self._registry.deregister(self.worker_id)

    # -- fault injection ----------------------------------------------------

    def kill(self, mode: str = "crash") -> None:
        global_flight_recorder().record("worker_killed",
                                        worker=self.worker_id, mode=mode)
        if mode == "crash":
            self._crashed.set()
            self._inbox.put(None)
            log.warning("worker %s crashed (injected)", self.worker_id)
            with self._state_lock:
                self._state = WorkerState.DEAD
        elif mode == "hang":
            # A real hang keeps heartbeating and stays schedulable — the
            # dispatcher must discover it through task deadlines.
            self._hung.set()
            log.warning("worker %s hung (injected)", self.worker_id)
        else:
            raise ValueError(f"unknown kill mode {mode!r}")

    def revive(self) -> None:
        """Clear an injected hang: the exec loop drains its inbox again,
        queued canary probes included, whose answers lift the dispatcher's
        quarantine."""
        self._hung.clear()

    # -- dispatcher-facing API ----------------------------------------------

    @property
    def state(self) -> WorkerState:
        with self._state_lock:
            return self._state

    def is_configured(self, stage_index: int) -> bool:
        with self._bind_lock:
            return stage_index in self._bindings

    def configure(self, stage_index: int, module, host_state, spec=None,
                  abort=None) -> int:
        """Install a stage: ``module`` (a stage module built on the meta
        device, given to this worker alone) gets its storage on this
        worker's device and ``host_state`` (``{node: state dict}``) copied
        in; returns when the weights are resident (the handshake's ACK).

        ``abort`` (a zero-arg callable) is checked before the weight copy
        and again just before the binding is installed: a dispatcher that
        timed out this handshake sets it, so the abandoned configure cannot
        install a binding after the dispatcher moved on. Returns a
        generation handle for :meth:`unconfigure`."""
        if self._crashed.is_set():
            raise RuntimeError(f"worker {self.worker_id} is dead")
        if abort is not None and abort():
            raise RuntimeError("configure aborted before weight transfer")
        module = module.to_empty(device=self.device)
        module.load_stage_state(host_state)
        module.eval()
        _wait_for_device(self.device)  # the ACK
        generation = next(self._bind_gen)
        with self._bind_lock:
            if abort is not None and abort():
                raise RuntimeError("configure aborted (caller timed out)")
            self._bindings[stage_index] = _StageBinding(
                module=module, device=self.device, spec=spec,
                generation=generation)
        global_metrics().inc("worker.configured")
        return generation

    def unconfigure(self, stage_index: int,
                    generation: int | None = None) -> None:
        """Drop a stage binding (and with it the module's device weights).
        With ``generation``, only if that configure's binding is still the
        installed one."""
        with self._bind_lock:
            binding = self._bindings.get(stage_index)
            if binding is None:
                return
            if generation is not None and binding.generation != generation:
                return
            del self._bindings[stage_index]

    def submit(self, task: Task) -> None:
        task.t_enqueue = time.perf_counter()
        self._inbox.put(task)

    @property
    def queue_depth(self) -> int:
        return self._inbox.qsize()

    # -- loops --------------------------------------------------------------

    def _heartbeat_loop(self) -> None:
        # A crashed worker stops renewing; the registry reaper evicts it
        # after lease_ttl.
        while not self._crashed.wait(self._fault.heartbeat_s):
            renewed = self._registry.heartbeat(
                self.worker_id, ttl_s=self._fault.lease_ttl_s)
            if not renewed and not self._crashed.is_set():
                # The lease lapsed (a stall held this thread) but the
                # worker is alive: re-register rather than serve unseen.
                self._registry.register(
                    self.worker_id, meta={"device": str(self.device)},
                    ttl_s=self._fault.lease_ttl_s)
                if self._crashed.is_set():
                    # A kill landing between the check and the register
                    # may have deregistered already: whichever side runs
                    # last removes the lease.
                    self._registry.deregister(self.worker_id)

    def _exec_loop(self) -> None:
        try:
            self._exec_loop_inner()
        finally:
            if self._crashed.is_set() and not self._stopping.is_set():
                # Event-driven crash eviction: an in-process worker whose
                # exec loop died is gone NOW. A hang keeps its lease by
                # design — only the watchdog can call that.
                self._registry.deregister(self.worker_id)
                global_metrics().inc("worker.crash_evicted")
                global_flight_recorder().record("worker_crash_evicted",
                                                worker=self.worker_id)
                log.warning("worker %s evicted on crash (event, not TTL)",
                            self.worker_id)

    def _exec_loop_inner(self) -> None:
        while not self._crashed.is_set():
            task = self._inbox.get()
            if task is None or self._crashed.is_set():
                break
            if self._hung.is_set():
                continue  # swallow the task, never reply
            if task.stage_index < 0:
                # Liveness probe: answered through this loop, so a blocked
                # loop fails the probe the way it fails real tasks.
                self._results.put(TaskResult(
                    request_id=task.request_id, stage_index=task.stage_index,
                    attempt=task.attempt, worker_id=self.worker_id))
                continue
            if task.t_enqueue:
                global_metrics().observe(
                    "worker.queue_wait_s",
                    time.perf_counter() - task.t_enqueue)
            with self._state_lock:
                self._state = WorkerState.BUSY
            try:
                with self._bind_lock:
                    binding = self._bindings.get(task.stage_index)
                if binding is None:
                    raise RuntimeError(
                        f"stage {task.stage_index} not configured on "
                        f"{self.worker_id}")
                with global_tracer().span(
                        "stage_exec", stage=task.stage_index,
                        worker=self.worker_id, request=task.request_id,
                        attempt=task.attempt), torch.no_grad():
                    y = binding.module(task.payload.to(self.device))
                    _wait_for_device(self.device)
                self._results.put(TaskResult(
                    request_id=task.request_id, stage_index=task.stage_index,
                    attempt=task.attempt, worker_id=self.worker_id,
                    output=y))
                global_metrics().inc("worker.tasks_ok")
            except Exception as e:  # noqa: BLE001 — report, don't die
                log.error("worker %s task failed: %s", self.worker_id, e)
                self._results.put(TaskResult(
                    request_id=task.request_id, stage_index=task.stage_index,
                    attempt=task.attempt, worker_id=self.worker_id,
                    error=str(e)))
                global_metrics().inc("worker.tasks_failed")
            finally:
                with self._state_lock:
                    if self._state is not WorkerState.DEAD:
                        self._state = WorkerState.IDLE
