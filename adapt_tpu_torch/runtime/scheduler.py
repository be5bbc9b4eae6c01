"""Admission control in front of the continuous batcher — the port of
``adapt_tpu/runtime/scheduler.py``'s :class:`QueueFullError` and the
bounded FIFO mode of :class:`AdmissionQueue` (the mode a batcher without a
``SchedulerConfig`` runs). Tenant quotas, deficit-round-robin fair
queueing, priorities, preemption and the degradation controller are not
ported yet: passing a ``SchedulerConfig`` raises.

Thread-safety: the queue is mutated only under the batcher's handoff
condition, as in the JAX package.
"""

from __future__ import annotations

import collections

from adapt_tpu_torch.config import SchedulerConfig


class QueueFullError(RuntimeError):
    """Admission control rejected a submit SYNCHRONOUSLY (the global
    ``max_queue_depth`` bound): the request was never accepted, so no id
    waits on ``result()``."""


class AdmissionQueue:
    """Bounded strict-FIFO admission queue with the deque-shaped API the
    batcher uses: ``append`` (checked — raises :class:`QueueFullError`),
    ``appendleft`` (a re-queue), ``popleft``, ``remove_id`` (cancel) and
    ``len``."""

    def __init__(self, cfg: SchedulerConfig | None = None):
        if cfg is not None:
            raise NotImplementedError(
                "SchedulerConfig traffic control (DRR, priorities, "
                "preemption, degradation) is not ported yet: ROADMAP "
                "queue 1 item 10"
            )
        self.cfg = SchedulerConfig()
        self._q: collections.deque = collections.deque()

    def check(self) -> None:
        """Raise :class:`QueueFullError` iff an admit would be rejected."""
        if len(self._q) >= self.cfg.max_queue_depth:
            raise QueueFullError(
                f"queue depth {len(self._q)} at max_queue_depth="
                f"{self.cfg.max_queue_depth}"
            )

    def append(self, req) -> None:
        self.check()
        self._q.append(req)

    def appendleft(self, req) -> None:
        """Put a popped request back at the head, unchecked: admission
        could not cover it yet (the paged pool's head-of-line wait)."""
        self._q.appendleft(req)

    def popleft(self):
        if not self._q:
            raise IndexError("pop from an empty AdmissionQueue")
        return self._q.popleft()

    def remove_id(self, req_id: int):
        for i, req in enumerate(self._q):
            if req.req_id == req_id:
                del self._q[i]
                return req
        return None

    def __len__(self) -> int:
        return len(self._q)
