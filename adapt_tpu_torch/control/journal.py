"""Dispatcher write-ahead journal: the worker pool and the accepted
requests outlive the dispatcher process.

Counterpart of ``adapt_tpu/control/journal.py``, with its on-disk format,
so either package replays the other's directory: an append-only JSONL WAL
(``wal.jsonl``: ``worker``, ``worker_gone``, ``submit``, ``done`` and
``horizon`` records) and one ``req_<id>.npy`` payload per request, written
atomically (tmp + rename, the directory fsynced) BEFORE its submit mark,
so a submit mark always has its payload. A done mark is appended on any
terminal completion, value or error. The WAL's directory entry is fsynced
when the journal is created, so the appends before the first compaction
survive a host crash.

The WAL compacts itself: a mirror of {workers, pending ids} lives in
memory, and every ``compact_every`` appends (and every :meth:`load`) the
file is rewritten to that state; done payloads are reclaimed in groups of
:attr:`RECLAIM_EVERY` after one fsync, and by the compaction sweep.

Payloads are numpy ``.npy`` files; the port hands tensors in and gets CPU
tensors back. numpy has no bfloat16, so a bfloat16 payload is journaled as
its exact float32 value.

A crash between a request's completion and its done mark replays it once
more on recovery (the WAL's at-least-once window); each pending request
completes exactly once in the recovered dispatcher.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any

import numpy as np
import torch

from adapt_tpu_torch.utils.logging import get_logger

log = get_logger("journal")


def _to_numpy(payload: Any) -> np.ndarray:
    if isinstance(payload, torch.Tensor):
        t = payload.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(payload)


class DispatcherJournal:
    """Append-only crash journal under ``root``; thread-safe. Every append
    but a done mark is flushed and fsynced."""

    #: Group-commit width of payload reclaim: one fsync per this many
    #: completions, then their payloads are unlinked together.
    RECLAIM_EVERY = 64

    def __init__(self, root: str, compact_every: int = 10_000):
        self.root = root
        self.compact_every = compact_every
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._wal_path = os.path.join(root, "wal.jsonl")
        self._workers: dict[str, dict] = {}
        self._pending: set[int] = set()
        #: The JSON ``meta`` dicts of pending submit marks.
        self._submit_meta: dict[int, dict] = {}
        #: Ids whose payload is being written (no mark yet): the
        #: compaction sweep must not reap their files.
        self._writing: set[int] = set()
        #: Done ids whose payloads await the group-commit reclaim.
        self._reclaimable: list[int] = []
        self._max_id = -1
        self._appends = 0
        self._replay_file_into_mirror()
        self._wal = open(self._wal_path, "a", encoding="utf-8")
        self._fsync_root()

    # -- write side ----------------------------------------------------------

    def _apply_to_mirror(self, rec: dict) -> None:
        op, rid = rec.get("op"), rec.get("id")
        if op == "worker":
            self._workers[rid] = {"host": rec["host"], "port": rec["port"],
                                  "meta": rec.get("meta", {})}
        elif op == "worker_gone":
            self._workers.pop(rid, None)
        elif op == "submit":
            self._pending.add(rid)
            if rec.get("meta") is not None:
                self._submit_meta[rid] = rec["meta"]
            self._max_id = max(self._max_id, rid)
        elif op == "done":
            self._pending.discard(rid)
            self._submit_meta.pop(rid, None)
            self._max_id = max(self._max_id, rid)
        elif op == "horizon":
            self._max_id = max(self._max_id, rid)

    @property
    def next_request_id(self) -> int:
        """One past the highest id this journal has seen: the seed of any
        dispatcher serving over it (a recycled id would clear a crashed
        request's pending mark with its own done mark)."""
        with self._lock:
            return self._max_id + 1

    def _replay_file_into_mirror(self) -> None:
        if not os.path.exists(self._wal_path):
            return
        with open(self._wal_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    # A torn last line is the crash's shape; its payload
                    # (if any) was orphaned before its mark.
                    log.warning("journal: skipping torn WAL line")
                    continue
                self._apply_to_mirror(rec)

    def _fsync_root(self) -> None:
        """Persist the directory entries: a created or renamed file is not
        durable until its directory is."""
        fd = os.open(self.root, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _append(self, record: dict, fsync: bool = True) -> None:
        with self._lock:
            self._wal.write(json.dumps(record) + "\n")
            self._wal.flush()
            if fsync:
                os.fsync(self._wal.fileno())
            self._apply_to_mirror(record)
            self._appends += 1
            if self._appends >= self.compact_every:
                self._compact_locked()

    def _compact_locked(self) -> None:
        """Rewrite the WAL as {workers} + {pending submit marks} + the id
        horizon (tmp + rename), reopen it, sweep unreferenced payloads."""
        tmp = self._wal_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for wid, info in self._workers.items():
                f.write(json.dumps({"op": "worker", "id": wid,
                                    "host": info["host"],
                                    "port": info["port"],
                                    "meta": info.get("meta", {})}) + "\n")
            for rid in sorted(self._pending):
                rec = {"op": "submit", "id": rid}
                meta = self._submit_meta.get(rid)
                if meta is not None:
                    rec["meta"] = meta
                f.write(json.dumps(rec) + "\n")
            f.write(json.dumps({"op": "horizon", "id": self._max_id}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        old = self._wal
        os.replace(tmp, self._wal_path)
        self._fsync_root()
        self._wal = open(self._wal_path, "a", encoding="utf-8")
        try:
            old.close()
        except OSError:
            pass
        self._appends = 0
        # Every done mark is durable now (the compacted file has no
        # pending mark for those ids), so the whole backlog may go.
        self._reclaimable.clear()
        keep = set()
        for rid in self._pending | self._writing:
            keep.update((f"req_{rid}.npy", f"req_{rid}.npy.tmp"))
        for name in os.listdir(self.root):
            if (name.startswith("req_") and name.endswith((".npy", ".npy.tmp"))
                    and name not in keep):
                try:
                    os.unlink(os.path.join(self.root, name))
                except OSError:
                    pass

    def compact(self) -> None:
        with self._lock:
            self._compact_locked()

    def record_worker(self, worker_id: str, host: str, port: int,
                      meta: dict | None = None) -> None:
        """Durable worker-pool entry; the latest record of an id wins."""
        self._append({"op": "worker", "id": worker_id, "host": host,
                      "port": port, "meta": meta or {}})

    def forget_worker(self, worker_id: str) -> None:
        """Remove a worker from the durable pool (recovery found its
        address dead, or it was decommissioned)."""
        self._append({"op": "worker_gone", "id": worker_id})

    def _payload_path(self, request_id: int) -> str:
        return os.path.join(self.root, f"req_{request_id}.npy")

    def record_submit(self, request_id: int, payload: Any,
                      meta: dict | None = None) -> None:
        """The payload first (atomic rename, directory fsynced), then the
        submit mark; ``meta`` (a JSON dict) rides on the mark."""
        with self._lock:
            self._writing.add(request_id)
        try:
            path = self._payload_path(request_id)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.save(f, _to_numpy(payload), allow_pickle=False)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self._fsync_root()
            rec = {"op": "submit", "id": request_id}
            if meta is not None:
                rec["meta"] = meta
            self._append(rec)
        finally:
            with self._lock:
                self._writing.discard(request_id)

    def submit_meta(self, request_id: int) -> dict | None:
        """The ``meta`` of a still-pending submit mark, or None."""
        with self._lock:
            meta = self._submit_meta.get(request_id)
            return dict(meta) if meta is not None else None

    def pending_ids(self) -> set[int]:
        with self._lock:
            return set(self._pending)

    def read_payload(self, request_id: int) -> torch.Tensor:
        """One pending request's payload (``OSError`` if it is gone)."""
        return torch.from_numpy(np.load(self._payload_path(request_id),
                                        allow_pickle=False))

    def record_done(self, request_id: int) -> None:
        """Unfsynced done mark (a lost one costs one extra replay); every
        :attr:`RECLAIM_EVERY` marks, one fsync, then their payloads go."""
        self._append({"op": "done", "id": request_id}, fsync=False)
        batch: list[int] = []
        with self._lock:
            self._reclaimable.append(request_id)
            if len(self._reclaimable) >= self.RECLAIM_EVERY:
                try:
                    os.fsync(self._wal.fileno())
                except (OSError, ValueError):
                    return  # keep the batch for the next time
                batch, self._reclaimable = self._reclaimable, []
        for rid in batch:
            try:
                os.unlink(self._payload_path(rid))
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            try:
                self._wal.close()
            except OSError:
                pass

    # -- read side (recovery) ------------------------------------------------

    def load(self) -> tuple[dict[str, dict], dict[int, torch.Tensor], int]:
        """``(workers, pending, next_request_id)``: worker id -> {host,
        port, meta}; request id -> payload for every submit without a done
        mark; one past the highest id ever journaled. A pending mark whose
        payload is unreadable is logged as lost and marked done. Compacts
        the WAL."""
        with self._lock:
            workers = {k: dict(v) for k, v in self._workers.items()}
            pending_ids = sorted(self._pending)
            next_id = self._max_id + 1
        pending: dict[int, torch.Tensor] = {}
        for rid in pending_ids:
            try:
                pending[rid] = self.read_payload(rid)
            except OSError as e:
                log.error("journal: request %d has a submit mark but no "
                          "readable payload (%s); it is LOST and marked done",
                          rid, e)
                self.record_done(rid)
        self.compact()
        return workers, pending, next_id
