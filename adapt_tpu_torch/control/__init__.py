"""The adaptive control plane of the port: worker membership
(``registry``, with the mesh members' ``DeviceHealthMonitor``), stage
workers (``worker``), the late-binding dispatcher with its watchdog
(``dispatcher``) and the crash journal (``journal``)."""

from adapt_tpu_torch.control.dispatcher import Dispatcher, RequestFailed
from adapt_tpu_torch.control.journal import DispatcherJournal
from adapt_tpu_torch.control.registry import WorkerRegistry
from adapt_tpu_torch.control.worker import StageWorker, WorkerState

__all__ = [
    "Dispatcher",
    "DispatcherJournal",
    "RequestFailed",
    "WorkerRegistry",
    "StageWorker",
    "WorkerState",
]
