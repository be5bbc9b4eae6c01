"""Serving pipelines over a partitioned model, two ways.

Counterpart of ``adapt_tpu/runtime/pipeline.py``.

``LocalPipeline``: static stage -> device binding. Each stage is a module
of its own on its device (``core.stage.compile_stages``); activations hop
device to device; across devices, or with a ``hop_transform``, ``stream``
runs a thread per stage (and a hop thread per stage with a
``hop_transform``) connected by depth-bounded queues, so stage i computes
request r+1 while stage i+1 computes r. No adaptivity; maximum throughput.

``ServingPipeline``: the adaptive path, ``control.Dispatcher`` + workers
(late binding, membership, watchdog re-dispatch) behind the same
queue-in / queue-out API. With ``gateway_model_config`` remote worker
processes join it at run time (``comm.remote.WorkerGateway``); with
``journal_dir`` accepted requests and the dial-out workers survive a crash
of the serving process (``control.journal``, ``Dispatcher.recover``).

Both run on the CUDA card unless given CPU devices (``devices="cpu"`` or a
list of CPU devices), and raise without a card otherwise; they never fall
back to the CPU. Calls run without autograd (serving is inference). The
observability exporter (``serve_observability``) waits for queue 1 item 9
of ROADMAP.md.
"""

from __future__ import annotations

import queue
import threading
import time
from collections.abc import Iterable, Sequence
from typing import Any

import torch

from adapt_tpu_torch.config import ServeConfig
from adapt_tpu_torch.control.dispatcher import Dispatcher
from adapt_tpu_torch.control.registry import WorkerRegistry
from adapt_tpu_torch.core.mesh import device_list
from adapt_tpu_torch.core.stage import CompiledStage, compile_stages
from adapt_tpu_torch.graph.partition import PartitionPlan
from adapt_tpu_torch.utils.logging import get_logger
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.tracing import global_tracer

log = get_logger("pipeline")

_SENTINEL = object()


class _StageError:
    """Error marker sent down the stage queues so a failing stage can't
    strand the stream's consumer."""

    def __init__(self, stage_index: int, exc: Exception):
        self.stage_index = stage_index
        self.exc = exc


def codec_hop_transform(codec_cfg):
    """A ``hop_transform`` from a ``config.CodecConfig``: every activation
    hop pays the codec's round trip (``pack`` then ``unpack``) and lands
    back on the device it left, as a hop between two processes would.
    None for ``"none"``: in-process hops need no transform."""
    from adapt_tpu_torch.comm.codec import get_codec, pack, unpack

    if codec_cfg.name == "none":
        return None
    codec = get_codec(codec_cfg.name, tolerance=codec_cfg.tolerance)

    def hop(activation, stage_index):
        dev = activation.device
        return unpack(pack(codec, activation), device=dev).to(dev)

    return hop


def _synchronize(x) -> None:
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


class LocalPipeline:
    """Static-chain pipelined inference over a device list."""

    def __init__(self, plan: PartitionPlan, variables=None, devices=None,
                 hop_transform=None):
        """``variables``: ``{node: state dict}`` (None: the graph's own
        weights). ``devices``: stage i runs on ``devices[i % len]`` (None:
        the CUDA card). ``hop_transform(activation, stage_index) ->
        activation`` is applied to every stage output before the next
        stage takes it (and to the final result)."""
        self.plan = plan
        self.hop_transform = hop_transform
        self.stages: list[CompiledStage] = compile_stages(
            plan, variables, device_list(devices))

    @classmethod
    def from_config(cls, plan: PartitionPlan, variables=None, devices=None,
                    config: ServeConfig | None = None) -> "LocalPipeline":
        """LocalPipeline with the hop transform ``config.codec`` names
        (:func:`codec_hop_transform`), the knob that also sets every
        remote worker's codec."""
        config = config or ServeConfig()
        return cls(plan, variables, devices,
                   hop_transform=codec_hop_transform(config.codec))

    def infer(self, x: torch.Tensor) -> torch.Tensor:
        """Single-request path (latency)."""
        for stage in self.stages:
            x = stage(x)
            if self.hop_transform is not None:
                x = self.hop_transform(x, stage.spec.index)
        return x

    def warmup(self, example) -> None:
        _synchronize(self.infer(example))

    def stream(self, inputs: Iterable[Any]) -> list[torch.Tensor]:
        """Throughput path. When every stage is on one device and there is
        no ``hop_transform``, the requests run one after another in the
        caller's thread: the stages share the card's default stream, so
        threads could overlap nothing on the device, and their eager
        launches would contend for the interpreter
        (``scripts/pipeline_threads.py`` measures both ways). Otherwise a
        thread per stage (and a hop thread per stage with a
        ``hop_transform``, a blocking host round trip) connected by
        depth-bounded queues, so stage i computes request r+1 while stage
        i+1, or stage i's hop, handles r."""
        if (self.hop_transform is None
                and len({s.device for s in self.stages}) == 1):
            outputs = []
            for x in inputs:
                for stage in self.stages:
                    try:
                        x = stage(x)
                    except Exception as e:  # noqa: BLE001 — name the stage
                        raise RuntimeError(f"stage {stage.spec.index} "
                                           "failed during stream") from e
                outputs.append(x)
            return outputs
        return self._threaded_stream(inputs)

    def _threaded_stream(self, inputs: Iterable[Any]) -> list[torch.Tensor]:
        """``stream``'s thread-per-stage path, on any device layout."""
        n_stages = len(self.stages)
        qs: list[queue.Queue] = [queue.Queue(maxsize=4)
                                 for _ in range(n_stages + 1)]
        outputs: list[torch.Tensor] = []
        abort = threading.Event()

        def put_or_abort(q: queue.Queue, item) -> bool:
            while not abort.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def get_or_abort(q: queue.Queue):
            while not abort.is_set():
                try:
                    return q.get(timeout=0.1)
                except queue.Empty:
                    continue
            return _SENTINEL

        hop_qs: list[queue.Queue | None] = [
            queue.Queue(maxsize=2) if self.hop_transform is not None else None
            for _ in range(n_stages)
        ]
        tracer = global_tracer()

        def stage_loop(i: int):
            stage = self.stages[i]
            out_q = hop_qs[i] or qs[i + 1]
            seq = 0
            while True:
                item = get_or_abort(qs[i])
                if item is _SENTINEL or isinstance(item, _StageError):
                    put_or_abort(out_q, item)
                    break
                try:
                    with tracer.span("pipeline.stage", stage=i, seq=seq):
                        y = stage(item)
                except Exception as e:  # noqa: BLE001 — surface to caller
                    put_or_abort(out_q, _StageError(stage.spec.index, e))
                    break
                seq += 1
                if not put_or_abort(out_q, y):
                    break

        def hop_loop(i: int):
            stage = self.stages[i]
            seq = 0
            while True:
                y = get_or_abort(hop_qs[i])
                if y is _SENTINEL or isinstance(y, _StageError):
                    put_or_abort(qs[i + 1], y)
                    break
                try:
                    with tracer.span("pipeline.hop", stage=i, seq=seq):
                        y = self.hop_transform(y, stage.spec.index)
                except Exception as e:  # noqa: BLE001 — surface to caller
                    put_or_abort(qs[i + 1], _StageError(stage.spec.index, e))
                    break
                seq += 1
                if not put_or_abort(qs[i + 1], y):
                    break

        threads = [
            threading.Thread(target=stage_loop, args=(i,), daemon=True)
            for i in range(n_stages)
        ] + [
            threading.Thread(target=hop_loop, args=(i,), daemon=True)
            for i in range(n_stages) if hop_qs[i] is not None
        ]
        for t in threads:
            t.start()

        def feed():
            for x in inputs:
                if not put_or_abort(qs[0], x):
                    return
            put_or_abort(qs[0], _SENTINEL)

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        error: _StageError | None = None
        while True:
            y = qs[-1].get()
            if isinstance(y, _StageError):
                error = y
                break
            if y is _SENTINEL:
                break
            outputs.append(y)
        if error is not None:
            abort.set()  # unblock producers so no thread leaks
        feeder.join()
        for t in threads:
            t.join()
        if error is not None:
            raise RuntimeError(
                f"stage {error.stage_index} failed during stream"
            ) from error.exc
        return outputs

    def throughput(self, inputs: Sequence[Any]) -> tuple[list, float]:
        """Timed stream ending in a device synchronize: (outputs, wall
        seconds)."""
        start = time.perf_counter()
        outputs = self.stream(inputs)
        if outputs:
            _synchronize(outputs[-1])
        return outputs, time.perf_counter() - start


class ServingPipeline:
    """Adaptive serving: dispatcher + workers + membership + watchdog.
    ``devices`` lists one in-process worker's device each (a device may
    repeat: ``[cuda:0] * 4`` is four workers on one card; ``[]``: none).

    ``gateway_model_config`` opens a ``comm.remote.WorkerGateway`` with
    the pipeline: any process can then join the pool with ``python -m
    adapt_tpu_torch.comm.remote --connect HOST:{gateway_port}``. The dict
    is the recipe joiners rebuild stages from (``model``, ``cuts``,
    ``num_classes``, ``model_kwargs``; or ``graph_spec``), and must
    rebuild the graph ``plan`` partitioned; codecs come from
    ``config.codec``. ``gateway_device``: where the joined workers'
    ``int8dev`` results are dequantized (None: the first of ``devices``,
    else the CUDA card). ``journal_dir``: journal accepted requests and
    the dial-out workers there (``control.journal``), so a crashed
    serving process can be rebuilt with ``Dispatcher.recover``."""

    def __init__(self, plan: PartitionPlan, variables=None, devices=None,
                 config: ServeConfig | None = None,
                 gateway_model_config: dict | None = None,
                 gateway_host: str = "127.0.0.1", gateway_port: int = 0,
                 gateway_secret: str | None = None, gateway_device=None,
                 journal_dir: str | None = None):
        devices = device_list(devices)
        self.config = config or ServeConfig()
        self.registry = WorkerRegistry(
            default_ttl_s=self.config.fault.lease_ttl_s)
        journal = None
        if journal_dir is not None:
            from adapt_tpu_torch.control.journal import DispatcherJournal

            journal = DispatcherJournal(journal_dir)
        self.dispatcher = Dispatcher(plan, variables, registry=self.registry,
                                     config=self.config, journal=journal)
        self.workers = self.dispatcher.spawn_workers(devices)
        self._journal_dir = journal_dir
        self.gateway = None
        if gateway_model_config is not None:
            from adapt_tpu_torch.comm.remote import WorkerGateway

            if gateway_device is None and devices:
                gateway_device = devices[0]
            self.gateway = WorkerGateway(
                self.dispatcher, gateway_model_config, host=gateway_host,
                port=gateway_port, secret=gateway_secret,
                result_device=gateway_device)

    @property
    def gateway_port(self) -> int | None:
        """The port joiners dial: None until :meth:`start` binds it (or
        without a gateway)."""
        if self.gateway is None or not self.gateway.port:
            return None
        return self.gateway.port

    def start(self) -> "ServingPipeline":
        """Start the gateway (joiners count toward the dispatcher's wait
        for its first worker), then the dispatcher."""
        if self._journal_dir is not None:
            # Only workers with a listen address are journaled: a journal
            # over none can replay requests but never re-adopt a worker.
            with self.dispatcher._workers_lock:
                pool = list(self.dispatcher._workers.values())
            if not any(getattr(w, "chain_address", None) is not None
                       for w in pool):
                log.warning(
                    "journal_dir=%r configured but the worker pool holds no "
                    "journaled (dial-out remote) workers: after a crash, "
                    "recovery cannot re-adopt any worker from this journal",
                    self._journal_dir)
        if self.gateway is not None:
            self.gateway.start()
        try:
            self.dispatcher.start()
        except Exception:
            if self.gateway is not None:
                self.gateway.stop()
            raise
        return self

    def shutdown(self) -> None:
        if self.gateway is not None:
            self.gateway.stop()
        self.dispatcher.shutdown()

    def __enter__(self) -> "ServingPipeline":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def infer(self, x, timeout: float | None = 120.0):
        return self.dispatcher.infer(x, timeout)

    def warmup(self, example, timeout: float | None = 300.0) -> None:
        self.dispatcher.warmup(example, timeout)

    def stream(self, inputs: Iterable[Any],
               timeout_per_request: float = 120.0):
        return self.dispatcher.serve_stream(inputs, timeout_per_request)

    def throughput(self, inputs: Sequence[Any]) -> tuple[list, float]:
        start = time.perf_counter()
        outputs = self.stream(inputs)
        if outputs:
            _synchronize(outputs[-1])
        return outputs, time.perf_counter() - start

    def kill_worker(self, index: int, mode: str = "crash") -> None:
        """Chaos hook: kill one worker by index."""
        self.workers[index].kill(mode)

    def metrics(self) -> dict:
        return global_metrics().snapshot()

    def serve_observability(self, port: int = 0, host: str = "127.0.0.1"):
        """The process observability exporter waits for
        ``utils/exporter.py`` (ROADMAP.md queue 1 item 9)."""
        raise NotImplementedError(
            "serve_observability waits for the exporter (utils/exporter.py, "
            "ROADMAP.md queue 1 item 9)")
