"""Remote stage workers: a stage server process and its dispatcher-side
proxy, plus the gateway through which workers join a running pipeline.

Counterpart of ``adapt_tpu/comm/remote.py``, with its wire protocol
(``comm.framing``: one duplex TCP connection of typed frames). A worker
process serves stage configure / execute for one device
(:class:`RemoteStageServer`, ``python -m adapt_tpu_torch.comm.remote``);
the dispatcher drives it through :class:`RemoteWorkerProxy`, which has the
interface of ``control.worker.StageWorker``, so late binding, the
watchdog and re-dispatch are blind to topology.

A configure carries the model by registry name (``models.MODEL_REGISTRY``)
or by value (``graph.spec`` of the graph), the cut list and the stage
index, then the stage's weights as one frame per array in the order
``graph.partition.stage_weight_keys`` defines, then an end frame. The
server builds the stage module on the meta device, gives it storage on
its device and loads the arrays into it. Activations cross with the
codec the configure names (``comm.codec``): ``int8dev`` quantizes on the
sender's card (K6) and dequantizes on the receiver's.

The server pings on every connection; the proxy renews the worker's lease
only when pings arrive, so a dead process or a cut link expires it like a
crashed in-process worker, and a closed link deregisters it at once.
Chain forwarding (``Dispatcher.setup_chain``) installs a next hop per
stage (``MSG_SET_ROUTE``): chained data (``MSG_DATA_CHAINED``) then goes
worker to worker and only the tail's result, and any error, returns to the
hub.

Beyond the JAX package: a worker may both listen (``--port``) and join a
gateway (``--connect``); its HELLO then names its listen address, which
makes the joined worker a chain member and lets a journal re-adopt it. The
JAX gateway ignores the extra key.

Telemetry: every ``telemetry_s`` the server pushes a
``utils.telemetry.TelemetryReporter`` report (``MSG_TELEMETRY``, JSON:
this process's windowed metric deltas, flight events, spans and a stage
capacity book). A thread of its own builds and encodes each report; the
dispatcher link's ping thread sends the finished ones, so a worker whose
pings stop stops reporting, and building a report never delays a ping;
the proxy ingests it into the process-global
``FederatedStore`` under the lease's worker id, whose
``fleet.report_age_s.<source>`` gauge then shows the worker's staleness.
"""

from __future__ import annotations

import hmac
import itertools
import json
import socket
import threading
import time
from typing import Any

import torch

from adapt_tpu_torch import resolve_device
from adapt_tpu_torch.comm import codec as codec_lib
from adapt_tpu_torch.comm.framing import (
    MSG_ACK,
    MSG_CONFIG,
    MSG_CONFIG_ARRAY,
    MSG_CONFIG_END,
    MSG_CONFIG_ERR,
    MSG_DATA,
    MSG_DATA_CHAINED,
    MSG_ERROR,
    MSG_HELLO,
    MSG_HELLO_ACK,
    MSG_KILL,
    MSG_PING,
    MSG_PROBE,
    MSG_PROBE_ACK,
    MSG_RESULT,
    MSG_SET_ROUTE,
    MSG_TELEMETRY,
    MSG_UNCONFIGURE,
    Message,
    payload_bytes,
    recv_msg,
    send_msg,
)
from adapt_tpu_torch.config import FaultConfig
from adapt_tpu_torch.control.registry import WorkerRegistry
from adapt_tpu_torch.control.worker import (
    TaskResult,
    WorkerState,
    _wait_for_device,
)
from adapt_tpu_torch.graph.partition import partition, stage_weight_keys
from adapt_tpu_torch.utils.logging import get_logger
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.telemetry import (
    TelemetryReporter,
    global_federated_store,
)
from adapt_tpu_torch.utils.tracing import (
    export_spans,
    global_flight_recorder,
    global_tracer,
)

log = get_logger("remote")

#: The first word of the line a worker process prints on stdout once it
#: listens: ``listening HOST:PORT``.
LISTENING = "listening"

def _close(sock: socket.socket | None) -> None:
    """Close a socket, first shutting it down: a close alone does not wake
    a thread blocked reading it."""
    if sock is None:
        return
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


# --------------------------------------------------------------------------
# Worker-process side
# --------------------------------------------------------------------------


class RemoteStageServer:
    """Serves stage configure / execute for one device over TCP."""

    #: Bound on a forward-link send: a wedged next hop must error the
    #: request hub-ward, not freeze the serving thread.
    FWD_SEND_TIMEOUT_S = 15.0
    #: Purge a configure whose frames stopped arriving this long ago.
    CONFIG_IDLE_S = 300.0

    def __init__(self, port: int = 0, device=None, heartbeat_s: float = 0.5,
                 host: str = "127.0.0.1", allow_registry: bool = True,
                 telemetry_s: float = 2.0):
        """``device``: where stages run (None: the CUDA card).
        ``allow_registry=False`` serves only architecture-by-value
        configures (``graph_spec``). ``telemetry_s``: the cadence of the
        telemetry reports pushed on the dispatcher link (0 disables
        them); only that link carries them (two links pushing would
        split the deltas)."""
        if telemetry_s < 0:
            raise ValueError(f"telemetry_s must be >= 0, got {telemetry_s}")
        self.port = port
        self.host = host
        self.device = resolve_device(device)
        self.heartbeat_s = heartbeat_s
        self.allow_registry = allow_registry
        self._plans: dict[str, Any] = {}
        self._stages: dict[int, torch.nn.Module] = {}
        self._stage_gen: dict[int, int] = {}
        self._codec: codec_lib.Codec = codec_lib.get_codec("none")
        self._hung = False
        self._crashed = False
        #: Stage executions and their device work, one at a time: a stage
        #: module is not shared between threads running it at once.
        self._exec_lock = threading.Lock()
        #: stage -> {"next": (host, port) | None, "next_stage": int}.
        self._routes: dict[int, dict] = {}
        #: (host, port) -> (socket, send lock): persistent forward links.
        self._fwd: dict[tuple, tuple[socket.socket, threading.Lock]] = {}
        self._fwd_lock = threading.Lock()
        #: reply() of the dispatcher's connection: chain-tail results and
        #: chain errors go there, whichever link the data came in on.
        self._primary_reply = None
        self._srv: socket.socket | None = None
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        #: Stage executions served (all connections).
        self.executed = 0
        self.telemetry_s = telemetry_s
        #: How reports name this process (None: HOST:PORT; a gateway
        #: joiner uses its worker id). The proxy's ingest overrides it
        #: with the lease's worker id.
        self.telemetry_worker: str | None = None
        self._telemetry: TelemetryReporter | None = None
        if telemetry_s > 0:
            # Built here, not on a link's threads: the first report's
            # imports must not hold up the pings that keep the lease.
            from adapt_tpu_torch.runtime.capacity import stage_book

            self._telemetry = TelemetryReporter("stage", "")
            self._telemetry.capacity_provider = (
                lambda: stage_book(len(self._stages)))
        #: Encoded but undelivered reports (collect() consumes its
        #: window, so a dropped report would lose deltas): the newest 8,
        #: oldest sent first. The collector thread appends, the
        #: dispatcher link's ping thread sends.
        self._telemetry_backlog: list[tuple[int, bytes]] = []
        self._telemetry_lock = threading.Lock()
        self._telemetry_thread: threading.Thread | None = None
        self._stopped = threading.Event()

    # -- stages ----------------------------------------------------------------

    def _plan_for(self, cfg: dict):
        model_kwargs = dict(cfg.get("model_kwargs", {}))
        graph_spec = cfg.get("graph_spec")
        key = json.dumps([cfg.get("model"), graph_spec,
                          cfg.get("num_classes", 1000), cfg["cuts"],
                          model_kwargs], sort_keys=True)
        if key not in self._plans:
            if graph_spec is not None:
                from adapt_tpu_torch.graph.spec import graph_from_spec

                graph = graph_from_spec(graph_spec, device="meta")
            elif not self.allow_registry:
                raise RuntimeError(
                    "this worker serves architecture-by-value only "
                    "(--no-registry); send a graph_spec, not a model name")
            else:
                from adapt_tpu_torch.models import MODEL_REGISTRY

                factory, _ = MODEL_REGISTRY[cfg["model"]]
                if isinstance(model_kwargs.get("dtype"), str):
                    model_kwargs["dtype"] = getattr(torch,
                                                    model_kwargs["dtype"])
                graph = factory(num_classes=cfg.get("num_classes", 1000),
                                device="meta", **model_kwargs)
            self._plans[key] = partition(graph, cfg["cuts"])
        return self._plans[key]

    def _build_stage(self, cfg: dict, leaves: list) -> None:
        """Rebuild the stage (graph by registry name or by value, cut),
        build its module on the meta device, give it storage on this
        server's device and load the streamed arrays into it."""
        plan = self._plan_for(cfg)
        idx = cfg["stage_index"]
        if not 0 <= idx < plan.num_stages:
            raise ValueError(f"stage index {idx} out of range (plan has "
                             f"{plan.num_stages} stages)")
        spec = plan.stages[idx]
        module = plan.build_stage(spec, "meta")
        keys = stage_weight_keys({n: module.layers[n].state_dict()
                                  for n in spec.node_names})
        if len(leaves) != len(keys):
            raise ValueError(f"stage {idx}: got {len(leaves)} weight arrays, "
                             f"the stage has {len(keys)}")
        state: dict[str, dict[str, torch.Tensor]] = {
            n: {} for n in spec.node_names}
        for (node, name), leaf in zip(keys, leaves):
            state[node][name] = leaf
        module = module.to_empty(device=self.device)
        module.load_stage_state(state)
        module.eval()
        _wait_for_device(self.device)
        self._stages[idx] = module
        self._codec = codec_lib.get_codec(cfg.get("codec", "none"))

    # -- chain forward links ---------------------------------------------------

    def _fwd_connect(self, addr: tuple) -> tuple[socket.socket,
                                                 threading.Lock]:
        """Persistent forward link to the next chain worker; a drain thread
        discards the peer's pings on it."""
        with self._fwd_lock:
            entry = self._fwd.get(addr)
            if entry is not None:
                return entry
            sock = socket.create_connection(addr, timeout=5.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(self.FWD_SEND_TIMEOUT_S)
            entry = (sock, threading.Lock())
            self._fwd[addr] = entry

        def drain():
            try:
                while True:
                    recv_msg(sock)
            except (ConnectionError, OSError):
                self._fwd_drop(addr, sock)

        threading.Thread(target=drain, daemon=True).start()
        return entry

    def _fwd_drop(self, addr: tuple, sock: socket.socket) -> None:
        """Evict and close a forward link (after a failed send the stream
        is unusable: a later chain must re-dial)."""
        with self._fwd_lock:
            if self._fwd.get(addr) is not None and self._fwd[addr][0] is sock:
                del self._fwd[addr]
        _close(sock)

    def _fwd_gc(self) -> None:
        """Close the forward links no route references any more."""
        live = {r["next"] for r in self._routes.values() if r["next"]}
        with self._fwd_lock:
            dead = [(a, s) for a, (s, _) in self._fwd.items()
                    if a not in live]
        for addr, sock in dead:
            self._fwd_drop(addr, sock)

    # -- serving ---------------------------------------------------------------

    def _telemetry_loop(self) -> None:
        """Every ``telemetry_s`` while a dispatcher link exists: collect
        one report and queue it encoded, off the ping thread, so building
        a report never delays the pings that keep the lease alive."""
        while not self._stopped.wait(self.telemetry_s):
            if self._crashed:
                return
            if self._primary_reply is None:
                continue
            try:
                self._telemetry.worker = (self.telemetry_worker
                                          or f"{self.host}:{self.port}")
                report = self._telemetry.collect()
                # default=str: a non-JSON value degrades to its repr
                # instead of ending this worker's telemetry.
                blob = json.dumps(report, default=str).encode()
            except Exception:  # noqa: BLE001 — never end the reports
                log.exception("telemetry collect failed")
                continue
            with self._telemetry_lock:
                self._telemetry_backlog.append((int(report["seq"]), blob))
                del self._telemetry_backlog[:-8]

    def _send_telemetry(self, reply) -> None:
        """Send every queued report, oldest first (the store detects loss
        from sequence gaps); one that fails to send stays queued."""
        with self._telemetry_lock:
            while self._telemetry_backlog:
                seq, blob = self._telemetry_backlog[0]
                reply(Message(MSG_TELEMETRY, 0, seq, 0, blob))
                self._telemetry_backlog.pop(0)

    def _handle(self, conn: socket.socket) -> int:
        """Serve one connection until it closes; returns the number of
        messages it carried (0: the peer closed first, the shape of a
        rejected gateway join)."""
        with self._conns_lock:
            self._conns.add(conn)
        n_msgs = 0
        stop_ping = threading.Event()
        send_lock = threading.Lock()  # the ping thread writes here too

        def reply(msg: Message) -> None:
            with send_lock:
                send_msg(conn, msg)

        def ping_loop():
            # Queued reports ride the ping thread, so a worker whose
            # pings stop stops reporting too.
            while not stop_ping.wait(self.heartbeat_s):
                if self._crashed:
                    return
                try:
                    reply(Message(MSG_PING, 0, 0, 0, b""))
                    if (self._telemetry is not None
                            and self._primary_reply is reply):
                        self._send_telemetry(reply)
                except OSError:
                    return

        if self._telemetry is not None:
            with self._telemetry_lock:
                if self._telemetry_thread is None:
                    self._telemetry_thread = threading.Thread(
                        target=self._telemetry_loop, daemon=True)
                    self._telemetry_thread.start()
        threading.Thread(target=ping_loop, daemon=True).start()
        # (stage, generation) -> a configure being assembled.
        pending: dict[tuple[int, int], dict] = {}
        try:
            while not self._crashed:
                msg = recv_msg(conn)
                n_msgs += 1
                if pending:
                    now = time.monotonic()
                    for key in [k for k, e in pending.items()
                                if now - e["ts"] > self.CONFIG_IDLE_S]:
                        del pending[key]
                kind = msg.msg_type
                if kind == MSG_CONFIG:
                    self._primary_reply = reply
                    cfg = json.loads(payload_bytes(msg.payload).decode())
                    pending[(msg.stage_index, msg.request_id)] = {
                        "cfg": cfg, "arrays": {}, "ts": time.monotonic()}
                elif kind == MSG_SET_ROUTE:
                    self._primary_reply = reply
                    self._set_route(reply, msg)
                elif kind == MSG_CONFIG_ARRAY:
                    entry = pending.get((msg.stage_index, msg.request_id))
                    if entry is not None:
                        entry["arrays"][msg.attempt] = codec_lib.unpack(
                            msg.payload, device="cpu")
                        entry["ts"] = time.monotonic()
                elif kind == MSG_CONFIG_END:
                    self._config_end(
                        reply, msg,
                        pending.pop((msg.stage_index, msg.request_id), None))
                elif kind == MSG_UNCONFIGURE:
                    gen = msg.request_id
                    pending.pop((msg.stage_index, gen), None)
                    # Only the revoked generation's install goes (gen 0:
                    # whatever is there): a newer binding survives.
                    if gen == 0 or self._stage_gen.get(msg.stage_index) == gen:
                        self._stages.pop(msg.stage_index, None)
                        self._stage_gen.pop(msg.stage_index, None)
                elif kind == MSG_HELLO_ACK:
                    continue
                elif kind in (MSG_DATA, MSG_DATA_CHAINED):
                    if not self._hung:
                        self._execute(reply, msg)
                elif kind == MSG_PROBE:
                    if not self._hung:
                        reply(Message(MSG_PROBE_ACK, msg.stage_index,
                                      msg.request_id, msg.attempt, b""))
                elif kind == MSG_KILL:
                    mode = payload_bytes(msg.payload).decode()
                    log.warning("remote worker kill: %s", mode)
                    if mode == "hang":
                        self._hung = True
                    else:
                        self._crashed = True
                        break
        except (ConnectionError, OSError):
            pass
        finally:
            stop_ping.set()
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()
        return n_msgs

    def _set_route(self, reply, msg: Message) -> None:
        try:
            info = json.loads(payload_bytes(msg.payload).decode())
            if info.get("clear"):
                self._routes.pop(msg.stage_index, None)
            else:
                nxt = info.get("next")
                route = {"next": tuple(nxt) if nxt else None,
                         "next_stage": info.get("next_stage", -1)}
                if route["next"] is not None:
                    # Pre-dial: an unreachable next hop fails the install.
                    self._fwd_connect(route["next"])
                self._routes[msg.stage_index] = route
            self._fwd_gc()
            reply(Message(MSG_ACK, msg.stage_index, msg.request_id, 0, b""))
        except Exception as e:  # noqa: BLE001 — reported to the proxy
            log.error("route install failed: %s", e)
            reply(Message(MSG_CONFIG_ERR, msg.stage_index, msg.request_id, 0,
                          str(e).encode()))

    def _config_end(self, reply, msg: Message, entry: dict | None) -> None:
        try:
            if entry is None:
                raise RuntimeError(
                    f"CONFIG_END for unknown configure "
                    f"{(msg.stage_index, msg.request_id)}")
            cfg, arrays = entry["cfg"], entry["arrays"]
            n = cfg["n_arrays"]
            if len(arrays) != n:
                raise RuntimeError(f"stage {msg.stage_index}: received "
                                   f"{len(arrays)}/{n} weight arrays")
            with self._exec_lock:
                self._build_stage(cfg, [arrays[i] for i in range(n)])
            self._stage_gen[msg.stage_index] = msg.request_id
            reply(Message(MSG_ACK, msg.stage_index, msg.request_id, 0, b""))
        except Exception as e:  # noqa: BLE001 — reported to the proxy
            log.error("remote configure failed: %s", e)
            reply(Message(MSG_CONFIG_ERR, msg.stage_index, msg.request_id, 0,
                          str(e).encode()))

    def _execute(self, reply, msg: Message) -> None:
        # Routes bind to the frame type: hub-path MSG_DATA ignores them.
        # Chain errors go hub-ward (the upstream peer's link is drained
        # unread).
        chained = msg.msg_type == MSG_DATA_CHAINED
        route = self._routes.get(msg.stage_index) if chained else None
        err_reply = (self._primary_reply or reply) if chained else reply
        try:
            if chained and route is None:
                raise RuntimeError(
                    f"chained frame for stage {msg.stage_index} arrived "
                    "after its route was cleared")
            t_exec = time.perf_counter()
            with global_tracer().span(
                    "remote.stage_exec", request=msg.request_id,
                    attempt=msg.attempt, stage=msg.stage_index) as sp:
                with self._exec_lock, torch.no_grad():
                    module = self._stages.get(msg.stage_index)
                    if module is None:
                        raise RuntimeError(
                            f"stage {msg.stage_index} not configured")
                    x = codec_lib.unpack(msg.payload, device=self.device)
                    y = module(x.to(self.device))
                    # int8dev quantizes on the card before the fetch; the
                    # host codecs fetch y once.
                    out = codec_lib.pack_frames(self._codec, y)
                    _wait_for_device(self.device)
                    self.executed += 1
            global_metrics().inc("remote.stage_execs")
            global_metrics().observe("remote.stage_exec_s",
                                     time.perf_counter() - t_exec)
            global_flight_recorder().record(
                "remote_exec", request=msg.request_id,
                stage=msg.stage_index, attempt=msg.attempt)
            annex = None
            if sp is not None or msg.annex:
                # Mid-chain hops accumulate spans; a corrupt inbound annex
                # only drops the upstream spans.
                acc = []
                if msg.annex:
                    try:
                        parsed = json.loads(msg.annex.decode())
                        if isinstance(parsed, list):
                            acc = parsed
                    except (ValueError, UnicodeDecodeError):
                        pass
                acc.extend(export_spans([sp]))
                annex = json.dumps(acc).encode()
            result = Message(MSG_RESULT, msg.stage_index, msg.request_id,
                             msg.attempt, out, annex=annex)
            if route is None:
                reply(result)
            elif route["next"] is None:
                (self._primary_reply or reply)(result)  # the chain's tail
            else:
                sock, lock = self._fwd_connect(route["next"])
                try:
                    with lock:
                        send_msg(sock, Message(
                            MSG_DATA_CHAINED, route["next_stage"],
                            msg.request_id, msg.attempt, out, annex=annex))
                except (TimeoutError, OSError):
                    self._fwd_drop(route["next"], sock)
                    raise
        except Exception as e:  # noqa: BLE001 — reported hub-ward
            try:
                err_reply(Message(MSG_ERROR, msg.stage_index, msg.request_id,
                                  msg.attempt, str(e).encode()))
            except Exception:  # noqa: BLE001
                log.warning("could not report an execute error hub-ward")

    def listen(self) -> int:
        """Bind and listen (port 0: any free port); returns the port."""
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.host, self.port))
        srv.listen(16)
        self._srv = srv
        self.port = srv.getsockname()[1]
        log.info("remote stage server on %s:%d (%s)", self.host, self.port,
                 self.device)
        return self.port

    def serve_forever(self) -> None:
        """Accept connections (a thread each: chain peers dial in while the
        dispatcher's link is in service) until crashed or shut down."""
        if self._srv is None:
            self.listen()
        srv = self._srv
        srv.settimeout(0.5)
        while not self._crashed:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()
        srv.close()

    def shutdown(self) -> None:
        """Stop serving: close the listening socket and every connection
        (an in-process server's end; a process just exits)."""
        self._crashed = True
        self._stopped.set()
        with self._conns_lock:
            conns = list(self._conns)
        for sock in [self._srv, *conns]:
            _close(sock)

    def connect_and_serve(self, address: tuple[str, int], worker_id: str,
                          retries: int = 20, secret: str | None = None,
                          join_retries: int = 8) -> None:
        """Join a running pipeline: dial its ``WorkerGateway``, announce
        MSG_HELLO ``{worker_id[, secret][, listen]}`` (``listen``: this
        server's address when it also listens), then serve that
        connection. A rejected join shows as the gateway closing the link
        before any message; joins retry (a redial can race the gateway's
        stale proxy of the same id) and a real rejection raises."""
        # A joiner knows its fleet identity: its reports carry it.
        self.telemetry_worker = worker_id
        for attempt in range(join_retries):
            last: Exception | None = None
            for _ in range(retries):
                try:
                    conn = socket.create_connection(address, timeout=5.0)
                    break
                except OSError as e:
                    last = e
                    time.sleep(0.25)
            else:
                raise ConnectionError(
                    f"cannot reach gateway at {address}: {last}")
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(None)  # serving sends block, as on dial-in
            info: dict[str, Any] = {"worker_id": worker_id}
            if secret is not None:
                info["secret"] = secret
            if self._srv is not None:
                info["listen"] = [self.host, self.port]
            send_msg(conn, Message(MSG_HELLO, 0, 0, 0,
                                   json.dumps(info).encode()))
            log.info("dialed gateway %s:%d as %s", *address, worker_id)
            if self._handle(conn) > 0 or self._crashed:
                return
            log.warning("gateway closed the join as %s without serving, "
                        "attempt %d/%d", worker_id, attempt + 1, join_retries)
            time.sleep(1.0)
        raise ConnectionError(f"gateway refused join as {worker_id!r} after "
                              f"{join_retries} attempts")


# --------------------------------------------------------------------------
# Dispatcher side
# --------------------------------------------------------------------------


class RemoteWorkerProxy:
    """Drives a RemoteStageServer; presents the StageWorker interface."""

    def __init__(self, worker_id: str, address: tuple[str, int],
                 registry: WorkerRegistry, result_queue, model_config: dict,
                 codec_name: str = "none", weights_codec: str = "lz",
                 fault: FaultConfig | None = None,
                 sock: socket.socket | None = None,
                 blob_cache: dict | None = None, result_device=None,
                 listen: tuple[str, int] | None = None):
        """``sock``: an already-connected socket (the gateway path); when
        None, :meth:`start` dials ``address``. ``blob_cache``: a dict
        shared across proxies, so a stage's packed weights are compressed
        once. ``result_device``: where ``int8dev`` results are dequantized
        (None: the CUDA card); the host codecs' results stay on the CPU.
        ``listen``: the worker's own listen address, when a gateway joiner
        announced one."""
        self.worker_id = worker_id
        self.address = tuple(address)
        self._chain_addr = (tuple(listen) if listen is not None
                            else self.address if sock is None else None)
        #: MSG_RESULT / MSG_ERROR frames this link delivered, and their
        #: payload bytes; the payload bytes of the data frames it sent.
        self.results_received = 0
        self.result_bytes_received = 0
        self.bytes_sent = 0
        self._registry = registry
        self._results = result_queue
        self._fault = fault or FaultConfig()
        self._model_config = model_config
        self._wcodec = codec_lib.get_codec(weights_codec)
        self.set_codec(codec_name)
        self._result_device = result_device
        self._sock: socket.socket | None = sock
        self._send_lock = threading.Lock()
        self._configured: dict[int, int] = {}  # stage -> newest generation
        self._config_gen = itertools.count(1)
        self._blob_cache = blob_cache
        self._ack_lock = threading.Lock()
        self._config_acks: dict[tuple[int, int], threading.Event] = {}
        self._config_errors: dict[tuple[int, int], str] = {}
        self._inflight_count = 0
        #: (stage, request, attempt) submits counted into _inflight_count:
        #: the only results allowed to decrement it (a chain tail delivers
        #: results of requests the head's proxy submitted).
        self._counted: set[tuple[int, int, int]] = set()
        self._count_lock = threading.Lock()
        self._stop = threading.Event()
        self._reader: threading.Thread | None = None
        self._lease_token = None

    def set_codec(self, codec_name: str) -> None:
        """Use ``codec_name`` for activations from now on. The server takes
        its output codec from a configure, so the stages this proxy had
        configured count as unconfigured until configured again."""
        self._codec = codec_lib.get_codec(codec_name)
        self._codec_name = codec_name
        self._configured = {}

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "RemoteWorkerProxy":
        """Dial (unless connected), register the lease, start the reader.
        Idempotent: recovery dials proxies before ``Dispatcher.start``."""
        if self._reader is not None:
            return self
        if self._sock is None:
            deadline = time.monotonic() + self._fault.startup_wait_s
            last: Exception | None = None
            while time.monotonic() < deadline:
                try:
                    self._sock = socket.create_connection(self.address,
                                                          timeout=5.0)
                    self._sock.setsockopt(socket.IPPROTO_TCP,
                                          socket.TCP_NODELAY, 1)
                    break
                except OSError as e:
                    last = e
                    time.sleep(0.1)
            if self._sock is None:
                raise ConnectionError(
                    f"cannot reach remote worker at {self.address}: {last}")
        # The timeout bounds blocked sends; reads retry through it.
        self._sock.settimeout(self._fault.send_timeout_s)
        self._lease_token = self._registry.register(
            self.worker_id,
            meta={"address": f"{self.address[0]}:{self.address[1]}"},
            ttl_s=self._fault.lease_ttl_s)
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"{self.worker_id}-reader",
                                        daemon=True)
        self._reader.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        _close(self._sock)
        if self._reader is not None:
            self._reader.join(timeout=2.0)
        self._registry.deregister(self.worker_id, token=self._lease_token)

    def _mark_dead(self, why: str) -> None:
        """Drop the link (a partial send leaves the stream unknowable) and
        deregister at once, so membership re-dispatches its work now."""
        if self._stop.is_set():
            return
        log.warning("remote %s link dropped: %s", self.worker_id, why)
        self._stop.set()
        _close(self._sock)
        self._registry.deregister(self.worker_id, token=self._lease_token)

    def _send(self, msg: Message, lock_timeout: float | None = None) -> None:
        """Bounded send: the channel-lock wait and the socket write are
        time-limited (``FaultConfig.send_timeout_s``). A lock timeout keeps
        the link; a socket timeout drops it."""
        if self._stop.is_set():
            raise ConnectionError(f"remote worker {self.worker_id} link is "
                                  "down")
        timeout = (self._fault.send_timeout_s if lock_timeout is None
                   else lock_timeout)
        if not self._send_lock.acquire(timeout=timeout):
            raise TimeoutError(
                f"{self.worker_id} send channel busy for {timeout}s")
        try:
            send_msg(self._sock, msg)
        except TimeoutError:
            self._mark_dead("send timed out (peer not draining)")
            raise ConnectionError(f"send to {self.worker_id} timed out; "
                                  "link dropped") from None
        except OSError as e:
            self._mark_dead(f"send failed: {e}")
            raise
        finally:
            self._send_lock.release()

    # -- StageWorker interface -------------------------------------------------

    @property
    def state(self) -> WorkerState:
        if self._stop.is_set():
            return WorkerState.DEAD
        with self._count_lock:
            return (WorkerState.BUSY if self._inflight_count
                    else WorkerState.IDLE)

    @property
    def queue_depth(self) -> int:
        with self._count_lock:
            return self._inflight_count

    def is_configured(self, stage_index: int) -> bool:
        return stage_index in self._configured

    def configure(self, stage_index: int, module, host_state, spec=None,
                  abort=None) -> int:
        """Ship the model recipe + stage index + codec, then the stage's
        weights one array a frame (``stage_weight_keys`` order), then the
        end frame, and wait for the generation's ACK. ``module`` is not
        used: the server builds its own. Returns the generation."""
        del module, spec
        if self._stop.is_set():
            raise ConnectionError(f"remote worker {self.worker_id} link is "
                                  "down")
        gen = next(self._config_gen)
        key = (stage_index, gen)
        cache_key = (stage_index, self._wcodec.name)
        blobs = (self._blob_cache.get(cache_key)
                 if self._blob_cache is not None else None)
        if blobs is None:
            blobs = [codec_lib.pack(self._wcodec, host_state[n][k])
                     for n, k in stage_weight_keys(host_state)]
            if self._blob_cache is not None:
                self._blob_cache[cache_key] = blobs
        header = json.dumps({**self._model_config, "stage_index": stage_index,
                             "codec": self._codec_name,
                             "n_arrays": len(blobs)}).encode()
        ack = threading.Event()
        with self._ack_lock:
            self._config_acks[key] = ack
        end_sent = False
        try:
            self._send(Message(MSG_CONFIG, stage_index, gen, 0, header))
            for i, blob in enumerate(blobs):
                if abort is not None and abort():
                    raise RuntimeError(f"configure of stage {stage_index} "
                                       "aborted mid-stream (caller timed out)")
                self._send(Message(MSG_CONFIG_ARRAY, stage_index, gen, i,
                                   blob))
            end_sent = True
            self._send(Message(MSG_CONFIG_END, stage_index, gen, 0, b""))
            if not ack.wait(self._fault.configure_timeout_s):
                raise TimeoutError(f"no config ACK for stage {stage_index} "
                                   f"(gen {gen}) from {self.worker_id}")
            with self._ack_lock:
                err = self._config_errors.pop(key, None)
            if err is not None:
                raise RuntimeError(f"remote configure failed: {err}")
            if abort is not None and abort():
                raise RuntimeError(f"configure of stage {stage_index} "
                                   "aborted (caller timed out)")
            self._configured[stage_index] = max(
                self._configured.get(stage_index, 0), gen)
            return gen
        except BaseException:
            # The server may install this generation after we gave up on
            # it: revoke it (generation-scoped, a newer binding survives).
            if end_sent:
                try:
                    self._send(Message(MSG_UNCONFIGURE, stage_index, gen, 0,
                                       b""))
                except Exception:  # noqa: BLE001 — the link may be down
                    pass
            raise
        finally:
            with self._ack_lock:
                self._config_acks.pop(key, None)
                self._config_errors.pop(key, None)

    @property
    def chain_address(self) -> tuple[str, int] | None:
        """Where a chain peer (or a recovering dispatcher) can dial this
        worker: its listen address, or None when unknown."""
        return self._chain_addr

    def send_route(self, stage_index: int,
                   next_addr: tuple[str, int] | None, next_stage: int = -1,
                   clear: bool = False) -> None:
        """Install (waiting for the ACK) or clear (fire and forget) the
        worker's next hop for ``stage_index``; ``next_addr=None`` without
        ``clear`` marks the chain's tail."""
        gen = next(self._config_gen)
        key = (stage_index, gen)
        payload = json.dumps(
            {"clear": True} if clear else
            {"next": list(next_addr) if next_addr else None,
             "next_stage": next_stage}).encode()
        if clear:
            self._send(Message(MSG_SET_ROUTE, stage_index, gen, 0, payload),
                       lock_timeout=1.0)
            return
        ack = threading.Event()
        with self._ack_lock:
            self._config_acks[key] = ack
        try:
            self._send(Message(MSG_SET_ROUTE, stage_index, gen, 0, payload))
            if not ack.wait(self._fault.configure_timeout_s):
                raise TimeoutError(f"no route ACK for stage {stage_index} "
                                   f"from {self.worker_id}")
            with self._ack_lock:
                err = self._config_errors.pop(key, None)
            if err is not None:
                raise RuntimeError(f"route install failed: {err}")
        finally:
            with self._ack_lock:
                self._config_acks.pop(key, None)
                self._config_errors.pop(key, None)

    def unconfigure(self, stage_index: int,
                    generation: int | None = None) -> None:
        """Drop the stage binding here and on the remote (with
        ``generation``, only that configure's)."""
        if generation is None or self._configured.get(stage_index) == \
                generation:
            self._configured.pop(stage_index, None)
        try:
            self._send(Message(MSG_UNCONFIGURE, stage_index, generation or 0,
                               0, b""))
        except Exception:  # noqa: BLE001 — best effort
            pass

    def submit(self, task) -> None:
        if task.stage_index < 0:
            # Canary probe: no payload, no in-flight count, a short lock
            # wait (the watchdog re-probes a dropped one).
            self._send(Message(MSG_PROBE, task.stage_index, task.request_id,
                               task.attempt, b""), lock_timeout=1.0)
            return
        # The payload as it lies: int8dev quantizes on its card before the
        # fetch; the host codecs fetch it.
        payload = codec_lib.pack_frames(self._codec, task.payload)
        self.bytes_sent += codec_lib.frames_nbytes(payload)
        if task.chained:
            # The result comes back on the tail's link: not counted here.
            self._send(Message(MSG_DATA_CHAINED, task.stage_index,
                               task.request_id, task.attempt, payload))
            return
        key = (task.stage_index, task.request_id, task.attempt)
        with self._count_lock:
            self._inflight_count += 1
            self._counted.add(key)
        try:
            self._send(Message(MSG_DATA, task.stage_index, task.request_id,
                               task.attempt, payload))
        except Exception:
            self._uncount(key)
            raise

    def _uncount(self, key: tuple[int, int, int]) -> None:
        with self._count_lock:
            if key in self._counted:
                self._counted.discard(key)
                self._inflight_count = max(0, self._inflight_count - 1)

    def kill(self, mode: str = "crash") -> None:
        self._send(Message(MSG_KILL, 0, 0, 0, mode.encode()))

    # -- internals -------------------------------------------------------------

    def _read_loop(self) -> None:
        while not self._stop.is_set():
            try:
                msg = recv_msg(self._sock)
            except (ConnectionError, OSError):
                break
            kind = msg.msg_type
            if kind == MSG_PING:
                self._registry.heartbeat(self.worker_id,
                                         ttl_s=self._fault.lease_ttl_s)
            elif kind == MSG_TELEMETRY:
                # The worker's report, federated under this lease's worker
                # id (the report knows only its port). A malformed report
                # is counted and never ends the read loop.
                try:
                    global_federated_store().ingest(
                        json.loads(payload_bytes(msg.payload).decode()),
                        worker=self.worker_id)
                    global_metrics().inc("fleet.reports_total")
                except Exception:  # noqa: BLE001
                    global_metrics().inc("fleet.report_rejected_total")
            elif kind == MSG_PROBE_ACK:
                self._results.put(TaskResult(
                    request_id=msg.request_id, stage_index=msg.stage_index,
                    attempt=msg.attempt, worker_id=self.worker_id))
            elif kind in (MSG_ACK, MSG_CONFIG_ERR):
                key = (msg.stage_index, msg.request_id)
                with self._ack_lock:
                    if kind == MSG_CONFIG_ERR:
                        self._config_errors[key] = payload_bytes(
                            msg.payload).decode()
                    ev = self._config_acks.get(key)
                if ev is not None:
                    ev.set()
            elif kind in (MSG_RESULT, MSG_ERROR):
                self._on_result(msg)
        self._mark_dead("connection closed")
        # Unblock configures still waiting for an ACK that cannot come.
        with self._ack_lock:
            for key, ev in self._config_acks.items():
                self._config_errors.setdefault(key, "link down")
                ev.set()

    def _on_result(self, msg: Message) -> None:
        self.results_received += 1
        self.result_bytes_received += len(msg.payload)
        if msg.annex and global_tracer().enabled:
            try:
                global_tracer().ingest(json.loads(msg.annex.decode()))
            except (ValueError, UnicodeDecodeError):
                global_metrics().inc("tracer.ingest_rejected")
        self._uncount((msg.stage_index, msg.request_id, msg.attempt))
        result = TaskResult(request_id=msg.request_id,
                            stage_index=msg.stage_index, attempt=msg.attempt,
                            worker_id=self.worker_id)
        if msg.msg_type == MSG_ERROR:
            result.error = payload_bytes(msg.payload).decode()
        else:
            try:
                result.output = codec_lib.unpack(msg.payload,
                                                 device=self._result_device)
            except Exception as e:  # noqa: BLE001 — a bad frame fails
                result.error = f"result decode failed: {e}"  # the task
        self._results.put(result)


class WorkerGateway:
    """Dispatcher-side listener for worker-initiated joins: a worker dials
    it (``python -m adapt_tpu_torch.comm.remote --connect HOST:PORT``) and
    announces MSG_HELLO; the gateway wraps the socket in a
    :class:`RemoteWorkerProxy`, registers its lease and attaches it to the
    dispatcher, so the pool can grow at run time. Activation and weights
    codecs come from the dispatcher's ``ServeConfig.codec``.

    A joiner naming a worker id that is live is rejected, and with a
    ``secret`` the HELLO must carry it (constant-time compare)."""

    #: Hard deadline on a joiner's HELLO: the accept loop is serial.
    HELLO_TIMEOUT_S = 10.0

    def __init__(self, dispatcher, model_config: dict,
                 host: str = "127.0.0.1", port: int = 0,
                 secret: str | None = None, result_device=None):
        self._dispatcher = dispatcher
        self._model_config = model_config
        self._secret = secret
        self._result_device = result_device
        codec_cfg = dispatcher.config.codec
        self._codec_name = codec_cfg.name
        self._weights_codec = codec_cfg.weights
        self._fault = dispatcher.config.fault
        self._host = host
        self._port = port
        self._srv: socket.socket | None = None
        self._stop = threading.Event()
        self._accept_thread: threading.Thread | None = None
        self._proxies: list[RemoteWorkerProxy] = []
        self._proxies_lock = threading.Lock()
        self._blob_cache: dict = {}

    @property
    def port(self) -> int:
        return self._port

    @property
    def proxies(self) -> list[RemoteWorkerProxy]:
        """The live joined workers' proxies, in join order."""
        with self._proxies_lock:
            return [p for p in self._proxies if not p._stop.is_set()]

    def start(self) -> "WorkerGateway":
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self._host, self._port))
        self._srv.listen(16)
        self._port = self._srv.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="gateway-accept", daemon=True)
        self._accept_thread.start()
        log.info("worker gateway listening on %s:%d", self._host, self._port)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        with self._proxies_lock:
            proxies = list(self._proxies)
        for p in proxies:
            p.stop()

    def _accept_loop(self) -> None:
        self._srv.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                self._join(conn, addr)
            except Exception as e:  # noqa: BLE001 — a bad joiner can't
                log.warning("gateway join from %s failed: %s", addr, e)
                try:  # kill the loop
                    conn.close()
                except OSError:
                    pass

    def _join(self, conn: socket.socket, addr) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.settimeout(self.HELLO_TIMEOUT_S)
        msg = recv_msg(conn, retry_on_timeout=False)
        if msg.msg_type != MSG_HELLO:
            raise ValueError(f"expected HELLO, got msg type {msg.msg_type}")
        info = json.loads(payload_bytes(msg.payload).decode())
        worker_id = info["worker_id"]
        if self._secret is not None and not hmac.compare_digest(
                str(info.get("secret", "")), self._secret):
            raise ValueError("join rejected: bad or missing gateway secret")
        if worker_id in self._dispatcher.registry.alive():
            raise ValueError(f"join rejected: worker_id {worker_id!r} is "
                             "currently live")
        listen = info.get("listen")
        proxy = RemoteWorkerProxy(
            worker_id, addr, self._dispatcher.registry,
            self._dispatcher.result_queue, model_config=self._model_config,
            codec_name=self._codec_name, weights_codec=self._weights_codec,
            fault=self._fault, sock=conn, blob_cache=self._blob_cache,
            result_device=self._result_device,
            listen=tuple(listen) if listen else None)
        proxy.start()  # registers the lease: the registry's join fires
        self._dispatcher.attach_worker(proxy)
        proxy._send(Message(MSG_HELLO_ACK, 0, 0, 0, b""))
        with self._proxies_lock:
            self._proxies = [p for p in self._proxies
                             if not p._stop.is_set()]
            self._proxies.append(proxy)
        log.info("worker %s joined via gateway (%s)", worker_id, addr)
        global_metrics().inc("gateway.joins")


def main(argv=None) -> None:
    """``python -m adapt_tpu_torch.comm.remote``:

    - ``--port P``: listen, for a dispatcher to dial in (and chain peers);
      ``P = 0`` takes a free port; the process prints ``listening
      HOST:PORT`` once it listens;
    - ``--connect HOST:PORT``: join a running pipeline's gateway;
    - both: join, announcing the listen port (a chain member a journal can
      re-adopt); the process keeps serving the port after the session.

    ``--device`` picks the stage device (default: the CUDA card; ``cpu``
    only when asked for); ``--no-tf32`` keeps f32 stages in full f32."""
    import argparse
    import os

    p = argparse.ArgumentParser(prog="python -m adapt_tpu_torch.comm.remote")
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--connect", default=None, metavar="HOST:PORT",
                   help="dial a dispatcher's WorkerGateway and join its pool")
    p.add_argument("--worker-id", default=None)
    p.add_argument("--device", default=None,
                   help="cuda:N or cpu (default: the CUDA card)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--heartbeat", type=float, default=0.5)
    p.add_argument("--telemetry-s", type=float, default=2.0,
                   help="telemetry report cadence on the dispatcher link "
                   "(seconds; 0 disables the reports)")
    p.add_argument("--secret",
                   default=os.environ.get("ADAPT_TPU_GATEWAY_SECRET"),
                   help="gateway join secret (or env "
                   "ADAPT_TPU_GATEWAY_SECRET)")
    p.add_argument("--no-registry", action="store_true",
                   help="serve only architecture-by-value (graph_spec) "
                   "configures, never the model registry")
    p.add_argument("--no-tf32", action="store_true",
                   help="f32 matmuls and convolutions in full f32 (torch "
                   "lets cuDNN use TF32 by default): for a dispatcher that "
                   "turned TF32 off and expects f32 stages to match it")
    args = p.parse_args(argv)
    if args.port is None and args.connect is None:
        p.error("one of --port / --connect is required")
    if args.telemetry_s < 0:
        p.error(f"--telemetry-s must be >= 0, got {args.telemetry_s}")
    if args.no_tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    server = RemoteStageServer(args.port or 0, device=args.device,
                               heartbeat_s=args.heartbeat, host=args.host,
                               allow_registry=not args.no_registry,
                               telemetry_s=args.telemetry_s)
    serving = None
    if args.port is not None:
        server.listen()
        # The bound address (--port 0 takes any free port), for whoever
        # started this process.
        print(f"{LISTENING} {server.host}:{server.port}", flush=True)
        if args.connect is None:
            server.serve_forever()
            return
        serving = threading.Thread(target=server.serve_forever, daemon=True)
        serving.start()
    host, _, port = args.connect.rpartition(":")
    server.connect_and_serve((host, int(port)),
                             args.worker_id or f"remote-{os.getpid()}",
                             secret=args.secret)
    if serving is not None and not server._crashed:
        serving.join()


if __name__ == "__main__":
    main()
