"""Wire framing for cross-process messages.

Counterpart of ``adapt_tpu/comm/framing.py``, byte for byte: an 8-byte
big-endian length prefix, then a typed header (message type, stage index,
request id, attempt, a flags byte), then the optional annexes and the
payload. Either package parses the other's frames.

- **Send** is a scatter write: ``Message.payload`` may be bytes, any
  buffer, or a list of buffer parts (``codec.pack_frames``), and
  :func:`send_msg` hands ``[prefix + header, *parts]`` to
  ``socket.sendmsg``: the payload is never joined on the host.
- **Receive** lands each frame in one pre-sized ``bytearray`` through
  ``recv_into``; ``Message.payload`` is a memoryview of it, which
  ``codec.unpack`` decodes without a copy. :func:`payload_bytes` gives
  real ``bytes`` for the small JSON control payloads.

Annexes ride length-prefixed ahead of the payload, so the payload stays
one contiguous view: ``FLAG_TRACE_ANNEX`` carries the spans a remote
worker recorded for the request (``utils.tracing.export_spans``),
``FLAG_PAGE_ANNEX`` the page-range description of a KV-page handoff.

The message types are one namespace shared with ``comm.remote``: 1-5
here, 6-17 the remote stage protocol, 18 the KV-page handoff, 19 the
telemetry report. All are defined here so the type bytes cannot collide.
"""

from __future__ import annotations

import socket
import struct
from dataclasses import dataclass
from typing import Any

MSG_DATA = 1
MSG_CONFIG = 2
MSG_RESULT = 3
MSG_ACK = 4
MSG_ERROR = 5
#: Fault injection: payload ``b"crash"`` or ``b"hang"``.
MSG_KILL = 6
#: Server-initiated transport heartbeat.
MSG_PING = 7
MSG_CONFIG_ERR = 8
#: Dispatcher-initiated canary probe and its answer: the answer comes from
#: the serve loop itself, so a hung server misses it.
MSG_PROBE = 9
MSG_PROBE_ACK = 10
#: Streamed configure: MSG_CONFIG carries the JSON header (generation in
#: ``request_id``), then one MSG_CONFIG_ARRAY per weight (``attempt`` =
#: its index), then MSG_CONFIG_END.
MSG_CONFIG_ARRAY = 11
MSG_CONFIG_END = 12
#: Worker-initiated join through a ``WorkerGateway`` and its answer.
MSG_HELLO = 13
MSG_HELLO_ACK = 14
#: Drop a stage binding; ``request_id`` is the generation to revoke (0:
#: whatever is installed).
MSG_UNCONFIGURE = 15
#: Install or clear a stage's direct next hop (chain forwarding).
MSG_SET_ROUTE = 16
#: Chain-routed data: routes apply to this type only.
MSG_DATA_CHAINED = 17
#: KV-page handoff (disaggregated serving; not used by this package yet).
MSG_KV_PAGES = 18
#: Telemetry report (not sent by this package yet: ROADMAP.md item 9).
MSG_TELEMETRY = 19

#: header: type, stage_index (signed: probes use stage -1), request_id
#: (signed: probe ids are negative), attempt, flags.
_HEADER = struct.Struct(">BiqIB")
_LEN = struct.Struct(">Q")
_ANNEX_LEN = struct.Struct(">I")

FLAG_TRACE_ANNEX = 0x01
FLAG_PAGE_ANNEX = 0x02

ACK_BYTE = b"\x06"


def _byte_view(part) -> memoryview:
    mv = part if isinstance(part, memoryview) else memoryview(part)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    return mv


def _payload_parts(payload) -> list[memoryview]:
    """A payload (bytes, a buffer, or a list of either) as flat byte views
    for the scatter send; empty parts dropped."""
    if isinstance(payload, (list, tuple)):
        return [v for v in map(_byte_view, payload) if v.nbytes]
    mv = _byte_view(payload)
    return [mv] if mv.nbytes else []


def payload_bytes(payload) -> bytes:
    """A received (or multi-part) payload as bytes: for small control
    payloads, not the data path."""
    if isinstance(payload, bytes):
        return payload
    if isinstance(payload, (list, tuple)):
        return b"".join(bytes(_byte_view(p)) for p in payload)
    return bytes(_byte_view(payload))


@dataclass(frozen=True)
class Message:
    msg_type: int
    stage_index: int
    request_id: int
    attempt: int
    #: bytes or a memoryview on receive; any buffer or a list of buffer
    #: parts on send.
    payload: Any
    #: Serialized trace spans; the flags byte is derived from its presence.
    annex: bytes | None = None
    #: Page-range blob of a KV-page handoff; same rule.
    page_annex: bytes | None = None


def _sendmsg_all(sock: socket.socket, parts: list[memoryview]) -> None:
    """``sendall`` over ``socket.sendmsg``: a send may write any prefix of
    the gather list, so loop, advancing the views."""
    while parts:
        try:
            sent = sock.sendmsg(parts)
        except AttributeError:  # a socket double without sendmsg
            for p in parts:
                sock.sendall(p)
            return
        while parts and sent >= parts[0].nbytes:
            sent -= parts[0].nbytes
            parts.pop(0)
        if sent:
            parts[0] = parts[0][sent:]


def frame_parts(msg: Message) -> list[memoryview]:
    """The frame as scatter-write parts, ``[length prefix + header (+
    annexes), *payload views]``: the pure half of :func:`send_msg`. The
    views alias the caller's buffers."""
    parts = _payload_parts(msg.payload)
    flags = 0
    head_extra = b""
    if msg.annex is not None:
        flags |= FLAG_TRACE_ANNEX
        head_extra += _ANNEX_LEN.pack(len(msg.annex)) + msg.annex
    if msg.page_annex is not None:
        flags |= FLAG_PAGE_ANNEX
        head_extra += _ANNEX_LEN.pack(len(msg.page_annex)) + msg.page_annex
    total = _HEADER.size + len(head_extra) + sum(p.nbytes for p in parts)
    header = _LEN.pack(total) + _HEADER.pack(
        msg.msg_type, msg.stage_index, msg.request_id, msg.attempt, flags
    ) + head_extra
    return [memoryview(header), *parts]


def send_msg(sock: socket.socket, msg: Message) -> None:
    """One gather write of the whole frame."""
    _sendmsg_all(sock, frame_parts(msg))


def _recv_exact_into(sock: socket.socket, buf: memoryview,
                     retry_on_timeout: bool = True) -> None:
    n, off = buf.nbytes, 0
    while off < n:
        try:
            got = sock.recv_into(buf[off:], min(n - off, 1 << 20))
        except TimeoutError:
            if retry_on_timeout:
                # A socket timeout bounds sends; a read keeps its partial
                # frame and retries (abandoning it would desync the
                # stream; liveness is the lease's and watchdog's job).
                continue
            raise
        if not got:
            raise ConnectionError("peer closed mid-frame")
        off += got


def parse_frame(buf) -> Message:
    """One frame body (everything after the length prefix) as a
    :class:`Message` whose payload is a memoryview of ``buf``; the pure
    half of :func:`recv_msg`."""
    total = len(buf)
    if total < _HEADER.size:
        raise ConnectionError(f"short frame: {total}")
    msg_type, stage_index, request_id, attempt, flags = _HEADER.unpack_from(
        buf)
    off = _HEADER.size

    def annex_at(off: int) -> tuple[bytes, int]:
        if total < off + _ANNEX_LEN.size:
            raise ConnectionError(f"short annexed frame: {total}")
        (alen,) = _ANNEX_LEN.unpack_from(buf, off)
        off += _ANNEX_LEN.size
        if total < off + alen:
            raise ConnectionError(f"annex overruns frame: {alen}")
        return bytes(buf[off:off + alen]), off + alen

    annex = page_annex = None
    if flags & FLAG_TRACE_ANNEX:
        annex, off = annex_at(off)
    if flags & FLAG_PAGE_ANNEX:
        page_annex, off = annex_at(off)
    return Message(msg_type, stage_index, request_id, attempt,
                   memoryview(buf)[off:], annex, page_annex)


def recv_msg(sock: socket.socket, retry_on_timeout: bool = True) -> Message:
    """Receive one frame. ``retry_on_timeout=False`` turns the socket's
    timeout into a hard receive deadline (the gateway's HELLO)."""
    lenbuf = bytearray(_LEN.size)
    _recv_exact_into(sock, memoryview(lenbuf), retry_on_timeout)
    (total,) = _LEN.unpack(lenbuf)
    if total < _HEADER.size:
        raise ConnectionError(f"short frame: {total}")
    buf = bytearray(total)
    _recv_exact_into(sock, memoryview(buf), retry_on_timeout)
    return parse_frame(buf)
