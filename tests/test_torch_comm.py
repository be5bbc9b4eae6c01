"""The port's wire (``adapt_tpu_torch.comm``) and journal
(``control.journal``) held against the JAX package's in the same process,
on the CPU.

Every input comes from a numpy seed. Frames are byte-equal to
``adapt_tpu.comm.framing``'s for every message type (negative ids and
annexes included) and each package parses the other's; ``pack`` is
byte-equal to the JAX package's for ``none``, ``bf16``, ``int8``, ``zfp``
and ``lz`` on f32, f16 and int32 arrays of shapes ``()``, ``(0,)``,
``(3, 5, 7)`` and ``(8, 28, 28, 64)`` (where the JAX package raises, the
port raises the same error), and ``bf16`` is bit-equal to ``ml_dtypes``
on NaN, +-Inf, subnormals and ties; frames unpack across the packages both
ways; ``int8dev`` on the CPU equals JAX's frame but for the blocks where
JAX's interpreted K6 kernel forms its scale one ulp off its own reference
(``tests/test_torch_k6_partition.py``'s rule); the native LZ codec is
byte-equal to JAX's, and building it writes nothing under ``native/``;
either package's journal replays the other's directory."""

import importlib
import json
import os
import pathlib
import socket
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from adapt_tpu_torch.comm import codec as TC
from adapt_tpu_torch.comm import framing as TF
from adapt_tpu_torch.comm import native as TN
from adapt_tpu_torch.control.journal import DispatcherJournal as TJournal

JC = importlib.import_module("adapt_tpu.comm.codec")
JF = importlib.import_module("adapt_tpu.comm.framing")
JN = importlib.import_module("adapt_tpu.comm.native")
JR = importlib.import_module("adapt_tpu.comm.remote")
JJ = importlib.import_module("adapt_tpu.control.journal")

ROOT = pathlib.Path(__file__).resolve().parent.parent

HOST_CODECS = ("none", "bf16", "int8", "zfp", "lz")
DTYPES = ("float32", "float16", "int32")
SHAPES = ((), (0,), (3, 5, 7), (8, 28, 28, 64))


def _array(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return np.asarray(rng.integers(-1000, 1000, shape), np.int32)
    return np.asarray(rng.standard_normal(shape) * 50, dtype)


def _pack_or_error(pack, codec, x):
    try:
        return bytes(pack(codec, x)), None
    except Exception as e:  # noqa: BLE001 — the error itself is compared
        return None, type(e)


# -- framing -------------------------------------------------------------------


def test_message_types_match_the_jax_namespace():
    for name in ("MSG_DATA", "MSG_CONFIG", "MSG_RESULT", "MSG_ACK",
                 "MSG_ERROR", "MSG_KV_PAGES", "MSG_TELEMETRY"):
        assert getattr(TF, name) == getattr(JF, name)
    for name in ("MSG_KILL", "MSG_PING", "MSG_CONFIG_ERR", "MSG_PROBE",
                 "MSG_PROBE_ACK", "MSG_CONFIG_ARRAY", "MSG_CONFIG_END",
                 "MSG_HELLO", "MSG_HELLO_ACK", "MSG_UNCONFIGURE",
                 "MSG_SET_ROUTE", "MSG_DATA_CHAINED"):
        assert getattr(TF, name) == getattr(JR, name)


@pytest.mark.parametrize("msg_type", range(1, 20))
@pytest.mark.parametrize("annexes", ["none", "trace", "both"])
def test_frames_byte_equal_and_cross_parse(msg_type, annexes):
    rng = np.random.default_rng(msg_type)
    payload = rng.integers(0, 256, 37, dtype=np.uint8).tobytes()
    annex = b'[{"name": "s"}]' if annexes != "none" else None
    page = b"\x00\x01pages" if annexes == "both" else None
    args = (msg_type, -1 if msg_type % 2 else 3, -(msg_type * 7919), 2,
            [payload[:5], memoryview(payload)[5:]])
    tparts = TF.frame_parts(TF.Message(*args, annex=annex, page_annex=page))
    jparts = JF.frame_parts(JF.Message(*args, annex=annex, page_annex=page))
    tb = b"".join(bytes(p) for p in tparts)
    assert tb == b"".join(bytes(p) for p in jparts)
    for parse in (TF.parse_frame, JF.parse_frame):
        m = parse(bytearray(tb[8:]))
        assert (m.msg_type, m.stage_index, m.request_id, m.attempt) == \
            args[:4]
        assert bytes(m.payload) == payload
        assert (m.annex, m.page_annex) == (annex, page)


def test_framing_over_a_socket_pair_both_ways():
    a, b = socket.socketpair()
    try:
        x = _array((8, 28, 28, 64), "float32", 3)
        parts = TC.pack_frames(TC.get_codec("none"), x)
        t = threading.Thread(target=TF.send_msg, args=(
            a, TF.Message(TF.MSG_DATA, 1, -42, 0, parts)))
        t.start()
        got = JF.recv_msg(b)
        t.join()
        np.testing.assert_array_equal(JC.unpack(got.payload), x)
        t = threading.Thread(target=JF.send_msg, args=(
            b, JF.Message(JF.MSG_RESULT, 2, 7, 1,
                          JC.pack_frames(JC.get_codec("lz"), x))))
        t.start()
        got = TF.recv_msg(a)
        t.join()
        assert (got.stage_index, got.request_id, got.attempt) == (2, 7, 1)
        assert np.array_equal(TC.unpack(got.payload).numpy(), x)
    finally:
        a.close()
        b.close()


def test_peer_close_mid_frame_raises():
    a, b = socket.socketpair()
    parts = TF.frame_parts(TF.Message(TF.MSG_DATA, 0, 1, 0, b"x" * 100))
    a.sendall(bytes(parts[0]))
    a.close()
    with pytest.raises(ConnectionError):
        TF.recv_msg(b)
    b.close()


# -- host codecs ---------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", HOST_CODECS)
def test_pack_byte_equal_to_jax(name, dtype, shape):
    x = _array(shape, dtype, seed=len(shape) * 10 + DTYPES.index(dtype))
    tb, terr = _pack_or_error(TC.pack, TC.get_codec(name), x)
    jb, jerr = _pack_or_error(JC.pack, JC.get_codec(name), x)
    assert terr is jerr
    assert tb == jb
    # The same array as a torch tensor packs to the same bytes.
    if terr is None:
        assert bytes(TC.pack(TC.get_codec(name), torch.from_numpy(x))) == jb


@pytest.mark.parametrize("name", HOST_CODECS)
def test_unpack_across_the_packages(name):
    x = _array((3, 5, 7), "float32", 11)
    tframe = TC.pack(TC.get_codec(name), x)
    jframe = JC.pack(JC.get_codec(name), x)
    ours = TC.unpack(jframe)
    theirs = JC.unpack(tframe)
    assert isinstance(ours, torch.Tensor)
    want = JC.unpack(jframe)
    assert np.array_equal(ours.numpy(), np.asarray(want, np.float32))
    assert np.array_equal(np.asarray(theirs, np.float32),
                          TC.unpack(tframe).numpy())


def _bf16_specials():
    f32 = np.float32
    ties = np.array([0x3F808000, 0x3F818000, 0x3F80C000, 0x7F7F8000,
                     0x00008000, 0x80018000], np.uint32).view(f32)
    sub = np.array([1e-40, -1e-40, 1.4e-45, -1.4e-45, 1.1754942e-38], f32)
    nan = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001,
                    0x7FFFFFFF], np.uint32).view(f32)
    rng = np.random.default_rng(5)
    rand = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(
        np.uint32).view(f32)
    return np.concatenate([ties, sub, nan, rand,
                           np.array([np.inf, -np.inf, 0.0, -0.0,
                                     3.4028235e38], f32)])


def test_bf16_rounding_bit_equal_to_ml_dtypes():
    x = _bf16_specials()
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    assert np.array_equal(TC.to_bf16_bits(x), want)
    frame = TC.pack(TC.get_codec("bf16"), x)
    with np.errstate(invalid="ignore"):
        assert bytes(frame) == bytes(JC.pack(JC.get_codec("bf16"), x))
    # Decoding: bfloat16 -> f32 is exact, NaNs stay NaN.
    back = TC.unpack(frame).numpy()
    ref = np.asarray(JC.unpack(frame), np.float32)
    assert np.array_equal(np.isnan(back), np.isnan(ref))
    assert np.array_equal(back[~np.isnan(back)], ref[~np.isnan(ref)])


def test_bfloat16_wire_dtype_maps_to_torch_bfloat16():
    x = _array((4, 6), "float32", 21)
    jb = x.astype(ml_dtypes.bfloat16)
    for name in ("none", "lz", "bf16"):
        frame = JC.pack(JC.get_codec(name), jb)
        got = TC.unpack(frame)
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(),
                              jb.view(np.int16))
        tb = torch.from_numpy(x).to(torch.bfloat16)
        assert bytes(TC.pack(TC.get_codec(name), tb)) == bytes(frame)


def test_int8dev_on_the_cpu_follows_jax_under_the_one_ulp_rule():
    x = _array((8, 28, 28, 64), "float32", 31)
    tframe = bytes(TC.pack(TC.get_codec("int8dev"), x))
    jframe = bytes(JC.pack(JC.get_codec("int8dev"), jnp.asarray(x)))

    def split(frame):
        hlen = int.from_bytes(frame[:4], "big")
        meta = json.loads(frame[4:4 + hlen])
        body = frame[4 + hlen:]
        n = meta["rows"][0] * meta["rows"][1]
        return meta, np.frombuffer(body[:n], np.int8), np.frombuffer(
            body[n:], np.float32)

    tm, tv, ts = split(tframe)
    jm, jv, js = split(jframe)
    assert tm == jm and len(tframe) == len(jframe)
    off = js != ts
    ulps = np.abs(js[off].view(np.int32).astype(np.int64)
                  - ts[off].view(np.int32).astype(np.int64))
    assert (ulps <= 1).all()
    same = np.repeat(~off, 8192)
    assert np.array_equal(tv[same], jv[same])
    # Each package decodes the other's frame to its own dequantize.
    back = TC.unpack(jframe, device="cpu")
    assert back.shape == x.shape and back.dtype == torch.float32
    np.testing.assert_allclose(back.numpy(), np.asarray(JC.unpack(jframe)),
                               rtol=0, atol=0)
    assert np.allclose(np.asarray(JC.unpack(tframe)),
                       TC.unpack(tframe, device="cpu").numpy(), atol=1e-6)


def test_int8dev_keeps_the_shape_of_a_scalar():
    x = np.float32(2.5)
    got = TC.unpack(TC.pack(TC.get_codec("int8dev"), np.asarray(x)),
                    device="cpu")
    assert got.shape == () and float(got) == pytest.approx(2.5, rel=1e-2)


def test_pack_copy_budget_and_zero_copy_unpack():
    x = _array((64, 64), "float32", 41)
    TC.reset_copy_stats()
    frames = TC.pack_frames(TC.get_codec("none"), x)
    assert TC.copy_stats()["calls"] == 0
    assert TC.frames_nbytes(frames) == len(TC.pack(TC.get_codec("none"), x))
    s = TC.copy_stats()
    assert s == {"bytes": x.nbytes, "calls": 1}
    buf = bytearray()
    view = TC.pack_into(TC.get_codec("none"), x, buf)
    y = TC.unpack(view)
    assert np.array_equal(y.numpy(), x)
    buf[-4:] = b"\x00\x00\x80\x7f"  # y views buf: edit the last element
    assert np.isinf(y.numpy().ravel()[-1])


def test_unpack_many_tiles_exactly():
    xs = [_array((3, 4), "float32", s) for s in range(3)]
    frames = [bytes(TC.pack(TC.get_codec("lz"), x)) for x in xs]
    out = TC.unpack_many(b"".join(frames), [len(f) for f in frames])
    assert all(np.array_equal(o.numpy(), x) for o, x in zip(out, xs))
    with pytest.raises(ValueError):
        TC.unpack_many(b"".join(frames), [len(frames[0])])


def test_unknown_codec_rejected():
    with pytest.raises(ValueError, match="unknown codec"):
        TC.get_codec("lz4")


# -- native LZ -----------------------------------------------------------------


@pytest.mark.parametrize("size", [0, 1, 1 << 10, (1 << 16) + 17])
def test_native_compress_byte_equal_to_jax(size):
    rng = np.random.default_rng(size)
    data = (rng.integers(0, 4, size, dtype=np.uint8).tobytes()
            + b"the quick brown fox " * (size // 64))
    assert TN.compress(data) == JN.compress(data)
    assert TN.decompress(JN.compress(data), len(data)) == data
    assert JN.decompress(TN.compress(data), len(data)) == data


def _tree(root: pathlib.Path):
    return sorted((p.relative_to(root).as_posix(), p.stat().st_size,
                   p.stat().st_mtime_ns) for p in root.rglob("*"))


def test_native_build_writes_nothing_under_native(tmp_path, monkeypatch):
    before = _tree(ROOT / "native")
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_tried", False)
    lib = TN.load()
    assert lib is not None, "g++ is expected in the test environment"
    assert TN.lib_path().parent == tmp_path and TN.lib_path().exists()
    data = b"abcabcabc" * 1000
    assert TN.decompress(TN.compress(data), len(data)) == data
    assert _tree(ROOT / "native") == before


def test_native_fallback_is_counted(monkeypatch):
    from adapt_tpu_torch.utils.metrics import global_metrics

    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_tried", False)
    monkeypatch.setattr(TN, "_build", lambda out: False)
    monkeypatch.setattr(TN, "lib_path", lambda: pathlib.Path("/nonexistent"))
    n = global_metrics().counter("native.qcodec_fallback")
    blob = TN.compress(b"hello hello hello")
    assert blob[:1] == b"Z"
    assert TN.decompress(blob, 17) == b"hello hello hello"
    assert global_metrics().counter("native.qcodec_fallback") == n + 1


# -- journal -------------------------------------------------------------------


def _fill(journal_cls, root, payloads):
    j = journal_cls(root)
    j.record_worker("w0", "127.0.0.1", 7001, meta={"codec": "none"})
    j.record_worker("w1", "127.0.0.1", 7002, meta={"codec": "lz"})
    j.forget_worker("w1")
    for rid, p in payloads.items():
        j.record_submit(rid, p, meta={"n": rid})
    for rid in list(payloads)[::2]:
        j.record_done(rid)
    j.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_replays_the_other_packages_directory(tmp_path, writer):
    rng = np.random.default_rng(61)
    payloads = {rid: rng.standard_normal((2, 3)).astype(np.float32)
                for rid in range(6)}
    root = str(tmp_path / "j")
    _fill(JJ.DispatcherJournal if writer == "jax" else TJournal, root,
          payloads)
    reader = TJournal if writer == "jax" else JJ.DispatcherJournal
    workers, pending, next_id = reader(root).load()
    assert set(workers) == {"w0"} and workers["w0"]["port"] == 7001
    assert workers["w0"]["meta"] == {"codec": "none"}
    assert sorted(pending) == [1, 3, 5] and next_id == 6
    for rid, p in pending.items():
        got = p.numpy() if isinstance(p, torch.Tensor) else p
        assert np.array_equal(got, payloads[rid])
    assert reader(root).submit_meta(3) == {"n": 3}


def test_journal_takes_tensors_and_gives_tensors(tmp_path):
    j = TJournal(str(tmp_path / "t"))
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    j.record_submit(0, x)
    j.record_submit(1, x.to(torch.bfloat16))
    _, pending, _ = j.load()
    assert torch.equal(pending[0], x) and torch.equal(pending[1], x)


def test_journal_compaction_bounds_history(tmp_path):
    root = str(tmp_path / "j")
    j = TJournal(root, compact_every=20)
    j.record_worker("w0", "127.0.0.1", 1234, meta={"codec": "none"})
    for rid in range(300):
        j.record_submit(rid, np.zeros((2, 2), np.float32))
        if rid != 150:
            j.record_done(rid)
    j.close()
    with open(os.path.join(root, "wal.jsonl"), encoding="utf-8") as f:
        assert sum(1 for _ in f) < 30
    payloads = [n for n in os.listdir(root) if n.startswith("req_")]
    assert "req_150.npy" in payloads and len(payloads) < 100
    workers, pending, next_id = TJournal(root).load()
    assert set(workers) == {"w0"} and set(pending) == {150}
    assert next_id == 300 and TJournal(root).next_request_id == 300
    # The JAX journal reads the compacted directory the same way.
    assert set(JJ.DispatcherJournal(root).load()[1]) == {150}


def test_journal_fsyncs_its_directory_at_creation(tmp_path, monkeypatch):
    synced = []
    real_open, real_fsync = os.open, os.fsync
    fds = {}

    def spy_open(path, flags, *a, **k):
        fd = real_open(path, flags, *a, **k)
        fds[fd] = str(path)
        return fd

    def spy_fsync(fd):
        synced.append(fds.get(fd, fd))
        return real_fsync(fd)

    monkeypatch.setattr(os, "open", spy_open)
    monkeypatch.setattr(os, "fsync", spy_fsync)
    root = str(tmp_path / "fresh")
    TJournal(root).close()
    assert root in synced
