"""The port's disaggregated prefill / decode (``runtime/disagg``) against
the JAX package's, on the CPU.

Weights come from the JAX package (flax ``init`` from a seed, carried
across by ``convert.from_flax``); prompts are seeded numpy arrays given to
both. Pinned, with their tolerances:

- the wire: ``pack_handoff`` frames byte-equal to the JAX package's (f32,
  bf16 and int8 pools; the raw wire, head tiles); pack -> loopback ->
  unpack is bit-exact with no codec-layer payload copy, the received
  tensors viewing the wire buffer; corrupt or truncated frames raise
  ``HandoffError`` and, through the server, fail only their request;
- streams: greedy ``DisaggServer`` streams token-equal to the port's
  collocated batcher and to the JAX package's ``DisaggServer`` (native and
  int8 pools); handed-off pages ``torch.equal`` to an in-place chunked
  prefill's;
- the policy: the ``DisaggConfig`` thresholds, the role-tagged lease,
  the degradation ladder's ``busy_threshold`` rung, the admission
  pre-check, ``continuous.prefill_stall_s``, the sequence-parallel ring's
  one-device rule."""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from adapt_tpu_torch.comm import codec
from adapt_tpu_torch.comm.framing import frame_parts, parse_frame
from adapt_tpu_torch.config import (
    DisaggConfig,
    PrefillConfig,
    SchedulerConfig,
    SLOSpec,
)
from adapt_tpu_torch.control.registry import WorkerRegistry
from adapt_tpu_torch.parallel.sp_prefill import build_sp_mesh
from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.parallel.sharding import head_tiles
from adapt_tpu_torch.runtime import disagg as disagg_mod
from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
from adapt_tpu_torch.runtime.disagg import (
    DisaggServer,
    HandoffError,
    KVHandoff,
    PrefillWorker,
    pack_handoff,
    unpack_handoff,
)
from adapt_tpu_torch.runtime.paged import Pager
from adapt_tpu_torch.runtime.scheduler import QueueFullError
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.tracing import global_flight_recorder

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JC = importlib.import_module("adapt_tpu.runtime.continuous")
JD = importlib.import_module("adapt_tpu.runtime.disagg")
JConfig = importlib.import_module("adapt_tpu.config")
JFraming = importlib.import_module("adapt_tpu.comm.framing")
JSharding = importlib.import_module("adapt_tpu.parallel.sharding")

VOCAB = 61
PAGE = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm_setup():
    """2 blocks, dim 32: disaggregation is a placement property, and every
    JAX batcher compiles its own programs."""
    jlm = J.transformer_lm(VOCAB, 32, 2, 2, 64, max_len=96, name="disagg_lm")
    variables = jax.device_get(jlm.graph.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
    tlm = T.transformer_lm(VOCAB, 32, 2, 2, 64, max_len=96, name="disagg_lm",
                           device="cpu")
    tlm.load_state_dict(from_flax(variables))
    return jlm, variables, tlm


def _cfg(threshold=2 * PAGE):
    return DisaggConfig(prompt_threshold=threshold,
                        busy_prompt_threshold=threshold)


def _mk_pair(tlm, dtype="native", **kw):
    decode = ContinuousBatcher(tlm, slots=2, chunk=4, kv_layout="paged",
                               page_size=PAGE, kv_cache_dtype=dtype, **kw)
    worker = PrefillWorker(tlm, page_size=PAGE, prefill_chunk=2 * PAGE,
                           kv_cache_dtype=dtype, device="cpu")
    return decode, worker, DisaggServer(decode, worker, _cfg(), device="cpu")


def _rand_blocks(rng, kind, blocks=2, n=3, kvh=2, hd=4):
    """Numpy page-major blocks: f32, bf16 (``ml_dtypes``) or int8 pairs."""
    def member():
        if kind == "int8":
            return (rng.randint(-127, 127, size=(n, kvh, PAGE, hd)).astype(
                np.int8), rng.rand(n, kvh, PAGE, 1).astype(np.float32))
        x = rng.rand(n, kvh, PAGE, hd).astype(np.float32)
        return x.astype(ml_dtypes.bfloat16) if kind == "bf16" else x

    return [(member(), member()) for _ in range(blocks)]


def _as_torch(a):
    if isinstance(a, tuple):
        return tuple(_as_torch(x) for x in a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _handoffs(seed, kind):
    """The same handoff for both packages: (port's, JAX package's)."""
    rng = np.random.RandomState(seed)
    blocks = _rand_blocks(rng, kind)
    prompt = rng.randint(0, VOCAB, size=3 * PAGE + 3).astype(np.int32)
    kw = dict(req_id=7, prompt=prompt, page_size=PAGE, n_pages=3,
              quantized=kind == "int8")
    return (KVHandoff(blocks=[tuple(_as_torch(m) for m in p) for p in blocks],
                      **kw), JD.KVHandoff(blocks=blocks, **kw))


def _wire(parts):
    return b"".join(bytes(p) for p in parts)


def _leaves(blocks):
    for pair in blocks:
        for m in pair:
            yield from (m if isinstance(m, tuple) else (m,))


# -- the wire -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_handoff_frames_byte_equal_jax_and_roundtrip_zero_copy(kind):
    """Frames byte-equal to the JAX package's (raw wire, and with two head
    tiles); pack -> gather -> parse -> unpack is bit-exact, the send path
    makes no codec-layer payload copy and every received tensor views the
    wire buffer."""
    th, jh = _handoffs(3, kind)
    codec.reset_copy_stats()
    msg = pack_handoff(th)
    assert codec.copy_stats()["calls"] == 0  # scatter parts, no joins
    wire = bytearray(_wire(frame_parts(msg)))
    assert bytes(wire) == _wire(JFraming.frame_parts(JD.pack_handoff(jh)))
    tiles = head_tiles(2, 2)
    assert tiles == JSharding.head_tiles(2, 2)
    assert _wire(frame_parts(pack_handoff(th, head_ranges=tiles))) == _wire(
        JFraming.frame_parts(JD.pack_handoff(jh, head_ranges=tiles)))
    got = unpack_handoff(parse_frame(memoryview(wire)[8:]))
    assert codec.copy_stats()["calls"] == 0  # unpack slices, never joins
    assert got.n_pages == 3 and got.quantized == (kind == "int8")
    np.testing.assert_array_equal(got.prompt, th.prompt)
    wire_arr = np.frombuffer(wire, np.uint8)
    for ours, theirs in zip(_leaves(th.blocks), _leaves(got.blocks)):
        assert torch.equal(ours, theirs)
        view = theirs.view(torch.int16) if kind == "bf16" else theirs
        assert np.shares_memory(view.numpy(), wire_arr), (
            "a received tensor does not view the wire buffer")
    tiled = unpack_handoff(disagg_mod.loopback(
        pack_handoff(th, head_ranges=tiles)))
    for ours, theirs in zip(_leaves(th.blocks), _leaves(tiled.blocks)):
        assert torch.equal(ours, theirs)


def test_corrupt_and_truncated_handoff_raise():
    th, _ = _handoffs(4, "f32")
    wire = bytearray(_wire(frame_parts(pack_handoff(th))))
    with pytest.raises((HandoffError, ConnectionError)):
        unpack_handoff(parse_frame(memoryview(wire)[8:-17]))
    wire2 = bytearray(wire)
    wire2[30:40] = b"\xff" * 10  # the page annex (JSON)
    with pytest.raises((HandoffError, ConnectionError)):
        unpack_handoff(parse_frame(memoryview(wire2)[8:]))
    with pytest.raises(HandoffError, match="cover 1 of 2"):
        pack_handoff(th, head_ranges=[(0, 1)])
    with pytest.raises(HandoffError, match="contiguously"):
        pack_handoff(th, head_ranges=[(1, 2)])


def test_pager_adopt_cached():
    p = Pager(6, 2, 4)  # 5 allocatable pages
    got = p.adopt_cached([b"k0", b"k1", b"k2"])
    assert [i for i, _ in got] == [0, 1, 2]
    st = p.stats()
    assert st.cached == 3 and st.in_use == 0
    assert [i for i, _ in p.adopt_cached([b"k1", b"k3"])] == [1]  # dedupe
    # 1 page free and 4 cached: a 6-key adoption cannot fit, all-or-nothing.
    assert p.adopt_cached([f"n{i}".encode() for i in range(6)]) == []
    page = dict(got)[0]
    assert p.lookup_share(0, b"k0") == page  # rc 0 -> 1, a prefix hit
    assert p.stats().in_use == 1


# -- streams ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["native", "int8"])
def test_disagg_streams_equal_collocated_and_jax(lm_setup, dtype):
    """Greedy streams through the disaggregated path equal the collocated
    port batcher's and the JAX package's DisaggServer's, token for token;
    the handoffs land as prefix hits; steady decode ticks afterwards stage
    nothing host->device."""
    jlm, variables, tlm = lm_setup
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, VOCAB, size=n).astype(np.int32)
               for n in (37, 29, 50)]
    steps = [12, 9, 10]
    ref = ContinuousBatcher(tlm, slots=2, chunk=4, kv_layout="paged",
                            page_size=PAGE, kv_cache_dtype=dtype)
    rids = [ref.submit(p, s) for p, s in zip(prompts, steps)]
    refs = ref.run()
    decode, worker, srv = _mk_pair(tlm, dtype)
    sids = [srv.submit(p, s) for p, s in zip(prompts, steps)]
    outs = srv.run()
    jdec = JC.ContinuousBatcher(jlm, variables, slots=2, chunk=4,
                                kv_layout="paged", page_size=PAGE,
                                kv_cache_dtype=dtype)
    jworker = JD.PrefillWorker(jlm, variables, page_size=PAGE,
                               prefill_chunk=2 * PAGE, kv_cache_dtype=dtype)
    jsrv = JD.DisaggServer(jdec, jworker, JConfig.DisaggConfig(
        prompt_threshold=2 * PAGE, busy_prompt_threshold=2 * PAGE))
    jsids = [jsrv.submit(p, s) for p, s in zip(prompts, steps)]
    jouts = jsrv.run()
    for rid, sid, jsid, p in zip(rids, sids, jsids, prompts):
        np.testing.assert_array_equal(outs[sid], refs[rid],
                                      err_msg=f"prompt {len(p)}")
        np.testing.assert_array_equal(outs[sid], np.asarray(jouts[jsid]))
    assert srv.disaggregated == 3 and srv.collocated == 0
    assert worker.handoffs == 3 == jworker.handoffs
    st = decode.stats()
    assert st["prefix_hits"] >= sum((len(p) - 1) // PAGE for p in prompts)
    assert st["prefill_tokens"] == jdec.stats()["prefill_tokens"]
    srv.submit(prompts[0][:5], 30)  # short: collocated, live below
    srv.tick()
    h2d0 = decode.stats()["h2d_transfers"]
    for _ in range(3):
        srv.tick()
    assert decode.stats()["h2d_transfers"] == h2d0
    srv.run()


def test_handoff_pages_equal_inplace_chunked_prefill(lm_setup):
    """Pages framed, unpacked and landed in a fresh pool hold the same
    bytes as an in-place chunked prefill with the same chunk schedule."""
    tlm = lm_setup[2]
    prompt = np.random.RandomState(5).randint(
        0, VOCAB, size=4 * PAGE + 3).astype(np.int32)
    colo = ContinuousBatcher(tlm, slots=1, chunk=4, kv_layout="paged",
                             page_size=PAGE, prefill_chunk=2 * PAGE)
    colo.submit(prompt, 2)
    colo.run()
    decode, _, srv = _mk_pair(tlm)
    srv.submit(prompt, 2)
    srv.run()
    m = (len(prompt) - 1) // PAGE
    for b in range(len(colo._caches)):
        for member in range(2):
            cpool = colo._caches[b][member]
            dpool = decode._caches[b][member]
            for j in range(m):
                key = Pager.prefix_key(prompt, (j + 1) * PAGE)
                assert torch.equal(cpool[colo._pager._by_key[key]],
                                   dpool[decode._pager._by_key[key]]), (
                    f"block {b} member {member} page {j}")


def test_corrupt_wire_fails_request_cleanly(lm_setup, monkeypatch):
    """A corrupted frame fails only its request (empty result,
    request_failed + finish events); the next request serves normally and
    its callbacks see the SERVER id."""
    tlm = lm_setup[2]
    _, _, srv = _mk_pair(tlm)
    real = disagg_mod.loopback

    def corrupting(msg):
        wire = bytearray(_wire(frame_parts(msg)))
        wire[len(wire) // 2] ^= 0xFF
        try:
            return parse_frame(memoryview(wire)[8:])
        except ConnectionError as e:
            raise HandoffError(str(e)) from e

    monkeypatch.setattr(disagg_mod, "loopback", corrupting)
    prompt = np.random.RandomState(1).randint(0, VOCAB, size=40).astype(
        np.int32)
    rec0 = global_flight_recorder().kind_counts().get("request_failed", 0)
    sid = srv.submit(prompt, 8)
    assert srv.result(sid, max_ticks=200).shape == (0,)
    assert global_flight_recorder().kind_counts().get(
        "request_failed", 0) == rec0 + 1
    assert srv.failed == 1
    monkeypatch.setattr(disagg_mod, "loopback", real)
    cb_ids = []
    sid2 = srv.submit(prompt, 8,
                      on_token=lambda rid, tok, idx: cb_ids.append(rid))
    out2 = srv.result(sid2, max_ticks=400)
    assert set(cb_ids) == {sid2} and len(cb_ids) == len(out2)
    np.testing.assert_array_equal(out2, T.generate(tlm, prompt[None],
                                                   8)[0].numpy())


# -- the policy ---------------------------------------------------------------


def test_placement_policy_and_role_lease(lm_setup):
    """Thresholds and occupancy route requests; a dead role-tagged lease
    falls back to collocated (counted); the lease stays out of untagged
    membership; the tick's keepalive resurrects it until close()."""
    tlm = lm_setup[2]
    reg = WorkerRegistry(default_ttl_s=5.0)
    decode = ContinuousBatcher(tlm, slots=2, chunk=4, kv_layout="paged",
                               page_size=PAGE)
    worker = PrefillWorker(tlm, page_size=PAGE, device="cpu")
    srv = DisaggServer(decode, worker, DisaggConfig(
        prompt_threshold=48, busy_prompt_threshold=17, busy_occupancy=0.5),
        registry=reg, device="cpu")
    assert reg.alive(role="prefill") == ["prefill:prefill0"]
    assert reg.alive(role="decode") == []
    assert reg.role("prefill:prefill0") == "prefill"
    assert not srv._placement(30)
    assert srv._placement(60)
    assert not srv._placement(PAGE)  # no full page to hand off
    assert srv._placement(30, SLOSpec(priority=1))  # high priority: busy
    decode.slots[0].req = object()  # occupancy 0.5 >= busy_occupancy
    assert srv._placement(30)
    decode.slots[0].req = None
    reg.deregister("prefill:prefill0")
    assert not srv._placement(60)
    assert srv.fallbacks == 1
    reg.register("w0")
    assert reg.alive(role="prefill") == []
    assert "w0" in reg.alive()
    srv.tick()
    assert reg.alive(role="prefill") == ["prefill:prefill0"]
    assert reg.alive_untagged() == ["w0"]
    srv.close()
    srv.tick()
    assert reg.alive(role="prefill") == []
    assert not srv._placement(60)


def test_ladder_busy_rung_and_admission_precheck(lm_setup):
    """The server attaches to the batcher's DegradationController, whose
    busy_threshold rung now acts on it (the busy tier stops tightening the
    threshold) and reverts; a
    request the decode queue would reject fails at submit, before its
    prefill runs."""
    tlm = lm_setup[2]
    sched = SchedulerConfig(max_queue_depth=1, degrade=True)
    decode = ContinuousBatcher(tlm, slots=2, chunk=4, kv_layout="paged",
                               page_size=PAGE, scheduler=sched)
    worker = PrefillWorker(tlm, page_size=PAGE, device="cpu")
    cfg = DisaggConfig(prompt_threshold=48, busy_prompt_threshold=17)
    srv = DisaggServer(decode, worker, cfg, device="cpu")
    ctrl = decode._controller
    assert ctrl._disagg() is srv
    ctrl._apply(decode, "busy_threshold")  # busy no longer tightens
    assert srv.cfg.busy_prompt_threshold == cfg.prompt_threshold
    assert not srv._placement(30, SLOSpec(priority=1))
    ctrl._revert(decode, "busy_threshold")
    assert srv.cfg == cfg
    assert srv._placement(30, SLOSpec(priority=1))
    rng = np.random.RandomState(7)
    decode.submit(rng.randint(0, VOCAB, size=5).astype(np.int32), 4)
    rej0 = decode.stats()["rejected"]
    with pytest.raises(QueueFullError):
        srv.submit(rng.randint(0, VOCAB, size=60).astype(np.int32), 4)
    assert worker.pending() == 0
    assert decode.stats()["rejected"] == rej0 + 1


def test_prefill_stall_metric(lm_setup):
    """continuous.prefill_stall_s records decode delay only when a
    decoding request waited behind in-tick prefill."""
    tlm = lm_setup[2]
    reg = global_metrics()
    bat = ContinuousBatcher(tlm, slots=2, chunk=4, kv_layout="paged",
                            page_size=PAGE)

    def stall_count():
        return reg.snapshot()["histograms"].get(
            "continuous.prefill_stall_s", {}).get("count", 0)

    rng = np.random.RandomState(2)
    bat.submit(rng.randint(0, VOCAB, size=6).astype(np.int32), 12)
    c0 = stall_count()
    bat.tick()  # admission into an empty batch: nobody waited
    assert stall_count() == c0
    bat.tick()
    c1 = stall_count()
    bat.submit(rng.randint(0, VOCAB, size=40).astype(np.int32), 4)
    bat.tick()  # a long admission while slot 0 decodes
    assert stall_count() == c1 + 1
    bat.tick()  # steady: no prefill work
    assert stall_count() == c1 + 1
    bat.run()


def test_prefill_cancel_before_handoff(lm_setup):
    tlm = lm_setup[2]
    _, worker, srv = _mk_pair(tlm)
    sid = srv.submit(np.random.RandomState(6).randint(
        0, VOCAB, size=40).astype(np.int32), 8)
    assert worker.pending() == 1
    assert srv.cancel(sid)
    assert worker.pending() == 0
    assert srv.result(sid, max_ticks=5).shape == (0,)
    assert not srv.cancel(sid)


def test_refusals(lm_setup):
    """A sequence-parallel width builds a ring of the tier's device (one
    naming two devices is refused); the tiers must agree on page size, KV
    dtype and device."""
    tlm = lm_setup[2]
    sp = PrefillConfig(sp_threshold=64, sp_width=2)
    pf = PrefillWorker(tlm, page_size=PAGE, device="cpu", prefill=sp)
    assert pf.stats()["sp_width"] == 2
    assert pf.sp_eligible(64) and not pf.sp_eligible(63)
    with pytest.raises(ValueError, match="distinct devices"):
        PrefillWorker(tlm, page_size=PAGE, device="cpu", prefill=sp,
                      sp_mesh=build_sp_mesh(2, devices=["cpu", "meta"]))
    decode = ContinuousBatcher(tlm, slots=2, kv_layout="paged",
                               page_size=PAGE)
    with pytest.raises(ValueError, match="page size"):
        DisaggServer(decode, PrefillWorker(tlm, page_size=16, device="cpu"),
                     device="cpu")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        DisaggServer(decode, PrefillWorker(tlm, page_size=PAGE,
                                           kv_cache_dtype="int8",
                                           device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="paged"):
        DisaggServer(ContinuousBatcher(tlm, slots=2),
                     PrefillWorker(tlm, page_size=PAGE, device="cpu"),
                     device="cpu")
