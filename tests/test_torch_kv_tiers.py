"""The port's host KV tier (``ops/quantize`` page codecs,
``runtime/paged.HostKVTier`` and the batcher's ``cache_tier=``) against the
JAX package's, on the CPU.

Pinned, with their tolerances: page-codec payloads and meta byte-equal to
the JAX package's for every codec and dtype (f32, f16, bf16, int8, int32),
lossless codecs bit-exact, lossy ones within their lattice and degrading
to "lz" on non-floating arrays; the warm / cold / disk / drop books of the
tier as the JAX package keeps them; greedy streams whose prefix pages were
evicted to the tier and readmitted token-equal to the uninterrupted run
and to the JAX package's tiered batcher (native, int8 pools, a lossy cold
codec, a speculative batcher); live pages never spill; budgets hold; the
disaggregated wire's codecs byte-equal and crc-checked. Weights come from
the JAX package through ``convert.from_flax``. The multi-device cases of
the JAX package's file (head-shard fetches, tp=2 spill / readmit) wait for
ROADMAP.md item 11."""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from adapt_tpu_torch.comm.framing import frame_parts, parse_frame
from adapt_tpu_torch.config import (
    CacheTierConfig,
    DisaggConfig,
    SpeculativeConfig,
)
from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.ops.quantize import (
    LOSSLESS_PAGE_CODECS,
    PAGE_CODECS,
    decode_page,
    encode_page,
    page_codec_roundtrip,
)
from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
from adapt_tpu_torch.runtime.disagg import (
    DisaggServer,
    HandoffError,
    KVHandoff,
    PrefillWorker,
    loopback,
    pack_handoff,
    unpack_handoff,
)
from adapt_tpu_torch.runtime.paged import HostKVTier, Pager
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.tracing import global_flight_recorder

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JC = importlib.import_module("adapt_tpu.runtime.continuous")
JQ = importlib.import_module("adapt_tpu.ops.quantize")
JConfig = importlib.import_module("adapt_tpu.config")

VOCAB = 37
PAGE = 8
STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm_setup():
    jlm = J.lm_tiny(vocab=VOCAB, max_len=64)
    variables = jax.device_get(jlm.graph.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
    tlm = T.lm_tiny(vocab=VOCAB, max_len=64, device="cpu")
    tlm.load_state_dict(from_flax(variables))
    return jlm, variables, tlm


def _mk(tlm, pool_pages, tier=None, dtype="native", **kw):
    kws = dict(slots=1, chunk=4, kv_layout="paged", page_size=PAGE,
               pool_pages=pool_pages, kv_cache_dtype=dtype, cache_tier=tier)
    kws.update(kw)
    return ContinuousBatcher(tlm, **kws)


def _prompts(seed=0, n=4, size=2 * PAGE + 4):
    rng = np.random.RandomState(seed)
    A = rng.randint(0, VOCAB, size=size).astype(np.int32)
    return A, [rng.randint(0, VOCAB, size=size).astype(np.int32)
               for _ in range(n)]


def _evict_then_rereference(bat, A, flood):
    """Register A's prefix pages, flood-evict them, re-reference A.
    Returns A's second-reference stream."""
    bat.submit(A, STEPS)
    bat.run()
    for p in flood:
        bat.submit(p, STEPS)
    bat.run()
    rid = bat.submit(A, STEPS)
    return np.asarray(bat.run()[rid])


def _reference_stream(tlm, A, flood, **kw):
    """The uninterrupted run: a big pool, the same traffic; A's second
    reference is an ordinary prefix hit."""
    ref = _mk(tlm, 64, **kw)
    try:
        return _evict_then_rereference(ref, A, flood)
    finally:
        ref.close()


def _np(t):
    """A decoded page as numpy (bf16 as ml_dtypes, the JAX package's)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _leaves(blocks):
    for pair in blocks:
        for m in pair:
            yield from (m if isinstance(m, tuple) else (m,))


# -- page codecs --------------------------------------------------------------


@pytest.mark.parametrize("codec", PAGE_CODECS)
@pytest.mark.parametrize(
    "dtype", [np.float32, np.float16, ml_dtypes.bfloat16, np.int8, np.int32])
def test_page_codec_byte_equal_jax_and_roundtrip(codec, dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 3, 8, 16) * 3).astype(dtype)
    want_payload, want_meta = JQ.encode_page(x, codec)
    arg = x
    if dtype is ml_dtypes.bfloat16:
        arg = torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    payload, meta = encode_page(arg, codec)
    assert payload == want_payload and meta == want_meta
    y = decode_page(payload, meta)
    assert tuple(y.shape) == x.shape
    np.testing.assert_array_equal(_np(y), JQ.decode_page(payload, meta))
    np.testing.assert_array_equal(_np(page_codec_roundtrip(arg, codec)),
                                  _np(y))
    floating = dtype in (np.float32, np.float16)
    if codec in LOSSLESS_PAGE_CODECS or not floating:
        # Lossy codecs degrade to lossless packing on non-floating (and
        # bfloat16) pages: quantized value planes and ids stay exact.
        np.testing.assert_array_equal(_np(y), x)
        if codec not in LOSSLESS_PAGE_CODECS:
            assert meta["codec"] == "lz"
    else:
        err = np.abs(_np(y).astype(np.float64) - x.astype(np.float64))
        amax = np.abs(x.astype(np.float64)).max(axis=-1, keepdims=True)
        bound = {"zfp": 2.0**-10, "int8": 1.0 / 127, "int4": 1.0 / 7}[codec]
        tiny = 1e-6 if dtype is np.float32 else 2e-3 * amax
        assert (err <= amax * bound + tiny).all()


def test_page_codec_meta_and_errors():
    x = np.zeros((4, 16), np.float32)
    payload, meta = encode_page(x, "lz")
    assert len(payload) < meta["raw_nbytes"]  # zeros compress
    np.testing.assert_array_equal(decode_page(payload, meta).numpy(), x)
    with pytest.raises(ValueError):
        encode_page(x, "snappy")
    with pytest.raises(ValueError):
        encode_page(np.zeros((4, 15), np.float32), "int4")  # odd lane
    with pytest.raises(ValueError, match="lossless"):
        CacheTierConfig(warm_codec="int8")


# -- the host tier ------------------------------------------------------------


def _blocks(rng, kvh=2, hd=4, quant=False):
    def member():
        if quant:
            return (torch.from_numpy(rng.randint(-127, 127, (kvh, PAGE, hd))
                                     .astype(np.int8)),
                    torch.from_numpy(rng.rand(kvh, PAGE, 1).astype(
                        np.float32)))
        return torch.from_numpy(rng.randn(kvh, PAGE, hd).astype(np.float32))

    return [(member(), member()) for _ in range(2)]


def _jax_blocks(blocks):
    return [tuple(tuple(x.numpy() for x in m) if isinstance(m, tuple)
                  else m.numpy() for m in pair) for pair in blocks]


def test_host_tier_warm_cold_demotion_and_drop():
    kw = dict(host_capacity_pages=4, warm_capacity_pages=2,
              cold_codec="int8")
    tier = HostKVTier(CacheTierConfig(**kw))
    jtier = importlib.import_module("adapt_tpu.runtime.paged").HostKVTier(
        JConfig.CacheTierConfig(**kw))
    rng = np.random.RandomState(0)
    pages = {}
    for i in range(6):
        key = b"k%d" % i
        pages[key] = _blocks(rng)
        assert tier.put(key, pages[key]) == jtier.put(
            key, _jax_blocks(pages[key]))
    st = tier.stats()
    assert st.pages == 4 and st.warm == 2 and st.cold == 2
    assert st.dropped == 2 and st.spilled == 6
    assert vars(st) == vars(jtier.stats())  # every book equal
    for k, v in zip(_leaves(pages[b"k5"]), _leaves(tier.get(b"k5"))):
        assert torch.equal(k, v)  # warm: bit-exact
    cold = tier.get(b"k3")
    jcold = jtier.get(b"k3")
    for k, v, jv in zip(_leaves(pages[b"k3"]), _leaves(cold),
                        jax.tree.leaves(jcold)):
        assert v.shape == k.shape and v.dtype == k.dtype
        np.testing.assert_array_equal(v.numpy(), jv)  # same lossy bits
        assert torch.allclose(k, v, atol=0.1)
    assert tier.get(b"k0") is None  # dropped off the cold end
    assert not tier.contains(b"k0") and tier.contains(b"k4")


def test_host_tier_quantized_members_and_disk_backing(tmp_path):
    """int8-pool pages carry (values, scales): a lossy cold codec passes
    the int8 value plane through bit-exact. A disk directory takes the
    cold overflow instead of dropping it."""
    tier = HostKVTier(CacheTierConfig(host_capacity_pages=2,
                                      warm_capacity_pages=0,
                                      cold_codec="int4"))
    rng = np.random.RandomState(1)
    blocks = _blocks(rng, quant=True)
    tier.put(b"q", blocks)
    for (k, v), (gk, gv) in zip(blocks, tier.get(b"q")):
        assert torch.equal(k[0], gk[0]) and torch.equal(v[0], gv[0])
        assert gk[1].dtype == torch.float32 and gk[1].shape == k[1].shape
    assert tier.stats().codec_bytes_saved != 0
    disk = HostKVTier(CacheTierConfig(host_capacity_pages=1,
                                      warm_capacity_pages=1,
                                      disk_dir=str(tmp_path)))
    a, b = _blocks(rng), _blocks(rng)
    disk.put(b"a", a)
    disk.put(b"b", b)  # demotes "a" past capacity: to disk, not dropped
    st = disk.stats()
    assert st.dropped == 0 and st.disk == 1 and st.pages == 1
    assert disk.contains(b"a")
    for k, v in zip(_leaves(a), _leaves(disk.get(b"a"))):
        assert torch.equal(k, v)


def test_pager_evict_hook_and_residency():
    p = Pager(4, 1, 4)
    seen = []
    p.evict_hook = lambda page, key: seen.append(key)
    p.adopt_cached([b"a", b"b", b"c"])
    assert p.resident(b"a") and [k for _, k in p.cached_pages()] == [
        b"a", b"b", b"c"]
    p.evict_cached(1)  # the sweep fires the hook
    assert seen == [b"a"] and not p.resident(b"a")
    p.alloc(0, 2)  # 0 free: demand eviction fires it too
    assert seen == [b"a", b"b"]
    assert p.resident(b"c")


def test_cache_tier_requires_paged(lm_setup):
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(lm_setup[2], slots=1, kv_layout="slots",
                          cache_tier=CacheTierConfig())


# -- the serving path ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["native", "int8"])
def test_spill_evict_readmit_equals_uninterrupted_and_jax(lm_setup, dtype):
    """Flood pressure evicts A's prefix pages into the host tier; A's
    re-reference readmits them through the adopt_cached landing path,
    counts prefix hits, and its stream equals the uninterrupted big-pool
    run's and the JAX package's tiered batcher's, the pool partition
    exact throughout."""
    jlm, variables, tlm = lm_setup
    A, flood = _prompts()
    want = _reference_stream(tlm, A, flood, dtype=dtype)
    tier = dict(spill_pages_per_tick=16, readmit_pages_per_tick=16)
    bat = _mk(tlm, 12, tier=CacheTierConfig(**tier), dtype=dtype)
    kinds0 = dict(global_flight_recorder().kind_counts())
    c0 = global_metrics().snapshot()["counters"]
    bat.submit(A, STEPS)
    bat.run()
    for p in flood:
        bat.submit(p, STEPS)
    bat.run()
    st = bat.stats()
    assert st["tier_spilled"] > 0, "the flood never spilled"
    hits0 = st["prefix_hits"]
    rid = bat.submit(A, STEPS)
    got = np.asarray(bat.run()[rid])
    np.testing.assert_array_equal(got, want)
    jbat = JC.ContinuousBatcher(
        jlm, variables, slots=1, chunk=4, kv_layout="paged", page_size=PAGE,
        pool_pages=12, kv_cache_dtype=dtype,
        cache_tier=JConfig.CacheTierConfig(**tier))
    np.testing.assert_array_equal(
        got, _evict_then_rereference(jbat, A, flood))
    st = bat.stats()
    jst = jbat.stats()
    # host_bytes is left out: the pages' f32 / bf16 contents agree with
    # the JAX package's only to ~1e-6, so their lz sizes differ a little.
    for key in ("tier_spilled", "tier_readmitted", "tier_dropped",
                "host_pages", "prefix_hits"):
        assert st[key] == jst[key], key
    assert st["tier_readmitted"] >= 1
    assert st["prefix_hits"] - hits0 >= st["tier_readmitted"]
    alloc = st["pool_pages"] - 1
    assert st["pages_in_use"] + st["pages_free"] == alloc
    mem = bat._memory_stats()
    assert mem["memory.host_bytes"] == st["host_bytes"] > 0
    assert mem["memory.pages_spilled"] == st["host_pages"]
    c1 = global_metrics().snapshot()["counters"]
    for name in ("cache_tier.spilled_total", "cache_tier.readmitted_total"):
        assert c1.get(name, 0) > c0.get(name, 0)
    kinds = global_flight_recorder().kind_counts()
    for kind in ("kv_spill", "kv_readmit", "radix_evict"):
        assert kinds.get(kind, 0) > kinds0.get(kind, 0)
    bat.close()


def test_spill_budget_respected_and_drops_counted(lm_setup):
    """A spill budget of 1 a tick bounds tier work, and evictions past it
    count as dropped."""
    tlm = lm_setup[2]
    A, flood = _prompts(n=6)
    tier = CacheTierConfig(spill_pages_per_tick=1, readmit_pages_per_tick=4,
                           spill_watermark=1.0, spill_low_watermark=1.0)
    bat = _mk(tlm, 12, tier=tier)
    bat.submit(A, STEPS)
    bat.run()
    last = bat.stats()["tier_spilled"]
    for p in flood:
        bat.submit(p, STEPS)
        while bat.tick() or bat.stats()["queued"]:
            s = bat.stats()["tier_spilled"]
            assert s - last <= 1, "a tick spilled past the budget"
            last = s
    st = bat.stats()
    assert st["tier_spilled"] >= 1
    assert st["tier_dropped"] >= 1
    bat.close()


def test_live_pages_never_spill(lm_setup):
    """Only rc=0 LRU pages reach the tier: while a request holds its
    prompt pages, their keys stay out of it under the most aggressive
    watermark; retired, the sweep may take them."""
    tlm = lm_setup[2]
    tier = CacheTierConfig(spill_watermark=0.0, spill_low_watermark=0.0,
                           spill_pages_per_tick=64)
    bat = _mk(tlm, 16, tier=tier)
    A = np.random.RandomState(3).randint(0, VOCAB, size=2 * PAGE + 2).astype(
        np.int32)
    bat.submit(A, 24)
    for _ in range(3):
        bat.tick()
    assert bat.stats()["active"] == 1
    for j in range(2):
        assert not bat._tier.contains(Pager.prefix_key(A, (j + 1) * PAGE))
    bat.run()
    bat.tick()
    assert bat.stats()["tier_spilled"] >= 1
    bat.close()


def test_prefix_cached_reads_the_hierarchy(lm_setup):
    tlm = lm_setup[2]
    A, flood = _prompts()
    bat = _mk(tlm, 12, tier=CacheTierConfig(spill_pages_per_tick=16,
                                            readmit_pages_per_tick=16))
    assert bat.prefix_cached(A) == 0
    bat.submit(A, STEPS)
    bat.run()
    assert bat.prefix_cached(A) == 2  # in the pool
    for p in flood:
        bat.submit(p, STEPS)
    bat.run()
    assert bat.stats()["tier_spilled"] > 0
    assert bat.prefix_cached(A) == 2  # evicted, host-resident
    bat.close()


def test_cold_codec_stream_equals_jax(lm_setup):
    """Warm capacity 0 demotes every spill through the lossy int8 page
    codec: the readmitted stream equals the JAX package's under the same
    tier (the codec bytes are the same), and its top-1 agreement with the
    uncompressed run is printed beside the JAX package's 0.95 bar."""
    jlm, variables, tlm = lm_setup
    A, flood = _prompts()
    want = _reference_stream(tlm, A, flood)
    kw = dict(host_capacity_pages=64, warm_capacity_pages=0,
              cold_codec="int8", spill_pages_per_tick=16,
              readmit_pages_per_tick=16)
    bat = _mk(tlm, 12, tier=CacheTierConfig(**kw))
    got = _evict_then_rereference(bat, A, flood)
    assert bat.stats()["tier_readmitted"] >= 1
    jbat = JC.ContinuousBatcher(
        jlm, variables, slots=1, chunk=4, kv_layout="paged", page_size=PAGE,
        pool_pages=12, cache_tier=JConfig.CacheTierConfig(**kw))
    np.testing.assert_array_equal(got, _evict_then_rereference(jbat, A,
                                                               flood))
    agreement = float((got == want).mean())
    assert agreement >= 0.95, agreement
    bat.close()


def test_speculative_spill_readmit_equals_uninterrupted(lm_setup):
    """Speculative mode (self draft) composes: the readmitted prefix feeds
    the same draft + verify tick and the stream equals the uninterrupted
    speculative run and the plain one."""
    tlm = lm_setup[2]
    A, flood = _prompts()
    kw = dict(draft_lm=tlm, speculative=SpeculativeConfig(draft_k=3))
    want = _reference_stream(tlm, A, flood, **kw)
    np.testing.assert_array_equal(want, _reference_stream(tlm, A, flood))
    bat = _mk(tlm, 12, tier=CacheTierConfig(spill_pages_per_tick=16,
                                            readmit_pages_per_tick=16), **kw)
    got = _evict_then_rereference(bat, A, flood)
    np.testing.assert_array_equal(got, want)
    assert bat.stats()["tier_readmitted"] >= 1
    bat.close()


# -- the disaggregated wire's codecs ------------------------------------------


def test_wire_codec_roundtrip_byte_equal_and_crc():
    """MSG_KV_PAGES with a wire codec: frames byte-equal to the JAX
    package's; lz round-trips bit-exact; lossy codecs keep the int prompt
    exact; the crc covers the ENCODED payload, so a flipped byte raises
    before any decode."""
    JD = importlib.import_module("adapt_tpu.runtime.disagg")
    JF = importlib.import_module("adapt_tpu.comm.framing")
    rng = np.random.RandomState(3)
    blocks = [tuple(rng.rand(3, 2, PAGE, 4).astype(np.float32)
                    for _ in range(2)) for _ in range(2)]
    prompt = rng.randint(0, VOCAB, size=3 * PAGE + 3).astype(np.int32)
    kw = dict(req_id=7, prompt=prompt, page_size=PAGE, n_pages=3,
              quantized=False)
    h = KVHandoff(blocks=[tuple(torch.from_numpy(m) for m in p)
                          for p in blocks], **kw)
    jh = JD.KVHandoff(blocks=blocks, **kw)
    for wc in PAGE_CODECS:
        assert b"".join(bytes(p) for p in frame_parts(
            pack_handoff(h, wire_codec=wc))) == b"".join(
            bytes(p) for p in JF.frame_parts(JD.pack_handoff(
                jh, wire_codec=wc))), wc
    got = unpack_handoff(loopback(pack_handoff(h, wire_codec="lz")))
    np.testing.assert_array_equal(got.prompt, prompt)
    for a, b in zip(_leaves(h.blocks), _leaves(got.blocks)):
        assert torch.equal(a, b)
    lossy = unpack_handoff(loopback(pack_handoff(h, wire_codec="int8")))
    np.testing.assert_array_equal(lossy.prompt, prompt)
    assert torch.allclose(lossy.blocks[0][0], h.blocks[0][0], atol=0.02)
    wire = bytearray(b"".join(frame_parts(pack_handoff(h, wire_codec="lz"))))
    wire[-5] ^= 0xFF
    with pytest.raises((HandoffError, ConnectionError)):
        unpack_handoff(parse_frame(memoryview(wire)[8:]))


def test_disagg_wire_codec_and_raw_bytes_counter(lm_setup):
    """A DisaggServer over a tier-enabled decode batcher takes the tier's
    lz wire codec: streams equal the collocated path, and the wire books
    both post-codec and raw bytes."""
    tlm = lm_setup[2]
    prompt = np.random.RandomState(5).randint(0, VOCAB, size=37).astype(
        np.int32)
    ref = _mk(tlm, 64, slots=2)
    rid = ref.submit(prompt, 10)
    want = ref.run()[rid]
    ref.close()
    decode = _mk(tlm, 64, tier=CacheTierConfig(wire_codec="lz"), slots=2)
    worker = PrefillWorker(tlm, page_size=PAGE, prefill_chunk=2 * PAGE,
                           device="cpu")
    srv = DisaggServer(decode, worker, DisaggConfig(
        prompt_threshold=2 * PAGE, busy_prompt_threshold=2 * PAGE),
        device="cpu")
    assert srv.wire_codec == "lz"
    c0 = global_metrics().snapshot()["counters"]
    sid = srv.submit(prompt, 10)
    np.testing.assert_array_equal(srv.run()[sid], want)
    assert srv.disaggregated == 1
    c1 = global_metrics().snapshot()["counters"]
    wire = c1.get("disagg.handoff_bytes", 0) - c0.get(
        "disagg.handoff_bytes", 0)
    raw = c1.get("disagg.handoff_bytes_raw", 0) - c0.get(
        "disagg.handoff_bytes_raw", 0)
    assert wire > 0 and raw > 0
    srv.close()
    decode.close()
