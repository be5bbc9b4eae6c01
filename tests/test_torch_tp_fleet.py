"""The port's fleet paths under tensor parallelism, on the CPU: the host KV
tier, the disaggregated handoff and the fleet router with a tp decode
batcher, and generation over an expert-placed MoE LM.

Weights are carried from the JAX package's variables. A tp=2 spill and
readmit must give the stream of the JAX tp=2 batcher over the same tier;
a disaggregated tp decode batcher must give the JAX DisaggServer's
streams and a router's tp=4 replica those of the JAX tp=4 batcher served
collocated (frames cut into one head tile a shard, each landing on its
shard); an 8-way ``ep``-placed MoE LM's ``generate`` must equal the
replicated one and the JAX package's ep-placed one."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.config import (
    CacheTierConfig,
    CapacityConfig,
    DisaggConfig,
    ParallelConfig,
)
from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.core.mesh import MeshSpec, build_mesh
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.parallel.expert import place_experts
from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
from adapt_tpu_torch.runtime.disagg import (
    DisaggServer,
    KVHandoff,
    PrefillWorker,
    head_ranges_for,
)
from adapt_tpu_torch.runtime.router import FleetRouter
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.tracing import global_flight_recorder

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JC = importlib.import_module("adapt_tpu.runtime.continuous")
JCFG = importlib.import_module("adapt_tpu.config")
JD = importlib.import_module("adapt_tpu.runtime.disagg")
JE = importlib.import_module("adapt_tpu.parallel.expert")
JM = importlib.import_module("adapt_tpu.core.mesh")

VOCAB = 37
PAGE = 8
STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers at once,
    and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clean_slate():
    global_metrics().reset()
    global_flight_recorder().clear()
    yield
    global_metrics().reset()
    global_flight_recorder().clear()


_CACHE = {}


def _lm():
    """A 4-head LM (tp=4 gives each shard one head) carried from JAX."""
    if "lm" not in _CACHE:
        args = (VOCAB, 32, 2, 4, 64)
        jlm = J.transformer_lm(*args, max_len=96)
        variables = jax.device_get(jlm.graph.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
        tlm = T.transformer_lm(*args, max_len=96, device="cpu")
        tlm.load_state_dict(from_flax(variables))
        _CACHE["lm"] = jlm, variables, tlm
    return _CACHE["lm"]


def _mesh(tp):
    return build_mesh(MeshSpec((("tp", tp),)), ["cpu"] * tp)


def _tp(tp, sim_mesh=None):
    """The batcher kwargs of a tp batcher, port (no ``sim_mesh``) or JAX."""
    if sim_mesh is None:
        return dict(mesh=_mesh(tp), parallel=ParallelConfig(tp=tp))
    return dict(mesh=sim_mesh(tp), parallel=JCFG.ParallelConfig(tp=tp))


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, size=n).astype(np.int32) for n in lens]


# -- the host KV tier -----------------------------------------------------------


def _evict_then_rereference(bat, A, flood):
    """Register A's prefix pages, flood-evict them, re-reference A: A's
    second stream."""
    bat.submit(A, STEPS)
    bat.run()
    for p in flood:
        bat.submit(p, STEPS)
    bat.run()
    rid = bat.submit(A, STEPS)
    return np.asarray(bat.run()[rid])


@pytest.mark.parametrize("dtype", ["native", "int8"])
def test_tp2_spill_readmit_equals_jax(sim_mesh, dtype):
    """tp=2 head-split pools under a host tier: the spill assembles each
    page from its shards' heads (``fetch_head_shards``), the readmit lands
    per-shard slices (``KVHandoffPlan``). A's re-referenced stream equals
    the JAX tp=2 batcher's over the same tier and the port's untiered
    run."""
    jlm, variables, tlm = _lm()
    A, *flood = _prompts(0, [2 * PAGE + 4] * 5)
    kw = dict(slots=1, chunk=4, kv_layout="paged", page_size=PAGE,
              kv_cache_dtype=dtype)
    tier = dict(spill_pages_per_tick=16, readmit_pages_per_tick=16)
    want = _evict_then_rereference(JC.ContinuousBatcher(
        jlm, variables, pool_pages=12,
        cache_tier=JCFG.CacheTierConfig(**tier), **_tp(2, sim_mesh), **kw),
        A, flood)
    untiered = _evict_then_rereference(ContinuousBatcher(
        tlm, pool_pages=64, **_tp(2), **kw), A, flood)
    bat = ContinuousBatcher(tlm, pool_pages=12,
                            cache_tier=CacheTierConfig(**tier), **_tp(2),
                            **kw)
    got = _evict_then_rereference(bat, A, flood)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, untiered)
    st = bat.stats()
    assert st["tier_readmitted"] >= 1 and st["tier_spilled"] >= 1
    assert st["cache_bytes_per_device"] * 2 == st["cache_bytes"]
    # A spilled page is the whole head range, assembled on the host.
    leaf = bat._fetch_page_host(1)[0][0]
    k = leaf[0] if isinstance(leaf, tuple) else leaf
    assert k.device.type == "cpu" and k.shape[0] == 4
    bat.close()


@pytest.mark.parametrize("dtype", ["native", "int8"])
def test_tp2_spill_is_one_host_copy(monkeypatch, dtype):
    """Each spill fetches every block's K / V (both members of a quantized
    pair) from both shards in ONE device->host copy, and the host page
    equals the shards' heads side by side."""
    from adapt_tpu_torch.parallel import sharding as TS

    _, _, tlm = _lm()
    A, *flood = _prompts(0, [2 * PAGE + 4] * 5)
    seen = []
    real = TS.host_copy
    monkeypatch.setattr(TS, "host_copy",
                        lambda ts: seen.append(len(ts)) or real(ts))
    bat = ContinuousBatcher(
        tlm, slots=1, chunk=4, kv_layout="paged", page_size=PAGE,
        kv_cache_dtype=dtype, pool_pages=12,
        cache_tier=CacheTierConfig(spill_pages_per_tick=16,
                                   readmit_pages_per_tick=16), **_tp(2))
    _evict_then_rereference(bat, A, flood)
    members = 2 * 2 * tlm.depth * (2 if dtype == "int8" else 1)
    assert bat.stats()["tier_spilled"] == len(seen) >= 1
    assert seen == [members] * len(seen)
    page = bat._fetch_page_host(1)
    for pair, got_pair in zip(bat._caches, page):
        for cache, got in zip(pair, got_pair):
            for m, g in enumerate(got if isinstance(got, tuple) else (got,)):
                want = torch.cat([(c[m] if isinstance(c, tuple) else c)[1]
                                  for c in cache], 0)
                assert torch.equal(g, want)
    bat.close()


# -- the disaggregated handoff ----------------------------------------------------


@pytest.mark.parametrize("dtype,tp", [("native", 2), ("int8", 2)])
def test_disagg_tp_decode_equals_jax(clean_slate, sim_mesh, dtype, tp):
    """A ``DisaggServer`` whose decode side is a tp batcher: every handoff
    is framed as tp head tiles a leaf and lands per shard; the streams
    equal the JAX DisaggServer's over its tp decode batcher (native: and
    the port's tp batcher served collocated); each shard still holds
    logical / tp bytes."""
    jlm, variables, tlm = _lm()
    prompts = _prompts(0, (37, 29, 50))
    steps = [10, 8, 9]
    kw = dict(slots=2, chunk=4, kv_layout="paged", page_size=PAGE,
              kv_cache_dtype=dtype)
    jdec = JC.ContinuousBatcher(jlm, variables, **_tp(tp, sim_mesh), **kw)
    jsrv = JD.DisaggServer(jdec, JD.PrefillWorker(
        jlm, variables, page_size=PAGE, prefill_chunk=2 * PAGE,
        kv_cache_dtype=dtype), JCFG.DisaggConfig(
        prompt_threshold=2 * PAGE, busy_prompt_threshold=2 * PAGE))
    jids = [jsrv.submit(p, s) for p, s in zip(prompts, steps)]
    jout = jsrv.run()
    decode = ContinuousBatcher(tlm, **_tp(tp), **kw)
    worker = PrefillWorker(tlm, page_size=PAGE, prefill_chunk=2 * PAGE,
                           kv_cache_dtype=dtype, device="cpu")
    srv = DisaggServer(decode, worker, DisaggConfig(
        prompt_threshold=2 * PAGE, busy_prompt_threshold=2 * PAGE),
        device="cpu")
    sids = [srv.submit(p, s) for p, s in zip(prompts, steps)]
    outs = srv.run()
    for jid, sid in zip(jids, sids):
        np.testing.assert_array_equal(outs[sid], np.asarray(jout[jid]))
    if dtype == "native":
        # Whole-prompt and handed-off admissions agree on native pools (an
        # int8 hit pass attends the quantized window instead).
        ref = ContinuousBatcher(tlm, **_tp(tp), **kw)
        rids = [ref.submit(p, s) for p, s in zip(prompts, steps)]
        rout = ref.run()
        for rid, sid in zip(rids, sids):
            np.testing.assert_array_equal(outs[sid], rout[rid])
    assert srv.disaggregated == len(prompts)
    evs = [e["data"] for e in global_flight_recorder().events("kv_handoff")]
    assert len(evs) == 3 and all(e["tiles"] == tp for e in evs)
    st = decode.stats()
    assert st["cache_bytes_per_device"] * tp == st["cache_bytes"]


def test_head_ranges_for_tp_destinations():
    _, _, tlm = _lm()
    kw = dict(slots=1, kv_layout="paged", page_size=PAGE)
    k = torch.zeros(2, 4, PAGE, 8)
    h = KVHandoff(req_id=0, prompt=np.zeros(17, np.int32), page_size=PAGE,
                  n_pages=2, quantized=False, blocks=[(k, k), (k, k)])
    assert head_ranges_for(ContinuousBatcher(tlm, **kw), h) is None
    assert head_ranges_for(ContinuousBatcher(tlm, **_tp(1), **kw), h) is None
    assert head_ranges_for(ContinuousBatcher(tlm, **_tp(4), **kw), h) == [
        (0, 1), (1, 2), (2, 3), (3, 4)]
    assert head_ranges_for(ContinuousBatcher(tlm, **_tp(2), **kw), h) == [
        (0, 2), (2, 4)]


# -- the fleet router ---------------------------------------------------------------


def test_router_prefill_reshard_tp4(clean_slate, sim_mesh):
    """A prefill tier streams KV to a tp=4 decode replica: each leaf cut
    into 4 head tiles sender-side (``_head_ranges`` is not None), landing
    through the prefix cache per shard; the streams equal the JAX tp=4
    batcher's served collocated."""
    jlm, variables, tlm = _lm()
    prompts = _prompts(7, (37, 29, 50))
    kw = dict(slots=2, chunk=PAGE, kv_layout="paged", page_size=PAGE)
    jref = JC.ContinuousBatcher(jlm, variables, **_tp(4, sim_mesh), **kw)
    jids = [jref.submit(p, 6) for p in prompts]
    jout = jref.run()
    rep = ContinuousBatcher(tlm, capacity=CapacityConfig(refresh_s=0.0),
                            **_tp(4), **kw)
    pf = PrefillWorker(tlm, page_size=PAGE, prefill_chunk=2 * PAGE,
                       device="cpu")
    router = FleetRouter({"d0": rep}, prefill=pf, disagg=DisaggConfig(
        prompt_threshold=2 * PAGE, busy_prompt_threshold=2 * PAGE))
    sids = [router.submit(p, steps=6) for p in prompts]
    out = router.run()
    assert set(out) == set(sids)
    evs = [e["data"] for e in global_flight_recorder().events("kv_handoff")]
    assert len(evs) == 3
    assert all(e["tiles"] == 4 and e["adopted"] for e in evs)
    k = torch.zeros(1, 4, PAGE, 8)
    probe = KVHandoff(req_id=0, prompt=np.zeros(9, np.int32), page_size=PAGE,
                      n_pages=1, quantized=False, blocks=[(k, k)])
    assert router._head_ranges(router._replicas["d0"], probe) is not None
    for sid, jid in zip(sids, jids):
        np.testing.assert_array_equal(out[sid], np.asarray(jout[jid]))
    router.close()


# -- expert parallelism -------------------------------------------------------------


def test_moe_lm_expert_sharded_generate_matches(devices):
    """Experts placed over an 8-shard ``ep`` mesh: each shard mixes its own
    experts and the shards' contributions sum in shard order; ``generate``
    equals the replicated run and the JAX package's ep-placed run token
    for token."""
    args = (53, 32, 2, 4, 48)
    kw = dict(max_len=48, moe_experts=8, moe_top_k=2)
    jlm = J.transformer_lm(*args, **kw)
    variables = jlm.graph.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 4), jnp.int32))
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(2), (2, 5), 0,
                                           53, jnp.int32))
    jmesh = JM.build_mesh(JM.MeshSpec(axes=(("ep", len(devices)),)))
    jplaced = JE.place_experts(variables, jmesh, num_experts=8)
    want = np.asarray(J.generate(jlm, jplaced, jnp.asarray(prompt), steps=4))
    tlm = T.transformer_lm(*args, device="cpu", **kw)
    tlm.load_state_dict(from_flax(jax.device_get(variables)))
    mesh = build_mesh(MeshSpec((("ep", 8),)), ["cpu"] * 8)
    plm = T.shard_lm(tlm, mesh, axis="ep",
                     state=place_experts(tlm.state_dict(), mesh, 8))
    blk = plm.decoder_block_0
    assert blk.moe_kind == "ep" and not blk.split_attn
    assert [m.w1.shape[0] for m in blk.moe_shards] == [1] * 8
    got = T.generate(plm, prompt, 4).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, T.generate(tlm, prompt, 4).numpy())
    np.testing.assert_allclose(T.logits_full(plm, prompt).numpy(),
                               T.logits_full(tlm, prompt).numpy(),
                               rtol=2e-5, atol=2e-5)
