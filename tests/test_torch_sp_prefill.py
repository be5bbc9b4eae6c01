"""The port's sequence-parallel prefill (``parallel/sp_prefill``) and its
serving paths, on the CPU, held against the JAX package at its own test
shapes (``tests/test_sp_prefill.py``: vocab 61, page 8,
``transformer_lm(61, 32, 2, 2, 64, max_len=96)`` and a GQA + rope model).

The JAX side runs on the simulated CPU mesh; the port's rings name ``cpu``
once a rank (one process drives every rank). The port's LMs carry the JAX
variables (``convert.from_flax``). Pinned:

- ``ring_collect``: every rank's window is exactly the concatenation;
- ``SPPrefiller`` pages against JAX's ``SPPrefiller`` (native, int8,
  int4; sp 2 and 4; GQA + rope; sp x tp): native within 1e-5, quantized
  scales within 1e-5 relative and codes off by at most 1 in at most 0.1%
  of entries. Byte-equality with the chunked prefill is NOT pinned: the
  JAX package's own sp pages differ from its chunked pages at ulp level;
- the sp batcher's greedy streams token-equal to the JAX sp batcher's and
  to the port's plain batcher's, ``sp_prefills`` 3, ``prefix_hits`` >= 3,
  a steady tick 0 host->device copies; the paged-only and tp-axis
  refusals;
- the prefill tier: a pool too small for the long prompts hands off
  nothing without sp and both with it, streams equal;
- the degrade paths: a failing ring falls back to the chunked path and
  three failures retire it; a job the pool cannot hold lands in
  ``failed_jobs`` and fails its request;
- a member shared by a tp=2 batcher and its (sp=2, tp=2) ring killed
  mid-stream: tp 1, the ring rebuilt from the survivors at sp=2, streams
  equal, a later long admission on the sp path.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.config import (
    DisaggConfig,
    ParallelConfig,
    PrefillConfig,
)
from adapt_tpu_torch.control.registry import DeviceHealthMonitor
from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.core.mesh import MeshSpec, build_mesh
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.ops.quantize import kv_values
from adapt_tpu_torch.parallel.sp_prefill import (
    SPPrefiller,
    build_sp_mesh,
    ring_collect,
)
from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
from adapt_tpu_torch.runtime.disagg import DisaggServer, PrefillWorker
from adapt_tpu_torch.utils.tracing import global_flight_recorder

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JC = importlib.import_module("adapt_tpu.runtime.continuous")
JCFG = importlib.import_module("adapt_tpu.config")
JS = importlib.import_module("adapt_tpu.parallel.sp_prefill")

VOCAB = 61
PAGE = 8
SP = PrefillConfig(sp_threshold=24, sp_width=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(heads, **kw):
    jlm = J.transformer_lm(VOCAB, 32, 2, heads, 64, max_len=96, **kw)
    variables = jax.device_get(
        jlm.graph.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
    tlm = T.transformer_lm(VOCAB, 32, 2, heads, 64, max_len=96,
                           device="cpu", **kw)
    tlm.load_state_dict(from_flax(variables))
    return jlm, variables, tlm


_CACHE = {}


def _model(kind="mha"):
    if kind not in _CACHE:
        _CACHE[kind] = (_pair(2) if kind == "mha"
                        else _pair(4, kv_heads=2, pos="rope"))
    return _CACHE[kind]


def _ring(sp, tp=1):
    return build_sp_mesh(sp, tp, devices=["cpu"] * (sp * tp))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=n).astype(np.int32) for n in lengths]


# -- the ring transport --------------------------------------------------


@pytest.mark.parametrize("sp,seq_dim,dtype", [
    (2, 2, torch.float32), (4, 2, torch.float32), (4, 1, torch.float32),
    (4, 2, torch.int8)])
def test_ring_collect_is_exact_concatenation(sp, seq_dim, dtype):
    shape = (1, 32, 2, 8) if seq_dim == 1 else (1, 2, 32, 8)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        shape).astype(np.float32) * 50).to(dtype)
    mesh = build_mesh(MeshSpec((("sp", sp),)), ["cpu"] * sp)
    outs = ring_collect(list(x.chunk(sp, dim=seq_dim)), mesh, "sp",
                        seq_dim=seq_dim)
    assert len(outs) == sp
    assert all(torch.equal(o, x) for o in outs)


# -- the pages against the JAX package's ----------------------------------


def _hold_pages(want, got, dtype, head_dim):
    assert len(want) == len(got)
    for jpair, tpair in zip(want, got):
        for a, b in zip(jpair, tpair):
            if dtype == "native":
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           atol=1e-5, rtol=0)
                continue
            ca = kv_values(torch.from_numpy(np.asarray(a[0])), head_dim)
            cb = kv_values(b[0], head_dim)
            off = (ca - cb).abs()
            assert int(off.max()) <= 1
            assert float((off > 0).float().mean()) <= 1e-3
            np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]),
                                       rtol=1e-5, atol=0)


@pytest.mark.parametrize("kind,dtype,sp,tp", [
    ("mha", "native", 2, 1), ("mha", "native", 4, 1),
    ("mha", "int8", 2, 1), ("mha", "int8", 4, 1),
    ("mha", "int4", 2, 1), ("mha", "int4", 4, 1),
    ("gqa", "native", 2, 1), ("gqa", "int8", 4, 1),
    ("mha", "native", 2, 2), ("gqa", "int4", 2, 2)])
def test_sp_pages_match_jax(kind, dtype, sp, tp):
    jlm, variables, tlm = _model(kind)
    prompt = _prompts(7, (41,))[0]
    tp_axis = "tp" if tp > 1 else None
    jpf = JS.SPPrefiller(jlm, variables, JS.build_sp_mesh(sp, tp), PAGE,
                         kv_cache_dtype=dtype, tp_axis=tp_axis,
                         name=f"j{kind}{dtype}{sp}{tp}")
    m, want = jpf.prefill(prompt)
    jpf.close()
    pf = SPPrefiller(tlm, _ring(sp, tp), PAGE, kv_cache_dtype=dtype,
                     tp_axis=tp_axis)
    n, got = pf.prefill(prompt)
    assert n == m == 5 and pf.variants == {8}
    assert pf.prefills == 1 and pf.prefill_tokens == 5 * PAGE
    kvh, hd = tlm.blocks[0].cache_heads, tlm.blocks[0].head_dim
    width = hd // 2 if dtype == "int4" else hd
    for pair in got:
        for member in pair:
            leaf = member[0] if isinstance(member, tuple) else member
            assert tuple(leaf.shape) == (5, kvh, PAGE, width)
    _hold_pages(want, got, dtype, tlm.blocks[0].head_dim)
    pf.close()
    assert pf.variants == set()


# -- serving ---------------------------------------------------------------


def _port_streams(tlm, prompts, steps, **kw):
    bat = ContinuousBatcher(tlm, slots=2, chunk=4, kv_layout="paged",
                            page_size=PAGE, prefill_chunk=2 * PAGE, **kw)
    rids = [bat.submit(p, steps) for p in prompts]
    out = bat.run()
    return bat, [np.asarray(out[r]) for r in rids]


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_sp_batcher_streams_match_jax_and_plain(kv):
    jlm, variables, tlm = _model()
    prompts = _prompts(3, (41, 7, 33, 25))
    plain, ref = _port_streams(tlm, prompts, 8, kv_cache_dtype=kv)
    plain.close()
    jbat = JC.ContinuousBatcher(
        jlm, variables, slots=2, chunk=4, kv_layout="paged", page_size=PAGE,
        prefill_chunk=2 * PAGE, kv_cache_dtype=kv,
        prefill=JCFG.PrefillConfig(sp_threshold=24, sp_width=2))
    jids = [jbat.submit(p, 8) for p in prompts]
    jout = jbat.run()
    jbat.close()
    bat, got = _port_streams(tlm, prompts, 8, kv_cache_dtype=kv, prefill=SP)
    for a, b, c in zip(ref, got, (jout[r] for r in jids)):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, np.asarray(c))
    st = bat.stats()
    assert st["sp_prefills"] == 3  # 41, 33, 25 >= 24
    assert st["sp_width"] == 2 and st["sp_failures"] == 0
    assert st["prefix_hits"] >= 3
    # A steady tick after an sp admission stages nothing.
    bat.submit(prompts[0], 24)
    bat.tick()
    h2d0 = bat.stats()["h2d_transfers"]
    for _ in range(2):
        bat.tick()
    assert bat.stats()["h2d_transfers"] == h2d0
    bat.run()
    bat.close()


def test_sp_refusals():
    tlm = _model()[2]
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(tlm, slots=2, kv_layout="slots", prefill=SP)
    mesh = build_mesh(MeshSpec((("tp", 2),)), ["cpu"] * 2)
    with pytest.raises(ValueError, match="tp axis"):
        ContinuousBatcher(tlm, slots=2, kv_layout="paged", page_size=PAGE,
                          mesh=mesh, parallel=ParallelConfig(tp=2),
                          prefill=SP, sp_mesh=_ring(2))
    with pytest.raises(ValueError, match="at least 2 ranks"):
        SPPrefiller(tlm, _ring(1), PAGE)
    with pytest.raises(ValueError, match="no 'sp' axis"):
        SPPrefiller(tlm, mesh, PAGE)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        SPPrefiller(tlm, _ring(2), PAGE, kv_cache_dtype="fp8")
    with pytest.raises(ValueError, match="distinct devices"):
        SPPrefiller(tlm, build_sp_mesh(2, devices=["cpu", "meta"]), PAGE)
    with pytest.raises(ValueError, match="not divisible by tp=4"):
        SPPrefiller(tlm, _ring(2, 4), PAGE, tp_axis="tp")
    with pytest.raises(ValueError, match="no full 8-token page"):
        SPPrefiller(tlm, _ring(2), PAGE).prefill(np.arange(8))
    with pytest.raises(ValueError, match="needs 4 devices"):
        build_sp_mesh(2, 2, devices=["cpu"] * 3)


def _disagg(tlm, prompts, sp_cfg, fail=False):
    decode = ContinuousBatcher(tlm, slots=2, chunk=4, kv_layout="paged",
                               page_size=PAGE)
    worker = PrefillWorker(tlm, page_size=PAGE, prefill_chunk=2 * PAGE,
                           pool_pages=3, prefill=sp_cfg, device="cpu")
    if fail:
        def down(prompt):
            raise RuntimeError("ring down")

        worker._sp.prefill = down
    srv = DisaggServer(decode, worker, DisaggConfig(
        prompt_threshold=24, busy_prompt_threshold=24), device="cpu")
    sids = [srv.submit(p, 8) for p in prompts]
    out = srv.run()
    st, failed = worker.stats(), srv.failed
    srv.close()
    decode.close()
    return [np.asarray(out[s]) for s in sids], st, failed


def test_disagg_sp_serves_past_pool_capacity():
    """Two allocatable pages: without sp the 41- and 60-token prompts
    collocate (no handoff); with sp both hand off, streams equal."""
    tlm = _model()[2]
    prompts = _prompts(5, (41, 7, 60))
    ref, st0, _ = _disagg(tlm, prompts, None)
    assert st0["handoffs"] == 0
    got, st1, failed = _disagg(tlm, prompts, SP)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)
    assert st1["sp_prefills"] == 2 and st1["handoffs"] == 2
    assert failed == 0 and st1["sp_failures"] == 0


def test_disagg_sp_failure_falls_back_or_fails():
    """A failing ring: the 24-token job (2 pages, the pool holds it) falls
    back to the chunk path and streams as without sp; the 60-token job (7
    pages) cannot, lands in ``failed_jobs`` and fails its request."""
    tlm = _model()[2]
    prompts = _prompts(6, (24, 60))
    ref, _, _ = _disagg(tlm, prompts[:1], None)
    got, st, failed = _disagg(tlm, prompts, SP, fail=True)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1].shape == (0,) and failed == 1
    assert st["sp_failures"] == 2 and st["sp_prefills"] == 0
    assert st["handoffs"] == 1


def test_sp_batcher_failures_fall_back_then_retire():
    """A ring whose member is lost (the health monitor's dead set) raises
    at every dispatch: each long admission falls back to the chunked path
    (streams equal the plain batcher's), every failure is counted and
    recorded, and the third in a row retires the ring."""
    tlm = _model()[2]
    prompts = _prompts(8, (41, 33, 25, 30))
    plain, ref = _port_streams(tlm, prompts, 8)
    plain.close()
    mon = DeviceHealthMonitor()
    mon.kill(1)
    fr = global_flight_recorder()
    _, cursor = fr.events_since(1 << 62)
    bat, got = _port_streams(tlm, prompts, 8, prefill=SP, health=mon)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)
    st = bat.stats()
    assert st["sp_failures"] == 3 and st["sp_prefills"] == 0
    assert st["sp_width"] == 1 and bat._sp is None
    events = [e["data"] for e in fr.events_since(cursor)[0]
              if e["kind"] == "sp_prefill"]
    assert len(events) == 3 and not any(e["ok"] for e in events)
    bat.close()


def test_sp_recovery_rebuilds_ring():
    """Kill member 1, shared by the tp=2 batcher (members 0, 1) and its
    (sp=2, tp=2) ring (members 0-3), mid-stream: the batcher goes to tp=1,
    the ring rebuilds from the survivors {0, 2, 3} at sp=2 (members 0 and
    2), re-armed for the old ring's two page buckets; streams equal the
    plain batcher's, and a later long admission takes the sp path."""
    tlm = _model()[2]
    prompts = _prompts(11, (41, 33))
    plain, ref = _port_streams(tlm, prompts, 12)
    plain.close()
    mon = DeviceHealthMonitor()
    bat = ContinuousBatcher(
        tlm, slots=2, chunk=4, kv_layout="paged", page_size=PAGE,
        prefill_chunk=2 * PAGE, mesh=build_mesh(MeshSpec((("tp", 2),)),
                                                ["cpu"] * 2),
        parallel=ParallelConfig(tp=2), health=mon, prefill=SP,
        sp_mesh=_ring(2, 2))
    rids = [bat.submit(p, 12) for p in prompts]
    for _ in range(2):
        bat.tick()
    assert bat.stats()["sp_prefills"] == 2 and bat._sp.tp == 2
    mon.kill(1)
    outs = bat.run()
    st = bat.stats()
    assert st["tp"] == 1 and st["recoveries"] == 1 and st["sp_width"] == 2
    assert [m.id for m in bat._sp._mesh.members()] == [0, 2]
    assert bat._sp.tp == 1 and bat._sp_granted == 2
    for rid, want in zip(rids, ref):
        np.testing.assert_array_equal(outs[rid], want)
    p_new = _prompts(12, (39,))[0]
    rid = bat.submit(p_new, 8)
    got = bat.run()[rid]
    assert bat.stats()["sp_prefills"] == 3
    solo, want = _port_streams(tlm, [p_new], 8)
    solo.close()
    np.testing.assert_array_equal(got, want[0])
    bat.close()
    assert bat._sp is None and bat._sp_granted == 0
