"""Elastic recovery of the port's tensor-parallel batcher, on the CPU, held
against the JAX package's (``tests/test_recovery.py``'s contract).

A GQA LM (``transformer_lm(37, 32, 2, 8, 64, max_len=48, kv_heads=4)``)
carries its weights from the JAX package's variables; the port's mesh
names ``cpu`` four times, its members told apart by member id, so killing
"device 3" kills the same shard in both packages. In f32 on the CPU a
tp=4 stream equals tp=2's and tp=1's, so every pin is token-exact:

- a kill mid-stream (member 3, and the lead, member 0) on both layouts:
  streams equal the JAX recovered batcher's, the port's uninterrupted
  tp=4 run's and its solo ``generate()``; the same ``stats()`` recovery
  books, the same reshard summary, each new shard's KV the ordered
  concatenation of the old shards' head ranges;
- speculative int8, int4 at tp=2 -> 1, a kill with a tick in flight, the
  triple kill to a tp=1 remnant (equal to JAX's), the ``min_tp`` floor,
  ``auto_reshard=False``, a member dead at construction, a kill during
  ``recover()``, a handoff landing with a loss pending;
- replay from the journal (a sampled request included), exactly-once
  ``on_token``, re-entry through the prefix cache, a queued cancel of a
  replayed request, the first new token's ITL, mid-chunked-prefill
  replay; flight events and metrics; no compile event;
- ``reshard_lm`` equal tensor for tensor to ``shard_lm`` on the shrunk
  mesh, ``KVReshardPlan``'s summary equal to the JAX plan's on the same
  arrays and its refusals; the monitor's membership semantics."""

import importlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.config import (
    ParallelConfig,
    RecoveryConfig,
    RuntimeConfig,
    SLOSpec,
    SpeculativeConfig,
)
from adapt_tpu_torch.control.journal import DispatcherJournal
from adapt_tpu_torch.control.registry import DeviceHealthMonitor
from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.core.mesh import MeshSpec, build_mesh
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.parallel.sharding import (
    Sharding,
    Shards,
    kv_head_sharding,
    plan_kv_reshard,
)
from adapt_tpu_torch.runtime.continuous import (
    ContinuousBatcher,
    DeviceLostError,
)
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.profiling import global_compile_sentinel
from adapt_tpu_torch.utils.tracing import global_flight_recorder

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JC = importlib.import_module("adapt_tpu.runtime.continuous")
JCFG = importlib.import_module("adapt_tpu.config")
JREG = importlib.import_module("adapt_tpu.control.registry")
JSH = importlib.import_module("adapt_tpu.parallel.sharding")
JTR = importlib.import_module("adapt_tpu.utils.tracing")

VOCAB = 37
PROMPTS = [np.asarray(p, np.int32) for p in (
    [1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12], [13, 14, 15, 16, 17])]
STEPS = [20, 14, 10]
BOOKS = ("tp", "recoveries", "recovery_migrated", "recovery_replayed",
         "recovery_dropped")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(args, key, **kw):
    jlm = J.transformer_lm(*args, **kw)
    variables = jax.device_get(
        jlm.graph.init(jax.random.PRNGKey(key), jnp.zeros((1, 4), jnp.int32)))
    tlm = T.transformer_lm(*args, device="cpu", **kw)
    tlm.load_state_dict(from_flax(variables))
    return jlm, variables, tlm


_CACHE = {}


def _target():
    if "t" not in _CACHE:
        _CACHE["t"] = _pair((VOCAB, 32, 2, 8, 64), 0, max_len=48,
                            kv_heads=4)
    return _CACHE["t"]


def _draft():
    if "d" not in _CACHE:
        _CACHE["d"] = _pair((VOCAB, 16, 1, 1, 32), 7, max_len=48)
    return _CACHE["d"]


def _mesh(tp=4):
    return build_mesh(MeshSpec((("tp", tp),)), ["cpu"] * tp)


def _port(tlm, tp=4, health=None, **kw):
    return ContinuousBatcher(tlm, mesh=_mesh(tp),
                             parallel=ParallelConfig(tp=tp), health=health,
                             **kw)


def _members(bat):
    return bat._mesh.members()


def _solo(tlm, prompt, steps, **kw):
    return T.generate(tlm, np.asarray(prompt)[None], steps, **kw)[0].numpy()


def _run_workload(bat, kill=(), monitor=None, dev_of=None):
    """Staggered admits; kill ``kill`` after the third request's first tick
    (every request slot-bound and decoding); run to drain."""
    ids = [bat.submit(PROMPTS[0], STEPS[0]), bat.submit(PROMPTS[1], STEPS[1])]
    bat.tick()
    bat.tick()
    ids.append(bat.submit(PROMPTS[2], STEPS[2]))
    bat.tick()
    devs = dev_of(bat) if kill else []
    for k in kill:
        monitor.kill(devs[k])
    out = bat.run()
    return [np.asarray(out[r]) for r in ids]


def _equal(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: request {i}")


def _reshard_event(rec):
    return rec.events("mesh_reshard")[-1]["data"]


def _kv_part(ev, dstate_bytes, old_ids, new_ids, lost):
    """The live-KV share of a reshard's moved bytes: the event's total less
    the replicated sampling state's (its layout is each package's own),
    counted by the plans' formula (once per new member other than the
    first survivor)."""
    src = next(i for i in old_ids if i not in lost)
    return ev["moved_bytes"] - dstate_bytes * sum(1 for i in new_ids
                                                   if i != src)


def _head_concat(snap, new_tp):
    """The expected new pieces: per new shard, the old pieces of its head
    range concatenated in order."""
    r = len(snap) // new_tp
    return [torch.cat(snap[j * r:(j + 1) * r], 1) for j in range(new_tp)]


# -- kill mid-stream --------------------------------------------------------


@pytest.mark.parametrize("layout,kill", [("slots", 3), ("paged", 3),
                                         ("paged", 0)])
def test_kill_midstream_equals_jax_and_uninterrupted(sim_mesh, layout, kill):
    """Kill one member of the tp=4 mesh mid-stream (member 0 is the lead,
    holding the replicated state's one copy): every in-flight greedy
    request finishes equal to the JAX recovered batcher's, the port's
    uninterrupted tp=4 run's and its solo ``generate()``; the recovery
    books and the reshard summary equal JAX's; per-shard KV bytes land at
    logical / 2."""
    jlm, variables, tlm = _target()
    kw = dict(slots=3, chunk=2)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=8)
    base = _run_workload(_port(tlm, **kw))
    mon = DeviceHealthMonitor()
    bat = _port(tlm, health=mon, **kw)
    got = _run_workload(bat, (kill,), mon, _members)
    jmon = JREG.DeviceHealthMonitor()
    jbat = JC.ContinuousBatcher(jlm, variables, mesh=sim_mesh(4),
                                parallel=JCFG.ParallelConfig(tp=4),
                                health=jmon, **kw)
    want = _run_workload(jbat, (kill,), jmon,
                         lambda b: list(b._mesh.devices.flat))
    _equal(got, want, "port vs JAX recovered")
    _equal(got, base, "killed vs uninterrupted")
    _equal(got, [_solo(tlm, p, s) for p, s in zip(PROMPTS, STEPS)],
           "killed vs solo generate()")
    st, jst = bat.stats(), jbat.stats()
    assert {k: st[k] for k in BOOKS} == {k: jst[k] for k in BOOKS} == dict(
        tp=2, recoveries=1, recovery_migrated=3, recovery_replayed=0,
        recovery_dropped=0)
    assert st["last_recovery_wall_s"] > 0.0
    assert st["cache_bytes_per_device"] * 2 == st["cache_bytes"]
    assert st["cache_bytes"] == jst["cache_bytes"]
    ev = _reshard_event(global_flight_recorder())
    jev = _reshard_event(JTR.global_flight_recorder())
    for k in ("old_tp", "new_tp", "lost", "host_staged_bytes"):
        assert ev[k] == jev[k], k
    new_ids = [m.id for m in _members(bat)]
    assert new_ids == [int(d.id) for d in jbat._mesh.devices.flat]
    dstate = sum(t.numel() * t.element_size() for t in bat._dstate.values())
    jdstate = sum(x.nbytes for x in jax.tree.leaves(jbat._dstate))
    assert _kv_part(ev, dstate, range(4), new_ids, {kill}) == _kv_part(
        jev, jdstate, range(4), new_ids, {kill}) > 0


@pytest.mark.parametrize("kill", [3, 0])
def test_migrated_kv_is_the_ordered_concat_of_old_shards(kill):
    """Each new shard's K and V, on both layouts, is ``torch.equal`` to the
    ordered concatenation of the old shards' head ranges snapshotted at the
    kill (``auto_reshard=False`` stops the batcher at the loss), the lead
    kill included; the model is rebuilt at tp=2 on the survivors."""
    _, _, tlm = _target()
    for kw in (dict(), dict(kv_layout="paged", page_size=8)):
        mon = DeviceHealthMonitor()
        bat = _port(tlm, health=mon, slots=3, chunk=2,
                    recovery=RecoveryConfig(auto_reshard=False), **kw)
        for p, s in zip(PROMPTS, STEPS):
            bat.submit(p, s)
        bat.tick()
        bat.tick()
        snap = [[[t.clone() for t in c] for c in pair] for pair in bat._caches]
        mon.kill(_members(bat)[kill])
        with pytest.raises(DeviceLostError, match="auto_reshard"):
            bat.tick()
        out = bat.recover()
        assert out["new_tp"] == 2 and out["migrated"] == 3
        assert [m.id for m in _members(bat)] == [i for i in range(4)
                                                  if i != kill][:2]
        assert isinstance(bat.lm, T.ShardedLM) and bat.lm.tp == 2
        for pair, spair in zip(bat._caches, snap):
            for c, sc in zip(pair, spair):
                assert isinstance(c, Shards) and len(c) == 2
                for a, b in zip(c, _head_concat(sc, 2)):
                    assert torch.equal(a, b)
        bat.run()
        bat.close()


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_kill_speculative_int8(layout):
    """Speculation with a replicated draft over int8 caches: the killed run
    equals solo ``generate(kv_cache_dtype="int8")``, and both members of
    every ``(values, scales)`` pair land at logical / 2 a shard."""
    _, _, tlm = _target()
    _, _, tdraft = _draft()
    kw = dict(slots=2, kv_cache_dtype="int8", draft_lm=tdraft,
              speculative=SpeculativeConfig(draft_k=3))
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=8)
    mon = DeviceHealthMonitor()
    bat = _port(tlm, health=mon, **kw)
    r1 = bat.submit(PROMPTS[0], 9)
    r2 = bat.submit(PROMPTS[1], 7)
    bat.tick()
    mon.kill(_members(bat)[2])
    out = bat.run()
    st = bat.stats()
    assert st["tp"] == 2 and st["recoveries"] == 1
    assert st["cache_bytes_per_device"] * 2 == st["cache_bytes"]
    for pair in bat._caches:
        for c in pair:
            assert len(c) == 2
            for values, scales in c:
                assert values.dtype == torch.int8 and values.shape[1] == 2
                assert scales.dtype == torch.float32 and scales.shape[1] == 2
    assert bat._draft_caches[0][0].device == bat.device
    for r, p, s in ((r1, PROMPTS[0], 9), (r2, PROMPTS[1], 7)):
        np.testing.assert_array_equal(
            out[r], _solo(tlm, p, s, kv_cache_dtype="int8"))
    bat.close()


def test_int4_tp2_to_tp1_migration():
    """int4 pools split at tp=2 (both members at logical / 2) migrate live
    onto the tp=1 remnant: the stream equals solo
    ``generate(kv_cache_dtype="int4")`` and the caches are plain again."""
    _, _, tlm = _target()
    p = np.asarray([1, 2, 3], np.int32)
    mon = DeviceHealthMonitor()
    bat = _port(tlm, tp=2, health=mon, slots=2, chunk=2,
                kv_cache_dtype="int4", kv_layout="paged", page_size=8)
    st = bat.stats()
    assert st["cache_bytes_per_device"] * 2 == st["cache_bytes"]
    r = bat.submit(p, 10)
    bat.tick()
    mon.kill(_members(bat)[1])
    out = bat.run()
    st = bat.stats()
    assert st["tp"] == 1 and st["recoveries"] == 1
    assert isinstance(bat._caches[0][0], tuple)
    assert isinstance(bat.lm, T.TransformerLM)
    np.testing.assert_array_equal(out[r],
                                  _solo(tlm, p, 10, kv_cache_dtype="int4"))
    bat.close()


def test_kill_with_tick_in_flight_drains_pipeline():
    """A kill with a tick in flight (``pipeline_depth=2``): recover()
    commits it first, then shrinks tp=4 -> 2; streams equal solo
    ``generate()``, ``on_token`` stays exactly once, the pipeline ends
    empty."""
    _, _, tlm = _target()
    mon = DeviceHealthMonitor()
    bat = _port(tlm, health=mon, slots=3, chunk=2, kv_layout="paged",
                page_size=8, runtime=RuntimeConfig(pipeline_depth=2))
    delivered: dict = {}

    def cb(rid, tok, idx):
        delivered.setdefault(rid, []).append((idx, tok))

    ids = [bat.submit(PROMPTS[i], STEPS[i], on_token=cb) for i in range(2)]
    bat.tick()
    bat.tick()
    ids.append(bat.submit(PROMPTS[2], STEPS[2], on_token=cb))
    bat.tick()
    assert bat.stats()["inflight"]
    mon.kill(_members(bat)[3])
    out = bat.run()
    st = bat.stats()
    assert st["tp"] == 2 and st["recoveries"] == 1
    assert st["active"] == 0 and not st["inflight"]
    assert st["admitted"] == 3 == st["completed"]
    for i, rid in enumerate(ids):
        solo = _solo(tlm, PROMPTS[i], STEPS[i])
        np.testing.assert_array_equal(out[rid], solo)
        assert [j for j, _ in delivered[rid]] == list(range(len(solo)))
        np.testing.assert_array_equal([t for _, t in delivered[rid]], solo)
    bat.close()


def test_triple_kill_single_device_fallback_equals_jax(sim_mesh):
    """Losing 3 of 4 members leaves a tp=1 remnant (a plain LM on the
    survivor's device): streams equal solo ``generate()`` and the JAX
    package's triple-killed batcher; later traffic serves; losing the
    remnant's member raises."""
    jlm, variables, tlm = _target()
    mon = DeviceHealthMonitor()
    bat = _port(tlm, health=mon, slots=2, chunk=2)
    r = bat.submit(PROMPTS[1], 12)
    bat.tick()
    devs = _members(bat)
    for k in (0, 2, 3):
        mon.kill(devs[k])
    out = bat.run()
    st = bat.stats()
    assert st["tp"] == 1 and st["recoveries"] == 1
    assert isinstance(bat.lm, T.TransformerLM) and bat._mesh is None
    jmon = JREG.DeviceHealthMonitor()
    jbat = JC.ContinuousBatcher(jlm, variables, mesh=sim_mesh(4),
                                parallel=JCFG.ParallelConfig(tp=4),
                                health=jmon, slots=2, chunk=2)
    jr = jbat.submit(PROMPTS[1], 12)
    jbat.tick()
    jdevs = list(jbat._mesh.devices.flat)
    for k in (0, 2, 3):
        jmon.kill(jdevs[k])
    jout = jbat.run()
    np.testing.assert_array_equal(out[r], np.asarray(jout[jr]))
    np.testing.assert_array_equal(out[r], _solo(tlm, PROMPTS[1], 12))
    assert {k: st[k] for k in BOOKS} == {k: jbat.stats()[k] for k in BOOKS}
    r2 = bat.submit(PROMPTS[0], 5)
    np.testing.assert_array_equal(bat.run()[r2], _solo(tlm, PROMPTS[0], 5))
    bat.submit(PROMPTS[2], 4)
    mon.kill(devs[1])
    assert bat.device_lost_pending()
    with pytest.raises(DeviceLostError, match="every device"):
        bat.tick()
    with pytest.raises(DeviceLostError):
        bat.tick()  # the loss stays pending after a failed recovery
    bat.close()


def test_min_tp_floor_refuses_recovery():
    """``min_tp``: survivors below the floor raise, and keep raising."""
    _, _, tlm = _target()
    mon = DeviceHealthMonitor()
    bat = _port(tlm, health=mon, slots=2, chunk=2,
                recovery=RecoveryConfig(min_tp=2))
    bat.submit(PROMPTS[0], 8)
    bat.tick()
    for m in _members(bat)[1:]:
        mon.kill(m)
    with pytest.raises(DeviceLostError, match="min_tp"):
        bat.tick()
    assert bat.device_lost_pending() and bat.stats()["tp"] == 4
    bat.close()


def test_auto_reshard_off_raises_then_manual_recover():
    _, _, tlm = _target()
    mon = DeviceHealthMonitor()
    bat = _port(tlm, health=mon, slots=2, chunk=2,
                recovery=RecoveryConfig(auto_reshard=False))
    r = bat.submit(PROMPTS[0], 12)
    bat.tick()
    mon.kill(_members(bat)[2])
    assert bat.device_lost_pending()
    for _ in range(2):
        with pytest.raises(DeviceLostError, match="auto_reshard"):
            bat.tick()
    bat.recover()
    assert not bat.device_lost_pending()
    np.testing.assert_array_equal(bat.run()[r], _solo(tlm, PROMPTS[0], 12))
    assert bat.stats()["tp"] == 2
    bat.close()


def test_dead_at_construction_detected():
    """A member already dead on the shared monitor sends no future leave:
    the constructor seeds the loss from ``dead_ids()``."""
    _, _, tlm = _target()
    mon = DeviceHealthMonitor()
    mesh = _mesh(4)
    mon.kill(mesh.members()[3])
    bat = ContinuousBatcher(tlm, mesh=mesh, parallel=ParallelConfig(tp=4),
                            health=mon, slots=2, chunk=2)
    assert bat.device_lost_pending()
    r = bat.submit(PROMPTS[0], STEPS[0])
    out = bat.run()
    st = bat.stats()
    assert st["tp"] == 2 and st["recoveries"] == 1
    np.testing.assert_array_equal(out[r], _solo(tlm, PROMPTS[0], STEPS[0]))
    bat.close()


def test_kill_during_recover_stays_pending():
    """A member killed on another thread after recover() read the dead set
    (its leave queued against the old membership) stays pending: the next
    tick recovers again, tp 4 -> 2 -> 1, and the stream is intact."""
    _, _, tlm = _target()
    mon = DeviceHealthMonitor()
    bat = _port(tlm, health=mon, slots=2, chunk=2)
    r = bat.submit(PROMPTS[1], 14)
    bat.tick()
    devs = _members(bat)
    read = mon.dead_ids

    def racing_dead_ids():
        snap = read()
        t = threading.Thread(target=mon.kill, args=(devs[1],))
        t.start()
        t.join()
        return snap

    mon.dead_ids = racing_dead_ids
    mon.kill(devs[3])
    bat.tick()
    mon.dead_ids = read
    assert bat.stats()["tp"] == 2 and bat.device_lost_pending()
    out = bat.run()
    st = bat.stats()
    assert st["tp"] == 1 and st["recoveries"] == 2
    np.testing.assert_array_equal(out[r], _solo(tlm, PROMPTS[1], 14))
    bat.close()


def test_handoff_with_loss_pending_recovers_first():
    """A disaggregated handoff landing between ticks while a loss is
    pending never lands on the old layout: with ``auto_reshard=False`` it
    raises before any pager mutation; with it on, the batcher recovers
    first and lands each slice on the shrunk layout, and the request then
    admits as a prefix hit, equal to solo ``generate()``."""
    _, _, tlm = _target()
    prompt = np.arange(1, 20, dtype=np.int32)  # 2 full pages of 8
    src = ContinuousBatcher(tlm, slots=1, chunk=2, kv_layout="paged",
                            page_size=8)
    src.submit(prompt, 20)
    src.tick()
    pages = src._pager.owned(0)[:2]
    host = [src._fetch_page_host(p) for p in pages]
    blocks = [tuple(torch.stack([h[b][m] for h in host]) for m in range(2))
              for b in range(len(host[0]))]
    src.close()
    for auto in (False, True):
        mon = DeviceHealthMonitor()
        bat = _port(tlm, health=mon, slots=2, chunk=2, kv_layout="paged",
                    page_size=8, recovery=RecoveryConfig(auto_reshard=auto))
        mon.kill(_members(bat)[0])
        if not auto:
            with pytest.raises(DeviceLostError):
                bat.adopt_prefill_pages(prompt, blocks, 8, False)
            assert bat._pager.stats().cached == 0
            continue
        assert bat.adopt_prefill_pages(prompt, blocks, 8, False) == 2
        st = bat.stats()
        assert st["tp"] == 2 and st["recoveries"] == 1
        assert [len(c) for c in bat._caches[0]] == [2, 2]
        r = bat.submit(prompt, 6)
        out = bat.run()
        assert bat.stats()["prefix_hits"] > 0
        np.testing.assert_array_equal(out[r], _solo(tlm, prompt, 6))
        bat.close()


# -- replay -----------------------------------------------------------------


def test_replay_policy_journal_roundtrip(tmp_path):
    """``policy="replay"``: every in-flight request re-queues from its
    journaled record (``source="journal"``), greedy streams equal solo
    ``generate()``, a sampled request equals its own uninterrupted run,
    and the journal holds nothing pending once drained."""
    _, _, tlm = _target()
    sampled = dict(temperature=0.8, top_k=5, rng=21)

    def drive(bat, kill=None, mon=None):
        ids = [bat.submit(PROMPTS[0], STEPS[0]),
               bat.submit(PROMPTS[1], 12, **sampled)]
        bat.tick()
        bat.tick()
        ids.append(bat.submit(PROMPTS[2], STEPS[2]))
        bat.tick()
        if kill is not None:
            mon.kill(_members(bat)[kill])
        out = bat.run()
        return [np.asarray(out[r]) for r in ids]

    base = drive(_port(tlm, slots=3, chunk=2))
    journal = DispatcherJournal(str(tmp_path / "wal"))
    rec = global_flight_recorder()
    _, cursor = rec.events_since(1 << 62)
    mon = DeviceHealthMonitor()
    bat = _port(tlm, health=mon, slots=3, chunk=2, journal=journal,
                recovery=RecoveryConfig(policy="replay"))
    got = drive(bat, 1, mon)
    st = bat.stats()
    assert st["tp"] == 2
    assert st["recovery_replayed"] == 3 and st["recovery_migrated"] == 0
    _equal(got, base, "replayed vs uninterrupted")
    np.testing.assert_array_equal(got[0], _solo(tlm, PROMPTS[0], STEPS[0]))
    events = [e["data"] for e in rec.events_since(cursor)[0]
              if e["kind"] == "replayed_from_journal"]
    assert len(events) == 3
    assert all(e["source"] == "journal" for e in events)
    assert journal.pending_ids() == set()
    _, pending, _ = journal.load()
    assert pending == {}
    bat.close()
    journal.close()


def test_replay_falls_back_to_memory_when_the_journal_fails(tmp_path):
    """A journaled record that cannot be read (its payload gone) replays
    from the in-memory record, loudly: ``source="memory"`` on the flight
    event, and the stream is still exact."""
    import os

    _, _, tlm = _target()
    journal = DispatcherJournal(str(tmp_path / "wal"))
    mon = DeviceHealthMonitor()
    bat = _port(tlm, health=mon, slots=2, chunk=2, journal=journal,
                recovery=RecoveryConfig(policy="replay"))
    r = bat.submit(PROMPTS[1], 12)
    bat.tick()
    os.unlink(journal._payload_path(r))
    rec = global_flight_recorder()
    _, cursor = rec.events_since(1 << 62)
    mon.kill(_members(bat)[1])
    out = bat.run()
    events = [e["data"] for e in rec.events_since(cursor)[0]
              if e["kind"] == "replayed_from_journal"]
    assert [e["source"] for e in events] == ["memory"]
    np.testing.assert_array_equal(out[r], _solo(tlm, PROMPTS[1], 12))
    bat.close()
    journal.close()


def test_journal_ids_continue_and_rejection_done_marked(tmp_path):
    """A batcher over an existing journal starts its ids past the
    journal's; a submit the pre-check sheds is never journaled, one the
    bounded append rejects after journaling is done-marked, a finish is
    done-marked."""
    from adapt_tpu_torch.config import SchedulerConfig
    from adapt_tpu_torch.runtime.scheduler import QueueFullError

    _, _, tlm = _target()
    journal = DispatcherJournal(str(tmp_path / "wal"))
    journal.record_submit(6, np.asarray([1, 2], np.int32), meta={})
    bat = _port(tlm, slots=1, journal=journal,
                scheduler=SchedulerConfig(max_queue_depth=1))
    assert bat.submit(PROMPTS[0], 4) == 7
    with pytest.raises(QueueFullError):
        bat.submit(PROMPTS[1], 4)
    assert journal.pending_ids() == {6, 7}
    check, calls = bat._queue.check, []

    def racing_check(tenant, prio):
        # The pre-check passes; the append's own check (a racing submit
        # filled the queue in between) rejects.
        calls.append(1)
        if len(calls) > 1:
            check(tenant, prio)

    bat._queue.check = racing_check
    with pytest.raises(QueueFullError):
        bat.submit(PROMPTS[1], 4)
    assert journal.pending_ids() == {6, 7}
    bat.run()
    assert journal.pending_ids() == {6}
    bat.close()
    journal.close()


def test_replay_streams_exactly_once():
    """A replayed request's ``on_token`` transcript has each index once;
    its TTFT is observed once."""
    _, _, tlm = _target()
    reg = global_metrics()
    ttft0 = reg.snapshot()["histograms"].get("continuous.ttft_s", {}).get(
        "count", 0)
    mon = DeviceHealthMonitor()
    bat = _port(tlm, health=mon, slots=2, chunk=2,
                recovery=RecoveryConfig(policy="replay"))
    stream: list = []
    r = bat.submit(PROMPTS[0], STEPS[0],
                   on_token=lambda rid, tok, idx: stream.append((idx, tok)))
    bat.tick()
    bat.tick()
    assert len(stream) >= 2
    mon.kill(_members(bat)[2])
    out = bat.run()
    assert bat.stats()["recovery_replayed"] == 1
    assert [i for i, _ in stream] == list(range(len(out[r])))
    np.testing.assert_array_equal([t for _, t in stream], out[r])
    np.testing.assert_array_equal(out[r], _solo(tlm, PROMPTS[0], STEPS[0]))
    ttft1 = reg.snapshot()["histograms"]["continuous.ttft_s"]["count"]
    assert ttft1 - ttft0 == 1
    bat.close()


def test_replay_reenters_prefix_cache():
    """A replayed paged request re-admits through the prefix cache (its
    pages survive the reshard with their contents), after a kill of the
    lead member."""
    _, _, tlm = _target()
    mon = DeviceHealthMonitor()
    bat = _port(tlm, health=mon, slots=2, chunk=2, kv_layout="paged",
                page_size=8, recovery=RecoveryConfig(policy="replay"))
    prompt = np.arange(1, 20, dtype=np.int32)
    r = bat.submit(prompt, 16)
    bat.tick()
    bat.tick()
    hits0 = bat.stats()["prefix_hits"]
    mon.kill(_members(bat)[0])
    out = bat.run()
    st = bat.stats()
    assert st["recovery_replayed"] == 1
    assert st["prefix_hits"] > hits0
    assert [m.id for m in _members(bat)] == [1, 2]
    np.testing.assert_array_equal(out[r], _solo(tlm, prompt, 16))
    bat.close()


def test_queued_cancel_of_replayed_request_keeps_delivered_stream():
    _, _, tlm = _target()
    mon = DeviceHealthMonitor()
    bat = _port(tlm, health=mon, slots=2, chunk=2,
                recovery=RecoveryConfig(policy="replay"))
    stream: list = []
    r = bat.submit(PROMPTS[0], STEPS[0],
                   on_token=lambda rid, tok, idx: stream.append(int(tok)))
    bat.tick()
    bat.tick()
    assert len(stream) >= 2
    mon.kill(_members(bat)[2])
    bat.recover()
    assert bat.cancel(r)
    out = bat.run()
    np.testing.assert_array_equal(out[r], np.asarray(stream, np.int32))
    r2 = bat.submit(PROMPTS[1], STEPS[1])
    np.testing.assert_array_equal(bat.run()[r2],
                                  _solo(tlm, PROMPTS[1], STEPS[1]))
    bat.close()


def test_replay_first_new_token_itl_spans_recovery():
    _, _, tlm = _target()
    mon = DeviceHealthMonitor()
    bat = _port(tlm, health=mon, slots=2, chunk=2,
                recovery=RecoveryConfig(policy="replay"))
    r = bat.submit(PROMPTS[0], STEPS[0],
                   slo=SLOSpec(itl_budget_s=5.0, tenant="rec"))
    bat.tick()
    bat.tick()
    mon.kill(_members(bat)[1])
    bat.recover()
    req = next(q for q in bat._queue if q.req_id == r)
    assert req.t_last_delivered > 0.0
    req.t_last_delivered -= 100.0  # a recovery stall past the budget
    bat.run()
    assert bat.stats()["slo_itl_missed"] >= 1
    bat.close()


def test_mid_chunked_prefill_replays():
    _, _, tlm = _target()
    mon = DeviceHealthMonitor()
    bat = _port(tlm, health=mon, slots=2, chunk=2, kv_layout="paged",
                page_size=8, prefill_chunk=8)
    long_prompt = np.arange(1, 30, dtype=np.int32)  # 4 chunks
    r = bat.submit(long_prompt, 6)
    bat.tick()
    assert bat.slots[0].pf_done >= 0
    mon.kill(_members(bat)[1])
    out = bat.run()
    st = bat.stats()
    assert st["recovery_replayed"] == 1 and st["recovery_migrated"] == 0
    np.testing.assert_array_equal(out[r], _solo(tlm, long_prompt, 6))
    bat.close()


# -- invariants and books ---------------------------------------------------


@pytest.mark.parametrize("quant", ["native", "int8"])
def test_post_reshard_invariants(quant):
    """After tp=4 -> 2: each shard holds logical / 2 of both members, a
    steady tick stages nothing and fetches once, each decode step makes a
    tp=2 step's attention calls, and no compile event or count moves
    (recovery builds no kernel and grants nothing)."""
    _, _, tlm = _target()
    sentinel = global_compile_sentinel()
    counts0, events0 = sentinel.counts(), sentinel.events
    gauges0 = {k: v for k, v in global_metrics().snapshot()["gauges"].items()
               if k.startswith("engine.compiles.")}
    mon = DeviceHealthMonitor()
    bat = _port(tlm, health=mon, slots=2, chunk=2, kv_layout="paged",
                page_size=8, kv_cache_dtype=quant)
    r1 = bat.submit(PROMPTS[0], 30)
    bat.tick()
    bat.tick()
    mon.kill(_members(bat)[3])
    bat.tick()
    st = bat.stats()
    assert st["tp"] == 2
    assert st["cache_bytes_per_device"] * 2 == st["cache_bytes"]
    for pair in bat._caches:
        for c in pair:
            assert isinstance(c, Shards) and len(c) == 2
            for piece in c:
                for m in (piece if isinstance(piece, tuple) else (piece,)):
                    assert m.shape[1] * 2 == 4 and m.is_contiguous()
    bat.tick()  # the first post-recovery tick re-uploaded the table
    h0 = bat.stats()["h2d_transfers"]
    d0 = bat.stats()["d2h_fetches"]
    calls = []
    blk = bat.lm.blocks[0]
    orig = type(blk.attn_shards[0]).decode_step_paged

    def counting(self, *a, **k):
        calls.append(1)
        return orig(self, *a, **k)

    type(blk.attn_shards[0]).decode_step_paged = counting
    try:
        bat.tick()
    finally:
        type(blk.attn_shards[0]).decode_step_paged = orig
    assert len(calls) == 2 * bat.chunk * len(bat.lm.blocks)
    after = bat.stats()
    assert after["h2d_transfers"] == h0
    assert after["d2h_fetches"] - d0 == 1
    out = bat.run()
    assert r1 in out
    assert sentinel.counts() == counts0 and sentinel.events == events0
    gauges1 = {k: v for k, v in global_metrics().snapshot()["gauges"].items()
               if k.startswith("engine.compiles.")}
    assert gauges1 == gauges0
    bat.close()


def test_flight_events_and_recovery_metrics():
    _, _, tlm = _target()
    rec = global_flight_recorder()
    reg = global_metrics()
    k0 = rec.kind_counts()
    snap0 = reg.snapshot()
    mon = DeviceHealthMonitor()
    bat = _port(tlm, health=mon, slots=2, chunk=2)
    bat.submit(PROMPTS[0], 12)
    bat.tick()
    mon.kill(_members(bat)[3])
    bat.run()
    k1 = rec.kind_counts()
    for kind in ("device_lost", "mesh_reshard", "kv_migrated"):
        assert k1.get(kind, 0) - k0.get(kind, 0) == 1, kind
    ev = _reshard_event(rec)
    assert ev["old_tp"] == 4 and ev["new_tp"] == 2 and ev["lost"] == [3]
    assert ev["moved_bytes"] > 0 and ev["host_staged_bytes"] > 0
    assert ev["weight_host_staged_bytes"] > 0
    snap1 = reg.snapshot()
    c0 = snap0["counters"].get("recovery.migrated_total", 0.0)
    assert snap1["counters"]["recovery.migrated_total"] - c0 == 1.0
    h = snap1["histograms"]["recovery.wall_s"]
    assert h["count"] >= 1 and h["max"] > 0.0
    bat.close()


# -- the pieces -------------------------------------------------------------


_KINDS = {
    # GQA: ``attn.q`` rows and ``attn.kv`` as Blocks of 2.
    "gqa": lambda: _target()[2],
    # MHA: the fused ``attn.qkv`` as Blocks of 3.
    "mha": lambda: T.transformer_lm(VOCAB, 32, 2, 4, 64, max_len=48,
                                    device="cpu", seed=3),
    # MoE: every expert's hidden slice.
    "moe": lambda: T.transformer_lm(VOCAB, 32, 1, 4, 64, max_len=48,
                                    moe_experts=4, moe_top_k=2,
                                    device="cpu", seed=5),
}


@pytest.mark.parametrize("kind,dead,size", [
    ("gqa", [3], 2), ("gqa", [0], 2), ("gqa", [0, 1], 2),
    ("gqa", [0, 2, 3], 1), ("mha", [1], 2), ("mha", [1, 2, 3], 1),
    ("moe", [0], 2)])
def test_reshard_lm_equals_shard_lm_on_the_shrunk_mesh(kind, dead, size):
    """The weights rebuilt from the old shards' slices equal, tensor for
    tensor, ``shard_lm`` of the original LM on the shrunk mesh (the plain
    LM for a tp=1 remnant), the lost shards' slices staged through the
    host; a fused projection's blocks concatenate within each block."""
    tlm = _KINDS[kind]()
    mesh = _mesh(4)
    slm = T.shard_lm(tlm, mesh)
    new = mesh.survivors("tp", dead, size)
    assert [m.id for m in new.members()] == [i for i in range(4)
                                              if i not in dead][:size]
    plan = plan_kv_reshard(mesh.members("tp"), new.members(), dead)
    got = T.reshard_lm(slm, plan, new)
    want = T.shard_lm(tlm, new) if size > 1 else tlm
    assert type(got) is type(want)
    a, b = got.state_dict(), want.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert plan.host_staged_bytes > 0


@pytest.mark.parametrize("kill,new_idx", [(3, (0, 1)), (0, (1, 2)),
                                          ((0, 2, 3), (1,))])
def test_plan_summary_equals_jax(sim_mesh, kill, new_idx):
    """The same head-split native and int8 leaves and a replicated leaf,
    migrated by the port's plan and the JAX package's: equal values, equal
    summaries."""
    from jax.sharding import NamedSharding, SingleDeviceSharding
    from jax.sharding import PartitionSpec as JP

    lost = kill if isinstance(kill, tuple) else (kill,)
    rng = np.random.RandomState(3)
    native = rng.randn(3, 4, 8, 6).astype(np.float32)
    vals = rng.randint(-127, 128, (3, 4, 8, 6)).astype(np.int8)
    scales = rng.rand(3, 4, 8, 1).astype(np.float32)
    repl = rng.randn(5, 7).astype(np.float32)
    jmesh = sim_mesh(4)
    jdevs = list(jmesh.devices.flat)
    jsh = JSH.kv_head_sharding(jmesh, "tp")
    jtree = [jax.device_put(x, jsh) for x in (native, vals, scales)]
    jnew = [jdevs[i] for i in new_idx]
    jplan = JSH.plan_kv_reshard(jdevs, jnew, lost)
    if len(jnew) > 1:
        nm = jax.sharding.Mesh(np.asarray(jnew), ("tp",))
        jnsh, jrsh = JSH.kv_head_sharding(nm, "tp"), NamedSharding(nm, JP())
    else:
        jnsh = jrsh = SingleDeviceSharding(jnew[0])
    jout = jplan.migrate_tree([jtree[0], (jtree[1], jtree[2])], jnsh)
    jplan.migrate_replicated({"r": jax.device_put(repl, NamedSharding(
        jmesh, JP()))}, jrsh)
    mesh = _mesh(4)
    sh = kv_head_sharding(mesh)
    tree = [sh.shard(torch.from_numpy(native)),
            Shards(list(zip(sh.shard(torch.from_numpy(vals)),
                            sh.shard(torch.from_numpy(scales)))),
                   sh, native.shape)]
    new = mesh.survivors("tp", lost, len(new_idx))
    plan = plan_kv_reshard(mesh.members("tp"), new.members(), lost)
    out = plan.migrate_tree(tree, kv_head_sharding(new))
    plan.migrate_replicated({"r": torch.from_numpy(repl)}, Sharding(new))
    assert plan.summary() == jplan.summary()

    def whole(x):
        if isinstance(x, Shards):
            return torch.cat(list(x), 1).numpy()
        return x.numpy()

    np.testing.assert_array_equal(whole(out[0]), np.asarray(jout[0]))
    for k in range(2):
        got = (whole(Shards([p[k] for p in out[1]])) if isinstance(
            out[1], Shards) else out[1][k].numpy())
        np.testing.assert_array_equal(got, np.asarray(jout[1][k]))


def test_plan_refuses_misaligned_and_uncovered_ranges():
    """The plan's refusals, with the JAX plan's messages: a new tp that
    does not divide the old, a new member that did not survive, source
    ranges that start past the covered span or stop short."""
    mesh = _mesh(4)
    m = mesh.members("tp")
    with pytest.raises(ValueError, match="must divide"):
        plan_kv_reshard(m, m[:3], [3])
    with pytest.raises(ValueError, match="not a surviving"):
        plan_kv_reshard(m, m[2:], [3])
    new = mesh.survivors("tp", [3], 2)
    plan = plan_kv_reshard(m, new.members(), [3])
    t = torch.zeros(2, 4, 3)
    sh = kv_head_sharding(mesh)
    gap = Shards([t[:, 1:2], t[:, 2:4]], sh, t.shape,
                 index=[(slice(0, 2), slice(1, 2), slice(0, 3)),
                        (slice(0, 2), slice(2, 4), slice(0, 3))])
    with pytest.raises(ValueError, match="misaligned"):
        plan.migrate(gap, kv_head_sharding(new))
    short = Shards([t[:, 0:1], t[:, 2:3]], sh, t.shape,
                   index=[(slice(0, 2), slice(0, 1), slice(0, 3)),
                          (slice(0, 2), slice(2, 3), slice(0, 3))])
    with pytest.raises(ValueError, match="not covered"):
        plan.migrate(short, kv_head_sharding(new))


def test_health_monitor_membership_semantics():
    """Tracked members own leases keyed by member id (the JAX monitor's
    keys for ``sim_mesh(4)``'s devices 0-3); a kill revokes exactly one,
    watchers see the leave, re-tracking does not resurrect, a registry
    leave folds into the dead set."""
    mon = DeviceHealthMonitor()
    devs = _mesh(4).members()
    assert [DeviceHealthMonitor.device_key(d) for d in devs] == [
        JREG.DeviceHealthMonitor.device_key(d) for d in jax.devices()[:4]]
    mon.track(devs)
    assert {DeviceHealthMonitor.device_key(d) for d in devs} <= set(
        mon.registry.alive())
    events = []
    mon.watch(lambda ev, key: events.append((ev, key)))
    key = mon.kill(devs[2])
    assert key == "device:2" and ("leave", key) in events
    assert mon.is_dead(devs[2]) and mon.is_dead(2) and not mon.is_dead(devs[0])
    assert mon.alive_devices(devs) == [devs[0], devs[1], devs[3]]
    mon.kill(2)
    assert [e for e in events if e == ("leave", key)] == [("leave", key)]
    mon.track(devs)
    assert key not in set(mon.registry.alive())
    mon.registry.deregister(DeviceHealthMonitor.device_key(devs[1]))
    assert mon.is_dead(devs[1]) and mon.dead_ids() == {1, 2}
    assert mon.alive_devices(devs) == [devs[0], devs[3]]


def test_tp1_mesh_tracks_its_member_and_raises_on_loss():
    """A tp=1 mesh keeps its one member: losing it raises instead of
    dispatching onto a dead shard; no mesh means nothing to track."""
    _, _, tlm = _target()
    mon = DeviceHealthMonitor()
    bat = _port(tlm, tp=1, health=mon, slots=2)
    assert [m.id for m in bat._mesh_devices] == [0]
    bat.submit(PROMPTS[0], 4)
    mon.kill(0)
    with pytest.raises(DeviceLostError, match="every device"):
        bat.tick()
    plain = ContinuousBatcher(tlm, slots=2, health=DeviceHealthMonitor())
    assert plain.recover() == {"old_tp": 1, "new_tp": 1, "lost": []}
