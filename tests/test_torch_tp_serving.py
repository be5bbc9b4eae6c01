"""The port's tensor-parallel serving (``ContinuousBatcher(mesh=,
parallel=ParallelConfig(tp))`` over ``shard_lm``), on the CPU.

A GQA LM (``transformer_lm(37, 32, 2, 8, 64, max_len=48, kv_heads=4)``)
carries its weights from the JAX package's variables. Its tp=4
``logits_full`` is held against JAX's on tp-placed variables at rtol =
atol = 2e-5 (the JAX package's own tolerance). Greedy streams of the
port's tp=4 and tp=2 batchers (both layouts; native, int8 and int4;
speculative; pipeline depth 2) must be token-equal to the JAX tp=4
batcher's on the 4-device simulated mesh and to the port's tp=1 batcher
on the same traffic. Each shard holds logical / tp KV bytes, a steady tick
stages nothing, and the JAX batcher's refusals hold. On the CPU every
shard runs the kernels' plain versions."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.config import (
    ParallelConfig,
    RuntimeConfig,
    SpeculativeConfig,
)
from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.core.mesh import MeshSpec, build_mesh
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.parallel.sharding import Shards
from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JC = importlib.import_module("adapt_tpu.runtime.continuous")
JCFG = importlib.import_module("adapt_tpu.config")

VOCAB = 37
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers at once,
    and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(args, key, **kw):
    """A JAX LM, its variables from ``key`` and the port's LM carrying
    them."""
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


def _mesh(tp, axis="tp"):
    return build_mesh(MeshSpec(((axis, tp),)), ["cpu"] * tp)


def _port(tlm, tp, **kw):
    return ContinuousBatcher(tlm, mesh=_mesh(tp),
                             parallel=ParallelConfig(tp=tp), **kw)


def _staggered(bat, prompts, steps, cancel_idx=0):
    """Two admits, two ticks, the rest, a tick, a mid-flight cancel of
    request ``cancel_idx``; returns the streams in request order."""
    ids = {}
    for i in range(2):
        ids[bat.submit(prompts[i], steps[i])] = i
    bat.tick()
    bat.tick()
    for i in range(2, len(prompts)):
        ids[bat.submit(prompts[i], steps[i])] = i
    bat.tick()
    assert bat.cancel(next(r for r, i in ids.items() if i == cancel_idx))
    out = bat.run()
    return [np.asarray(out[r]) for r in sorted(ids, key=ids.get)]


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=n).astype(np.int32) for n in lens]


def _equal(a, b, what):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: request {i}")


# -- the sharded model ----------------------------------------------------------


def test_sharded_logits_full_matches_jax_tp4():
    """tp=4 shards of the carried weights: ``logits_full`` within 2e-5 of
    the JAX package's (whose tp=4 placement its own tests hold to its
    unsharded logits) and of the port's own unsharded model."""
    jlm, variables, tlm = _target()
    ids = np.random.RandomState(2).randint(0, VOCAB, (2, 13)).astype(np.int32)
    want = np.asarray(J.logits_full(jlm, variables, jnp.asarray(ids)))
    slm = T.shard_lm(tlm, _mesh(4))
    got = T.logits_full(slm, ids).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, T.logits_full(tlm, ids).numpy(),
                               rtol=TOL, atol=TOL)
    # Each shard holds its heads / 4 and the model's head_dim.
    blk = slm.decoder_block_0
    assert [a.heads for a in blk.attn_shards] == [2] * 4
    assert [a.kv_heads for a in blk.attn_shards] == [1] * 4
    assert blk.head_dim == 4 and blk.cache_heads == 4


def test_sharded_generate_equals_unsharded_all_cache_dtypes():
    _, _, tlm = _target()
    prompt = np.random.RandomState(4).randint(0, VOCAB, (3, 7))
    for kv in ("native", "int8", "int4"):
        want = T.generate(tlm, prompt, 9, kv_cache_dtype=kv)
        for tp in (2, 4):
            got = T.generate(T.shard_lm(tlm, _mesh(tp)), prompt, 9,
                             kv_cache_dtype=kv)
            assert torch.equal(got, want), (kv, tp)


# -- streams ---------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_tp_staggered_streams_equal_jax_tp4_and_tp1(sim_mesh, layout):
    """tp=4 and tp=2 port batchers, tp=1 port batcher and the JAX tp=4
    batcher run one staggered workload with a mid-flight cancel: every
    stream is token-equal; each shard holds logical / tp KV bytes."""
    jlm, variables, tlm = _target()
    prompts = _prompts(1, (3, 9, 5, 12, 7))
    steps = [20, 4, 8, 3, 6]
    kw = dict(slots=3, chunk=2)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=8)
    want = _staggered(JC.ContinuousBatcher(
        jlm, variables, mesh=sim_mesh(4), parallel=JCFG.ParallelConfig(tp=4),
        **kw), prompts, steps)
    assert 0 < len(want[0]) < steps[0]
    for tp in (1, 2, 4):
        bat = _port(tlm, tp, **kw)
        _equal(_staggered(bat, prompts, steps), want, f"port tp={tp}")
        st = bat.stats()
        assert st["tp"] == tp and st["active"] == 0
        assert st["cache_bytes_per_device"] * tp == st["cache_bytes"]
        if tp > 1:
            for pair in bat._caches:
                for c in pair:
                    assert isinstance(c, Shards) and len(c) == tp
                    assert all(p.is_contiguous() and p.shape[1] == 4 // tp
                               for p in c)


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_tp_speculative_streams_equal_jax_tp4(sim_mesh, layout):
    """Batched speculation with the target in shards and the draft
    replicated (one copy on the lead device): streams equal the JAX tp=4
    speculative batcher's and the port's tp=1 one's."""
    jlm, variables, tlm = _target()
    jd, dvars, tdraft = _draft()
    prompts = _prompts(3, (4, 7, 2))
    steps = [7, 9, 5]
    kw = dict(slots=2, speculative=SpeculativeConfig(draft_k=3))
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=8)

    def drive(bat):
        ids = [bat.submit(p, s) for p, s in zip(prompts, steps)]
        out = bat.run()
        return [np.asarray(out[r]) for r in ids]

    want = drive(JC.ContinuousBatcher(
        jlm, variables, mesh=sim_mesh(4), parallel=JCFG.ParallelConfig(tp=4),
        draft_lm=jd, draft_variables=dvars,
        **{k: (JCFG.SpeculativeConfig(draft_k=3) if k == "speculative"
               else v) for k, v in kw.items()}))
    for tp in (1, 4):
        bat = _port(tlm, tp, draft_lm=tdraft, **kw)
        _equal(drive(bat), want, f"spec tp={tp}")
        assert bat._draft_caches[0][0].device == bat.device
        assert 0.0 <= bat.stats()["spec_acceptance"] <= 1.0


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_tp4_quantized_pool_bytes_and_stream(sim_mesh, kv):
    """tp=4 quantized pools: both members (int8 / packed int4 values and
    f32 scales) split on heads, a quarter of their bytes each shard, and
    the streams equal the JAX tp=4 quantized batcher's; so do the port's
    tp=2 and tp=4 quantized dense strips (whole-prompt admissions, which
    stream ``generate(kv_cache_dtype=...)`` on either layout)."""
    jlm, variables, tlm = _target()
    prompts = _prompts(5, (3, 11, 6))
    kw = dict(slots=2, kv_cache_dtype=kv, kv_layout="paged", page_size=8)
    jb = JC.ContinuousBatcher(jlm, variables, mesh=sim_mesh(4),
                              parallel=JCFG.ParallelConfig(tp=4), **kw)
    jids = [jb.submit(p, 6) for p in prompts]
    jout = jb.run()
    bat = _port(tlm, 4, **kw)
    ids = [bat.submit(p, 6) for p in prompts]
    out = bat.run()
    _equal([out[r] for r in ids], [np.asarray(jout[r]) for r in jids], kv)
    st = bat.stats()
    assert st["cache_bytes_per_device"] * 4 == st["cache_bytes"]
    assert st["cache_bytes"] == jb.stats()["cache_bytes"]
    for pair in bat._caches:
        for c in pair:
            for values, scales in c:
                assert values.dtype == torch.int8 and values.shape[1] == 1
                assert scales.dtype == torch.float32 and scales.shape[1] == 1
    for tp in (2, 4):
        dense = _port(tlm, tp, slots=2, kv_cache_dtype=kv)
        ids = [dense.submit(p, 6) for p in prompts]
        out = dense.run()
        _equal([out[r] for r in ids], [np.asarray(jout[r]) for r in jids],
               f"{kv} dense tp={tp}")
        st = dense.stats()
        assert st["cache_bytes_per_device"] * tp == st["cache_bytes"]


def test_tp2_depth2_int8_speculative_equals_tp1():
    """Pipeline depth 2 over an int8 pool with speculation at tp=2: the
    streams equal tp=1's at depth 2 on the same traffic (the mid-flight
    cancel included), and tp=1 depth 1's where no cancel cuts them."""
    _, _, tlm = _target()
    _, _, tdraft = _draft()
    prompts = _prompts(6, (5, 12, 3, 8))
    kw = dict(slots=2, kv_layout="paged", page_size=8, kv_cache_dtype="int8",
              draft_lm=tdraft, speculative=SpeculativeConfig(draft_k=2))
    outs = {}
    for tp, depth in ((1, 1), (1, 2), (2, 2)):
        bat = _port(tlm, tp, runtime=RuntimeConfig(pipeline_depth=depth),
                    **kw)
        outs[tp, depth] = _staggered(bat, prompts, [9, 6, 7, 5],
                                     cancel_idx=0)
        assert bat.stats()["pipeline_depth"] == depth
    _equal(outs[2, 2], outs[1, 2], "tp2 depth2")
    _equal(outs[2, 2][1:], outs[1, 1][1:], "tp2 depth2 vs depth 1")
    cut = outs[2, 2][0]
    np.testing.assert_array_equal(cut, outs[1, 1][0][:len(cut)])


def test_tp_sampled_streams_equal_tp1():
    """Seeded sampled requests (temperature, top-k, top-p) ride the shards
    unchanged: each stream equals the tp=1 batcher's with the same
    seed."""
    _, _, tlm = _target()
    p1 = np.asarray([1, 2, 3], np.int32)
    p2 = np.asarray([4, 5, 6, 7], np.int32)
    outs = {}
    for tp in (1, 4):
        bat = _port(tlm, tp, slots=2)
        r1 = bat.submit(p1, 6, temperature=0.9, top_k=5, rng=21)
        r2 = bat.submit(p2, 5, temperature=0.7, top_p=0.8, rng=5)
        out = bat.run()
        outs[tp] = [out[r1], out[r2]]
    _equal(outs[4], outs[1], "sampled")


# -- books and invariants -----------------------------------------------------


def test_tp_steady_tick_stages_nothing_and_fetches_once():
    """A steady tp=4 tick makes 0 host->device copies and one fetch, on
    both layouts."""
    _, _, tlm = _target()
    for kw in (dict(), dict(kv_layout="paged", page_size=8)):
        bat = _port(tlm, 4, slots=2, chunk=2, **kw)
        bat.submit(np.asarray([1, 2, 3], np.int32), 30)
        bat.tick()
        bat.tick()
        st = bat.stats()
        for _ in range(4):
            bat.tick()
        after = bat.stats()
        assert after["h2d_transfers"] == st["h2d_transfers"]
        assert after["d2h_fetches"] - st["d2h_fetches"] == 4
        bat.close()


def test_tp_memory_gauges_per_device():
    """memory.kv_bytes_per_device == kv_bytes / tp on strips,
    memory.pool_bytes_per_device == pool_bytes / tp on pools; the
    replicated draft's bytes stay logical; tp=1 reports equal bytes."""
    _, _, tlm = _target()
    _, _, tdraft = _draft()
    ms = _port(tlm, 4, slots=2)._memory_stats()
    assert ms["memory.kv_bytes_per_device"] * 4 == ms["memory.kv_bytes"]
    paged = _port(tlm, 4, slots=2, kv_layout="paged", page_size=8,
                  draft_lm=tdraft)
    ms = paged._memory_stats()
    assert ms["memory.pool_bytes_per_device"] * 4 == ms["memory.pool_bytes"]
    draft = paged._draft_caches
    assert not any(isinstance(c, Shards) for pair in draft for c in pair)
    assert ms["memory.draft_cache_bytes"] == sum(
        c.numel() * c.element_size() for pair in draft for c in pair)
    one = ContinuousBatcher(tlm, slots=2)
    ms = one._memory_stats()
    assert ms["memory.kv_bytes_per_device"] == ms["memory.kv_bytes"]
    assert one.stats()["tp"] == 1
    assert one.stats()["cache_bytes_per_device"] == one.stats()["cache_bytes"]


def test_tp_validation_matches_jax(sim_mesh):
    """The JAX batcher's refusals, by name: tp without a mesh, a config
    that disagrees with the mesh, a missing axis, indivisible KV heads,
    ParallelConfig's own."""
    jlm, variables, tlm = _target()
    cases = [
        (dict(parallel=ParallelConfig(tp=4)),
         dict(parallel=JCFG.ParallelConfig(tp=4)), "requires a mesh"),
        (dict(mesh=_mesh(4), parallel=ParallelConfig(tp=2)),
         dict(mesh=sim_mesh(4), parallel=JCFG.ParallelConfig(tp=2)),
         "!= mesh"),
        (dict(mesh=_mesh(4, "dp")), dict(mesh=sim_mesh(4, axis="dp")),
         "axis"),
    ]
    for pkw, jkw, match in cases:
        with pytest.raises(ValueError, match=match) as pe:
            ContinuousBatcher(tlm, slots=2, **pkw)
        with pytest.raises(ValueError, match=match) as je:
            JC.ContinuousBatcher(jlm, variables, slots=2, **jkw)
        assert str(pe.value) == str(je.value)
    for kw in (dict(tp=0), dict(axis="")):
        with pytest.raises(ValueError) as pe:
            ParallelConfig(**kw)
        with pytest.raises(ValueError) as je:
            JCFG.ParallelConfig(**kw)
        assert str(pe.value) == str(je.value)
    odd = J.transformer_lm(VOCAB, 32, 1, 4, 64, max_len=48, kv_heads=2,
                           name="tp_odd")
    todd = T.transformer_lm(VOCAB, 32, 1, 4, 64, max_len=48, kv_heads=2,
                            device="cpu")
    ovars = odd.graph.init(jax.random.PRNGKey(2), jnp.zeros((1, 4),
                                                            jnp.int32))
    with pytest.raises(ValueError, match="KV") as pe:
        ContinuousBatcher(todd, slots=2, mesh=_mesh(4))
    with pytest.raises(ValueError, match="KV") as je:
        J.validate_tp(odd, 4)
    assert str(pe.value) == str(je.value)
    with pytest.raises(ValueError, match="KV"):
        JC.ContinuousBatcher(odd, ovars, slots=2, mesh=sim_mesh(4))


def test_tp1_mesh_serves_the_single_device_path():
    """A size-1 tp axis partitions nothing: the batcher serves the LM
    itself on the mesh's device, with plain caches."""
    _, _, tlm = _target()
    bat = _port(tlm, 1, slots=2)
    assert bat.lm is tlm and bat._mesh is None
    assert not isinstance(bat._caches[0][0], Shards)
    assert bat.stats()["tp"] == 1
