"""The port's dense ContinuousBatcher, on the CPU.

Greedy streams — staggered submits, a live cancel, chunk 1 and 8 — must
be token-equal to the JAX package's batcher and to the port's own
``generate()`` for each request alone (with every step's top-2 logit
margin above the 1e-4 logit tolerance); sampled streams must equal the
port's ``generate()`` under the same seed; a steady tick stages nothing
host->device."""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.config import KernelConfig, SchedulerConfig, SLOSpec
from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
from adapt_tpu_torch.runtime.scheduler import AdmissionQueue, QueueFullError

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JC = importlib.import_module("adapt_tpu.runtime.continuous")

VOCAB, MAX_LEN = 37, 48
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers at once,
    and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm_setup():
    jlm = J.lm_tiny(vocab=VOCAB, max_len=MAX_LEN)
    variables = jax.device_get(
        jlm.graph.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    )
    tlm = T.lm_tiny(vocab=VOCAB, max_len=MAX_LEN, device="cpu")
    tlm.load_state_dict(from_flax(variables))
    return jlm, variables, tlm


def _solo(tlm, prompt, steps, **kw):
    return T.generate(tlm, np.asarray(prompt)[None], steps, **kw)[0].numpy()


def _margins_ok(jlm, variables, prompt, tokens):
    seq = np.concatenate([prompt, tokens[:-1]])[None]
    lg = np.asarray(J.logits_full(jlm, variables, jnp.asarray(seq)))[0]
    top2 = np.sort(lg[len(prompt) - 1:], axis=-1)[:, -2:]
    return bool((top2[:, 1] - top2[:, 0] > LOGIT_TOL).all())


PROMPT_LENS = (3, 9, 5, 12, 7)
STEPS = (20, 4, 8, 3, 5)  # request 0 is long enough to be live at the cancel


def _drive(bat, prompts, cancel_tick_first):
    """Two requests, two ticks, three more arrive, request 0 is cancelled
    while live (after one more tick when ``cancel_tick_first``)."""
    ids = [bat.submit(prompts[i], STEPS[i]) for i in range(2)]
    bat.tick()
    bat.tick()
    ids += [bat.submit(prompts[i], STEPS[i]) for i in range(2, 5)]
    if cancel_tick_first:
        bat.tick()
    assert bat.cancel(ids[0])
    return ids, bat.run()


@pytest.mark.parametrize("chunk", [1, 8])
def test_staggered_greedy_with_cancel_matches_jax_and_generate(lm_setup,
                                                               chunk):
    jlm, variables, tlm = lm_setup
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, VOCAB, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    ids, out = _drive(ContinuousBatcher(tlm, slots=3, chunk=chunk),
                      prompts, chunk == 1)
    jbat = JC.ContinuousBatcher(jlm, variables, slots=3, chunk=chunk)
    jids, jout = _drive(jbat, prompts, chunk == 1)
    for i, (rid, jrid) in enumerate(zip(ids, jids)):
        np.testing.assert_array_equal(out[rid], jout[jrid], err_msg=f"req {i}")
        want = _solo(tlm, prompts[i], STEPS[i])
        assert _margins_ok(jlm, variables, prompts[i], want)
        if i == 0:  # cancelled live: a strict prefix of its solo stream
            assert 0 < len(out[rid]) < STEPS[0]
            np.testing.assert_array_equal(out[rid], want[:len(out[rid])])
        else:
            np.testing.assert_array_equal(out[rid], want, err_msg=f"req {i}")


def test_sampled_streams_match_port_generate(lm_setup):
    _, _, tlm = lm_setup
    p1 = np.asarray([1, 2, 3, 4])
    p2 = np.asarray([5, 6, 7])
    p3 = np.asarray([8, 9, 10, 11, 12])
    bat = ContinuousBatcher(tlm, slots=2, top_k=5, chunk=4)
    r1 = bat.submit(p1, 6, temperature=0.9, rng=7)
    r2 = bat.submit(p2, 5)  # greedy, same batch
    r3 = bat.submit(p3, 9, temperature=1.3, top_p=0.8, rng=9)
    r4 = bat.submit(p1, 7, temperature=2.0, top_k=VOCAB, rng=3)
    out = bat.run()
    np.testing.assert_array_equal(
        out[r1], _solo(tlm, p1, 6, temperature=0.9, top_k=5, rng=7))
    np.testing.assert_array_equal(out[r2], _solo(tlm, p2, 5))
    np.testing.assert_array_equal(
        out[r3], _solo(tlm, p3, 9, temperature=1.3, top_k=5, top_p=0.8, rng=9))
    np.testing.assert_array_equal(
        out[r4], _solo(tlm, p1, 7, temperature=2.0, rng=3))


def test_split_decode_streams_match_split_generate(lm_setup):
    """KernelConfig(decode_split=3): the batcher's split decode equals
    generate(decode_split=3) — both cut the same max_len + 1 strip."""
    _, _, tlm = lm_setup
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, VOCAB, size=n) for n in (5, 11, 2)]
    bat = ContinuousBatcher(tlm, slots=2, chunk=4,
                            kernel=KernelConfig(decode_split=3))
    ids = [bat.submit(p, 30, temperature=1.1, rng=i)
           for i, p in enumerate(prompts)]
    out = bat.run()
    for i, (rid, p) in enumerate(zip(ids, prompts)):
        np.testing.assert_array_equal(
            out[rid],
            _solo(tlm, p, 30, temperature=1.1, rng=i, decode_split=3))


def test_top_k1_sampling_equals_greedy(lm_setup):
    _, _, tlm = lm_setup
    p = np.asarray([4, 5, 6, 7, 8])
    bat = ContinuousBatcher(tlm, slots=2)
    a = bat.submit(p, 10, temperature=0.7, top_k=1, rng=5)
    b = bat.submit(p, 10)
    out = bat.run()
    np.testing.assert_array_equal(out[a], out[b])


def test_logprobs_match_generate(lm_setup):
    _, _, tlm = lm_setup
    p = np.asarray([2, 3, 5, 7, 11, 13])
    bat = ContinuousBatcher(tlm, slots=2, chunk=3)
    rid = bat.submit(p, 8)
    out = bat.run()
    toks, lps = T.generate(tlm, p[None], 8, return_logprobs=True)
    np.testing.assert_array_equal(out[rid], toks[0].numpy())
    np.testing.assert_allclose(bat.logprobs(rid), lps[0].numpy(),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    with pytest.raises(KeyError):
        bat.logprobs(rid)  # claimed


def test_eos_and_stop_end_streams(lm_setup):
    _, _, tlm = lm_setup
    p = np.asarray([1, 4, 9, 16])
    full = _solo(tlm, p, 12)
    bat = ContinuousBatcher(tlm, slots=2, chunk=4)
    r_eos = bat.submit(p, 12, eos_id=int(full[5]))
    r_stop = bat.submit(p, 12, stop=[[int(full[2]), int(full[3])]])
    seen = []
    r_cb = bat.submit(p, 4, on_token=lambda r, t, i: seen.append((r, t, i)))
    out = bat.run()
    cut = list(full).index(full[5]) + 1
    np.testing.assert_array_equal(out[r_eos], full[:cut])
    np.testing.assert_array_equal(out[r_stop], full[:4])
    assert seen == [(r_cb, int(t), i) for i, t in enumerate(full[:4])]


def test_steady_ticks_stage_nothing_host_to_device(lm_setup):
    _, _, tlm = lm_setup
    bat = ContinuousBatcher(tlm, slots=2, chunk=2)
    bat.submit(np.asarray([1, 2, 3]), 20)
    bat.submit(np.asarray([4, 5]), 20)
    bat.tick()  # admissions stage their rows
    n = bat.stats()["h2d_transfers"]
    assert n > 0
    for _ in range(4):
        assert bat.tick() == 2
    assert bat.stats()["h2d_transfers"] == n


def test_queued_cancel_and_unknown_ids(lm_setup):
    _, _, tlm = lm_setup
    bat = ContinuousBatcher(tlm, slots=1)
    a = bat.submit(np.asarray([1, 2]), 3)
    b = bat.submit(np.asarray([3, 4]), 3)
    assert bat.cancel(b)  # still queued
    assert not bat.cancel(99)
    out = bat.run()
    assert len(out[b]) == 0 and len(out[a]) == 3
    assert not bat.cancel(a)  # finished
    st = bat.stats()
    assert st["admitted"] == 1 and st["completed"] == 1
    assert st["active"] == 0 and st["queued"] == 0


def test_server_mode_results(lm_setup):
    _, _, tlm = lm_setup
    prompts = [np.asarray([i + 1, i + 2, i + 3]) for i in range(4)]
    with ContinuousBatcher(tlm, slots=2, chunk=4) as bat:
        ids = [bat.submit(p, 5) for p in prompts]
        got = [bat.result(r, timeout=60) for r in ids]
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(g, _solo(tlm, p, 5))
    assert bat._server is None


def test_queue_bound_rejects_synchronously(lm_setup):
    _, _, tlm = lm_setup
    bat = ContinuousBatcher(tlm, slots=1)
    bat._queue.cfg = SchedulerConfig(max_queue_depth=2)
    bat.submit(np.asarray([1]), 2)
    bat.submit(np.asarray([2]), 2)
    with pytest.raises(QueueFullError):
        bat.submit(np.asarray([3]), 2)
    assert bat.stats()["rejected"] == 1
    # A configured queue is the JAX package's AdmissionQueue: the same
    # requests (tenants, priorities, a best-effort one) pop in the same
    # order from both.
    JS = importlib.import_module("adapt_tpu.runtime.scheduler")
    JCfg = importlib.import_module("adapt_tpu.config")
    orders = []
    for queue, spec in ((AdmissionQueue(SchedulerConfig()), SLOSpec),
                        (JS.AdmissionQueue(JCfg.SchedulerConfig()),
                         JCfg.SLOSpec)):
        for i, (tenant, prio) in enumerate(
                [("a", 0), ("b", 0), ("a", 2), ("c", -1), ("b", 2),
                 ("a", 0), ("c", 0)]):
            queue.append(types.SimpleNamespace(
                req_id=i, slo=spec(tenant=tenant, priority=prio)))
        orders.append([queue.popleft().req_id for _ in range(7)])
    assert orders[0] == orders[1] == [2, 4, 0, 1, 6, 5, 3]


def test_argument_errors(lm_setup):
    _, _, tlm = lm_setup
    # Quantized strips are served: int8 values + f32 scales against f32
    # native, (hd + 4) / (4 hd) of the bytes at head_dim 16.
    st = ContinuousBatcher(tlm, kv_cache_dtype="int8").stats()
    assert st["cache_bytes_ratio"] == (16 + 4) / (4 * 16)
    assert ContinuousBatcher(tlm, kv_layout="paged").stats()["pool_pages"] > 1
    with pytest.raises(ValueError, match="chunk"):
        ContinuousBatcher(tlm, chunk=0)
    bat = ContinuousBatcher(tlm, slots=1)
    with pytest.raises(ValueError, match="max_len"):
        bat.submit(np.arange(40), 20)
    with pytest.raises(ValueError, match="rng"):
        bat.submit(np.asarray([1]), 2, temperature=0.5)
