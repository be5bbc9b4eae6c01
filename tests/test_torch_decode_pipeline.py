"""The port's fault-tolerant pipelined decode (``runtime/decode_pipeline``)
against the JAX package's, on the CPU.

Weights come from the JAX package (flax ``init`` from a seed, carried
across by ``convert.from_flax``); prompts are seeded numpy arrays given to
both. Greedy streams of the port's ``PipelinedDecoder`` must be
token-equal to the JAX package's ``generate()`` (and, in one case, its
``PipelinedDecoder``) and to the port's own ``generate()``: native and
int8 stage caches, ragged prompts, and a worker crashed or hung mid-decode.
Sampled streams are held to the port's ``generate()`` under the same seed
(the JAX package's threefry keys are not the port's). Stage workers run on
CPU devices; kill tests crash a worker, and the one hang test waits for a
1 s task deadline, never for a wall-clock sleep."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.config import FaultConfig
from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.runtime.decode_pipeline import PipelinedDecoder
from adapt_tpu_torch.utils.metrics import global_metrics

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JD = importlib.import_module("adapt_tpu.runtime.decode_pipeline")
JConfig = importlib.import_module("adapt_tpu.config")

VOCAB = 59
#: A crashed worker is caught by its task deadline; 1 s keeps a kill test
#: short, and a healthy stage of these sizes answers in milliseconds.
FAST = FaultConfig(lease_ttl_s=0.5, heartbeat_s=0.1, task_deadline_s=1.0,
                   watchdog_period_s=0.02, max_retries=4)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm_setup():
    jlm = J.lm_tiny(vocab=VOCAB, max_len=32)
    prompt = np.random.RandomState(0).randint(0, VOCAB, (4, 6))
    variables = jax.device_get(
        jlm.graph.init(jax.random.PRNGKey(1), jnp.asarray(prompt)))
    tlm = T.lm_tiny(vocab=VOCAB, max_len=32, device="cpu")
    tlm.load_state_dict(from_flax(variables))
    return jlm, variables, tlm, prompt


def _jax_generate(setup, prompt, steps, **kw):
    jlm, variables = setup[:2]
    if "prompt_lengths" in kw:
        kw["prompt_lengths"] = jnp.asarray(kw["prompt_lengths"])
    return np.asarray(J.generate(jlm, variables, jnp.asarray(prompt), steps,
                                 **kw))


def _killing(dec, stage, mode, when):
    """An ``on_token`` hook that kills ``stage``'s worker once, when
    ``when(m, s)`` first holds."""
    killed = []

    def on_token(m, s):
        if not killed and when(m, s):
            killed.append((m, s))
            dec.kill_worker(stage, mode=mode)

    return on_token, killed


def test_no_fault_matches_jax_decoder_and_generate(lm_setup):
    jlm, variables, tlm, prompt = lm_setup
    want = T.generate(tlm, prompt, 6).numpy()
    np.testing.assert_array_equal(want, _jax_generate(lm_setup, prompt, 6))
    jfast = JConfig.FaultConfig(lease_ttl_s=0.5, heartbeat_s=0.1,
                                task_deadline_s=3.0, watchdog_period_s=0.05)
    with JD.PipelinedDecoder(jlm, variables, [2],
                             devices=jax.devices()[:3], fault=jfast) as jdec:
        jgot = jdec.generate(jnp.asarray(prompt), 6)
    with PipelinedDecoder(tlm, [2], devices=[CPU] * 3, fault=FAST) as dec:
        got = dec.generate(prompt, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jgot))


def test_sampled_matches_generate(lm_setup):
    tlm, prompt = lm_setup[2:]
    kw = dict(temperature=0.8, top_k=9, rng=3)
    want = T.generate(tlm, prompt, 5, **kw).numpy()
    with PipelinedDecoder(tlm, [2], devices=[CPU] * 3, fault=FAST) as dec:
        got = dec.generate(prompt, 5, **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["crash", "hang"])
def test_worker_kill_mid_decode_replays_and_matches(lm_setup, mode):
    """A stage dies AFTER several tokens committed: detected by its
    deadline, rebound to the spare, its caches rebuilt by replay, and the
    stream equals the no-fault one (no token lost or duplicated)."""
    tlm, prompt = lm_setup[2:]
    want = _jax_generate(lm_setup, prompt, 8)
    np.testing.assert_array_equal(T.generate(tlm, prompt, 8).numpy(), want)
    global_metrics().reset()
    with PipelinedDecoder(tlm, [2], devices=[CPU] * 3, fault=FAST) as dec:
        on_token, killed = _killing(dec, 1, mode,
                                    lambda m, s: m == 0 and s == 2)
        got = dec.generate(prompt, 8, on_token=on_token)
    assert killed, "kill hook never fired"
    np.testing.assert_array_equal(got, want)
    assert global_metrics().snapshot()["counters"].get(
        "decode.recoveries", 0) >= 1
    assert len(dec.recovery_log) >= 1 and dec.recovery_log[0]["stage"] == 1


def test_kill_during_eos_sampling_session(lm_setup):
    """Recovery composes with sampling and EOS: per-row keys make the
    replayed session's draws the same."""
    tlm, prompt = lm_setup[2:]
    kw = dict(temperature=1.1, top_k=13, rng=5)
    eos = int(T.generate(tlm, prompt, 7, **kw).numpy()[0, 1])
    want = T.generate(tlm, prompt, 7, eos_id=eos, **kw).numpy()
    with PipelinedDecoder(tlm, [1, 3], devices=[CPU] * 4, fault=FAST) as dec:
        on_token, killed = _killing(dec, 0, "crash", lambda m, s: s == 3)
        got = dec.generate(prompt, 7, eos_id=eos, on_token=on_token, **kw)
    assert killed
    np.testing.assert_array_equal(got, want)


def test_int8_stage_caches_survive_kill(lm_setup):
    """int8 stage caches and a mid-decode crash: replay rebuilds the
    quantized caches, so the stream equals generate(kv_cache_dtype="int8"),
    the port's and the JAX package's."""
    tlm, prompt = lm_setup[2:]
    want = _jax_generate(lm_setup, prompt, 7, kv_cache_dtype="int8")
    np.testing.assert_array_equal(
        T.generate(tlm, prompt, 7, kv_cache_dtype="int8").numpy(), want)
    with PipelinedDecoder(tlm, [2], devices=[CPU] * 3, fault=FAST,
                          kv_cache_dtype="int8") as dec:
        on_token, killed = _killing(dec, 0, "crash", lambda m, s: s == 3)
        got = dec.generate(prompt, 7, on_token=on_token)
    assert killed
    np.testing.assert_array_equal(got, want)


def test_rejects_bad_boundaries(lm_setup):
    tlm = lm_setup[2]
    for bad in ([3, 1], [0], [4], [2, 2]):
        with pytest.raises(ValueError, match="boundaries"):
            PipelinedDecoder(tlm, bad, devices=[CPU] * 2, fault=FAST)


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_ragged_prompts_survive_kill(lm_setup, kv):
    """Ragged batches (right-padded + prompt_lengths) with a crash
    mid-decode: the replay rebuilds the left-aligned masked caches (native
    or quantized) and the stream matches generate() row for row."""
    tlm = lm_setup[2]
    lens = [2, 5, 3, 6]
    prompt = np.random.RandomState(9).randint(0, VOCAB, (4, max(lens)))
    want = _jax_generate(lm_setup, prompt, 6, prompt_lengths=lens,
                         kv_cache_dtype=kv)
    np.testing.assert_array_equal(
        T.generate(tlm, prompt, 6, prompt_lengths=lens,
                   kv_cache_dtype=kv).numpy(), want)
    with PipelinedDecoder(tlm, [2], devices=[CPU] * 3, fault=FAST,
                          kv_cache_dtype=kv) as dec:
        on_token, killed = _killing(dec, 1 if kv == "native" else 0,
                                    "crash", lambda m, s: s == 2)
        got = dec.generate(prompt, 6, prompt_lengths=lens, on_token=on_token)
    assert killed
    np.testing.assert_array_equal(got, want)


def test_rejects_bad_microbatch_split_and_kv_dtype(lm_setup):
    tlm, prompt = lm_setup[2:]
    with PipelinedDecoder(tlm, [2], devices=[CPU] * 2, fault=FAST) as dec:
        with pytest.raises(ValueError, match="microbatch"):
            dec.generate(prompt, 4, num_microbatches=3)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        PipelinedDecoder(tlm, [2], devices=[CPU] * 2, fault=FAST,
                         kv_cache_dtype="int4")


def test_top_p_matches_generate(lm_setup):
    tlm, prompt = lm_setup[2:]
    kw = dict(temperature=1.0, top_p=0.65, rng=43)
    want = T.generate(tlm, prompt, 5, **kw).numpy()
    with PipelinedDecoder(tlm, [2], devices=[CPU] * 3, fault=FAST) as dec:
        got = dec.generate(prompt, 5, **kw)
    np.testing.assert_array_equal(got, want)


def test_gqa_matches_jax_and_generate():
    """GQA: stage workers hold the smaller kv_heads caches; tokens match
    generate(), the port's and the JAX package's."""
    vocab = 37
    kw = dict(vocab=vocab, dim=32, depth=2, heads=4, mlp_dim=48, max_len=32,
              kv_heads=2)
    jlm = J.transformer_lm(**kw)
    prompt = np.random.RandomState(80).randint(0, vocab, (2, 5))
    variables = jax.device_get(
        jlm.graph.init(jax.random.PRNGKey(81), jnp.asarray(prompt)))
    tlm = T.transformer_lm(**kw, device="cpu")
    tlm.load_state_dict(from_flax(variables))
    want = np.asarray(J.generate(jlm, variables, jnp.asarray(prompt), 6))
    with PipelinedDecoder(tlm, [1], devices=[CPU] * 3, fault=FAST) as dec:
        got = dec.generate(prompt, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, T.generate(tlm, prompt, 6).numpy())
