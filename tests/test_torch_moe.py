"""The port's mixture-of-experts layers and MoE decoder LM against the JAX
package's, on the CPU.

Weights come from the JAX package (flax ``init`` from a seed; the LM
through ``convert.from_flax``); inputs are seeded numpy arrays given to
both. Tolerances: layer outputs at ``atol = rtol = 2e-5``, the aux loss at
``rtol = 1e-5``, LM logits at ``1e-4`` (the two frameworks' f32 matmuls
differ by ~1e-6, summed over depth). Greedy token streams — ``generate()``
and the dense and paged batchers — must be equal to the JAX package's and
to the port's own ``generate()`` for each prompt alone."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.models import moe as M
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

JM = importlib.import_module("adapt_tpu.models.moe")
J = importlib.import_module("adapt_tpu.models.transformer_lm")
JC = importlib.import_module("adapt_tpu.runtime.continuous")

TOL = 2e-5
LOGIT_TOL = 1e-4
B, S, D, E, H = 2, 16, 8, 4, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed=0, shape=(B, S, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _load(layer, params):
    """Copy a flax MoE layer's params into the port's layer."""
    with torch.no_grad():
        for leaf in ("gate", "w1", "b1", "w2", "b2"):
            getattr(layer, leaf).copy_(torch.from_numpy(
                np.array(params[leaf], np.float32)))
    return layer


def _pair(kind, top_k, cf=1.25, seed=1):
    x = _x()
    if kind == "serve":
        jm = JM.MoEDecoderMlp(num_experts=E, hidden_dim=H, top_k=top_k)
        tm = M.MoEDecoderMlp(D, E, H, top_k, device="cpu")
    else:
        jm = JM.MoEMlp(num_experts=E, hidden_dim=H, top_k=top_k,
                       capacity_factor=cf)
        tm = M.MoEMlp(D, E, H, top_k, capacity_factor=cf, device="cpu")
    v = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    return jm, v, _load(tm, v["params"]), x


@pytest.mark.parametrize("kind", ["serve", "train"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_layers_match_jax_with_aux_loss(kind, top_k):
    jm, v, tm, x = _pair(kind, top_k)
    jy, st = jm.apply(v, jnp.asarray(x), mutable=["intermediates"])
    with torch.no_grad():
        ty = tm(torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(float(tm.aux_loss),
                               float(st["intermediates"]["aux_loss"][0]),
                               rtol=1e-5)


def test_moe_capacity_drops_tokens_like_jax():
    jm, v, tm, x = _pair("train", 1, cf=0.05)
    jy = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        ty = tm(torch.from_numpy(x)).numpy()
    dropped = np.all(ty.reshape(-1, D) == 0.0, axis=-1)
    assert dropped.any()
    np.testing.assert_array_equal(
        dropped, np.all(jy.reshape(-1, D) == 0.0, axis=-1))
    np.testing.assert_allclose(ty, jy, atol=TOL, rtol=TOL)
    assert float(tm.aux_loss) >= 1.0 - 1e-3


def test_aux_loss_uniform_is_one_and_utilization_sums_to_one():
    gates = torch.full((8, 4), 0.25)
    _, _, aux = M._one_hot_routing(gates, capacity=8, top_k=1)
    assert abs(float(aux) - 1.0) < 1e-5
    # Expert utilization (the ep books' first-choice share) sums to 1.
    g = torch.softmax(torch.from_numpy(_x(3, (64, E))), dim=-1)
    _, first = M._topk_combine(g, 2)
    util = first.sum(0) / first.sum()
    assert util.shape == (E,) and abs(float(util.sum()) - 1.0) < 1e-6
    ju = np.asarray(importlib.import_module(
        "adapt_tpu.parallel.expert").expert_utilization(jnp.asarray(g)))
    np.testing.assert_allclose(util.numpy(), ju, atol=1e-6)


def test_moe_decoder_mlp_is_per_token_independent():
    _, _, tm, _ = _pair("serve", 2)
    x = torch.from_numpy(_x(5, (2, 8, D)))
    with torch.no_grad():
        both = tm(x)
        one, two = tm(x[:1]), tm(x[1:])
    torch.testing.assert_close(both, torch.cat([one, two]), atol=1e-6,
                               rtol=1e-6)


def test_both_moe_layers_record_one_aux_convention():
    _, v, train, x = _pair("train", 1, cf=float(E))
    serve = _load(M.MoEDecoderMlp(D, E, H, 1, device="cpu"), v["params"])
    with torch.no_grad():
        train(torch.from_numpy(x))
        serve(torch.from_numpy(x))
    np.testing.assert_allclose(float(train.aux_loss), float(serve.aux_loss),
                               rtol=1e-6)


def test_moe_refuses_like_jax():
    with pytest.raises(ValueError, match="top_k"):
        M.MoEDecoderMlp(D, E, H, 3, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        M.MoEDecoderMlp(D, 1, H, 2, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        T.transformer_lm(53, 32, 2, 4, 48, max_len=48, moe_experts=8,
                         moe_top_k=3, device="cpu")


# -- the MoE decoder LM ---------------------------------------------------------

_LM = {}


def _moe_lm():
    if not _LM:
        jlm = J.transformer_lm(53, 32, 2, 4, 48, max_len=48, moe_experts=8,
                               moe_top_k=2, name="moe_lm")
        v = jax.device_get(jlm.graph.init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 4), jnp.int32)))
        tlm = T.transformer_lm(53, 32, 2, 4, 48, max_len=48, moe_experts=8,
                               moe_top_k=2, name="moe_lm", device="cpu")
        tlm.load_state_dict(from_flax(v))
        _LM["pair"] = (jlm, v, tlm)
    return _LM["pair"]


def test_moe_lm_logits_and_generate_match_jax():
    jlm, v, tlm = _moe_lm()
    ids = np.random.default_rng(1).integers(0, 53, (2, 6)).astype(np.int32)
    want = np.asarray(J.logits_full(jlm, v, jnp.asarray(ids)))
    got = T.logits_full(tlm, ids).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    jg = np.asarray(J.generate(jlm, v, jnp.asarray(ids), steps=5))
    tg = T.generate(tlm, ids, 5).numpy()
    np.testing.assert_array_equal(tg, jg)
    # Cached decode == the full forward's argmax, step by step.
    seq = ids
    for _ in range(5):
        lg = T.logits_full(tlm, seq)[:, -1]
        top2 = torch.topk(lg, 2).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > LOGIT_TOL
        seq = np.concatenate([seq, lg.argmax(-1).numpy()[:, None]], 1)
    np.testing.assert_array_equal(tg, seq[:, 6:])


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_moe_lm_batcher_streams_equal_jax_and_generate(layout):
    jlm, v, tlm = _moe_lm()
    rng = np.random.RandomState(21)
    prompts = [rng.randint(0, 53, size=n).astype(np.int32)
               for n in (5, 9, 3, 20)]
    kw = (dict(kv_layout="paged", page_size=16) if layout == "paged"
          else {})
    jb = JC.ContinuousBatcher(jlm, v, slots=2, chunk=2, **kw)
    tb = ContinuousBatcher(tlm, slots=2, chunk=2, **kw)
    jids = [jb.submit(p, 4) for p in prompts]
    tids = [tb.submit(p, 4) for p in prompts]
    jout, tout = jb.run(), tb.run()
    tb.close()
    for p, ji, ti in zip(prompts, jids, tids):
        solo = T.generate(tlm, p[None], 4)[0].numpy()
        np.testing.assert_array_equal(tout[ti], solo)
        np.testing.assert_array_equal(tout[ti], np.asarray(jout[ji]))
