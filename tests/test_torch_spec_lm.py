"""The speculative slice's model paths, on the CPU, against the JAX package.

- Block-level ``verify_chunk`` (dense strips) and ``verify_chunk_paged``
  (pools) equal the JAX package's at ``atol = rtol = 1e-4``: native and
  quantized caches, scalar and ``(b,)`` index, a dead row, tree leaves, on
  the MHA model and on the GQA + rope + window model.
- The K logits of one verify pass equal K sequential ``decode_step``\\ s of
  the port (both layouts).
- ``speculative_generate`` is token-equal to the port's ``generate()`` and
  to the JAX package's ``speculative_generate``: perfect and wrong drafts,
  ``draft_k`` 1 and 4, ``steps`` edges, EOS padding, int8 draft weights
  loaded from the JAX payload, ``host_fetches == rounds + 1``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.models import speculative as TS
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.ops import quantize as TQ

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JS = importlib.import_module("adapt_tpu.models.speculative")
JQ = importlib.import_module("adapt_tpu.ops.quantize")

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CONFIGS = {
    "target": dict(vocab=37, dim=32, depth=2, heads=2, mlp=64, max_len=48),
    "draft": dict(vocab=37, dim=16, depth=1, heads=1, mlp=32, max_len=48),
    "gqa_rope_window": dict(vocab=61, dim=64, depth=2, heads=8, mlp=128,
                            max_len=128, kv_heads=4, pos="rope", window=16),
}
_CACHE = {}


def _build(name, seed=0):
    if name not in _CACHE:
        c = dict(CONFIGS[name])
        args = [c.pop(k) for k in ("vocab", "dim", "depth", "heads", "mlp")]
        jlm = J.transformer_lm(*args, **c)
        variables = jax.device_get(jlm.graph.init(
            jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32)))
        tlm = T.transformer_lm(*args, device="cpu", **c)
        tlm.load_state_dict(from_flax(variables))
        _CACHE[name] = (jlm, variables, tlm)
    return _CACHE[name]


def _caches(rng, shape, kind):
    """A random cache, native or quantized by JAX's shared scheme, as (jax
    operand, torch operand)."""
    x = rng.randn(*shape).astype(np.float32)
    if kind == "native":
        return jnp.asarray(x), torch.from_numpy(x.copy())
    vals, sc = JQ.quantize_kv_vectors(jnp.asarray(x), kind)
    return (vals, sc), (torch.from_numpy(np.array(vals)),
                        torch.from_numpy(np.array(sc)))


def _members(c):
    return c if isinstance(c, tuple) else (c,)


def _assert_cache_close(got, want, live=None):
    """Float members at TOL; quantized bytes equal but for rare one-step
    rounding flips (an f32 input straddling a .5 boundary)."""
    for g, w in zip(_members(got), _members(want)):
        g, w = np.array(g), np.array(w)
        if live is not None:
            g, w = g[live], w[live]
        if g.dtype == np.int8:
            assert (g != w).mean() <= 2e-3
        else:
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["native", "int8", "int4"])
@pytest.mark.parametrize("name,tree_tail", [("target", 0), ("target", 2),
                                            ("gqa_rope_window", 2)])
def test_block_verify_chunk_matches_jax(name, tree_tail, kind):
    jlm, variables, tlm = _build(name)
    bname = "decoder_block_1"
    jblock, tblock = jlm.graph.node(bname).module, getattr(tlm, bname)
    rng = np.random.RandomState(4)
    b, kc, L = 3, 5, 40
    kvh, hd, dim = tblock.cache_heads, tblock.head_dim, tblock.dim
    x = rng.randn(b, kc, dim).astype(np.float32)
    jk, tk = _caches(rng, (b, kvh, L, hd), kind)
    jv, tv = _caches(rng, (b, kvh, L, hd), kind)
    # A per-slot index always; the scalar index (the single-request loop)
    # on native caches.
    indices = [np.asarray([7, 30, 18], np.int32)]
    if kind == "native":
        indices.append(21)
    for index in indices:
        jidx = jnp.asarray(index) if np.ndim(index) else index
        tidx = torch.from_numpy(index) if np.ndim(index) else index
        jo, jk2, jv2 = jblock.apply(variables[bname], jnp.asarray(x), jk, jv,
                                    jidx, tree_tail, method="verify_chunk")
        ck = tuple(m.clone() for m in _members(tk))
        cv = tuple(m.clone() for m in _members(tv))
        if kind == "native":
            ck, cv = ck[0], cv[0]
        with torch.no_grad():
            to, tk2, tv2 = tblock.verify_chunk(torch.from_numpy(x), ck, cv,
                                               tidx, tree_tail)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL,
                                   rtol=TOL, err_msg=f"index={index}")
        assert _members(tk2)[0] is _members(ck)[0]  # written in place
        _assert_cache_close(tk2, jk2)
        _assert_cache_close(tv2, jv2)


@pytest.mark.parametrize("kind", ["native", "int8", "int4"])
@pytest.mark.parametrize("name,tree_tail", [("target", 0),
                                            ("gqa_rope_window", 0),
                                            ("gqa_rope_window", 2)])
def test_block_verify_chunk_paged_matches_jax(name, tree_tail, kind):
    """A dead row (negative index) writes to the trash page and is not
    compared (K5's plain version emits zeros there, the JAX oracle a
    uniform average nothing reads)."""
    jlm, variables, tlm = _build(name)
    bname = "decoder_block_0"
    jblock, tblock = jlm.graph.node(bname).module, getattr(tlm, bname)
    rng = np.random.RandomState(6)
    b, kc, page, npages = 3, 5, 8, 14
    kvh, hd, dim = tblock.cache_heads, tblock.head_dim, tblock.dim
    x = rng.randn(b, kc, dim).astype(np.float32)
    jk, tk = _caches(rng, (npages, kvh, page, hd), kind)
    jv, tv = _caches(rng, (npages, kvh, page, hd), kind)
    table = np.asarray([[3, 7, 1, 12], [5, 2, 9, 4], [6, 8, 10, 11]], np.int32)
    index = np.asarray([13, 22, -6], np.int32)  # slot 0 crosses a page
    jo, jk2, jv2 = jblock.apply(
        variables[bname], jnp.asarray(x), jk, jv, jnp.asarray(table),
        jnp.asarray(index), "xla", tree_tail, method="verify_chunk_paged")
    with torch.no_grad():
        to, tk2, tv2 = tblock.verify_chunk_paged(
            torch.from_numpy(x), tk, tv, torch.from_numpy(table),
            torch.from_numpy(index), None, tree_tail, 2)
    np.testing.assert_allclose(to.numpy()[:2], np.asarray(jo)[:2], atol=TOL,
                               rtol=TOL)
    live = np.arange(1, npages)  # page 0 is the trash page
    _assert_cache_close(tk2, jk2, live)
    _assert_cache_close(tv2, jv2, live)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("layout", ["slots", "paged"])
@pytest.mark.parametrize("name", ["target", "gqa_rope_window"])
def test_verify_logits_equal_sequential_decode_steps(name, layout, kv_dtype):
    """K causal logits from ONE verify pass == K ``decode_step``\\ s of the
    port, each slot at its own position (the losslessness mechanism)."""
    _, _, tlm = _build(name)
    rng = np.random.RandomState(8)
    b, kc, page = 2, 4, 8
    s0 = np.asarray([9, 5])
    prompt = rng.randint(0, tlm.vocab, size=(b, 12))
    chunk = torch.from_numpy(rng.randint(0, tlm.vocab, size=(b, kc)))
    kvh = tlm.blocks[0].cache_heads
    quant = False if kv_dtype == "native" else kv_dtype

    def to_pool(t):
        """(b, kvh, 32, w) strips -> a pool: trash page 0, then each row's
        four pages in order."""
        w = t.shape[-1]
        pages = [torch.zeros(1, kvh, page, w, dtype=t.dtype)] + [
            t[i].reshape(kvh, 4, page, w).transpose(0, 1) for i in range(b)]
        return torch.cat(pages).contiguous()

    def fresh():
        """Per-block caches holding each row's own prompt prefix."""
        out = []
        with torch.no_grad():
            h = tlm.embed(torch.from_numpy(prompt))
            for block in tlm.blocks:
                h, k, v = block.prefill(h, 32, None, quant)
                if layout == "paged":
                    k, v = T.map_cache(to_pool, k), T.map_cache(to_pool, v)
                out.append((k, v))
        return out

    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    idx = torch.from_numpy(s0).to(torch.int32)
    with torch.no_grad():
        caches = fresh()
        offs = torch.arange(kc)[None, :]
        x = tlm.embed.embed_positions(chunk, idx[:, None] + offs)
        for block, (ck, cv) in zip(tlm.blocks, caches):
            if layout == "paged":
                x, _, _ = block.verify_chunk_paged(x, ck, cv, table, idx)
            else:
                x, _, _ = block.verify_chunk(x, ck, cv, idx)
        fused = tlm.head(x)
        caches = fresh()
        seq = []
        for t in range(kc):
            x = tlm.embed.embed_positions(chunk[:, t:t + 1],
                                          (idx + t)[:, None])
            for block, (ck, cv) in zip(tlm.blocks, caches):
                if layout == "paged":
                    x, _, _ = block.decode_step_paged(x, ck, cv, table,
                                                      idx + t)
                else:
                    x, _, _ = block.decode_step(x, ck, cv, idx + t)
            seq.append(tlm.head(x)[:, 0])
    np.testing.assert_allclose(fused.numpy(), torch.stack(seq, 1).numpy(),
                               atol=TOL, rtol=TOL)


def _prompt(n, seed=0, vocab=37):
    return np.random.RandomState(seed).randint(0, vocab, size=(1, n))


@pytest.mark.parametrize("draft,draft_k", [("target", 1), ("target", 4),
                                           ("draft", 1), ("draft", 4)])
def test_speculative_generate_matches_generate_and_jax(draft, draft_k):
    jlm, variables, tlm = _build("target")
    jd, dvars, td = _build(draft, seed=7 if draft == "draft" else 0)
    prompt, steps = _prompt(6), 17
    want = T.generate(tlm, prompt, steps).numpy()
    got, st = TS.speculative_generate(tlm, prompt, steps, td, draft_k=draft_k,
                                      return_stats=True)
    assert got.dtype == np.int32 and got.shape == (1, steps)
    np.testing.assert_array_equal(got, want)
    jout, jst = JS.speculative_generate(
        jlm, variables, jnp.asarray(prompt, jnp.int32), steps, jd, dvars,
        draft_k=draft_k, return_stats=True)
    np.testing.assert_array_equal(got, np.asarray(jout))
    assert st == jst
    assert st["host_fetches"] == st["rounds"] + 1
    assert st["drafted"] == st["rounds"] * draft_k
    if draft == "target":
        assert st["acceptance"] == 1.0
        assert st["rounds"] == -(-(steps - 1) // (draft_k + 1))


@pytest.mark.parametrize("steps", [1, 2, 5, 6, 7])
def test_speculative_generate_steps_edges(steps):
    """Rounds that overshoot ``steps`` are cut; ``steps == 1`` runs no
    round at all."""
    _, _, tlm = _build("target")
    prompt = _prompt(4, seed=2)
    got, st = TS.speculative_generate(tlm, prompt, steps, tlm, draft_k=4,
                                      return_stats=True)
    np.testing.assert_array_equal(got, T.generate(tlm, prompt, steps).numpy())
    assert st["rounds"] == -(-(steps - 1) // 5)
    assert st["host_fetches"] == st["rounds"] + 1


def test_speculative_generate_eos_padding_matches_generate():
    jlm, variables, tlm = _build("target")
    _, _, td = _build("draft", seed=7)
    prompt, steps = _prompt(5, seed=3), 16
    free = T.generate(tlm, prompt, steps).numpy()[0]
    eos = int(free[6])  # a token the stream really emits mid-way
    want = T.generate(tlm, prompt, steps, eos_id=eos).numpy()
    for d in (tlm, td):
        got = TS.speculative_generate(tlm, prompt, steps, d, draft_k=3,
                                      eos_id=eos)
        np.testing.assert_array_equal(got, want)
    jout = JS.speculative_generate(
        jlm, variables, jnp.asarray(prompt, jnp.int32), steps, jlm, variables,
        draft_k=3, eos_id=eos)
    np.testing.assert_array_equal(want, np.asarray(jout))
    assert (want[0, list(want[0]).index(eos):] == eos).all()


def test_speculative_generate_int8_draft_from_the_jax_payload():
    """The draft's matrices as the very int8 payload JAX's
    ``quantize_params`` produced: loaded through the converter's carrier
    the port's draft proposes what JAX's dequantized draft proposes (same
    rounds),
    and the port's own ``quantize_params`` stays lossless too."""
    jlm, variables, tlm = _build("target")
    jq = JQ.quantize_params(variables)

    def carry(leaf):
        if isinstance(leaf, JQ.QuantizedTensor):
            return (np.asarray(leaf.values), np.asarray(leaf.scales),
                    leaf.shape, leaf.dtype)
        return np.asarray(leaf)

    carried = jax.tree.map(
        carry, jq, is_leaf=lambda l: isinstance(l, JQ.QuantizedTensor))
    c = dict(CONFIGS["target"])
    args = [c.pop(k) for k in ("vocab", "dim", "depth", "heads", "mlp")]
    td = T.transformer_lm(*args, device="cpu", **c)
    td.load_state_dict(from_flax(carried))
    w = td.decoder_block_0.mlp_in.weight
    assert not torch.equal(w, tlm.decoder_block_0.mlp_in.weight)
    np.testing.assert_array_equal(
        w.detach().numpy().T,
        np.asarray(JQ.dequantize(
            jq["decoder_block_0"]["params"]["mlp_in"]["kernel"])))
    prompt, steps = _prompt(7, seed=5), 15
    want = T.generate(tlm, prompt, steps).numpy()
    got, st = TS.speculative_generate(tlm, prompt, steps, td, draft_k=4,
                                      return_stats=True)
    np.testing.assert_array_equal(got, want)
    jout, jst = JS.speculative_generate(
        jlm, variables, jnp.asarray(prompt, jnp.int32), steps, jlm,
        JQ.dequantize_params(jq), draft_k=4, return_stats=True)
    np.testing.assert_array_equal(got, np.asarray(jout))
    assert st == jst and st["acceptance"] > 0.5
    # The port's own quantization of the draft (torch layout blocks).
    qw = TQ.quantize_params(tlm.state_dict())
    before = {k: v.clone() for k, v in tlm.state_dict().items()}
    got2, st2 = TS.speculative_generate(tlm, prompt, steps, tlm, draft_k=4,
                                        return_stats=True, draft_weights=qw)
    np.testing.assert_array_equal(got2, want)
    assert st2["acceptance"] > 0.5
    for k, v in tlm.state_dict().items():  # swapped back afterwards
        assert torch.equal(v, before[k])


def test_speculative_generate_validation():
    _, _, tlm = _build("target")
    big = T.transformer_lm(41, 16, 1, 1, 32, max_len=48, device="cpu")
    p = _prompt(4)
    with pytest.raises(ValueError, match="single-request"):
        TS.speculative_generate(tlm, np.zeros((2, 4), np.int64), 4, tlm)
    with pytest.raises(ValueError, match="steps"):
        TS.speculative_generate(tlm, p, 0, tlm)
    with pytest.raises(ValueError, match="draft_k"):
        TS.speculative_generate(tlm, p, 4, tlm, draft_k=0)
    with pytest.raises(ValueError, match="exceeds max_len"):
        TS.speculative_generate(tlm, p, 45, tlm)
    with pytest.raises(ValueError, match="vocab"):
        TS.speculative_generate(tlm, p, 4, big)
    props = torch.tensor([[1, 2, 3], [1, 9, 3], [7, 2, 3]])
    preds = torch.tensor([[1, 2, 3, 4], [1, 2, 3, 4], [1, 2, 3, 4]])
    assert TS.accept_speculation(props, preds).tolist() == [3, 1, 0]
