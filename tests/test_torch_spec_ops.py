"""The speculative slice's ops, on the CPU, against the JAX package.

- ``verify_attention`` and ``paged_verify_attention_reference`` equal the
  JAX package's at ``atol = rtol = 1e-5`` on live rows: native / int8 /
  int4, scalar and ``(b,)`` index, sliding window, ``tree_tail``.
- K5's plain version (split 1 and 4) equals the JAX package's interpreted
  ``_verify_kernel`` (``paged_verify_attention(prefer="pallas")`` at page
  128) at ``2e-5``, and emits zeros for dead rows.
- K6's plain versions are BIT-EQUAL to the JAX package's ``quantize``
  (interpret mode) and ``quantize_reference`` / ``dequantize``: bf16 input,
  a ragged size, zero and constant blocks, NaN / +Inf / -Inf blocks (NaN
  scales compared NaN-aware); ``quantize_params`` quantizes exactly the
  float leaves with ``ndim >= 2``.
- ``speculative_sample`` alone: ``top_k = 1`` equals greedy, and over 2400
  seeds on a 16-token vocabulary the committed token's distribution is
  within total variation 0.05 of the target's softmax."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.models.speculative import speculative_sample
from adapt_tpu_torch.models.transformer_lm import truncate_rows
from adapt_tpu_torch.ops import decode_attention as TD
from adapt_tpu_torch.ops import paged_attention as TP
from adapt_tpu_torch.ops import quantize as TQ

JD = importlib.import_module("adapt_tpu.ops.decode_attention")
JP = importlib.import_module("adapt_tpu.ops.paged_attention")
JQ = importlib.import_module("adapt_tpu.ops.quantize")

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kv(rng, shape, kind):
    """Native f32 K/V, or the shared per-vector quantization of it, as
    (numpy operand, jax operand, torch operand)."""
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "native":
        return jnp.asarray(x), torch.from_numpy(x)
    vals, sc = JQ.quantize_kv_vectors(jnp.asarray(x), kind)
    return (vals, sc), (torch.from_numpy(np.array(vals)),
                        torch.from_numpy(np.array(sc)))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.mark.parametrize("kind", ["native", "int8", "int4"])
@pytest.mark.parametrize("window,tree_tail", [(None, 0), (9, 0), (None, 2),
                                              (11, 2)])
def test_verify_attention_matches_jax(kind, window, tree_tail):
    rng = np.random.default_rng(3)
    b, kvh, g, kc, hd, L = 3, 2, 2, 5, 16, 40
    q = rng.standard_normal((b, kvh, g * kc, hd)).astype(np.float32)
    jk, tk = _kv(rng, (b, kvh, L, hd), kind)
    jv, tv = _kv(rng, (b, kvh, L, hd), kind)
    for index in (17, np.asarray([4, 30, 12], np.int32)):
        jidx = index if np.ndim(index) == 0 else jnp.asarray(index)
        want = JD.verify_attention(jnp.asarray(q), jk, jv, jidx, kc,
                                   window=window, tree_tail=tree_tail)
        tidx = index if np.ndim(index) == 0 else torch.from_numpy(index)
        got = TD.verify_attention(torch.from_numpy(q), tk, tv, tidx, kc,
                                  window=window, tree_tail=tree_tail)
        _close(got, want, msg=f"index={index}")


def _pools(rng, npages, kvh, page, hd, kind):
    jk, tk = _kv(rng, (npages, kvh, page, hd), kind)
    jv, tv = _kv(rng, (npages, kvh, page, hd), kind)
    return jk, jv, tk, tv


@pytest.mark.parametrize("kind", ["native", "int8", "int4"])
@pytest.mark.parametrize("window,tree_tail", [(None, 0), (20, 0), (None, 2)])
def test_paged_verify_reference_and_plain_match_jax_oracle(kind, window,
                                                           tree_tail):
    """Small pages (16): the gather oracle against JAX's, and the plain
    version of K5 / K5-split against it on live rows, zeros on the dead
    row."""
    rng = np.random.default_rng(5)
    b, kvh, g, kc, hd, page, npages = 3, 2, 2, 5, 16, 16, 13
    q = rng.standard_normal((b, kvh, g * kc, hd)).astype(np.float32)
    jk, jv, tk, tv = _pools(rng, npages, kvh, page, hd, kind)
    table = np.asarray([[3, 7, 1, 0], [5, 2, 9, 4], [6, 8, 0, 0]], np.int32)
    index = np.asarray([37, 50, -7], np.int32)  # row 2 is dead
    want = JP.paged_verify_attention_reference(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(index), kc,
        window=window, tree_tail=tree_tail)
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(table),
            torch.from_numpy(index), kc)
    got = TP.paged_verify_attention_reference(*args, window, tree_tail)
    _close(got[:2], want[:2])
    for split in (1, 4):
        out = TP.paged_verify_attention(*args, window=window,
                                        tree_tail=tree_tail, split=split)
        _close(out[:2], want[:2], msg=f"split={split}")
        assert torch.count_nonzero(out[2]) == 0


@pytest.mark.parametrize("kind,page", [("native", 128), ("int8", 1024),
                                       ("int4", 1024)])
def test_k5_plain_matches_interpreted_verify_kernel(kind, page):
    """The plain version of K5 and K5-split against the JAX package's
    ``_verify_kernel`` run by the Pallas interpreter (pages the TPU gates
    admit: 128 native, 1024 quantized), windowed and with a tree tail."""
    rng = np.random.default_rng(7)
    b, kvh, g, kc, hd, npages = 2, 1, 2, 5, 64, 7
    q = rng.standard_normal((b, kvh, g * kc, hd)).astype(np.float32)
    jk, jv, tk, tv = _pools(rng, npages, kvh, page, hd, kind)
    table = np.asarray([[3, 5, 1], [6, 2, 4]], np.int32)
    index = np.asarray([2 * page + 41, page - 3], np.int32)
    for window, tree_tail, split in ((None, 0, 1), (page + 2, 0, 2),
                                     (None, 2, 4)):
        want = JP.paged_verify_attention(
            jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(index),
            kc, prefer="pallas", window=window, tree_tail=tree_tail,
            split=split)
        got = TP.paged_verify_attention(
            torch.from_numpy(q), tk, tv, torch.from_numpy(table),
            torch.from_numpy(index), kc, window=window, tree_tail=tree_tail,
            split=split)
        _close(got, want, 2e-5, msg=f"w={window} tt={tree_tail} s={split}")


def test_paged_verify_dispatch_rules():
    q = torch.zeros(1, 2, 5, 16)
    pool = torch.zeros(3, 2, 8, 16)
    table = torch.zeros(1, 2, dtype=torch.int32)
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="prefer"):
        TP.paged_verify_attention(q, pool, pool, table, idx, 5, prefer="cuda")
    with pytest.raises(ValueError, match="split"):
        TP.paged_verify_attention(q, pool, pool, table, idx, 5, split=0)
    with pytest.raises(ValueError, match="KV-head"):
        TP.paged_verify_attention(q[:, :1], pool, pool, table, idx, 5)
    with pytest.raises(ValueError, match="CUDA"):
        TP.paged_verify_attn(q, pool, pool, table, idx, 5)
    # prefer="xla" is the plain version on CPU tensors.
    out = TP.paged_verify_attention(q, pool, pool, table, idx, 5,
                                    prefer="xla")
    assert out.shape == q.shape


# -- K6 ----------------------------------------------------------------------


def _quant_inputs():
    rng = np.random.default_rng(11)
    ragged = rng.standard_normal((3, 5000)).astype(np.float32) * 3.0
    blocks = rng.standard_normal((4, 8192)).astype(np.float32)
    blocks[1] = 0.0  # an all-zero block
    blocks[2] = -0.37  # a constant block
    halves = (np.arange(-40, 41, dtype=np.float32) / 2.0)  # .5 ties
    nan_inf = rng.standard_normal((3, 8192)).astype(np.float32)
    nan_inf[0, 17], nan_inf[1, 4000], nan_inf[2, 8191] = np.nan, np.inf, -np.inf
    inf = rng.standard_normal((2, 8192)).astype(np.float32)
    inf[0, 5], inf[1, 6000] = np.inf, -np.inf  # Inf blocks, no NaN
    return {
        "ragged": ragged,
        "matrix": rng.standard_normal((96, 256)).astype(np.float32) * 0.05,
        "zero_const": blocks,
        "ties": np.concatenate([halves, [127.0]]).astype(np.float32),
        "tiny": rng.standard_normal((7,)).astype(np.float32) * 1e-14,
        # Non-finite input: a NaN block gets a NaN scale, an Inf block an
        # Inf scale, and a NaN quotient (NaN, or Inf / Inf) stores 0.
        "nan_inf": nan_inf,
        "inf": inf,
    }


@pytest.mark.parametrize("name", list(_quant_inputs()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_plain_bit_equal_to_jax(name, dtype):
    x = _quant_inputs()[name]
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert np.array_equal(np.asarray(jx.astype(jnp.float32)),
                          tx.float().numpy(), equal_nan=True)
    jq = JQ.quantize(jx)  # the Pallas kernel, interpreted
    jr = JQ.quantize_reference(jx)
    tq = TQ.quantize(tx)
    assert tq.shape == tuple(x.shape) and tq.dtype == tx.dtype
    for want in (jq, jr):
        assert np.array_equal(tq.values.numpy(), np.asarray(want.values))
        # NaN-aware: a NaN scale must be NaN on both sides.
        assert np.array_equal(tq.scales.numpy(), np.asarray(want.scales),
                              equal_nan=True)
    back = TQ.dequantize(tq)
    assert back.dtype == tx.dtype and back.shape == tx.shape
    for want in (JQ.dequantize(jq), JQ.dequantize_reference(jr)):
        assert np.array_equal(back.float().numpy(),
                              np.asarray(want.astype(jnp.float32)),
                              equal_nan=True)
    # The round trip stays within half a quantization step per block (the
    # blocks with a finite scale: every block of finite input).
    fin = torch.isfinite(tq.scales).reshape(-1)
    blk = torch.arange(tx.numel()) // TQ.BLOCK
    keep = fin[blk]
    assert keep.all() == bool(np.isfinite(x).all())
    if keep.any():
        step = tq.scales.reshape(-1)[fin].max().item()
        slack = (0.0 if dtype == "float32"
                 else 0.01 * np.abs(x.reshape(-1)[keep.numpy()]).max())
        err = (back.float().reshape(-1) - tx.float().reshape(-1))[keep]
        assert err.abs().max() <= step / 2 + slack + 1e-12


def test_k6_storage_offset_views_equal_jax():
    """A contiguous view at storage offset 1 (``buf[1:].view(2, 8192)`` of
    a bf16 ``buf``: a base no 16-byte vector load may start at) quantizes to
    JAX's values and scales, and an int8 payload stored at an odd offset
    dequantizes to JAX's values, bit for bit. The copy the public
    ``quantize`` / ``dequantize`` make on the card for such bases
    (``aligned16``) lands 16-byte aligned and holds the same elements."""
    rng = np.random.default_rng(12)
    buf = torch.from_numpy(rng.standard_normal(2 * 8192 + 1).astype(
        np.float32)).to(torch.bfloat16)
    x = buf[1:].view(2, 8192)
    assert x.storage_offset() == 1 and x.is_contiguous()
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jq = JQ.quantize(jx)
    tq = TQ.quantize(x)
    assert np.array_equal(tq.values.numpy(), np.asarray(jq.values))
    assert np.array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    shifted = torch.empty(tq.values.numel() + 1, dtype=torch.int8)
    shifted[1:] = tq.values.reshape(-1)
    odd = TQ.QuantizedTensor(shifted[1:].view(-1, 128), tq.scales, tq.shape,
                             tq.dtype)
    assert odd.values.storage_offset() == 1
    assert np.array_equal(TQ.dequantize(odd).float().numpy(),
                          np.asarray(JQ.dequantize(jq).astype(jnp.float32)))
    for t in (x, odd.values):
        copy = TQ.aligned16(t)
        assert copy.data_ptr() % 16 == 0 and torch.equal(copy, t)
    fixed = TQ._aligned_payload(odd)
    assert fixed.values.data_ptr() % 16 == 0
    assert torch.equal(fixed.values, tq.values)
    aligned = buf[:-1].view(2, 8192)
    if aligned.data_ptr() % 16 == 0:  # an aligned base is never copied
        assert TQ.aligned16(aligned) is aligned


def test_quantize_params_leaf_selection():
    tree = {
        "w": torch.randn(8, 8),
        "b": torch.randn(8),
        "nested": {"emb": torch.randn(3, 4, 5, dtype=torch.bfloat16),
                   "ids": torch.arange(6).reshape(2, 3),
                   "scale": torch.ones(4)},
    }
    q = TQ.quantize_params(tree)
    assert isinstance(q["w"], TQ.QuantizedTensor)
    assert isinstance(q["nested"]["emb"], TQ.QuantizedTensor)
    assert q["b"] is tree["b"] and q["nested"]["scale"] is tree["nested"]["scale"]
    assert q["nested"]["ids"] is tree["nested"]["ids"]  # ints stay
    back = TQ.dequantize_params(q)
    assert back["w"].shape == (8, 8) and back["w"].dtype == torch.float32
    assert back["nested"]["emb"].dtype == torch.bfloat16
    assert torch.equal(back["w"], TQ.dequantize(q["w"]))
    assert q["w"].nbytes_payload == 64 * 128 + 4
    with pytest.raises(ValueError, match="CUDA"):
        TQ.quantize_blocks(tree["w"])
    with pytest.raises(ValueError, match="CUDA"):
        TQ.dequantize_blocks(q["w"])


def test_quantized_leaf_carrier_loads_the_jax_payload():
    """A JAX ``QuantizedTensor`` given as numpy fields becomes the port's,
    and dequantizes to the very tensor JAX restores."""
    from adapt_tpu_torch.convert import quantized_leaf

    x = jnp.asarray(np.random.default_rng(2).standard_normal((40, 300)),
                    jnp.float32)
    jq = JQ.quantize(x)
    tq = quantized_leaf(np.asarray(jq.values), np.asarray(jq.scales),
                        jq.shape, jq.dtype)
    assert tq.dtype == torch.float32 and tq.shape == (40, 300)
    assert np.array_equal(TQ.dequantize(tq).numpy(),
                          np.asarray(JQ.dequantize(jq)))
    with pytest.raises(ValueError, match="float"):
        quantized_leaf(np.zeros((64, 128)), np.ones((1, 1)), (4,), "int32")


# -- speculative sampling ----------------------------------------------------


def test_speculative_sample_top_k_1_is_greedy():
    rng = np.random.default_rng(0)
    B, d, V = 6, 4, 16
    logits = torch.from_numpy(rng.standard_normal((B, d + 1, V))).float()
    greedy = logits.argmax(-1)
    props = greedy[:, :d].clone()
    props[1, 2] = (props[1, 2] + 1) % V  # one wrong proposal mid-chain
    props[4, 0] = (props[4, 0] + 3) % V  # one wrong at once
    lgp = truncate_rows(
        (logits / 0.7).reshape(-1, V), torch.ones(B * (d + 1), dtype=torch.int64)
    ).reshape(B, d + 1, V)
    seeds = torch.arange(B) + 5
    out, acc = speculative_sample(lgp, props, seeds, torch.zeros(B).long())
    assert acc.tolist() == [4, 2, 4, 4, 0, 4]
    for i, a in enumerate(acc.tolist()):
        assert out[i, : a + 1].tolist() == greedy[i, : a + 1].tolist()


@pytest.mark.parametrize("which", ["likely", "unlikely"])
def test_speculative_sample_commits_the_target_distribution(which):
    """Position 0's committed token (the accepted proposal, or the residual
    draw) is distributed as the target's softmax whatever the proposal; so
    is position d's fresh draw."""
    V, n, d = 16, 2400, 2
    rng = np.random.default_rng(1)
    row = torch.from_numpy(rng.standard_normal(V)).float() * 1.5
    p = torch.softmax(row, -1)
    prop = int(p.argmax() if which == "likely" else p.argmin())
    lgp = row.expand(n, d + 1, V).contiguous()
    props = torch.full((n, d), prop)
    out, acc = speculative_sample(lgp, props, torch.arange(n) * 7 + 1,
                                  torch.full((n,), 3))
    first = torch.bincount(out[:, 0], minlength=V).float() / n
    assert 0.5 * (first - p).abs().sum() < 0.05
    # Acceptance of position 0 happens with the target's probability.
    assert abs((acc >= 1).float().mean().item() - p[prop].item()) < 0.04
    tail = torch.bincount(out[:, d], minlength=V).float() / n
    assert 0.5 * (tail - p).abs().sum() < 0.05
    # The same (seed, counter) gives the same draw: a pure function.
    again, _ = speculative_sample(lgp, props, torch.arange(n) * 7 + 1,
                                  torch.full((n,), 3))
    assert torch.equal(out, again)
