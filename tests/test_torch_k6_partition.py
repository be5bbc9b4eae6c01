"""K6's partition on the card, held against the JAX package on the CPU.

K6-dequantize (``csrc/dequantize_blocks.cu``) takes a whole weight tree in
one launch per table of at most ``MAX_LEAVES`` leaves
(``ops/quantize.dequantize_plan``: leaves in tree order, empty ones left
out, leaf j owning chunks [first[j], first[j + 1]) of CHUNK elements, so a
chunk never straddles two leaves). CTA c finds its leaf by a binary search
of the prefix sums; each of its warps reads spans of 512 int8 values (16 a
lane, one 16-byte load each), scales a span by its block scale
``scales[span >> 13]`` in f32, rounds once into the leaf's dtype and
writes it in rounds of 16-byte stores, lane t of round r the outputs at
(32 r + t) * 16 / sizeof(dtype), cut at n (spans past n do nothing).
K6-quantize (``csrc/quantize_blocks.cu``) gives each 8192-element block a
cluster of 4 CTAs of 128 threads; each warp reads a span of 512 with
16-byte loads (load l of lane t at (32 l + t) * 16 / sizeof(dtype)):
a thread's, then a warp's, then a CTA's absmax (NaN-propagating), the four
partials read by every CTA, the scale max(absmax, 1e-12) / 127 by a true
division, and per element round half to even, 0 for a NaN quotient, else
the clamp to +-127, the bytes written in element order.

This file carries torch emulations of both walks (test code, not part of
the package) and holds them, on trees of mixed f32 / bf16 / f16 leaves with
ragged sizes, an empty leaf, 1-D leaves that pass through and 40 leaves
(two tables), and on NaN / +-Inf blocks:

- dequantize: every element written exactly once, every load inside the
  padded payload, and each leaf bit-equal to the port's
  ``dequantize_reference`` / ``dequantize_params`` and to the JAX
  package's interpreted ``dequantize`` and ``dequantize_reference`` of the
  same payload (NaN-aware);
- quantize: values and scales bit-equal to the port's and the JAX
  package's ``quantize_reference`` (NaN-aware scales), and to JAX's
  interpreted ``quantize``, whose scalar scale is held to its own
  reference: wherever it differs from ``quantize_reference`` it differs by
  one ulp (JAX's kernel, not the port: see ROADMAP.md section 3), and the
  port follows the reference.

The card's kernels are held to the plain versions bit for bit in
``test_torch_kernels_gpu.py`` and ``chip_smoke.py``."""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.ops import quantize as TQ

JQ = importlib.import_module("adapt_tpu.ops.quantize")

VECS = TQ.CHUNK // (TQ.DEQ_THREADS * TQ.VEC)  # 16-byte vectors a thread
CLUSTER, QT, QV = 4, 128, 16  # quantize: CTAs a block, threads, values


def emulate_dequantize(qts):
    """K6-dequantize's walk over ``dequantize_plan``'s tables. Returns the
    outputs (logical shape and dtype), the number of writes of every
    element and the number of launches."""
    sizes = [math.prod(qt.shape) for qt in qts]
    outs = [torch.zeros(n, dtype=qt.dtype) for n, qt in zip(sizes, qts)]
    writes = [torch.zeros(n, dtype=torch.int32) for n in sizes]
    plan = TQ.dequantize_plan(sizes)
    lanes = torch.arange(32)
    for idx, first in plan:
        assert 1 <= len(idx) <= TQ.MAX_LEAVES and first[0] == 0
        for c in range(first[-1]):
            lo, hi = 0, len(idx) - 1  # the kernel's binary search
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                lo, hi = (mid, hi) if first[mid] <= c else (lo, mid - 1)
            j = idx[lo]
            qt, n = qts[j], sizes[j]
            vals, scales = qt.values.reshape(-1), qt.scales.reshape(-1)
            esize = torch.finfo(qt.dtype).bits // 8
            per = 16 // esize  # outputs a 16-byte store
            e0 = (c - first[lo]) * TQ.CHUNK
            for u in range(VECS):
                for warp in range(TQ.DEQ_THREADS // 32):
                    span = e0 + (u * TQ.DEQ_THREADS + warp * 32) * TQ.VEC
                    if span >= n:  # spans past n do nothing
                        continue
                    # Each lane's 16-byte load of 16 int8 values, when it
                    # starts below n, stays inside the padded payload.
                    loads = span + lanes * TQ.VEC
                    assert int(loads[loads < n].max()) + TQ.VEC <= vals.numel()
                    s = scales[span >> 13]  # 512 | 8192: one scale a span
                    for r in range(esize):  # store rounds, 512 bytes each
                        pos = (span + (r * 32 + lanes) * per)[:, None] \
                            + torch.arange(per)
                        keep = pos < n  # stores past n are cut
                        f = vals[pos[keep]].to(torch.float32) * s
                        outs[j][pos[keep]] = f.to(qt.dtype)
                        writes[j][pos[keep]] += 1
    return ([o.reshape(qt.shape) for o, qt in zip(outs, qts)], writes,
            len(plan))


def emulate_quantize(x):
    """K6-quantize's cluster walk: (values (rows, 128) int8, scales (nb,
    1) f32)."""
    flat = x.to(torch.float32).reshape(-1)
    n = flat.numel()
    nb = -(-n // TQ.BLOCK)
    per = 16 // x.element_size()  # elements a 16-byte load
    v = torch.nn.functional.pad(flat, (0, nb * TQ.BLOCK - n))
    # block, rank, warp, load l, lane, element: a warp's span of 512 read
    # as QV / per loads, load l of lane t at (32 l + t) per.
    v = v.reshape(nb, CLUSTER, QT // 32, QV // per, 32, per)
    # torch.amax propagates NaN, as PTX max.NaN does.
    a = torch.amax(v.abs(), dim=(3, 5))  # a thread's 16
    a = torch.amax(a, dim=3)  # the warp's shuffles
    a = torch.amax(a, dim=2)  # the CTA's partial, in shared memory
    amax = torch.amax(a, dim=1)  # every CTA reads the cluster's four
    s = torch.maximum(amax, torch.tensor(1e-12)) / torch.full_like(amax,
                                                                   127.0)
    r = torch.round(v / s.reshape(nb, 1, 1, 1, 1, 1))
    q = torch.where(torch.isnan(r), torch.zeros_like(r),
                    r.clamp(-127.0, 127.0))
    # The staged bytes keep element order: byte (32 l + t) per + i.
    return q.to(torch.int8).reshape(-1, TQ.LANES), s[:, None]


def _tensor(rng, shape, dtype, scale=1.0):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(dtype)


def _trees():
    rng = np.random.default_rng(5)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    draft_like = {  # a 2-layer LM's state_dict at narrow widths
        "embed.pos_embed": _tensor(rng, (64, 48), f32, 0.02),
        "embed.tok.weight": _tensor(rng, (503, 48), bf16, 0.02),
    }
    for i in range(2):
        p = f"decoder_block_{i}."
        draft_like.update({
            p + "ln1.scale": torch.ones(48),
            p + "attn.qkv.weight": _tensor(rng, (144, 48), bf16, 0.05),
            p + "attn.qkv.bias": _tensor(rng, (144,), bf16),
            p + "attn.out.weight": _tensor(rng, (48, 48), bf16, 0.05),
            p + "mlp_in.weight": _tensor(rng, (192, 48), bf16, 0.05),
            p + "mlp_out.weight": _tensor(rng, (48, 192), bf16, 0.05),
        })
    draft_like["head.logits.weight"] = _tensor(rng, (503, 48), f32, 0.02)
    mixed = {
        "a": _tensor(rng, (37, 211), f32, 3.0),  # ragged: 7807
        "nested": {"b": _tensor(rng, (3, 5, 1111), bf16),  # 16665
                   "empty": torch.zeros((0, 16), dtype=f16),
                   "bias": _tensor(rng, (9,), f32)},
        "c": _tensor(rng, (2, 8192), f16),  # two whole blocks
        "d": _tensor(rng, (5, 3), f16),  # under one vector
        "e": _tensor(rng, (4097, 2), bf16),  # one past two chunks
    }
    shapes = [((8, 7), f32), ((33, 17), bf16), ((2, 4100), f16),
              ((129, 64), bf16)]
    forty = {f"w{i}": _tensor(rng, *shapes[i % 4]) for i in range(40)}
    forty["bias"] = _tensor(rng, (7,), f32)
    return {"draft_like": (draft_like, 1), "mixed": (mixed, 1),
            "forty_leaves": (forty, 2)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _jax_payload(qt):
    return JQ.QuantizedTensor(jnp.asarray(qt.values.numpy()),
                              jnp.asarray(qt.scales.numpy()), qt.shape,
                              jnp.dtype(str(qt.dtype).split(".")[-1]))


def _same(a, b):
    """Bit-equal up to NaN payloads (a NaN on both sides counts equal)."""
    return np.array_equal(a, b, equal_nan=True)


def test_plan_tables_and_prefix_sums():
    sizes = [5000, 0, 4096, 4097, 1, 8192 * 3 + 1] + [100] * 40
    plan = TQ.dequantize_plan(sizes)
    live = [i for i, n in enumerate(sizes) if n]
    assert [i for idx, _ in plan for i in idx] == live  # tree order
    assert [len(idx) for idx, _ in plan] == [TQ.MAX_LEAVES,
                                              len(live) - TQ.MAX_LEAVES]
    for idx, first in plan:
        assert first[0] == 0 and len(first) == len(idx) + 1
        for j, i in enumerate(idx):
            assert first[j + 1] - first[j] == -(-sizes[i] // TQ.CHUNK)
    assert plan[0][1][1:6] == [2, 3, 5, 6, 13]
    assert TQ.dequantize_plan([0, 0]) == []
    assert TQ.CHUNK % TQ.VEC == 0 and TQ.BLOCK % TQ.VEC == 0


@pytest.mark.parametrize("name", ["draft_like", "mixed", "forty_leaves"])
def test_grouped_dequantize_walk_bit_equal(name):
    tree, launches = _trees()[name]
    qtree = TQ.quantize_params(tree)
    named = [(k, v) for k, v in _leaves(qtree)
             if isinstance(v, TQ.QuantizedTensor)]
    outs, writes, n_launch = emulate_dequantize([qt for _, qt in named])
    assert n_launch == launches
    back = dict(_leaves(TQ.dequantize_params(qtree)))
    src = dict(_leaves(tree))
    for (key, qt), out, w in zip(named, outs, writes):
        assert bool((w == 1).all()), key  # every element written once
        assert out.dtype == src[key].dtype and out.shape == src[key].shape
        assert torch.equal(out, TQ.dequantize_reference(qt)), key
        assert torch.equal(out, back[key]), key
        if out.numel():
            jq = _jax_payload(qt)
            for want in (JQ.dequantize(jq), JQ.dequantize_reference(jq)):
                assert np.array_equal(out.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    for key, leaf in _leaves(tree):
        if leaf.ndim < 2:
            assert back[key] is leaf  # 1-D leaves pass through


def _quant_cases():
    rng = np.random.default_rng(17)
    nan_inf = rng.standard_normal((3, 8192)).astype(np.float32)
    nan_inf[0, 17], nan_inf[1, 4000], nan_inf[2, 8191] = (np.nan, np.inf,
                                                          -np.inf)
    inf = rng.standard_normal((2, 8192)).astype(np.float32)
    inf[0, 2047], inf[1, 2048] = np.inf, -np.inf  # rank edges
    tail = rng.standard_normal((1000, 37)).astype(np.float32)
    tail[-1, -1] = np.nan  # in the ragged last block
    return {
        "matrix_bf16": (rng.standard_normal((96, 512)) * 0.04, "bfloat16"),
        "ragged_f32": (rng.standard_normal((1000, 37)) * 3.0, "float32"),
        "small_f16": (rng.standard_normal((17,)), "float16"),
        "nan_inf_f32": (nan_inf, "float32"),
        "nan_inf_bf16": (nan_inf, "bfloat16"),
        "inf_bf16": (inf, "bfloat16"),
        "nan_tail_f32": (tail, "float32"),
    }


@pytest.mark.parametrize("name", list(_quant_cases()))
def test_quantize_cluster_walk_bit_equal(name):
    x, dtype = _quant_cases()[name]
    jx = jnp.asarray(x.astype(np.float32)).astype(dtype)
    tx = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    vals, scales = emulate_quantize(tx)
    tr = TQ.quantize_reference(tx)
    jr = JQ.quantize_reference(jx)
    for want in (tr, jr):
        assert np.array_equal(vals.numpy(), np.asarray(want.values))
        assert _same(scales.numpy(), np.asarray(want.scales))
    # JAX's interpreted kernel forms its scalar scale with a one-ulp
    # difference from the true division in some blocks; elsewhere it, and
    # so the emulation, is bit-equal to it.
    jq = JQ.quantize(jx)
    js, rs = np.asarray(jq.scales).ravel(), np.asarray(jr.scales).ravel()
    off = ~((js == rs) | (np.isnan(js) & np.isnan(rs)))
    ulps = np.abs(js[off].view(np.int32).astype(np.int64)
                  - rs[off].view(np.int32).astype(np.int64))
    assert (ulps <= 1).all()
    same = np.repeat(~off, TQ.BLOCK)
    assert _same(scales.numpy().ravel()[~off], js[~off])
    assert np.array_equal(vals.numpy().ravel()[same],
                          np.asarray(jq.values).ravel()[same])
    if not np.isfinite(x).all():
        assert not np.isfinite(scales.numpy()).all()


class _FakeLib:
    """Stands in for the built K6-dequantize library on the CPU: records
    each launch's table and runs the emulated walk on the tensors behind
    the table's pointers."""

    def __init__(self, tensors):
        self.by_ptr = {t.data_ptr(): t for t in tensors}
        self.tables = []

    def dequantize_blocks(self, vals, scales, outs, n, dtype, first, count,
                          stream):
        table = [(vals[j], scales[j], outs[j], n[j], dtype[j])
                 for j in range(count)]
        self.tables.append((table, list(first[:count + 1])))
        codes = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16}
        qts = [TQ.QuantizedTensor(self.by_ptr[v], self.by_ptr[s], (k,),
                                  codes[d]) for v, s, _, k, d in table]
        got, _, launches = emulate_dequantize(qts)
        assert launches == 1
        for (_, _, o, k, _), g in zip(table, got):
            self.by_ptr[o].view(-1)[:k] = g
        return 0


def test_grouped_launch_marshals_one_table_per_32_leaves(monkeypatch):
    """The host side of the grouped launch: ``dequantize_params``' CUDA
    path builds one table a launch (pointers, sizes, dtype codes, chunk
    prefix sums, in tree order) and returns the kernel's outputs in the
    tree's places; an unaligned payload raises before any launch."""
    tree, _ = _trees()["forty_leaves"]
    qts = [v for _, v in _leaves(TQ.quantize_params(tree))
           if isinstance(v, TQ.QuantizedTensor)]
    lib = _FakeLib([t for qt in qts for t in (qt.values, qt.scales)])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(TQ._build, "load", lambda name: lib)
    orig = TQ._dequantize_launch

    def launch(qts_, outs, first):  # the outputs' pointers, for the fake
        lib.by_ptr.update({o.data_ptr(): o for o in outs})
        return orig(qts_, outs, first)

    monkeypatch.setattr(TQ, "_dequantize_launch", launch)
    n0 = TQ.dequantize_blocks.launches
    outs = TQ._dequantize_grouped(qts)
    assert TQ.dequantize_blocks.launches == n0 + 2 and len(lib.tables) == 2
    sizes = [math.prod(qt.shape) for qt in qts]
    for (table, first), (idx, want) in zip(lib.tables,
                                           TQ.dequantize_plan(sizes)):
        assert first == want
        for (v, s, o, n, d), i in zip(table, idx):
            assert (v, s, o) == (qts[i].values.data_ptr(),
                                 qts[i].scales.data_ptr(),
                                 outs[i].data_ptr())
            assert n == sizes[i]
            assert d == TQ._build.dtype_code(qts[i].dtype)
    for qt, out in zip(qts, outs):
        assert torch.equal(out, TQ.dequantize_reference(qt))
    bad = qts[0]
    shifted = torch.empty(bad.values.numel() + 1, dtype=torch.int8)
    shifted[1:] = bad.values.reshape(-1)
    bad = TQ.QuantizedTensor(shifted[1:].view(-1, TQ.LANES), bad.scales,
                             bad.shape, bad.dtype)
    with pytest.raises(ValueError, match="aligned"):
        TQ._dequantize_grouped([bad])
    assert len(lib.tables) == 2
