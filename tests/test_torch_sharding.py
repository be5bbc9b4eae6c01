"""The port's sharding over a mesh of shards (``core/mesh.build_mesh``,
``parallel/sharding``, ``parallel/expert``, ``convert.shard_state_dict``),
held against the JAX package's on the CPU.

Every leaf's port spec (torch layout) must equal the JAX spec (flax
layout) translated by the weight's layout change, for a GQA LM, an MHA MoE
LM and a ViT; port shard ``i`` of every converted tensor must equal the
converted piece of the JAX leaf's ``addressable_shards[i]`` on the
simulated mesh. ``merge_specs``, ``fetch_head_shards``,
``KVHandoffPlan.place``, the expert placement and ``expert_utilization``
are held to the JAX functions on the same numpy inputs."""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.convert import from_flax, shard_state_dict, vit_from_flax
from adapt_tpu_torch.core.mesh import MeshSpec, build_mesh
from adapt_tpu_torch.parallel import expert as TE
from adapt_tpu_torch.parallel import sharding as TS
from adapt_tpu_torch.parallel.sharding import Blocks, P, Shards

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JV = importlib.import_module("adapt_tpu.models.vit")
JS = importlib.import_module("adapt_tpu.parallel.sharding")
JE = importlib.import_module("adapt_tpu.parallel.expert")


def _mesh(n, axis="tp"):
    return build_mesh(MeshSpec(((axis, n),)), ["cpu"] * n)


def _init(jm, x):
    return jax.device_get(jm.init(jax.random.PRNGKey(0), x))


_CACHE = {}


def _models():
    """(name, JAX variables, flax path -> port name, converter, JAX rules,
    port rules) for a GQA LM, an MHA MoE LM and a ViT."""
    if "m" in _CACHE:
        return _CACHE["m"]
    ids = jnp.zeros((1, 4), jnp.int32)
    gqa = J.transformer_lm(37, 32, 2, 8, 64, max_len=48, kv_heads=4)
    moe = J.transformer_lm(53, 32, 2, 4, 48, max_len=48, moe_experts=8,
                           moe_top_k=2)
    vit = JV.vit_tiny()
    _CACHE["m"] = [
        ("gqa", _init(gqa.graph, ids), _lm_name, from_flax,
         JS.lm_tp_rules, TS.lm_tp_rules),
        ("moe", _init(moe.graph, ids), _lm_name, from_flax,
         JS.lm_tp_rules, TS.lm_tp_rules),
        ("vit", _init(vit, jnp.zeros((1, 32, 32, 3))), _vit_name,
         vit_from_flax, JS.vit_tp_rules, TS.vit_tp_rules),
    ]
    return _CACHE["m"]


def _lm_name(keys):
    node, _, *rest = keys
    rest = ["weight" if k in ("kernel", "embedding") else k for k in rest]
    return ".".join([node] + rest)


_VIT = {"LayerNorm_0": "ln1", "LayerNorm_1": "ln2", "Dense_0": "mlp_in",
        "Dense_1": "mlp_out", "Conv_0": None, "kernel": "weight"}
_VIT_HEAD = {"LayerNorm_0": "ln", "Dense_0": "fc", "kernel": "weight"}


def _vit_name(keys):
    node, _, *rest = keys
    table = _VIT_HEAD if node == "head" else _VIT
    rest = [table.get(k, k) for k in rest]
    return ".".join(["layers", node] + [k for k in rest if k is not None])


def _leaves(variables):
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
        yield keys, "/".join(keys), np.asarray(leaf)


def _strip(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _out_entry(entries, shape):
    """A flax layout's split on output dims ``shape`` as the entry of the
    flattened torch dim: the axis, or Blocks over the dims before it."""
    for j, e in enumerate(entries):
        if e is not None:
            n = math.prod(shape[:j])
            return e if n == 1 else Blocks(e, n)
    return None


def _torch_spec(jspec, keys, shape):
    """The JAX spec of a flax leaf moved to the port's torch layout: a
    Dense kernel ``(in, *out)`` becomes ``(prod(out), in)``, a Dense bias
    ``(*out,)`` flattens; everything else keeps its layout."""
    jspec = tuple(jspec) + (None,) * (len(shape) - len(jspec))
    dense = (keys[-1] in ("kernel", "bias") and "moe" not in keys
             and "Conv_0" not in keys and "ln" not in keys[-2]
             and "LayerNorm" not in keys[-2])
    if dense and keys[-1] == "kernel":
        return _strip((_out_entry(jspec[1:], shape[1:]), jspec[0]))
    if dense:
        return _strip((_out_entry(jspec, shape),))
    return _strip(jspec)


def _unshard(x):
    """The logical tensor of a ``Shards``, assembled from its pieces by
    their index (a Blocks dim piece holds its slice of every block)."""
    spec = list(x.sharding.spec) + [None] * (len(x.shape)
                                              - len(x.sharding.spec))
    out = torch.empty(x.shape, dtype=x[0].dtype)
    for piece, idx in zip(x, x.index):
        views = [(out, piece)]
        for dim, (s, e) in enumerate(zip(idx, spec)):
            nxt = []
            for dst, src in views:
                w = s.stop - s.start
                if isinstance(e, Blocks):
                    bsize = dst.shape[dim] // e.n
                    nxt += [(dst.narrow(dim, b * bsize + s.start, w),
                             src.narrow(dim, b * w, w)) for b in range(e.n)]
                else:
                    nxt.append((dst.narrow(dim, s.start, w), src))
            views = nxt
        for dst, src in views:
            dst.copy_(src)
    return out


def test_specs_match_jax_for_every_leaf():
    """GQA LM, MHA MoE LM, ViT: the port's rule on the torch name equals
    the JAX rule on the flax path, translated to the torch layout; some
    leaves of each split."""
    for name, variables, to_port, conv, jrules, trules in _models():
        sd = conv(variables)
        split = 0
        for keys, path, leaf in _leaves(variables):
            port = to_port(keys)
            assert port in sd, (name, path, port)
            want = _torch_spec(jrules(path, leaf.ndim), keys, leaf.shape)
            got = _strip(trules(port, sd[port].ndim))
            assert got == want, (name, path, got, want)
            split += bool(want)
        assert split >= 6, name
    # The renamed axis lands in Blocks entries too.
    assert TS.lm_tp_rules("decoder_block_3.attn.kv.weight", 2, "mp") == P(
        Blocks("mp", 2), None)
    assert TS.lm_tp_rules("decoder_block_0.attn.kv.weight", 1) == P()


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_equal_converted_jax_addressable_shards(sim_mesh, tp):
    """``shard_state_dict`` of the converted weights: piece ``i`` of every
    tensor equals ``from_flax`` of the JAX leaves' ``addressable_shards``
    on device ``i`` — so a sharded JAX checkpoint carries across shard by
    shard."""
    mesh = sim_mesh(tp)
    devs = list(mesh.devices.flat)
    for name, variables, to_port, conv, jrules, trules in _models():
        placed = jax.device_put(variables, JS.tree_shardings(
            variables, mesh, rules=jrules))
        ours = shard_state_dict(conv(variables), _mesh(tp), trules)
        for i, dev in enumerate(devs):
            piece = jax.tree.map(
                lambda x: np.asarray(next(s.data for s in x.addressable_shards
                                          if s.device == dev)), placed)
            want = conv(piece)
            assert set(want) == set(ours)
            for k, t in want.items():
                assert torch.equal(ours[k][i], t), (name, tp, i, k)
                assert ours[k][i].is_contiguous()
        # The pieces reassemble to the whole tensor.
        full = conv(variables)
        for k, x in ours.items():
            assert torch.equal(_unshard(x), full[k]), (name, k)


def test_merge_specs_matches_jax_and_raises_on_conflict():
    jP = jax.sharding.PartitionSpec
    for a, b in ((("ep", None, None), (None, None, "tp")),
                 (("ep",), (None, "tp")), ((None, "tp"), (None, "tp"))):
        got = TS.merge_specs(P(*a), P(*b))
        assert tuple(got) == tuple(JS.merge_specs(jP(*a), jP(*b)))
    with pytest.raises(ValueError, match="conflict") as pe:
        TS.merge_specs(P("ep", None), P("tp", None))
    with pytest.raises(ValueError, match="conflict") as je:
        JS.merge_specs(jP("ep", None), jP("tp", None))
    assert str(pe.value).split(":")[0] == str(je.value).split(":")[0]


def test_build_mesh_shapes_repeats_and_the_card():
    m = build_mesh(MeshSpec((("dp", 2), ("tp", 2))), ["cpu"] * 4)
    assert dict(m.shape) == {"dp": 2, "tp": 2}
    assert list(m.shape) == ["dp", "tp"] and m.devices.shape == (2, 2)
    assert m.axis_positions("tp") == [0, 1]
    assert m.axis_positions("dp") == [0, 2]
    assert m.along("tp").axis_names == ("tp",)
    with pytest.raises(ValueError, match="needs 4 devices"):
        build_mesh(MeshSpec((("tp", 4),)), ["cpu"] * 2)
    with pytest.raises(ValueError, match="no 'pp' axis"):
        m.axis_devices("pp")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_mesh(MeshSpec((("tp", 2),)))


def test_reduce_shards_fixed_order_one_sum_a_device():
    rng = np.random.RandomState(0)
    parts = [torch.from_numpy(rng.randn(3, 5).astype(np.float32))
             for _ in range(4)]
    out = TS.reduce_shards(parts)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert len(out) == 4 and all(o is out[0] for o in out)
    assert torch.equal(out[0], want)


def _pool(rng, pages=5, kvh=4, page=8, w=6):
    return torch.from_numpy(rng.randn(pages, kvh, page, w).astype(np.float32))


@pytest.mark.parametrize("tp", [2, 4])
def test_fetch_head_shards_equals_jax_and_the_page(sim_mesh, tp):
    """The spill read: per-shard heads assembled on the host equal the
    logical page and the JAX function on the same pool."""
    rng = np.random.RandomState(1)
    x = _pool(rng)
    ours = TS.kv_head_sharding(_mesh(tp)).shard(x)
    assert [p.shape[1] for p in ours] == [4 // tp] * tp
    jx = jax.device_put(x.numpy(), JS.kv_head_sharding(sim_mesh(tp)))
    for page in (0, 3):
        got = TS.fetch_head_shards(ours, page)
        assert torch.equal(got, x[page])
        np.testing.assert_array_equal(got.numpy(),
                                      JS.fetch_head_shards(jx, page))
    # A replicated pool (every shard whole) reads one copy.
    whole = TS.Sharding(_mesh(tp), P()).shard(x)
    assert torch.equal(TS.fetch_head_shards(whole, 2), x[2])
    assert torch.equal(TS.fetch_head_shards(x, 2), x[2])


def test_fetch_head_shards_moves_a_list_of_leaves_in_one_copy(monkeypatch):
    """A list of leaves (a page's K / V of every block, a quantized
    pair's two members) comes back as a list, every shard's piece of every
    leaf in ONE ``host_copy``."""
    rng = np.random.RandomState(4)
    xs = [_pool(rng), _pool(rng, w=1), _pool(rng)]
    sharding = TS.kv_head_sharding(_mesh(2))
    leaves = [sharding.shard(xs[0]), sharding.shard(xs[1]), xs[2]]
    seen = []
    real = TS.host_copy
    monkeypatch.setattr(TS, "host_copy",
                        lambda ts: seen.append(len(ts)) or real(ts))
    got = TS.fetch_head_shards(leaves, 3)
    assert seen == [5] and isinstance(got, list) and len(got) == 3
    for g, x in zip(got, xs):
        assert torch.equal(g, x[3])


def test_fetch_head_shards_raises_on_misaligned_or_uncovered_heads():
    rng = np.random.RandomState(2)
    x = _pool(rng)
    full = (slice(0, 5), None, slice(0, 8), slice(0, 6))

    def shards(*spans):
        idx = [tuple(slice(*s) if i == 1 else full[i] for i, s in
                     enumerate([None, sp, None, None])) for sp in spans]
        return Shards([x[:, lo:hi] for lo, hi in spans], None, x.shape, idx)

    with pytest.raises(ValueError, match="misaligned"):
        TS.fetch_head_shards(shards((0, 2), (3, 4)), 0)
    with pytest.raises(ValueError, match="not covered"):
        TS.fetch_head_shards(shards((0, 2)), 0)
    with pytest.raises(ValueError, match="overlap"):
        TS.fetch_head_shards(shards((0, 2), (1, 4)), 0)
    assert torch.equal(TS.fetch_head_shards(shards((0, 2), (2, 4)), 1), x[1])


@pytest.mark.parametrize("tp", [2, 4])
def test_kv_handoff_plan_places_per_shard_slices(sim_mesh, tp):
    """The landing: each shard receives only its heads, equal to the JAX
    plan's per-device pieces, every slice of every leaf staged by ONE call
    of the caller's staging; a quantized pair places under one plan; no
    sharding is one placement."""
    rng = np.random.RandomState(3)
    host = _pool(rng, pages=3)
    plan = TS.plan_kv_handoff(TS.kv_head_sharding(_mesh(tp)))
    calls = []

    def stage(xs):
        calls.append(len(xs))
        return [x.clone() for x in xs]

    (ours,) = plan.place([host], stage)
    jplan = JS.plan_kv_handoff(JS.kv_head_sharding(sim_mesh(tp)))
    theirs = jplan.place(host.numpy())
    w = 4 // tp
    for i, (p, s) in enumerate(zip(ours, sorted(
            theirs.addressable_shards, key=lambda s: s.device.id))):
        assert torch.equal(p, host[:, i * w:(i + 1) * w])
        np.testing.assert_array_equal(p.numpy(), np.asarray(s.data))
    assert plan.staged_bytes == jplan.staged_bytes == host.numel() * 4
    vals = torch.randint(-127, 127, (3, 4, 8, 6), dtype=torch.int8)
    scales = torch.rand(3, 4, 8, 1)
    qv, qs = plan.place([vals, scales], stage)
    assert calls == [tp, 2 * tp]
    assert [p.shape for p in qs] == [(3, w, 8, 1)] * tp
    assert torch.equal(_unshard(qv), vals)
    assert TS.plan_kv_handoff(None).place([host], list)[0] is host


def test_head_tiles_and_kv_head_sharding_agree():
    for kvh, tp in ((12, 2), (12, 4), (4, 4), (6, 3)):
        tiles = TS.head_tiles(kvh, tp)
        assert tiles == JS.head_tiles(kvh, tp)
        idx = TS.kv_head_sharding(_mesh(tp)).index((2, kvh, 8, 4))
        assert [(i[1].start, i[1].stop) for i in idx] == tiles
    with pytest.raises(ValueError, match="evenly cover"):
        TS.head_tiles(6, 4)


def test_batch_replicate_and_tree_shardings():
    mesh = _mesh(2, "dp")
    x = torch.arange(12.0).reshape(4, 3)
    b = TS.shard_batch(x, mesh)
    assert torch.equal(b[0], x[:2]) and torch.equal(b[1], x[2:])
    r = TS.replicate({"a": x, "b": [x]}, mesh)
    assert all(p is x for p in r["a"]) and len(r["b"][0]) == 2
    sh = TS.tree_shardings({"decoder_block_0": {"mlp_in": {"weight": x}}},
                           _mesh(2), rules=TS.lm_tp_rules)
    assert sh["decoder_block_0.mlp_in.weight"].spec == P("tp", None)


# -- expert parallelism ---------------------------------------------------------


def test_expert_placement_and_utilization_match_jax(sim_mesh):
    """``expert_shardings`` / ``place_experts`` over an 8-way ``ep`` mesh:
    the expert stacks split on their leading axis (the gate replicated),
    the pieces equal the JAX placement's; the stacks' specs compose with
    ``lm_tp_rules``' hidden split; ``expert_utilization`` equals JAX's."""
    variables = _models()[1][1]
    sd = from_flax(variables)
    mesh = sim_mesh(8, axis="ep")
    jspecs = {p: s.spec for p, s in zip(
        (path for _, path, _ in _leaves(variables)),
        jax.tree.leaves(JE.expert_shardings(variables, mesh, num_experts=8),
                        is_leaf=lambda s: hasattr(s, "spec")))}
    ours = TE.expert_shardings(sd, _mesh(8, "ep"), num_experts=8)
    split = 0
    for keys, path, leaf in _leaves(variables):
        want = _torch_spec(jspecs[path], keys, leaf.shape)
        assert _strip(ours[_lm_name(keys)].spec) == want, path
        split += bool(want)
    assert split == 8  # w1, b1, w2, b2 of both blocks; gates replicated
    placed = TE.place_experts(sd, _mesh(8, "ep"), num_experts=8)
    jplaced = JE.place_experts(variables, mesh, num_experts=8)
    devs = list(mesh.devices.flat)
    for i, dev in enumerate(devs):
        piece = jax.tree.map(
            lambda x: np.asarray(next(s.data for s in x.addressable_shards
                                      if s.device == dev)), jplaced)
        want = from_flax(piece)
        for k, t in want.items():
            assert torch.equal(placed[k][i], t), (i, k)
    w1 = ours["decoder_block_0.moe.w1"].spec
    assert TS.merge_specs(w1, TS.lm_tp_rules("decoder_block_0.moe.w1", 3)
                          ) == P("ep", None, "tp")
    gates = np.random.RandomState(4).rand(64, 8).astype(np.float32)
    np.testing.assert_array_equal(TE.expert_utilization(gates),
                                  JE.expert_utilization(jnp.asarray(gates)))
    assert abs(TE.expert_utilization(torch.from_numpy(gates)).sum() - 1) < 1e-6


def test_shard_lm_validate_tp_messages_match_jax():
    T = importlib.import_module("adapt_tpu_torch.models.transformer_lm")
    for args, kw, tp in (((37, 32, 1, 4, 64), dict(kv_heads=2), 4),
                         ((37, 36, 1, 6, 64), {}, 4),
                         ((37, 36, 1, 4, 66), {}, 4)):
        j = J.transformer_lm(*args, max_len=16, **kw)
        t = T.transformer_lm(*args, max_len=16, device="cpu", **kw)
        with pytest.raises(ValueError) as je:
            J.validate_tp(j, tp)
        with pytest.raises(ValueError) as pe:
            T.shard_lm(t, _mesh(tp))
        assert str(pe.value) == str(je.value)


def test_sharded_lm_and_batcher_refuse_distinct_devices():
    """Shards run on one device: a tp axis naming two devices is refused
    by ``shard_lm`` and by the batcher (through it)."""
    from adapt_tpu_torch.core.mesh import Mesh
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

    T = importlib.import_module("adapt_tpu_torch.models.transformer_lm")
    lm = T.transformer_lm(37, 32, 1, 4, 64, max_len=16, device="cpu")
    devs = np.empty(2, dtype=object)
    devs[:] = [torch.device("cpu"), torch.device("meta")]
    mesh = Mesh(devs, ("tp",))
    with pytest.raises(ValueError, match="distinct devices"):
        T.shard_lm(lm, mesh)
    with pytest.raises(ValueError, match="distinct devices"):
        ContinuousBatcher(lm, slots=2, mesh=mesh)


def test_vit_blocks_unshard_round_trip():
    """A fused-qkv Blocks cut reassembles exactly; each piece holds its
    q, k and v rows in order."""
    sd = vit_from_flax(_models()[2][1])
    name = "layers.encoder_block_1.attn.qkv.weight"
    x = TS.Sharding(_mesh(4), TS.vit_tp_rules(name, 2)).shard(sd[name])
    assert torch.equal(_unshard(x), sd[name])
    rows = sd[name].shape[0] // 3
    w = rows // 4
    for i, p in enumerate(x):
        for b in range(3):
            assert torch.equal(p[b * w:(b + 1) * w],
                               sd[name][b * rows + i * w:b * rows
                                        + (i + 1) * w])

