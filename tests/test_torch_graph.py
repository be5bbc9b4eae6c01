"""The port's graph layer (``graph.partition``, ``graph.spec``,
``LayerGraph.eval_shapes``) on the CPU, against the JAX package.

- The partitioner's own rules, as ``tests/test_graph.py`` states them for
  the JAX package: cut validation (invalid, unknown, out-of-order, output
  and input fan-out cuts), coverage, ``balanced_cuts`` (partial costs, too
  many stages) and ``compose == apply`` bit for bit (``torch.equal``), on a
  residual MLP with add joins.
- On the model zoo (ResNet-50 with either stem, EfficientNet-B0 / B4,
  ViT): the same valid cut points, balanced cuts and stage node lists as
  the JAX package's graphs, and ``eval_shapes`` equal to JAX's node for
  node (shape and dtype), with no weight touched.
- Specs: a JSON round trip rebuilds ``vit_tiny``, a bf16 s2d ResNet-50 and
  EfficientNet-B0 whose outputs equal the originals' bit for bit; foreign
  roots (``adapt_tpu_torchx.``, ``os.``), unknown merge ops and non-module
  objects are refused.
"""

import importlib
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.graph.ir import INPUT, Lambda, LayerGraph, rebuild
from adapt_tpu_torch.graph.partition import (
    InvalidCutError,
    balanced_cuts,
    partition,
    valid_cut_points,
)
from adapt_tpu_torch.graph.spec import (
    graph_from_spec,
    graph_to_spec,
    registered_lambda,
)
from adapt_tpu_torch.models import efficientnet as TE
from adapt_tpu_torch.models import resnet as TR
from adapt_tpu_torch.models import vit as TV
from adapt_tpu_torch.models.layers import ConvBN, Dense, init_weights

JG = importlib.import_module("adapt_tpu.graph.partition")
JE = importlib.import_module("adapt_tpu.models.efficientnet")
JR = importlib.import_module("adapt_tpu.models.resnet")
JV = importlib.import_module("adapt_tpu.models.vit")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def residual_mlp_graph(width=16, blocks=3):
    """A small DAG with residual joins (ResNet-style add joins)."""
    g = LayerGraph("res_mlp")
    g.add("embed", Dense(8, width, device="cpu"), INPUT)
    prev = "embed"
    for i in range(blocks):
        branch = g.add(f"block{i}_branch", Dense(width, width, device="cpu"),
                       prev)
        prev = g.add(f"block{i}_out", registered_lambda("add_relu"),
                     (prev, branch))
    g.add("head", Dense(width, 4, device="cpu"), prev)
    return init_weights(g, 0)


@pytest.fixture(scope="module")
def graph_and_x():
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8).astype(
        np.float32))
    return residual_mlp_graph(), x


def test_full_apply_and_eval_shapes(graph_and_x):
    g, x = graph_and_x
    assert g.apply(x).shape == (2, 4)
    shapes = g.eval_shapes(x)
    assert shapes["head"].shape == (2, 4) and shapes["head"].is_meta
    assert shapes["block1_out"].shape == (2, 16)


def test_topological_add_and_duplicates_enforced():
    g = LayerGraph("bad")
    with pytest.raises(ValueError, match="unknown layer"):
        g.add("a", Dense(3, 3, device="cpu"), "missing")
    g.add("a", Dense(3, 3, device="cpu"), INPUT)
    with pytest.raises(ValueError, match="duplicate"):
        g.add("a", Dense(3, 3, device="cpu"), INPUT)


def test_valid_cut_points(graph_and_x):
    g, _ = graph_and_x
    cuts = valid_cut_points(g)
    assert "embed" in cuts
    for i in range(3):
        assert f"block{i}_out" in cuts
        assert f"block{i}_branch" not in cuts


@pytest.mark.parametrize("cuts", [["block0_out"], ["embed", "block1_out"],
                                  ["block0_out", "block1_out", "block2_out"]])
def test_composed_stages_match_full_model(graph_and_x, cuts):
    g, x = graph_and_x
    plan = partition(g, cuts)
    assert plan.num_stages == len(cuts) + 1 and plan.cuts == tuple(cuts)
    with torch.no_grad():
        assert torch.equal(plan.compose(plan.extract_variables(), x),
                           g.apply(x))


def test_stage_coverage_disjoint_and_total(graph_and_x):
    g, _ = graph_and_x
    plan = partition(g, ["block0_out", "block2_out"])
    all_nodes = [n for s in plan.stages for n in s.node_names]
    assert sorted(all_nodes) == sorted(g.topo_order())
    assert len(all_nodes) == len(set(all_nodes))


@pytest.mark.parametrize("cuts,match", [
    (["block1_branch"], "skip connection"),
    (["nope"], "unknown cut"),
    (["block1_out", "block0_out"], None),  # out of order
    (["head"], "graph output"),
    (["embed", "embed"], "duplicate"),
])
def test_bad_cuts_rejected(graph_and_x, cuts, match):
    g, _ = graph_and_x
    with pytest.raises(InvalidCutError, match=match):
        partition(g, cuts)


def test_input_fanout_not_a_valid_cut():
    g = LayerGraph("fan")
    g.add("a", Dense(4, 4, device="cpu"), INPUT)
    g.add("b", Dense(4, 4, device="cpu"), INPUT)
    g.add("c", registered_lambda("add"), ("a", "b"))
    g.add("d", Dense(4, 2, device="cpu"), "c")
    assert valid_cut_points(g) == ["c"]
    with pytest.raises(InvalidCutError):
        partition(g, ["a"])


def test_balanced_cuts(graph_and_x):
    g, x = graph_and_x
    cuts = balanced_cuts(g, 3)
    assert len(cuts) == 2
    plan = partition(g, cuts)
    with torch.no_grad():
        assert torch.equal(plan.compose(plan.extract_variables(), x),
                           g.apply(x))
    costs = {n: 1.0 for n in g.topo_order() if "branch" in n}  # no merges
    assert len(balanced_cuts(g, 2, costs=costs)) == 1
    with pytest.raises(InvalidCutError):
        balanced_cuts(g, 20)
    assert balanced_cuts(g, 1) == []


def test_compose_length_mismatch(graph_and_x):
    g, x = graph_and_x
    plan = partition(g, ["block1_out"])
    with pytest.raises(ValueError, match="stale plan"):
        plan.compose(plan.extract_variables()[:1], x)


def test_stage_apply_is_pure_across_threads(graph_and_x):
    """``stage_apply`` shares no module between calls: eight threads
    running one stage function on different inputs each get their own
    input's output (a shared module with swapped-in weights would race)."""
    g, _ = graph_and_x
    plan = partition(g, ["block1_out"])
    svars = plan.extract_variables()
    fn = plan.stage_apply(plan.stages[0])
    xs = [torch.full((2, 8), float(i)) for i in range(8)]
    with torch.no_grad():
        want = [fn(svars[0], x) for x in xs]
    got = [None] * len(xs)

    def run(i):
        with torch.no_grad():
            for _ in range(20):
                got[i] = fn(svars[0], xs[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_extract_variables_carries_buffers_on_the_cpu():
    g = TR.resnet50(10, device="cpu")
    plan = partition(g, TR.RESNET50_3STAGE_CUTS)
    stem = plan.extract_variables()[0]["stem"]
    assert {"conv.mean", "conv.var", "conv.weight"} <= set(stem)
    assert all(t.device.type == "cpu" for t in stem.values())


# -- the model zoo against the JAX package's graphs --------------------------

#: name: (JAX graph, port graph factory, NHWC input shape)
ZOO = {
    "resnet50": (lambda: JR.resnet50(10),
                 lambda: TR.resnet50(10, device="cpu"), (2, 33, 33, 3)),
    "resnet50_s2d": (lambda: JR.resnet50(10, stem="s2d"),
                     lambda: TR.resnet50(10, stem="s2d", device="cpu"),
                     (2, 64, 64, 3)),
    "efficientnet_b0_bf16": (
        lambda: JE.efficientnet_b0(10, dtype=jnp.bfloat16),
        lambda: TE.efficientnet_b0(10, torch.bfloat16, device="cpu"),
        (2, 64, 64, 3)),
    "efficientnet_b4": (lambda: JE.efficientnet_b4(10),
                        lambda: TE.efficientnet_b4(10, device="cpu"),
                        (1, 48, 48, 3)),
    "vit_tiny": (lambda: JV.vit_tiny(), lambda: TV.vit_tiny(device="cpu"),
                 (2, 32, 32, 3)),
}


@pytest.mark.parametrize("name", list(ZOO))
def test_cut_points_and_plans_equal_jax(name):
    jfac, tfac, _ = ZOO[name]
    jg, tg = jfac(), tfac()
    assert tg.topo_order() == jg.topo_order()
    assert {n: tg.node(n).inputs for n in tg.topo_order()} == {
        n: jg.node(n).inputs for n in jg.topo_order()}
    assert valid_cut_points(tg) == JG.valid_cut_points(jg)
    for k in (2, 3, 5):
        cuts = balanced_cuts(tg, k)
        assert cuts == JG.balanced_cuts(jg, k)
        tp, jp = partition(tg, cuts), JG.partition(jg, cuts)
        assert [s.node_names for s in tp.stages] == [
            s.node_names for s in jp.stages]


@pytest.mark.parametrize("name", list(ZOO))
def test_eval_shapes_equal_jax(name):
    """Node for node, shape and dtype, from meta tensors (nothing runs)."""
    jfac, tfac, shape = ZOO[name]
    jg, tg = jfac(), tfac()
    xs = jax.ShapeDtypeStruct(shape, jnp.float32)
    abstract = jax.eval_shape(jg.init, jax.random.PRNGKey(0), xs)
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), abstract)
    want = jg.eval_shapes(variables, xs)
    got = tg.eval_shapes(torch.empty(shape, device="meta"))
    assert list(got) == list(want)
    for n, t in got.items():
        assert t.is_meta
        assert tuple(t.shape) == tuple(want[n].shape), n
        assert str(t.dtype).removeprefix("torch.") == want[n].dtype.name, n


# -- architecture by value ---------------------------------------------------


def _roundtrip(graph, x):
    spec = json.loads(json.dumps(graph_to_spec(graph)))  # the wire trip
    rebuilt = graph_from_spec(spec, device="cpu")
    assert rebuilt.topo_order() == graph.topo_order()
    assert rebuilt.output == graph.output
    rebuilt.load_state_dict(graph.state_dict())
    with torch.no_grad():
        assert torch.equal(rebuilt.apply(x), graph.apply(x))
    return spec


def test_spec_roundtrip_vit_tiny():
    _roundtrip(TV.vit_tiny(device="cpu"), torch.ones(1, 32, 32, 3))


def test_spec_roundtrip_resnet50_s2d_bf16():
    spec = _roundtrip(
        TR.resnet50(10, dtype=torch.bfloat16, stem="s2d", device="cpu"),
        torch.ones(1, 64, 64, 3))
    stem = spec["nodes"][0]["module"]
    assert stem["type"] == "adapt_tpu_torch.models.layers.SpaceToDepthStem"
    assert stem["config"] == {"dtype": {"__dtype__": "bfloat16"}}


def test_spec_roundtrip_efficientnet_b0():
    spec = _roundtrip(TE.efficientnet_b0(10, device="cpu"),
                      torch.ones(1, 64, 64, 3))
    kinds = {n["module"].get("name") for n in spec["nodes"]}
    assert "add" in kinds  # the identity-residual joins ship by name


def _one_node_spec(module_spec):
    return {"name": "g", "output": "a",
            "nodes": [{"name": "a", "inputs": [INPUT],
                       "module": module_spec}]}


@pytest.mark.parametrize("path", [
    "adapt_tpu_torchx.layers.Dense",   # a sibling of an allowed root
    "os.system",
    "torch.nnx.Linear",
    "adapt_tpu.models.layers.ConvBN",  # the JAX package is not a root
])
def test_spec_refuses_foreign_roots(path):
    with pytest.raises(ValueError, match="refusing to import"):
        graph_from_spec(_one_node_spec(
            {"kind": "module", "type": path, "config": {}}), device="cpu")


def test_spec_refuses_non_modules_and_unknown_ops():
    with pytest.raises(ValueError, match="not an nn.Module class"):
        graph_from_spec(_one_node_spec(
            {"kind": "module", "type": "adapt_tpu_torch.models.resnet.resnet50",
             "config": {}}), device="cpu")
    with pytest.raises(ValueError, match="unknown Lambda"):
        graph_from_spec(_one_node_spec({"kind": "lambda", "name": "evil"}),
                        device="cpu")
    g = LayerGraph("custom")
    g.add("a", Lambda(lambda x: x + 1, "add"), INPUT)  # not the registry's
    with pytest.raises(TypeError, match="LAMBDA_REGISTRY"):
        graph_to_spec(g)
    g = LayerGraph("plain")
    g.add("a", torch.nn.Linear(2, 2), INPUT)
    with pytest.raises(TypeError, match="NodeModule"):
        graph_to_spec(g)
    with pytest.raises(TypeError, match="NodeModule"):
        rebuild(g.node("a").module, "meta")
    # torch.nn is a root: a spec may name its classes.
    ok = graph_from_spec(_one_node_spec(
        {"kind": "module", "type": "torch.nn.modules.activation.ReLU",
         "config": {}}), device="cpu")
    assert torch.equal(ok.apply(torch.tensor([-1.0, 2.0])),
                       torch.tensor([0.0, 2.0]))


def test_node_modules_record_their_arguments():
    m = ConvBN(8, 16, 5, strides=2, groups=8, act="silu", device="cpu")
    assert m.spec_args == {"in_features": 8, "features": 16, "kernel": 5,
                           "strides": 2, "groups": 8, "act": "silu",
                           "dtype": torch.float32}
    twin = rebuild(m, "meta")
    assert type(twin) is ConvBN and twin.weight.is_meta
    assert twin.weight.shape == m.weight.shape == (16, 1, 5, 5)
