"""The port's ViT and LayerGraph against the JAX package.

The same flax variables (initialised by the JAX package from a seed) load
into the port through ``convert.vit_from_flax``; the same numpy images go
through both. On the CPU the port's attention runs the plain versions of
K1 and K7. f32 forwards agree to ``atol = rtol = 1e-5`` and every
parameter's gradient of the mean cross-entropy to ``1e-4`` of that
gradient's largest magnitude (the same f32 function, summed in another
order). A bf16 forward
is held at ``5e-2`` relative to the largest logit (bf16 rounds at other
places in the two frameworks)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adapt_tpu_torch.convert import vit_from_flax
from adapt_tpu_torch.graph.ir import INPUT, Lambda, LayerGraph
from adapt_tpu_torch.models import vit as TV

JV = importlib.import_module("adapt_tpu.models.vit")

#: name: (JAX graph factory, port graph factory, image size)
MODELS = {
    "vit_tiny": (lambda dt: JV.vit_tiny(dtype=dt),
                 lambda dt: TV.vit_tiny(dtype=dt, device="cpu"), 32),
    # two blocks at the ViT-B head_dim of 64
    "vit_2block_hd64": (
        lambda dt: JV.vit(8, 128, 2, 2, 256, 10, dt, name="vit_hd64"),
        lambda dt: TV.vit(8, 128, 2, 2, 256, 10, dt, name="vit_hd64",
                          img_size=32, device="cpu"), 32),
}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, dtype=torch.float32, seed=0):
    """(JAX graph, its variables as numpy, port graph with them loaded,
    images, labels)."""
    jfac, tfac, img = MODELS[name]
    rng = np.random.RandomState(seed)
    x = rng.randn(4, img, img, 3).astype(np.float32)
    y = rng.randint(0, 10, size=4)
    jg = jfac(JDT[dtype])
    var = jax.device_get(jax.jit(jg.init)(jax.random.PRNGKey(seed),
                                          jnp.asarray(x[:1])))
    tg = tfac(dtype)
    tg.load_state_dict(vit_from_flax(var))
    return jg, var, tg, x, y


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_jax(name):
    jg, var, tg, x, _ = _pair(name)
    want = np.asarray(jax.jit(jg.apply)(var, jnp.asarray(x)))
    with torch.no_grad():
        got = tg.apply(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_every_gradient_matches_jax_grad(name):
    jg, var, tg, x, y = _pair(name, seed=1)

    def loss(v):
        logits = jg.apply(v, jnp.asarray(x))
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)))

    want = vit_from_flax(jax.device_get(jax.jit(jax.grad(loss))(var)))
    logits = tg(torch.from_numpy(x))
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(y)).backward()
    names = [n for n, _ in tg.named_parameters()]
    assert sorted(names) == sorted(want)
    for n, p in tg.named_parameters():
        err = float((p.grad - want[n]).abs().max())
        assert err <= 1e-4 * float(want[n].abs().max()), (n, err)


def test_bf16_forward_matches_jax():
    jg, var, tg, x, _ = _pair("vit_2block_hd64", torch.bfloat16, seed=2)
    want = np.asarray(jax.jit(jg.apply)(var, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = tg(torch.from_numpy(x))
    assert got.dtype == torch.float32  # the classifier runs in f32
    assert all(p.dtype == torch.float32 for p in tg.parameters())
    err = np.abs(got.numpy() - want).max()
    assert err <= 5e-2 * np.abs(want).max(), err


def test_graph_structure_and_cuts_match_jax():
    jg = JV.vit_tiny()
    tg = TV.vit_tiny(device="cpu")
    assert tg.topo_order() == jg.topo_order()
    assert tg.output == jg.output == "head"
    for n in tg.topo_order():
        assert tg.node(n).inputs == jg.node(n).inputs
        assert tg.consumers(n) == jg.consumers(n)
    for depth, stages in ((12, 1), (12, 2), (12, 4), (12, 5), (12, 12),
                          (4, 3), (7, 4)):
        assert TV.vit_block_cuts(depth, stages) == JV.vit_block_cuts(
            depth, stages)
    with pytest.raises(ValueError, match="cannot split"):
        TV.vit_block_cuts(4, 5)


def test_layer_graph_order_duplicates_and_subsets():
    g = LayerGraph("toy")
    g.add("a", torch.nn.Linear(3, 3))
    g.add("b", Lambda(torch.relu, "relu"), "a")
    g.add("c", Lambda(lambda u, v: u + v, "add"), ("a", "b"))
    with pytest.raises(ValueError, match="duplicate"):
        g.add("a", Lambda(torch.relu))
    with pytest.raises(ValueError, match="duplicate"):
        g.add(INPUT, Lambda(torch.relu))
    with pytest.raises(ValueError, match="topological order"):
        g.add("d", Lambda(torch.relu), "missing")
    with pytest.raises(ValueError, match="unknown layer"):
        g.set_output("missing")
    with pytest.raises(KeyError, match="no layer"):
        g.node("missing")
    assert g.topo_order() == ["a", "b", "c"] and g.output == "c"
    assert g.consumers("a") == ["b", "c"]
    assert [n for n, _ in g.named_parameters()] == ["layers.a.weight",
                                                    "layers.a.bias"]
    x = torch.randn(2, 3)
    with torch.no_grad():
        a = g.layers["a"](x)
        assert torch.equal(g.apply(x), a + torch.relu(a))
        assert torch.equal(g.apply_subset(["b", "c"], {"a": a}), g(x))
        g.set_output("b")
        assert torch.equal(g.apply(x), torch.relu(a))
    with pytest.raises(ValueError, match="empty graph"):
        LayerGraph("empty").output


def test_entry_points_take_device_and_seed():
    a = TV.vit_tiny(device="cpu", seed=3)
    b = TV.vit_tiny(device="cpu", seed=3)
    c = TV.vit_tiny(device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layers.head.fc.weight"],
                           sc["layers.head.fc.weight"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TV.vit_tiny()
