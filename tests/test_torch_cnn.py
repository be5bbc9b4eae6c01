"""The port's CNN zoo (``models/layers.py``, ``resnet.py``,
``efficientnet.py``) against the JAX package, on the CPU.

The same flax variables go into both packages: their structure from the
JAX graph's ``init`` (abstractly, ``jax.eval_shape``), their values from a
seeded numpy generator, loaded into the port through
``convert.cnn_from_flax``. BatchNorm is not left at its init (mean 0, var
1, scale 1, bias 0, where a swapped mean and variance or a wrong epsilon
would pass): every running mean and BN bias is drawn from U(-0.5, 0.5),
every running variance and BN scale from U(0.5, 2); conv kernels are
N(0, 1/fan_in) and the SE and classifier biases U(-0.5, 0.5).

The same numpy images (NHWC) go through both. Each node's output (the
activations at the 3-stage cuts among them) and the logits are held to
the JAX package's, with no transpose, at ``1e-4`` of the reference
tensor's largest magnitude in f32, and at ``5e-2`` of it in bf16 (both
frameworks round to bf16 after each layer, at places that differ). Image
sizes 64 and 33 give even and odd spatial sizes, so flax's asymmetric
``"SAME"`` pads (the 7x7/2 stem conv, the 3x3/2 max-pool with ``-inf``,
the 4x4 s2d conv, the 5x5/2 depthwise convs) are exercised both ways.
Partitioned runs (``compose`` over the extracted stage states) equal
``graph.apply`` bit for bit; ``save_variables`` / ``restore_variables``
round-trip a model exactly."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.convert import cnn_from_flax
from adapt_tpu_torch.graph.ir import INPUT
from adapt_tpu_torch.graph.partition import balanced_cuts, partition
from adapt_tpu_torch.models import efficientnet as TE
from adapt_tpu_torch.models import resnet as TR
from adapt_tpu_torch.models.layers import ConvBN, same_pads
from adapt_tpu_torch.utils.checkpoint import (
    restore_variables,
    save_variables,
)

JE = importlib.import_module("adapt_tpu.models.efficientnet")
JR = importlib.import_module("adapt_tpu.models.resnet")

F32_TOL, BF16_TOL = 1e-4, 5e-2

#: name: (JAX graph factory, port graph factory, 3-stage cuts or None for
#: balanced_cuts); factories take the dtype pair.
MODELS = {
    "resnet50_conv7": (
        lambda dt: JR.resnet50(10, dtype=dt),
        lambda dt: TR.resnet50(10, dtype=dt, device="cpu"),
        TR.RESNET50_3STAGE_CUTS),
    "resnet50_s2d": (
        lambda dt: JR.resnet50(10, dtype=dt, stem="s2d"),
        lambda dt: TR.resnet50(10, dtype=dt, stem="s2d", device="cpu"),
        TR.RESNET50_3STAGE_CUTS),
    "efficientnet_b0": (
        lambda dt: JE.efficientnet_b0(10, dtype=dt),
        lambda dt: TE.efficientnet_b0(10, dt, device="cpu"), None),
    "efficientnet_b4": (
        lambda dt: JE.efficientnet_b4(10, dtype=dt),
        lambda dt: TE.efficientnet_b4(10, dt, device="cpu"), None),
}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def flax_variables(jg, shape, seed):
    """Variables of ``jg``'s structure with seeded values (see the module
    docstring)."""
    rng = np.random.default_rng(seed)
    abstract = jax.eval_shape(jg.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct(shape, jnp.float32))

    def fill(path, s):
        keys = [p.key for p in path]
        leaf, parent = keys[-1], keys[-2]
        if leaf == "kernel":  # HWIO conv or (in, out) Dense
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if parent.startswith("BatchNorm") and leaf in ("var", "scale"):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return rng.uniform(-0.5, 0.5, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, abstract)


def jax_node_outputs(jg, variables, x):
    """Every node's output, run eagerly node by node."""
    cache = {INPUT: jnp.asarray(x)}
    for n in jg.topo_order():
        node = jg.node(n)
        cache[n] = node.apply(variables[n], *(cache[d] for d in node.inputs))
    del cache[INPUT]
    return cache


def port_node_outputs(tg, x):
    cache = {INPUT: torch.from_numpy(x)}
    with torch.no_grad():
        for n in tg.topo_order():
            node = tg.node(n)
            cache[n] = node.apply(*(cache[d] for d in node.inputs))
    del cache[INPUT]
    return cache


def assert_close_rel(got, want, tol, what):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _pair(name, img, dtype, seed=0):
    jfac, tfac, cuts = MODELS[name]
    jg, tg = jfac(JDT[dtype]), tfac(dtype)
    x = np.random.RandomState(seed).randn(2, img, img, 3).astype(np.float32)
    variables = flax_variables(jg, x.shape, seed + 1)
    tg.load_state_dict(cnn_from_flax(variables))
    return jg, tg, variables, x, cuts


@pytest.mark.parametrize("name,img", [
    ("resnet50_conv7", 64), ("resnet50_conv7", 33), ("resnet50_s2d", 64),
    ("efficientnet_b0", 64), ("efficientnet_b0", 33),
    ("efficientnet_b4", 64),
])
def test_cnn_f32_matches_jax_node_for_node(name, img):
    jg, tg, variables, x, cuts = _pair(name, img, torch.float32)
    want = jax_node_outputs(jg, variables, x)
    got = port_node_outputs(tg, x)
    assert list(got) == list(want)
    for n in got:
        assert_close_rel(got[n], want[n], F32_TOL, f"{name}@{img} {n}")
    cuts = cuts or balanced_cuts(tg, 3)
    plan = partition(tg, cuts)
    assert plan.num_stages == 3
    with torch.no_grad():
        composed = plan.compose(plan.extract_variables(),
                                torch.from_numpy(x))
        assert torch.equal(composed, tg.apply(torch.from_numpy(x)))
    assert torch.equal(composed, got["head"])
    assert_close_rel(composed, want["head"], F32_TOL, f"{name} composed")


@pytest.mark.parametrize("name", ["resnet50_conv7", "efficientnet_b0"])
def test_cnn_bf16_matches_jax(name):
    jg, tg, variables, x, cuts = _pair(name, 64, torch.bfloat16, seed=3)
    want = jax_node_outputs(jg, variables, x)
    got = port_node_outputs(tg, x)
    cuts = cuts or balanced_cuts(tg, 3)
    for n in (*cuts, "head"):
        assert got[n].dtype == (torch.float32 if n == "head"
                                else torch.bfloat16)
        assert_close_rel(got[n], want[n], BF16_TOL, f"{name} bf16 {n}")


def test_s2d_stem_refuses_odd_sizes_like_jax():
    jg, tg, variables, _, _ = _pair("resnet50_s2d", 64, torch.float32)
    x = np.zeros((1, 33, 33, 3), np.float32)
    with pytest.raises(ValueError, match="even H/W"):
        jg.node("stem").apply(variables["stem"], jnp.asarray(x))
    with pytest.raises(ValueError, match="even H/W"):
        tg.node("stem").apply(torch.from_numpy(x))


@pytest.mark.parametrize("n,k,s,want", [
    (224, 7, 2, (2, 3)),   # the ResNet stem conv
    (112, 3, 2, (0, 1)),   # its max-pool
    (32, 5, 2, (1, 2)),    # an EfficientNet 5x5/2 depthwise on even sizes
    (33, 5, 2, (2, 2)),
    (32, 4, 1, (1, 2)),    # the s2d stem's 4x4/1 conv
    (9, 1, 2, (0, 0)),
])
def test_same_pads_follow_flax(n, k, s, want):
    assert same_pads(n, k, s) == want


def test_folded_weights_follow_every_state_change():
    """ConvBN keeps its bf16 weight and BatchNorm multiplier across no-grad
    calls; an in-place edit, a state load or a move recomputes them, and
    with autograd on they are recomputed and carry gradients."""
    gen = torch.Generator().manual_seed(6)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen)

    m = ConvBN(4, 8, (3, 3), 2, dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        m.weight.copy_(rnd(8, 4, 3, 3))
        m.var.copy_(rnd(8).abs() + 0.5)
    x = rnd(2, 9, 9, 4)

    def fresh_out():  # the same state in a module with nothing kept
        f = ConvBN(**m.spec_args, device="cpu")
        f.load_state_dict(m.state_dict())
        with torch.no_grad():
            return f(x)

    with torch.no_grad():
        y0 = m(x)
        kept = m._folded[2]
        assert torch.equal(m(x), y0) and m._folded[2] is kept
        assert torch.equal(y0, fresh_out())
        m.var.mul_(2.0)
        assert not torch.equal(m(x), y0)
        assert torch.equal(m(x), fresh_out())
        other = ConvBN(**m.spec_args, device="cpu")
        other.load_state_dict({k: rnd(*v.shape).abs() + 0.5
                               for k, v in m.state_dict().items()})
        m.load_state_dict(other.state_dict())
        assert torch.equal(m(x), other(x))
        state = {k: v.clone() for k, v in m.state_dict().items()}
        m.to_empty(device="cpu")
        assert "_folded" not in m.__dict__
        m.load_state_dict(state)
        assert torch.equal(m(x), other(x))
    m(x).float().sum().backward()
    assert m.weight.grad is not None and m.var.grad is None
    assert m.scale.grad is not None


def test_save_restore_variables_round_trip(tmp_path):
    tg = TR.resnet50(10, device="cpu", seed=4)
    plan = partition(tg, TR.RESNET50_3STAGE_CUTS)
    meta = {"model": "resnet50", "num_classes": 10,
            "cuts": list(TR.RESNET50_3STAGE_CUTS)}
    save_variables(tmp_path / "ckpt", plan.extract_variables(), meta)
    stages, got_meta = restore_variables(tmp_path / "ckpt")
    assert got_meta == meta
    fresh = TR.resnet50(10, device="cpu", seed=5)
    for stage in stages:
        for node, sd in stage.items():
            fresh.node(node).module.load_state_dict(sd)
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 33, 33, 3).astype(
        np.float32))
    with torch.no_grad():
        assert torch.equal(fresh.apply(x), tg.apply(x))
    assert all(torch.equal(a, b) for a, b in zip(
        fresh.state_dict().values(), tg.state_dict().values()))
    save_variables(tmp_path / "bare", tg.state_dict())
    sd, no_meta = restore_variables(tmp_path / "bare")
    assert no_meta == {} and sd.keys() == tg.state_dict().keys()
