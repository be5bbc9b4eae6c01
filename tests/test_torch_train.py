"""The port's training path against the JAX package.

Three SGD steps of ``make_train_step`` on ``vit_tiny`` (two microbatches
through the one-rank pipeline) from the same flax variables and the same
numpy batch as JAX's ``make_train_step(optax.sgd)`` on a one-device
``("dp", "pp")`` mesh: every loss agrees to ``rtol 1e-5`` and every final
parameter to ``1e-4`` of its largest magnitude (f32 on both sides, summed
in another order). Also the microbatch split, the one-rank pipeline
schedule, the validation of meshes and knobs, ``PipelineConfig`` and
``TrainCheckpointer`` resume and its context manager. Several ranks:
``test_torch_pipeline_spmd.py``."""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adapt_tpu_torch.config import PipelineConfig
from adapt_tpu_torch.convert import vit_from_flax
from adapt_tpu_torch.core.mesh import MeshSpec, build_mesh
from adapt_tpu_torch.models.vit import vit_tiny
from adapt_tpu_torch.parallel import pipeline_spmd as PS
from adapt_tpu_torch.parallel.train import (
    make_pipelined_vit_apply,
    make_train_step,
    split_vit_variables,
)
from adapt_tpu_torch.utils.checkpoint import TrainCheckpointer

JCFG = importlib.import_module("adapt_tpu.config")
JMESH = importlib.import_module("adapt_tpu.core.mesh")
JPS = importlib.import_module("adapt_tpu.parallel.pipeline_spmd")
JT = importlib.import_module("adapt_tpu.parallel.train")
JV = importlib.import_module("adapt_tpu.models.vit")

LR = 0.05
MESH = build_mesh(MeshSpec((("dp", 1), ("pp", 1))), ["cpu"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, n=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, size=n))


def _port(seed=0, lr=LR, momentum=0.0):
    g = vit_tiny(device="cpu", seed=seed)
    params = split_vit_variables(g, 4)
    step = make_train_step(
        make_pipelined_vit_apply(g, MESH, num_micro=2),
        functools.partial(torch.optim.SGD, lr=lr, momentum=momentum))
    return g, params, step


def _flax_tree(params):
    """JAX's PipelinedViT -> per-node flax variables (unstacked blocks)."""
    tree = {"patch_embed": params.embed, "head": params.head}
    depth = jax.tree.leaves(params.blocks)[0].shape[0]
    for i in range(depth):
        tree[f"encoder_block_{i}"] = jax.tree.map(lambda a, i=i: a[i],
                                                  params.blocks)
    return jax.device_get(tree)


def test_three_sgd_steps_match_jax():
    x, y = _batch()
    jg = JV.vit_tiny()
    var = jax.jit(jg.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    mesh = JMESH.build_mesh(JMESH.MeshSpec((("dp", 1), ("pp", 1))),
                            jax.devices()[:1])
    jparams = JT.split_vit_variables(jg, var, 4)
    opt = optax.sgd(LR)
    jstate = opt.init(jparams)
    jstep = jax.jit(JT.make_train_step(
        JT.make_pipelined_vit_apply(jg, mesh, 2), opt))
    j_losses = []
    for _ in range(3):
        jparams, jstate, loss = jstep(jparams, jstate, jnp.asarray(x),
                                      jnp.asarray(y))
        j_losses.append(float(loss))

    g, params, step = _port()
    g.load_state_dict(vit_from_flax(jax.device_get(var)))
    state, t_losses = None, []
    for _ in range(3):
        params, state, loss = step(params, state, torch.from_numpy(x),
                                   torch.from_numpy(y))
        t_losses.append(float(loss))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_losses[-1] < t_losses[0]
    want = vit_from_flax(_flax_tree(jparams))
    got = g.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (k, err)


def test_pipelined_state_dict_is_jax_stacked_layout():
    g, params, _ = _port()
    sd = params.state_dict()
    assert sd["blocks"]["attn.qkv.weight"].shape == (4, 192, 64)
    blocks = PS.stack_stage_params([b.state_dict() for b in params.blocks])
    assert all(torch.equal(blocks[k], sd["blocks"][k]) for k in blocks)
    g2, params2, _ = _port(seed=5)
    params2.load_state_dict(sd)
    a, b = g.state_dict(), g2.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="other parameters"):
        PS.stack_stage_params([{"w": torch.zeros(1)}, {"u": torch.zeros(1)}])


@pytest.mark.parametrize("num_micro", [1, 2, 4])
def test_microbatch_round_trip(num_micro):
    x = torch.arange(8 * 3 * 5, dtype=torch.float32).reshape(8, 3, 5)
    xs = PS.pipeline_microbatch(x, num_micro)
    assert xs.shape == (num_micro, 8 // num_micro, 3, 5)
    last, mb = num_micro - 1, 8 // num_micro
    assert torch.equal(xs[last], x[last * mb:])
    assert torch.equal(PS.pipeline_unmicrobatch(xs), x)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(
        JPS.pipeline_microbatch(jnp.asarray(x.numpy()), num_micro)))


def test_microbatch_refuses_ragged_split():
    with pytest.raises(ValueError, match="not divisible"):
        PS.pipeline_microbatch(torch.zeros(6, 2), 4)


def _blocks(n=4, d=8):
    torch.manual_seed(0)
    return torch.nn.ModuleList(torch.nn.Linear(d, d) for _ in range(n))


@pytest.mark.parametrize("schedule", ["serial", "overlap"])
def test_one_rank_pipeline_is_the_sequential_block_loop(schedule):
    blocks = _blocks()
    xs = torch.randn(3, 2, 8)
    with torch.no_grad():
        got = PS.spmd_pipeline(lambda m, a: m(a), blocks, xs, MESH,
                               schedule=schedule, hop_buffers=3)
        want = []
        for x in xs:
            for m in blocks:
                x = m(x)
            want.append(x)
    assert torch.equal(got, torch.stack(want))


def test_more_ranks_are_refused():
    """Several ranks run (``test_torch_pipeline_spmd.py``); what is refused
    is a rank count the blocks or rows do not divide, a mesh without the
    axis, a rank whose dp shards name distinct devices, and bad knobs."""
    blocks, xs = _blocks(), torch.randn(2, 2, 8)
    fn = lambda m, a: m(a)  # noqa: E731

    def mesh(*axes, devices=None):
        spec = MeshSpec(tuple(axes))
        return build_mesh(spec, devices or ["cpu"] * spec.num_devices)

    with pytest.raises(ValueError, match="not divisible by pipeline"):
        PS.spmd_pipeline(fn, blocks, xs, mesh(("pp", 3)))
    with pytest.raises(ValueError, match="not divisible by the 'dp'"):
        PS.spmd_pipeline(fn, blocks, torch.randn(2, 3, 8),
                         mesh(("dp", 2), ("pp", 2)), batch_axis="dp")
    with pytest.raises(ValueError, match="no axis 'pp'"):
        PS.spmd_pipeline(fn, blocks, xs, mesh(("tp", 2)))
    with pytest.raises(ValueError, match="distinct devices"):
        PS.spmd_pipeline(fn, blocks, xs, mesh(("dp", 2), ("pp", 1),
                                              devices=["cpu", "meta"]),
                         batch_axis="dp")
    with pytest.raises(ValueError, match="schedule"):
        PS.spmd_pipeline(fn, blocks, xs, schedule="1f1b")
    with pytest.raises(ValueError, match="hop_buffers"):
        PS.spmd_pipeline(fn, blocks, xs, schedule="overlap", hop_buffers=1)
    g, params, _ = _port()
    with pytest.raises(ValueError, match="distinct devices"):
        make_pipelined_vit_apply(g, mesh(("dp", 2), ("pp", 2), devices=[
            "cpu", "cpu", "meta", "meta"]), 2)
    apply_fn = make_pipelined_vit_apply(g, mesh(("dp", 1), ("pp", 3)), 2)
    with pytest.raises(ValueError, match="not divisible by pipeline"):
        apply_fn(params, torch.zeros(2, 32, 32, 3))
    with torch.no_grad():
        two = make_pipelined_vit_apply(g, mesh(("dp", 1), ("pp", 2)), 2)(
            params, torch.ones(2, 32, 32, 3))
        one = make_pipelined_vit_apply(g, None, 2)(params,
                                                   torch.ones(2, 32, 32, 3))
    assert torch.equal(two, one)


def test_pipeline_config_matches_jax_and_drives_the_schedule():
    def fields(c):
        return {f.name: f.default for f in dataclasses.fields(c)}

    assert fields(PipelineConfig) == fields(JCFG.PipelineConfig)
    for bad in (dict(schedule="gpipe"), dict(microbatches=0),
                dict(hop_buffers=1)):
        with pytest.raises(ValueError):
            PipelineConfig(**bad)
    blocks, x = _blocks(), torch.randn(8, 8)
    with torch.no_grad():
        got = PS.spmd_pipeline_from_config(
            lambda m, a: m(a), blocks, x, MESH,
            PipelineConfig(microbatches=4))
        want = x
        for m in blocks:
            want = m(want)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_checkpoint_resume_continues_with_the_same_losses(tmp_path):
    x, y = (torch.from_numpy(t) for t in _batch(1))
    _, params, step = _port(momentum=0.9)
    state, losses = None, []
    ckpt = TrainCheckpointer(tmp_path, max_to_keep=3)
    for i in range(1, 5):
        params, state, loss = step(params, state, x, y)
        losses.append(float(loss))
        ckpt.save(i, params, state)
    assert ckpt.steps() == [2, 3, 4] and ckpt.latest_step() == 4
    _, fresh, step2 = _port(seed=9, momentum=0.9)
    resumed, opt_state, at = ckpt.restore(fresh, step=2)
    assert at == 2 and resumed is fresh
    assert opt_state["state"]  # the momentum buffers came back
    again = []
    for _ in range(2):
        resumed, opt_state, loss = step2(resumed, opt_state, x, y)
        again.append(float(loss))
    assert again == losses[2:]


def test_checkpointer_without_steps_raises(tmp_path):
    ckpt = TrainCheckpointer(tmp_path / "empty")
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(None)
    with pytest.raises(ValueError, match="max_to_keep"):
        TrainCheckpointer(tmp_path, max_to_keep=0)


def test_checkpointer_as_a_context_manager(tmp_path):
    """As JAX ``tests/test_checkpoint.py`` opens it: ``with`` gives the
    checkpointer, retention and restore work inside, leaving closes it."""
    x, y = (torch.from_numpy(t) for t in _batch(2))
    _, params, step = _port()
    state = None
    with TrainCheckpointer(tmp_path / "train", max_to_keep=2) as ck:
        for i in (1, 2, 3):
            params, state, _ = step(params, state, x, y)
            ck.save(i, params, state)
        assert ck.latest_step() == 3 and ck.steps() == [2, 3]
        _, fresh, _ = _port(seed=4)
        _, _, at = ck.restore(fresh)
        assert at == 3
        a, b = params.state_dict(), fresh.state_dict()
        assert all(torch.equal(a["blocks"][k], b["blocks"][k])
                   for k in a["blocks"])
        with pytest.raises(FileNotFoundError):
            ck.restore(fresh, step=1)  # evicted by retention
    with pytest.raises(ValueError, match="closed"):
        ck.save(4, params, state)
    with pytest.raises(ValueError, match="closed"):
        ck.latest_step()
    with TrainCheckpointer(tmp_path / "empty") as ck:
        with pytest.raises(FileNotFoundError):
            ck.restore(None)
    ck.close()  # closing twice is harmless
