"""The port's SPMD pipeline over several ranks (``parallel/pipeline_spmd``),
the ViT over dp x pp and dp x tp meshes (``parallel/train``,
``models/vit.shard_vit``) and the multichip dry run (``dryrun``), on
meshes that name ``cpu`` once an entry (one process drives every rank).

From JAX ``tests/test_parallel.py``, with its tolerances: the pipelined
stack of 8 encoder blocks matches the sequential loop (2e-5) at pp 4 and
at dp 2 x pp 4, its gradients match (rtol 1e-4, atol 1e-5), the overlap
schedule is bit-identical to serial at 2-4 ranks and deeper hop buffers,
``PipelineConfig`` drives it, the knobs and divisibility are validated.
A ``block_fn`` that records its calls, with ticks counted at the hop
(``ring_pass``, one call a tick), pins each schedule's (tick, rank,
microbatch) order and its tick count T. The dp x pp ViT train step matches
JAX's on a (dp 2, pp 2) mesh (losses rtol 1e-5, parameters 1e-4 of their
largest magnitude, as ``test_torch_train.py``), and the tp + dp ViT
matches the replicated one (rtol 1e-4, atol 1e-5) and JAX's
``graph.apply``.
"""

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
from adapt_tpu_torch.dryrun import dryrun_multichip
from adapt_tpu_torch.models.vit import shard_vit, vit, vit_tiny
from adapt_tpu_torch.parallel import pipeline_spmd as PS
from adapt_tpu_torch.parallel.sharding import P
from adapt_tpu_torch.parallel.train import (
    make_pipelined_vit_apply,
    make_train_step,
    place_vit,
    split_vit_variables,
    vit_shardings,
)

JMESH = importlib.import_module("adapt_tpu.core.mesh")
JSH = importlib.import_module("adapt_tpu.parallel.sharding")
JT = importlib.import_module("adapt_tpu.parallel.train")
JV = importlib.import_module("adapt_tpu.models.vit")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(*axes):
    spec = MeshSpec(tuple(axes))
    return build_mesh(spec, ["cpu"] * spec.num_devices)


@pytest.fixture(scope="module")
def blocks():
    """8 encoder blocks (dim 32, 4 heads, MLP 64) with random weights."""
    g = vit(4, 32, 8, 4, 64, 10, img_size=8, device="cpu", seed=3)
    return torch.nn.ModuleList(g.node(f"encoder_block_{i}").module
                               for i in range(8))


def _sequential(blocks, batch):
    h = batch
    for blk in blocks:
        h = blk(h)
    return h


def _run(blk, h):
    return blk(h)


@pytest.mark.parametrize("axes,batch_axis,num_micro", [
    ((("pp", 4),), None, 8),
    ((("dp", 2), ("pp", 4)), "dp", 4),  # mb 2, one row a dp shard
])
def test_pipeline_matches_sequential(blocks, axes, batch_axis, num_micro):
    batch = torch.randn(8, 10, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y = PS.spmd_pipeline(_run, blocks,
                             PS.pipeline_microbatch(batch, num_micro),
                             _mesh(*axes), batch_axis=batch_axis)
        want = _sequential(blocks, batch)
    torch.testing.assert_close(PS.pipeline_unmicrobatch(y), want, rtol=2e-5,
                               atol=2e-5)


def test_pipeline_is_differentiable(blocks):
    """Gradients through the tick loop and the hops equal the sequential
    model's."""
    batch = torch.randn(4, 10, 32, generator=torch.Generator().manual_seed(2))
    xs = PS.pipeline_microbatch(batch, 4)
    params = list(blocks.parameters())
    y = PS.spmd_pipeline(_run, blocks, xs, _mesh(("pp", 4)))
    g_pipe = torch.autograd.grad((y ** 2).mean(), params)
    g_seq = torch.autograd.grad((_sequential(blocks, batch) ** 2).mean(),
                                params)
    for a, b in zip(g_pipe, g_seq):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("axes,batch_axis,hop_buffers", [
    ((("pp", 2),), None, 2), ((("pp", 3),), None, 2),
    ((("pp", 4),), None, 2), ((("pp", 4),), None, 3),
    ((("dp", 2), ("pp", 4)), "dp", 2),
])
def test_overlap_equals_serial_bitwise(blocks, axes, batch_axis,
                                       hop_buffers):
    ranks = dict(axes)["pp"]
    stack = blocks[:2 * ranks]  # 6 blocks at 3 ranks
    xs = torch.randn(8, 1 if batch_axis is None else 2, 10, 32,
                     generator=torch.Generator().manual_seed(7))
    mesh = _mesh(*axes)
    with torch.no_grad():
        serial = PS.spmd_pipeline(_run, stack, xs, mesh,
                                  batch_axis=batch_axis, schedule="serial")
        overlap = PS.spmd_pipeline(_run, stack, xs, mesh,
                                   batch_axis=batch_axis, schedule="overlap",
                                   hop_buffers=hop_buffers)
    assert torch.equal(serial, overlap)


def _expected_ticks(ranks, per, num_micro, delay):
    """(tick, rank, microbatch) of every block call, in the reference's
    order, and T: rank p runs microbatch t - p * delay at tick t."""
    ticks = num_micro + (ranks - 1) * delay
    order = [(t, p, t - p * delay) for t in range(ticks)
             for p in range(ranks) if 0 <= t - p * delay < num_micro
             for _ in range(per)]
    return order, ticks


@pytest.mark.parametrize("schedule,hop_buffers,delay", [
    ("serial", 2, 1), ("overlap", 2, 2), ("overlap", 3, 3)])
def test_schedule_order_and_tick_count(monkeypatch, schedule, hop_buffers,
                                       delay):
    """Blocks are their own indices; microbatch m is the constant m. Ticks
    are counted at the hop: serial T = M + P - 1, overlap T = M + (P - 1)
    (d + 1)."""
    ranks, per, num_micro = 3, 2, 4
    tick = [-1]
    hop = PS.ring_pass

    def counting_hop(blocks, devices):
        tick[0] += 1
        return hop(blocks, devices)

    monkeypatch.setattr(PS, "ring_pass", counting_hop)
    calls = []

    def block_fn(i, x):
        calls.append((tick[0], i // per, int(x[0])))
        return x

    xs = torch.arange(num_micro, dtype=torch.float32)[:, None].repeat(1, 3)
    y = PS.spmd_pipeline(block_fn, list(range(ranks * per)), xs,
                         _mesh(("pp", ranks)), schedule=schedule,
                         hop_buffers=hop_buffers)
    order, ticks = _expected_ticks(ranks, per, num_micro, delay)
    assert calls == order
    assert tick[0] + 1 == ticks
    assert torch.equal(y, xs)


def test_pipeline_from_config_matches_sequential(blocks):
    batch = torch.randn(8, 10, 32, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        want = _sequential(blocks, batch)
        for cfg in (PipelineConfig(schedule="serial", microbatches=8),
                    PipelineConfig(schedule="overlap", microbatches=8,
                                   hop_buffers=3)):
            got = PS.spmd_pipeline_from_config(_run, blocks, batch,
                                               _mesh(("pp", 4)), cfg)
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_knobs_and_divisibility_are_validated(blocks):
    xs = torch.zeros(4, 2, 10, 32)
    pp4 = _mesh(("pp", 4))
    with pytest.raises(ValueError, match="schedule"):
        PS.spmd_pipeline(_run, blocks, xs, pp4, schedule="eager")
    with pytest.raises(ValueError, match="hop_buffers"):
        PS.spmd_pipeline(_run, blocks, xs, pp4, schedule="overlap",
                         hop_buffers=1)
    with pytest.raises(ValueError, match="not divisible"):
        PS.spmd_pipeline(_run, blocks[:6], xs, pp4)
    with pytest.raises(ValueError, match="not divisible"):
        PS.spmd_pipeline(_run, blocks, torch.zeros(4, 3, 10, 32),
                         _mesh(("dp", 2), ("pp", 4)), batch_axis="dp")
    with pytest.raises(ValueError, match="no axis"):
        PS.spmd_pipeline(_run, blocks, xs, pp4, batch_axis="dp")
    split = build_mesh(MeshSpec((("dp", 2), ("pp", 1))), ["cpu", "meta"])
    with pytest.raises(ValueError, match="distinct devices"):
        PS.spmd_pipeline(_run, blocks, xs, split, batch_axis="dp")
    with pytest.raises(ValueError, match="schedule"):
        PipelineConfig(schedule="eager")
    with pytest.raises(ValueError, match="hop_buffers"):
        PipelineConfig(hop_buffers=0)


# -- the ViT over dp x pp and dp x tp ------------------------------------


@pytest.fixture(scope="module")
def jax_vit():
    jg = JV.vit_tiny()
    x = np.random.default_rng(4).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    variables = jax.jit(jg.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    return jg, jax.device_get(variables), x


def test_dp_pp_train_step_matches_jax(jax_vit, devices):
    """Two SGD steps over a (dp 2, pp 2) mesh: 2 microbatches of 2 rows,
    one row a dp shard, the blocks placed by ``vit_shardings``."""
    jg, variables, x = jax_vit
    y = np.array([1, 7, 3, 0])
    jmesh = JMESH.build_mesh(JMESH.MeshSpec((("dp", 2), ("pp", 2))),
                             devices[:4])
    jparams = JT.split_vit_variables(jg, variables, 4)
    jparams = jax.device_put(jparams, JT.vit_shardings(jparams, jmesh))
    opt = optax.sgd(0.05)
    jstate = opt.init(jparams)
    jstep = jax.jit(JT.make_train_step(JT.make_pipelined_vit_apply(
        jg, jmesh, 2), opt))
    j_losses = []
    for _ in range(2):
        jparams, jstate, loss = jstep(jparams, jstate, jnp.asarray(x),
                                      jnp.asarray(y))
        j_losses.append(float(loss))

    g = vit_tiny(device="cpu")
    g.load_state_dict(vit_from_flax(variables))
    mesh = _mesh(("dp", 2), ("pp", 2))
    params = split_vit_variables(g, 4)
    shardings = vit_shardings(params, mesh)
    assert all(s.spec == P("pp") for s in shardings.blocks.values())
    assert all(s.spec == P() for part in (shardings.embed, shardings.head)
               for s in part.values())
    assert sorted(shardings.blocks) == sorted(params.state_dict()["blocks"])
    params = place_vit(params, shardings)
    step = make_train_step(make_pipelined_vit_apply(g, mesh, 2),
                           functools.partial(torch.optim.SGD, lr=0.05))
    state, t_losses = None, []
    for _ in range(2):
        params, state, loss = step(params, state, torch.from_numpy(x),
                                   torch.from_numpy(y))
        t_losses.append(float(loss))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    tree = {"patch_embed": jparams.embed, "head": jparams.head}
    for i in range(4):
        tree[f"encoder_block_{i}"] = jax.tree.map(lambda a, i=i: a[i],
                                                  jparams.blocks)
    want = vit_from_flax(jax.device_get(tree))
    got = g.state_dict()
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (k, err)


def test_tp_dp_vit_matches_replicated_and_jax(jax_vit):
    """``shard_vit`` over (dp 2, tp 4) and (dp 2, tp 2): every encoder
    matmul split by ``vit_tp_rules``, the batch over dp."""
    jg, variables, x = jax_vit
    want_jax = np.asarray(jax.jit(jg.apply)(variables, jnp.asarray(x)))
    g = vit_tiny(device="cpu")
    g.load_state_dict(vit_from_flax(variables))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ref = g.apply(xt)
        for tp in (4, 2):
            sharded = shard_vit(g, _mesh(("dp", 2), ("tp", tp)))
            blk = sharded.blocks[0]
            assert len(blk.attn_shards) == tp and len(blk.mlp_shards) == tp
            assert blk.attn_shards[0].qkv.weight.shape == (3 * 64 // tp, 64)
            assert blk.mlp_shards[0]["mlp_out"].weight.shape == (64,
                                                                 128 // tp)
            y = sharded(xt)
            torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(y.numpy(), want_jax, rtol=1e-4,
                                       atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        shard_vit(g, _mesh(("tp", 8)))


def test_dryrun_multichip_on_four_cpu_entries():
    out = dryrun_multichip(4, devices=["cpu"] * 4)
    assert out["mesh"] == {"dp": 1, "pp": 4}
    assert np.isfinite(out["loss"])
    assert out["tp_err"] < 1e-4 and out["ring_flash_err"] < 1e-4
    with pytest.raises(ValueError, match="need 4 devices"):
        dryrun_multichip(4, devices=["cpu"] * 2)
