"""The port's pipelined KV-cache generation (``parallel/pipeline_decode``)
against the port's own ``generate()`` and the JAX package, on meshes that
name ``cpu`` once a rank (one process drives every rank).

The contracts of JAX ``tests/test_pipeline_decode.py``: streams token-equal
to single-program ``generate()`` — greedy, sampled with top-k, top-p, EOS,
ragged, int8, GQA, a single step, 2 ranks of 2 blocks, dp 2 x pp 2 — each
rank holding only its own blocks, and bad divisibility refused. Also:
int4 caches equal ``generate(kv_cache_dtype="int4")``, where the reference
passes ``kv_quant = kv_cache_dtype == "int8"`` and so runs native caches
for an int4 request (pinned against JAX's own ``generate``); and greedy
ragged streams token-equal to JAX ``pipelined_generate`` on the same
weights (``convert.from_flax``). JAX's pipelined program is run twice, at
pp 2, to keep its compile cost down; everything else is held to the
port's ``generate()``, which ``test_torch_lm.py`` holds to JAX's.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.core.mesh import MeshSpec, build_mesh
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.parallel import pipelined_generate, shard_for_pipeline
from adapt_tpu_torch.parallel.pipeline_decode import PipelinedVariables

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JP = importlib.import_module("adapt_tpu.parallel.pipeline_decode")

VOCAB = 61
LENS = [3, 5, 2, 5, 4, 5, 1, 3]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(pp, dp=1):
    spec = ((("dp", dp),) if dp > 1 else ()) + (("pp", pp),)
    return build_mesh(MeshSpec(spec), ["cpu"] * (dp * pp))


@pytest.fixture(scope="module")
def pair():
    """JAX ``lm_tiny(vocab=61, max_len=32)`` (depth 4), its variables, the
    port's LM on them, and an (8, 5) prompt."""
    jlm = J.lm_tiny(vocab=VOCAB, max_len=32)
    prompt = np.random.default_rng(0).integers(0, VOCAB, (8, 5))
    variables = jax.device_get(
        jax.jit(jlm.graph.init)(jax.random.PRNGKey(1), jnp.asarray(prompt)))
    tlm = T.lm_tiny(vocab=VOCAB, max_len=32, device="cpu")
    tlm.load_state_dict(from_flax(variables))
    return jlm, variables, tlm, torch.from_numpy(prompt)


#: name -> (pp, dp, steps, generate() keywords): the reference's cases
#: at pp 4 (one block a rank) and pp 2, and on a (dp 2, pp 2) mesh.
CASES = {
    "greedy": (4, 1, 7, {}),
    "sampled_top_k": (4, 1, 6, dict(temperature=0.9, top_k=7, rng=3)),
    "top_p": (4, 1, 5, dict(temperature=1.0, top_p=0.65, rng=41)),
    "ragged": (4, 1, 5, dict(prompt_lengths=LENS)),
    "int8": (4, 1, 6, dict(kv_cache_dtype="int8")),
    "int4": (4, 1, 6, dict(kv_cache_dtype="int4")),
    "single_step": (4, 1, 1, {}),
    "two_ranks_two_blocks": (2, 1, 5, {}),
    "two_ranks_int4": (2, 1, 5, dict(kv_cache_dtype="int4")),
    "dp_greedy": (2, 2, 5, {}),
    "dp_sampled": (2, 2, 4, dict(temperature=0.9, top_k=11, rng=52)),
    "dp_ragged": (2, 2, 4, dict(prompt_lengths=LENS)),
    "dp_int8": (2, 2, 4, dict(kv_cache_dtype="int8")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_streams_equal_generate(pair, case):
    _, _, lm, prompt = pair
    pp, dp, steps, kw = CASES[case]
    want = T.generate(lm, prompt, steps, **kw)
    got = pipelined_generate(lm, None, prompt, steps, _mesh(pp, dp),
                             dp_axis="dp" if dp > 1 else None, **kw)
    assert got.shape == (8, steps) and got.dtype == torch.int64
    assert torch.equal(got, want)


@pytest.mark.parametrize("pp,dp", [(4, 1), (2, 2)])
def test_eos_matches_generate(pair, pp, dp):
    _, _, lm, prompt = pair
    eos = int(T.generate(lm, prompt, 6)[0, 1])  # finishes a row early
    want = T.generate(lm, prompt, 6, eos_id=eos)
    got = pipelined_generate(lm, None, prompt, 6, _mesh(pp, dp),
                             dp_axis="dp" if dp > 1 else None, eos_id=eos)
    assert torch.equal(got, want)
    assert (got[0, 1:] == eos).all()


def test_gqa_matches_generate():
    """Rank-local caches carry the GQA model's kv_heads layout."""
    lm = T.transformer_lm(53, 32, 4, 4, 48, max_len=32, kv_heads=2,
                          device="cpu", seed=61)
    prompt = torch.from_numpy(np.random.default_rng(60).integers(0, 53,
                                                                 (4, 5)))
    want = T.generate(lm, prompt, 6)
    assert torch.equal(pipelined_generate(lm, None, prompt, 6, _mesh(4)),
                       want)


def test_shard_for_pipeline_places_blocks_per_rank(pair):
    """Each rank holds only its own L/P blocks, as tensors on its device;
    the embedding and head are the model's own tensors (one copy a
    device); a pre-placed ``PipelinedVariables`` and a ``state_dict``
    generate identically."""
    _, variables, lm, prompt = pair
    placed = shard_for_pipeline(lm, _mesh(2))
    assert isinstance(placed, PipelinedVariables) and len(placed.stages) == 2
    sd = lm.state_dict()
    ends = {k: t.data_ptr() for k, t in sd.items()
            if k.startswith(("embed.", "head."))}
    for p, stage in enumerate(placed.stages):
        assert stage.depth == 2 and placed.devices[p] == torch.device("cpu")
        got = stage.state_dict()
        for j in range(2):
            src, dst = f"decoder_block_{2 * p + j}.", f"decoder_block_{j}."
            block = {k[len(src):]: t for k, t in sd.items()
                     if k.startswith(src)}
            assert block and all(torch.equal(got[dst + k], t)
                                 for k, t in block.items())
        assert {k: t.data_ptr() for k, t in got.items()
                if k.startswith(("embed.", "head."))} == ends
        assert not any(k.startswith("decoder_block_2") for k in got)
    want = T.generate(lm, prompt, 5)
    assert torch.equal(pipelined_generate(lm, placed, prompt, 5, _mesh(2)),
                       want)
    assert torch.equal(pipelined_generate(lm, from_flax(variables), prompt,
                                          5, _mesh(2)), want)


def test_rejects_bad_divisibility(pair):
    _, _, lm, prompt = pair
    with pytest.raises(ValueError, match="batch"):
        pipelined_generate(lm, None, prompt[:6], 4, _mesh(4))
    lm3 = T.transformer_lm(VOCAB, 64, 3, 4, 128, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="depth"):
        pipelined_generate(lm3, None, prompt, 4, _mesh(4))
    with pytest.raises(ValueError, match="depth"):
        shard_for_pipeline(lm3, _mesh(4))
    rows12 = torch.cat([prompt, prompt[:4]])
    with pytest.raises(ValueError, match="dp size"):
        # 12 rows: divisible by pp=4 (3 a microbatch), but 3 % dp=2 != 0.
        pipelined_generate(lm, None, rows12, 4, _mesh(4, 2), dp_axis="dp")
    with pytest.raises(ValueError, match="max_len"):
        pipelined_generate(lm, None, prompt, 30, _mesh(4))


def _jax_pipelined(jlm, variables, prompt, steps, **kw):
    mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    return np.asarray(JP.pipelined_generate(jlm, variables,
                                            jnp.asarray(prompt), steps, mesh,
                                            **kw))


def test_ragged_greedy_equals_jax_pipelined(pair):
    jlm, variables, lm, prompt = pair
    want = _jax_pipelined(jlm, variables, prompt.numpy(), 12,
                          prompt_lengths=jnp.asarray(LENS))
    got = pipelined_generate(lm, None, prompt, 12, _mesh(2),
                             prompt_lengths=LENS)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int4_runs_int4_caches_where_jax_runs_native(pair):
    """The reference's int4 request runs native caches: its output is its
    own native ``generate``'s. The port's is ``generate(kv_cache_dtype=
    "int4")``'s, which differs from the native streams."""
    jlm, variables, lm, prompt = pair
    jax_int4 = _jax_pipelined(jlm, variables, prompt.numpy(), 12,
                              kv_cache_dtype="int4")
    jax_native = np.asarray(J.generate(jlm, variables,
                                       jnp.asarray(prompt.numpy()), 12))
    np.testing.assert_array_equal(jax_int4, jax_native)
    got = pipelined_generate(lm, None, prompt, 12, _mesh(2),
                             kv_cache_dtype="int4")
    assert torch.equal(got, T.generate(lm, prompt, 12, kv_cache_dtype="int4"))
    assert not torch.equal(got, T.generate(lm, prompt, 12))
