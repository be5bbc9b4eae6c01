"""The pipelined tick's device half on a card: ``_AsyncFetch`` (a pinned
host buffer per fetch, a ``non_blocking`` copy and a recorded event) and
the pinned ``non_blocking`` staging. Every test is marked ``gpu`` and
skips without a CUDA device. This file imports no JAX:

    python -m pytest tests/test_torch_async_gpu.py -q --noconftest

- depth-2 greedy streams equal depth-1 streams on the card, dense strips
  and the paged pool (K1, K2 / K3 launched);
- a steady depth-2 dispatch half runs under
  ``torch.cuda.set_sync_debug_mode("error")`` (no stream synchronization,
  no blocking copy), stages nothing host->device and starts one fetch
  that is still in flight when the dispatch returns or has landed."""

import numpy as np
import pytest
import torch

from adapt_tpu_torch.config import RuntimeConfig
from adapt_tpu_torch.models.transformer_lm import transformer_lm
from adapt_tpu_torch.runtime.continuous import ContinuousBatcher


@pytest.fixture(scope="module")
def lm():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no "
                    "CPU mode")
    return transformer_lm(512, 128, 2, 2, 256, max_len=256,
                          dtype=torch.bfloat16, name="async_gpu", seed=0,
                          device="cuda")


def _traffic(seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 512, n), s) for n, s in
            ((17, 24), (60, 9), (5, 30), (129, 12), (33, 20), (8, 16))]


def _serve(lm, depth, layout):
    extra = dict(kv_layout="paged", page_size=16) if layout == "paged" else {}
    bat = ContinuousBatcher(lm, slots=4, chunk=4,
                            runtime=RuntimeConfig(pipeline_depth=depth),
                            **extra)
    traffic = _traffic()
    ids = [bat.submit(p, s) for p, s in traffic[:3]]
    bat.tick()
    bat.tick()
    ids += [bat.submit(p, s) for p, s in traffic[3:]]
    out = bat.run()
    st = bat.stats()
    assert st["active"] == 0 and not st["inflight"]
    return [out[r].tolist() for r in ids]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_depth2_streams_equal_depth1_on_card(lm, layout):
    one = _serve(lm, 1, layout)
    two = _serve(lm, 2, layout)
    assert one == two
    assert [len(t) for t in two] == [s for _, s in _traffic()]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_steady_depth2_dispatch_half_makes_no_stream_sync(lm, layout):
    extra = dict(kv_layout="paged", page_size=16) if layout == "paged" else {}
    bat = ContinuousBatcher(lm, slots=4, chunk=4,
                            runtime=RuntimeConfig(pipeline_depth=2), **extra)
    for p, _ in _traffic(1)[:4]:
        bat.submit(p, 60)
    for _ in range(3):
        bat.tick()
    assert bat.stats()["inflight"]
    before = bat.stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fl = bat._tick_dispatch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    prev, bat._inflight = bat._inflight, fl
    assert fl is not None and fl.n_active == 4
    after = bat.stats()
    assert after["h2d_transfers"] == before["h2d_transfers"]
    assert after["d2h_fetches"] - before["d2h_fetches"] == 1
    assert bat._tick_commit(prev) == 4
    assert fl.fetch.commit().shape == (2, 4, 4)
    assert fl.fetch.ready()
    bat.run()
