"""The partitioned pipeline and the K6 unaligned-base repair on a card.
Every test is marked ``gpu`` and skips without a CUDA device. This file
imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_pipeline_gpu.py -q --noconftest

- K6: the public ``quantize`` of a contiguous view at storage offset 1
  (``buf[1:].view(2, 8192)`` of a bf16 ``buf`` of 16385 elements), and
  ``dequantize`` / ``dequantize_params`` of an int8 payload stored at an
  odd offset, launch the kernels on aligned copies and equal the plain
  versions bit for bit (NaN-aware, as the other K6 gates); the kernel entry
  points still refuse such bases (``test_torch_kernels_gpu.py``).
- ``LocalPipeline``: a 10-class ResNet-50 at 64 x 64 in its 3 stages, f32
  (TF32 off), on ``cuda:0``: ``infer``, ``stream`` (in the caller's
  thread on one card) and the thread-per-stage stream outputs within
  ``1e-4`` of the largest reference logit of ``graph.apply`` on the card.
- ``ServingPipeline``: a 4-block ViT with head_dim 64 (K1's) in 3 stages on
  four workers of ``cuda:0``, one crashed and one hung mid-stream: every
  result within ``1e-2`` of the largest reference logit (bf16) of
  ``graph.apply``, none failed, the hung worker not DEAD, no stage module
  built by the failover, K1 launched on the path.
- Across processes (``comm.remote``): a 10-class ResNet-50 at 64 x 64 in
  3 stages over 3 worker processes on ``cuda:0`` with the ``none``,
  ``int8dev`` and ``lz`` codecs, and the 4-block ViT over 3 worker
  processes (configured by ``graph_spec``): the lossless codecs
  ``torch.equal`` to ``graph.apply``, ``int8dev`` within max(1e-2, 2 x
  the in-process int8dev pipeline's error) with K6 launched on every hop
  this process makes.
"""

import pytest
import torch

from adapt_tpu_torch.config import FaultConfig, ServeConfig
from adapt_tpu_torch.control.worker import WorkerState
from adapt_tpu_torch.graph.partition import partition
from adapt_tpu_torch.models import resnet as TR
from adapt_tpu_torch.models import vit as TV
from adapt_tpu_torch.ops import attention as TA
from adapt_tpu_torch.ops import quantize as TQ
from adapt_tpu_torch.runtime.pipeline import LocalPipeline, ServingPipeline
from adapt_tpu_torch.utils.metrics import global_metrics


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K6 kernels are CUDA C++ with no "
                    "CPU mode, and the pipelines run on the card")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 gates are real f32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _same_bits(a, b):
    """``torch.equal``, a NaN counting equal to a NaN."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_public_entry_points_take_unaligned_bases(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(31)
    buf = torch.randn(2 * 8192 + 1, generator=g, device=cuda).to(dtype)
    buf[8000] = float("nan")
    x = buf[1:].view(2, 8192)
    assert x.data_ptr() % 16 and x.is_contiguous()
    n_q = TQ.quantize_blocks.launches
    qt = TQ.quantize(x)
    torch.cuda.synchronize()
    assert TQ.quantize_blocks.launches == n_q + 1
    ref = TQ.quantize_reference(x)
    assert torch.equal(qt.values, ref.values)
    assert _same_bits(qt.scales, ref.scales)
    shifted = torch.empty(qt.values.numel() + 1, dtype=torch.int8,
                          device=cuda)
    shifted[1:] = qt.values.reshape(-1)
    odd = TQ.QuantizedTensor(shifted[1:].view(-1, 128), qt.scales, qt.shape,
                             qt.dtype)
    assert odd.values.data_ptr() % 16
    n_d = TQ.dequantize_blocks.launches
    back = TQ.dequantize(odd)
    bias = buf[:5]
    tree = TQ.dequantize_params({"w": odd, "b": bias})
    torch.cuda.synchronize()
    assert TQ.dequantize_blocks.launches == n_d + 2
    want = TQ.dequantize_reference(ref)
    assert back.dtype == dtype and _same_bits(back, want)
    assert _same_bits(tree["w"], want) and tree["b"] is bias


@pytest.mark.gpu
def test_resnet50_local_pipeline_on_the_card(cuda):
    graph = TR.resnet50(10, device=cuda, seed=0)
    plan = partition(graph, TR.RESNET50_3STAGE_CUTS)
    gen = torch.Generator(device=cuda).manual_seed(3)
    xs = [torch.randn(2, 64, 64, 3, generator=gen, device=cuda)
          for _ in range(6)]
    with torch.no_grad():
        refs = [graph.apply(x) for x in xs]
    pipe = LocalPipeline(plan, devices=[cuda] * 3)
    assert all(s.device.type == "cuda" for s in pipe.stages)
    outs = ([pipe.infer(x) for x in xs] + pipe.stream(xs)
            + pipe._threaded_stream(xs))
    for y, ref in zip(outs, refs * 3, strict=True):
        assert y.is_cuda and _rel_err(y, ref) <= 1e-4
    shapes = graph.eval_shapes(xs[0])
    assert tuple(shapes["conv2_block3_out"].shape) == (2, 16, 16, 256)
    assert tuple(shapes["conv3_block4_out"].shape) == (2, 8, 8, 512)


@pytest.mark.gpu
def test_vit_serving_pipeline_survives_crash_and_hang_on_the_card(cuda):
    graph = TV.vit(8, 128, 4, 2, 256, 10, torch.bfloat16, name="vit_hd64",
                   img_size=32, device=cuda, seed=1)
    plan = partition(graph, TV.vit_block_cuts(4, 3))
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda)
    with torch.no_grad():
        ref = graph.apply(x)
    global_metrics().reset()
    cfg = ServeConfig(max_inflight=8, fault=FaultConfig(
        lease_ttl_s=0.5, heartbeat_s=0.1, task_deadline_s=2.0,
        watchdog_period_s=0.05, startup_wait_s=10.0, max_retries=4,
        quarantine_strikes=2))
    with ServingPipeline(plan, None, [cuda] * 4, cfg) as pipe:
        pipe.warmup(x)
        builds = pipe.dispatcher.stage_builds
        k1 = TA.flash_attn_fwd.launches
        futures = []
        for i in range(12):
            futures.append(pipe.dispatcher.submit(x))
            if i == 3:
                pipe.kill_worker(0, mode="crash")
            elif i == 6:
                pipe.kill_worker(1, mode="hang")
        results = [f.result(120.0) for f in futures]
        torch.cuda.synchronize()
        assert all(_rel_err(y, ref) <= 1e-2 for y in results)
        assert TA.flash_attn_fwd.launches - k1 >= 4 * 12
        counters = global_metrics().snapshot()["counters"]
        assert counters.get("dispatcher.failed", 0) == 0
        assert counters.get("dispatcher.completed", 0) >= 13
        assert pipe.workers[1].state is not WorkerState.DEAD
        assert pipe.dispatcher.stage_builds == builds


# -- the pipeline across processes (comm.remote) ------------------------------


def _worker_procs(n, *args):
    """``n`` worker processes on the card (``subprocess``, never a fork of
    this CUDA process; TF32 off, as the ``cuda`` fixture sets it here),
    each listening on a free port; returns the processes and their
    ports."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "adapt_tpu_torch.comm.remote", "--port", "0",
         "--device", "cuda:0", "--heartbeat", "0.2", "--no-tf32", *args],
        cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True) for _ in range(n)]
    ports = []
    for p in procs:
        line = p.stdout.readline().split()
        assert line and line[0] == "listening", f"worker did not start {line}"
        ports.append(int(line[1].rpartition(":")[2]))
    return procs, ports


def _stop(procs):
    for p in procs:
        p.terminate()
    for p in procs:
        p.wait(timeout=30)
        p.stdout.close()


REMOTE_FAULT = FaultConfig(lease_ttl_s=2.0, heartbeat_s=0.2,
                           task_deadline_s=30.0, watchdog_period_s=0.1,
                           startup_wait_s=60.0, configure_timeout_s=60.0)


@pytest.mark.gpu
def test_resnet50_hub_over_worker_processes_on_the_card(cuda):
    """Phase 13 (a) small: a 10-class ResNet-50 at 64 x 64, f32, in 3
    stages over 3 worker processes on the card; ``none`` and ``lz``
    outputs ``torch.equal`` to ``graph.apply``, ``int8dev`` within
    max(1e-2, 2 x ``LocalPipeline.from_config(codec="int8dev")``'s error)
    of the largest logit, with K6 launched in this process for every stage
    input it sends and every result it receives."""
    from adapt_tpu_torch.comm.remote import RemoteWorkerProxy
    from adapt_tpu_torch.config import CodecConfig
    from adapt_tpu_torch.control.dispatcher import Dispatcher

    graph = TR.resnet50(10, device=cuda, seed=0)
    cuts = list(TR.RESNET50_3STAGE_CUTS)
    plan = partition(graph, cuts)
    gen = torch.Generator(device=cuda).manual_seed(5)
    xs = [torch.randn(2, 64, 64, 3, generator=gen, device=cuda)
          for _ in range(6)]
    with torch.no_grad():
        refs = [graph.apply(x) for x in xs]
    local = LocalPipeline.from_config(
        plan, devices=[cuda] * 3,
        config=ServeConfig(codec=CodecConfig(name="int8dev")))
    bar = max(1e-2, 2 * max(_rel_err(y, r)
                            for y, r in zip(local.stream(xs), refs)))
    host = plan.extract_variables()
    procs, ports = _worker_procs(3)
    try:
        for codec in ("none", "int8dev", "lz"):
            disp = Dispatcher(plan, None,
                              config=ServeConfig(fault=REMOTE_FAULT))
            proxies = [RemoteWorkerProxy(
                f"w{i}", ("127.0.0.1", port), disp.registry,
                disp.result_queue,
                model_config={"model": "resnet50", "num_classes": 10,
                              "cuts": cuts},
                codec_name=codec, fault=REMOTE_FAULT, result_device=cuda)
                for i, port in enumerate(ports)]
            for p in proxies:
                disp.attach_worker(p)
            try:
                disp.start()
                for i, p in enumerate(proxies):
                    p.configure(i, None, host[i])
                n_q = TQ.quantize_blocks.launches
                n_d = TQ.dequantize_blocks.launches
                outs = disp.serve_stream(xs, timeout_per_request=120.0)
                torch.cuda.synchronize()
            finally:
                disp.shutdown()
            if codec == "int8dev":
                assert all(_rel_err(y, r) <= bar for y, r in zip(outs, refs))
                assert outs[0].is_cuda
                assert TQ.quantize_blocks.launches - n_q == 3 * len(xs)
                assert TQ.dequantize_blocks.launches - n_d == 3 * len(xs)
            else:
                assert all(torch.equal(y.to(cuda), r)
                           for y, r in zip(outs, refs))
    finally:
        _stop(procs)


@pytest.mark.gpu
def test_vit_over_worker_processes_equals_graph_apply_on_the_card(cuda):
    """Phase 13 (c) small: a 4-block ViT with head_dim 64 (K1's), bf16, in
    3 stages over 3 worker processes by value (``graph_spec``), codec
    ``none``: every output ``torch.equal`` to ``graph.apply`` on the card
    (K1 runs in the workers)."""
    from adapt_tpu_torch.comm.remote import RemoteWorkerProxy
    from adapt_tpu_torch.control.dispatcher import Dispatcher
    from adapt_tpu_torch.graph.spec import graph_to_spec

    graph = TV.vit(8, 128, 4, 2, 256, 10, torch.bfloat16, name="vit_hd64",
                   img_size=32, device=cuda, seed=1)
    cuts = TV.vit_block_cuts(4, 3)
    plan = partition(graph, cuts)
    gen = torch.Generator(device=cuda).manual_seed(2)
    xs = [torch.randn(4, 32, 32, 3, generator=gen, device=cuda)
          for _ in range(6)]
    with torch.no_grad():
        refs = [graph.apply(x) for x in xs]
    procs, ports = _worker_procs(3)
    disp = Dispatcher(plan, None, config=ServeConfig(fault=REMOTE_FAULT))
    for i, port in enumerate(ports):
        disp.attach_worker(RemoteWorkerProxy(
            f"v{i}", ("127.0.0.1", port), disp.registry, disp.result_queue,
            model_config={"graph_spec": graph_to_spec(graph), "cuts": cuts},
            fault=REMOTE_FAULT, result_device=cuda))
    try:
        disp.start()
        outs = disp.serve_stream(xs, timeout_per_request=120.0)
        assert all(torch.equal(y.to(cuda), r) for y, r in zip(outs, refs))
    finally:
        disp.shutdown()
        _stop(procs)
