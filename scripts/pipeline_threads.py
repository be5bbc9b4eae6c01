#!/usr/bin/env python3
"""Host contention of eager PyTorch threads on one CUDA card: why
``LocalPipeline.stream`` runs the requests in the caller's thread when
every stage shares the card, and not a thread per stage.

    python3 scripts/pipeline_threads.py

Prints the card's name and power limit, then:

1. eager launch throughput: N threads (N = 1..4) each enqueue 4000 small
   kernels (an in-place add on a 1-element CUDA tensor of its own), the run
   ending in a synchronize; launches/s in total, beside one thread's;
2. the same at ``sys.setswitchinterval`` 0.5 ms and 50 ms (the default is
   5 ms): if the interpreter lock is handed over at every launch, the
   interval moves little;
3. ResNet-50 (conv7 stem, 1000 classes, batch 8, 224 x 224 x 3, bf16, 3
   stages at ``RESNET50_3STAGE_CUTS``) through ``LocalPipeline``: images/s
   of ``infer`` in a loop and of the thread-per-stage stream
   (``LocalPipeline._threaded_stream``, the path ``stream`` takes across
   devices) over 32 requests, in turns (infer, threads, threads, infer),
   at each switch interval.

The last line is one JSON object with every number. Needs one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launches_per_s(torch, dev, n_threads, per_thread=4000):
    xs = [torch.zeros(1, device=dev) for _ in range(n_threads)]
    start = threading.Barrier(n_threads + 1)

    def work(x):
        start.wait()
        for _ in range(per_thread):
            x.add_(1.0)

    threads = [threading.Thread(target=work, args=(x,)) for x in xs]
    for t in threads:
        t.start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.wait()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if any(int(x.item()) != per_thread for x in xs):
        raise AssertionError("a thread's launches went missing")
    return n_threads * per_thread / dt


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pipeline_threads: needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from adapt_tpu_torch.graph.partition import partition
    from adapt_tpu_torch.models.resnet import RESNET50_3STAGE_CUTS, resnet50
    from adapt_tpu_torch.runtime.pipeline import LocalPipeline

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    launches_per_s(torch, dev, 1, 200)  # warm up
    graph = resnet50(1000, torch.bfloat16, device=dev, seed=0)
    pipe = LocalPipeline(partition(graph, RESNET50_3STAGE_CUTS),
                         devices=[dev] * 3)
    gen = torch.Generator(device=dev).manual_seed(29)
    xs = [torch.randn(8, 224, 224, 3, generator=gen, device=dev)
          for _ in range(32)]
    pipe.warmup(xs[0])
    pipe._threaded_stream(xs[:4])

    def images_per_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 8 * len(xs) / (time.perf_counter() - t0)

    result = {"card": card}
    default = sys.getswitchinterval()
    try:
        for interval in (default, 0.0005, 0.05):
            sys.setswitchinterval(interval)
            rates = {n: launches_per_s(torch, dev, n) for n in (1, 2, 3, 4)}
            turns = [
                ("infer", images_per_s(lambda: [pipe.infer(x) for x in xs])),
                ("threads", images_per_s(lambda: pipe._threaded_stream(xs))),
                ("threads", images_per_s(lambda: pipe._threaded_stream(xs))),
                ("infer", images_per_s(lambda: [pipe.infer(x) for x in xs])),
            ]
            key = f"switch_{interval * 1e3:g}ms"
            result[key] = {"launches_per_s": rates, "resnet50_bf16": turns}
            print(f"switch interval {interval * 1e3:g} ms on {card}: eager "
                  "launches/s by threads " + ", ".join(
                      f"{n}: {r:.0f}" for n, r in rates.items())
                  + "; ResNet-50 bf16 batch 8 images/s in turns "
                  + ", ".join(f"{k} {v:.1f}" for k, v in turns))
    finally:
        sys.setswitchinterval(default)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
