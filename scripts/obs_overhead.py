#!/usr/bin/env python3
"""What engine observability costs the paged batcher on one CUDA card, in
turns: phase 7's paged traffic (GPT-2-small widths, bf16, random weights
from seed 0) served with every observability surface off, on but
unscraped, and on with ``serve_metrics`` scraped every ~50 ms by a second
thread, ``--rounds`` times in the order off, unscraped, scraped, scraped,
unscraped, off.

    python3 scripts/obs_overhead.py [--rounds 2]

Prints tok/s of every run and, per mode, the median over the off runs'
median, beside the card's name and power limit; streams of every run must
equal the first off run's.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as CS
    from adapt_tpu_torch.config import (
        CapacityConfig,
        KernelConfig,
        ObservabilityConfig,
    )
    from adapt_tpu_torch.ops import _build
    from adapt_tpu_torch.utils.exporter import serve_metrics
    from adapt_tpu_torch.utils.profiling import global_engine_obs
    from adapt_tpu_torch.utils.tracing import global_tracer

    p = argparse.ArgumentParser()
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("obs_overhead: needs a CUDA card", file=sys.stderr)
        return 1
    card = CS.card_line()
    print(f"card: {card}; kernels built in {_build.build_all():.1f} s",
          flush=True)
    lm = CS.gpt2_small(torch)
    wave1, wave2, fan = CS.paged_traffic(torch, lm.vocab)
    eo, tracer = global_engine_obs(), global_tracer()
    on = dict(capacity=CapacityConfig(refresh_s=0.05),
              observability=ObservabilityConfig(obs_engine=True,
                                                trace_enabled=True))
    rates: dict[str, list] = {"off": [], "unscraped": [], "scraped": []}
    first = None
    order = ("off", "unscraped", "scraped", "scraped", "unscraped", "off")
    for mode in ["off"] + list(order) * args.rounds:  # a warm-up run first
        kw = (dict(capacity=CapacityConfig(enabled=False)) if mode == "off"
              else on)
        server = scraper = None
        if mode == "scraped":
            server = serve_metrics(port=0)
            scraper = CS.Scraper(server.server_address[1])
        try:
            got = CS.drive_paged(torch, lm, KernelConfig(), (wave1, wave2),
                                 fan, 2, **kw)
        finally:
            if scraper is not None:
                scraper.stop()
                server.shutdown()
                server.server_close()
            eo.enabled = tracer.enabled = False
        got[0].close()
        out = got[2]
        if first is None:
            first = out
            continue  # the warm-up run is not counted
        if set(out) != set(first) or any(
                not np.array_equal(out[r], first[r]) for r in first):
            raise AssertionError(f"a {mode} run's streams differ")
        rate = got[7] / got[6]
        rates[mode].append(rate)
        print(f"{mode} on {card}: {rate:.1f} tok/s", flush=True)
    base = statistics.median(rates["off"])
    print(f"obs overhead on {card}, medians over {args.rounds} rounds: off "
          f"{base:.1f} tok/s; unscraped / off "
          f"{statistics.median(rates['unscraped']) / base:.3f}; scraped "
          f"every 50 ms / off {statistics.median(rates['scraped']) / base:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
