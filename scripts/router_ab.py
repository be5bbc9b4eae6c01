#!/usr/bin/env python3
"""Placement policies side by side on one CUDA card: phase 17 (b)'s
recurring-prefix traffic (``chip_smoke.affinity_traffic``: 6 prefixes of
384 tokens, each 4 times with a unique tail, 3 waves of 8, 32 new tokens)
through fresh two-replica fleets of phase 7's paged batcher, in turns:

- ``affinity``: ``FleetRouter(policy="affinity")`` as the port ranks;
- ``forecast``: the same, but ranking on the replicas' TTFT forecasts
  whatever they have learned, as the JAX package's router does
  (``FleetRouter._priced`` always true);
- ``random``: ``policy="random"``, seed 0.

    python3 scripts/router_ab.py [--reps N] [--trained]

``--trained`` first serves the traffic once through each fleet, evicts
the cached prefix pages and measures a second pass, as the JAX package's
``benchmarks/load/router_smoke.py`` does. Prints, per arm and turn, the
fleet's prefix hits, TTFT p50, tok/s, the replica each request went to
and its admission path (c chunked, h hit, w whole).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as CS
    from adapt_tpu_torch.config import RouterConfig
    from adapt_tpu_torch.ops import _build
    from adapt_tpu_torch.runtime.router import FleetRouter
    from adapt_tpu_torch.utils.metrics import global_metrics

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--trained", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("router_ab: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = CS.card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    print(f"kernels built in {_build.build_all():.1f} s", flush=True)
    lm = CS.gpt2_small(torch)
    waves = CS.affinity_traffic(torch, lm.vocab)

    class ForecastRanked(FleetRouter):
        """Ranks on the forecasts from their first sample, as the JAX
        router does."""

        @staticmethod
        def _priced(books):
            return True

    arms = (("affinity", FleetRouter), ("forecast", ForecastRanked),
            ("random", FleetRouter))
    reg = global_metrics()
    for rep in range(args.reps):
        for arm, cls in arms:
            policy = "random" if arm == "random" else "affinity"
            router = cls({"r0": CS.router_replica(lm),
                          "r1": CS.router_replica(lm)},
                         config=RouterConfig(policy=policy), seed=0)
            run = CS.FleetRun(router)
            if args.trained:
                CS.serve_waves(router, waves, 32, run.on_token)
                for r in router._replicas.values():
                    r.engine._pager.evict_cached()
            hits0 = router.stats()["prefix_hits"]
            n0 = len(router.placements()["decisions"])
            before = reg.snapshot(window=True)
            t0 = time.perf_counter()
            prompts, out, _ = CS.serve_waves(router, waves, 32)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ttft = reg.snapshot(since=before)["histograms"].get(
                "continuous.ttft_s", {})
            dec = router.placements()["decisions"][n0:]
            where = "".join(d["replica"][1:] for d in dec)
            paths = "".join(run.path(d["sid"])[0] for d in dec)
            ntok = sum(len(v) for v in out.values())
            print(f"turn {rep} {'trained' if args.trained else 'fresh'} "
                  f"{arm} on {card}: prefix hits "
                  f"{router.stats()['prefix_hits'] - hits0}, TTFT p50 "
                  f"{ttft.get('p50', float('nan')):.4f} s, "
                  f"{ntok / wall:.1f} tok/s, replicas {where}, paths "
                  f"{paths}", flush=True)
            router.close(close_engines=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
