#!/usr/bin/env python3
"""What the paged batcher costs with observability off, this checkout
against another, on one CUDA card, in turns.

    python3 scripts/obs_ab.py --other DIR [--rounds 2] [--runs 3]

``DIR`` holds another checkout of the repo (``git archive <commit>``
unpacked into a directory that ``.gitignore`` lists). Each turn is a
process of its own that imports ``chip_smoke`` and ``adapt_tpu_torch``
from one tree and serves phase 7's paged traffic (GPT-2-small widths,
bf16, random weights from seed 0) ``--runs`` times after a warm-up run,
with the batcher's defaults: observability off. Where the tree has a
capacity plane (on by default), each of its runs is followed by one with
``CapacityConfig(enabled=False)``. The turns go other, this, this, other,
``--rounds`` times. Prints every run's tok/s and the medians beside the
card's name and power limit; every run's streams must equal the first
run's, across both trees.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(tree: str, runs: int) -> int:
    """One turn: serve the traffic from ``tree``'s code; print one JSON
    line of tok/s by configuration and the streams' digest."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as CS
    from adapt_tpu_torch.config import KernelConfig
    from adapt_tpu_torch.ops import _build

    try:
        from adapt_tpu_torch.config import CapacityConfig
        configs = {"default": {},
                   "no_capacity": dict(capacity=CapacityConfig(
                       enabled=False))}
    except ImportError:
        configs = {"default": {}}
    built = _build.build_all()
    lm = CS.gpt2_small(torch)
    wave1, wave2, fan = CS.paged_traffic(torch, lm.vocab)
    rates: dict[str, list] = {k: [] for k in configs}
    digest = None
    for i in range(runs + 1):  # a warm-up run first
        for name, kw in configs.items():
            got = CS.drive_paged(torch, lm, KernelConfig(), (wave1, wave2),
                                 fan, 2, **kw)
            got[0].close()
            out = got[2]
            h = hashlib.sha256()
            for r in sorted(out):
                h.update(np.asarray(out[r], np.int64).tobytes())
            if digest is None:
                digest = h.hexdigest()
            elif h.hexdigest() != digest:
                raise AssertionError(f"a {name} run's streams differ")
            if i:
                rates[name].append(got[7] / got[6])
    print(json.dumps({"tree": tree, "build_s": built, "rates": rates,
                      "digest": digest}), flush=True)
    return 0


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--other", help="another checkout of the repo")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker:
        return worker(args.worker, args.runs)
    import torch

    if not torch.cuda.is_available():
        print("obs_ab: needs a CUDA card", file=sys.stderr)
        return 1
    if not args.other:
        p.error("--other DIR is required")
    sys.path.insert(0, ROOT)
    import chip_smoke as CS

    card = CS.card_line()
    other = os.path.abspath(args.other)
    trees = {"other": other, "this": ROOT}
    readings: dict[str, dict[str, list]] = {"other": {}, "this": {}}
    digests = set()
    from adapt_tpu_torch.ops import _build

    # Built once here; the other tree reuses these libraries where its
    # sources (and so the content-hashed names) agree.
    print(f"card: {card}; this tree's kernels built in "
          f"{_build.build_all():.1f} s", flush=True)
    dst = os.path.join(other, "adapt_tpu_torch", "_kernels_build")
    os.makedirs(dst, exist_ok=True)
    for f in os.listdir(_build.BUILD_DIR):
        if f.endswith(".so") and not os.path.exists(os.path.join(dst, f)):
            shutil.copy2(os.path.join(_build.BUILD_DIR, f), dst)
    for turn in ["other", "this", "this", "other"] * args.rounds:
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             trees[turn], "--runs", str(args.runs)],
            capture_output=True, text=True, cwd=trees[turn])
        if run.returncode != 0:
            print(run.stdout[-4000:], run.stderr[-8000:], file=sys.stderr)
            raise RuntimeError(f"the {turn} tree's turn failed")
        got = json.loads(run.stdout.strip().splitlines()[-1])
        digests.add(got["digest"])
        for name, rs in got["rates"].items():
            readings[turn].setdefault(name, []).extend(rs)
        print(f"{turn} on {card} (kernels built in {got['build_s']:.1f} s): "
              + "; ".join(f"{n} {[round(r, 1) for r in rs]} tok/s"
                          for n, rs in got["rates"].items()), flush=True)
    if len(digests) != 1:
        raise AssertionError(f"the trees' streams differ: {digests}")
    base = statistics.median(readings["other"]["default"])
    line = {f"{t}.{n}": statistics.median(rs)
            for t, by in readings.items() for n, rs in by.items()}
    print(f"obs_ab on {card}: medians (tok/s) {json.dumps(line)}; this / "
          f"other with defaults "
          f"{statistics.median(readings['this']['default']) / base:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
