#!/usr/bin/env python3
"""Device time of the decode-attention kernels of two trees, in turns, on one
CUDA card:

    python3 scripts/decode_ab.py OTHER_ROOT [OTHER_ROOT ...] [--full | --k6]

OTHER_ROOT is the root of another checkout of this repository (for example
``git archive <commit>`` unpacked into ``_checkout/``, which ``.gitignore``
lists). The script runs other, this, this, other (with several others:
each other in order, this twice, the others in reverse): each turn imports
that tree's ``adapt_tpu_torch`` (its kernels build into its own
``_kernels_build/``) and calls this tree's
``chip_smoke.decode_device_times``, which prints K2, K3, K2q and K3q (int8,
int4) at the steady-decode and phase 8 shapes beside the library's device
time under ``torch.profiler``; ``--full`` adds the splits, K4, K5 and K6
(quantize and dequantize at every 2-layer GPT-2 draft matrix, and one whole
``dequantize_params`` of the draft's tree); ``--k6`` times K6 alone.
The last line is one JSON object: ``{"card": ..., "turns": [{"tree": ...,
"ms": {key: ms}}, ...]}``.
"""

from __future__ import annotations

import importlib
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREES: set[str] = set()


def load_tree(root, libs=("decode_attn", "paged_attn")):
    """The (D, P, Q) ops modules of the ``adapt_tpu_torch`` under ``root``,
    with its kernel libraries ``libs`` built (all at once)."""
    for name in list(sys.modules):
        if name == "adapt_tpu_torch" or name.startswith("adapt_tpu_torch."):
            del sys.modules[name]
    sys.path[:] = [p for p in sys.path if p not in TREES]
    TREES.add(root)
    sys.path.insert(0, root)  # stays first until the next turn
    build = importlib.import_module("adapt_tpu_torch.ops._build")
    mods = [importlib.import_module(f"adapt_tpu_torch.ops.{m}") for m in
            ("decode_attention", "paged_attention", "quantize")]
    jobs = {n: build._start(n) for n in libs}
    for name, job in jobs.items():
        if job is not None:
            build._finish(name, job)
    return mods


def main(argv) -> int:
    import torch

    others = [os.path.abspath(a) for a in argv if not a.startswith("--")]
    if not others or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.append(HERE)
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(f"card: {card}")
    turns = []
    order = ([("other", r) for r in others] + [("this", HERE)] * 2
             + [("other", r) for r in reversed(others)])
    for label, root in order:
        print(f"-- {label}: {root}")
        D, P, Q = load_tree(root, ("quantize_blocks", "dequantize_blocks")
                            if "--k6" in argv else ("decode_attn",
                                                    "paged_attn"))
        if "--k6" in argv:
            ms = chip_smoke.device_times(
                torch, card, lambda rec, Q=Q: chip_smoke.k6_fns(torch, Q, rec))
        else:
            ms = chip_smoke.decode_device_times(torch, D, P, Q, card,
                                                full="--full" in argv)
        turns.append({"tree": label, "root": root,
                      "ms": {"/".join(k): v for k, v in ms.items()}})
    print(json.dumps({"card": card, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
