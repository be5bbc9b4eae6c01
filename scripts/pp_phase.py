#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 21 alone on one CUDA card: the multi-rank
pipelines (meshes naming the card), with what it needs before it and
nothing else.

    python3 scripts/pp_phase.py

Builds the kernels and the GPT-2-small-width model, checks K1 and K2
against their plain versions (phases 2-3), then runs
``chip_smoke.pp_phase``: (a) ``pipelined_generate`` at pp 2 / 4, native,
int8 and int4, and (dp 2, pp 2) against ``generate()``, (b) the ViT-B/16
train step over (dp 2, pp 2), (c) ``shard_vit`` at (dp 2, tp 2), (d)
``dryrun_multichip(4)``. Every gate of phase 21 is kept; a failure exits
non-zero. Prints the kernels' phase-21 launch counts as JSON.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as CS
    from adapt_tpu_torch.ops import _build
    from adapt_tpu_torch.ops import attention as A
    from adapt_tpu_torch.ops import decode_attention as D

    if not torch.cuda.is_available():
        print("pp_phase: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = CS.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(f"kernels built in {_build.build_all():.1f} s", flush=True)
    errs: dict = {}
    dev = torch.device("cuda", 0)
    CS.check_k1(torch, A, dev, errs)
    CS.check_k2(torch, D, dev, errs)
    lm = CS.gpt2_small(torch)
    _, _, prompts = CS.dense_traffic(torch, lm.vocab)
    kernels = [dict(name=n) for n in (
        "flash_attn_fwd", "decode_attn", "decode_attn[int8]",
        "decode_attn[int4]", "flash_attn_bwd")]
    CS.pp_phase(torch, A, D, lm, card, kernels, prompts[:8])
    print(json.dumps(kernels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
