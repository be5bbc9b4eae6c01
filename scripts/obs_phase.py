#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 15 alone on one CUDA card: the MoE decoder at
GPT-2-small widths, engine observability on the paged path, and worker
telemetry, with what it needs before it and nothing else.

    python3 scripts/obs_phase.py

Builds the kernels and the GPT-2-small-width model, then runs
``chip_smoke.obs_phase``: (a) the MoE LM through ``generate()``, one
decode step's batch invariance and the dense, paged and int8 paged
batchers; (b) phase 7's paged traffic with every observability surface
off, then on under a scraping thread; (c) ResNet-50 over three worker
processes pushing telemetry, one of them SIGKILLed. Every gate of phase 15
is kept; a failure exits non-zero. Prints the kernels' phase-15 launch
counts as JSON.
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
    from adapt_tpu_torch.ops import paged_attention as P

    if not torch.cuda.is_available():
        print("obs_phase: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = CS.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(f"kernels built in {_build.build_all():.1f} s", flush=True)
    lm = CS.gpt2_small(torch)
    ragged, lens, prompts = CS.dense_traffic(torch, lm.vocab)
    wave1, wave2, fan = CS.paged_traffic(torch, lm.vocab)
    kernels = [dict(name=n) for n in (
        "flash_attn_fwd", "decode_attn", "paged_attn", "paged_chunk_attn",
        "paged_attn[int8]", "paged_chunk_attn[int8]")]
    CS.obs_phase(torch, A, D, P, lm, card, kernels, ROOT, ragged, lens,
                 prompts, (wave1, wave2), fan)
    print(json.dumps(kernels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
