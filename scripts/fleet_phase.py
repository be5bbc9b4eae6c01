#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 16 alone on one CUDA card: fault-tolerant
pipelined decode, disaggregated prefill and the host KV tier at
GPT-2-small widths, with what it needs before it and nothing else.

    python3 scripts/fleet_phase.py

Builds the kernels and the GPT-2-small-width model, then runs
``chip_smoke.fleet_phase``: (a) ``PipelinedDecoder`` over three stage
workers and a spare, native and int8 stage caches, with a crash and a hang
mid-decode; (b) ``DisaggServer`` on phase 7's paged traffic, native, int8
and speculative, beside the same batcher collocated, the handed-off pages
and a corrupted frame; (c) the host KV tier on that traffic served twice,
lossless and with a cold int8 codec. Every gate of phase 16 is kept; a
failure exits non-zero. Prints the kernels' phase-16 launch counts as
JSON.
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
        print("fleet_phase: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = CS.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(f"kernels built in {_build.build_all():.1f} s", flush=True)
    lm = CS.gpt2_small(torch)
    solo, _ = CS.reference_streams(torch, lm)
    wave1, wave2, _ = CS.paged_traffic(torch, lm.vocab)
    kernels = [dict(name=n) for n in (
        "flash_attn_fwd", "decode_attn", "decode_attn[int8]", "paged_attn",
        "paged_chunk_attn", "paged_attn[int8]", "paged_chunk_attn[int8]",
        "paged_verify_attn")]
    CS.fleet_phase(torch, A, D, P, lm, card, kernels, solo, (wave1, wave2))
    print(json.dumps(kernels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
