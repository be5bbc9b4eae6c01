#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 14 alone on one CUDA card: traffic control and
the pipelined tick, with what it needs before it and nothing else.

    python3 scripts/sched_phase.py

Builds the kernels and the GPT-2-small-width model (and its 2-layer draft),
measures the speculative int8 path's tie-aware bar as phases 9 and 10 do
(the verify pass against the decode step, and the prefix-hit and chunked
passes against the whole prompt, on int8 pools), then runs
``chip_smoke.sched_phase``: (a) preemption, (b) the degradation ladder
under speculation, (c) depth 2 against depth 1 on phase 6's and phase 7's
traffic and a steady depth-2 tick, (d) the depth 1 / depth 2 readings.
Every gate of phase 14 is kept; a failure exits non-zero. Prints the
kernels' phase-14 launch counts as JSON.
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
    from adapt_tpu_torch.ops import quantize as Q

    if not torch.cuda.is_available():
        print("sched_phase: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = CS.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(f"kernels built in {_build.build_all():.1f} s", flush=True)
    lm = CS.gpt2_small(torch)
    draft2 = CS.truncated_draft(torch, lm)
    solo, solo_gaps = CS.reference_streams(torch, lm)
    _, _, prompts = CS.dense_traffic(torch, lm.vocab)
    wave1, wave2, fan = CS.paged_traffic(torch, lm.vocab)
    verr = CS.verify_pass_error(torch, lm, draft2, prompts[:8], "paged",
                                "int8")
    hit_err, chunk_err = CS.quantized_pass_error(
        torch, lm, "int8", [wave1[0]] + list(wave2[:7]),
        list(wave1[5:8]) + list(wave2[7:]))
    bar = max(0.1, 2 * verr, 2 * hit_err, 2 * chunk_err)
    print(f"int8 paged speculative tie-aware bar {bar:.4f} (verify pass "
          f"{verr:.4f}, prefix hit {hit_err:.4f}, chunked {chunk_err:.4f})",
          flush=True)
    kernels = [dict(name=n) for n in (
        "flash_attn_fwd", "decode_attn", "paged_attn", "paged_chunk_attn",
        "paged_attn[int8]", "paged_chunk_attn[int8]",
        "paged_verify_attn[int8]", "quantize_blocks", "dequantize_blocks")]
    CS.sched_phase(torch, A, D, P, Q, lm, draft2, card, kernels, solo,
                   solo_gaps, prompts, (wave1, wave2), fan, bar)
    print(json.dumps(kernels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
