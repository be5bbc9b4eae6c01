#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 18 alone on one CUDA card: tensor-parallel
serving as tp shards of GPT-2-small on the one card, with what it needs
before it and nothing else.

    python3 scripts/tp_phase.py

Builds the kernels, the GPT-2-small-width model and its 2-layer draft,
measures phase 9's int8 tie-aware bar, then runs ``chip_smoke.tp_phase``:
(a) dense and paged traffic at tp=1, 2 and 4 (streams held to tp=1's,
launches tp x tp=1's, per-shard bytes); (b) an int8 pool and int8
speculation at tp=2; (c) a steady tp=2 tick; (d) the host tier and a
router's prefill tier at tp=2; (e) K1-K5 at the shards' head counts. Every
gate of phase 18 is kept; a failure exits non-zero. Prints the kernels'
phase-18 launch counts as JSON.
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
        print("tp_phase: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = CS.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(f"kernels built in {_build.build_all():.1f} s", flush=True)
    lm = CS.gpt2_small(torch)
    draft2 = CS.truncated_draft(torch, lm)
    solo, _ = CS.reference_streams(torch, lm)
    _, _, prompts = CS.dense_traffic(torch, lm.vocab)
    wave1, wave2, _ = CS.paged_traffic(torch, lm.vocab)
    hit_err, chunk_err = CS.quantized_pass_error(
        torch, lm, "int8", [wave1[0]] + list(wave2[:7]), list(wave1[5:8])
        + list(wave2[7:]))
    qbar = max(0.1, 2 * max(hit_err, chunk_err))
    print(f"int8 tie-aware bar {qbar:.4f} (prefix hit {hit_err:.4f}, "
          f"chunked {chunk_err:.4f})", flush=True)
    kernels = [dict(name=n) for n in (
        "flash_attn_fwd", "decode_attn", "paged_attn", "paged_chunk_attn",
        "paged_attn[int8]", "paged_chunk_attn[int8]",
        "paged_verify_attn[int8]")]
    CS.tp_phase(torch, A, D, P, Q, lm, draft2, card, kernels, solo, prompts,
                (wave1, wave2), qbar)
    print(json.dumps(kernels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
