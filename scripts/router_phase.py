#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 17 alone on one CUDA card: the fleet router
and autoscaler over replicas sharing the card, at GPT-2-small widths, with
what it needs before it and nothing else.

    python3 scripts/router_phase.py

Builds the kernels and the GPT-2-small-width model, measures phase 9's
int8 tie-aware bar (the first-token logit error of a prefix-hit and a
chunked pass on int8 pools), then runs ``chip_smoke.router_phase``: (a)
phase 7's traffic through ``FleetRouter`` over two replicas; (b) recurring
prefixes under the affinity and the random policy; (c) one of three
replicas' leases deregistered mid-load; (d) the synchronous shed and the
autoscaler up and down; (e) a prefill tier feeding two replicas, native
and int8. Every gate of phase 17 is kept; a failure exits non-zero. Prints
the kernels' phase-17 launch counts as JSON.
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
        print("router_phase: needs a CUDA card", file=sys.stderr)
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
    hit_err, chunk_err = CS.quantized_pass_error(
        torch, lm, "int8", [wave1[0]] + list(wave2[:7]), list(wave1[5:8])
        + list(wave2[7:]))
    qbar = max(0.1, 2 * max(hit_err, chunk_err))
    print(f"int8 tie-aware bar {qbar:.4f} (prefix hit {hit_err:.4f}, "
          f"chunked {chunk_err:.4f})", flush=True)
    kernels = [dict(name=n) for n in (
        "flash_attn_fwd", "decode_attn", "decode_attn[int8]", "paged_attn",
        "paged_chunk_attn", "paged_attn[int8]", "paged_chunk_attn[int8]",
        "paged_verify_attn")]
    CS.router_phase(torch, A, D, P, lm, card, kernels, solo, (wave1, wave2),
                    qbar)
    print(json.dumps(kernels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
