#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 19 alone on one CUDA card: elastic recovery of
the tensor-parallel batcher (tp=4 shards of GPT-2-small on the one card),
with what it needs before it and nothing else.

    python3 scripts/rec_phase.py

Builds the kernels, the GPT-2-small-width model and its 2-layer draft,
measures phase 9's int8 tie-aware bar and phase 18's precision bar (2 x
e1, from an f32 copy of the weights), then runs
``chip_smoke.recovery_phase``: (a) a member killed mid-stream on dense
strips and a paged pool (the lead too), live KV migrated to tp=2; (b) an
int8 pool with int8 speculation; (c) replay from a journal; (d) a triple
kill to a tp=1 remnant. Every gate of phase 19 is kept; a failure exits
non-zero. Prints the kernels' phase-19 launch counts as JSON.
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
    from adapt_tpu_torch.core.mesh import MeshSpec, build_mesh
    from adapt_tpu_torch.models.transformer_lm import shard_lm
    from adapt_tpu_torch.ops import _build
    from adapt_tpu_torch.ops import attention as A
    from adapt_tpu_torch.ops import decode_attention as D
    from adapt_tpu_torch.ops import paged_attention as P
    from adapt_tpu_torch.ops import quantize as Q

    if not torch.cuda.is_available():
        print("rec_phase: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = CS.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(f"kernels built in {_build.build_all():.1f} s", flush=True)
    lm = CS.gpt2_small(torch)
    draft2 = CS.truncated_draft(torch, lm)
    _, _, prompts = CS.dense_traffic(torch, lm.vocab)
    wave1, wave2, _ = CS.paged_traffic(torch, lm.vocab)
    hit_err, chunk_err = CS.quantized_pass_error(
        torch, lm, "int8", [wave1[0]] + list(wave2[:7]), list(wave1[5:8])
        + list(wave2[7:]))
    qbar = max(0.1, 2 * max(hit_err, chunk_err))
    print(f"int8 tie-aware bar {qbar:.4f} (prefix hit {hit_err:.4f}, "
          f"chunked {chunk_err:.4f})", flush=True)
    lm32 = CS.f32_copy(torch, lm)
    slm4 = shard_lm(lm, build_mesh(MeshSpec((("tp", 4),)), [lm.device] * 4))
    pwaves = CS.tp_paged_waves((wave1, wave2))
    bar = 2 * CS.tp_precision(torch, lm, lm32, {4: slm4},
                              [pwaves[0][0], prompts[0]])
    kernels = [dict(name=n) for n in (
        "flash_attn_fwd", "decode_attn", "paged_attn", "paged_chunk_attn",
        "paged_chunk_attn[int8]", "paged_verify_attn[int8]",
        "dequantize_blocks")]
    CS.recovery_phase(torch, A, D, P, Q, lm, draft2, lm32, slm4, card,
                      kernels, prompts, bar, qbar)
    print(json.dumps(kernels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
