#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 20 alone on one CUDA card: sequence
parallelism (rings of 2 and 4 ranks naming the card), with what it needs
before it and nothing else.

    python3 scripts/sp_phase.py

Builds the kernels and the GPT-2-small-width model, measures phase 9's
int8 tie-aware bar and phase 18's precision bar (2 x e1, from an f32 copy
of the weights, with the tp=2 shards that (d) serves), checks K1 (phase
2, the ``causal_shift`` cases included), then runs ``chip_smoke.sp_phase``:
(a) ring attention and Ulysses, (b) the sp batcher, (c) the prefill tier,
(d) sp x tp recovery. Every gate of phase 20 is kept; a failure exits
non-zero. Prints the kernels' phase-20 launch counts as JSON.
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

    if not torch.cuda.is_available():
        print("sp_phase: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = CS.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(f"kernels built in {_build.build_all():.1f} s", flush=True)
    errs: dict = {}
    CS.check_k1(torch, A, torch.device("cuda", 0), errs)
    lm = CS.gpt2_small(torch)
    _, _, prompts = CS.dense_traffic(torch, lm.vocab)
    wave1, wave2, _ = CS.paged_traffic(torch, lm.vocab)
    hit_err, chunk_err = CS.quantized_pass_error(
        torch, lm, "int8", [wave1[0]] + list(wave2[:7]), list(wave1[5:8])
        + list(wave2[7:]))
    qbar = max(0.1, 2 * max(hit_err, chunk_err))
    print(f"int8 tie-aware bar {qbar:.4f} (prefix hit {hit_err:.4f}, "
          f"chunked {chunk_err:.4f})", flush=True)
    lm32 = CS.f32_copy(torch, lm)
    slm2 = shard_lm(lm, build_mesh(MeshSpec((("tp", 2),)), [lm.device] * 2))
    pwaves = CS.tp_paged_waves((wave1, wave2))
    bar = 2 * CS.tp_precision(torch, lm, lm32, {2: slm2},
                              [pwaves[0][0], prompts[0]])
    kernels = [dict(name=n) for n in (
        "flash_attn_fwd", "paged_attn", "paged_chunk_attn",
        "paged_attn[int8]", "paged_chunk_attn[int8]")]
    CS.sp_phase(torch, A, lm, lm32, slm2, card, kernels, (wave1, wave2), bar,
                qbar)
    print(json.dumps(kernels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
