#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 13 alone on one CUDA card: the pipeline across
worker processes, with what it needs before it and nothing else.

    python3 scripts/remote_phase.py

Builds the kernels, runs ``chip_smoke.check_k6`` (K6 against its plain
version, the two ResNet-50 hop shapes included), then
``chip_smoke.remote_phase`` on ``chip_smoke.remote_cases`` with TF32 off,
and prints phase 13's lines and the K1 / K6 rows' phase-13 fields as JSON.
Every gate of phase 13 is kept; a failure exits non-zero. Phase 12 does not
run, so its in-process rate prints as nan.
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
    from adapt_tpu_torch.ops import quantize as Q

    if not torch.cuda.is_available():
        print("remote_phase: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = CS.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(f"kernels built in {_build.build_all():.1f} s", flush=True)
    CS.check_k6(torch, Q, dev, {})
    kernels = [dict(name=n) for n in ("quantize_blocks", "dequantize_blocks",
                                      "flash_attn_fwd")]
    CS.remote_phase(torch, A, Q, dev, card, kernels, ROOT, float("nan"),
                    CS.remote_cases(torch, dev))
    print(json.dumps(kernels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
