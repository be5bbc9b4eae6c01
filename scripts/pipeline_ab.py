#!/usr/bin/env python3
"""Phase 12's LocalPipelines of two trees, in turns, on one CUDA card:

    python3 scripts/pipeline_ab.py OTHER_ROOT

OTHER_ROOT is the root of another checkout of this repository (for example
``git archive <commit>`` unpacked into ``_checkout/``, which ``.gitignore``
lists). The script runs other, this, this, other: each turn imports that
tree's ``adapt_tpu_torch`` (K1 builds into its own ``_kernels_build/``) and
calls this tree's ``chip_smoke.pipeline_phase`` on
``chip_smoke.pipeline_cases`` without the graft scenario, TF32 off: ResNet-50
and EfficientNet-B4 in f32 and bf16, ViT-B/16 in bf16, 32 requests each,
every gate of phase 12 kept. Each turn prints images/s of ``graph.apply``,
``infer`` and ``stream`` and the card's busy share under ``infer``.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "scripts"))

from decode_ab import load_tree  # noqa: E402


def main(argv) -> int:
    import torch

    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[0])
    sys.path.append(HERE)
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    for label, root in [("other", other), ("this", HERE), ("this", HERE),
                        ("other", other)]:
        print(f"-- {label}: {root}", flush=True)
        load_tree(root, ("flash_attn_fwd",))
        import adapt_tpu_torch.ops.attention as A

        cases, _ = chip_smoke.pipeline_cases(torch, dev)
        chip_smoke.pipeline_phase(torch, A, dev, card, [], cases, None)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
