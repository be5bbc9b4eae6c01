"""The multichip dry run of the port: the counterpart of
``__graft_entry__.py``'s ``dryrun_multichip(n)``.

On a mesh of ``n`` entries (by default the CUDA card named ``n`` times; one
process drives every entry, as in ``parallel/``) it runs, at tiny shapes:

- a dp x tp ViT forward (tp 2) against the unsharded graph's logits;
- one pipelined ViT train step over a dp x pp mesh (pp the largest of 4,
  2, 1 dividing both ``n`` and the depth), the blocks placed by
  ``vit_shardings``, with a finite loss;
- causal ring attention over an sp ring of ``n`` ranks, its plain-op and
  its K1 blocks, against full attention.

The reference runs ``vit_tiny`` and head_dim 8 rings; K1 and K7 serve
head_dim 64 and 128, so the ViT here is ``vit_tiny``'s depth, patch and
image with 2 heads of 64 (model dim 128), and the ring's heads are 64
wide.

    python -m adapt_tpu_torch.dryrun 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import math
import sys

import torch

from adapt_tpu_torch.core.mesh import MeshSpec, build_mesh, device_list


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the checks on ``n_devices`` mesh entries (``devices``: a list
    of at least that many, default the card repeated); raise on a failed
    one. Returns the mesh, the train loss and the largest errors."""
    from adapt_tpu_torch.models.vit import shard_vit, vit
    from adapt_tpu_torch.parallel.ring_attention import (
        full_attention,
        ring_attention,
    )
    from adapt_tpu_torch.parallel.train import (
        make_pipelined_vit_apply,
        make_train_step,
        place_vit,
        split_vit_variables,
        vit_shardings,
    )

    devs = device_list(devices) if devices is not None else None
    if devs is not None and len(devs) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devs)}")
    depth = 4
    pp = next(c for c in (4, 2, 1) if n_devices % c == 0 and depth % c == 0)
    dp = n_devices // pp
    mesh = build_mesh(MeshSpec((("dp", dp), ("pp", pp))), devs)
    lead = mesh.devices.flat[0]
    graph = vit(4, 128, depth, 2, 256, num_classes=10, name="vit_tiny_hd64",
                img_size=32, device=lead)

    x = torch.ones(dp * 2, 32, 32, 3, device=lead)  # 2 rows a dp shard
    y = torch.zeros(dp * 2, dtype=torch.int64, device=lead)
    out = {"mesh": dict(mesh.shape)}

    # ---- dp x tp forward, before the step updates the weights in place ---
    if n_devices >= 2:
        tp = 2
        tp_mesh = build_mesh(MeshSpec((("dp", n_devices // tp), ("tp", tp))),
                             devs)
        with torch.no_grad():
            ref = graph.apply(x)
            logits = shard_vit(graph, tp_mesh)(x)
        err = float((logits - ref).abs().max())
        if not err <= 1e-4 * max(float(ref.abs().max()), 1.0):
            raise AssertionError(f"tp forward differs by {err}")
        out["tp_err"] = err

    # ---- dp x pp pipelined training step ---------------------------------
    params = split_vit_variables(graph, depth)
    params = place_vit(params, vit_shardings(params, mesh))
    step = make_train_step(make_pipelined_vit_apply(graph, mesh, 2),
                           functools.partial(torch.optim.SGD, lr=1e-3))
    _, _, loss = step(params, None, x, y)
    out["loss"] = float(loss)
    if not math.isfinite(out["loss"]):
        raise AssertionError(f"non-finite loss {out['loss']}")

    # ---- sp ring attention -------------------------------------------------
    sp_mesh = build_mesh(MeshSpec((("sp", n_devices),)), devs)
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(2, 2, 8 * n_devices, 64, generator=gen).to(lead)
    ref = full_attention(q, q, q, causal=True)
    for impl in ("jnp", "flash"):
        got = ring_attention(q, q, q, sp_mesh, axis="sp", causal=True,
                             block_impl=impl)
        err = float((got - ref).abs().max())
        if not err <= 2e-4 + 2e-4 * float(ref.abs().max()):
            raise AssertionError(f"ring attention [{impl}] differs by {err}")
        out[f"ring_{impl}_err"] = err
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=4)
    ap.add_argument("--device", default=None,
                    help="the device every entry names (default: the card)")
    args = ap.parse_args(argv)
    devices = None if args.device is None else [args.device] * args.n
    print(dryrun_multichip(args.n, devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
