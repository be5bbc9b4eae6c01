#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``adapt_tpu_torch``).

    python3 chip_smoke.py            # the whole check, one CUDA card
    python3 chip_smoke.py --profile  # and torch.profiler breakdowns: one
                                     # ViT-B/16 train step and SDPA's
                                     # forward + backward; decode (dense
                                     # strips and paged pool, native and
                                     # int8 caches, native at split 4); a
                                     # chunked paged prefill; two
                                     # speculative ticks (K4 / K5's share
                                     # of kernel time)

K1, K7, K4 and K5 run on the tensor cores for bf16 / f16 and on the CUDA
cores for f32; K2 / K3 (and K2q / K3q) spread each row, and their splits
each (row, split), over a cluster of 8 blocks, the splits combined inside
the launch; K5 / K5-split (and K5q) keep that partition. Phase 1 prints the
compiler's registers and spills of the tensor-core kernels and of the
cluster kernels' instantiations; after phase
11 the device time per launch (``torch.profiler``) of K1 / K7 beside SDPA's,
of K2 / K3 / K2q / K3q at the steady-decode and phase 8 shapes beside
(gather +) masked SDPA, of K2-split / K3-split (and q) at phase 8's shape,
of K4 / K4q beside a gather + masked SDPA at phase
8's chunk shape, of K5 / K5q / K5-split beside a gather + masked SDPA at
phase 10's verify shape, of K6 quantize / dequantize at every draft matrix
shape and of one whole grouped ``dequantize_params`` of the draft's tree,
and of K2 against K2-split (split 2, 4, 8)
on b1 strips of 1025, 4097 and 16385 keys, is measured and
written into the kernels' JSON line as ``device_ms`` (and
``steady_device_ms``) / ``library_device_ms``. ``scripts/decode_ab.py``
times another commit's decode kernels against this one's in turns.

Phases (no phase failure is caught; any mismatch exits non-zero):

1. the card's name and power limit, torch/CUDA versions; build every
   kernel from ``adapt_tpu_torch/csrc`` (one nvcc per source, in parallel);
2. K1 (``flash_attn_fwd``) against its plain version in bf16 at the
   prefill shapes of the main path, plus ragged, ``valid_from``, window and
   head_dim-128 cases;
3. K2 (``decode_attn``) and K2-split (``decode_attn_split``, split 4)
   against the plain version on the batcher's dense strip (L = 1025), plus
   GQA and ``valid_from`` cases, and split 1 against split 4; then with
   ``torch.equal``: K2 on strips of 1024, 1025, 1029 and 1031, each row
   alone against the same row in a batch of 8, a second run against the
   first, the dead row zeros; K2-split at split 1 against K2, each row
   alone against the batch at split 4, second runs at splits 4 and 16;
4. K3 (``paged_attn``) and K3-split (``paged_attn_split``, split 4)
   against the plain version at the paged path's shapes (8 slots, 12 kv
   heads, page 128, 8 pages a slot, a 65-page pool, shuffled tables, one
   dead row), plus GQA, ``valid_from``, page-16 and head_dim-128 cases, and
   K3 against K2 with ``torch.equal`` on the same K/V as dense strips of
   1024, 1025, 1029 and 1031; K3-split's equalities as K2-split's, and
   K3-split against K2-split on the same K/V as a strip of 1024 (pages 128
   and 16, split 4);
5. K4 (``paged_chunk_attn``) against its plain version at C in {128,
   256}, pos0 in {0, 256, 512}, the window padded to a power of two with
   trash pages, plus window and GQA cases; at C 256 its rows equal to a
   causal K1 pass over the window as a dense strip with ``torch.equal``;
6. GPT-2-small widths (50257 / 768 / 12 layers / 12 heads / 3072, learned
   positions, max_len 1024, bf16, random weights from seed 0):
   ``generate()`` on 4 ragged prompts, then a ``ContinuousBatcher(slots=8,
   chunk=8)`` answering 16 requests (prompts 16-512, 64 new tokens, two
   staggered waves, one cancel), then the same batcher with
   ``KernelConfig(decode_split=4)`` on 8 requests; every stream must equal
   the port's own ``generate()`` for that prompt alone;
7. the same model through ``ContinuousBatcher(kv_layout="paged",
   page_size=128, prefill_chunk=256)``: 16 requests (8 sharing a 384-token
   prefix, 4 short unique, 4 long enough to be chunked; two staggered waves,
   one cancel) and a greedy ``submit_fanout`` of 4, then the paged batcher
   with ``decode_split=4`` on 8 requests. Whole-prompt admissions must equal
   ``generate()``; prefix-hit, chunked and split streams pass a tie-aware
   check; fan-out siblings equal each other; the pool drains. Launch
   counts are set to 0 just before each batcher path and read just after;
8. each kernel timed at its main-path shape with CUDA events, beside its
   plain version, one PyTorch library call of the same function
   (``scaled_dot_product_attention``, after a gather of the pages for the
   paged kernels; the port never calls either) and its bound:
   max(operations / 989 TFLOP/s, bytes / 3.35 TB/s);
9. the quantized branches (int8 and packed int4 K/V with one f32 scale per
   vector): K2q / K2q-split, K3q / K3q-split and K4q against their plain
   versions at the shapes of phases 3-5 (K3q equal to K2q with
   ``torch.equal`` on the four strip lengths; phase 3's K2 invariances for
   K2q; phases 3 and 4's split equalities for K2q / K3q-split); the dense
   batcher with ``kv_cache_dtype="int8"`` then
   ``"int4"`` on 8 of phase 6's prompts (two staggered waves of 4, one
   cancel), every stream equal to ``generate(kv_cache_dtype=...)``; phase 7's
   paged traffic with ``"int8"``, whose prefix-hit and chunked streams pass
   the tie-aware check at a bar set from the measured first-token logit
   error of a hit and a chunked pass; the paged batcher with ``"int4"`` on 8
   unique whole-prompt requests, streams exact; every path's launch counts,
   drained pool, ``cache_bytes_ratio`` ((hd + 4) / (2 hd) for int8, (hd / 2
   + 4) / (2 hd) for int4, exactly) and top-1 agreement with the native
   streams (printed, not gated); K2q and K3q (int8, int4) and K4q (int8)
   timed, their bound from the quantized bytes, no library call (none takes
   int8 K/V with per-vector scales; a dequantize + SDPA time is printed as a
   two-call figure); the branches no path launches (the splits, K4q on
   int4) timed on lines of their own;
10. speculative decoding: K5 / K5-split (``paged_verify_attn``, native,
   int8 and int4 pools; window, tree leaves, GQA row tiling, page 16,
   head_dim 128, a dead slot in every case, split 1 equal to the unsplit
   kernel with ``torch.equal``) and K6 (``quantize_blocks`` /
   ``dequantize_blocks``, ``torch.equal`` to the plain version at every
   draft matrix shape, ragged, all-zero and NaN / +-Inf blocks, NaN-aware;
   the public ``quantize`` / ``dequantize`` on a bf16 view at storage
   offset 1 and an int8 payload at an odd offset, copied aligned and
   launched once each)
   against their plain versions; ``dequantize_params`` of the 2-layer
   draft's tree in one K6 launch, 40 leaves in two, each leaf equal to
   ``dequantize_blocks`` alone and to the plain version; then the 12-layer
   model through
   ``ContinuousBatcher(draft_lm=..., speculative=SpeculativeConfig(draft_k=
   4))``: (a) phase 7's paged traffic with the target as its own draft, (b)
   a 2-layer draft of the same widths held in int8 on an int8 pool, (c) a
   tree draft (``tree_width=2``) with ``decode_split=4``, (d) an int4 pool,
   (e) dense strips (plain ``verify_attention``, no kernel) with one
   ``temperature > 0, top_k = 1`` request. Every stream passes a tie-aware
   check against ``generate()`` (a first difference only where the
   reference's own top-2 logit gap is below the bar) at a bar set from the
   measured first-token logit error of a verify pass against the decode
   step; the self draft's
   acceptance is at least 0.9 (of what a tree round can accept); pools drain; a steady speculative tick stages
   nothing host->device and fetches once; (b)'s K6 dequantize launches
   equal its draft calls (one launch a weight swap). K5, K5q, K5-split and
   K6 (and one whole ``dequantize_params`` of the draft) are timed at
   their main-path shapes; plain dense ``verify_attention`` is timed beside
   them;
11. training: K7 (``flash_attn_bwd``, the flash backward) against its plain
   version on K1's ``(out, lse)`` in f32 (2e-4) and bf16 / f16 (1e-2 of the
   largest reference magnitude) at the ViT shape b8 h12 s197 d64, causal
   s256, causal + window 64, ``valid_from``, head_dim 128 and s_q 70 x s_k
   197, two runs ``torch.equal``; then ViT-B/16 (patch 16, 768 / 12 blocks
   / 12 heads / 3072, 1000 classes, 224 x 224 x 3, random weights from seed
   0) through ``split_vit_variables`` -> ``make_pipelined_vit_apply`` ->
   ``make_train_step(SGD)``: (a) one f32 step of batch 8 in 2 microbatches
   through K1 + K7 against the same step with every attention on the plain
   versions, every parameter's gradient within 1e-3 relative L2; (b) five
   bf16-compute steps (f32 parameters) of batch 32 in 4 microbatches on one
   fixed batch (lr 0.005): losses finite and falling, K1 and K7 launched
   12 x 4 times a step each (K7's count is one per call, both passes), step
   ms, images/s, peak memory; then K7 and K1 timed at the ViT shape beside the plain
   version, SDPA (K7's library figure derived as SDPA forward + backward
   minus forward) and the bound; then the device time per launch of K1 (ViT
   shape and LM prefill shape b1 h12 s512 d64 causal), K7 (ViT shape) and
   SDPA's forward and forward + backward at the same shapes; then the decode
   kernels' device times (``decode_device_times``);
12. the paper's pipeline (``pipeline_phase``; TF32 off, so its f32 gates are
   real f32): ``LocalPipeline`` (3 stages on the card, ``infer`` and
   ``stream``) over ResNet-50 (``conv7`` stem, 1000 classes, 224 x 224 x 3,
   batch 8, ``RESNET50_3STAGE_CUTS``) and EfficientNet-B4 (380 x 380, batch
   4, ``balanced_cuts``) in f32 and bf16 compute and ViT-B/16 (bf16, batch
   8, ``vit_block_cuts(12, 3)``), 32 requests each, random weights from
   seed 0: every output within 1e-4 (f32) / 1e-2 (bf16) of the largest
   ``graph.apply`` logit on the card (bit-equality printed); for the ViT,
   K1 within 1e-2 + 1e-2|ref| of its plain version on every block's own
   q / k / v, and every stream output as close to the f32 truth (the same
   weights in f32, every attention on the plain version) as the bf16 model
   on the plain versions comes (bar max(1e-2, 2 x its error)); images/s of
   ``graph.apply``, ``infer`` and ``stream``, the card's busy share under
   ``infer`` (``torch.profiler`` device ms over the wall ms a request),
   ``eval_shapes`` at the cuts,
   K1 launched 12 times a request on the ViT's stream (the K1 row's
   ``pipeline_launches``); then the graft scenario: ViT-B/16 in 3 stages
   behind ``ServingPipeline`` on four workers of the card, 16 requests of
   batch 8, worker 0 crashed at request 5 and worker 1 hung at request 9:
   every result within 1e-2 of ``graph.apply``, none failed, at least 16
   completed, the hung worker not DEAD, no stage module built by the
   failover (``dispatcher.stage_builds``), the last result within 10 x
   (deadline + lease TTL) of the crash; recovery seconds, images/s,
   re-dispatches and quarantines printed, and the phase's seconds;
13. the paper's pipeline across processes (``remote_phase``; TF32 off):
   worker processes started with ``subprocess`` (``python -m
   adapt_tpu_torch.comm.remote --port 0 --device cuda:0``) on the one card,
   and one ``RemoteStageServer`` in this process over loopback TCP, whose
   launches are counted here. (a) ResNet-50 f32 (1000 classes, batch 8,
   ``RESNET50_3STAGE_CUTS``, 32 requests) behind a ``ServingPipeline``
   with no in-process worker, the three workers joining its
   ``WorkerGateway``, stage i configured on worker i: codecs ``none`` and
   ``lz`` ``torch.equal`` to ``graph.apply``, ``int8dev`` within max(1e-2,
   2 x ``LocalPipeline.from_config(codec="int8dev")``'s error) x the
   largest logit; (b) K6 ``torch.equal`` to its plain version at the two
   cut shapes (in ``check_k6``), and on the ``int8dev`` run K6 launched in
   this process once for every stage input the hub sends and every result
   it receives plus once each way for every stage run of its own server
   (4 hops a request each way); (f) ``setup_chain`` over the same workers,
   32 requests ``torch.equal``, the hub receiving only the tail's results,
   then the middle worker SIGKILLed mid-burst: the chain falls back to the
   hub and each request completes once, ``torch.equal``; (e) a journaled
   dispatcher over the survivors as dial-out workers, ``hard_stop()`` with
   requests in flight, ``Dispatcher.recover``: the journal's pending set
   replayed once each, ``torch.equal``, the journal drained; (c) ViT-B/16
   bf16 (``vit_block_cuts(12, 3)``, 16 requests of batch 8) over three
   worker processes, ``torch.equal`` (K1 in the workers); (d) the graft
   faults over four workers (the three + this process's server): SIGKILL
   of worker 0 at request 5, an ``MSG_KILL`` hang of worker 1 at 9, phase
   12's gates, K1 launched 4 times a stage run of this process's server.
   Printed: images/s of every run beside phase 12's in-process
   ``ServingPipeline``, wire over raw bytes and stage dispatch-to-result
   p50 ms per codec, recovery seconds, K6 at the hop shapes beside its
   plain version and bound, and the phase's seconds.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

PEAK_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def close(a, b, atol, rtol, what) -> float:
    err = (a.float() - b.float()).abs()
    lim = atol + rtol * b.float().abs()
    worst = float(err.max())
    if not bool((err <= lim).all()):
        raise AssertionError(
            f"{what}: max abs err {worst:.3e} over atol {atol} rtol {rtol}"
        )
    return worst


def check_k1(torch, A, dev, errs):
    """K1 vs its plain version, bf16 in f32 math on both sides; out is
    compared at one bf16 ulp (atol 1e-2, rtol 1e-2), lse at 1e-3."""
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    cases = [(dict(b=1, h=12, s=s, d=64, causal=True), {}) for s in
             (32, 128, 512, 1024)]
    cases += [
        (dict(b=2, h=12, s=197, d=64, causal=False), {}),  # ViT ragged
        (dict(b=8, h=12, s=197, d=64, causal=False), {}),  # phase 12's ViT
        (dict(b=1, h=12, s=197, d=64, causal=True), {}),
        (dict(b=4, h=12, s=128, d=64, causal=True),
         {"valid_from": torch.tensor([0, 5, 64, 127], device=dev)}),
        (dict(b=1, h=12, s=1024, d=64, causal=True), {"window": 256}),
        (dict(b=1, h=8, s=256, d=128, causal=True), {}),
    ]
    for shp, kw in cases:
        b, h, s, d = shp["b"], shp["h"], shp["s"], shp["d"]
        q, k, v = rnd(b, h, s, d), rnd(b, h, s, d), rnd(b, h, s, d)
        out, lse = A.flash_attn_fwd(q, k, v, shp["causal"],
                                    kw.get("valid_from"), None,
                                    kw.get("window"))
        torch.cuda.synchronize()
        ref, ref_lse = A._reference_with_lse(
            q, k, v, shp["causal"], kw.get("valid_from"), None,
            kw.get("window"))
        rows = slice(None)
        if "valid_from" in kw:  # padded query rows are unspecified
            vf = kw["valid_from"]
            keep = torch.arange(s, device=dev)[None, :] >= vf[:, None]
            out, ref = out.transpose(1, 2)[keep], ref.transpose(1, 2)[keep]
            lse, ref_lse = lse.transpose(1, 2)[keep], ref_lse.transpose(1, 2)[keep]
        e = close(out[rows], ref[rows], 1e-2, 1e-2, f"K1 out {shp} {kw}")
        close(lse, ref_lse, 1e-3, 1e-5, f"K1 lse {shp} {kw}")
        errs["flash_attn_fwd"] = max(errs.get("flash_attn_fwd", 0.0), e)
        print(f"K1 {shp} {list(kw)}: max abs err {e:.3e} (tol 1e-2 + 1e-2|ref|)")


def decode_inputs(torch, dev, b, kvh, g, L, hd, seed=2):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q, ck, cv = rnd(b, kvh, g, hd), rnd(b, kvh, L, hd), rnd(b, kvh, L, hd)
    idx = torch.linspace(0, L - 1, b, device=dev).round().to(torch.int32)
    return q, ck, cv, idx


def check_k2(torch, D, dev, errs):
    """K2 / K2-split vs the plain version at atol 1e-2, rtol 1e-2 (bf16
    outputs), and split 1 vs split 4."""
    cases = [
        (dict(b=8, kvh=12, g=1, L=1025, hd=64), None),
        (dict(b=8, kvh=3, g=4, L=1025, hd=64), None),
        (dict(b=8, kvh=12, g=1, L=1025, hd=64), "vf"),
        (dict(b=4, kvh=8, g=2, L=700, hd=128), None),
    ]
    for shp, extra in cases:
        q, ck, cv, idx = decode_inputs(torch, dev, **shp)
        vf = None
        if extra == "vf":
            vf = (idx // 3).to(torch.int32)
        outs = {}
        for split in (1, 4):
            if split == 1:
                got = D.decode_attn(q, ck, cv, idx, vf)
                name = "decode_attn"
            else:
                got = D.decode_attn_split(q, ck, cv, idx, vf, split)
                name = "decode_attn_split"
            torch.cuda.synchronize()
            ref = D.decode_attention_plain(q, ck, cv, idx, vf, split)
            e = close(got, ref, 1e-2, 1e-2, f"{name} {shp} {extra}")
            errs[name] = max(errs.get(name, 0.0), e)
            outs[split] = got
            print(f"{name} {shp} {extra}: max abs err {e:.3e} "
                  "(tol 1e-2 + 1e-2|ref|)")
        e = close(outs[1], outs[4], 1e-2, 1e-2, f"split1 vs split4 {shp}")
        print(f"K2 split 1 vs split 4 {shp}: max abs err {e:.3e}")
    check_invariance(torch, D, None, dev)
    check_split_bits(torch, D, None, None, dev, "dense")


#: Strip lengths on which the unsplit K2 must give the same bits: the
#: pool's 1024, the batcher's max_len + 1 and speculative strips past it.
STRIP_LENGTHS = (1024, 1025, 1029, 1031)


def rows_of(c, sl):
    """Rows ``sl`` of a cache operand (each member of a quantized pair)."""
    return tuple(m[sl] for m in c) if isinstance(c, tuple) else c[sl]


def first_keys(c, length):
    """The first ``length`` positions of a cache operand, contiguous."""
    if isinstance(c, tuple):
        return tuple(first_keys(m, length) for m in c)
    return c[:, :, :length].contiguous()


def check_invariance(torch, D, Q, dev, kv="native"):
    """The unsplit K2 (K2q for a quantized ``kv``) sums by key position
    only: the same rows give the same bits (torch.equal) on strips of every
    STRIP_LENGTHS length, each row alone equals the same row in the batch
    of 8, a second run equals the first and the dead row is zeros."""
    for shp in (dict(b=8, kvh=12, g=1, hd=64), dict(b=8, kvh=3, g=4, hd=64)):
        q, ck, cv, _ = decode_inputs(torch, dev, L=max(STRIP_LENGTHS),
                                     seed=5, **shp)
        idx = torch.linspace(0, 1023, shp["b"], device=dev).round().to(
            torch.int32)
        idx[2] = -1  # a dead row
        if kv != "native":
            ck, cv = quantized(Q, ck, kv), quantized(Q, cv, kv)
        strips = {n: (first_keys(ck, n), first_keys(cv, n))
                  for n in STRIP_LENGTHS}
        ref = D.decode_attn(q, *strips[1025], idx)
        outs = {n: D.decode_attn(q, *strips[n], idx) for n in STRIP_LENGTHS}
        again = D.decode_attn(q, *strips[1025], idx)
        alone = [D.decode_attn(q[r:r + 1], rows_of(strips[1025][0],
                                                   slice(r, r + 1)),
                               rows_of(strips[1025][1], slice(r, r + 1)),
                               idx[r:r + 1]) for r in range(shp["b"])]
        torch.cuda.synchronize()
        for n, out in outs.items():
            if not torch.equal(out, ref):
                raise AssertionError(f"K2[{kv}] on L={n} != L=1025 at {shp}")
        if not torch.equal(again, ref):
            raise AssertionError(f"K2[{kv}] second run differs at {shp}")
        if not torch.equal(torch.cat(alone), ref):
            raise AssertionError(f"K2[{kv}] row alone != row in batch at "
                                 f"{shp}")
        if ref[2].any():
            raise AssertionError(f"K2[{kv}]'s dead row is not zero")
        print(f"K2[{kv}] {shp}: strips of {list(STRIP_LENGTHS)} equal, each "
              "row alone == in the batch of 8, second run equal, dead row "
              "zeros (torch.equal)")


def check_split_bits(torch, D, P, Q, dev, layout, kv="native"):
    """The splits' bit-equalities (torch.equal) on one ``layout`` ("dense":
    K2-split, "paged": K3-split; K2q / K3q-split for a quantized ``kv``):
    (1) split 1 equals the unsplit kernel; (2, paged) K3-split equals
    K2-split on the same K/V as a dense strip of the same key range, 1024,
    at pages 128 and 16, split 4; (3) each row alone equals the same row in
    the batch of 8 at split 4; (4) a second run equals the first at splits
    4 and 16; the dead row is zeros."""
    for shp in (dict(b=8, kvh=12, g=1, hd=64), dict(b=8, kvh=3, g=4, hd=64)):
        for page in (128, 16) if layout == "paged" else (128,):
            q, kp, vp, table, idx = paged_inputs(
                torch, dev, page=page, pps=1024 // page,
                npages=8 * 1024 // page + 1, seed=14, **shp)
            if kv != "native":
                kp, vp = quantized(Q, kp, kv), quantized(Q, vp, kv)

            def strip(pool, n, table=table):
                if isinstance(pool, tuple):
                    return tuple(as_strip(torch, m, table, n) for m in pool)
                return as_strip(torch, pool, table, n)

            tag = f"[{kv}] {layout} {shp} page {page}"
            if layout == "paged":
                def run(sl, split):
                    return P.paged_attn_split(q[sl], kp, vp, table[sl],
                                              idx[sl], None, split)
                one = P.paged_attn(q, kp, vp, table, idx)
                dense = D.decode_attn_split(q, strip(kp, 1024),
                                            strip(vp, 1024), idx, None, 4)
            else:
                ck, cv = strip(kp, 1025), strip(vp, 1025)

                def run(sl, split):
                    return D.decode_attn_split(q[sl], rows_of(ck, sl),
                                               rows_of(cv, sl), idx[sl],
                                               None, split)
                one = D.decode_attn(q, ck, cv, idx)
                dense = None
            every = slice(0, shp["b"])
            ref = run(every, 4)
            checks = [("split 1 != unsplit", run(every, 1), one),
                      ("second run differs at split 4", run(every, 4), ref),
                      ("second run differs at split 16", run(every, 16),
                       run(every, 16))]
            if dense is not None:
                checks.append(("K3-split != K2-split (L=1024)", ref, dense))
            checks += [(f"row {r} alone != row in batch at split 4",
                        run(slice(r, r + 1), 4), ref[r:r + 1])
                       for r in range(shp["b"])]
            torch.cuda.synchronize()
            for what, a, b in checks:
                if not torch.equal(a, b):
                    raise AssertionError(f"split{tag}: {what}")
            if ref[-1].any():
                raise AssertionError(f"split{tag}: the dead row is not zero")
            print(f"split{tag}: split 1 == unsplit, "
                  + ("K3-split == K2-split on L=1024, " if dense is not None
                     else "") + "rows alone == in the batch of 8 and second "
                  "runs equal (splits 4, 16), dead row zeros (torch.equal)")


def paged_inputs(torch, dev, b, kvh, g, hd, page, pps, npages, seed=6):
    """bf16 pools with a shuffled page table (pages shared between two
    rows, a trash tail), indices spread over the slot window, the last row
    dead (the batcher's idle sentinel)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q, kp, vp = rnd(b, kvh, g, hd), rnd(npages, kvh, page, hd), rnd(
        npages, kvh, page, hd)
    perm = torch.randperm(npages - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    table = perm[:b * pps].reshape(b, pps).to(torch.int32)
    table[1, 0] = table[0, 0]
    table[-1, -1] = 0
    width = pps * page
    idx = torch.linspace(0, width - 1, b).round().to(torch.int32)
    idx[-1] = -9
    return q, kp, vp, table.to(dev), idx.to(dev)


def as_strip(torch, pool, table, length):
    """The same K/V as a dense (b, kv_h, length, hd) strip."""
    b = table.shape[0]
    win = pool[table.long()].movedim(2, 1).reshape(b, pool.shape[1], -1,
                                                   pool.shape[3])
    out = torch.zeros(b, pool.shape[1], length, pool.shape[3],
                      dtype=pool.dtype, device=pool.device)
    out[:, :, :win.shape[2]] = win
    return out


def check_k3(torch, D, P, dev, errs):
    """K3 / K3-split vs the plain version at atol 1e-2, rtol 1e-2 (bf16
    outputs); K3 == K2 with torch.equal on the same K/V (the batcher's
    1025-long strip)."""
    cases = [
        (dict(b=8, kvh=12, g=1, hd=64, page=128, pps=8, npages=65), None),
        (dict(b=8, kvh=3, g=4, hd=64, page=128, pps=8, npages=65), None),
        (dict(b=8, kvh=12, g=1, hd=64, page=128, pps=8, npages=65), "vf"),
        (dict(b=8, kvh=12, g=1, hd=64, page=16, pps=64, npages=513), None),
        (dict(b=4, kvh=8, g=2, hd=128, page=128, pps=6, npages=25), None),
    ]
    for shp, extra in cases:
        q, kp, vp, table, idx = paged_inputs(torch, dev, **shp)
        vf = (idx.clamp(min=0) // 3).to(torch.int32) if extra == "vf" else None
        for name, split in (("paged_attn", 1), ("paged_attn_split", 4)):
            if split == 1:
                got = P.paged_attn(q, kp, vp, table, idx, vf)
            else:
                got = P.paged_attn_split(q, kp, vp, table, idx, vf, split)
            torch.cuda.synchronize()
            ref = P.paged_attention_plain(q, kp, vp, table, idx, vf, split)
            e = close(got, ref, 1e-2, 1e-2, f"{name} {shp} {extra}")
            errs[name] = max(errs.get(name, 0.0), e)
            print(f"{name} {shp} {extra}: max abs err {e:.3e} "
                  "(tol 1e-2 + 1e-2|ref|)")
            if split == 1:
                for n in STRIP_LENGTHS:
                    dense = D.decode_attn(q, as_strip(torch, kp, table, n),
                                          as_strip(torch, vp, table, n), idx,
                                          vf)
                    torch.cuda.synchronize()
                    if not torch.equal(got, dense):
                        raise AssertionError(
                            f"K3 != K2 (L={n}) bit for bit at {shp}")
                if got[-1].any():
                    raise AssertionError("K3's dead row is not zero")
                print(f"K3 == K2 bit for bit (torch.equal) at {shp} {extra}, "
                      f"strips of {list(STRIP_LENGTHS)}")
    check_split_bits(torch, D, P, None, dev, "paged")


def chunk_inputs(torch, dev, kvh, g, hd, chunk, pos0, page=128, seed=8):
    """A chunk's folded q and a pool; the window's pages shuffled and
    padded to a power of two with trash page 0."""
    gen = torch.Generator(device=dev).manual_seed(seed + pos0 + chunk)
    n_strip = (pos0 + chunk) // page
    n_pad = 1 << (n_strip - 1).bit_length()
    npages = n_strip + 3

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q = rnd(1, kvh, g * chunk, hd)
    kp, vp = rnd(npages, kvh, page, hd), rnd(npages, kvh, page, hd)
    live = torch.randperm(npages - 1, generator=torch.Generator().manual_seed(
        seed))[:n_strip] + 1
    pages = torch.cat([live, torch.zeros(n_pad - n_strip, dtype=live.dtype)])
    return q, kp, vp, pages.to(torch.int32).to(dev)


def check_k4(torch, P, A, dev, errs):
    """K4 vs its plain version at atol 1e-2, rtol 1e-2 (bf16 outputs); at C
    256 (g 1) K4's rows equal to the same rows of a causal K1 pass (``A``)
    over the window as a dense strip, with ``torch.equal``."""
    cases = [dict(kvh=12, g=1, hd=64, chunk=c, pos0=p, window=None)
             for c in (128, 256) for p in (0, 256, 512)]
    cases += [dict(kvh=12, g=1, hd=64, chunk=256, pos0=512, window=300),
              dict(kvh=3, g=4, hd=64, chunk=256, pos0=256, window=None),
              dict(kvh=8, g=2, hd=128, chunk=128, pos0=384, window=None)]
    for c in cases:
        q, kp, vp, pages = chunk_inputs(torch, dev, c["kvh"], c["g"], c["hd"],
                                        c["chunk"], c["pos0"])
        got = P.paged_chunk_attn(q, kp, vp, pages, c["pos0"], c["chunk"],
                                 c["window"])
        torch.cuda.synchronize()
        ref = P.paged_chunk_attention_reference(q, kp, vp, pages, c["pos0"],
                                                c["chunk"], c["window"])
        e = close(got, ref, 1e-2, 1e-2, f"paged_chunk_attn {c}")
        errs["paged_chunk_attn"] = max(errs.get("paged_chunk_attn", 0.0), e)
        print(f"paged_chunk_attn {c}: max abs err {e:.3e} "
              "(tol 1e-2 + 1e-2|ref|)")
        if c["g"] != 1 or c["chunk"] != 256:
            continue
        n = c["pos0"] + c["chunk"]
        q_all = torch.zeros(1, c["kvh"], n, c["hd"], device=dev,
                            dtype=q.dtype)
        q_all[:, :, c["pos0"]:] = q

        def strip(pool):
            return pool[pages.long()].movedim(1, 0).reshape(
                1, c["kvh"], -1, c["hd"])[:, :, :n].contiguous()

        ref1, _ = A.flash_attn_fwd(q_all, strip(kp), strip(vp), True,
                                   window=c["window"])
        torch.cuda.synchronize()
        if not torch.equal(got, ref1[:, :, c["pos0"]:]):
            raise AssertionError(f"K4 rows != K1 rows at {c}")
        print(f"K4 == K1 bit for bit (torch.equal) on the chunk's rows at "
              f"{c}")


KV_DTYPES = ("int8", "int4")


def quantized(Q, t, kv):
    """``t`` as a quantized (values, scales) pair; pools pass as pairs."""
    return Q.quantize_kv_vectors(t, kv)


def check_k2q(torch, D, Q, dev, errs):
    """K2q / K2q-split (int8 and int4 caches) vs the plain version at atol
    1e-2, rtol 1e-2 (bf16 outputs) on phase 3's shapes."""
    cases = [
        (dict(b=8, kvh=12, g=1, L=1025, hd=64), None),
        (dict(b=8, kvh=3, g=4, L=1025, hd=64), None),
        (dict(b=8, kvh=12, g=1, L=1025, hd=64), "vf"),
        (dict(b=4, kvh=8, g=2, L=700, hd=128), None),
    ]
    for kv in KV_DTYPES:
        for shp, extra in cases:
            q, ck, cv, idx = decode_inputs(torch, dev, **shp)
            ck, cv = quantized(Q, ck, kv), quantized(Q, cv, kv)
            vf = (idx // 3).to(torch.int32) if extra == "vf" else None
            for name, split in (("decode_attn", 1), ("decode_attn_split", 4)):
                if split == 1:
                    got = D.decode_attn(q, ck, cv, idx, vf)
                else:
                    got = D.decode_attn_split(q, ck, cv, idx, vf, split)
                torch.cuda.synchronize()
                ref = D.decode_attention_plain(q, ck, cv, idx, vf, split)
                key = f"{name}[{kv}]"
                e = close(got, ref, 1e-2, 1e-2, f"{key} {shp} {extra}")
                errs[key] = max(errs.get(key, 0.0), e)
                print(f"{key} {shp} {extra}: max abs err {e:.3e} "
                      "(tol 1e-2 + 1e-2|ref|)")
        check_invariance(torch, D, Q, dev, kv)
        check_split_bits(torch, D, None, Q, dev, "dense", kv)


def check_k3q(torch, D, P, Q, dev, errs):
    """K3q / K3q-split vs the plain version at atol 1e-2, rtol 1e-2 on
    phase 4's pool shapes; K3q == K2q with torch.equal on the same
    quantized K/V as a dense strip."""
    cases = [
        (dict(b=8, kvh=12, g=1, hd=64, page=128, pps=8, npages=65), None),
        (dict(b=8, kvh=3, g=4, hd=64, page=128, pps=8, npages=65), None),
        (dict(b=8, kvh=12, g=1, hd=64, page=128, pps=8, npages=65), "vf"),
        (dict(b=8, kvh=12, g=1, hd=64, page=16, pps=64, npages=513), None),
        (dict(b=4, kvh=8, g=2, hd=128, page=128, pps=6, npages=25), None),
    ]
    for kv in KV_DTYPES:
        for shp, extra in cases:
            q, kp, vp, table, idx = paged_inputs(torch, dev, **shp)
            kp, vp = quantized(Q, kp, kv), quantized(Q, vp, kv)
            vf = ((idx.clamp(min=0) // 3).to(torch.int32) if extra == "vf"
                  else None)
            for name, split in (("paged_attn", 1), ("paged_attn_split", 4)):
                if split == 1:
                    got = P.paged_attn(q, kp, vp, table, idx, vf)
                else:
                    got = P.paged_attn_split(q, kp, vp, table, idx, vf, split)
                torch.cuda.synchronize()
                ref = P.paged_attention_plain(q, kp, vp, table, idx, vf, split)
                key = f"{name}[{kv}]"
                e = close(got, ref, 1e-2, 1e-2, f"{key} {shp} {extra}")
                errs[key] = max(errs.get(key, 0.0), e)
                print(f"{key} {shp} {extra}: max abs err {e:.3e} "
                      "(tol 1e-2 + 1e-2|ref|)")
                if split == 1:
                    for n in STRIP_LENGTHS:
                        strip = lambda pool, n=n: tuple(  # noqa: E731
                            as_strip(torch, m, table, n) for m in pool)
                        dense = D.decode_attn(q, strip(kp), strip(vp), idx,
                                              vf)
                        torch.cuda.synchronize()
                        if not torch.equal(got, dense):
                            raise AssertionError(
                                f"K3q != K2q (L={n}) bit for bit at {shp}")
                    if got[-1].any():
                        raise AssertionError("K3q's dead row is not zero")
                    print(f"K3q == K2q bit for bit (torch.equal) [{kv}] at "
                          f"{shp} {extra}, strips of {list(STRIP_LENGTHS)}")
        check_split_bits(torch, D, P, Q, dev, "paged", kv)


def check_k4q(torch, P, Q, dev, errs):
    """K4q vs its plain version at atol 1e-2, rtol 1e-2 on phase 5's
    cases."""
    cases = [dict(kvh=12, g=1, hd=64, chunk=c, pos0=p, window=None)
             for c in (128, 256) for p in (0, 256, 512)]
    cases += [dict(kvh=12, g=1, hd=64, chunk=256, pos0=512, window=300),
              dict(kvh=3, g=4, hd=64, chunk=256, pos0=256, window=None),
              dict(kvh=8, g=2, hd=128, chunk=128, pos0=384, window=None)]
    for kv in KV_DTYPES:
        for c in cases:
            q, kp, vp, pages = chunk_inputs(torch, dev, c["kvh"], c["g"],
                                            c["hd"], c["chunk"], c["pos0"])
            kp, vp = quantized(Q, kp, kv), quantized(Q, vp, kv)
            got = P.paged_chunk_attn(q, kp, vp, pages, c["pos0"], c["chunk"],
                                     c["window"])
            torch.cuda.synchronize()
            ref = P.paged_chunk_attention_reference(
                q, kp, vp, pages, c["pos0"], c["chunk"], c["window"])
            key = f"paged_chunk_attn[{kv}]"
            e = close(got, ref, 1e-2, 1e-2, f"{key} {c}")
            errs[key] = max(errs.get(key, 0.0), e)
            print(f"{key} {c}: max abs err {e:.3e} (tol 1e-2 + 1e-2|ref|)")


def verify_inputs(torch, dev, b, kvh, g, kc, hd, page, pps, npages,
                  dtype=None, seed=12):
    """A verify chunk's folded q (b, kv_h, g * kc, hd) and pools with a
    shuffled page table; base positions spread over the slot window, the
    last slot dead (the batcher's idle sentinel)."""
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    q = rnd(b, kvh, g * kc, hd)
    kp, vp = rnd(npages, kvh, page, hd), rnd(npages, kvh, page, hd)
    perm = torch.randperm(npages - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    table = perm[:b * pps].reshape(b, pps).to(torch.int32)
    idx = torch.linspace(0, pps * page - kc, b).round().to(torch.int32)
    idx[-1] = -(kc + 2)
    return q, kp, vp, table.to(dev), idx.to(dev)


def check_k5(torch, P, Q, dev, errs):
    """K5 / K5-split vs the plain version at atol 1e-2, rtol 1e-2 (bf16) or
    1e-4 (f32), native / int8 / int4 pools; split 1 == unsplit with
    torch.equal; the dead slot is zeros."""
    main = dict(b=8, kvh=12, g=1, kc=5, hd=64, page=128, pps=8, npages=65)
    cases = [
        (main, None, 0, None),
        (dict(main, kvh=3, g=4), None, 0, None),  # 20 rows: two row tiles
        (main, 300, 0, None),
        (dict(main, kc=7), None, 2, None),  # tree leaves
        (dict(main, kvh=3, g=4, kc=7), 200, 2, None),
        (dict(main, page=16, pps=64, npages=513), None, 0, None),
        (dict(b=4, kvh=8, g=2, kc=5, hd=128, page=128, pps=6, npages=25),
         None, 0, None),
        (main, None, 0, torch.float32),
    ]
    for kv in ("native",) + KV_DTYPES:
        for shp, window, tt, dtype in cases:
            q, kp, vp, table, idx = verify_inputs(torch, dev, dtype=dtype,
                                                  **shp)
            if kv != "native":
                kp, vp = quantized(Q, kp, kv), quantized(Q, vp, kv)
            kc = shp["kc"]
            tol = 1e-4 if dtype is torch.float32 else 1e-2
            tag = "" if kv == "native" else f"[{kv}]"
            what = (f"{shp} window={window} tree_tail={tt} "
                    f"{'f32' if dtype else 'bf16'}")
            got = P.paged_verify_attn(q, kp, vp, table, idx, kc, window, tt)
            split4 = P.paged_verify_attn_split(q, kp, vp, table, idx, kc,
                                               window, tt, 4)
            split1 = P.paged_verify_attn_split(q, kp, vp, table, idx, kc,
                                               window, tt, 1)
            torch.cuda.synchronize()
            for name, out, split in (("paged_verify_attn", got, 1),
                                     ("paged_verify_attn_split", split4, 4)):
                ref = P.paged_verify_attention_plain(q, kp, vp, table, idx,
                                                     kc, window, tt, split)
                e = close(out, ref, tol, tol, f"{name}{tag} {what}")
                errs[name + tag] = max(errs.get(name + tag, 0.0), e)
                print(f"{name}{tag} {what}: max abs err {e:.3e} (tol {tol} "
                      f"+ {tol}|ref|)")
                if out[-1].any():
                    raise AssertionError(f"{name}{tag}: the dead slot is not "
                                         "zero")
            if not torch.equal(split1, got):
                raise AssertionError(f"K5{tag} split 1 != unsplit at {what}")
    print("K5 split 1 == unsplit bit for bit (torch.equal) in every case")


#: The 2-layer GPT-2-small draft's quantized matrices in ``state_dict``
#: order (phase 10 holds ``draft2`` to it): (name, shape, dtype name).
DRAFT_LEAVES = (
    ("embed.pos_embed", (1024, 768), "float32"),
    ("embed.tok.weight", (50257, 768), "bfloat16"),
    *((f"decoder_block_{i}.{m}", shape, "bfloat16") for i in range(2)
      for m, shape in (("attn.qkv.weight", (2304, 768)),
                       ("attn.out.weight", (768, 768)),
                       ("mlp_in.weight", (3072, 768)),
                       ("mlp_out.weight", (768, 3072)))),
    ("head.logits.weight", (50257, 768), "float32"),
)


def draft_tree(torch, Q, seed=17, device="cuda"):
    """``Q.quantize_params`` of random tensors at DRAFT_LEAVES (values x
    0.036, as GPT-2's init), on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    return Q.quantize_params({
        name: (torch.randn(*shape, generator=g, device=device) * 0.036).to(
            getattr(torch, dt)) for name, shape, dt in DRAFT_LEAVES})


def same_bits(torch, a, b):
    """``torch.equal``, a NaN counting equal to a NaN (the kernel's and the
    plain version's NaN payloads may differ)."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def check_k6(torch, Q, dev, errs):
    """K6 quantize / dequantize vs the plain version with torch.equal
    (values, scales, the round trip; NaN-aware): every draft matrix shape
    and dtype, a ragged size, an all-zero block, NaN / +-Inf blocks, and
    phase 13's int8dev hops (ResNet-50's cuts at batch 8, f32)."""
    gen = torch.Generator(device=dev).manual_seed(13)
    zero = torch.randn(3, 8192, generator=gen, device=dev)
    zero[1] = 0.0
    nan_inf = torch.randn(3, 8192, generator=gen, device=dev)
    nan_inf[0, 17], nan_inf[1, 4000], nan_inf[2, 8191] = (
        float("nan"), float("inf"), float("-inf"))
    inf = torch.randn(2, 8192, generator=gen, device=dev)
    inf[0, 2047], inf[1, 2048] = float("inf"), float("-inf")
    leaf_kinds = dict.fromkeys((shape, dt) for _, shape, dt in DRAFT_LEAVES)
    cases = {f"{shape} {dt}": (torch.randn(*shape, generator=gen, device=dev)
                               * 0.036).to(getattr(torch, dt))
             for shape, dt in leaf_kinds}
    cases.update({
        "(1000, 37) f32, no multiple of 8192": torch.randn(
            1000, 37, generator=gen, device=dev),
        "(3, 8192) f32 with an all-zero block": zero,
        "(3, 8192) f32, NaN / +Inf / -Inf blocks": nan_inf,
        "(2, 8192) bf16, +Inf / -Inf blocks": inf.to(torch.bfloat16),
        # Phase 13's int8dev hops: ResNet-50's cut activations at batch 8.
        "(8, 56, 56, 256) f32, a hop": torch.randn(
            8, 56, 56, 256, generator=gen, device=dev).relu(),
        "(8, 28, 28, 512) f32, a hop": torch.randn(
            8, 28, 28, 512, generator=gen, device=dev).relu(),
    })
    for what, x in cases.items():
        qt = Q.quantize_blocks(x)
        back = Q.dequantize_blocks(qt)
        torch.cuda.synchronize()
        ref = Q.quantize_reference(x)
        ref_back = Q.dequantize_reference(ref)
        fin = torch.isfinite(ref.scales)
        ok_b = torch.isfinite(ref_back)

        def worst(d):  # largest |difference| over finite entries, or 0
            return float(d.abs().max()) if d.numel() else 0.0

        ev = worst(qt.values.int() - ref.values.int())
        es = worst((qt.scales - ref.scales)[fin])
        eb = worst((back.float() - ref_back.float())[ok_b])
        if not (torch.equal(qt.values, ref.values)
                and same_bits(torch, qt.scales, ref.scales)):
            raise AssertionError(f"quantize_blocks != plain at {what}: values "
                                 f"differ by {ev}, finite scales by {es}")
        if not same_bits(torch, back, ref_back) or back.dtype != x.dtype:
            raise AssertionError(f"dequantize_blocks != plain at {what}: "
                                 f"finite values differ by {eb}")
        if not bool(torch.isfinite(x).all()) and bool(fin.all()):
            raise AssertionError(f"K6 at {what}: non-finite input gave "
                                 "finite scales")
        errs["quantize_blocks"] = max(errs.get("quantize_blocks", 0.0), ev, es)
        errs["dequantize_blocks"] = max(errs.get("dequantize_blocks", 0.0), eb)
        rt = worst((back.float() - x.float())[ok_b])
        print(f"K6 {what}: values, scales and round trip torch.equal to the "
              f"plain version (NaN-aware; scales {qt.scales.flatten()[:3].tolist()}"
              f"{'...' if qt.scales.numel() > 3 else ''}; finite round-trip "
              f"error {rt:.3e})")
    # The public entry points on bases no 16-byte vector access may start
    # at (the kernels refuse them): a view at storage offset 1 and an int8
    # payload stored at an odd offset are copied aligned, then launched.
    buf = torch.randn(2 * 8192 + 1, generator=gen, device=dev).to(
        torch.bfloat16)
    x = buf[1:].view(2, 8192)
    n_q, n_d = Q.quantize_blocks.launches, Q.dequantize_blocks.launches
    qt = Q.quantize(x)
    shifted = torch.empty(qt.values.numel() + 1, dtype=torch.int8,
                          device=dev)
    shifted[1:] = qt.values.reshape(-1)
    odd = Q.QuantizedTensor(shifted[1:].view(-1, 128), qt.scales, qt.shape,
                            qt.dtype)
    back = Q.dequantize(odd)
    torch.cuda.synchronize()
    ref = Q.quantize_reference(x)
    if (Q.quantize_blocks.launches, Q.dequantize_blocks.launches) != (
            n_q + 1, n_d + 1):
        raise AssertionError("K6's public quantize / dequantize on unaligned "
                             "bases did not launch the kernels once each")
    if not (torch.equal(qt.values, ref.values)
            and same_bits(torch, qt.scales, ref.scales)
            and same_bits(torch, back, Q.dequantize_reference(ref))):
        raise AssertionError("K6's public quantize / dequantize on unaligned "
                             "bases differ from the plain version")
    print(f"K6 public quantize of a bf16 view at storage offset "
          f"{x.storage_offset()} and dequantize of an int8 payload at offset "
          f"{odd.values.storage_offset()}: copied aligned, one launch each, "
          "torch.equal to the plain version")


def check_k6_grouped(torch, Q, draft_state):
    """``dequantize_params`` on the card: the 2-layer draft's quantized
    ``state_dict`` (its matrices must be DRAFT_LEAVES) in one K6 launch and
    40 leaves in two, each leaf ``torch.equal`` to ``dequantize_blocks``
    of that leaf alone and to the plain version, a second run equal to the
    first. Returns (the draft tree, K6 launches per call)."""
    q = Q.quantize_params(draft_state)
    leaves = [(k, v) for k, v in q.items() if isinstance(v, Q.QuantizedTensor)]
    got = [(k, tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in leaves]
    if got != list(DRAFT_LEAVES):
        raise AssertionError(f"the draft's quantized leaves {got} are not "
                             f"DRAFT_LEAVES {list(DRAFT_LEAVES)}")
    dev = next(iter(draft_state.values())).device
    g = torch.Generator(device=dev).manual_seed(19)
    shapes = [((8, 7), torch.float32), ((33, 17), torch.bfloat16),
              ((2, 4100), torch.float16), ((129, 64), torch.bfloat16)]
    forty = Q.quantize_params({f"w{i}": torch.randn(
        *shapes[i % 4][0], generator=g, device=dev).to(shapes[i % 4][1])
        for i in range(40)})
    per_call = {}
    for name, tree, want in (("draft2", q, 1), ("forty", forty, 2)):
        n0 = Q.dequantize_blocks.launches
        back = Q.dequantize_params(tree)
        torch.cuda.synchronize()
        per_call[name] = Q.dequantize_blocks.launches - n0
        if per_call[name] != want:
            raise AssertionError(f"dequantize_params({name}) made "
                                 f"{per_call[name]} K6 launches, want {want}")
        again = Q.dequantize_params(tree)
        for k, v in tree.items():
            if not isinstance(v, Q.QuantizedTensor):
                continue
            if not (torch.equal(back[k], Q.dequantize_blocks(v))
                    and torch.equal(back[k], Q.dequantize_reference(v))
                    and torch.equal(back[k], again[k])
                    and back[k].dtype == v.dtype):
                raise AssertionError(f"dequantize_params({name})[{k}] != "
                                     "dequantize_blocks / plain / a second run")
    print(f"dequantize_params on the card: the 2-layer draft's "
          f"{len(leaves)} matrices in {per_call['draft2']} K6 launch, 40 "
          f"leaves in {per_call['forty']}; every leaf torch.equal to "
          "dequantize_blocks alone, to the plain version and to a second run")
    return q, per_call["draft2"]


def drive_spec(torch, lm, draft, spec, kernel, layout, kv, waves, steps,
               cancel_at, prefill_chunk=None, sampled=None):
    """Serve ``waves`` (two staggered waves) through a speculative batcher;
    cancel wave-1 request ``cancel_at`` once live. Between the waves, once
    no slot is mid-prefill, ONE steady tick is measured: host->device
    copies and device->host fetches it made. ``sampled`` (prompt, kwargs)
    joins wave 2. Returns the batcher, {id: prompt}, results, the cancelled
    id, the sampled id, wall s, committed tokens, (h2d, d2h) of the steady
    tick."""
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

    extra = {}
    if layout == "paged":
        extra = dict(page_size=128, prefill_chunk=prefill_chunk)
    bat = ContinuousBatcher(lm, slots=8, kv_layout=layout, kernel=kernel,
                            kv_cache_dtype=kv, draft_lm=draft,
                            speculative=spec, **extra)
    t0 = time.perf_counter()
    ids = [bat.submit(p, steps) for p in waves[0]]
    bat.tick()
    while any(s.req is not None and s.pf_done >= 0 for s in bat.slots):
        bat.tick()
    before = bat.stats()
    if bat.tick() < 1:
        raise AssertionError("the steady tick decoded no slot")
    after = bat.stats()
    steady = (after["h2d_transfers"] - before["h2d_transfers"],
              after["d2h_fetches"] - before["d2h_fetches"])
    ids += [bat.submit(p, steps) for p in waves[1]]
    sampled_id = None
    if sampled is not None:
        sampled_id = bat.submit(sampled[0], steps, **sampled[1])
    cancelled = None
    if cancel_at is not None:
        cancelled = ids[cancel_at]
        if not bat.cancel(cancelled):
            raise AssertionError("the cancel found no live request")
    out = bat.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prompts = dict(zip(ids, list(waves[0]) + list(waves[1])))
    if sampled_id is not None:
        prompts[sampled_id] = sampled[0]
    tokens = sum(len(v) for v in out.values())
    return bat, prompts, out, cancelled, sampled_id, wall, tokens, steady


def check_spec_streams(prompts, out, cancelled, steps, ref, ref_gaps, bar):
    """Every speculative stream against its reference ``ref(prompt)``
    (``generate()`` alone, same cache dtype and split): equal, or first
    differing at a token where the reference's OWN top-2 logit gap
    (``ref_gaps(prompt)[t]``, read from the logits ``generate()`` picked
    that token from — over a quantized cache the native forward's gap would
    say nothing) is below ``bar``. Returns the exempted ids."""
    exempt = []
    for rid, p in prompts.items():
        got = out[rid]
        if rid == cancelled:
            if not 0 < len(got) < steps:
                raise AssertionError(f"cancelled stream has {len(got)} tokens")
        elif len(got) != steps:
            raise AssertionError(f"request {rid} has {len(got)} tokens")
        bad = np.nonzero(got != ref(p)[:len(got)])[0]
        if len(bad) == 0:
            continue
        t = int(bad[0])
        gap = float(ref_gaps(p)[t])
        print(f"tie-aware exemption: speculative request {rid} (prompt "
              f"{len(p)}) first differs from generate() at token {t}, top-2 "
              f"gap {gap:.4f}")
        if gap >= bar:
            raise AssertionError(f"request {rid} differs at token {t} with "
                                 f"top-2 gap {gap:.4f} >= {bar:.4f}")
        exempt.append(rid)
    return exempt


def verify_pass_error(torch, lm, draft, prompts, layout, kv):
    """Largest |logits| difference, over ``prompts`` (one per slot), between
    the FIRST row of a speculative verify pass and the plain decode step
    that scores the same token at the same position: two fresh batchers
    admit the same prompts, one takes a lockstep step (chunk 1), the other a
    speculative tick; the target head's outputs are read through a forward
    hook. The two differ in the matmuls' row count (and so, possibly, in
    their summation order), not in the function."""
    from adapt_tpu_torch.config import SpeculativeConfig
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

    seen = []
    hook = lm.head.register_forward_hook(
        lambda mod, args, out: seen.append(out.detach()))
    extra = dict(page_size=128) if layout == "paged" else {}
    try:
        rows = {}
        for mode, kw in (("decode", dict(chunk=1)),
                         ("verify", dict(draft_lm=draft,
                                         speculative=SpeculativeConfig(4)))):
            bat = ContinuousBatcher(lm, slots=len(prompts), kv_layout=layout,
                                    kv_cache_dtype=kv, **extra, **kw)
            for p in prompts:
                bat.submit(p, 8)
            seen.clear()
            bat.tick()
            rows[mode] = [o for o in seen if o.shape[0] == len(prompts)][-1]
    finally:
        hook.remove()
    if rows["decode"].shape[1] != 1 or rows["verify"].shape[1] != 5:
        raise AssertionError("verify_pass_error read the wrong head calls")
    return float((rows["decode"][:, 0] - rows["verify"][:, 0]).abs().max())


def drive_batcher(torch, lm, prompts, steps, kernel, cancel_at,
                  kv_cache_dtype="native", runtime=None):
    """Serve ``prompts`` in two staggered waves; cancel request
    ``cancel_at`` (if not None) once it is live. ``runtime``: the
    batcher's ``RuntimeConfig``. Returns (results, request ids, cancelled
    id, wall s, committed tokens, mean TTFT s, the batcher's stats)."""
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
    from adapt_tpu_torch.utils.metrics import global_metrics

    reg = global_metrics()
    before = reg.snapshot(window=True)
    bat = ContinuousBatcher(lm, slots=8, chunk=8, kernel=kernel,
                            kv_cache_dtype=kv_cache_dtype, runtime=runtime)
    half = len(prompts) // 2
    t0 = time.perf_counter()
    ids = [bat.submit(p, steps) for p in prompts[:half]]
    bat.tick()
    bat.tick()
    ids += [bat.submit(p, steps) for p in prompts[half:]]
    cancelled = None
    if cancel_at is not None:
        cancelled = ids[cancel_at]
        if not bat.cancel(cancelled):
            raise AssertionError("the cancel found no live request")
    out = bat.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    win = reg.snapshot(since=before)
    ttft = win["histograms"].get("continuous.ttft_s", {}).get("mean", 0.0)
    tokens = sum(len(v) for v in out.values())
    return out, ids, cancelled, wall, tokens, ttft, bat.stats()


def paged_traffic(torch, vocab):
    """The paged path's requests, made from seed 7: 8 share a 384-token
    prefix (3 full pages) with unique tails of 16-128, 4 are unique of
    16-512, 4 unique of 600-900 (chunked at prefill_chunk 256). Wave 1 holds
    one prefix request, the unique ones and 3 long; wave 2 the other 7
    prefix requests (prefix hits) and the last long one. The fan-out
    prompt is 2 of the prefix's pages plus 44 tokens."""
    rng = torch.Generator().manual_seed(7)

    def ri(lo, hi):
        return int(torch.randint(lo, hi + 1, (1,), generator=rng))

    def toks(n):
        return torch.randint(0, vocab, (n,), generator=rng).numpy()

    prefix = toks(384)
    shared = [np.concatenate([prefix, toks(ri(16, 128))]) for _ in range(8)]
    unique = [toks(ri(16, 512)) for _ in range(4)]
    longp = [toks(ri(600, 900)) for _ in range(4)]
    wave1 = [shared[0]] + unique + longp[:3]
    wave2 = shared[1:] + longp[3:]
    fan = np.concatenate([prefix[:256], toks(44)])
    return wave1, wave2, fan


def first_gap(torch, lm, prompt, got, ref):
    """None when ``got`` is a prefix of ``ref``; else (t, gap) with t the
    first differing token and gap the top-2 logit gap of the full forward
    over prompt + ref[:t] at the position that picks token t."""
    from adapt_tpu_torch.models.transformer_lm import logits_full

    bad = np.nonzero(got != ref[:len(got)])[0]
    if len(bad) == 0:
        return None
    t = int(bad[0])
    lg = logits_full(lm, np.concatenate([prompt, ref[:t]])[None])[0, -1]
    top2 = torch.topk(lg.float(), 2).values
    return t, float(top2[0] - top2[1])


def drive_paged(torch, lm, kernel, waves, fan, cancel_at,
                kv_cache_dtype="native", prefill_chunk=256, runtime=None,
                **batcher_kw):
    """Serve ``waves`` (two staggered waves) and, if ``fan`` is given, a
    greedy fan-out of 4 through a paged batcher; cancel wave-1 request
    ``cancel_at`` once live. ``runtime``: the batcher's ``RuntimeConfig``;
    ``batcher_kw``: more batcher arguments (``capacity``,
    ``observability``).
    Returns the batcher, {id: prompt}, results, admit events by id, the
    cancelled id, fan-out ids, wall s, committed tokens and mean TTFT s."""
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
    from adapt_tpu_torch.utils.metrics import global_metrics
    from adapt_tpu_torch.utils.tracing import global_flight_recorder

    reg, fr = global_metrics(), global_flight_recorder()
    before = reg.snapshot(window=True)
    _, cursor = fr.events_since(1 << 62)
    bat = ContinuousBatcher(lm, slots=8, chunk=8, kv_layout="paged",
                            page_size=128, prefill_chunk=prefill_chunk,
                            kernel=kernel, kv_cache_dtype=kv_cache_dtype,
                            runtime=runtime, **batcher_kw)
    t0 = time.perf_counter()
    ids = [bat.submit(p, 64) for p in waves[0]]
    bat.tick()
    bat.tick()
    ids += [bat.submit(p, 64) for p in waves[1]]
    cancelled = None
    if cancel_at is not None:
        cancelled = ids[cancel_at]
        if not bat.cancel(cancelled):
            raise AssertionError("the cancel found no live request")
    out = bat.run()
    fan_ids = []
    if fan is not None:
        fan_ids = bat.submit_fanout(fan, 4, 64)
        out.update(bat.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prompts = dict(zip(ids, list(waves[0]) + list(waves[1])))
    prompts.update({r: fan for r in fan_ids})
    events, _ = fr.events_since(cursor)
    admits = {e["data"]["request"]: e["data"] for e in events
              if e["kind"] == "admit"}
    win = reg.snapshot(since=before)
    ttft = win["histograms"].get("continuous.ttft_s", {}).get("mean", 0.0)
    tokens = sum(len(v) for v in out.values())
    return bat, prompts, out, admits, cancelled, fan_ids, wall, tokens, ttft


def check_paged_streams(torch, lm, prompts, out, admits, cancelled, fan_ids,
                        split, ref, bar=0.1, max_exempt=2):
    """Whole-prompt admissions (no hit, not chunked) with split 1 must
    equal their reference stream ``ref(prompt)`` (``generate()`` alone);
    every other stream passes the tie-aware check (a first difference only
    where the full forward's top-2 gap is below ``bar``; at most
    ``max_exempt`` exemptions, None for no cap); fan-out siblings equal the
    first one. Returns (exemptions, {path: count})."""
    exempt, paths = [], {}
    for rid, p in prompts.items():
        a = admits[rid]
        path = ("cow" if a["cow"] else "hit" if a["prefix_pages"] else
                "chunked" if a["chunked"] else "whole")
        paths[path] = paths.get(path, 0) + 1
        got = out[rid]
        if rid == cancelled:
            if not 0 < len(got) < 64:
                raise AssertionError(f"cancelled stream has {len(got)} tokens")
        elif len(got) != 64:
            raise AssertionError(f"request {rid} has {len(got)} tokens")
        if path == "cow":
            if not np.array_equal(got, out[fan_ids[0]]):
                raise AssertionError(f"fan-out sibling {rid} differs from "
                                     "its group's first sibling")
            continue
        want = ref(p)
        if path == "whole" and split is None:
            if not np.array_equal(got, want[:len(got)]):
                bad = int((got != want[:len(got)]).argmax())
                raise AssertionError(f"whole-prompt request {rid} differs "
                                     f"from generate() at token {bad}")
            continue
        tg = first_gap(torch, lm, p, got, want)
        if tg is None:
            continue
        t, gap = tg
        print(f"tie-aware exemption: request {rid} ({path}, prompt "
              f"{len(p)}) first differs from generate() at token {t}, "
              f"top-2 gap {gap:.4f}")
        if gap >= bar:
            raise AssertionError(f"request {rid} differs at token {t} with "
                                 f"top-2 gap {gap:.4f} >= {bar:.4f}")
        exempt.append(rid)
    if max_exempt is not None and len(exempt) > max_exempt:
        raise AssertionError(f"{len(exempt)} streams needed the tie "
                             f"exemption (at most {max_exempt})")
    return exempt, paths


def first_token_logits(bat, prompt):
    """The f32 logits a batcher's admission of ``prompt`` samples its first
    token from (whole-prompt, prefix-hit or final chunked pass, whichever
    the batcher takes), read through its ``_first_pick``."""
    seen = []
    orig = bat._first_pick

    def spy(h_last, req):
        seen.append(bat.lm.head(h_last)[0, 0].float())
        return orig(h_last, req)

    bat._first_pick = spy
    try:
        bat.submit(prompt, 1)
        bat.run()
    finally:
        bat._first_pick = orig
    return seen[-1]


def quantized_pass_error(torch, lm, kv, shared, longp):
    """Largest |first-token logits| difference of a prefix-hit pass (each
    ``shared`` prompt re-submitted, its full prompt pages cached) and of a
    chunked pass (each ``longp`` prompt at prefill_chunk 256) against the
    whole-prompt pass of the same prompt, on ``kv`` pools: these passes
    attend the already quantized window, the whole-prompt pass the native
    K/V. Returns (hit error, chunked error)."""
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

    def fresh(**extra):  # an empty prefix cache: the first pass is whole
        return ContinuousBatcher(lm, slots=1, chunk=8, kv_layout="paged",
                                 page_size=128, kv_cache_dtype=kv, **extra)

    hit_err = chunk_err = 0.0
    for p in shared:
        bat = fresh()
        a = first_token_logits(bat, p)  # whole prompt
        b = first_token_logits(bat, p)  # prefix hit on its own pages
        if bat.stats()["prefix_hits"] < 1:
            raise AssertionError("the re-submitted prompt did not hit")
        hit_err = max(hit_err, float((a - b).abs().max()))
    for p in longp:
        a = first_token_logits(fresh(), p)
        b = first_token_logits(fresh(prefill_chunk=256), p)
        chunk_err = max(chunk_err, float((a - b).abs().max()))
    return hit_err, chunk_err


def agreement(out, ids, prompts, ref, cancelled):
    """Top-1 agreement of served streams with reference streams."""
    same = total = 0
    for rid, p in zip(ids, prompts):
        if rid == cancelled:
            continue
        want = ref(p)
        same += int((out[rid] == want[:len(out[rid])]).sum())
        total += len(out[rid])
    return same / max(total, 1)


def kernel_rows(torch, prof, calls=1):
    """Device time by kernel from a ``torch.profiler`` run of ``calls``
    calls: ``[(ms per call, launches per call, name)]``, largest first."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops: their kernels are listed themselves
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0:
            rows.append((dev / 1e3 / calls, e.count // calls, e.key))
    return sorted(rows, reverse=True)


#: Substrings of the device kernels' names: K4 (the tensor-core and the f32
#: chunk kernels) and K5 (both of its bodies take the verify row policy).
SHARE_OF = {"K4": ("chunk_tc_kernel", "chunk_kernel"),
            "K5": ("VerifyRows",)}


def kernel_share(rows, label):
    """One line: each of SHARE_OF's kernels' ms and launches per call and
    its share of the kernel time in ``rows`` (``kernel_rows``)."""
    busy = sum(r[0] for r in rows)
    parts = []
    for name, marks in SHARE_OF.items():
        hit = [r for r in rows if any(m in r[2] for m in marks)]
        ms = sum(r[0] for r in hit)
        parts.append(f"{name} {ms:.3f} ms, {sum(r[1] for r in hit)} launches"
                     f" = {ms / max(busy, 1e-9):.3f} of {busy:.3f} ms")
    print(f"  kernel share[{label}]: " + "; ".join(parts))


def profile_prefill(torch, lm, card, kv):
    """``--profile``: where the paged path's chunked prefill goes. 8
    prompts of 768 tokens, one new token each, through
    ``ContinuousBatcher(kv_layout="paged", page_size=128,
    prefill_chunk=256)`` (each prompt's second and third chunks attend
    their window through K4); once unprofiled, then the same under
    ``torch.profiler``."""
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

    def run():
        rng = torch.Generator().manual_seed(6)
        bat = ContinuousBatcher(lm, slots=8, chunk=8, kv_layout="paged",
                                page_size=128, prefill_chunk=256,
                                kv_cache_dtype=kv)
        for _ in range(8):
            bat.submit(torch.randint(0, lm.vocab, (768,),
                                     generator=rng).numpy(), 1)
        ticks = 0
        while bat.stats()["active"] or bat.stats()["queued"]:
            bat.tick()
            ticks += 1
        torch.cuda.synchronize()
        return ticks

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ticks = run()
    rows = kernel_rows(torch, prof)
    busy = sum(r[0] for r in rows)
    print(f"profile[paged prefill {kv}] on {card}: 8 prompts of 768 tokens "
          f"in chunks of 256, {ticks} ticks: wall {wall_ms:.2f} ms; kernels "
          f"{busy:.2f} ms = {busy / wall_ms:.3f} of the wall "
          f"({sum(r[1] for r in rows)} launches)")
    for ms, n, key in rows[:10]:
        print(f"  {ms:9.3f} ms  {n:6d} x  {key[:90]}")
    kernel_share(rows, f"paged prefill {kv}")


def profile_decode(torch, lm, card, layout, kv="native", split=None):
    """``--profile``: where a steady decode tick's time goes on one KV
    ``layout`` and cache dtype ``kv`` (with ``split``, at
    ``KernelConfig(decode_split=split)``). 8 slots decode (chunk 8,
    256-token prompts); 4 ticks are timed on the host clock without the
    profiler, then 4 more run under ``torch.profiler`` for device time by
    kernel. Busy share = kernel time / unprofiled wall."""
    from adapt_tpu_torch.config import KernelConfig
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

    rng = torch.Generator().manual_seed(5)
    bat = ContinuousBatcher(lm, slots=8, chunk=8, kv_layout=layout,
                            kv_cache_dtype=kv,
                            kernel=KernelConfig(decode_split=split))
    for _ in range(8):
        bat.submit(torch.randint(0, lm.vocab, (256,), generator=rng).numpy(),
                   400)
    for _ in range(2):
        bat.tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        bat.tick()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(4):
            bat.tick()
        torch.cuda.synchronize()
    rows = kernel_rows(torch, prof)
    busy = sum(r[0] for r in rows)
    steps = 4 * bat.chunk
    label = f"{layout} {kv}" + (f" split{split}" if split else "")
    print(f"profile[{label}] on {card}: 4 steady ticks = {steps} decode "
          f"steps of 8 "
          f"slots: wall {wall_ms:.2f} ms ({wall_ms / steps:.3f} ms/step, "
          f"{8 * steps / wall_ms * 1e3:.1f} tok/s); kernels "
          f"{busy:.2f} ms = {busy / wall_ms:.3f} of the wall "
          f"({sum(r[1] for r in rows) / steps:.0f} launches/step)")
    for ms, n, key in rows[:15]:
        print(f"  {ms:9.3f} ms  {n:6d} x  {key[:90]}")
    if layout == "paged":
        kernel_share(rows, f"paged {kv}, 4 steady ticks")


def profile_spec(torch, lm, draft, spec, card, kv, label):
    """``--profile``: where a steady SPECULATIVE tick's time goes on the
    paged layout: 8 slots (256-token prompts), 4 ticks timed on the host
    clock without the profiler, then 4 more under ``torch.profiler`` for
    device time by kernel. Tokens are what the 4 unprofiled ticks
    committed."""
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

    rng = torch.Generator().manual_seed(5)
    bat = ContinuousBatcher(lm, slots=8, kv_layout="paged", page_size=128,
                            kv_cache_dtype=kv, draft_lm=draft,
                            speculative=spec)
    done = [0]
    for _ in range(8):
        bat.submit(torch.randint(0, lm.vocab, (256,), generator=rng).numpy(),
                   400, on_token=lambda *a: done.__setitem__(0, done[0] + 1))
    for _ in range(2):
        bat.tick()
    torch.cuda.synchronize()
    n0, t0 = done[0], time.perf_counter()
    for _ in range(4):
        bat.tick()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ntok = done[0] - n0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(4):
            bat.tick()
        torch.cuda.synchronize()
    rows = kernel_rows(torch, prof)
    busy = sum(r[0] for r in rows)
    print(f"profile[spec {label}] on {card}: 4 steady ticks of 8 slots: wall "
          f"{wall_ms:.2f} ms ({wall_ms / 4:.3f} ms/tick), {ntok} tokens "
          f"committed ({ntok / 32:.3f} per slot and tick) = "
          f"{ntok / wall_ms * 1e3:.1f} tok/s; acceptance "
          f"{bat.stats()['spec_acceptance']:.4f}; kernels {busy:.2f} ms = "
          f"{busy / wall_ms:.3f} of the wall "
          f"({sum(r[1] for r in rows) / 4:.0f} launches/tick)")
    for ms, n, key in rows[:12]:
        print(f"  {ms:9.3f} ms  {n:6d} x  {key[:90]}")
    kernel_share(rows, f"spec {label}, 4 steady ticks")


K7_CASES = [
    # (label, b, h, s_q, s_k, d, causal, window, valid_from)
    ("vit", 8, 12, 197, 197, 64, False, None, None),
    ("causal", 1, 12, 256, 256, 64, True, None, None),
    ("window64", 1, 12, 256, 256, 64, True, 64, None),
    ("valid_from", 4, 12, 128, 128, 64, True, None, [0, 5, 64, 127]),
    ("d128", 1, 8, 256, 256, 128, True, None, None),
    ("sq70_sk197", 2, 12, 70, 197, 64, False, None, None),
]


def check_k7(torch, A, dev, errs):
    """K7 vs its plain version on the same ``(out, lse)`` from K1, in f32
    (atol = rtol = 2e-4, the JAX package's bar for its streaming backward,
    CUDA cores) and bf16 / f16 (tensor cores; within 1e-2 of the largest
    reference magnitude); dq compared
    on valid rows only under ``valid_from``. Two runs on the same inputs
    must be ``torch.equal``, and each case moves the launch count by 2."""
    g = torch.Generator(device=dev).manual_seed(11)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for label, b, h, s_q, s_k, d, causal, window, vf in K7_CASES:
            def rnd(s):
                return torch.randn(b, h, s, d, generator=g, device=dev).to(
                    dtype)
            q, k, v, do = rnd(s_q), rnd(s_k), rnd(s_k), rnd(s_q)
            vft = None if vf is None else torch.tensor(vf, device=dev)
            out, lse = A.flash_attn_fwd(q, k, v, causal, vft, None, window)
            n0 = A.flash_attn_bwd.launches
            got = A.flash_attn_bwd(q, k, v, out, lse, do, causal, vft, window)
            again = A.flash_attn_bwd(q, k, v, out, lse, do, causal, vft,
                                     window)
            torch.cuda.synchronize()
            if A.flash_attn_bwd.launches != n0 + 2:
                raise AssertionError(f"K7 {label}: launches did not move")
            ref = A.flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                              vft, window)
            worst = 0.0
            for name, a, a2, r in zip(("dq", "dk", "dv"), got, again, ref):
                if not torch.equal(a, a2):
                    raise AssertionError(f"K7 {label} {dtype}: {name} differs "
                                         "between two runs")
                if name == "dq" and vft is not None:
                    keep = torch.arange(s_q, device=dev)[None, :] >= vft[:, None]
                    a, r = a.transpose(1, 2)[keep], r.transpose(1, 2)[keep]
                what = f"K7 {label} {dtype} {name}"
                if dtype == torch.float32:
                    worst = max(worst, close(a, r, 2e-4, 2e-4, what))
                else:
                    e = float((a.float() - r.float()).abs().max())
                    lim = 1e-2 * float(r.float().abs().max())
                    if e > lim:
                        raise AssertionError(f"{what}: max abs err {e:.3e} "
                                             f"over {lim:.3e}")
                    worst = max(worst, e)
            errs["flash_attn_bwd"] = max(errs.get("flash_attn_bwd", 0.0),
                                         worst)
            tol = ("atol 2e-4 + rtol 2e-4" if dtype == torch.float32
                   else "1e-2 x max|ref|")
            print(f"K7 {label} b{b} h{h} s_q{s_q} s_k{s_k} d{d} "
                  f"{str(dtype)[6:]}: max abs err {worst:.3e} (tol {tol}), "
                  "two runs equal")


def plain_attention(torch, A):
    """Every attention of a ViT on the plain versions, as an ``attn_fn``:
    ``_reference_with_lse`` forward, ``flash_attention_bwd_plain`` backward
    (the card's path runs K1 and K7 in their place)."""

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            out, lse = A._reference_with_lse(q, k, v, False)
            ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, do):
            return A.flash_attention_bwd_plain(*ctx.saved_tensors,
                                               do.to(ctx.saved_tensors[0].dtype))

    return PlainFlash.apply


def vit_step(torch, graph, x, y, num_micro, lr, attn_fn=None, steps=1):
    """``steps`` SGD steps of the port's ``make_train_step`` over the graph's
    own modules, every attention through ``attn_fn`` (None: K1 / K7).
    Returns (losses as device tensors, step times in ms on CUDA events, the
    first step's gradients by parameter name)."""
    import functools

    from adapt_tpu_torch.parallel.train import (
        make_pipelined_vit_apply,
        make_train_step,
        split_vit_variables,
    )

    depth = sum(n.startswith("encoder_block_") for n in graph.topo_order())
    for i in range(depth):
        graph.node(f"encoder_block_{i}").module.attn.attn_fn = attn_fn
    params = split_vit_variables(graph, depth)
    step = make_train_step(
        make_pipelined_vit_apply(graph, {"dp": 1, "pp": 1}, num_micro),
        functools.partial(torch.optim.SGD, lr=lr))
    state, losses, times, grads = None, [], [], None
    for i in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        params, state, loss = step(params, state, x, y)
        ev[1].record()
        losses.append(loss)
        times.append(ev)
        if i == 0:
            grads = {n: p.grad.detach().clone()
                     for n, p in graph.named_parameters()}
    torch.cuda.synchronize()
    return losses, [a.elapsed_time(b) for a, b in times], grads


def grad_error(torch, got, ref):
    """The largest relative L2 error over the parameters' gradients."""
    return max(float(torch.linalg.vector_norm((got[n] - r).float())
                     / max(float(torch.linalg.vector_norm(r.float())), 1e-30))
               for n, r in ref.items())


def profile_train(torch, graph, x, y, num_micro, lr, card):
    """``--profile``: one train step's breakdown: its wall on the host clock
    unprofiled, then one more step under ``torch.profiler`` for device time
    by kernel; launches per step, the device's busy share, K1 and K7 ms."""
    vit_step(torch, graph, x, y, num_micro, lr)  # warm
    t0 = time.perf_counter()
    vit_step(torch, graph, x, y, num_micro, lr)
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        vit_step(torch, graph, x, y, num_micro, lr)
        torch.cuda.synchronize()
    rows = kernel_rows(torch, prof)
    busy = sum(r[0] for r in rows)
    k1 = sum(r[0] for r in rows if "flash_fwd_" in r[2])
    k7 = sum(r[0] for r in rows if "flash_bwd_" in r[2])
    print(f"profile[train] on {card}: one step of batch {x.shape[0]} in "
          f"{num_micro} microbatches: wall {wall_ms:.2f} ms; kernels "
          f"{busy:.2f} ms = {busy / wall_ms:.3f} of the wall "
          f"({sum(r[1] for r in rows)} launches/step); K1 {k1:.3f} ms, K7 "
          f"{k7:.3f} ms (both passes)")
    for ms, n, key in rows[:15]:
        print(f"  {ms:9.3f} ms  {n:6d} x  {key[:90]}")


def train_phase(torch, A, dev, card, runs, kernels, errs, build, img,
                classes):
    """Phase 11: the training path through the port's ``make_train_step``
    on ``build`` (``vit_b16``): an f32 step through K1 + K7 against the
    plain versions, five bf16-compute steps, and K7 / K1 timed at the
    path's shape. Returns (a failure message or None, the bf16 run's
    ``(graph, x, y, num_micro, lr)`` for ``--profile``)."""
    F = torch.nn.functional
    LR = 0.005
    gen = torch.Generator().manual_seed(21)

    def batch(n):
        x = torch.randn(n, img, img, 3, generator=gen).to(dev)
        return x, torch.randint(0, classes, (n,), generator=gen).to(dev)

    # (a) f32, batch 8 in 2 microbatches, one step: K1 + K7 vs the plain
    # versions, from the same weights on the same batch.
    t0 = time.perf_counter()
    vit = build(dtype=torch.float32, seed=0)
    nparam = sum(p.numel() for p in vit.parameters())
    depth = sum(n.startswith("encoder_block_") for n in vit.topo_order())
    print(f"{vit.name} built in {time.perf_counter() - t0:.1f} s ({nparam} "
          "parameters)")
    w0 = {k: t.clone() for k, t in vit.state_dict().items()}
    x8, y8 = batch(8)
    plain_fn = plain_attention(torch, A)
    A.flash_attn_fwd.launches = A.flash_attn_bwd.launches = 0
    loss_k, _, g_k = vit_step(torch, vit, x8, y8, 2, LR)
    n_f32 = (A.flash_attn_fwd.launches, A.flash_attn_bwd.launches)
    vit.load_state_dict(w0)
    loss_p, _, g_p = vit_step(torch, vit, x8, y8, 2, LR, plain_fn)
    err32 = grad_error(torch, g_k, g_p)
    if n_f32 != (2 * depth, 2 * depth):
        return (f"f32 ViT step launched K1/K7 {n_f32} times, want "
                f"{2 * depth} each"), None
    if not err32 <= 1e-3:
        return (f"f32 {vit.name} gradients through K1 + K7 differ from the "
                f"plain path by relative L2 {err32:.3e} > 1e-3"), None
    print(f"{vit.name} f32 step (batch 8, 2 microbatches) on {card}: loss "
          f"{float(loss_k[0]):.6f} (plain {float(loss_p[0]):.6f}), largest "
          f"relative L2 gradient error vs the plain path {err32:.3e} (gate "
          f"1e-3), K1/K7 launches {n_f32}")
    del vit, w0, g_k, g_p

    # (b) bf16 compute (f32 parameters), batch 32 in 4 microbatches, 5 SGD
    # steps on one fixed batch. K7's count is one per call, both passes.
    vit = build(dtype=torch.bfloat16, seed=0)
    w0 = {k: t.clone() for k, t in vit.state_dict().items()}
    x32, y32 = batch(32)
    _, _, g_p = vit_step(torch, vit, x32, y32, 4, LR, plain_fn)
    vit.load_state_dict(w0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.flash_attn_fwd.launches = A.flash_attn_bwd.launches = 0
    losses, times, g_k = vit_step(torch, vit, x32, y32, 4, LR, steps=5)
    launches = {"flash_attn_fwd": A.flash_attn_fwd.launches,
                "flash_attn_bwd": A.flash_attn_bwd.launches}
    runs["train"] = launches
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    want = 5 * 4 * depth  # steps x microbatches x blocks
    if launches != {"flash_attn_fwd": want, "flash_attn_bwd": want}:
        return (f"train path launches {launches}, want {want} each ({depth} "
                "blocks x 4 microbatches x 5 steps)"), None
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        return f"bf16 {vit.name} losses {losses}: not finite and falling", None
    step_ms = sum(times[1:]) / len(times[1:])
    err16 = grad_error(torch, g_k, g_p)
    print(f"{vit.name} bf16 training (batch 32, 4 microbatches, SGD lr {LR}) "
          f"on {card}: losses {[round(v, 6) for v in losses]}; step "
          f"{step_ms:.2f} ms (steps 2-5, CUDA events) = "
          f"{32 / step_ms * 1e3:.1f} images/s; peak memory "
          f"{peak / 2**30:.2f} GiB; step-1 gradient error vs the plain path "
          f"(relative L2, not gated) {err16:.3e}; launches {launches} (K7: "
          "one per call, both passes)")

    # K7 at the path's shape: b8 h12 s197 d64 non-causal bf16 (one
    # microbatch of the bf16 run). Bound: the five products over 989
    # TFLOP/s against q, k, v, out, do read + dq, dk, dv written + lse and
    # delta over 3.35 TB/s.
    b, h, s, d = 8, 12, 197, 64
    g = torch.Generator(device=dev).manual_seed(23)
    q, k, v, do = (torch.randn(b, h, s, d, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(4))
    out, lse = A.flash_attn_fwd(q, k, v, False)
    ms = time_ms(lambda: A.flash_attn_bwd(q, k, v, out, lse, do, False))
    plain = time_ms(lambda: A.flash_attention_bwd_plain(q, k, v, out, lse,
                                                        do, False))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    sdpa_f = time_ms(lambda: F.scaled_dot_product_attention(qg, kg, vg))
    sdpa_fb = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qg, kg, vg), (qg, kg, vg), do))
    bms, by = bound(10 * b * h * s * s * d, 8 * b * h * s * d * 2
                    + 2 * b * h * s * 4)
    kernels.append(dict(
        name="flash_attn_bwd", route="cuda",
        source="adapt_tpu_torch/csrc/flash_attn_bwd.cu",
        replaces="adapt_tpu/ops/attention.py:840",
        launches=runs["train"]["flash_attn_bwd"],
        max_abs_err=errs["flash_attn_bwd"], ms=ms, plain_ms=plain,
        bound_ms=bms, bound_by=by, library_ms=sdpa_fb - sdpa_f,
        library_derived="sdpa forward+backward minus sdpa forward",
        shape=f"b{b} h{h} s{s} d{d} non-causal bf16"))
    k1_ms = time_ms(lambda: A.flash_attn_fwd(q, k, v, False))
    with torch.no_grad():
        sdpa_nograd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    k1_bms, k1_by = bound(4 * b * h * s * s * d, 4 * b * h * s * d * 2
                          + b * h * s * 4)
    print(f"at the ViT shape b{b} h{h} s{s} d{d} bf16 on {card}: K7 {ms:.4f} "
          f"ms, SDPA backward {sdpa_fb - sdpa_f:.4f} ms (derived: "
          f"forward+backward {sdpa_fb:.4f} minus forward {sdpa_f:.4f}), bound "
          f"{bms:.4f} by {by}; K1 {k1_ms:.4f} ms, SDPA forward "
          f"{sdpa_nograd:.4f} ms, K1 bound {k1_bms:.4f} by {k1_by}")

    return None, (vit, x32, y32, 4, LR)


def profile_library_backward(torch, card):
    """``--profile``: which kernels one SDPA forward + backward runs at the
    ViT shape (b8 h12 s197 d64 bf16) and their device time, to read K7's
    derived library figure against."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(23)
    q, k, v, do = (torch.randn(8, 12, 197, 64, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        return torch.autograd.grad(F.scaled_dot_product_attention(q, k, v),
                                   (q, k, v), do)

    for _ in range(3):
        fwd_bwd()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            fwd_bwd()
        torch.cuda.synchronize()
    rows = kernel_rows(torch, prof, calls=5)
    print(f"profile[sdpa forward+backward] on {card}: b8 h12 s197 d64 bf16, "
          f"device {sum(r[0] for r in rows):.4f} ms a call")
    for ms, n, key in rows[:8]:
        print(f"  {ms:9.4f} ms  {n:4d} x  {key[:90]}")


def device_ms_each(torch, fns, n=20, by_name=None):
    """Device ms per call of each ``fns[key]()`` from ONE ``torch.profiler``
    session: each function's ``n`` calls (after 3 warm-up calls) end in a
    synchronize and one marker kernel (``torch.cuda._sleep``'s
    ``spin_kernel``), so on the device's own timeline the markers cut the
    events (kernels, copies) into one group per function, in order, however
    long the host stalls (gaps of 10 ms once split a group when a stall
    outlasted them). A lead-in group of ``n`` one-element fills goes first
    and is dropped: the first events after the profiler starts are
    sometimes not recorded. Raises unless there is one group per function
    and each group's event count is a multiple of ``n`` (no call lost an
    event). A dict ``by_name`` receives, per key, the device ms per call of
    each kernel (or copy) name in its group."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    keys = list(fns)
    lead = torch.empty(1, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(0.05)
        for fn in [lead.zero_] + [fns[k] for k in keys]:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    groups = [[0.0, 0, {}]]  # [busy us, event count, {name: us}]
    for start, end, name in dev:
        if "spin_kernel" in name:
            groups.append([0.0, 0, {}])
            continue
        groups[-1][0] += end - start
        groups[-1][1] += 1
        short = name.split("(")[0].split("<")[0].replace("void ", "")
        groups[-1][2][short] = groups[-1][2].get(short, 0.0) + end - start
    groups.pop()  # after the last marker: empty
    if len(groups) != len(keys) + 1 or any(c % n for _, c, _ in groups[1:]):
        raise AssertionError(
            f"device event groups {[c for _, c, _ in groups]} for the "
            f"lead-in and {len(keys)} functions of {n} calls each")
    if by_name is not None:
        for key, (_, c, names) in zip(keys, groups[1:]):
            by_name[key] = {k: us / 1e3 / n for k, us in names.items()}
            by_name[key]["launches"] = c // n
    return {key: us / 1e3 / n for key, (us, _, _) in zip(keys, groups[1:])}


def flash_device_times(torch, A, card):
    """Device time per launch of K1 (ViT shape b8 h12 s197 d64 and LM
    prefill shape b1 h12 s512 d64 causal, bf16) and K7 (ViT shape) under
    ``torch.profiler``, beside SDPA's forward and forward + backward (the
    library's kernels: cuDNN / flash) at the same shapes in the same call.
    Event times of these calls are host-bound; these are the device's."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(29)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(
            torch.bfloat16)

    vit = [rnd(8, 12, 197, 64) for _ in range(4)]
    lm = [rnd(1, 12, 512, 64) for _ in range(3)]
    q, k, v, do = vit
    out, lse = A.flash_attn_fwd(q, k, v, False)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    t = device_ms_each(torch, {
        "k1_vit": lambda: A.flash_attn_fwd(q, k, v, False),
        "k1_lm": lambda: A.flash_attn_fwd(*lm, True),
        "k7_vit": lambda: A.flash_attn_bwd(q, k, v, out, lse, do, False),
        "sdpa_fwd_vit": lambda: F.scaled_dot_product_attention(q, k, v),
        "sdpa_fwd_lm": lambda: F.scaled_dot_product_attention(
            *lm, is_causal=True),
        "sdpa_fwdbwd_vit": lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qg, kg, vg), (qg, kg, vg), do),
    })
    t["sdpa_bwd_vit"] = t["sdpa_fwdbwd_vit"] - t["sdpa_fwd_vit"]
    print(f"device ms per launch on {card} (torch.profiler, 20 launches): "
          f"K1 b8 h12 s197 d64 bf16 {t['k1_vit']:.4f} (SDPA forward "
          f"{t['sdpa_fwd_vit']:.4f}); K1 b1 h12 s512 d64 causal bf16 "
          f"{t['k1_lm']:.4f} (SDPA forward {t['sdpa_fwd_lm']:.4f}); K7 b8 "
          f"h12 s197 d64 bf16 {t['k7_vit']:.4f} (SDPA backward "
          f"{t['sdpa_bwd_vit']:.4f} = forward+backward "
          f"{t['sdpa_fwdbwd_vit']:.4f} minus forward)")
    return t


#: The decode kernels' device-time shapes (b8 kv_h12 g1 hd64 bf16 q, the
#: strip L = 1025, the pool page 128 x 8 pages a slot in 65 pages): "a" the
#: steady decode of ``--profile`` (8 slots after 256-token prompts, every
#: row at 288 live keys), "b" phase 8's (indices spread over 0..1024).
DECODE_SHAPES = ("a", "b")


def decode_device_times(torch, D, P, Q, card, full=True):
    """Device ms per launch (``torch.profiler``) of K2, K3, K2q and K3q
    (int8, int4) at the two DECODE_SHAPES, beside the library's: masked
    SDPA (K2), a gather of the pages + masked SDPA (K3); quantized caches
    have no library call, so a dequantize + SDPA figure is printed. With
    ``full``, also K2-split and K3-split (split 4, their torch combine
    included) at shape b, K4 / K4q at phase 8's chunk shape and K5 / K5q /
    K5-split at phase 10's verify shape (each beside a gather + masked
    SDPA), and K6 (``k6_fns``). ``D``, ``P``, ``Q`` are the
    ops modules of the tree under test (``scripts/decode_ab.py`` passes
    another commit's). All of it is one ``torch.profiler`` session
    (``device_ms_each``). Returns ``{(name, kv, shape): ms}`` and prints
    one line per entry with its bound."""

    def build(rec):
        for shape in DECODE_SHAPES:
            decode_shape_fns(torch, D, P, Q, shape, full, rec)
        if full:
            decode_side_fns(torch, P, Q, rec)
            decode_crossover_fns(torch, D, rec)

    return device_times(torch, card, build)


def device_times(torch, card, build):
    """Device ms a call of every function ``build(rec)`` records with
    ``rec(key, fn, bytes, operations)``, in one ``torch.profiler`` session
    (``device_ms_each``); prints one line per entry with its bound and its
    share of it. Returns ``{key: ms}``."""
    fns, bounds = {}, {}

    def rec(key, fn, nbytes, ops):
        fns[key] = fn
        bounds[key] = bound(ops, nbytes)

    build(rec)
    names = {}
    t = device_ms_each(torch, fns, by_name=names)
    for key, ms in t.items():
        bms, by = bounds[key]
        print(f"device {key[0]}[{key[1]}] shape {key[2]} on {card}: {ms:.4f} "
              f"ms a call, {names[key]['launches']} device events (bound "
              f"{bms:.5f} by {by}, {100 * bms / ms:.1f}% of it)")
        if "split" in key[0]:
            parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(
                names[key].items(), key=lambda kv: -kv[1]) if k != "launches")
            print(f"  by kernel name ({names[key]['launches']} device events "
                  f"a call): {parts}")
    return t


#: b1 strips on which the unsplit K2 is timed against K2-split (split 2, 4,
#: 8): one kv-head row of 12 per slot, every key live.
CROSSOVER_LENGTHS = (1025, 4097, 16385)


def decode_crossover_fns(torch, D, rec):
    """``rec(key, fn, bytes, operations)`` for K2 and K2-split (split 2, 4
    and 8) on b1 kv_h12 g1 hd64 bf16 strips of CROSSOVER_LENGTHS keys,
    index L - 1: where a split starts to beat the unsplit kernel."""
    dev = torch.device("cuda", 0)
    for L in CROSSOVER_LENGTHS:
        q, ck, cv, _ = decode_inputs(torch, dev, 1, 12, 1, L, 64, seed=12)
        idx = torch.full((1,), L - 1, dtype=torch.int32, device=dev)
        nbytes, ops = 2 * 12 * L * 2 * 64 + 2 * 12 * 64 * 2 + 4, 4 * 64 * 12 * L
        rec(("decode_attn", "native", f"b1 L{L}"),
            lambda q=q, ck=ck, cv=cv, idx=idx: D.decode_attn(q, ck, cv, idx),
            nbytes, ops)
        for split in (2, 4, 8):
            rec(("decode_attn_split", "native", f"b1 L{L} split{split}"),
                lambda q=q, ck=ck, cv=cv, idx=idx, sp=split:
                D.decode_attn_split(q, ck, cv, idx, None, sp), nbytes, ops)


def decode_shape_fns(torch, D, P, Q, shape, full, rec):
    """``rec(key, fn, bytes, operations)`` for every decode call that
    ``decode_device_times`` times at DECODE_SHAPES ``shape``."""
    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    B, kvh, G, hd, L = 8, 12, 1, 64, 1025
    q, ck, cv, idx = decode_inputs(torch, dev, B, kvh, G, L, hd, seed=4)
    _, kp, vp, table, pidx = paged_inputs(torch, dev, B, kvh, G, hd, 128, 8,
                                          65, seed=9)
    pidx[-1] = 1023  # all rows live, as phase 8
    if shape == "a":
        idx = torch.full_like(idx, 287)
        pidx = torch.full_like(pidx, 287)
    mask = torch.arange(L, device=dev)[None, :] <= idx[:, None].long()
    pmask = torch.arange(1024, device=dev)[None, :] <= pidx[:, None].long()
    live = float((idx.long() + 1).sum()) * kvh
    plive = float((pidx.long() + 1).sum()) * kvh
    qo = 2 * B * kvh * G * hd * 2 + B * 4
    ops, pops = 4 * G * hd * live, 4 * G * hd * plive

    def dequant(pair):
        return (Q.kv_values(pair[0], hd).float() * pair[1]).to(torch.bfloat16)

    def gather(pool):
        return pool[table.long()].movedim(2, 1).reshape(B, kvh, -1, hd)

    def sdpa(k, v, m):
        return lambda: F.scaled_dot_product_attention(
            q, k(), v(), attn_mask=m[:, None, None, :])

    for kv in ("native",) + KV_DTYPES:
        if kv == "native":
            dk, dv, pk, pv, w = ck, cv, kp, vp, 2 * hd
        else:
            dk, dv = quantized(Q, ck, kv), quantized(Q, cv, kv)
            pk, pv = quantized(Q, kp, kv), quantized(Q, vp, kv)
            w = dk[0].shape[-1] + 4
        rec(("decode_attn", kv, shape),
            lambda dk=dk, dv=dv: D.decode_attn(q, dk, dv, idx),
            2 * live * w + qo, ops)
        rec(("paged_attn", kv, shape),
            lambda pk=pk, pv=pv: P.paged_attn(q, pk, pv, table, pidx),
            2 * plive * w + qo + table.numel() * 4, pops)
        if kv == "native":
            rec(("sdpa_masked", kv, shape), sdpa(lambda: ck, lambda: cv, mask),
                2 * live * w + qo, ops)
            rec(("gather_sdpa", kv, shape),
                sdpa(lambda: gather(kp), lambda: gather(vp), pmask),
                2 * plive * w + qo, pops)
        else:
            rec(("dequant_sdpa", kv, shape),
                sdpa(lambda dk=dk: dequant(dk), lambda dv=dv: dequant(dv),
                     mask), 2 * live * w + qo, ops)
        if full and shape == "b":
            rec(("decode_attn_split", kv, shape),
                lambda dk=dk, dv=dv: D.decode_attn_split(q, dk, dv, idx, None,
                                                         4),
                2 * live * w + qo, ops)
            rec(("paged_attn_split", kv, shape),
                lambda pk=pk, pv=pv: P.paged_attn_split(q, pk, pv, table,
                                                        pidx, None, 4),
                2 * plive * w + qo + table.numel() * 4, pops)


def decode_side_fns(torch, P, Q, rec):
    """``rec(key, fn, bytes, operations)`` for K4 / K4q (int8, int4) at
    phase 8's chunk shape beside a gather of the pages + masked SDPA, K5 /
    K5q (int8, int4) / K5-split (split 4) at phase 10's verify shape beside
    a gather + masked SDPA, and K6 (``k6_fns``)."""
    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    B, kvh, G, hd = 8, 12, 1, 64
    C, pos0 = 256, 512  # K4 at phase 8's chunked-prefill pass
    cq, ckp, cvp, pages = chunk_inputs(torch, dev, kvh, 1, hd, C, pos0)
    pairs = sum(pos0 + r + 1 for r in range(C)) * kvh
    cshape = f"C{C} pos0 {pos0}"
    cmask = (torch.arange(pages.numel() * 128, device=dev)[None, :]
             <= pos0 + torch.arange(C, device=dev)[:, None])
    cio = 2 * kvh * C * hd * 2 + pages.numel() * 4

    def gather_sdpa_chunk():
        ks = ckp[pages.long()].movedim(1, 0).reshape(1, kvh, -1, hd)
        vs = cvp[pages.long()].movedim(1, 0).reshape(1, kvh, -1, hd)
        return F.scaled_dot_product_attention(cq, ks, vs, attn_mask=cmask)

    for kv in ("native",) + KV_DTYPES:
        if kv == "native":
            kp, vp, w = ckp, cvp, 2 * hd
        else:
            kp, vp = quantized(Q, ckp, kv), quantized(Q, cvp, kv)
            w = kp[0].shape[-1] + 4
        rec(("paged_chunk_attn", kv, cshape),
            lambda kp=kp, vp=vp: P.paged_chunk_attn(cq, kp, vp, pages, pos0,
                                                    C),
            2 * (pos0 + C) * kvh * w + cio, 4 * pairs * hd)
    rec(("gather_sdpa_chunk", "native", cshape), gather_sdpa_chunk,
        2 * (pos0 + C) * kvh * hd * 2 + cio, 4 * pairs * hd)
    KC = 5  # K5 at phase 10's verify pass
    q, kp, vp, table, idx = verify_inputs(torch, dev, B, kvh, G, KC, hd, 128,
                                          8, 65)
    vlive = float((idx.clamp(min=-KC).long() + KC).sum()) * kvh
    pairs5 = float(sum((idx.clamp(min=-t - 1).long() + t + 1).sum()
                       for t in range(KC))) * kvh
    vio = 2 * B * kvh * G * KC * hd * 2 + table.numel() * 4
    vmask = P.verify_live(idx, B, G * KC, 8 * 128, KC, None, 0, dev)

    def sdpa_verify():
        ks = kp[table.long()].movedim(2, 1).reshape(B, kvh, -1, hd)
        vs = vp[table.long()].movedim(2, 1).reshape(B, kvh, -1, hd)
        return F.scaled_dot_product_attention(q, ks, vs,
                                              attn_mask=vmask[:, None])

    for kv in ("native",) + KV_DTYPES:
        if kv == "native":
            pk, pv, w = kp, vp, 2 * hd
        else:
            pk, pv = quantized(Q, kp, kv), quantized(Q, vp, kv)
            w = pk[0].shape[-1] + 4
        rec(("paged_verify_attn", kv, f"kc{KC}"),
            lambda pk=pk, pv=pv: P.paged_verify_attn(q, pk, pv, table, idx,
                                                     KC),
            2 * vlive * w + vio, 4 * pairs5 * hd)
    rec(("paged_verify_attn_split", "native", f"kc{KC}"),
        lambda: P.paged_verify_attn_split(q, kp, vp, table, idx, KC, None, 0,
                                          4),
        2 * vlive * 2 * hd + vio, 4 * pairs5 * hd)
    rec(("sdpa_verify", "native", f"kc{KC}"), sdpa_verify,
        2 * vlive * 2 * hd + vio, 4 * pairs5 * hd)
    k6_fns(torch, Q, rec)


def k6_fns(torch, Q, rec):
    """``rec(key, fn, bytes, operations)`` for K6 quantize and dequantize at
    each draft matrix's shape and dtype (DRAFT_LEAVES) and for one whole
    ``dequantize_params`` of the draft's tree (``("dequantize_params",
    "draft2", "11 leaves")``: every launch it makes). Dequantize moves n
    int8 + the scales + n outputs, quantize n inputs + the padded int8
    payload + the scales."""
    tree = draft_tree(torch, Q)
    for shape, dt in dict.fromkeys((s_, d_) for _, s_, d_ in DRAFT_LEAVES):
        qt = next(v for v in tree.values() if v.shape == shape
                  and str(v.dtype).endswith(dt))
        x = Q.dequantize_reference(qt)
        n, nb, es = x.numel(), qt.scales.numel(), x.element_size()
        tag = {"float32": "f32", "bfloat16": "bf16"}[dt]
        rec(("quantize_blocks", tag, str(shape)),
            lambda x=x: Q.quantize_blocks(x), n * es + nb * 8192 + nb * 4, 0)
        rec(("dequantize_blocks", tag, str(shape)),
            lambda qt=qt: Q.dequantize_blocks(qt), n + nb * 4 + n * es, 0)
    total = sum(math.prod(qt.shape) * (1 + torch.finfo(qt.dtype).bits // 8)
                + qt.scales.numel() * 4 for qt in tree.values())
    rec(("dequantize_params", "draft2", f"{len(tree)} leaves"),
        lambda: Q.dequantize_params(tree), total, 0)


def add_device_times(kernels, dec_ms):
    """Write ``decode_device_times``'s figures into the kernels' JSON rows:
    ``device_ms`` at the row's shape (phase 8's, shape b) and, for K2 / K3
    (and K2q / K3q), ``steady_device_ms`` at shape a; the library's device
    time beside them (masked SDPA, gather + masked SDPA; a dequantize +
    SDPA figure for the quantized branches, which have no library call);
    K6's at (768, 3072) bf16 and, for dequantize, ``call_device_ms`` of one
    whole ``dequantize_params`` of the draft's tree."""
    libs = {"decode_attn": "sdpa_masked", "decode_attn_split": "sdpa_masked",
            "paged_attn": "gather_sdpa", "paged_attn_split": "gather_sdpa"}
    for kr in kernels:
        base, _, kv = kr["name"].partition("[")
        kv = kv.rstrip("]") or "native"
        if base in ("decode_attn", "paged_attn"):
            kr.update(device_ms=dec_ms[(base, kv, "b")],
                      steady_device_ms=dec_ms[(base, kv, "a")])
            if kv == "native":
                kr.update(
                    library_device_ms=dec_ms[(libs[base], kv, "b")],
                    steady_library_device_ms=dec_ms[(libs[base], kv, "a")])
            elif base == "decode_attn":
                kr.update(dequant_sdpa_device_ms=dec_ms[("dequant_sdpa", kv,
                                                         "b")])
        elif base in ("decode_attn_split", "paged_attn_split"):
            kr["device_ms"] = dec_ms[(base, kv, "b")]
            if kv == "native":
                kr["library_device_ms"] = dec_ms[(libs[base], kv, "b")]
        elif base in ("paged_chunk_attn", "paged_verify_attn",
                      "paged_verify_attn_split"):
            kr["device_ms"] = next(v for k, v in dec_ms.items()
                                   if k[:2] == (base, kv))
            if kv == "native":
                lib = ("gather_sdpa_chunk" if base == "paged_chunk_attn"
                       else "sdpa_verify")
                kr["library_device_ms"] = next(
                    v for k, v in dec_ms.items() if k[0] == lib)
        elif kr["name"] in ("quantize_blocks", "dequantize_blocks"):
            kr["device_ms"] = dec_ms[(kr["name"], "bf16", "(768, 3072)")]
            if kr["name"] == "dequantize_blocks":
                kr["call_device_ms"] = next(
                    v for k, v in dec_ms.items() if k[0] == "dequantize_params")


def ptxas_entries(log, marker):
    """``[(entry, registers, spill bytes)]`` of the kernels whose mangled
    name holds ``marker``, from one ``-Xptxas -v`` build log."""
    import re

    out = []
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if marker in line and "Compiling entry" in line:
            kern = line.split("'")[1] if "'" in line else line
            info = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", info)
            spill = re.findall(r"(\d+) bytes spill", info)
            out.append((kern, int(regs.group(1)) if regs else -1,
                        sum(int(x) for x in spill)))
    return out


def ptxas_report(_build):
    """The compiler's registers and spills: each tensor-core kernel (K1, K7
    and K4 / K5's 16-bit instantiations, every cache element), K6's
    kernels (quantize per input dtype, the grouped dequantize), and a
    summary of the CUDA-core cluster kernels' instantiations (K2 / K3, and
    K5's f32 ones: every head dim, cache element and padded g) with K2 /
    K3's main path's (bf16, hd 64, g 1) named, from this process's
    build."""
    for name, marker, main in (
            ("flash_attn_fwd", "_tc_kernel", None),
            ("flash_attn_bwd", "_tc_kernel", None),
            ("paged_chunk_attn", "chunk_tc_kernel", None),
            ("paged_verify_attn", "verify_tc_kernel", None),
            ("quantize_blocks", "quantize_kernel", None),
            ("dequantize_blocks", "dequantize_kernel", None),
            ("decode_attn", "decode_cluster_kernel", "Li64ELi1E"),
            ("paged_attn", "decode_cluster_kernel", "Li64ELi1E"),
            ("paged_verify_attn", "decode_cluster_kernel", "f32")):
        if name not in _build.LOGS:
            print(f"ptxas {name}: built before this process, no report")
            continue
        ents = ptxas_entries(_build.LOGS[name], marker)
        if main is None:
            for kern, regs, spill in ents:
                print(f"ptxas {name}: {kern}: {regs} registers, {spill} "
                      "bytes spilled")
            continue
        regs = [r for _, r, _ in ents]
        print(f"ptxas {name}: {len(ents)} cluster instantiations, "
              f"{min(regs)}-{max(regs)} registers, "
              f"{sum(sp for _, _, sp in ents)} bytes spilled in all")
        for kern, r, sp in ents:
            if "13__nv_bfloat16" + main in kern:
                elem = ("int8" if "Int8KV" in kern else "int4" if "Int4KV"
                        in kern else "native")
                print(f"ptxas {name}: bf16 hd64 G{main[-2]} {elem}: {r} "
                      f"registers, {sp} bytes spilled")


def device_ms_sum(torch, fn, n=5):
    """(device ms, device events) per call of ``fn()``, from one
    ``torch.profiler`` session of ``n`` calls after a warm-up call: the sum
    of every device event's duration (kernels, copies; one stream runs them
    one at a time). No markers: with a session a model, the profiler once
    lost ``device_ms_each``'s markers and its first events; so the sum is
    a floor, and the event count shows a loss."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = [e.time_range.end - e.time_range.start for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(dev) / 1e3 / n, len(dev) / n


def local_pipeline_case(torch, A, dev, card, label, graph, cuts, xs, tol,
                        k1_per_request=0, oracle=None):
    """Phase 12, one model: ``graph`` cut at ``cuts`` into a LocalPipeline
    of 3 stages on ``dev``; ``infer`` and ``stream`` over the requests
    ``xs``, every output within ``tol`` x max|ref| of ``graph.apply`` on
    the same card. With ``oracle`` (x -> (the f32 truth, the graph's own
    output with every kernel on its plain version)), every stream output
    also lies within max(``tol``, 2 x the plain output's error) x
    max|truth| of the truth: as close to it as the plain versions come,
    in the compute dtype's own rounding noise. Images/s of
    ``graph.apply`` alone, ``infer`` and ``stream`` (host clock around work
    ending in a synchronize); the card's busy share under ``infer``
    (device ms a request under ``torch.profiler`` over the unprofiled wall
    ms a request); with ``k1_per_request``, K1's launches over the stream
    (counts set to 0 just before it) must be that many per request.
    Returns K1's count."""
    from adapt_tpu_torch.graph.partition import partition
    from adapt_tpu_torch.runtime.pipeline import LocalPipeline

    plan = partition(graph, cuts)
    n_img = sum(x.shape[0] for x in xs)
    shapes = graph.eval_shapes(xs[0])
    cut_desc = ", ".join(
        f"{c} {tuple(shapes[c].shape)} {str(shapes[c].dtype)[6:]} "
        f"{shapes[c].numel() * shapes[c].element_size() / 1e6:.1f} MB"
        for c in plan.cuts)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.no_grad():
        refs = [graph.apply(x) for x in xs]  # also the warm-up
        refs, t_apply = timed(lambda: [graph.apply(x) for x in xs])
        truths = [oracle(x) for x in xs] if oracle is not None else []
    pipe = LocalPipeline(plan, devices=[dev] * plan.num_stages)
    pipe.warmup(xs[0])
    infer, t_infer = timed(lambda: [pipe.infer(x) for x in xs])
    A.flash_attn_fwd.launches = 0
    stream, t_stream = timed(lambda: pipe.stream(xs))
    k1 = A.flash_attn_fwd.launches
    dev_ms, launches = device_ms_sum(torch, lambda: pipe.infer(xs[0]))
    stage_ms, acts = [], xs  # each stage alone over every request
    for stage in pipe.stages:
        acts, t = timed(lambda: [stage(a) for a in acts])
        stage_ms.append(t / len(xs) * 1e3)
    if len(stream) != len(xs):
        raise AssertionError(f"{label}: stream returned {len(stream)} of "
                             f"{len(xs)} outputs")
    worst, bit_equal = 0.0, True
    for i, (y, ref) in enumerate(zip(infer + stream, refs + refs)):
        scale = float(ref.float().abs().max())
        err = float((y.float() - ref.float()).abs().max())
        if not err <= tol * scale:
            raise AssertionError(
                f"{label}: output {i} differs from graph.apply by {err:.3e} "
                f"> {tol} x max|ref| {scale:.3e}")
        worst = max(worst, err / scale)
        bit_equal = bit_equal and torch.equal(y, ref)
    worst_truth = worst_plain = 0.0
    for i, (y, (truth, plain)) in enumerate(zip(stream, truths)):
        scale = float(truth.float().abs().max())
        err = float((y.float() - truth.float()).abs().max()) / scale
        err_plain = float((plain.float() - truth.float()).abs().max()) / scale
        if not err <= max(tol, 2 * err_plain):
            raise AssertionError(
                f"{label}: output {i} differs from the f32 truth by {err:.3e}"
                f" x max|truth|, over max({tol}, 2 x the plain versions' "
                f"{err_plain:.3e})")
        worst_truth = max(worst_truth, err)
        worst_plain = max(worst_plain, err_plain)
    if k1_per_request and k1 != k1_per_request * len(xs):
        raise AssertionError(f"{label}: K1 launched {k1} times over "
                             f"{len(xs)} requests, want {k1_per_request} "
                             "each")
    print(f"{label} LocalPipeline ({plan.num_stages} stages {list(plan.cuts)}) "
          f"on {card}: {len(xs)} requests of batch {xs[0].shape[0]}; "
          f"images/s graph.apply {n_img / t_apply:.1f}, infer "
          f"{n_img / t_infer:.1f}, stream {n_img / t_stream:.1f}; outputs "
          f"vs graph.apply: largest error {worst:.3e} x max|ref| (gate "
          f"{tol}), bit-equal {bit_equal}"
          + (f"; vs the f32 truth (plain versions, f32): stream's largest "
             f"error {worst_truth:.3e} x max|truth|, the plain versions' "
             f"own {worst_plain:.3e} (bar max({tol}, 2 x that a request))"
             if truths else "")
          + f"; infer wall {t_infer / len(xs) * 1e3:.3f} ms a request, "
          f"device {dev_ms:.3f} ms in {launches:g} device events "
          f"(torch.profiler): busy share "
          f"{dev_ms / (t_infer / len(xs) * 1e3):.3f}; stage ms a request "
          f"(each alone) "
          f"{[round(t, 3) for t in stage_ms]}, no hop (stage outputs stay on "
          f"the card); eval_shapes at the cuts: "
          f"{cut_desc}" + (f"; K1 launches {k1} ({k1 // len(xs)} a request)"
                           if k1_per_request else ""))
    return k1


def serving_case(torch, A, dev, card, graph, cuts, x, n_req, tol):
    """Phase 12, the graft scenario on the card: ``graph`` cut at ``cuts``
    behind ``ServingPipeline`` with four workers on ``dev``; ``n_req``
    requests of ``x``, worker 0 crashed at request 5 and worker 1 hung at
    request 9. Gates: every result within ``tol`` x max|ref| of
    ``graph.apply``, none failed, at least ``n_req`` completed, worker 1
    not DEAD, no stage module built by the failover, the last result
    within 10 x (deadline + lease TTL) of the crash."""
    from adapt_tpu_torch.config import FaultConfig, ServeConfig
    from adapt_tpu_torch.control.worker import WorkerState
    from adapt_tpu_torch.graph.partition import partition
    from adapt_tpu_torch.runtime.pipeline import ServingPipeline
    from adapt_tpu_torch.utils.metrics import global_metrics

    plan = partition(graph, cuts)
    with torch.no_grad():
        ref = graph.apply(x)
    scale = float(ref.float().abs().max())
    cfg = ServeConfig(max_inflight=8, fault=FaultConfig(
        lease_ttl_s=0.5, heartbeat_s=0.1, task_deadline_s=2.0,
        watchdog_period_s=0.05, startup_wait_s=10.0, max_retries=4,
        quarantine_strikes=2))
    global_metrics().reset()
    with ServingPipeline(plan, None, [dev] * 4, cfg) as pipe:
        pipe.warmup(x)
        builds = pipe.dispatcher.stage_builds
        A.flash_attn_fwd.launches = 0
        t0 = time.perf_counter()
        futures, t_kill = [], None
        for i in range(n_req):
            futures.append(pipe.dispatcher.submit(x))
            if i == 5:
                pipe.kill_worker(0, mode="crash")
                t_kill = time.monotonic()
            elif i == 9:
                pipe.kill_worker(1, mode="hang")
        results = [f.result(120.0) for f in futures]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        recovery_s = time.monotonic() - t_kill
        k1 = A.flash_attn_fwd.launches
        snap = global_metrics().snapshot()
        counters = snap["counters"]
        stage_p50 = [round(snap["histograms"][f"stage{i}.latency_s"]["p50"]
                           * 1e3, 3) for i in range(plan.num_stages)]
        hung_state = pipe.workers[1].state
        after = pipe.dispatcher.stage_builds
    errs = [float((y.float() - ref.float()).abs().max()) for y in results]
    budget = 10 * (cfg.fault.task_deadline_s + cfg.fault.lease_ttl_s)
    failures = [
        (f"a result differs from graph.apply by {max(errs):.3e} > {tol} x "
         f"max|ref| {scale:.3e}") if not max(errs) <= tol * scale else None,
        (f"{counters.get('dispatcher.failed', 0)} requests failed")
        if counters.get("dispatcher.failed", 0) else None,
        (f"{counters.get('dispatcher.completed', 0)} completed < {n_req}")
        if counters.get("dispatcher.completed", 0) < n_req else None,
        "the hung worker was marked DEAD"
        if hung_state is WorkerState.DEAD else None,
        f"the failover built stage modules ({builds} -> {after})"
        if after != builds else None,
        f"recovery {recovery_s:.2f} s over the budget {budget} s"
        if not recovery_s < budget else None,
    ]
    failures = [f for f in failures if f]
    if failures:
        raise AssertionError("ServingPipeline graft scenario: "
                             + "; ".join(failures))
    n_img = n_req * x.shape[0]
    print(f"ServingPipeline graft scenario ({plan.num_stages} stages, 4 "
          f"workers on one card, {n_req} requests of batch {x.shape[0]}, "
          f"crash at 5, hang at 9) on {card}: recovery {recovery_s:.3f} s "
          f"(budget {budget} s), {n_img / wall:.1f} images/s over the run, "
          f"re-dispatches {counters.get('dispatcher.redispatched', 0):.0f}, "
          f"quarantines {counters.get('dispatcher.quarantined', 0):.0f}, "
          f"completed {counters.get('dispatcher.completed', 0):.0f}, failed "
          f"0, stage builds {builds} before and after, K1 launches {k1}; "
          f"stage dispatch-to-result ms p50 {stage_p50}; "
          f"largest error vs graph.apply {max(errs) / scale:.3e} x max|ref| "
          f"(gate {tol}), bit-equal {all(e == 0 for e in errs)}")
    return k1, n_img / wall


def vit_oracle(torch, A, graph, graph32, x, errs):
    """For a ViT ``graph`` and its f32 twin ``graph32`` (same weights):
    first K1 against its plain version on the q / k / v every block of
    ``graph`` gives it on ``x`` (``check_k1``'s tolerance; the largest
    error goes into ``errs``); then x -> (``graph32``'s output with every
    attention on K1's plain version, the f32 truth; ``graph``'s with the
    same), without autograd."""
    plain = plain_attention(torch, A)

    def blocks(g):
        return [g.node(n).module.attn for n in g.topo_order()
                if n.startswith("encoder_block_")]

    def on_plain(g, x):
        for b in blocks(g):
            b.attn_fn = plain
        try:
            return g.apply(x)
        finally:
            for b in blocks(g):
                b.attn_fn = None

    worst, shape = [], []

    def both(q, k, v):
        shape[:] = [q.shape, q.dtype]
        out, _ = A.flash_attn_fwd(q, k, v, False)
        ref, _ = A._reference_with_lse(q, k, v, False)
        worst.append(close(out, ref, 1e-2, 1e-2,
                           f"K1 on ViT block {len(worst)}'s own q / k / v"))
        return out

    with torch.no_grad():
        for b in blocks(graph):
            b.attn_fn = both
        try:
            graph.apply(x)
        finally:
            for b in blocks(graph):
                b.attn_fn = None
    errs["flash_attn_fwd"] = max(errs.get("flash_attn_fwd", 0.0), *worst)
    print(f"K1 vs plain on the q / k / v of {len(worst)} ViT blocks "
          f"({tuple(shape[0])} {str(shape[1])[6:]}): max abs err "
          f"{max(worst):.3e} (tol 1e-2 + 1e-2|ref|)")

    def run(x):
        with torch.no_grad():
            return on_plain(graph32, x), on_plain(graph, x)

    return run


def pipeline_phase(torch, A, dev, card, kernels, cases, serve):
    """Phase 12: the paper's pipeline on the card. ``cases``: (label,
    build(dtype) -> graph, cuts or None for ``balanced_cuts(graph, 3)``,
    image size, batch, requests, dtype, K1 launches a request); ``serve``:
    (build, cuts, image size, batch, requests) for the graft scenario,
    bf16 (None: no graft scenario). Returns K1's launches on the ViT
    LocalPipeline's stream and the graft scenario's images/s."""
    from adapt_tpu_torch.graph.partition import balanced_cuts

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(29)
    k1_pipeline, path_errs, serve_rate = None, {}, None
    for label, build, cuts, img, batch, n_req, dtype, k1_each in cases:
        graph = build(dtype)
        xs = [torch.randn(batch, img, img, 3, generator=gen, device=dev)
              for _ in range(n_req)]
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        oracle = (vit_oracle(torch, A, graph, build(torch.float32), xs[0],
                             path_errs) if k1_each else None)
        k1 = local_pipeline_case(
            torch, A, dev, card, f"{label} {str(dtype)[6:]}", graph,
            cuts or balanced_cuts(graph, 3), xs, tol, k1_each, oracle)
        if k1_each:
            k1_pipeline = k1
        del graph, xs, oracle
    if serve is not None:
        build, cuts, img, batch, n_req = serve
        x = torch.randn(batch, img, img, 3, generator=gen, device=dev)
        _, serve_rate = serving_case(torch, A, dev, card,
                                     build(torch.bfloat16), cuts, x, n_req,
                                     1e-2)
    print(f"phase 12 (pipelines) took {time.perf_counter() - t_phase:.1f} s "
          f"on {card}")
    for kr in kernels:
        if kr["name"] == "flash_attn_fwd" and k1_pipeline is not None:
            kr.update(pipeline_launches=k1_pipeline,
                      pipeline_shape="ViT-B/16 LocalPipeline stream, 3 "
                      "stages, 32 requests of batch 8, bf16",
                      pipeline_max_abs_err=path_errs["flash_attn_fwd"])
    return k1_pipeline, serve_rate


def pipeline_cases(torch, dev):
    """Phase 12's models at full width and depth, random weights from seed
    0: ResNet-50 (``conv7`` stem, 1000 classes, 224 x 224 x 3, batch 8, the
    3-stage cuts) and EfficientNet-B4 (380 x 380, batch 4, 3 stages from
    ``balanced_cuts``) in f32 and bf16 compute, ViT-B/16 (bf16, batch 8,
    ``vit_block_cuts(12, 3)``, 12 K1 launches a request), 32 requests each;
    the graft scenario on ViT-B/16, 16 requests of batch 8."""
    from adapt_tpu_torch.models.efficientnet import efficientnet_b4
    from adapt_tpu_torch.models.resnet import RESNET50_3STAGE_CUTS, resnet50
    from adapt_tpu_torch.models.vit import vit_b16, vit_block_cuts

    def res(dt):
        return resnet50(1000, dt, device=dev, seed=0)

    def eff(dt):
        return efficientnet_b4(1000, dt, device=dev, seed=0)

    def vit(dt):
        return vit_b16(1000, dt, device=dev, seed=0)

    r50, vcuts = RESNET50_3STAGE_CUTS, vit_block_cuts(12, 3)
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("ResNet-50", res, r50, 224, 8, 32, f32, 0),
        ("ResNet-50", res, r50, 224, 8, 32, bf16, 0),
        ("EfficientNet-B4", eff, None, 380, 4, 32, f32, 0),
        ("EfficientNet-B4", eff, None, 380, 4, 32, bf16, 0),
        ("ViT-B/16", vit, vcuts, 224, 8, 32, bf16, 12),
    ], (vit, vcuts, 224, 8, 16)


# -- phase 13: the paper's pipeline across processes ---------------------------


def remote_fault(FaultConfig, **kw):
    """Phase 13's fault settings: phase 12's deadline and watchdog, leases
    renewed by the worker processes' pings (every 0.2 s), and waits long
    enough for a worker process to reach the card and for a stage's
    weights to cross a socket."""
    base = dict(lease_ttl_s=1.0, heartbeat_s=0.2, task_deadline_s=2.0,
                watchdog_period_s=0.05, startup_wait_s=90.0, max_retries=4,
                quarantine_strikes=2, configure_timeout_s=120.0,
                send_timeout_s=30.0)
    base.update(kw)
    return FaultConfig(**base)


class WorkerProcs:
    """Stage-worker processes on the card (``python -m
    adapt_tpu_torch.comm.remote --port 0 --device cuda:0 --no-tf32``: TF32
    off, as in this process), started with ``subprocess`` (never a fork of
    this CUDA process); each prints its
    port once it listens. stderr goes to a file whose tail a failure
    prints; :meth:`close` stops every one."""

    def __init__(self, root, logdir, device):
        self.root, self.logdir, self.device = root, logdir, device
        self.procs, self.logs = [], []

    def start(self, *args):
        env = dict(os.environ, PYTHONPATH=self.root)
        log = open(os.path.join(self.logdir, f"worker{len(self.procs)}.log"),
                   "w")
        self.logs.append(log)
        proc = subprocess.Popen(
            [sys.executable, "-m", "adapt_tpu_torch.comm.remote", "--port",
             "0", "--device", self.device, "--heartbeat", "0.2",
             "--no-tf32", *args],
            cwd=self.root, env=env, stdout=subprocess.PIPE, stderr=log,
            text=True)
        self.procs.append(proc)
        return proc

    @staticmethod
    def port(proc) -> int:
        """The port a worker printed (``listening HOST:PORT``): printed
        after its device is resolved, so the card is up in it."""
        line = proc.stdout.readline().split()
        if not line or line[0] != "listening":
            raise AssertionError(f"worker process {proc.pid} did not start "
                                 f"(exit {proc.poll()}): {line}")
        return int(line[1].rpartition(":")[2])

    def tails(self) -> str:
        out = []
        for log in self.logs:
            log.flush()
            with open(log.name) as f:
                tail = f.read()[-2000:]
            if tail.strip():
                out.append(f"--- {os.path.basename(log.name)}\n{tail}")
        return "\n".join(out)

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=15)
            p.stdout.close()
        for log in self.logs:
            log.close()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(cond, what, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 13: {what} not within {timeout} s")
        time.sleep(0.02)


def rel_err(y, ref) -> float:
    return float((y.to(ref.device).float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def served(torch, dispatcher, xs, label):
    """Submit every request of ``xs`` (``max_inflight`` at a time) and wait
    for all: (outputs, wall s, counters, stage dispatch-to-result p50 ms).
    Fails unless each request completed exactly once and none failed."""
    from adapt_tpu_torch.utils.metrics import global_metrics

    global_metrics().reset()
    t0 = time.perf_counter()
    futures = [dispatcher.submit(x) for x in xs]
    outs = [f.result(300.0) for f in futures]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = global_metrics().snapshot()
    c = snap["counters"]
    done, failed = c.get("dispatcher.completed", 0), c.get(
        "dispatcher.failed", 0)
    if failed or done != len(xs) or len({f.request_id for f in futures}) \
            != len(xs):
        raise AssertionError(f"{label}: {done:.0f} completed, {failed:.0f} "
                             f"failed of {len(xs)} requests")
    p50 = [round(snap["histograms"][f"stage{i}.latency_s"]["p50"] * 1e3, 3)
           for i in range(3) if f"stage{i}.latency_s" in snap["histograms"]]
    return outs, wall, c, p50


def check_equal(torch, outs, refs, label):
    bad = [i for i, (y, r) in enumerate(zip(outs, refs))
           if not torch.equal(y.to(r.device), r)]
    if bad:
        raise AssertionError(
            f"{label}: outputs {bad[:4]} differ from graph.apply (largest "
            f"{max(rel_err(outs[i], refs[i]) for i in bad):.3e} x max|ref|)")


def resnet_remote_runs(torch, Q, dev, card, procs, srv, kernels, tmp, case):
    """Phase 13 (a), (b), (f), (e) on ``case`` = (graph, 3-stage cuts,
    the recipe workers rebuild it from, requests): a ``ServingPipeline``
    with no in-process worker and a gateway, joined by two worker processes
    and by ``srv`` (a server in this process, over loopback TCP, so its K6
    counts are this process's). Stage i is configured on worker i (``srv``
    stage 0). Returns the images/s of the hub runs and the chain."""
    from adapt_tpu_torch.comm.remote import RemoteWorkerProxy
    from adapt_tpu_torch.config import CodecConfig, FaultConfig, ServeConfig
    from adapt_tpu_torch.control.dispatcher import Dispatcher
    from adapt_tpu_torch.control.journal import DispatcherJournal
    from adapt_tpu_torch.graph.partition import partition
    from adapt_tpu_torch.runtime.pipeline import LocalPipeline, ServingPipeline

    import signal
    import threading

    graph, cuts, recipe, xs = case
    plan = partition(graph, cuts)
    gen = torch.Generator(device=dev).manual_seed(37)
    with torch.no_grad():
        refs = [graph.apply(x) for x in xs]
    shapes = graph.eval_shapes(xs[0])
    hop_raw = (xs[0].numel() * 4 + 2 * sum(
        shapes[c].numel() * 4 for c in cuts) + refs[0].numel() * 4)
    # The int8dev bar: the error of the same hops inside one process.
    local = LocalPipeline.from_config(
        plan, devices=[dev] * 3,
        config=ServeConfig(codec=CodecConfig(name="int8dev")))
    local_err = max(rel_err(y, r) for y, r in zip(local.stream(xs), refs))
    del local

    gw = free_port()
    cfg = ServeConfig(fault=remote_fault(FaultConfig))
    pipe = ServingPipeline(plan, None, devices=[], config=cfg,
                           gateway_model_config=recipe, gateway_port=gw,
                           gateway_device=dev)
    joiners = [procs.start("--connect", f"127.0.0.1:{gw}", "--worker-id",
                           f"w{i}") for i in (1, 2)]
    threading.Thread(target=srv.connect_and_serve,
                     args=(("127.0.0.1", gw), "w0"), daemon=True).start()
    t0 = time.perf_counter()
    pipe.start()
    ports = [procs.port(p) for p in joiners]
    wait_for(lambda: {"w0", "w1", "w2"} <= set(pipe.registry.alive()),
             "three workers joining the gateway")
    print(f"phase 13: 2 worker processes and this process's server joined "
          f"the gateway in {time.perf_counter() - t0:.1f} s")
    by_id = {p.worker_id: p for p in pipe.gateway.proxies}
    order = [by_id["w0"], by_id["w1"], by_id["w2"]]
    host = plan.extract_variables()

    def pin(codec):
        for i, p in enumerate(order):
            p.set_codec(codec)
            p.configure(i, None, host[i])

    rates = {}
    try:
        for codec in ("none", "int8dev", "lz"):
            pin(codec)
            pipe.dispatcher.warmup(xs[0])  # first calls in every process
            for p in order:
                p.bytes_sent = p.result_bytes_received = 0
            Q.quantize_blocks.launches = Q.dequantize_blocks.launches = 0
            ex0 = srv.executed
            got_before = sum(p.results_received for p in order)
            outs, wall, c, p50 = served(torch, pipe.dispatcher, xs,
                                        f"hub {codec}")
            nq, nd = Q.quantize_blocks.launches, Q.dequantize_blocks.launches
            wire = sum(p.bytes_sent + p.result_bytes_received for p in order)
            rates[codec] = len(xs) * 8 / wall
            extra = ""
            if codec == "int8dev":
                err = max(rel_err(y, r) for y, r in zip(outs, refs))
                bar = max(1e-2, 2 * local_err)
                if not err <= bar:
                    raise AssertionError(
                        f"hub int8dev: error {err:.3e} x max|ref| over "
                        f"max(1e-2, 2 x LocalPipeline int8dev's "
                        f"{local_err:.3e})")
                # This process quantizes every stage input the hub sends and
                # its own stage's outputs, and dequantizes every result the
                # hub receives and its own stage's inputs: with no
                # re-dispatch, 3 + 1 hops each way a request.
                here = srv.executed - ex0
                sent = c.get("dispatcher.tasks_sent", 0)
                got = sum(p.results_received for p in order) - got_before
                if (nq, nd) != (sent + here, got + here) or not here:
                    raise AssertionError(
                        f"hub int8dev: K6 quantize {nq} / dequantize {nd} "
                        f"launches in this process for {sent:.0f} stage "
                        f"inputs sent, {got} results received and {here} "
                        f"stage runs here; want {sent + here:.0f} / "
                        f"{got + here}")
                for kr in kernels:
                    if kr["name"] in ("quantize_blocks", "dequantize_blocks"):
                        kr.update(remote_launches=(
                            nq if kr["name"] == "quantize_blocks" else nd),
                            remote_path=(
                                f"phase 13 hub int8dev run, {graph.name} "
                                f"f32, {len(xs)} requests of batch "
                                f"{xs[0].shape[0]}: launches in the smoke's "
                                "process (hub + its own stage-0 server), 4 a "
                                "request without re-dispatch"))
                extra = (f"; error {err:.3e} x max|ref| (LocalPipeline "
                         f"int8dev {local_err:.3e}, bar {bar:.3e}); K6 "
                         f"launches here {nq} quantize / {nd} dequantize "
                         f"({nq / len(xs):g} / {nd / len(xs):g} hops a "
                         f"request over {len(xs)} requests, {here} stage "
                         "runs here)")
            else:
                check_equal(torch, outs, refs, f"hub {codec}")
                extra = "; every output torch.equal to graph.apply"
            print(f"phase 13 (a) hub over 3 workers (2 processes + 1 in this "
                  f"process), {graph.name} f32, codec {codec}, on {card}: "
                  f"{rates[codec]:.1f} images/s, wire / raw bytes "
                  f"{wire / (hop_raw * len(xs)):.4f}, stage dispatch-to-"
                  f"result p50 ms {p50}, re-dispatches "
                  f"{c.get('dispatcher.redispatched', 0):.0f}{extra}")

        # (f) the chain over the same workers, then the middle one killed
        # mid-burst.
        pin("none")
        pipe.dispatcher.setup_chain(["w0", "w1", "w2"])
        got0 = [p.results_received for p in order]
        outs, wall, c, _ = served(torch, pipe.dispatcher, xs, "chain")
        check_equal(torch, outs, refs, "chain")
        got = [p.results_received - g for p, g in zip(order, got0)]
        if got != [0, 0, len(xs)]:
            raise AssertionError(f"chain: results per hub link {got}, want "
                                 f"[0, 0, {len(xs)}]")
        rates["chain"] = len(xs) * 8 / wall
        box = {}
        burst = threading.Thread(target=lambda: box.update(
            r=served(torch, pipe.dispatcher, xs, "chain kill")), daemon=True)
        tail0 = order[2].results_received
        burst.start()
        wait_for(lambda: order[2].results_received - tail0 >= len(xs) // 4,
                 "a quarter of the burst's chained results before the kill")
        os.kill(joiners[0].pid, signal.SIGKILL)
        burst.join(300.0)
        if "r" not in box:
            raise AssertionError("chain kill: the burst did not finish")
        outs, wall_k, c, _ = box["r"]
        check_equal(torch, outs, refs, "chain kill")
        if pipe.dispatcher._chain is not None:
            raise AssertionError("chain kill: the chain is still enabled")
        print(f"phase 13 (f) chain w0 -> w1 -> w2 (codec none) on {card}: "
              f"{rates['chain']:.1f} images/s, the hub received only the "
              f"tail's {len(xs)} results, every output torch.equal to "
              f"graph.apply; middle worker SIGKILLed after {len(xs) // 4} "
              f"chained results: the chain fell back to the hub, all {len(xs)} "
              f"completed once ({c.get('dispatcher.redispatched', 0):.0f} "
              f"re-dispatched, {c.get('dispatcher.chain_disabled', 0):.0f} "
              f"chain disable), torch.equal, {len(xs) * 8 / wall_k:.1f} "
              f"images/s over the burst")
    finally:
        pipe.shutdown()

    # (e) a journaled dispatcher over the survivors as dial-out workers,
    # crashed with requests in flight, then recovered.
    jroot = os.path.join(tmp, "journal")
    journal = DispatcherJournal(jroot)
    disp = Dispatcher(plan, None, config=cfg, journal=journal)
    for wid, port in (("r0", srv.port), ("r2", ports[1])):
        disp.attach_worker(RemoteWorkerProxy(
            wid, ("127.0.0.1", port), disp.registry, disp.result_queue,
            model_config=recipe, fault=cfg.fault, result_device=dev))
    disp_b = None
    try:
        disp.start()
        disp.warmup(xs[0])
        futures = [disp.submit(x) for x in xs[:8]]
        futures[0].result(120.0)
        disp.hard_stop()
        # Two requests accepted but never dispatched: the replay set is
        # never empty, however fast the pool drained the eight.
        last = max(f.request_id for f in futures)
        for rid, x in ((last + 1, xs[8]), (last + 2, xs[9])):
            journal.record_submit(rid, x)
        journal.close()
        _, pending, _ = DispatcherJournal(jroot).load()
        t0 = time.perf_counter()
        disp_b, recovered = Dispatcher.recover(
            plan, None, DispatcherJournal(jroot), config=cfg,
            result_device=dev)
        outs = {rid: f.result(120.0) for rid, f in recovered.items()}
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        if set(recovered) != set(pending):
            raise AssertionError(f"recovery replayed {sorted(recovered)}, "
                                 f"the journal held {sorted(pending)}")
        with torch.no_grad():
            check_equal(torch, list(outs.values()),
                        [graph.apply(pending[r].to(dev)) for r in outs],
                        "recovery")
        wait_for(lambda: not disp_b._journal.pending_ids(),
                 "the replayed requests' done marks", 30.0)
    finally:
        if disp_b is not None:
            disp_b.shutdown()
        else:
            disp.shutdown()
    left = DispatcherJournal(jroot).load()[1]
    if left:
        raise AssertionError(f"recovery left {sorted(left)} pending")
    print(f"phase 13 (e) dispatcher hard_stop with {len(pending)} journaled "
          f"requests pending (of 8 submitted and 2 accepted but never "
          f"dispatched), recovered over 2 re-adopted dial-out workers in "
          f"{rec_s:.3f} s (recover() to the last replayed result) "
          f"on {card}: each completed once, torch.equal to graph.apply, "
          "the journal drained")

    # (b) K6 at the hop shapes, timed beside the plain version and the
    # bound (ops against 67 TFLOP/s, as phase 10).
    for c in cuts:
        x = torch.randn(*shapes[c].shape, generator=gen, device=dev)
        qt = Q.quantize_blocks(x)
        n, nb = x.numel(), qt.scales.numel()
        for kr in kernels:
            if kr["name"] == "quantize_blocks":
                fn, plain = (lambda: Q.quantize_blocks(x),
                             lambda: Q.quantize_reference(x))
                ops, nbytes = 3 * n, n * 4 + nb * 8192 + nb * 4
            elif kr["name"] == "dequantize_blocks":
                fn, plain = (lambda: Q.dequantize_blocks(qt),
                             lambda: Q.dequantize_reference(qt))
                ops, nbytes = n, nb * 8192 + nb * 4 + n * 4
            else:
                continue
            bms = max(ops / 67e12, nbytes / PEAK_BYTES) * 1e3
            kr.setdefault("hop", []).append(dict(
                shape=f"{tuple(x.shape)} f32", ms=time_ms(fn),
                plain_ms=time_ms(plain), bound_ms=bms))
    return rates


def vit_remote_runs(torch, A, dev, card, procs, vprocs, srv, kernels, case):
    """Phase 13 (c) and (d) on ``case`` = (a bf16 ViT graph, 3-stage cuts,
    the recipe, requests, K1 launches a stage run): three worker processes,
    codec none; then the graft faults over four workers (the three and
    ``srv``): a SIGKILL of worker 0 at request 5, an ``MSG_KILL`` hang of
    worker 1 at request 9."""
    from adapt_tpu_torch.comm.remote import RemoteWorkerProxy
    from adapt_tpu_torch.config import FaultConfig, ServeConfig
    from adapt_tpu_torch.control.dispatcher import Dispatcher
    from adapt_tpu_torch.control.worker import WorkerState
    from adapt_tpu_torch.graph.partition import partition

    import signal

    graph, cuts, recipe, xs, k1_each = case
    plan = partition(graph, cuts)
    with torch.no_grad():
        refs = [graph.apply(x) for x in xs]
    cfg = ServeConfig(fault=remote_fault(FaultConfig))
    host = plan.extract_variables()
    ports = [procs.port(p) for p in vprocs]

    def dispatcher(addrs):
        disp = Dispatcher(plan, None, config=cfg)
        proxies = [RemoteWorkerProxy(
            f"v{i}", ("127.0.0.1", port), disp.registry, disp.result_queue,
            model_config=recipe, fault=cfg.fault, result_device=dev)
            for i, port in enumerate(addrs)]
        for p in proxies:
            disp.attach_worker(p)
        disp.start()
        for i, p in enumerate(proxies[:3]):
            p.configure(i, None, host[i])
        disp.warmup(xs[0])  # first calls in every process
        return disp, proxies

    disp, _ = dispatcher(ports)
    try:
        outs, wall, _, p50 = served(torch, disp, xs, "ViT over 3 processes")
        check_equal(torch, outs, refs, "ViT over 3 processes")
    finally:
        disp.shutdown()
    rate = len(xs) * 8 / wall
    print(f"phase 13 (c) {graph.name} bf16 over 3 worker processes (K1 in "
          f"each), "
          f"codec none, on {card}: {rate:.1f} images/s, stage dispatch-to-"
          f"result p50 ms {p50}, every output torch.equal to graph.apply")

    # (d): stage 0 on v0 (SIGKILLed), 1 on v1 (hung), 2 on this process's
    # server, whose K1 launches are counted here; v3 spare.
    order = [ports[0], ports[1], srv.port, ports[2]]
    disp, proxies = dispatcher(order)
    try:
        A.flash_attn_fwd.launches = 0
        ex0 = srv.executed
        from adapt_tpu_torch.utils.metrics import global_metrics

        global_metrics().reset()
        t0 = time.perf_counter()
        futures, t_kill = [], None
        for i, x in enumerate(xs):
            futures.append(disp.submit(x))
            if i == 5:
                os.kill(vprocs[0].pid, signal.SIGKILL)
                t_kill = time.monotonic()
            elif i == 9:
                proxies[1].kill("hang")
        outs = [f.result(300.0) for f in futures]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        recovery_s = time.monotonic() - t_kill
        k1, here = A.flash_attn_fwd.launches, srv.executed - ex0
        c = global_metrics().snapshot()["counters"]
        hung = proxies[1].state
        builds = disp.stage_builds
    finally:
        disp.shutdown()
    errs = [rel_err(y, r) for y, r in zip(outs, refs)]
    budget = 10 * (cfg.fault.task_deadline_s + cfg.fault.lease_ttl_s)
    failures = [
        f"a result differs from graph.apply by {max(errs):.3e} x max|ref| "
        "> 1e-2" if not max(errs) <= 1e-2 else None,
        f"{c.get('dispatcher.failed', 0):.0f} requests failed"
        if c.get("dispatcher.failed", 0) else None,
        f"{c.get('dispatcher.completed', 0):.0f} completed < {len(xs)}"
        if c.get("dispatcher.completed", 0) < len(xs) else None,
        "the hung worker was marked DEAD" if hung is WorkerState.DEAD
        else None,
        f"the hub built {builds} stage modules" if builds else None,
        f"recovery {recovery_s:.2f} s over the budget {budget} s"
        if not recovery_s < budget else None,
        f"K1 launched {k1} times here for {here} stage runs here, want "
        f"{k1_each} each and at least one run"
        if not (here and k1 == k1_each * here) else None,
    ]
    failures = [f for f in failures if f]
    if failures:
        raise AssertionError("phase 13 (d) graft faults across processes: "
                             + "; ".join(failures))
    for kr in kernels:
        if kr["name"] == "flash_attn_fwd":
            kr.update(remote_launches=k1, remote_path=(
                f"phase 13 (d) {graph.name} over 4 workers: launches in the "
                f"smoke's own stage server, {k1_each} a stage run"))
    print(f"phase 13 (d) graft faults across processes ({graph.name}, 4 "
          f"workers: 3 processes + this process's server; {len(xs)} requests "
          f"of batch {xs[0].shape[0]}, "
          f"SIGKILL of worker 0 at 5, MSG_KILL hang of worker 1 at 9) on "
          f"{card}: recovery {recovery_s:.3f} s (budget {budget} s), "
          f"{len(xs) * 8 / wall:.1f} images/s over the run, re-dispatches "
          f"{c.get('dispatcher.redispatched', 0):.0f}, quarantines "
          f"{c.get('dispatcher.quarantined', 0):.0f}, completed "
          f"{c.get('dispatcher.completed', 0):.0f}, failed 0, the hung worker "
          f"{hung.value}, hub stage builds 0; K1 {k1} launches in this "
          f"process's server ({here} stage runs); largest error "
          f"{max(errs):.3e} x max|ref|, bit-equal "
          f"{all(e == 0 for e in errs)}")
    return rate


def remote_cases(torch, dev):
    """Phase 13's models at full width and depth, random weights from seed
    0, and the recipes the workers rebuild them from by registry name:
    ResNet-50 f32 (``conv7``, 1000 classes, ``RESNET50_3STAGE_CUTS``), 32
    requests of batch 8 at 224; ViT-B/16 bf16 (``vit_block_cuts(12, 3)``,
    4 K1 launches a stage run), 16 requests of batch 8."""
    from adapt_tpu_torch.models.resnet import RESNET50_3STAGE_CUTS, resnet50
    from adapt_tpu_torch.models.vit import vit_b16, vit_block_cuts

    gen = torch.Generator(device=dev).manual_seed(37)

    def images(n):
        return [torch.randn(8, 224, 224, 3, generator=gen, device=dev)
                for _ in range(n)]

    rcuts, vcuts = list(RESNET50_3STAGE_CUTS), vit_block_cuts(12, 3)
    return ((resnet50(1000, torch.float32, device=dev, seed=0), rcuts,
             {"model": "resnet50", "num_classes": 1000, "cuts": rcuts},
             images(32)),
            (vit_b16(1000, torch.bfloat16, device=dev, seed=0), vcuts,
             {"model": "vit_b16", "num_classes": 1000, "cuts": vcuts,
              "model_kwargs": {"dtype": "bfloat16"}}, images(16), 4))


def remote_phase(torch, A, Q, dev, card, kernels, root, inproc_rate,
                 cases):
    """Phase 13: the paper's pipeline across processes on the card (see
    the module docstring); ``cases``: :func:`remote_cases`.
    ``inproc_rate``: phase 12's in-process ``ServingPipeline`` images/s,
    printed beside the process runs."""
    import shutil
    import tempfile
    import threading

    from adapt_tpu_torch.comm.remote import RemoteStageServer

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase13-")
    procs = WorkerProcs(root, tmp, "cuda:0" if dev.type == "cuda" else "cpu")
    srv = None
    try:
        # The ViT workers start now: their processes reach the card while
        # the ResNet runs go.
        vprocs = [procs.start() for _ in range(3)]
        srv = RemoteStageServer(0, device=dev, heartbeat_s=0.2)
        srv.listen()
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        rates = resnet_remote_runs(torch, Q, dev, card, procs, srv, kernels,
                                   tmp, cases[0])
        vit_rate = vit_remote_runs(torch, A, dev, card, procs, vprocs, srv,
                                   kernels, cases[1])
    except BaseException:
        print(procs.tails(), file=sys.stderr)
        raise
    finally:
        if srv is not None:
            srv.shutdown()
        procs.close()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 13 images/s on {card}: {cases[0][0].name} f32 hub "
          + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
          + f"; {cases[1][0].name} bf16 over 3 processes {vit_rate:.1f}, "
          f"phase 12's "
          f"in-process ServingPipeline (4 threads on the card) "
          f"{inproc_rate:.1f}")
    print(f"phase 13 (pipeline across processes) took "
          f"{time.perf_counter() - t_phase:.1f} s on {card}")


# -- phase 14: traffic control and the pipelined tick ------------------------


def need_launches(path, launches, want):
    """Fail unless every kernel in ``want`` launched in ``path``'s run."""
    if any(launches[k] == 0 for k in want):
        raise AssertionError(f"{path}: a kernel of the path did not "
                             f"launch: {launches}")


def counted(counters, path, want, runs, fn):
    """Run ``fn()`` with every launch count set to 0 just before it; read
    the counts just after into ``runs[path]`` and gate them on ``want``."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    runs[path] = {k: c.launches for k, c in counters.items()}
    need_launches(path, runs[path], want)
    return out


def sched_prompts(torch, vocab):
    """Phase 14 (a)'s prompts from seed 14: 13 ``batch`` prompts of
    256-512 tokens (the 13th is the submit the burst cap refuses) and 8
    ``interactive`` ones of 16-128."""
    rng = torch.Generator().manual_seed(14)

    def toks(lo, hi):
        n = int(torch.randint(lo, hi + 1, (1,), generator=rng))
        return torch.randint(0, vocab, (n,), generator=rng).numpy()

    return ([toks(256, 512) for _ in range(13)],
            [toks(16, 128) for _ in range(8)])


def top2_gap(torch, lm, prompt, ref, t):
    """The top-2 logit gap of the full forward over prompt + ref[:t] at the
    position that picks token t."""
    from adapt_tpu_torch.models.transformer_lm import logits_full

    lg = logits_full(lm, np.concatenate([prompt, ref[:t]])[None])[0, -1]
    top2 = torch.topk(lg.float(), 2).values
    return float(top2[0] - top2[1])


def preempt_part(torch, lm, card, counters, runs, bar=0.1):
    """Phase 14 (a): 12 ``batch`` requests (priority 0, 192 new tokens)
    fill the 8 slots of a paged batcher with ``SchedulerConfig(quotas=
    {"batch": TenantQuota(1, burst=12), "interactive": TenantQuota(2)},
    cache_aware=True)``; a 13th batch submit must raise QueueFullError
    synchronously; then 8 ``interactive`` requests (priority 1, 32 tokens,
    TTFT budget 0.25 s) arrive while every slot decodes. Gates: a
    preemption happens and each victim re-admits as a prefix hit; every
    ``on_token`` stream holds each index once and equals ``result()`` except
    at a counted regeneration mismatch (allowed only at a reference top-2
    gap below ``bar``); every stream passes the tie-aware check against
    ``generate()``; the pool drains."""
    from adapt_tpu_torch.config import SchedulerConfig, SLOSpec, TenantQuota
    from adapt_tpu_torch.models.transformer_lm import generate
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
    from adapt_tpu_torch.runtime.scheduler import QueueFullError
    from adapt_tpu_torch.utils.metrics import global_metrics
    from adapt_tpu_torch.utils.tracing import global_flight_recorder

    batch, inter = sched_prompts(torch, lm.vocab)
    fr, reg = global_flight_recorder(), global_metrics()
    delivered: dict[int, list] = {}

    def on_token(rid, tok, idx):
        delivered.setdefault(rid, []).append((idx, tok))

    def serve():
        _, cursor = fr.events_since(1 << 62)
        before = reg.snapshot(window=True)
        bat = ContinuousBatcher(
            lm, slots=8, chunk=8, kv_layout="paged", page_size=128,
            pool_pages=65, prefill_chunk=256,
            scheduler=SchedulerConfig(
                quotas={"batch": TenantQuota(1, burst=12),
                        "interactive": TenantQuota(2)},
                cache_aware=True))
        t0 = time.perf_counter()
        reqs = {}
        for p in batch[:12]:
            reqs[bat.submit(p, 192, on_token=on_token,
                            slo=SLOSpec(tenant="batch"))] = (p, 192)
        try:
            bat.submit(batch[12], 192, slo=SLOSpec(tenant="batch"))
        except QueueFullError as e:
            refused = str(e)
        else:
            raise AssertionError("phase 14 (a): the 13th queued batch "
                                 "submit was accepted")
        while sum(1 for s in bat.slots
                  if s.req is not None and s.pf_done < 0) < 8:
            bat.tick()  # every slot decoding
        for p in inter:
            reqs[bat.submit(p, 32, on_token=on_token,
                            slo=SLOSpec(ttft_budget_s=0.25,
                                        tenant="interactive",
                                        priority=1))] = (p, 32)
        out = bat.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events, _ = fr.events_since(cursor)
        return (bat, reqs, out, refused, wall, events,
                reg.snapshot(since=before))

    bat, reqs, out, refused, wall, events, win = counted(
        counters, "sched_preempt", ("flash_attn_fwd", "paged_attn",
                                    "paged_chunk_attn"), runs, serve)
    st = bat.stats()
    victims = [e["data"]["request"] for e in events
               if e["kind"] == "preempted"]
    if not victims or st["preempted"] != len(victims):
        raise AssertionError(f"phase 14 (a): no preemption ({st['preempted']}"
                             f", events {victims})")
    admits: dict[int, list] = {}
    for e in events:
        if e["kind"] == "admit":
            admits.setdefault(e["data"]["request"], []).append(e["data"])
    for v in set(victims):
        later = admits[v][1:]
        if not later or any(a["prefix_pages"] == 0 for a in later):
            raise AssertionError(f"phase 14 (a): victim {v} re-admitted "
                                 f"without a prefix hit: {admits[v]}")
    if st["pages_in_use"] != 0 or st["pages_free"] != st["pool_pages"] - 1 \
            or st["active"] or st["queued"]:
        raise AssertionError(f"phase 14 (a): the pool did not drain: {st}")
    mismatch = {}
    for e in events:
        if e["kind"] == "regen_mismatch":
            mismatch.setdefault(e["data"]["request"], []).append(
                e["data"]["index"])
    exempt = 0
    for rid, (p, steps) in reqs.items():
        got = out[rid]
        ref = generate(lm, p[None], steps)[0].cpu().numpy()  # alone
        if len(got) != steps:
            raise AssertionError(f"phase 14 (a): request {rid} has "
                                 f"{len(got)} tokens")
        idx = [i for i, _ in delivered.get(rid, [])]
        if idx != list(range(steps)):
            raise AssertionError(f"phase 14 (a): request {rid}'s on_token "
                                 "indices are not 0..n-1 exactly once")
        streamed = np.asarray([t for _, t in delivered[rid]])
        for t in np.nonzero(streamed != got)[0]:
            if int(t) not in mismatch.get(rid, []):
                raise AssertionError(f"phase 14 (a): request {rid}'s stream "
                                     f"differs from result() at {t}")
        for t in mismatch.get(rid, []):
            gap = top2_gap(torch, lm, p, ref, t)
            print(f"phase 14 (a) regeneration mismatch: request {rid} index "
                  f"{t}: delivered {streamed[t]}, regenerated {got[t]}, "
                  f"generate() {ref[t]}, reference top-2 gap {gap:.4f}")
            if gap >= bar:
                raise AssertionError(f"phase 14 (a): regeneration mismatch "
                                     f"at a gap {gap:.4f} >= {bar}")
        tg = first_gap(torch, lm, p, got, ref)
        if tg is not None:
            t, gap = tg
            print(f"tie-aware exemption: phase 14 (a) request {rid} (prompt "
                  f"{len(p)}) first differs from generate() at token {t}, "
                  f"top-2 gap {gap:.4f}")
            if gap >= bar:
                raise AssertionError(f"phase 14 (a): request {rid} differs at "
                                     f"token {t} with top-2 gap {gap:.4f}")
            exempt += 1
    ntok = sum(len(v) for v in out.values())
    h = win["histograms"].get("continuous.ttft_s", {})
    g = reg.snapshot()["gauges"]
    print(f"phase 14 (a) preemption on {card}: {len(reqs)} requests (13th "
          f"batch submit refused: {refused!r}), {len(victims)} preemptions "
          f"(victims {sorted(set(victims))}, each re-admitted as a prefix "
          f"hit), {st['regen_mismatches']} regeneration mismatches, "
          f"{exempt} tie exemptions, {ntok} tokens in {wall:.3f} s = "
          f"{ntok / wall:.1f} tok/s, TTFT mean {h.get('mean', 0) * 1e3:.1f} "
          f"ms p99 {h.get('p99', 0) * 1e3:.1f} ms, slo.ttft_attainment "
          f"{g.get('slo.ttft_attainment', float('nan')):.3f}, prefix_hits "
          f"{st['prefix_hits']}, launches {runs['sched_preempt']}")


def ladder_part(torch, lm, draft2, Q, S, card, counters, runs, solo,
                solo_gaps, prompts8, bar):
    """Phase 14 (b): phase 10 (b)'s 2-layer int8-weight draft on an int8
    pool (``draft_k=4``) behind ``SchedulerConfig(max_queue_depth=16,
    degrade_dwell_s=0.05, preempt=False)``: after one warm request (cached
    pages to evict), a burst of 32 submits (``prompts8`` four times, every
    fourth at priority -1), one a tick, some refused. Gates: the ladder
    climbs draft_k 4 -> 2, busy_threshold (a no-op: no disaggregated
    server), evict_cached, reject_best_effort, at least one best-effort
    submit is refused by the shed, and it comes back down to level 0 and
    draft_k 4; every stream passes the speculative tie-aware check at
    ``bar``; K6 makes one dequantize launch set per draft call."""
    from adapt_tpu_torch.config import (SchedulerConfig, SLOSpec,
                                        SpeculativeConfig)
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
    from adapt_tpu_torch.runtime.scheduler import (DegradationController,
                                                   QueueFullError)
    from adapt_tpu_torch.utils.tracing import global_flight_recorder

    qdraft = Q.quantize_params(draft2.state_dict())
    Q.dequantize_blocks.launches = 0
    Q.dequantize_params(qdraft)
    per_call = Q.dequantize_blocks.launches
    fr = global_flight_recorder()
    draft_calls = [0]
    deq = S.dequantize_params

    def counting(tree):
        draft_calls[0] += 1
        return deq(tree)

    def serve():
        _, cursor = fr.events_since(1 << 62)
        bat = ContinuousBatcher(
            lm, slots=8, chunk=8, kv_layout="paged", page_size=128,
            kv_cache_dtype="int8", draft_lm=draft2,
            speculative=SpeculativeConfig(draft_k=4,
                                          draft_weight_dtype="int8"),
            scheduler=SchedulerConfig(max_queue_depth=16,
                                      degrade_dwell_s=0.05, preempt=False))
        t0 = time.perf_counter()
        warm = bat.submit(prompts8[0], 64)
        done = bat.run()
        reqs = {warm: prompts8[0]}
        refused = {"bound": 0, "shed": 0}
        low_k = []
        for j in range(32):
            p = prompts8[j % 8]
            try:
                reqs[bat.submit(p, 64, slo=SLOSpec(
                    tenant="burst", priority=-1 if j % 4 == 3 else 0))] = p
            except QueueFullError as e:
                refused["shed" if "best-effort" in str(e) else "bound"] += 1
            bat.tick()
            low_k.append(bat._spec_k_eff)
        done.update(bat.run())
        level, idle = bat.stats()["degradation_level"], 0
        while level > 0 and idle < 40:  # calm ticks step it back down
            time.sleep(0.06)
            bat.tick()
            level, idle = bat.stats()["degradation_level"], idle + 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events, _ = fr.events_since(cursor)
        return bat, reqs, done, refused, low_k, wall, events

    S.dequantize_params = counting
    try:
        bat, reqs, out, refused, low_k, wall, events = counted(
            counters, "sched_ladder",
            ("flash_attn_fwd", "decode_attn", "paged_verify_attn",
             "quantize_blocks", "dequantize_blocks"),
            runs, serve)
    finally:
        S.dequantize_params = deq
    launches = runs["sched_ladder"]
    if launches["dequantize_blocks"] != draft_calls[0] * per_call:
        raise AssertionError(f"phase 14 (b): {launches['dequantize_blocks']} "
                             f"K6 dequantize launches for {draft_calls[0]} "
                             f"draft calls (want {per_call} a call)")
    steps = [(e["data"]["step"], e["data"]["direction"]) for e in events
             if e["kind"] == "degradation_step"]
    ladder = list(DegradationController.LADDER)
    ups = [s for s, d in steps if d == "up"]
    downs = [s for s, d in steps if d == "down"]
    st = bat.stats()
    if ups[:4] != ladder or downs[-4:] != ladder[::-1] or min(low_k) != 2 \
            or st["degradation_level"] != 0 or bat._spec_k_eff != 4 \
            or not refused["shed"]:
        raise AssertionError(f"phase 14 (b): the ladder went {steps}, "
                             f"draft_k over the burst {low_k}, refused "
                             f"{refused}, final {st}")
    if st["pages_in_use"] != 0 or st["active"] or st["queued"]:
        raise AssertionError(f"phase 14 (b): the pool did not drain: {st}")
    exempt = check_spec_streams(
        reqs, out, None, 64, lambda p: solo(p, None, "int8"),
        lambda p: solo_gaps(p, None, "int8"), bar)
    ntok = sum(len(v) for v in out.values())
    print(f"phase 14 (b) ladder under speculation on {card}: {len(reqs)} "
          f"requests served, refused {refused} of the burst of 32, ladder "
          f"{steps}, draft_k 2 from the burst's tick {low_k.index(2)}, "
          f"acceptance "
          f"{st['spec_acceptance']:.4f}, {len(exempt)} tie exemptions at bar "
          f"{bar:.4f}, {ntok} tokens in {wall:.3f} s, {draft_calls[0]} draft "
          f"calls, {launches['dequantize_blocks']} K6 dequantize launches, "
          f"launches {launches}")


def steady_sync_check(torch, lm, card, layout):
    """Phase 14 (c): one steady depth-2 tick on ``layout`` (8 slots of
    256-token prompts, every slot decoding, a tick in flight) makes 0
    host->device copies and 1 fetch, and its dispatch half runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (no stream sync, no
    blocking copy)."""
    from adapt_tpu_torch.config import RuntimeConfig
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

    extra = dict(kv_layout="paged", page_size=128) if layout == "paged" else {}
    bat = ContinuousBatcher(lm, slots=8, chunk=8,
                            runtime=RuntimeConfig(pipeline_depth=2), **extra)
    rng = torch.Generator().manual_seed(5)
    for _ in range(8):
        bat.submit(torch.randint(0, lm.vocab, (256,), generator=rng).numpy(),
                   200)
    for _ in range(3):
        bat.tick()
    if not bat.stats()["inflight"]:
        raise AssertionError("phase 14 (c): no tick in flight")
    before = bat.stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fl = bat._tick_dispatch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    prev, bat._inflight = bat._inflight, fl
    after = bat.stats()
    bat._tick_commit(prev)
    steady = (after["h2d_transfers"] - before["h2d_transfers"],
              after["d2h_fetches"] - before["d2h_fetches"])
    if fl is None or fl.n_active != 8 or steady != (0, 1):
        raise AssertionError(f"phase 14 (c) {layout}: a steady depth-2 tick "
                             f"made {steady[0]} host->device copies and "
                             f"{steady[1]} fetches (want 0 and 1)")
    bat.close()
    print(f"phase 14 (c) steady depth-2 tick [{layout}] on {card}: 0 "
          f"host->device copies, 1 fetch, dispatch half free of stream "
          f"syncs (torch.cuda.set_sync_debug_mode('error'))")


def depth_part(torch, lm, card, counters, runs, prompts, waves, fan):
    """Phase 14 (c) + (d): phase 6's dense traffic and phase 7's paged
    traffic at ``pipeline_depth`` 1 then 2. Every depth-2
    stream equals the depth-1 run's, token for token, where the
    request took the same admission path (a path that moved with the
    admission timing is held by the tie-aware check, printed); the
    cancelled request's stream is a prefix. Returns {(layout, depth):
    [tok/s of each run]}."""
    from adapt_tpu_torch.config import KernelConfig, RuntimeConfig

    rates: dict = {}
    for layout, want in (("dense", ("flash_attn_fwd", "decode_attn")),
                         ("paged", ("flash_attn_fwd", "paged_attn",
                                    "paged_chunk_attn"))):
        first = {}
        for turn, depth in enumerate((1, 2)):
            rt = RuntimeConfig(pipeline_depth=depth)
            path = f"sched_depth{depth}_{layout}_{turn}"
            if layout == "dense":
                out, ids, cancelled, wall, ntok, _, _ = counted(
                    counters, path, want, runs,
                    lambda: drive_batcher(torch, lm, prompts, 64,
                                          KernelConfig(), 3, runtime=rt))
                paths = {r: "whole" for r in ids}
            else:
                (bat, pprompts, out, admits, cancelled, _, wall, ntok,
                 _) = counted(counters, path, want, runs,
                              lambda: drive_paged(torch, lm, KernelConfig(),
                                                  waves, fan, 2, runtime=rt))
                ids = list(pprompts)
                paths = {r: ("cow" if a["cow"] else "hit"
                             if a["prefix_pages"] else "chunked"
                             if a["chunked"] else "whole")
                         for r, a in admits.items()}
                if bat.stats()["pages_in_use"]:
                    raise AssertionError(f"phase 14 (c) {path}: pool not "
                                         "drained")
            rates.setdefault((layout, depth), []).append(ntok / wall)
            if not first:
                first = dict(out=out, ids=ids, paths=paths,
                             cancelled=cancelled)
                continue
            moved = 0
            for a, b in zip(first["ids"], ids):
                x, y = first["out"][a], out[b]
                if a == first["cancelled"] or b == cancelled:
                    n = min(len(x), len(y))
                    same = np.array_equal(x[:n], y[:n])
                elif first["paths"][a] == paths[b]:
                    same = np.array_equal(x, y)
                else:
                    moved += 1
                    p = prompts[ids.index(b)] if layout == "dense" \
                        else pprompts[b]
                    tg = first_gap(torch, lm, p, y, x)
                    same = tg is None or tg[1] < 0.1
                    if tg is not None:
                        print(f"tie-aware exemption: phase 14 (c) {path} "
                              f"request {b} ({first['paths'][a]} at depth 1, "
                              f"{paths[b]} here) first differs at token "
                              f"{tg[0]}, top-2 gap {tg[1]:.4f}")
                if not same:
                    raise AssertionError(f"phase 14 (c) {path}: request {b} "
                                         "differs from depth 1")
            print(f"phase 14 (c) {path} on {card}: streams equal the "
                  f"depth-1 run's ({moved} moved admission paths), "
                  f"{ntok / wall:.1f} tok/s, launches {runs[path]}")
    for layout in ("dense", "paged"):
        steady_sync_check(torch, lm, card, layout)
    return rates


def depth_readings(torch, lm, card):
    """Phase 14 (d), not gated: steady decode (8 slots of 256-token
    prompts, chunk 8) on each layout at depth 1, 2, 2, 1 in turns: 6 ticks
    timed on the host clock (tok/s and the mean ``runtime.overlap_ratio``);
    in the first two turns 3 more under ``torch.profiler`` (device
    activity only: a host trace of ~16k launches takes longer to reduce
    than to record) for the busy share, kernel time a tick over the
    unprofiled wall a tick."""
    from adapt_tpu_torch.config import RuntimeConfig
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
    from adapt_tpu_torch.utils.metrics import global_metrics

    acts = [torch.profiler.ProfilerActivity.CUDA]
    for layout in ("slots", "paged"):
        extra = (dict(kv_layout="paged", page_size=128)
                 if layout == "paged" else {})
        for turn, depth in enumerate((1, 2, 2, 1)):
            bat = ContinuousBatcher(
                lm, slots=8, chunk=8,
                runtime=RuntimeConfig(pipeline_depth=depth), **extra)
            rng = torch.Generator().manual_seed(5)
            for _ in range(8):
                bat.submit(torch.randint(0, lm.vocab, (256,),
                                         generator=rng).numpy(), 400)
            for _ in range(3):
                bat.tick()
            torch.cuda.synchronize()
            ratios = []
            t0 = time.perf_counter()
            for _ in range(6):
                bat.tick()
                ratios.append(global_metrics().snapshot()["gauges"][
                    "runtime.overlap_ratio"])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            busy = float("nan")
            if turn < 2:
                with torch.profiler.profile(activities=acts) as prof:
                    for _ in range(3):
                        bat.tick()
                    torch.cuda.synchronize()
                busy = sum(r[0] for r in kernel_rows(torch, prof, calls=3))
            bat.close()
            tps = 8 * 8 * 6 / wall_ms * 1e3
            print(f"phase 14 (d) steady decode [{layout}] depth {depth} on "
                  f"{card}: {tps:.1f} tok/s ({wall_ms / 48:.3f} ms/step), "
                  f"busy share {busy / (wall_ms / 6):.3f}, "
                  f"runtime.overlap_ratio {sum(ratios) / len(ratios):.3f}")


#: Phase 14's counters by part: the kernels' rows they count into (the
#: ladder part runs an int8 pool and K2 on the draft's bf16 strips).
SCHED_ROWS = {
    "native": {"flash_attn_fwd": "flash_attn_fwd",
               "decode_attn": "decode_attn", "paged_attn": "paged_attn",
               "paged_chunk_attn": "paged_chunk_attn"},
    "int8": {"flash_attn_fwd": "flash_attn_fwd",
             "decode_attn": "decode_attn", "paged_attn": "paged_attn[int8]",
             "paged_chunk_attn": "paged_chunk_attn[int8]",
             "paged_verify_attn": "paged_verify_attn[int8]",
             "quantize_blocks": "quantize_blocks",
             "dequantize_blocks": "dequantize_blocks"},
}


def sched_phase(torch, A, D, P, Q, lm, draft2, card, kernels, solo,
                solo_gaps, prompts, waves, fan, spec_bar):
    """Phase 14: traffic control and the pipelined tick on the card — (a)
    preemption, (b) the degradation ladder under speculation, (c) depth 2
    against depth 1 and a steady depth-2 tick, (d) readings. Adds
    ``sched_launches`` (phase 14's launches of each kernel, its main-path
    runs summed) to every row of ``kernels``."""
    from adapt_tpu_torch.models import speculative as S

    t_phase = time.perf_counter()
    counters = {"flash_attn_fwd": A.flash_attn_fwd,
                "decode_attn": D.decode_attn, "paged_attn": P.paged_attn,
                "paged_chunk_attn": P.paged_chunk_attn,
                "paged_verify_attn": P.paged_verify_attn,
                "quantize_blocks": Q.quantize_blocks,
                "dequantize_blocks": Q.dequantize_blocks}
    runs: dict = {}
    took = []
    t = time.perf_counter()
    preempt_part(torch, lm, card, counters, runs)
    took.append(time.perf_counter() - t)
    ladder_part(torch, lm, draft2, Q, S, card, counters, runs, solo,
                solo_gaps, prompts[:8], spec_bar)
    took.append(time.perf_counter() - t - sum(took))
    rates = depth_part(torch, lm, card, counters, runs, prompts, waves, fan)
    took.append(time.perf_counter() - t - sum(took))
    for (layout, depth), r in sorted(rates.items()):
        print(f"phase 14 (d) {layout} traffic at depth {depth} on {card}: "
              f"tok/s {', '.join(f'{x:.1f}' for x in r)}")
    depth_readings(torch, lm, card)
    took.append(time.perf_counter() - t - sum(took))
    totals: dict = {}
    for path, launches in runs.items():
        rows = SCHED_ROWS["int8" if path == "sched_ladder" else "native"]
        for k, n in launches.items():
            if k in rows:
                totals[rows[k]] = totals.get(rows[k], 0) + n
    for kr in kernels:
        kr["sched_launches"] = totals.get(kr["name"], 0)
    print(f"phase 14 launches by path: {json.dumps(runs)}")
    print(f"phase 14 (traffic control, pipelined tick) took "
          f"{time.perf_counter() - t_phase:.1f} s on {card} ((a) {took[0]:.1f}"
          f", (b) {took[1]:.1f}, (c) {took[2]:.1f}, (d) {took[3]:.1f})")


# -- phase 15: MoE blocks, engine observability, worker telemetry ----------

#: Phase 15's MoE decoder: GPT-2-small widths with every block's MLP a
#: dropless mixture of 8 experts, 2 active a token (``benchmarks/
#: lm_decode.py --moe 8``).
MOE_EXPERTS, MOE_TOP_K = 8, 2
#: Phase 15's counters, by the kernels' rows they count into.
OBS_ROWS = {"native": {"flash_attn_fwd": "flash_attn_fwd",
                       "decode_attn": "decode_attn",
                       "paged_attn": "paged_attn",
                       "paged_chunk_attn": "paged_chunk_attn"},
            "int8": {"flash_attn_fwd": "flash_attn_fwd",
                     "paged_attn": "paged_attn[int8]",
                     "paged_chunk_attn": "paged_chunk_attn[int8]"}}


def gpt2_small_moe(torch):
    """GPT-2-small widths (learned positions, max_len 1024, bf16, random
    weights from seed 0) with ``moe_experts=8, moe_top_k=2``, on the card."""
    from adapt_tpu_torch.models.transformer_lm import transformer_lm

    t0 = time.perf_counter()
    moe = transformer_lm(*GPT2_SMALL, max_len=1024, dtype=torch.bfloat16,
                         name="gpt2_small_moe", moe_experts=MOE_EXPERTS,
                         moe_top_k=MOE_TOP_K, seed=0)
    n = sum(p.numel() for p in moe.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in moe.parameters())
    print(f"phase 15 (a) MoE model ({MOE_EXPERTS} experts, top-{MOE_TOP_K})"
          f" built in {time.perf_counter() - t0:.1f} s: {n} parameters, "
          f"{nbytes} bytes")
    return moe


def moe_row_check(torch, moe, vocab, card):
    """One decode step of row 0 three ways: in a batch of 8 live rows,
    with its companions' rows zero (as ``generate()`` pads), and as a
    batch of 1. The zeroed batch must be ``torch.equal`` to the live one
    (a mixture-of-experts row depends on no other row's values). The
    batch of 1 may run other cuBLAS algorithms; it is held to the live
    row within bf16's 1e-2 x max|row| and its bit-equality is printed."""
    dev = moe.device
    g = torch.Generator().manual_seed(15)
    ids = torch.randint(0, vocab, (8, 64), generator=g).to(dev)
    nxt = torch.randint(0, vocab, (8, 1), generator=g).to(dev)
    with torch.no_grad():
        h = moe.embed(ids)
        caches = []
        for blk in moe.blocks:
            h, ck, cv = blk.prefill(h, 1025)
            caches.append((ck, cv))
        idx = torch.full((8,), 64, dtype=torch.int32, device=dev)

        def step(x, zero_others=False):
            rows = x.shape[0]
            for blk, (ck, cv) in zip(moe.blocks, caches):
                ck, cv = ck[:rows].clone(), cv[:rows].clone()
                if zero_others:
                    ck[1:], cv[1:] = 0, 0
                x, _, _ = blk.decode_step(x, ck, cv, idx[:rows])
            return moe.head(x)[:, 0]

        x = moe.embed.embed_positions(nxt, idx[:, None])
        batch = step(x)
        lone = x.clone()
        lone[1:] = 0
        alone = step(lone, zero_others=True)
        single = step(x[:1].clone())
    if not torch.equal(batch[0], alone[0]):
        raise AssertionError("phase 15 (a): a MoE decode row with its "
                             "companions zeroed differs from the same row in "
                             "a batch of 8 (largest "
                             f"{float((batch[0] - alone[0]).abs().max()):.3e})")
    err = float((batch[0] - single[0]).float().abs().max())
    tol = 1e-2 * float(batch[0].float().abs().max())
    print(f"phase 15 (a) on {card}: a MoE decode row as a batch of 1 vs its "
          f"row in a batch of 8: torch.equal "
          f"{torch.equal(batch[0], single[0])}, max|diff| {err!r} "
          f"(tolerance 1e-2 x max|row| = {tol!r})")
    if not err <= tol:
        raise AssertionError(f"phase 15 (a): a MoE decode row as a batch of "
                             f"1 differs from its batch-8 row by {err:.3e} "
                             f"> {tol:.3e}")


def moe_part(torch, card, counters, runs, ragged, lens, prompts, waves, fan):
    """Phase 15 (a): the MoE LM at full width through ``generate()`` (4
    ragged prompts), one decode step's batch invariance, the dense batcher
    on phase 6's first 8 requests, the paged batcher on phase 7's traffic
    and the paged traffic's 8 unique prompts on an int8 pool."""
    from adapt_tpu_torch.config import KernelConfig
    from adapt_tpu_torch.models.transformer_lm import generate

    moe = gpt2_small_moe(torch)
    vocab = moe.vocab
    toks = generate(moe, ragged, 32, prompt_lengths=lens)
    torch.cuda.synchronize()
    if toks.shape != (4, 32) or not bool(((toks >= 0)
                                          & (toks < vocab)).all()):
        raise AssertionError(f"phase 15 (a): MoE ragged generate gave "
                             f"{tuple(toks.shape)} / bad ids")
    moe_row_check(torch, moe, vocab, card)
    solo, _ = reference_streams(torch, moe)
    dense = prompts[:8]
    out, ids, _, wall, ntok, ttft, _ = counted(
        counters, "phase 15 moe_dense", ("flash_attn_fwd", "decode_attn"),
        runs, lambda: drive_batcher(torch, moe, dense, 64, KernelConfig(),
                                    None))
    for rid, p in zip(ids, dense):
        if not np.array_equal(out[rid], solo(p)):
            bad = int((out[rid] != solo(p)).argmax())
            raise AssertionError(f"phase 15 (a) MoE dense: request {rid} "
                                 f"differs from generate() at token {bad}")
    print(f"phase 15 (a) MoE batcher[dense] on {card}: 8 requests, streams "
          f"equal generate(), {ntok} tokens in {wall:.3f} s = "
          f"{ntok / wall:.1f} tok/s, mean TTFT {ttft * 1e3:.1f} ms, "
          f"launches {runs['phase 15 moe_dense']}")
    (bat, pprompts, out, admits, cancelled, fan_ids, wall, ntok,
     ttft) = counted(counters, "phase 15 moe_paged",
                     ("flash_attn_fwd", "paged_attn", "paged_chunk_attn"),
                     runs, lambda: drive_paged(torch, moe, KernelConfig(),
                                               waves, fan, 2))
    st = bat.stats()
    bat.close()
    if st["pages_in_use"] != 0 or st["pages_free"] != st["pool_pages"] - 1:
        raise AssertionError(f"phase 15 (a) MoE paged: the pool did not "
                             f"drain: {st}")
    exempt, paths = check_paged_streams(torch, moe, pprompts, out, admits,
                                        cancelled, fan_ids, None, solo)
    print(f"phase 15 (a) MoE batcher[paged] on {card}: {len(pprompts)} "
          f"requests (paths {paths}, {len(exempt)} tie exemptions, 1 "
          f"cancelled), {ntok} tokens in {wall:.3f} s = {ntok / wall:.1f} "
          f"tok/s, mean TTFT {ttft * 1e3:.1f} ms, prefix_hits "
          f"{st['prefix_hits']}, cow_forks {st['cow_forks']}, launches "
          f"{runs['phase 15 moe_paged']}")
    # The int8 pool: whole-prompt admissions equal generate(kv_cache_dtype=
    # "int8"); a chunked admission attends the quantized window of its
    # earlier chunks (no generate() twin), so it must equal the same
    # request served alone by a batcher of the same configuration (the
    # batch-invariance contract: every row's bits are its own).
    unique = list(waves[0][1:]) + list(waves[1][-1:])
    (bat, pprompts, out, admits, _, _, wall, ntok, ttft) = counted(
        counters, "phase 15 moe_paged_int8",
        ("flash_attn_fwd", "paged_attn", "paged_chunk_attn"), runs,
        lambda: drive_paged(torch, moe, KernelConfig(), (unique[:4],
                                                         unique[4:]),
                            None, None, kv_cache_dtype="int8"))
    st = bat.stats()
    bat.close()
    if st["pages_in_use"] != 0:
        raise AssertionError(f"phase 15 (a) MoE int8: pool not drained {st}")
    paths = {}
    for rid, p in pprompts.items():
        chunked = admits[rid]["chunked"]
        paths[chunked] = paths.get(chunked, 0) + 1
        if chunked:
            alone = drive_paged(torch, moe, KernelConfig(), ([p], []), None,
                                None, kv_cache_dtype="int8")
            alone[0].close()
            want = next(iter(alone[2].values()))
        else:
            want = solo(p, kv="int8")
        if not np.array_equal(out[rid], want):
            bad = int((out[rid] != want).argmax())
            raise AssertionError(
                f"phase 15 (a) MoE int8: request {rid} ("
                f"{'chunked' if chunked else 'whole'}, prompt {len(p)}) "
                f"differs at token {bad} from "
                f"{'itself served alone' if chunked else 'generate()'}")
    print(f"phase 15 (a) MoE batcher[paged int8] on {card}: {len(pprompts)} "
          f"requests ({paths.get(False, 0)} whole-prompt equal generate("
          f"kv_cache_dtype='int8'), {paths.get(True, 0)} chunked equal "
          f"themselves served alone), {ntok} tokens in {wall:.3f} s = "
          f"{ntok / wall:.1f} tok/s, mean TTFT {ttft * 1e3:.1f} ms, "
          f"cache_bytes_ratio {st['cache_bytes_ratio']}, launches "
          f"{runs['phase 15 moe_paged_int8']}")
    del moe, bat


class Scraper:
    """A thread scraping ``/metrics`` and ``/metrics.json`` every ~50 ms:
    counts scrapes and errors, and checks the page partition (used + free
    + cached == pool pages) in every JSON scrape that carries it."""

    def __init__(self, port):
        import threading

        self.port, self.errors, self.scrapes = port, [], 0
        self.partition_ok, self.partition_bad = 0, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _get(self, path):
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}",
                                    timeout=10) as r:
            return r.read().decode()

    def _run(self):
        while not self._stop.is_set():
            try:
                if "adapt_" not in self._get("/metrics"):
                    raise AssertionError("a /metrics scrape without metrics")
                g = json.loads(self._get("/metrics.json"))["gauges"]
                self.scrapes += 1
                if "memory.pool_pages" in g:
                    parts = (g["memory.pages_used"] + g["memory.pages_free"]
                             + g["memory.pages_cached"])
                    if parts == g["memory.pool_pages"]:
                        self.partition_ok += 1
                    else:
                        self.partition_bad.append(
                            (parts, g["memory.pool_pages"]))
            except Exception as e:  # noqa: BLE001 — counted, then gated
                self.errors.append(repr(e))
            self._stop.wait(0.05)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30)


#: The phases a paged, non-speculative tick records.
TICK_PHASES = ("admit", "prefill", "dispatch", "commit_lag", "decode",
               "commit", "update")


def observed_part(torch, lm, card, counters, runs, waves, fan):
    """Phase 15 (b): phase 7's paged traffic with every observability
    surface off, then on but unscraped, then on (``ObservabilityConfig(
    obs_engine=True, trace_enabled=True)``, a ``CapacityConfig``,
    ``serve_metrics`` on an ephemeral port scraped every ~50 ms by a
    second thread while the batcher ticks). Gates on the last run: streams equal; no scrape error; every tick
    phase recorded; the page partition adds up at every scrape; the
    allocator gauge equals ``torch.cuda.memory_allocated()`` after the
    drain; every launched op's dispatch gauge on the kernel (plain count
    0), its kernel count equal to its wrapper's launches in the run (the
    books are kept in the launch wrappers); no compile event after warmup; ``engine.mfu`` / ``engine.mbu`` in
    (0, 1]; the capacity book healthy, calibrated and scoring the shared
    prefix above 0 and a fresh prompt at 0. Returns (on / off tok/s,
    the headline mfu, mbu)."""
    from adapt_tpu_torch.config import (
        CapacityConfig,
        KernelConfig,
        ObservabilityConfig,
    )
    from adapt_tpu_torch.ops import _build
    from adapt_tpu_torch.runtime.capacity import affinity_score
    from adapt_tpu_torch.utils.exporter import serve_metrics
    from adapt_tpu_torch.utils.metrics import global_metrics
    from adapt_tpu_torch.utils.profiling import global_engine_obs
    from adapt_tpu_torch.utils.tracing import global_tracer

    reg = global_metrics()
    eo, tracer = global_engine_obs(), global_tracer()
    eo.enabled = tracer.enabled = False
    results = {}
    # "quiet": every surface on but nothing scraping, which splits the
    # scraper's cost from the instrumentation's.
    for mode in ("off", "quiet", "on"):
        extra = dict(capacity=CapacityConfig(enabled=False))
        server = scraper = None
        if mode != "off":
            extra = dict(capacity=CapacityConfig(refresh_s=0.05),
                         observability=ObservabilityConfig(
                             obs_engine=True, trace_enabled=True))
        if mode == "on":
            server = serve_metrics(port=0)
            scraper = Scraper(server.server_address[1])
            _build.reset_kernel_dispatch()
        before = reg.snapshot(window=True)
        events0 = reg.counter("engine.compile_events")
        try:
            got = counted(
                counters, f"phase 15 obs_{mode}",
                ("flash_attn_fwd", "paged_attn", "paged_chunk_attn"), runs,
                lambda: drive_paged(torch, lm, KernelConfig(), waves, fan, 2,
                                    **extra))
            bat = got[0]
            if mode == "on":
                bat.tick()  # an idle tick: the flush rebuilds the book
                torch.cuda.synchronize()
        finally:
            if scraper is not None:
                scraper.stop()
            eo.enabled = tracer.enabled = False
        results[mode] = got
        if mode != "on":
            bat.close()
            continue
        win = reg.snapshot(since=before)
        snap = reg.snapshot()
        g = snap["gauges"]
        in_use = torch.cuda.memory_allocated()
        missing = [n for n in TICK_PHASES
                   if not win["histograms"].get(f"engine.phase.{n}_s",
                                                {}).get("count")]
        book = bat.capacity_book()
        shared = np.concatenate([waves[1][0][:384], [1, 2, 3]])
        fresh = torch.randint(0, lm.vocab, (400,),
                              generator=torch.Generator().manual_seed(
                                  151)).numpy()
        aff_shared = affinity_score(book["sketch"], shared)
        aff_fresh = affinity_score(book["sketch"], fresh)
        server.shutdown()
        server.server_close()
        bat.close()
        launched = runs["phase 15 obs_on"]
        ops = {"prefill": "flash_attn_fwd", "paged_decode": "paged_attn",
               "paged_chunk": "paged_chunk_attn"}
        bad_ops = {op: (g.get(f"engine.kernel_dispatch.{op}"),
                        g.get(f"engine.kernel_dispatch.{op}.xla_total"),
                        g.get(f"engine.kernel_dispatch.{op}.pallas_total"),
                        launched[fn])
                   for op, fn in ops.items()
                   if g.get(f"engine.kernel_dispatch.{op}") != 1.0
                   or g.get(f"engine.kernel_dispatch.{op}.xla_total") != 0.0
                   or g.get(f"engine.kernel_dispatch.{op}.pallas_total")
                   != float(launched[fn]) or not launched[fn]}
        mfu, mbu = g.get("engine.mfu"), g.get("engine.mbu")
        checks = [
            (scraper.errors, f"scrape errors: {scraper.errors[:3]}"),
            (not scraper.scrapes or scraper.partition_bad
             or not scraper.partition_ok,
             f"{scraper.scrapes} scrapes, partition bad at "
             f"{scraper.partition_bad[:3]}"),
            (missing, f"tick phases not recorded: {missing}"),
            (g.get("memory.hbm_bytes_in_use") != in_use,
             f"memory.hbm_bytes_in_use {g.get('memory.hbm_bytes_in_use')} "
             f"!= torch.cuda.memory_allocated() {in_use}"),
            (bad_ops, f"kernel dispatch books {bad_ops}"),
            (reg.counter("engine.compile_events") != events0,
             f"{reg.counter('engine.compile_events') - events0} compile "
             "events during the run"),
            (not (mfu and mbu and 0 < mfu <= 1 and 0 < mbu <= 1),
             f"engine.mfu {mfu}, engine.mbu {mbu}"),
            (book["health"] != "ok"
             or "capacity.forecast_calibration" not in g,
             f"capacity health {book['health']}, calibration "
             f"{g.get('capacity.forecast_calibration')}"),
            (not (aff_shared > 0 and aff_fresh == 0),
             f"affinity shared {aff_shared}, fresh {aff_fresh}"),
        ]
        for bad, what in checks:
            if bad:
                raise AssertionError(f"phase 15 (b): {what}")
        phases = {n: win["histograms"][f"engine.phase.{n}_s"]["count"]
                  for n in TICK_PHASES}
        print(f"phase 15 (b) observed paged run on {card}: {scraper.scrapes} "
              f"scrapes (0 errors, the page partition exact in "
              f"{scraper.partition_ok}), phase samples {phases}, "
              f"engine.mfu {mfu:.6f}, engine.mbu {mbu:.6f} (decode chunk "
              f"{g['engine.flops.decode']:.4e} FLOP, "
              f"{g['engine.bytes_accessed.decode']:.4e} B), "
              f"memory.hbm_bytes_in_use {in_use}, capacity health "
              f"{book['health']}, calibration "
              f"{g['capacity.forecast_calibration']:.3f}, affinity shared "
              f"prefix {aff_shared:.3f} / fresh {aff_fresh:.3f}, 0 compile "
              f"events, kernel dispatch {ops} on the kernel")
    rate = {m: r[7] / r[6] for m, r in results.items()}
    off = results["off"][2]
    for mode in ("quiet", "on"):
        got = results[mode][2]
        if set(off) != set(got) or any(not np.array_equal(off[r], got[r])
                                       for r in off):
            raise AssertionError(f"phase 15 (b): a stream of the {mode} run "
                                 "differs from the run without observability")
    ratio = rate["on"] / rate["off"]
    print(f"phase 15 (b) on {card}: every stream equal with and without "
          f"observability; tok/s on and scraped {rate['on']:.1f}, on and "
          f"unscraped {rate['quiet']:.1f}, off {rate['off']:.1f}: on / off "
          f"{ratio:.3f}, unscraped / off {rate['quiet'] / rate['off']:.3f} "
          f"(not gated; budget 5%)")
    return ratio, mfu, mbu


def telemetry_case(torch, dev):
    """Phase 15 (c)'s model and traffic: phase 13's ResNet-50 f32 (1000
    classes, ``RESNET50_3STAGE_CUTS``, random weights from seed 0), 8
    requests of batch 8 at 224, and the recipe the workers rebuild it
    from."""
    from adapt_tpu_torch.models.resnet import RESNET50_3STAGE_CUTS, resnet50

    cuts = list(RESNET50_3STAGE_CUTS)
    gen = torch.Generator(device=dev).manual_seed(37)
    return (resnet50(1000, torch.float32, device=dev, seed=0), cuts,
            {"model": "resnet50", "num_classes": 1000, "cuts": cuts},
            [torch.randn(8, 224, 224, 3, generator=gen, device=dev)
             for _ in range(8)])


def telemetry_part(torch, dev, card, root, case):
    """Phase 15 (c) on ``case`` (:func:`telemetry_case`): phase 13's
    ResNet-50 f32 hub (codec ``none``, 8
    requests of batch 8) over three worker processes started with
    ``--telemetry-s 0.5`` and joining a ``ServingPipeline``'s gateway.
    Gates: the process-global store holds one source per worker process;
    each source's ``remote.stage_exec_s`` count equals the stages its
    proxy received; ``serve_observability()`` serves ``/fleet/metrics``
    and ``/fleet/capacity``; after a SIGKILL of one worker its
    ``fleet.report_age_s.<source>`` passes four report intervals while the
    live workers' stay under that."""
    import signal
    import tempfile
    import shutil
    import urllib.request

    from adapt_tpu_torch.config import FaultConfig, ServeConfig
    from adapt_tpu_torch.graph.partition import partition
    from adapt_tpu_torch.runtime.pipeline import ServingPipeline
    from adapt_tpu_torch.utils.metrics import global_metrics
    from adapt_tpu_torch.utils.telemetry import global_federated_store

    every = 0.5
    tmp = tempfile.mkdtemp(prefix="phase15-")
    procs = WorkerProcs(root, tmp, "cuda:0" if dev.type == "cuda" else "cpu")
    pipe = server = None
    graph, cuts, recipe, xs = case
    try:
        plan = partition(graph, cuts)
        gw = free_port()
        pipe = ServingPipeline(
            plan, None, devices=[],
            config=ServeConfig(fault=remote_fault(FaultConfig)),
            gateway_model_config=recipe, gateway_port=gw,
            gateway_device=dev)
        workers = [procs.start("--telemetry-s", str(every), "--connect",
                               f"127.0.0.1:{gw}", "--worker-id", f"t{i}")
                   for i in range(3)]
        pipe.start()
        for p in workers:
            procs.port(p)
        wait_for(lambda: {"t0", "t1", "t2"} <= set(pipe.registry.alive()),
                 "three telemetry workers joining the gateway")
        by_id = {p.worker_id: p for p in pipe.gateway.proxies}
        host = plan.extract_variables()
        for i in range(3):
            by_id[f"t{i}"].configure(i, None, host[i])
        pipe.dispatcher.warmup(xs[0])
        outs, wall, _, _ = served(torch, pipe.dispatcher, xs, "phase 15 (c)")
        store = global_federated_store()
        pids = {p.pid: f"t{i}" for i, p in enumerate(workers)}

        def sources():
            return {s["worker"]: k for k, s in store.sources().items()
                    if s["role"] == "stage" and s["pid"] in pids
                    and s["worker"] == pids[s["pid"]]}

        def counts():
            src = store.fleet_snapshot()["sources"]
            return {w: src[k]["histograms"].get("remote.stage_exec_s",
                                                {}).get("count", 0)
                    for w, k in sources().items()}

        def received():
            return {w: by_id[w].results_received for w in ("t0", "t1", "t2")}

        wait_for(lambda: counts() == received(),
                 "the workers' reports counting the stage runs received",
                 timeout=30.0)
        want = received()
        server = pipe.serve_observability()
        port = server.server_address[1]

        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=10) as r:
                return r.read().decode()

        fleet = get("/fleet/metrics")
        caps = json.loads(get("/fleet/capacity"))["replicas"]
        keys = sources()
        if not all(f'worker="{w}"' in fleet for w in keys) or any(
                caps.get(k, {}).get("book", {}).get("kind") != "stage"
                for k in keys.values()):
            raise AssertionError("phase 15 (c): /fleet/metrics or "
                                 "/fleet/capacity lacks a worker")
        os.kill(workers[0].pid, signal.SIGKILL)
        workers[0].wait(timeout=30)
        reg = global_metrics()

        def ages():
            g = reg.snapshot()["gauges"]
            return {w: g.get(f"fleet.report_age_s.{k}", 0.0)
                    for w, k in keys.items()}

        t_kill = time.perf_counter()
        wait_for(lambda: ages()["t0"] > 4 * every,
                 "the killed worker's report age to grow", timeout=30.0)
        seen = ages()
        if not all(seen[w] < 4 * every for w in ("t1", "t2")):
            raise AssertionError(f"phase 15 (c): live workers' report ages "
                                 f"{seen}")
        print(f"phase 15 (c) worker telemetry on {card}: 3 worker processes "
              f"(--telemetry-s {every}) served {len(xs)} requests of batch "
              f"{xs[0].shape[0]} "
              f"({len(xs) * xs[0].shape[0] / wall:.1f} images/s), one store "
              f"source each, "
              f"remote.stage_exec_s counts {counts()} = stages received "
              f"{want}; /fleet/metrics and /fleet/capacity list all three; "
              f"{time.perf_counter() - t_kill:.2f} s after a SIGKILL of t0 "
              f"its report age {seen['t0']:.3f} s, live t1 / t2 "
              f"{seen['t1']:.3f} / {seen['t2']:.3f} s")
    except BaseException:
        print(procs.tails(), file=sys.stderr)
        raise
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if pipe is not None:
            pipe.shutdown()
        procs.close()
        shutil.rmtree(tmp, ignore_errors=True)


def obs_phase(torch, A, D, P, lm, card, kernels, root, ragged, lens, prompts,
              waves, fan, tcase=None):
    """Phase 15: (a) the MoE LM, (b) observability on the paged path, (c)
    worker telemetry (on ``tcase``, :func:`telemetry_case` by default).
    Adds ``obs_launches`` (phase 15's launches of each kernel, its runs
    summed) to every row of ``kernels``."""
    t_phase = time.perf_counter()
    counters = {"flash_attn_fwd": A.flash_attn_fwd,
                "decode_attn": D.decode_attn, "paged_attn": P.paged_attn,
                "paged_chunk_attn": P.paged_chunk_attn}
    runs: dict = {}
    took = []
    t = time.perf_counter()
    moe_part(torch, card, counters, runs, ragged, lens, prompts, waves, fan)
    took.append(time.perf_counter() - t)
    ratio, mfu, mbu = observed_part(torch, lm, card, counters, runs, waves,
                                    fan)
    took.append(time.perf_counter() - t - sum(took))
    telemetry_part(torch, lm.device, card, root,
                   tcase or telemetry_case(torch, lm.device))
    took.append(time.perf_counter() - t - sum(took))
    totals: dict = {}
    for path, launches in runs.items():
        rows = OBS_ROWS["int8" if path.endswith("int8") else "native"]
        for k, n in launches.items():
            if k in rows:
                totals[rows[k]] = totals.get(rows[k], 0) + n
    for kr in kernels:
        kr["obs_launches"] = totals.get(kr["name"], 0)
    print(f"phase 15 launches by path: {json.dumps(runs)}")
    print(f"phase 15 (MoE, observability, worker telemetry) took "
          f"{time.perf_counter() - t_phase:.1f} s on {card} ((a) "
          f"{took[0]:.1f}, (b) {took[1]:.1f}, (c) {took[2]:.1f}); "
          f"observability on / off tok/s {ratio:.3f}, engine.mfu "
          f"{mfu:.6f}, engine.mbu {mbu:.6f}")


#: GPT-2-small widths: vocab, dim, depth, heads, MLP.
GPT2_SMALL = (50257, 768, 12, 12, 3072)


def gpt2_small(torch):
    """The serving configuration: GPT-2-small widths, learned positions,
    max_len 1024, bf16, random weights from seed 0, on the card."""
    from adapt_tpu_torch.models.transformer_lm import transformer_lm

    t0 = time.perf_counter()
    lm = transformer_lm(*GPT2_SMALL, max_len=1024, dtype=torch.bfloat16,
                        name="gpt2_small", seed=0)
    print(f"GPT-2-small widths built in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in lm.parameters())} parameters)")
    return lm


def truncated_draft(torch, lm):
    """The 2-layer draft of ``lm``'s widths: it shares the target's
    embedding, first two blocks and head. With random weights it rarely
    agrees with the 12-layer target: its paths show losslessness at
    acceptance ~0."""
    from adapt_tpu_torch.models.transformer_lm import transformer_lm

    vocab, dim, _, heads, mlp = GPT2_SMALL
    t0 = time.perf_counter()
    draft2 = transformer_lm(vocab, dim, 2, heads, mlp, max_len=1024,
                            dtype=torch.bfloat16, name="gpt2_small_draft",
                            seed=1)
    draft2.load_state_dict({k: v for k, v in lm.state_dict().items()
                            if k in draft2.state_dict()})
    print(f"2-layer draft of the same widths built in "
          f"{time.perf_counter() - t0:.1f} s")
    return draft2


def dense_traffic(torch, vocab):
    """Phase 6's inputs from seed 0: a (4, 100) ragged ``generate()`` batch
    with its lengths, and the dense path's 16 prompts of 16-512 tokens."""
    rng = torch.Generator().manual_seed(0)
    lens = [37, 64, 100, 23]
    ragged = torch.randint(0, vocab, (4, max(lens)), generator=rng)
    plens = torch.randint(16, 513, (16,), generator=rng).tolist()
    return ragged, lens, [torch.randint(0, vocab, (n,), generator=rng).numpy()
                          for n in plens]


def reference_streams(torch, lm):
    """``(solo, solo_gaps)``: ``solo(p, split, kv, steps)`` is
    ``generate()`` of one prompt alone (memoised); ``solo_gaps`` the top-2
    logit gap at every token of it, from the same ``generate()`` call with
    a hook on the head reading row 0 of each step's logits (memoised)."""
    from adapt_tpu_torch.models.transformer_lm import generate

    streams, gaps = {}, {}

    def solo(p, split=None, kv="native", steps=64):
        key = (p.tobytes(), split, kv, steps)
        if key not in streams:
            streams[key] = generate(lm, p[None], steps, decode_split=split,
                                    kv_cache_dtype=kv)[0].cpu().numpy()
        return streams[key]

    def solo_gaps(p, split=None, kv="native", steps=64):
        key = (p.tobytes(), split, kv, steps)
        if key not in gaps:
            seen = []
            hook = lm.head.register_forward_hook(
                lambda mod, args, o: seen.append(
                    torch.topk(o[0, 0].float(), 2).values))
            try:
                generate(lm, p[None], steps, decode_split=split,
                         kv_cache_dtype=kv)
            finally:
                hook.remove()
            top2 = torch.stack(seen).cpu().numpy()
            gaps[key] = top2[:, 0] - top2[:, 1]
        return gaps[key]

    return solo, solo_gaps


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        return _fail("torch is not installed")
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is false: this check needs "
                     "one CUDA card")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "adapt_tpu_torch", "csrc")):
        return _fail("adapt_tpu_torch/ is missing beside chip_smoke.py")
    sys.path.insert(0, root)
    from adapt_tpu_torch.config import KernelConfig, SpeculativeConfig
    from adapt_tpu_torch.models.transformer_lm import generate
    from adapt_tpu_torch.ops import _build
    from adapt_tpu_torch.ops import attention as A
    from adapt_tpu_torch.ops import decode_attention as D
    from adapt_tpu_torch.ops import paged_attention as P
    from adapt_tpu_torch.ops import quantize as Q

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"kernels built from adapt_tpu_torch/csrc in {_build.build_all():.1f} s")
    ptxas_report(_build)

    errs: dict[str, float] = {}
    check_k1(torch, A, dev, errs)
    check_k2(torch, D, dev, errs)
    check_k3(torch, D, P, dev, errs)
    check_k4(torch, P, A, dev, errs)
    # -- phase 6: the full-width dense path ------------------------------
    VOCAB, DIM, DEPTH, HEADS, MLP = GPT2_SMALL
    lm = gpt2_small(torch)
    prompt, lens, prompts = dense_traffic(torch, VOCAB)
    toks = generate(lm, prompt, 32, prompt_lengths=lens)
    torch.cuda.synchronize()
    if toks.shape != (4, 32) or not bool(((toks >= 0) & (toks < VOCAB)).all()):
        return _fail(f"ragged generate gave {tuple(toks.shape)} / bad ids")
    print(f"generate: 4 ragged prompts {lens}, 32 tokens each, ids in range")

    solo, solo_gaps = reference_streams(torch, lm)

    runs = {}
    for path, kernel, reqs, cancel_at in (
        ("main", KernelConfig(), prompts, 3),
        ("split4", KernelConfig(decode_split=4), prompts[:8], None),
    ):
        A.flash_attn_fwd.launches = 0
        D.decode_attn.launches = 0
        D.decode_attn_split.launches = 0
        out, ids, cancelled, wall, ntok, ttft, _ = drive_batcher(
            torch, lm, reqs, 64, kernel, cancel_at)
        launches = {
            "flash_attn_fwd": A.flash_attn_fwd.launches,
            "decode_attn": D.decode_attn.launches,
            "decode_attn_split": D.decode_attn_split.launches,
        }
        runs[path] = launches
        want = ("decode_attn_split" if kernel.decode_split else "decode_attn")
        if launches["flash_attn_fwd"] == 0 or launches[want] == 0:
            return _fail(f"{path} path did not launch its kernels: {launches}")
        for rid, p in zip(ids, reqs):
            ref = solo(p, kernel.decode_split)
            got = out[rid]
            if rid == cancelled:
                if len(got) >= 64 or not (ref[:len(got)] == got).all():
                    return _fail(f"cancelled stream {got} is no prefix")
                continue
            if len(got) != 64 or not (ref == got).all():
                bad = int((ref != got).argmax())
                return _fail(f"{path}: request {rid} differs from generate() "
                             f"at token {bad}")
        print(f"batcher[{path}] on {card}: {len(reqs)} requests "
              f"({'1 cancelled, ' if cancelled is not None else ''}streams "
              f"equal generate()), {ntok} tokens in {wall:.3f} s = "
              f"{ntok / wall:.1f} tok/s, mean TTFT {ttft * 1e3:.1f} ms, "
              f"launches {launches}")

    # -- phase 7: the full-width paged path ------------------------------
    counters = {"flash_attn_fwd": A.flash_attn_fwd,
                "paged_attn": P.paged_attn,
                "paged_attn_split": P.paged_attn_split,
                "paged_chunk_attn": P.paged_chunk_attn}
    wave1, wave2, fan = paged_traffic(torch, VOCAB)
    split_prompts = ([p[:len(p) // 2] for p in wave1[1:5]]
                     + [p[:256] for p in wave2[:4]])
    for path, kernel, waves, fan_p, cancel_at, want in (
        ("paged", KernelConfig(), (wave1, wave2), fan, 2,
         ("flash_attn_fwd", "paged_attn", "paged_chunk_attn")),
        ("paged_split4", KernelConfig(decode_split=4),
         (split_prompts[:4], split_prompts[4:]), None, None,
         ("flash_attn_fwd", "paged_attn_split")),
    ):
        for fn in counters.values():
            fn.launches = 0
        (bat, pprompts, out, admits, cancelled, fan_ids, wall, ntok,
         ttft) = drive_paged(torch, lm, kernel, waves, fan_p, cancel_at)
        launches = {k: fn.launches for k, fn in counters.items()}
        runs[path] = launches
        if any(launches[k] == 0 for k in want):
            return _fail(f"{path} path did not launch its kernels: {launches}")
        st = bat.stats()
        if st["pages_in_use"] != 0 or st["pages_free"] != st["pool_pages"] - 1:
            return _fail(f"{path}: the pool did not drain: {st}")
        if fan_p is not None and (st["prefix_hits"] < 1 or st["cow_forks"] < 1):
            return _fail(f"{path}: prefix_hits {st['prefix_hits']}, "
                         f"cow_forks {st['cow_forks']}")
        exempt, paths = check_paged_streams(
            torch, lm, pprompts, out, admits, cancelled, fan_ids,
            kernel.decode_split, lambda p, sp=kernel.decode_split: solo(p, sp))
        submitted = sum(len(p) for p in pprompts.values())
        print(f"batcher[{path}] on {card}: {len(pprompts)} requests "
              f"(paths {paths}, {len(exempt)} tie exemptions"
              f"{', 1 cancelled' if cancelled is not None else ''}), "
              f"{ntok} tokens in {wall:.3f} s = {ntok / wall:.1f} tok/s, "
              f"mean TTFT {ttft * 1e3:.1f} ms, prefix_hits "
              f"{st['prefix_hits']}, cow_forks {st['cow_forks']}, prompt "
              f"tokens prefilled {st['prefill_tokens']} of {submitted} "
              f"submitted, launches {launches}")

    # -- phase 8: kernel times at main-path shapes -------------------------
    F = torch.nn.functional
    kernels = []
    g = torch.Generator(device=dev).manual_seed(3)
    b, h, s, d = 1, 12, 512, 64
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    ms = time_ms(lambda: A.flash_attn_fwd(q, k, v, True))
    plain = time_ms(lambda: A._reference_with_lse(q, k, v, True))
    lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True))
    pairs = b * h * s * (s + 1) / 2
    bms, by = bound(4 * pairs * d, 4 * b * h * s * d * 2 + b * h * s * 4)
    kernels.append(dict(
        name="flash_attn_fwd", route="cuda",
        source="adapt_tpu_torch/csrc/flash_attn_fwd.cu",
        replaces="adapt_tpu/ops/attention.py:96",
        launches=runs["main"]["flash_attn_fwd"],
        max_abs_err=errs["flash_attn_fwd"], ms=ms, plain_ms=plain,
        bound_ms=bms, bound_by=by, library_ms=lib,
        shape=f"b{b} h{h} s{s} d{d} causal bf16"))

    B, kvh, G, L, hd = 8, 12, 1, 1025, 64
    q, ck, cv, idx = decode_inputs(torch, dev, B, kvh, G, L, hd, seed=4)
    live = float((idx.long() + 1).sum()) * kvh
    dbytes = 2 * live * hd * 2 + 2 * B * kvh * G * hd * 2 + B * 4
    dops = 4 * G * hd * live
    mask = torch.arange(L, device=dev)[None, :] <= idx[:, None].long()
    for name, fn, split in (
        ("decode_attn", lambda: D.decode_attn(q, ck, cv, idx), 1),
        ("decode_attn_split",
         lambda: D.decode_attn_split(q, ck, cv, idx, None, 4), 4),
    ):
        ms = time_ms(fn)
        plain = time_ms(
            lambda sp=split: D.decode_attention_plain(q, ck, cv, idx, None, sp))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, ck, cv, attn_mask=mask[:, None, None, :]))
        bms, by = bound(dops, dbytes)
        path = "main" if split == 1 else "split4"
        kernels.append(dict(
            name=name, route="cuda",
            source="adapt_tpu_torch/csrc/decode_attn.cu",
            replaces=("adapt_tpu/ops/decode_attention.py:240" if split == 1
                      else "adapt_tpu/ops/decode_attention.py:301"),
            launches=runs[path][name], max_abs_err=errs[name], ms=ms,
            plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
            shape=f"b{B} kv_h{kvh} g{G} L{L} hd{hd} split{split} bf16"))

    # K3 / K3-split at the K2 shape, in pages: 8 slots, 12 kv heads, page
    # 128, 8 pages a slot in a 65-page pool, indices spread over 0..1023.
    q, kp, vp, table, idx = paged_inputs(torch, dev, B, kvh, G, hd, 128, 8,
                                         65, seed=9)
    idx[-1] = 1023  # all rows live for the timing
    live = float((idx.long() + 1).sum()) * kvh
    pbytes = (2 * live * hd * 2 + 2 * B * kvh * G * hd * 2 + table.numel() * 4
              + B * 4)
    pmask = torch.arange(1024, device=dev)[None, :] <= idx[:, None].long()

    def gather_sdpa():
        ks = kp[table.long()].movedim(2, 1).reshape(B, kvh, -1, hd)
        vs = vp[table.long()].movedim(2, 1).reshape(B, kvh, -1, hd)
        return F.scaled_dot_product_attention(
            q, ks, vs, attn_mask=pmask[:, None, None, :])

    lib = time_ms(gather_sdpa)
    for name, fn, split, path in (
        ("paged_attn", lambda: P.paged_attn(q, kp, vp, table, idx), 1,
         "paged"),
        ("paged_attn_split",
         lambda: P.paged_attn_split(q, kp, vp, table, idx, None, 4), 4,
         "paged_split4"),
    ):
        ms = time_ms(fn)
        plain = time_ms(lambda sp=split: P.paged_attention_plain(
            q, kp, vp, table, idx, None, sp))
        bms, by = bound(4 * G * hd * live, pbytes)
        kernels.append(dict(
            name=name, route="cuda",
            source="adapt_tpu_torch/csrc/paged_attn.cu",
            replaces=("adapt_tpu/ops/paged_attention.py:331" if split == 1
                      else "adapt_tpu/ops/paged_attention.py:357"),
            launches=runs[path][name], max_abs_err=errs[name], ms=ms,
            plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
            shape=f"b{B} kv_h{kvh} g{G} page128 pps8 hd{hd} split{split} "
                  "bf16"))

    # K4 at C = 256, pos0 = 512 (a chunked-prefill pass of the paged path).
    C, pos0 = 256, 512
    q, kp, vp, pages = chunk_inputs(torch, dev, kvh, 1, hd, C, pos0)
    pairs = sum(pos0 + r + 1 for r in range(C)) * kvh
    cbytes = (2 * (pos0 + C) * kvh * hd * 2 + 2 * kvh * C * hd * 2
              + pages.numel() * 4)
    cmask = (torch.arange(pages.numel() * 128, device=dev)[None, :]
             <= pos0 + torch.arange(C, device=dev)[:, None])

    def gather_sdpa_chunk():
        ks = kp[pages.long()].movedim(1, 0).reshape(1, kvh, -1, hd)
        vs = vp[pages.long()].movedim(1, 0).reshape(1, kvh, -1, hd)
        return F.scaled_dot_product_attention(q, ks, vs, attn_mask=cmask)

    ms = time_ms(lambda: P.paged_chunk_attn(q, kp, vp, pages, pos0, C))
    plain = time_ms(lambda: P.paged_chunk_attention_reference(
        q, kp, vp, pages, pos0, C))
    lib = time_ms(gather_sdpa_chunk)
    bms, by = bound(4 * pairs * hd, cbytes)
    kernels.append(dict(
        name="paged_chunk_attn", route="cuda",
        source="adapt_tpu_torch/csrc/paged_chunk_attn.cu",
        replaces="adapt_tpu/ops/paged_attention.py:380",
        launches=runs["paged"]["paged_chunk_attn"],
        max_abs_err=errs["paged_chunk_attn"], ms=ms, plain_ms=plain,
        bound_ms=bms, bound_by=by, library_ms=lib,
        shape=f"kv_h{kvh} g1 C{C} pos0 {pos0} page128 hd{hd} bf16"))
    # -- phase 9: quantized KV (int8 / int4) ------------------------------
    check_k2q(torch, D, Q, dev, errs)
    check_k3q(torch, D, P, Q, dev, errs)
    check_k4q(torch, P, Q, dev, errs)
    hd_lm = DIM // HEADS
    want_ratio = {"int8": (hd_lm + 4) / (2 * hd_lm),
                  "int4": (hd_lm // 2 + 4) / (2 * hd_lm)}
    dense_counters = {"flash_attn_fwd": A.flash_attn_fwd,
                      "decode_attn": D.decode_attn,
                      "decode_attn_split": D.decode_attn_split}
    qprompts = prompts[:8]
    for kv in KV_DTYPES:
        path = f"dense_{kv}"
        for fn in dense_counters.values():
            fn.launches = 0
        out, ids, cancelled, wall, ntok, ttft, st = drive_batcher(
            torch, lm, qprompts, 64, KernelConfig(), 1, kv_cache_dtype=kv)
        launches = {k: fn.launches for k, fn in dense_counters.items()}
        runs[path] = launches
        if launches["flash_attn_fwd"] == 0 or launches["decode_attn"] == 0:
            return _fail(f"{path} path did not launch its kernels: {launches}")
        for rid, p in zip(ids, qprompts):
            ref, got = solo(p, kv=kv), out[rid]
            if rid == cancelled:
                if not 0 < len(got) < 64 or not (ref[:len(got)] == got).all():
                    return _fail(f"{path}: cancelled stream is no prefix")
                continue
            if len(got) != 64 or not (ref == got).all():
                bad = int((ref != got).argmax())
                return _fail(f"{path}: request {rid} differs from generate("
                             f"kv_cache_dtype={kv!r}) at token {bad}")
        if st["active"] or st["queued"]:
            return _fail(f"{path}: the batcher did not drain: {st}")
        if st["cache_bytes_ratio"] != want_ratio[kv]:
            return _fail(f"{path}: cache_bytes_ratio {st['cache_bytes_ratio']}"
                         f" != {want_ratio[kv]}")
        agree = agreement(out, ids, qprompts, solo, cancelled)
        print(f"batcher[{path}] on {card}: {len(qprompts)} requests (1 "
              f"cancelled, streams equal generate(kv_cache_dtype={kv!r})), "
              f"{ntok} tokens in {wall:.3f} s = {ntok / wall:.1f} tok/s, "
              f"mean TTFT {ttft * 1e3:.1f} ms, cache_bytes "
              f"{st['cache_bytes']} (ratio {st['cache_bytes_ratio']}), top-1 "
              f"agreement with the native streams {agree:.4f} (not gated), "
              f"launches {launches}")

    # Paged int8 on phase 7's traffic: hit and chunked passes attend the
    # quantized window, so their tie-aware bar is set from the measured
    # first-token logit error of such passes (at least phase 7's 0.1), and
    # every such stream may need it: each starts from logits perturbed by
    # that error, where a native pass differs only in summation order. A
    # first difference at a gap above the bar still fails.
    hit_err, chunk_err = quantized_pass_error(
        torch, lm, "int8", [wave1[0]] + list(wave2[:7]), list(wave1[5:8])
        + list(wave2[7:]))
    qbar = max(0.1, 2 * max(hit_err, chunk_err))
    print(f"int8 paged: largest first-token logit difference against the "
          f"whole-prompt pass: prefix hit {hit_err:.4f}, chunked "
          f"{chunk_err:.4f}; tie-aware bar {qbar:.4f}")
    for path, kv, waves, fan_p, cancel_at, pchunk, bar, cap, want in (
        ("paged_int8", "int8", (wave1, wave2), fan, 2, 256, qbar, None,
         ("flash_attn_fwd", "paged_attn", "paged_chunk_attn")),
        ("paged_int4", "int4", (qprompts[:4], qprompts[4:]), None, None,
         None, 0.0, 0, ("flash_attn_fwd", "paged_attn")),
    ):
        for fn in counters.values():
            fn.launches = 0
        (bat, pprompts, out, admits, cancelled, fan_ids, wall, ntok,
         ttft) = drive_paged(torch, lm, KernelConfig(), waves, fan_p,
                             cancel_at, kv_cache_dtype=kv,
                             prefill_chunk=pchunk)
        launches = {k: fn.launches for k, fn in counters.items()}
        runs[path] = launches
        if any(launches[k] == 0 for k in want):
            return _fail(f"{path} path did not launch its kernels: {launches}")
        st = bat.stats()
        if st["pages_in_use"] != 0 or st["pages_free"] != st["pool_pages"] - 1:
            return _fail(f"{path}: the pool did not drain: {st}")
        if st["cache_bytes_ratio"] != want_ratio[kv]:
            return _fail(f"{path}: cache_bytes_ratio {st['cache_bytes_ratio']}"
                         f" != {want_ratio[kv]}")
        exempt, paths = check_paged_streams(
            torch, lm, pprompts, out, admits, cancelled, fan_ids, None,
            lambda p, kv=kv: solo(p, kv=kv), bar, cap)
        if pchunk is None and set(paths) != {"whole"}:
            return _fail(f"{path}: expected whole-prompt admissions only, "
                         f"got {paths}")
        ids = list(pprompts)
        agree = agreement(out, ids, [pprompts[r] for r in ids], solo,
                          cancelled)
        print(f"batcher[{path}] on {card}: {len(pprompts)} requests (paths "
              f"{paths}, {len(exempt)} tie exemptions at bar {bar:.4f}"
              f"{', 1 cancelled' if cancelled is not None else ''}), "
              f"{ntok} tokens in {wall:.3f} s = {ntok / wall:.1f} tok/s, "
              f"mean TTFT {ttft * 1e3:.1f} ms, prefix_hits "
              f"{st['prefix_hits']}, cow_forks {st['cow_forks']}, "
              f"cache_bytes {st['cache_bytes']} (ratio "
              f"{st['cache_bytes_ratio']}), top-1 agreement with the native "
              f"streams {agree:.4f} (not gated), launches {launches}")

    # Quantized kernel times at their main-path shapes. The bound counts
    # each live vector's value bytes plus its f32 scale. Branches that no
    # quantized path of this script launches (the splits, K4q on int4) are
    # timed too and printed on their own lines, not in the kernels line.
    def dequant(pair, hd):
        return (Q.kv_values(pair[0], hd).float() * pair[1]).to(torch.bfloat16)

    def side_time(name, fn, plain_fn, ops, nbytes, shape):
        bms, by = bound(ops, nbytes)
        print(f"{name} on {card} (no quantized path launches it): "
              f"{time_ms(fn):.4f} ms (plain {time_ms(plain_fn):.4f}, library "
              f"none, bound {bms:.4f} by {by}) at {shape}")

    q, ck, cv, idx = decode_inputs(torch, dev, B, kvh, G, L, hd, seed=4)
    live = float((idx.long() + 1).sum()) * kvh
    for kv in KV_DTYPES:
        ckq, cvq = quantized(Q, ck, kv), quantized(Q, cv, kv)
        w = ckq[0].shape[-1]
        ms = time_ms(lambda: D.decode_attn(q, ckq, cvq, idx))
        plain = time_ms(lambda: D.decode_attention_plain(q, ckq, cvq, idx))
        two = time_ms(lambda: F.scaled_dot_product_attention(
            q, dequant(ckq, hd), dequant(cvq, hd),
            attn_mask=mask[:, None, None, :]))
        bms, by = bound(4 * G * hd * live, 2 * live * (w + 4)
                        + 2 * B * kvh * G * hd * 2 + B * 4)
        name = f"decode_attn[{kv}]"
        kernels.append(dict(
            name=name, route="cuda",
            source="adapt_tpu_torch/csrc/decode_attn.cu",
            replaces="adapt_tpu/ops/decode_attention.py:240",
            launches=runs[f"dense_{kv}"]["decode_attn"],
            max_abs_err=errs[name], ms=ms, plain_ms=plain, bound_ms=bms,
            bound_by=by, library_ms=None, dequant_sdpa_ms=two,
            shape=f"b{B} kv_h{kvh} g{G} L{L} hd{hd} {kv} K/V bf16 q"))
        side_time(f"decode_attn_split[{kv}]",
                  lambda: D.decode_attn_split(q, ckq, cvq, idx, None, 4),
                  lambda: D.decode_attention_plain(q, ckq, cvq, idx, None, 4),
                  4 * G * hd * live,
                  2 * live * (w + 4) + 2 * B * kvh * G * hd * 2 + B * 4,
                  f"b{B} kv_h{kvh} g{G} L{L} hd{hd} split4 {kv} K/V bf16 q")

    q, kp, vp, table, idx = paged_inputs(torch, dev, B, kvh, G, hd, 128, 8,
                                         65, seed=9)
    idx[-1] = 1023
    live = float((idx.long() + 1).sum()) * kvh
    kpq, vpq = quantized(Q, kp, "int8"), quantized(Q, vp, "int8")

    def gather_dequant_sdpa():
        ks = dequant(kpq, hd)[table.long()].movedim(2, 1).reshape(
            B, kvh, -1, hd)
        vs = dequant(vpq, hd)[table.long()].movedim(2, 1).reshape(
            B, kvh, -1, hd)
        return F.scaled_dot_product_attention(
            q, ks, vs, attn_mask=pmask[:, None, None, :])

    ms = time_ms(lambda: P.paged_attn(q, kpq, vpq, table, idx))
    plain = time_ms(lambda: P.paged_attention_plain(q, kpq, vpq, table, idx))
    two = time_ms(gather_dequant_sdpa)
    bms, by = bound(4 * G * hd * live, 2 * live * (hd + 4)
                    + 2 * B * kvh * G * hd * 2 + table.numel() * 4 + B * 4)
    kernels.append(dict(
        name="paged_attn[int8]", route="cuda",
        source="adapt_tpu_torch/csrc/paged_attn.cu",
        replaces="adapt_tpu/ops/paged_attention.py:331",
        launches=runs["paged_int8"]["paged_attn"],
        max_abs_err=errs["paged_attn[int8]"], ms=ms, plain_ms=plain,
        bound_ms=bms, bound_by=by, library_ms=None, dequant_sdpa_ms=two,
        shape=f"b{B} kv_h{kvh} g{G} page128 pps8 hd{hd} int8 K/V bf16 q"))
    k4 = (quantized(Q, kp, "int4"), quantized(Q, vp, "int4"))
    bms, by = bound(4 * G * hd * live, 2 * live * (hd // 2 + 4)
                    + 2 * B * kvh * G * hd * 2 + table.numel() * 4 + B * 4)
    kernels.append(dict(
        name="paged_attn[int4]", route="cuda",
        source="adapt_tpu_torch/csrc/paged_attn.cu",
        replaces="adapt_tpu/ops/paged_attention.py:331",
        launches=runs["paged_int4"]["paged_attn"],
        max_abs_err=errs["paged_attn[int4]"],
        ms=time_ms(lambda: P.paged_attn(q, *k4, table, idx)),
        plain_ms=time_ms(lambda: P.paged_attention_plain(q, *k4, table,
                                                         idx)),
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"b{B} kv_h{kvh} g{G} page128 pps8 hd{hd} int4 K/V bf16 q"))
    for kv, pq in (("int8", (kpq, vpq)), ("int4", k4)):
        side_time(f"paged_attn_split[{kv}]",
                  lambda: P.paged_attn_split(q, *pq, table, idx, None, 4),
                  lambda: P.paged_attention_plain(q, *pq, table, idx, None,
                                                  4),
                  4 * G * hd * live, 2 * live * (pq[0][0].shape[-1] + 4)
                  + 2 * B * kvh * G * hd * 2 + table.numel() * 4 + B * 4,
                  f"b{B} kv_h{kvh} g{G} page128 pps8 hd{hd} split4 {kv} K/V "
                  "bf16 q")

    q, kp, vp, pages = chunk_inputs(torch, dev, kvh, 1, hd, C, pos0)
    kpq, vpq = quantized(Q, kp, "int8"), quantized(Q, vp, "int8")

    def gather_dequant_sdpa_chunk():
        ks = dequant(kpq, hd)[pages.long()].movedim(1, 0).reshape(
            1, kvh, -1, hd)
        vs = dequant(vpq, hd)[pages.long()].movedim(1, 0).reshape(
            1, kvh, -1, hd)
        return F.scaled_dot_product_attention(q, ks, vs, attn_mask=cmask)

    ms = time_ms(lambda: P.paged_chunk_attn(q, kpq, vpq, pages, pos0, C))
    plain = time_ms(lambda: P.paged_chunk_attention_reference(
        q, kpq, vpq, pages, pos0, C))
    two = time_ms(gather_dequant_sdpa_chunk)
    bms, by = bound(4 * pairs * hd, 2 * (pos0 + C) * kvh * (hd + 4)
                    + 2 * kvh * C * hd * 2 + pages.numel() * 4)
    k4q = (quantized(Q, kp, "int4"), quantized(Q, vp, "int4"))
    side_time("paged_chunk_attn[int4]",
              lambda: P.paged_chunk_attn(q, *k4q, pages, pos0, C),
              lambda: P.paged_chunk_attention_reference(q, *k4q, pages, pos0,
                                                        C),
              4 * pairs * hd, 2 * (pos0 + C) * kvh * (hd // 2 + 4)
              + 2 * kvh * C * hd * 2 + pages.numel() * 4,
              f"kv_h{kvh} g1 C{C} pos0 {pos0} page128 hd{hd} int4 K/V bf16 q")
    kernels.append(dict(
        name="paged_chunk_attn[int8]", route="cuda",
        source="adapt_tpu_torch/csrc/paged_chunk_attn.cu",
        replaces="adapt_tpu/ops/paged_attention.py:380",
        launches=runs["paged_int8"]["paged_chunk_attn"],
        max_abs_err=errs["paged_chunk_attn[int8]"], ms=ms, plain_ms=plain,
        bound_ms=bms, bound_by=by, library_ms=None, dequant_sdpa_ms=two,
        shape=f"kv_h{kvh} g1 C{C} pos0 {pos0} page128 hd{hd} int8 K/V "
              "bf16 q"))

    # -- phase 10: speculative decoding (K5, K6) ---------------------------
    check_k5(torch, P, Q, dev, errs)
    check_k6(torch, Q, dev, errs)
    from adapt_tpu_torch.models import speculative as S

    draft2 = truncated_draft(torch, lm)
    qdraft, call_launches = check_k6_grouped(torch, Q, draft2.state_dict())
    spec_counters = {
        "flash_attn_fwd": A.flash_attn_fwd, "decode_attn": D.decode_attn,
        "decode_attn_split": D.decode_attn_split,
        "paged_chunk_attn": P.paged_chunk_attn,
        "paged_verify_attn": P.paged_verify_attn,
        "paged_verify_attn_split": P.paged_verify_attn_split,
        "quantize_blocks": Q.quantize_blocks,
        "dequantize_blocks": Q.dequantize_blocks,
    }
    verr = {}
    for layout, kv in (("paged", "native"), ("paged", "int8"),
                       ("paged", "int4"), ("slots", "native")):
        verr[layout, kv] = verify_pass_error(torch, lm, draft2, qprompts,
                                             layout, kv)
        print(f"verify pass vs decode step, first-token logits "
              f"[{layout} {kv}]: largest difference {verr[layout, kv]:.4f}; "
              f"tie-aware bar {max(0.1, 2 * verr[layout, kv]):.4f}")
    base = {}  # tok/s of the non-speculative run of the same traffic
    (_, _, _, _, _, _, wall, ntok, _) = drive_paged(
        torch, lm, KernelConfig(), (wave1, wave2), None, 2)
    base["spec_paged"] = ntok / wall
    for key, kv, kern in (("spec_int8", "int8", KernelConfig()),
                          ("spec_tree_split4", "native",
                           KernelConfig(decode_split=4)),
                          ("spec_int4", "int4", KernelConfig())):
        (_, _, _, _, _, _, wall, ntok, _) = drive_paged(
            torch, lm, kern, (qprompts[:4], qprompts[4:]), None, 1,
            kv_cache_dtype=kv, prefill_chunk=None)
        base[key] = ntok / wall
    _, _, _, wall, ntok, _, _ = drive_batcher(torch, lm, qprompts, 64,
                                              KernelConfig(), 1)
    base["spec_dense"] = ntok / wall
    sampled = (prompts[9], dict(temperature=0.7, top_k=1, rng=3))
    qwaves = (qprompts[:4], qprompts[4:])
    for (path, layout, kv, draft, spec, kernel, waves, cancel_at, pchunk,
         samp, want) in (
        ("spec_paged", "paged", "native", lm, SpeculativeConfig(draft_k=4),
         KernelConfig(), (wave1, wave2), 2, 256, None,
         ("flash_attn_fwd", "decode_attn", "paged_chunk_attn",
          "paged_verify_attn")),
        ("spec_int8", "paged", "int8", draft2,
         SpeculativeConfig(draft_k=4, draft_weight_dtype="int8"),
         KernelConfig(), qwaves, 1, None, None,
         ("flash_attn_fwd", "decode_attn", "paged_verify_attn",
          "quantize_blocks", "dequantize_blocks")),
        ("spec_tree_split4", "paged", "native", lm,
         SpeculativeConfig(draft_k=4, tree_width=2),
         KernelConfig(decode_split=4), qwaves, 1, None, None,
         ("flash_attn_fwd", "decode_attn_split", "paged_verify_attn_split")),
        ("spec_int4", "paged", "int4", lm, SpeculativeConfig(draft_k=4),
         KernelConfig(), qwaves, 1, None, None,
         ("flash_attn_fwd", "decode_attn", "paged_verify_attn")),
        ("spec_dense", "slots", "native", lm, SpeculativeConfig(draft_k=4),
         KernelConfig(), qwaves, 1, None, sampled,
         ("flash_attn_fwd", "decode_attn")),
    ):
        # The draft's weight swaps (each dequantizes its whole tree),
        # counted apart from the kernel's own counter.
        draft_calls = [0]
        deq = S.dequantize_params

        def counted(tree, deq=deq, calls=draft_calls):
            calls[0] += 1
            return deq(tree)

        S.dequantize_params = counted
        for fn in spec_counters.values():
            fn.launches = 0
        try:
            (bat, sprompts, out, cancelled, sampled_id, wall, ntok,
             steady) = drive_spec(torch, lm, draft, spec, kernel, layout, kv,
                                  waves, 64, cancel_at, pchunk, samp)
        finally:
            S.dequantize_params = deq
        launches = {k: fn.launches for k, fn in spec_counters.items()}
        runs[path] = launches
        if any(launches[k] == 0 for k in want):
            return _fail(f"{path} path did not launch its kernels: {launches}")
        if launches["dequantize_blocks"] != draft_calls[0] * call_launches:
            return _fail(f"{path}: {launches['dequantize_blocks']} K6 "
                         f"dequantize launches for {draft_calls[0]} draft "
                         f"calls (want {call_launches} a call)")
        if draft_calls[0]:
            print(f"{path}: {draft_calls[0]} draft calls, "
                  f"{launches['dequantize_blocks']} K6 dequantize launches")
        if layout == "slots" and (launches["paged_verify_attn"]
                                  or launches["paged_verify_attn_split"]):
            return _fail(f"{path}: the dense verify launched K5: {launches}")
        st = bat.stats()
        if st["active"] or st["queued"]:
            return _fail(f"{path}: the batcher did not drain: {st}")
        if layout == "paged" and (
                st["pages_in_use"] != 0
                or st["pages_free"] != st["pool_pages"] - 1):
            return _fail(f"{path}: the pool did not drain: {st}")
        if steady != (0, 1):
            return _fail(f"{path}: a steady speculative tick made {steady[0]} "
                         f"host->device copies and {steady[1]} device->host "
                         "fetches (want 0 and 1)")
        # The bar: twice the measured verify-vs-decode logit error of this
        # layout and cache dtype, at least 0.1; the int8 pool keeps phase
        # 9's bar where that is larger.
        bar = max(0.1, 2 * verr[layout, kv])
        if path == "spec_int8":
            bar = max(bar, qbar)
        split = kernel.decode_split
        exempt = check_spec_streams(
            sprompts, out, cancelled, 64,
            lambda p, sp=split, kv=kv: solo(p, sp, kv),
            lambda p, sp=split, kv=kv: solo_gaps(p, sp, kv), bar)
        acc = st["spec_acceptance"]
        rounds = st["spec_drafted"] // (spec.draft_k + spec.tree_width)
        per_pass = (st["spec_accepted"] + rounds) / max(rounds, 1)
        # A tree round drafts d + w candidates of which at most d + 1 can
        # be accepted, so its bar scales by (d + 1) / (d + w).
        most = min(1.0, (spec.draft_k + 1) / (spec.draft_k + spec.tree_width))
        if draft is lm and kv == "native" and acc < 0.9 * most:
            return _fail(f"{path}: self-draft acceptance {acc:.4f} < "
                         f"{0.9 * most:.4f}")
        note = ""
        if layout == "slots":
            note = (" (verify on dense strips is plain verify_attention: the "
                    "JAX package has no kernel there, K5 not launched)")
        if sampled_id is not None:
            note += ("; the temperature 0.7 / top_k 1 request passed the same "
                     "check against its greedy stream")
        print(f"batcher[{path}] on {card}: {len(sprompts)} requests "
              f"({'1 cancelled, ' if cancelled is not None else ''}"
              f"{len(exempt)} tie exemptions at bar {bar:.4f}), acceptance "
              f"{acc:.4f}, {per_pass:.3f} tokens per verify pass and slot, "
              f"{st['ticks']} ticks, {ntok} tokens in {wall:.3f} s = "
              f"{ntok / wall:.1f} tok/s (non-speculative run of the same "
              f"traffic in this call: {base[path]:.1f} tok/s), steady tick: "
              f"{steady[0]} host->device copies, {steady[1]} fetch, launches "
              f"{launches}{note}")

    # K5 / K5q / K5-split at the speculative path's shape: 8 slots, 12 kv
    # heads, g 1, 5 chunk rows, page 128, 8 pages a slot, base positions
    # spread over the window.
    KC = 5
    q, kp, vp, table, idx = verify_inputs(torch, dev, B, kvh, G, KC, hd, 128,
                                          8, 65, seed=14)
    idx[-1] = 8 * 128 - KC
    live = float((idx.long() + KC).sum()) * kvh  # keys a slot's rows read
    pairs5 = float(sum((idx.long() + t + 1).sum() for t in range(KC))) * kvh
    qo_bytes = 2 * B * kvh * G * KC * hd * 2 + table.numel() * 4 + B * 4
    vmask = D.verify_live(idx, B, G * KC, 8 * 128, KC, None, 0, dev)

    def sdpa_verify(kpool, vpool):
        ks = kpool[table.long()].movedim(2, 1).reshape(B, kvh, -1, hd)
        vs = vpool[table.long()].movedim(2, 1).reshape(B, kvh, -1, hd)
        return F.scaled_dot_product_attention(q, ks, vs,
                                              attn_mask=vmask[:, None])

    pools = {"native": (kp, vp),
             "int8": (quantized(Q, kp, "int8"), quantized(Q, vp, "int8")),
             "int4": (quantized(Q, kp, "int4"), quantized(Q, vp, "int4"))}
    for kv, path in (("native", "spec_paged"), ("int8", "spec_int8"),
                     ("int4", "spec_int4")):
        pq = pools[kv]
        vbytes = (2 * live * hd * 2 if kv == "native"
                  else 2 * live * (pq[0][0].shape[-1] + 4))
        bms, by = bound(4 * pairs5 * hd, vbytes + qo_bytes)
        tag = "" if kv == "native" else f"[{kv}]"
        row = dict(
            name=f"paged_verify_attn{tag}", route="cuda",
            source="adapt_tpu_torch/csrc/paged_verify_attn.cu",
            replaces="adapt_tpu/ops/paged_attention.py:647",
            launches=runs[path]["paged_verify_attn"],
            max_abs_err=errs[f"paged_verify_attn{tag}"],
            ms=time_ms(lambda: P.paged_verify_attn(q, *pq, table, idx, KC)),
            plain_ms=time_ms(lambda: P.paged_verify_attention_plain(
                q, *pq, table, idx, KC)),
            bound_ms=bms, bound_by=by,
            library_ms=(time_ms(lambda: sdpa_verify(kp, vp))
                        if kv == "native" else None),
            shape=f"b{B} kv_h{kvh} g{G} kc{KC} page128 pps8 hd{hd} "
                  f"{kv} K/V bf16 q")
        if kv != "native":
            row["dequant_sdpa_ms"] = time_ms(lambda: sdpa_verify(
                dequant(pq[0], hd), dequant(pq[1], hd)))
        kernels.append(row)
        split_fn = lambda: P.paged_verify_attn_split(  # noqa: E731
            q, *pq, table, idx, KC, None, 0, 4)
        split_plain = lambda: P.paged_verify_attention_plain(  # noqa: E731
            q, *pq, table, idx, KC, None, 0, 4)
        split_shape = (f"b{B} kv_h{kvh} g{G} kc{KC} page128 pps8 hd{hd} "
                       f"split4 {kv} K/V bf16 q")
        if kv == "native":
            kernels.append(dict(
                name="paged_verify_attn_split", route="cuda",
                source="adapt_tpu_torch/csrc/paged_verify_attn.cu",
                replaces="adapt_tpu/ops/paged_attention.py:647",
                launches=runs["spec_tree_split4"]["paged_verify_attn_split"],
                max_abs_err=errs["paged_verify_attn_split"],
                ms=time_ms(split_fn), plain_ms=time_ms(split_plain),
                bound_ms=bms, bound_by=by, library_ms=row["library_ms"],
                shape=split_shape))
        else:
            side_time(f"paged_verify_attn_split[{kv}]", split_fn, split_plain,
                      4 * pairs5 * hd, vbytes + qo_bytes, split_shape)
    # The dense-strip verify at the same geometry: plain tensor operations,
    # no kernel (as in the JAX package), timed for the record.
    Lv = 1024 + 1 + 4
    ck = torch.randn(B, kvh, Lv, hd, device=dev).to(torch.bfloat16)
    cv = torch.randn(B, kvh, Lv, hd, device=dev).to(torch.bfloat16)
    dense_ms = time_ms(lambda: D.verify_attention(q, ck, cv, idx, KC))
    print(f"verify_attention (dense strips, plain tensor operations, no "
          f"kernel) on {card}: {dense_ms:.4f} ms at b{B} kv_h{kvh} g{G} "
          f"kc{KC} L{Lv} hd{hd} bf16")

    # K6 at the draft's matrices: an MLP matrix and the embedding, bf16.
    # No single PyTorch call computes either; the plain version is the
    # multi-call figure. Elementwise f32 work outside the tensor cores:
    # its operations are held against 67 TFLOP/s.
    for shape, in_kernels in (((768, 3072), True), ((50257, 768), False)):
        x = (torch.randn(*shape, device=dev) * 0.036).to(torch.bfloat16)
        qt = Q.quantize_blocks(x)
        n, nb = x.numel(), qt.scales.numel()
        for name, fn, plain_fn, ops, nbytes, replaces in (
            ("quantize_blocks", lambda: Q.quantize_blocks(x),
             lambda: Q.quantize_reference(x), 3 * n,
             n * 2 + nb * 8192 + nb * 4, "adapt_tpu/ops/quantize.py:71"),
            ("dequantize_blocks", lambda: Q.dequantize_blocks(qt),
             lambda: Q.dequantize_reference(qt), n, n + nb * 4 + n * 2,
             "adapt_tpu/ops/quantize.py:81"),
        ):
            t_ops, t_bytes = ops / 67e12, nbytes / PEAK_BYTES
            bms = max(t_ops, t_bytes) * 1e3
            by = "operations" if t_ops > t_bytes else "bytes"
            ms, plain = time_ms(fn), time_ms(plain_fn)
            what = f"{shape} bf16, {nb} blocks of 8192"
            if in_kernels:
                kernels.append(dict(
                    name=name, route="cuda",
                    source=f"adapt_tpu_torch/csrc/{name}.cu",
                    replaces=replaces, launches=runs["spec_int8"][name],
                    max_abs_err=errs[name], ms=ms, plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=None,
                    multi_call_ms=plain, shape=what))
            else:
                print(f"{name} on {card}: {ms:.4f} ms (plain {plain:.4f}, "
                      f"library none (multi-call {plain:.4f}), bound "
                      f"{bms:.4f} by {by}) at {what}")
    # One whole dequantize_params of the draft's quantized state_dict: what
    # each draft scan and draft prefill pays.
    call_bytes = sum(
        math.prod(qt.shape) * (1 + torch.finfo(qt.dtype).bits // 8)
        + qt.scales.numel() * 4 for qt in qdraft.values()
        if isinstance(qt, Q.QuantizedTensor))
    next(kr for kr in kernels if kr["name"] == "dequantize_blocks").update(
        call_ms=time_ms(lambda: Q.dequantize_params(qdraft)),
        call_plain_ms=time_ms(lambda: {
            k: Q.dequantize_reference(v) if isinstance(v, Q.QuantizedTensor)
            else v for k, v in qdraft.items()}),
        call_bound_ms=call_bytes / PEAK_BYTES * 1e3,
        call_launches=call_launches, call_shape="2-layer draft, 11 matrices")

    # -- phase 11: training ViT-B/16 (K1 forward, K7 backward) -------------
    check_k7(torch, A, dev, errs)
    from adapt_tpu_torch.models.vit import vit_b16

    msg, train_case = train_phase(torch, A, dev, card, runs, kernels, errs,
                                  vit_b16, 224, 1000)
    if msg:
        return _fail(msg)
    dev_ms = flash_device_times(torch, A, card)
    for kr in kernels:
        if kr["name"] == "flash_attn_fwd":
            kr.update(device_ms=dev_ms["k1_lm"],
                      library_device_ms=dev_ms["sdpa_fwd_lm"],
                      vit_device_ms=dev_ms["k1_vit"],
                      vit_library_device_ms=dev_ms["sdpa_fwd_vit"])
        elif kr["name"] == "flash_attn_bwd":
            kr.update(device_ms=dev_ms["k7_vit"],
                      library_device_ms=dev_ms["sdpa_bwd_vit"])
    add_device_times(kernels, decode_device_times(torch, D, P, Q, card))

    # -- phase 12: the paper's pipeline (LocalPipeline, ServingPipeline) ----
    _, serve_rate = pipeline_phase(torch, A, dev, card, kernels,
                                   *pipeline_cases(torch, dev))

    # -- phase 13: the paper's pipeline across processes -----------------
    remote_phase(torch, A, Q, dev, card, kernels, root, serve_rate,
                 remote_cases(torch, dev))

    # -- phase 14: traffic control and the pipelined tick ----------------
    sched_phase(torch, A, D, P, Q, lm, draft2, card, kernels, solo,
                solo_gaps, prompts, (wave1, wave2), fan,
                max(0.1, 2 * verr["paged", "int8"], qbar))

    # -- phase 15: MoE blocks, engine observability, worker telemetry -----
    obs_phase(torch, A, D, P, lm, card, kernels, root, prompt, lens, prompts,
              (wave1, wave2), fan)

    if "--profile" in argv:
        profile_train(torch, *train_case, card)
        profile_library_backward(torch, card)
        for kv in ("native", "int8"):
            for layout in ("slots", "paged"):
                profile_decode(torch, lm, card, layout, kv)
            profile_prefill(torch, lm, card, kv)
        for layout in ("slots", "paged"):
            profile_decode(torch, lm, card, layout, "native", split=4)
        profile_spec(torch, lm, lm, SpeculativeConfig(draft_k=4), card,
                     "native", "self draft, native pool")
        profile_spec(torch, lm, draft2,
                     SpeculativeConfig(draft_k=4, draft_weight_dtype="int8"),
                     card, "int8", "2-layer int8-weight draft, int8 pool")
    for kr in kernels:
        lib = ("none" if kr["library_ms"] is None
               else f"{kr['library_ms']:.4f}")
        two = (f", dequantize + sdpa {kr['dequant_sdpa_ms']:.4f}"
               if "dequant_sdpa_ms" in kr else "")
        if "multi_call_ms" in kr:
            two = f" (multi-call {kr['multi_call_ms']:.4f})"
        devt = (f", device {kr['device_ms']:.4f} a launch"
                if "device_ms" in kr else "")
        call = ""
        if "call_ms" in kr:
            call = (f"; one dequantize_params of the {kr['call_shape']}: "
                    f"{kr['call_launches']} launch, {kr['call_ms']:.4f} ms, "
                    f"device {kr['call_device_ms']:.4f} (plain "
                    f"{kr['call_plain_ms']:.4f}, bound "
                    f"{kr['call_bound_ms']:.4f})")
        for h in kr.get("hop", []):
            call += (f"; at the hop {h['shape']}: {h['ms']:.4f} ms (plain "
                     f"{h['plain_ms']:.4f}, bound {h['bound_ms']:.4f})")
        if "remote_launches" in kr:
            call += (f"; {kr['remote_launches']} launches on "
                     f"{kr['remote_path']}")
        print(f"{kr['name']} on {card}: {kr['ms']:.4f} ms{devt} (plain "
              f"{kr['plain_ms']:.4f}, library {lib}{two}, bound "
              f"{kr['bound_ms']:.4f} by {kr['bound_by']}) at {kr['shape']}"
              f"{call}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
