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
   head_dim-128 cases, and the striped ring's device int32 ``causal_shift``
   0 and 1 at s 1024 and 2048 (a row with no live key not compared);
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
   plain version and bound, and the phase's seconds;
14. traffic control and the pipelined tick (``sched_phase``);
15. MoE decoder blocks, engine observability and worker telemetry
   (``obs_phase``);
16. the fleet tier (``fleet_phase``, on the 12-layer model): (a)
   ``PipelinedDecoder`` cut at blocks [4, 8] on three ``StageWorker`` s of
   the card and a spare, 8 ragged prompts of 16-256 tokens, 32 new
   tokens, 2 microbatches, native then int8 stage caches, without faults
   and with a crash of stage 1 and a hang of stage 2 mid-decode: streams
   equal ``generate()`` on each microbatch's rows, K1 and K2 (K2q)
   launched, each recovery within 10 x (deadline + lease TTL) of its
   kill; (b) ``DisaggServer`` over phase 7's paged batcher and a
   ``PrefillWorker`` with its own pool on phase 7's traffic (prompts of
   600+ tokens disaggregated), native, int8 and self-draft speculative:
   streams equal the same batcher served collocated, K4 (K4q) launched in
   the prefill tier and K3 (K3q, K5) in decode, ``disagg.pages_streamed``
   above 0, a 769-token prompt's handed-off pages ``torch.equal`` to an
   in-place chunked prefill's, a corrupted frame failing only its request;
   (c) the host KV tier (``CacheTierConfig(warm_codec="lz")``) on phase
   7's traffic served twice by a 38-page paged batcher: spills and
   readmits above 0, streams equal an untiered 200-page run's; then a cold
   int8 codec held by the tie-aware check. Launches of each kernel are
   added to its row as ``fleet_launches``;
17. the fleet router (``router_phase``, on the 12-layer model): replicas
   are phase 7's paged batcher on the one card over the one model, with a
   capacity book rebuilt every tick. A stream admitted on the same path
   (whole, hit, chunked) as in its reference run must equal it; any other
   passes phase 7's tie-aware check (at most 2 exemptions); every client
   sees each token index once, in order; no replica leaves and no request
   fails unless the part causes it. (a) phase 7's traffic (no cancel, no
   fan-out) through ``FleetRouter`` over two replicas with leases in a
   ``WorkerRegistry``, held to one replica alone: decode books on both
   leases, 16 "placed" decisions, K1, K3 and K4 launched; (b) 24 requests
   on 6 recurring 384-token prefixes (seed 17, 3 waves of 8, 32 tokens)
   through two fleets, ``policy="affinity"`` and ``"random"``: the
   affinity arm's prefix hits at least the random arm's, hit ratio, TTFT
   p50 and tok/s printed; (c) three replicas on phase 7's traffic, the
   lease of the one holding the most requests deregistered: one "lost"
   leave whose ``moved`` equals ``router.replaced`` (above 0), its wall
   below ``recovery_budget_s``, two replicas live; (d) 12 submits into a
   queue bound of 4 with no tick: 4 accepted, 8 ``QueueFullError`` s, each
   booked; an autoscaler over a queue bound of 8: one ``scale_up`` within
   3 ticks, one ``scale_down`` within 5 s of the drain, streams equal
   ``generate()``; (e) two replicas with a ``PrefillWorker`` tier (2 slots,
   prefill_chunk 256; 600+-token prompts disaggregated) on phase 7's
   traffic, native then int8, held to the replicas served collocated: one
   ``kv_handoff`` a long prompt (one tile, adopted), K4 (K4q) launched in
   the tier, ``disagg.pages_streamed`` above 0, and a page-size and a
   KV-dtype mismatch refused at ``add_replica``. Launches of each kernel
   are added to its row as ``router_launches``.
18. tensor-parallel serving (``tp_phase``, on the 12-layer model) as
   shards of the one card (meshes naming cuda:0 2 and 4 times). First the
   precision gate: each tp model's largest logit difference from an f32
   copy of the same weights is at most 2 x that of the bf16 model (e1).
   Every stream, tp=1's included, then has each token within 2 x e1 of
   the f32 copy's best logit given its own history (int8 paths: plus
   phase 9's int8 bar); a tp stream may leave tp=1's only so. (a) dense
   and paged traffic with a cancel at tp=1, 2 and 4: launches tp x tp=1's,
   per-shard cache bytes x tp the logical bytes; (b) an int8 pool and int8
   speculation (the draft replicated) at tp=2; (c) a steady tp=2 tick: 0
   host->device copies, 1 fetch; (d) a host-tier spill and readmit at
   tp=2 equal to an untiered run, and a router over a tp=2 replica with a
   prefill tier: 2 head tiles a leaf, streams held to the replica
   collocated; (e) K1-K5, native and int8, against their plain versions
   at kv_h 6 and 3. Launches are added to each row as ``tp_launches``,
   (e)'s errors as ``tp_shard_max_abs_err``;
19. elastic recovery of the tp batcher (``recovery_phase``, on the 12-layer
   model, held with phase 18's f32 copy and bar; meshes of 4 member ids
   naming cuda:0): (a) phase 6's first 8 prompts staggered on a tp=4
   batcher until every slot decodes, member 3 killed on dense strips and
   on a paged pool, then member 0 (the lead) on the pool: the tick raises
   ``DeviceLostError``, ``recover()`` shrinks to tp=2; each new shard's KV
   ``torch.equal`` to the ordered concatenation of the old shards' head
   ranges, the books (tp 2, every slot migrated), per-shard bytes x 2 the
   logical bytes, a steady tick after it 0 host->device copies, 1 fetch
   and a tp=2 step's launches, no compile event, tokens up to the kill
   equal to the uninterrupted tp=4 run's and every token within the bar;
   (b) an int8 pool with the 2-layer int8-weight draft, recovering inside
   a tick, both members of every pair checked; (c) ``policy="replay"``
   with a ``DispatcherJournal``: every request replays from the journal,
   prefix hits rise, each index delivered once, the journal empty at
   drain, each life's tokens within the bar along its own history,
   ``regen_mismatches`` printed; (d) a 4-block model killed down to a tp=1
   remnant. Each run prints the recovery's wall, moved and host-staged
   bytes and tok/s before and after; launches are added to each row as
   ``recovery_launches``;
20. sequence parallelism (``sp_phase``; rings of 2 and 4 ranks naming
   cuda:0, one process driving every rank): (a) ``ring_attention`` at b1
   h12 S4096 d64 bf16, {flash, jnp} x {contiguous, striped} x causal or
   not, and ``ulysses_attention``, each within 1e-2 + 1e-2|ref| of
   ``attention_reference``, K1 launched exactly what each layout needs (a
   contiguous causal ring nothing on its dead steps), then the device ms of
   the striped against the contiguous causal flash ring; (b) the paged
   batcher (phase 7's pool) on phase 7's four 600-900-token and four
   16-512-token prompts, 32 new tokens, with ``PrefillConfig(sp_threshold=
   512, sp_width=2)`` and 4, native and int8: ``sp_prefills`` = the prompts
   of 512+ tokens, as many prefix hits, no sp failure, a steady tick 0
   host->device copies and 1 fetch after a fresh sp admission, each stream
   leaving the run without sp only at a top-2 gap below phase 7's bar
   (int8: phase 9's) and every token within phase 18's bar (int8: plus
   phase 9's) of the f32 copy's best logit given its own history; printed:
   the sp pages' largest difference from the chunked prefill's (K4) per
   block, the long prompts' TTFT, the K4 launches; (c) a ``PrefillWorker``
   whose 3-page pool holds no long prompt: no handoff without sp, every
   long prompt handed off with sp_width 2, no failed job, streams held as
   in (b); (d) a tp=2 batcher with an (sp=2, tp=2) ring and a journal,
   member 1 killed with every slot decoding: tp 1, the ring rebuilt from
   members {0, 2, 3} at sp 2, tp 1, a later long admission on the sp path,
   phase 19's delivery, journal and bar gates. Launches are added to each
   row as ``sp_launches``;
21. the multi-rank pipelines (``pp_phase``; meshes naming cuda:0, one
   process driving every rank): (a) ``pipelined_generate`` of phase 6's
   first 8 prompts, ragged, 32 new tokens, at pp 2 and 4, native and int8,
   int4 at pp 2, and (dp 2, pp 2): every stream token-equal to
   ``generate()`` of the same batch and ``kv_cache_dtype``, or first
   differing at a top-2 gap below phase 7's bar (quantized: max(0.1, 2 x
   the first-token logit difference of a b/P-row prefill from the whole
   batch's)) in at most 2 of 8; K1 and K2 (K2q) launches exactly P x dp x
   ``generate()``'s; each rank's block bytes (L/P)/L of the whole, the
   embedding and head one copy on the card; steady decode tok/s printed
   beside ``generate()``'s; (b) the ViT-B/16 train step over (dp 2, pp 2):
   f32 gradients within phase 11's 1e-3 relative L2 of the one-rank
   step's, K1 and K7 launched num_micro x dp x depth times a step, bf16
   losses falling; (c) ``shard_vit`` at (dp 2, tp 2) within phase 12's
   bar of ``graph.apply`` (1e-4 f32, 1e-2 bf16, of the largest logit);
   (d) ``dryrun.dryrun_multichip(4)``. Launches are added to each row as
   ``pp_launches``.

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
    # The striped ring's steps (phase 20): a device int32 diagonal shift.
    cases += [(dict(b=1, h=12, s=s, d=64, causal=True), {
        "causal_shift": torch.full((), sh, dtype=torch.int32, device=dev)})
        for s in (1024, 2048) for sh in (0, 1)]
    for shp, kw in cases:
        b, h, s, d = shp["b"], shp["h"], shp["s"], shp["d"]
        q, k, v = rnd(b, h, s, d), rnd(b, h, s, d), rnd(b, h, s, d)
        out, lse = A.flash_attn_fwd(q, k, v, shp["causal"],
                                    kw.get("valid_from"),
                                    kw.get("causal_shift"), kw.get("window"))
        torch.cuda.synchronize()
        ref, ref_lse = A._reference_with_lse(
            q, k, v, shp["causal"], kw.get("valid_from"),
            kw.get("causal_shift"), kw.get("window"))
        rows = slice(None)
        if "valid_from" in kw:  # padded query rows are unspecified
            vf = kw["valid_from"]
            keep = torch.arange(s, device=dev)[None, :] >= vf[:, None]
            out, ref = out.transpose(1, 2)[keep], ref.transpose(1, 2)[keep]
            lse, ref_lse = lse.transpose(1, 2)[keep], ref_lse.transpose(1, 2)[keep]
        if "causal_shift" in kw:  # a row with no live key is unspecified
            keep = ref_lse > -1e29
            out, ref, lse, ref_lse = out[keep], ref[keep], lse[keep], ref_lse[keep]
            kw = {"causal_shift": int(kw["causal_shift"])}
        e = close(out[rows], ref[rows], 1e-2, 1e-2, f"K1 out {shp} {kw}")
        close(lse, ref_lse, 1e-3, 1e-5, f"K1 lse {shp} {kw}")
        errs["flash_attn_fwd"] = max(errs.get("flash_attn_fwd", 0.0), e)
        what = kw if "causal_shift" in kw else list(kw)
        print(f"K1 {shp} {what}: max abs err {e:.3e} (tol 1e-2 + 1e-2|ref|)")


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


def admit_path(a):
    """An admit event's path: "cow", "hit", "chunked" or "whole"."""
    return ("cow" if a["cow"] else "hit" if a["prefix_pages"] else
            "chunked" if a["chunked"] else "whole")


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
        path = admit_path(admits[rid])
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


def vit_step(torch, graph, x, y, num_micro, lr, attn_fn=None, steps=1,
             mesh=None):
    """``steps`` SGD steps of the port's ``make_train_step`` over the graph's
    own modules, every attention through ``attn_fn`` (None: K1 / K7), the
    blocks pipelined over ``mesh`` (None: one rank). Returns (losses as
    device tensors, step times in ms on CUDA events, the first step's
    gradients by parameter name)."""
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
        make_pipelined_vit_apply(graph, mesh, num_micro),
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
    # The gateway registers a joiner's lease before it lists its proxy:
    # wait for both.
    wait_for(lambda: {"w0", "w1", "w2"} <= set(pipe.registry.alive())
             and {"w0", "w1", "w2"} <= {p.worker_id
                                        for p in pipe.gateway.proxies},
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
            # lz compresses on the host at ~20 images/s: 8 requests show it.
            reqs = xs[:8] if codec == "lz" else xs
            pin(codec)
            pipe.dispatcher.warmup(xs[0])  # first calls in every process
            for p in order:
                p.bytes_sent = p.result_bytes_received = 0
            Q.quantize_blocks.launches = Q.dequantize_blocks.launches = 0
            ex0 = srv.executed
            got_before = sum(p.results_received for p in order)
            outs, wall, c, p50 = served(torch, pipe.dispatcher, reqs,
                                        f"hub {codec}")
            nq, nd = Q.quantize_blocks.launches, Q.dequantize_blocks.launches
            wire = sum(p.bytes_sent + p.result_bytes_received for p in order)
            rates[codec] = len(reqs) * 8 / wall
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
                  f"process), {graph.name} f32, codec {codec}, {len(reqs)} "
                  f"requests, on {card}: "
                  f"{rates[codec]:.1f} images/s, wire / raw bytes "
                  f"{wire / (hop_raw * len(reqs)):.4f}, stage dispatch-to-"
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
    """Phase 14 (a): 12 ``batch`` requests (priority 0, 128 new tokens)
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
            reqs[bat.submit(p, 128, on_token=on_token,
                            slo=SLOSpec(tenant="batch"))] = (p, 128)
        try:
            bat.submit(batch[12], 128, slo=SLOSpec(tenant="batch"))
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


def steady_sync_check(torch, lm, card, layout, label="phase 14 (c)"):
    """Phase 14 (c): one steady depth-2 tick on ``layout`` (8 slots of
    256-token prompts, every slot decoding, a tick in flight) makes 0
    host->device copies and 1 fetch, and its dispatch half runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (no stream sync, no
    blocking copy). Phase 18 (c) runs it over tp shards."""
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
        raise AssertionError(f"{label}: no tick in flight")
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
        raise AssertionError(f"{label} {layout}: a steady depth-2 tick "
                             f"made {steady[0]} host->device copies and "
                             f"{steady[1]} fetches (want 0 and 1)")
    bat.close()
    print(f"{label} steady depth-2 tick [{layout}] on {card}: 0 "
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
    prompts, chunk 8) on each layout at depth 1, then 2: 6 ticks timed on
    the host clock (tok/s and the mean ``runtime.overlap_ratio``), then 3
    more under ``torch.profiler`` (device activity only: a host trace of
    ~16k launches takes longer to reduce than to record) for the busy
    share, kernel time a tick over the unprofiled wall a tick."""
    from adapt_tpu_torch.config import RuntimeConfig
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
    from adapt_tpu_torch.utils.metrics import global_metrics

    acts = [torch.profiler.ProfilerActivity.CUDA]
    for layout in ("slots", "paged"):
        extra = (dict(kv_layout="paged", page_size=128)
                 if layout == "paged" else {})
        for depth in (1, 2):
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
#: lm_decode.py --moe 8``), cut to 6 of the 12 blocks so that the whole
#: script, phase 16 included, stays near 700 s on the card.
MOE_EXPERTS, MOE_TOP_K, MOE_DEPTH = 8, 2, 6
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
    weights from seed 0) at ``MOE_DEPTH`` blocks with ``moe_experts=8,
    moe_top_k=2``, on the card."""
    from adapt_tpu_torch.models.transformer_lm import transformer_lm

    vocab, dim, _, heads, mlp = GPT2_SMALL
    t0 = time.perf_counter()
    moe = transformer_lm(vocab, dim, MOE_DEPTH, heads, mlp, max_len=1024,
                         dtype=torch.bfloat16, name="gpt2_small_moe",
                         moe_experts=MOE_EXPERTS, moe_top_k=MOE_TOP_K,
                         seed=0)
    n = sum(p.numel() for p in moe.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in moe.parameters())
    print(f"phase 15 (a) MoE model ({MOE_DEPTH} blocks, {MOE_EXPERTS} "
          f"experts, top-{MOE_TOP_K}) built in {time.perf_counter() - t0:.1f} s: {n} parameters, "
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
    """Phase 15 (a): the MoE LM at full width (``MOE_DEPTH`` blocks)
    through ``generate()`` (4 ragged prompts), one decode step's batch
    invariance, the dense batcher on phase 6's first 8 requests, the paged
    batcher on phase 7's traffic and the paged traffic's 8 unique prompts
    on an int8 pool."""
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
        wait_for(lambda: {"t0", "t1", "t2"} <= set(pipe.registry.alive())
                 and {"t0", "t1", "t2"} <= {p.worker_id
                                            for p in pipe.gateway.proxies},
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


# -- phase 16: pipelined decode, disaggregated prefill, the host KV tier ------

#: Phase 16 (a)'s fault settings: phase 12's deadline, a short lease; the
#: recovery budget is 10 x (deadline + lease TTL), phase 12's.
FLEET_FAULT = dict(lease_ttl_s=0.5, heartbeat_s=0.1, task_deadline_s=2.0,
                   watchdog_period_s=0.05, max_retries=4)

#: Phase 16's kernel rows by path kind (int8 paths count into the int8
#: rows, as phase 15's do).
FLEET_ROWS = {
    "native": {"flash_attn_fwd": "flash_attn_fwd",
               "decode_attn": "decode_attn", "paged_attn": "paged_attn",
               "paged_chunk_attn": "paged_chunk_attn",
               "paged_verify_attn": "paged_verify_attn"},
    "int8": {"flash_attn_fwd": "flash_attn_fwd",
             "decode_attn": "decode_attn[int8]",
             "paged_attn": "paged_attn[int8]",
             "paged_chunk_attn": "paged_chunk_attn[int8]"},
}


def fleet_ragged(torch, vocab):
    """Phase 16 (a)'s prompts from seed 16: 8 ragged prompts of 16-256
    tokens, right-padded into one (8, longest) batch, and their lengths."""
    rng = torch.Generator().manual_seed(16)
    lens = torch.randint(16, 257, (8,), generator=rng).tolist()
    batch = torch.randint(0, vocab, (8, max(lens)), generator=rng)
    for i, n in enumerate(lens):
        batch[i, n:] = 0
    return batch.numpy(), lens


def pipelined_part(torch, lm, card, counters, runs):
    """Phase 16 (a): ``PipelinedDecoder`` over the 12 blocks cut at [4, 8],
    three stages on three ``StageWorker`` s of the card and one spare: 8
    ragged prompts, 32 new tokens, 2 microbatches, native then int8 stage
    caches, each without faults and then with a ``crash`` of stage 1 and a
    ``hang`` of stage 2 mid-decode. Greedy streams must equal
    ``generate()`` with the same ``kv_cache_dtype`` on each microbatch's
    rows (the shapes the stages run; equality with one 8-row
    ``generate()`` is printed); K1 and K2 (K2q) launch in every run; each
    recovery ends within 10 x (deadline + lease TTL) of its kill."""
    from adapt_tpu_torch.config import FaultConfig
    from adapt_tpu_torch.models.transformer_lm import generate
    from adapt_tpu_torch.runtime.decode_pipeline import PipelinedDecoder

    fault = FaultConfig(**FLEET_FAULT)
    budget = 10 * (fault.task_deadline_s + fault.lease_ttl_s)
    prompt, lens = fleet_ragged(torch, lm.vocab)
    steps, M = 32, 2
    mb = len(lens) // M
    for kv in ("native", "int8"):
        want = np.concatenate([generate(
            lm, prompt[m * mb:(m + 1) * mb], steps,
            prompt_lengths=lens[m * mb:(m + 1) * mb],
            kv_cache_dtype=kv).cpu().numpy() for m in range(M)])
        whole = generate(lm, prompt, steps, prompt_lengths=lens,
                         kv_cache_dtype=kv).cpu().numpy()
        for faults in (False, True):
            path = f"pipelined_{'faults_' if faults else ''}{kv}"
            kills: list = []

            def run():
                with PipelinedDecoder(lm, [4, 8], fault=fault,
                                      kv_cache_dtype=kv) as dec:
                    def on_token(m, s):
                        # Stage 1 crashes once microbatch 0 has 8 tokens,
                        # stage 2 hangs once microbatch 1 has 20.
                        for stage, mode, mm, ss in ((1, "crash", 0, 7),
                                                    (2, "hang", 1, 19)):
                            if (faults and (m, s) == (mm, ss)
                                    and stage not in [k[0] for k in kills]):
                                kills.append((stage, mode, time.monotonic()))
                                dec.kill_worker(stage, mode)

                    t0 = time.perf_counter()
                    got = dec.generate(prompt, steps, prompt_lengths=lens,
                                       num_microbatches=M,
                                       on_token=on_token if faults else None)
                    torch.cuda.synchronize()
                    return got, time.perf_counter() - t0, dec.recovery_log

            got, wall, log = counted(counters, path,
                                     ("flash_attn_fwd", "decode_attn"), runs,
                                     run)
            if got.shape != want.shape or not np.array_equal(got, want):
                bad = np.argwhere(got != want)[:3].tolist()
                raise AssertionError(f"phase 16 (a) {path}: streams differ "
                                     f"from generate() at {bad}")
            rec = []
            if faults:
                if len(kills) != 2 or len(log) < 2:
                    raise AssertionError(f"phase 16 (a) {path}: kills {kills}"
                                         f", recoveries {log}")
                for stage, mode, t_kill in kills:
                    end = min((r["end"] for r in log if r["stage"] == stage
                               and r["end"] >= t_kill), default=None)
                    if end is None:
                        raise AssertionError(
                            f"phase 16 (a) {path}: stage {stage} ({mode}) "
                            f"was never recovered: {log}")
                    rec.append((stage, mode, end - t_kill))
                    if end - t_kill > budget:
                        raise AssertionError(
                            f"phase 16 (a) {path}: stage {stage} ({mode}) "
                            f"recovered {end - t_kill:.2f} s after its kill "
                            f"(budget {budget:.1f} s)")
            print(f"phase 16 (a) PipelinedDecoder[{kv}"
                  f"{', crash + hang' if faults else ''}] on {card}: 8 ragged "
                  f"prompts {lens}, {steps} tokens, {M} microbatches, 3 "
                  f"stages + 1 spare: streams equal generate() per "
                  f"microbatch (one 8-row generate(): "
                  f"{'equal' if np.array_equal(got, whole) else 'differs'}), "
                  f"{got.size} tokens in {wall:.3f} s = {got.size / wall:.1f}"
                  f" tok/s"
                  + "".join(f", stage {s} {m} recovered in {t:.3f} s"
                            for s, m, t in rec)
                  + f" (budget {budget:.1f} s), launches {runs[path]}")


def serve_waves(server, waves, steps=64, on_token=None):
    """Submit ``waves`` to a batcher, a ``DisaggServer`` or a router with
    two ticks between waves, then run. Returns ({id: prompt}, results,
    wall s)."""
    t0 = time.perf_counter()
    prompts = {}
    for i, wave in enumerate(waves):
        if i:
            server.tick()
            server.tick()
        for p in wave:
            prompts[server.submit(p, steps, on_token=on_token)] = p
    out = server.run()
    return prompts, out, time.perf_counter() - t0


def windowed(reg, before):
    """(prefill-stall count, sum s; handoff count, sum s; handoff bytes,
    raw bytes, pages streamed) in the metrics window since ``before``."""
    win = reg.snapshot(since=before)
    h, c = win["histograms"], win["counters"]
    stall = h.get("continuous.prefill_stall_s", {})
    ho = h.get("disagg.handoff_s", {})
    return (stall.get("count", 0), stall.get("sum", 0.0), ho.get("count", 0),
            ho.get("sum", 0.0), c.get("disagg.handoff_bytes", 0.0),
            c.get("disagg.handoff_bytes_raw", 0.0),
            c.get("disagg.pages_streamed", 0.0))


def disagg_pair(lm, kv="native", **batcher_kw):
    """Phase 7's paged batcher (slots 8, chunk 8, page 128, prefill_chunk
    256, the 65-page pool) behind a ``DisaggServer`` whose
    ``PrefillWorker`` (2 slots, prefill_chunk 256) has its own pool; prompts
    of 600 tokens and more disaggregate."""
    from adapt_tpu_torch.config import DisaggConfig
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
    from adapt_tpu_torch.runtime.disagg import DisaggServer, PrefillWorker

    decode = ContinuousBatcher(lm, slots=8, chunk=8, kv_layout="paged",
                               page_size=128, prefill_chunk=256,
                               kv_cache_dtype=kv, **batcher_kw)
    worker = PrefillWorker(lm, page_size=128, slots=2, prefill_chunk=256,
                           kv_cache_dtype=kv)
    return DisaggServer(decode, worker, DisaggConfig(
        prompt_threshold=600, busy_prompt_threshold=600)), tier_k4(worker)


def tier_k4(worker):
    """Count the K4 launches made inside a prefill tier's ``step``: returns
    the one-element count the wrapped step adds to."""
    k4, step = [0], worker.step

    def counted_step():
        n0 = _paged_chunk_launches()
        out = step()
        k4[0] += _paged_chunk_launches() - n0
        return out

    worker.step = counted_step
    return k4


def _paged_chunk_launches():
    from adapt_tpu_torch.ops import paged_attention as P

    return P.paged_chunk_attn.launches


def disagg_part(torch, lm, card, counters, runs, waves):
    """Phase 16 (b): phase 7's paged traffic (two staggered waves, no
    cancel, no fan-out) through ``disagg_pair`` and through the same
    batcher served collocated, native, on an int8 pool, and with a
    self-draft speculative batcher (``draft_k=4``): every stream equal to
    the collocated one; the 600-900-token prompts disaggregated;
    ``disagg.pages_streamed`` above 0; K4 (K4q) launched in the prefill
    tier and K3 (K3q; K5 when speculative) in decode. Then a 769-token
    prompt's handed-off pages ``torch.equal`` to an in-place chunked
    prefill's, and one corrupted frame failing its request while the other
    two complete with their streams."""
    from adapt_tpu_torch.config import SpeculativeConfig
    from adapt_tpu_torch.runtime import disagg as DG
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
    from adapt_tpu_torch.runtime.paged import Pager
    from adapt_tpu_torch.utils.metrics import global_metrics

    reg = global_metrics()
    outs = {}
    for tag, kv, extra, want_dec in (
        ("native", "native", {}, "paged_attn"),
        ("int8", "int8", {}, "paged_attn"),
        ("spec", "native", dict(draft_lm=lm, speculative=SpeculativeConfig(
            draft_k=4)), "paged_verify_attn"),
    ):
        before = reg.snapshot(window=True)
        colo = ContinuousBatcher(lm, slots=8, chunk=8, kv_layout="paged",
                                 page_size=128, prefill_chunk=256,
                                 kv_cache_dtype=kv, **extra)
        cprompts, cout, cwall = counted(
            counters, f"collocated_{tag}", ("paged_attn" if not extra else
                                            "paged_verify_attn",), runs,
            lambda: serve_waves(colo, waves))
        c_stats = windowed(reg, before)
        colo.close()
        before = reg.snapshot(window=True)
        srv, k4 = disagg_pair(lm, kv, **extra)
        path = f"disagg_{tag}"
        dprompts, dout, dwall = counted(
            counters, path, ("paged_chunk_attn", want_dec), runs,
            lambda: serve_waves(srv, waves))
        d_stats = windowed(reg, before)
        torch.cuda.synchronize()
        if k4[0] == 0:
            raise AssertionError(f"phase 16 (b) {path}: no K4 launch in the "
                                 "prefill tier")
        decode_k4 = runs[path]["paged_chunk_attn"] - k4[0]
        ndis = sum(1 for p in dprompts.values() if len(p) >= 600)
        if srv.disaggregated != ndis or srv.failed or d_stats[6] <= 0:
            raise AssertionError(
                f"phase 16 (b) {path}: {srv.disaggregated} disaggregated of "
                f"{ndis} long prompts, {srv.failed} failed, pages streamed "
                f"{d_stats[6]}")
        cby = {tuple(p): cout[r] for r, p in cprompts.items()}
        for sid, p in dprompts.items():
            if not np.array_equal(dout[sid], cby[tuple(p)]):
                bad = int((dout[sid] != cby[tuple(p)]).argmax())
                raise AssertionError(
                    f"phase 16 (b) {path}: request {sid} (prompt {len(p)}) "
                    f"differs from the collocated stream at token {bad}")
        st = srv.stats()
        if st["pages_in_use"] != 0:
            raise AssertionError(f"phase 16 (b) {path}: pool not drained {st}")
        outs[tag] = {tuple(p): dout[s] for s, p in dprompts.items()}
        ntok = sum(len(v) for v in dout.values())
        print(f"phase 16 (b) DisaggServer[{tag}] on {card}: "
              f"{len(dprompts)} requests ({srv.disaggregated} disaggregated, "
              f"{srv.collocated} collocated), streams equal the collocated "
              f"batcher's; {ntok} tokens in {dwall:.3f} s = "
              f"{ntok / dwall:.1f} tok/s (collocated {cwall:.3f} s = "
              f"{ntok / cwall:.1f} tok/s); handoffs {d_stats[2]}: "
              f"{d_stats[4]:.0f} wire bytes ({d_stats[5]:.0f} raw), "
              f"{d_stats[6]:.0f} pages, {d_stats[3]:.4f} s in all; "
              f"continuous.prefill_stall_s {d_stats[0]} samples, "
              f"{d_stats[1]:.4f} s (collocated {c_stats[0]} samples, "
              f"{c_stats[1]:.4f} s); K4 launches: {k4[0]} in the prefill "
              f"tier, {decode_k4} in decode; launches {runs[path]}")
        srv.close()
        srv.decode.close()

    # Handed-off pages == an in-place chunked prefill's (769 tokens: six
    # full pages, three chunks of 256 in both tiers).
    p769 = torch.randint(0, lm.vocab, (769,), generator=torch.Generator(
        ).manual_seed(161)).numpy()
    colo = ContinuousBatcher(lm, slots=8, chunk=8, kv_layout="paged",
                             page_size=128, prefill_chunk=256)
    colo.submit(p769, 1)
    colo.run()
    srv, _ = disagg_pair(lm)
    srv.submit(p769, 1)
    srv.run()
    for j in range(768 // 128):
        key = Pager.prefix_key(p769, (j + 1) * 128)
        cp, dp = colo._pager._by_key[key], srv.decode._pager._by_key[key]
        for b, (cpair, dpair) in enumerate(zip(colo._caches,
                                               srv.decode._caches)):
            for cpool, dpool in zip(cpair, dpair):
                if not torch.equal(cpool[cp], dpool[dp]):
                    raise AssertionError(f"phase 16 (b): handed-off page {j} "
                                         f"of block {b} differs from the "
                                         "in-place chunked prefill's")
    colo.close()
    srv.close()
    srv.decode.close()

    # One corrupted frame fails its request; the other two complete.
    longp = [p for w in waves for p in w if len(p) >= 600][:3]
    srv, _ = disagg_pair(lm)
    real = DG.loopback
    hit = []

    def corrupting(msg):
        if hit:
            return real(msg)
        hit.append(msg.request_id)
        wire = bytearray(b"".join(DG.frame_parts(msg)))
        wire[len(wire) // 2] ^= 0xFF
        return DG.parse_frame(memoryview(wire)[8:])

    DG.loopback = corrupting
    try:
        sids = [srv.submit(p, 64) for p in longp]
        got = srv.run()
    finally:
        DG.loopback = real
    bad = [s for s in sids if len(got[s]) == 0]
    if bad != hit or srv.failed != 1:
        raise AssertionError(f"phase 16 (b): corrupted request {hit}, empty "
                             f"results {bad}, failed {srv.failed}")
    for s, p in zip(sids, longp):
        if s not in hit and not np.array_equal(got[s], outs["native"][
                tuple(p)]):
            raise AssertionError(f"phase 16 (b): request {s} beside the "
                                 "corrupted frame differs from its stream")
    srv.close()
    srv.decode.close()
    print(f"phase 16 (b) on {card}: handed-off pages of a 769-token prompt "
          f"torch.equal to an in-place chunked prefill's (6 pages x 12 "
          f"blocks x K, V); a corrupted frame failed request {hit[0]} "
          f"cleanly, the other two completed with their streams")


def tier_traffic(torch, lm, waves, tier=None, pool_pages=38):
    """Phase 7's two waves served twice by one paged batcher (slots 8,
    chunk 8, page 128, prefill_chunk 256) of ``pool_pages`` pages, with
    ``tier`` as its host KV tier. Returns the batcher, {id: prompt},
    results, admit events by id and the wall."""
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
    from adapt_tpu_torch.utils.tracing import global_flight_recorder

    fr = global_flight_recorder()
    _, cursor = fr.events_since(1 << 62)
    bat = ContinuousBatcher(lm, slots=8, chunk=8, kv_layout="paged",
                            page_size=128, prefill_chunk=256,
                            pool_pages=pool_pages, cache_tier=tier)
    prompts, out, wall = {}, {}, 0.0
    for _ in range(2):
        p, o, w = serve_waves(bat, waves)
        prompts.update(p)
        out.update(o)
        wall += w
    torch.cuda.synchronize()
    events, _ = fr.events_since(cursor)
    admits = {e["data"]["request"]: e["data"] for e in events
              if e["kind"] == "admit"}
    return bat, prompts, out, admits, wall


def tier_part(torch, lm, card, counters, runs, waves, solo):
    """Phase 16 (c): phase 7's traffic served twice by a paged batcher of
    38 pages (the prefix LRU evicts, and admission never waits on the
    pool) with ``CacheTierConfig(warm_codec="lz")``:
    ``cache_tier.spilled_total`` and ``readmitted_total`` above 0 and
    every stream equal to the same traffic on a 200-page batcher with
    no tier (nothing evicted: its second round hits where the tiered one
    readmits). Then a cold ``int8`` codec (warm capacity 0) on the same
    traffic, held by phase 7's tie-aware check against ``generate()`` at
    max(0.1, 2 x the first-token logit error of a lossy readmit against a
    lossless one), with no cap on exemptions, as phase 9 holds its int8
    pool; every spill demoted to the cold sub-tier. On bf16 pages the
    lossy codecs degrade to "lz", as the JAX package's do on
    ``ml_dtypes.bfloat16`` pages: the codecs the cold pages took are
    printed."""
    from adapt_tpu_torch.config import CacheTierConfig
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
    from adapt_tpu_torch.utils.metrics import global_metrics

    reg = global_metrics()
    want = ("flash_attn_fwd", "paged_attn", "paged_chunk_attn")
    ref, rprompts, rout, _, rwall = counted(
        counters, "tier_reference", want, runs,
        lambda: tier_traffic(torch, lm, waves, pool_pages=200))
    ref.close()
    rby = {}
    for r, p in rprompts.items():
        rby.setdefault(tuple(p), []).append(rout[r])
    lossless = CacheTierConfig(warm_codec="lz", spill_pages_per_tick=64,
                               readmit_pages_per_tick=64)
    before = reg.snapshot(window=True)
    bat, prompts, out, admits, wall = counted(
        counters, "tier_lz", want, runs,
        lambda: tier_traffic(torch, lm, waves, lossless))
    c = reg.snapshot(since=before)["counters"]
    spilled = c.get("cache_tier.spilled_total", 0)
    readmitted = c.get("cache_tier.readmitted_total", 0)
    st = bat.stats()
    if spilled <= 0 or readmitted <= 0 or st["pages_in_use"] != 0:
        raise AssertionError(f"phase 16 (c): spilled {spilled}, readmitted "
                             f"{readmitted}, {st}")
    seen: dict = {}
    for r, p in prompts.items():
        k = tuple(p)
        i = seen.get(k, 0)
        seen[k] = i + 1
        if not np.array_equal(out[r], rby[k][i]):
            bad = int((out[r] != rby[k][i]).argmax())
            raise AssertionError(f"phase 16 (c): request {r} (prompt {len(p)}"
                                 f") differs from the untiered run at token "
                                 f"{bad}")
    ntok = sum(len(v) for v in out.values())
    paths = {}
    for r in prompts:
        a = admits[r]
        k = "hit" if a["prefix_pages"] else "chunked" if a["chunked"] else \
            "whole"
        paths[k] = paths.get(k, 0) + 1
    bat.close()
    print(f"phase 16 (c) host KV tier[lz] on {card}: {len(prompts)} requests"
          f" on a 38-page pool (paths {paths}), streams equal the untiered "
          f"200-page run's; spilled {spilled:.0f}, readmitted "
          f"{readmitted:.0f}, dropped {st['tier_dropped']}, host pages "
          f"{st['host_pages']}, host bytes {st['host_bytes']} (codec saved "
          f"{st['tier_codec_bytes_saved']}); {ntok} tokens in {wall:.3f} s "
          f"= {ntok / wall:.1f} tok/s (untiered {ntok / rwall:.1f}); "
          f"launches {runs['tier_lz']}")

    cold = CacheTierConfig(warm_capacity_pages=0, cold_codec="int8",
                           spill_pages_per_tick=64, readmit_pages_per_tick=64)
    # The bar: a readmitted prefix hit's first-token logits through the
    # cold codec against the same pass through the lossless one, for the
    # shared-prefix prompt and a long one (every pool page evicted, so
    # spilled, between the prompt's first pass and its readmitted one).
    err = 0.0
    for p in (waves[0][0], max(waves[0], key=len)):
        lg = []
        for cfg in (lossless, cold):
            b = ContinuousBatcher(lm, slots=8, chunk=8, kv_layout="paged",
                                  page_size=128, prefill_chunk=256,
                                  pool_pages=38, cache_tier=cfg)
            b.submit(p, 1)
            b.run()
            b._pager.evict_cached()
            lg.append(first_token_logits(b, p))
            if b.stats()["tier_readmitted"] < 1:
                raise AssertionError("phase 16 (c): the probe did not "
                                     "readmit")
            b.close()
        err = max(err, float((lg[0] - lg[1]).abs().max()))
    bar = max(0.1, 2 * err)
    bat, prompts, out, admits, wall = counted(
        counters, "tier_cold_int8", want, runs,
        lambda: tier_traffic(torch, lm, waves, cold))
    exempt, paths = check_paged_streams(torch, lm, prompts, out, admits, None,
                                        [], None, solo, bar, None)
    st = bat.stats()
    ts = bat._tier.stats()
    applied: dict = {}
    for entry in bat._tier._cold.values():
        for pair in entry.blocks:
            for member in pair:
                for _, meta in member:
                    applied[meta["codec"]] = applied.get(meta["codec"], 0) + 1
    bat.close()
    if ts.cold < 1 or ts.warm != 0:
        raise AssertionError(f"phase 16 (c) cold int8: pages not demoted "
                             f"{ts}")
    print(f"phase 16 (c) host KV tier[cold int8] on {card}: "
          f"{len(prompts)} requests (paths {paths}), {len(exempt)} tie "
          f"exemptions at bar {bar:.4f} (a lossy readmit's first-token logit"
          f" error {err:.4f}); readmitted {st['tier_readmitted']}, {ts.cold} "
          f"cold pages, their leaves' codecs {applied}, codec saved "
          f"{st['tier_codec_bytes_saved']} bytes; launches "
          f"{runs['tier_cold_int8']}")


def fleet_phase(torch, A, D, P, lm, card, kernels, solo, waves):
    """Phase 16: (a) pipelined decode through stage workers with a crash
    and a hang, (b) disaggregated prefill, (c) the host KV tier. Adds
    ``fleet_launches`` (phase 16's launches of each kernel, its runs
    summed) to every row of ``kernels``."""
    t_phase = time.perf_counter()
    counters = {"flash_attn_fwd": A.flash_attn_fwd,
                "decode_attn": D.decode_attn, "paged_attn": P.paged_attn,
                "paged_chunk_attn": P.paged_chunk_attn,
                "paged_verify_attn": P.paged_verify_attn}
    runs: dict = {}
    took = []
    t = time.perf_counter()
    pipelined_part(torch, lm, card, counters, runs)
    took.append(time.perf_counter() - t)
    disagg_part(torch, lm, card, counters, runs, waves)
    took.append(time.perf_counter() - t - sum(took))
    tier_part(torch, lm, card, counters, runs, waves, solo)
    took.append(time.perf_counter() - t - sum(took))
    totals: dict = {}
    for path, launches in runs.items():
        rows = FLEET_ROWS["int8" if path.endswith("int8")
                          and "cold" not in path else "native"]
        for k, n in launches.items():
            if k in rows:
                totals[rows[k]] = totals.get(rows[k], 0) + n
    for kr in kernels:
        kr["fleet_launches"] = totals.get(kr["name"], 0)
    print(f"phase 16 launches by path: {json.dumps(runs)}")
    print(f"phase 16 (pipelined decode, disaggregated prefill, host KV tier) "
          f"took {time.perf_counter() - t_phase:.1f} s on {card} ((a) "
          f"{took[0]:.1f}, (b) {took[1]:.1f}, (c) {took[2]:.1f})")


# -- phase 17: the fleet router and autoscaler --------------------------------


def router_replica(lm, kv="native", scheduler=None):
    """Phase 7's paged batcher (slots 8, chunk 8, page 128, prefill_chunk
    256, the 65-page pool) rebuilding its capacity book every tick: one
    replica behind a ``FleetRouter``."""
    from adapt_tpu_torch.config import CapacityConfig
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

    return ContinuousBatcher(lm, slots=8, chunk=8, kv_layout="paged",
                             page_size=128, prefill_chunk=256,
                             kv_cache_dtype=kv,
                             capacity=CapacityConfig(refresh_s=0.0),
                             scheduler=scheduler)


def solo_reference(lm, waves, steps):
    """The traffic served by one replica alone: {prompt bytes: (stream,
    admission path)} and the wall."""
    from adapt_tpu_torch.utils.tracing import global_flight_recorder

    fr = global_flight_recorder()
    _, cursor = fr.events_since(1 << 62)
    bat = router_replica(lm)
    prompts, out, wall = serve_waves(bat, waves, steps)
    events, _ = fr.events_since(cursor)
    paths = {e["data"]["request"]: admit_path(e["data"]) for e in events
             if e["kind"] == "admit"}
    bat.close()
    return {p.tobytes(): (out[r], paths[r]) for r, p in prompts.items()}, wall


class FleetRun:
    """One router run's books: where each request was last submitted for
    decode (replica, engine id), the admission path there (admit events
    attributed to the replica whose tick recorded them: the router ticks
    its replicas one after another on one thread) and the token indices
    its client saw."""

    def __init__(self, router):
        self.where: dict = {}
        self.paths: dict = {}
        self.seen: dict = {}
        submit = router._decode_submit

        def decode_submit(t, rep):
            submit(t, rep)
            self.where[t.sid] = (rep.name, t.rid)

        router._decode_submit = decode_submit
        for rep in list(router._replicas.values()):
            self._watch(rep.name, rep.engine)

    def _watch(self, name, engine):
        from adapt_tpu_torch.utils.tracing import global_flight_recorder

        fr = global_flight_recorder()
        tick = engine.tick

        def watched_tick():
            _, cursor = fr.events_since(1 << 62)
            try:
                return tick()
            finally:
                events, _ = fr.events_since(cursor)
                for e in events:
                    if e["kind"] == "admit":
                        self.paths[name, e["data"]["request"]] = admit_path(
                            e["data"])

        engine.tick = watched_tick

    def on_token(self, sid, tok, idx):
        self.seen.setdefault(sid, []).append(idx)

    def path(self, sid):
        return self.paths[self.where[sid]]

    def reference(self, prompts, out):
        """This run as a reference: {prompt bytes: (stream, path)}."""
        return {p.tobytes(): (out[s], self.path(s))
                for s, p in prompts.items()}


def hold_streams(torch, lm, label, run, prompts, out, ref, solo, steps,
                 kv="native", bar=0.1, max_exempt=2):
    """Phase 17's rule: a stream admitted on the same path (whole, hit,
    chunked) as in ``ref`` must equal ``ref``'s stream; any other passes
    phase 7's tie-aware check against ``generate()`` alone (a first
    difference only at a top-2 gap below ``bar``, at most ``max_exempt``
    streams). Every client saw indices 0..n-1 exactly once, in order.
    Returns (exemptions, {path: count}, requests whose path moved)."""
    exempt, paths, moved = [], {}, 0
    for sid, p in prompts.items():
        got = out[sid]
        want, want_path = ref[p.tobytes()]
        if len(got) != steps:
            raise AssertionError(f"{label}: request {sid} has {len(got)} "
                                 f"tokens, not {steps}")
        if run.seen.get(sid) != list(range(steps)):
            raise AssertionError(f"{label}: request {sid}'s client saw "
                                 f"indices {run.seen.get(sid)}")
        path = run.path(sid)
        paths[path] = paths.get(path, 0) + 1
        moved += path != want_path
        if np.array_equal(got, want):
            continue
        if path == want_path:
            bad = int((got != want).argmax())
            raise AssertionError(f"{label}: request {sid} ({path}, prompt "
                                 f"{len(p)}) differs from its reference "
                                 f"run on the same path at token {bad}")
        tg = first_gap(torch, lm, p, got, solo(p, None, kv, steps))
        if tg is None:
            continue
        t, gap = tg
        print(f"tie-aware exemption: {label} request {sid} ({path}; "
              f"{want_path} in the reference, prompt {len(p)}) first "
              f"differs from generate() at token {t}, top-2 gap {gap:.4f}")
        if gap >= bar:
            raise AssertionError(f"{label}: request {sid} differs at token "
                                 f"{t} with top-2 gap {gap:.4f} >= {bar:.4f}")
        exempt.append(sid)
    if len(exempt) > max_exempt:
        raise AssertionError(f"{label}: {len(exempt)} streams needed the tie "
                             f"exemption (at most {max_exempt})")
    return exempt, paths, moved


def flight_since(cursor, kind):
    from adapt_tpu_torch.utils.tracing import global_flight_recorder

    events, _ = global_flight_recorder().events_since(cursor)
    return [e["data"] for e in events if e["kind"] == kind]


def flight_cursor():
    from adapt_tpu_torch.utils.tracing import global_flight_recorder

    return global_flight_recorder().events_since(1 << 62)[1]


def no_leave(label, cursor, router):
    """Phase 17's guard against a silent re-placement: no replica left and
    no request failed."""
    leaves = flight_since(cursor, "replica_leave")
    if leaves or router.failed:
        raise AssertionError(f"{label}: replica_leave {leaves}, "
                             f"{router.failed} requests failed")


def placement_part(torch, lm, card, counters, runs, waves, solo):
    """Phase 17 (a): phase 7's paged traffic (two waves, no cancel, no
    fan-out) through a ``FleetRouter`` over two replicas with leases in a
    ``WorkerRegistry``, held to one replica serving it alone. Returns that
    solo reference ((c)'s) and this run as (e)'s collocated reference."""
    from adapt_tpu_torch.control.registry import WorkerRegistry
    from adapt_tpu_torch.runtime.router import FleetRouter
    from adapt_tpu_torch.utils.metrics import global_metrics

    ref, swall = solo_reference(lm, waves, 64)
    reg = WorkerRegistry()
    router = FleetRouter({"r0": router_replica(lm), "r1": router_replica(lm)},
                         registry=reg)
    run = FleetRun(router)
    cursor = flight_cursor()
    prompts, out, wall = counted(
        counters, "router_placement",
        ("flash_attn_fwd", "paged_attn", "paged_chunk_attn"), runs,
        lambda: serve_waves(router, waves, 64, run.on_token))
    torch.cuda.synchronize()
    kinds = {n: m.get("capacity", {}).get("kind")
             for n, m in reg.alive_meta().items()}
    if kinds != {"decode:r0": "decode", "decode:r1": "decode"}:
        raise AssertionError(f"phase 17 (a): lease books {kinds}")
    decisions = router.placements()["decisions"]
    if len(decisions) != 16 or any(d["kind"] != "placed" for d in decisions):
        raise AssertionError(f"phase 17 (a): decisions "
                             f"{[d['kind'] for d in decisions]}")
    no_leave("phase 17 (a)", cursor, router)
    st = router.stats()
    if st["pages_in_use"] != 0 or st["placed"] != 16:
        raise AssertionError(f"phase 17 (a): {st}")
    exempt, paths, moved = hold_streams(torch, lm, "phase 17 (a)", run,
                                        prompts, out, ref, solo, 64)
    by_rep = {n: sum(d["replica"] == n for d in decisions)
              for n in ("r0", "r1")}
    ntok = sum(len(v) for v in out.values())
    ratio = global_metrics().snapshot()["gauges"].get(
        "router.affinity_hit_ratio")
    print(f"phase 17 (a) FleetRouter[2 replicas] on {card}: 16 requests "
          f"placed {by_rep} (paths {paths}, {moved} on another path than "
          f"alone), streams held to one replica alone ({len(exempt)} tie "
          f"exemptions), exactly-once delivery, both leases carry decode "
          f"books; affinity hit ratio {ratio}; {ntok} tokens in {wall:.3f} s"
          f" = {ntok / wall:.1f} tok/s (one replica alone {ntok / swall:.1f}"
          f"); launches {runs['router_placement']}")
    router.close(close_engines=True)
    return ref, run.reference(prompts, out)


def affinity_traffic(torch, vocab):
    """Phase 17 (b)'s requests from seed 17: 6 prefixes of 384 tokens (3
    full pages), each 4 times with a unique tail of 16-64 tokens,
    interleaved (request i carries prefix i mod 6), in 3 waves of 8:
    recurring system prompts shared by many users."""
    rng = torch.Generator().manual_seed(17)
    prefixes = [torch.randint(0, vocab, (384,), generator=rng).numpy()
                for _ in range(6)]
    reqs = []
    for i in range(24):
        n = int(torch.randint(16, 65, (1,), generator=rng))
        reqs.append(np.concatenate([
            prefixes[i % 6],
            torch.randint(0, vocab, (n,), generator=rng).numpy()]))
    return [reqs[0:8], reqs[8:16], reqs[16:24]]


def affinity_part(torch, lm, card, counters, runs, solo):
    """Phase 17 (b): ``affinity_traffic`` (32 new tokens) through two fresh
    two-replica fleets, ``policy="affinity"`` and ``policy="random"`` (seed
    0): the affinity arm's fleet-summed prefix hits at least the random
    arm's; both arms held to one replica alone."""
    from adapt_tpu_torch.config import RouterConfig
    from adapt_tpu_torch.runtime.router import FleetRouter
    from adapt_tpu_torch.utils.metrics import global_metrics

    reg = global_metrics()
    waves = affinity_traffic(torch, lm.vocab)
    ref, swall = solo_reference(lm, waves, 32)
    hits, line = {}, []
    for policy in ("affinity", "random"):
        router = FleetRouter(
            {"r0": router_replica(lm), "r1": router_replica(lm)},
            config=RouterConfig(policy=policy), seed=0)
        run = FleetRun(router)
        cursor = flight_cursor()
        before = reg.snapshot(window=True)
        path = f"router_{policy}"
        prompts, out, wall = counted(
            counters, path, ("paged_attn", "paged_chunk_attn"), runs,
            lambda: serve_waves(router, waves, 32, run.on_token))
        torch.cuda.synchronize()
        ttft = reg.snapshot(since=before)["histograms"].get(
            "continuous.ttft_s", {})
        no_leave(f"phase 17 (b) {policy}", cursor, router)
        exempt, paths, moved = hold_streams(
            torch, lm, f"phase 17 (b) {policy}", run, prompts, out, ref,
            solo, 32)
        st = router.stats()
        hits[policy] = st["prefix_hits"]
        ratio = reg.snapshot()["gauges"]["router.affinity_hit_ratio"]
        ntok = sum(len(v) for v in out.values())
        line.append(
            f"{policy}: prefix hits {st['prefix_hits']}, misses "
            f"{st['prefix_misses']}, affinity hit ratio {ratio:.4f}, "
            f"paths {paths} "
            f"({moved} moved), {len(exempt)} tie exemptions, TTFT p50 "
            f"{ttft.get('p50', float('nan')):.4f} s (mean "
            f"{ttft.get('mean', float('nan')):.4f}), {ntok / wall:.1f} tok/s,"
            f" launches {runs[path]}")
        router.close(close_engines=True)
    if hits["affinity"] < hits["random"]:
        raise AssertionError(f"phase 17 (b): affinity hits {hits['affinity']}"
                             f" < random's {hits['random']}")
    print(f"phase 17 (b) affinity against random on {card}: 24 requests of "
          f"6 recurring 384-token prefixes, streams held to one replica "
          f"alone ({24 * 32 / swall:.1f} tok/s); " + "; ".join(line))


def kill_part(torch, lm, card, counters, runs, waves, ref, solo):
    """Phase 17 (c): phase 7's traffic over three replicas; after the
    second wave and 2 ticks, the lease of the replica holding the most
    requests is deregistered. Its work is re-placed on the two survivors
    within the recovery budget, streams held to one replica alone,
    delivery exactly-once."""
    from adapt_tpu_torch.config import RouterConfig
    from adapt_tpu_torch.control.registry import WorkerRegistry
    from adapt_tpu_torch.runtime.router import FleetRouter

    cfg = RouterConfig()
    reg = WorkerRegistry()
    router = FleetRouter({f"r{i}": router_replica(lm) for i in range(3)},
                         registry=reg, config=cfg)
    run = FleetRun(router)
    cursor = flight_cursor()

    def go():
        t0 = time.perf_counter()
        prompts = {}
        for i, wave in enumerate(waves):
            if i:
                router.tick()
                router.tick()
            for p in wave:
                prompts[router.submit(p, 64, on_token=run.on_token)] = p
        router.tick()
        router.tick()
        victim = max(router._live(), key=lambda r: len(r.sids))
        held = len(victim.sids)
        reg.deregister(victim.lease_key, victim.lease_token)
        out = router.run()
        return prompts, out, victim.name, held, time.perf_counter() - t0

    prompts, out, victim, held, wall = counted(
        counters, "router_kill", ("paged_attn",), runs, go)
    torch.cuda.synchronize()
    leaves = flight_since(cursor, "replica_leave")
    st = router.stats()
    if (len(leaves) != 1 or leaves[0]["reason"] != "lost"
            or leaves[0]["replica"] != victim
            or leaves[0]["moved"] != router.replaced or router.replaced < 1
            or leaves[0]["wall_s"] >= cfg.recovery_budget_s
            or st["replicas_live"] != 2 or router.failed):
        raise AssertionError(f"phase 17 (c): leaves {leaves}, replaced "
                             f"{router.replaced}, {st}")
    exempt, paths, moved = hold_streams(torch, lm, "phase 17 (c)", run,
                                        prompts, out, ref, solo, 64)
    ntok = sum(len(v) for v in out.values())
    print(f"phase 17 (c) kill one of three on {card}: {victim}'s lease "
          f"deregistered holding {held} requests, {router.replaced} "
          f"re-placed in {leaves[0]['wall_s']:.6f} s (budget "
          f"{cfg.recovery_budget_s} s); paths {paths} ({moved} on another "
          f"path than alone), {len(exempt)} tie exemptions, exactly-once "
          f"delivery, 2 replicas live; {ntok} tokens in {wall:.3f} s; "
          f"launches {runs['router_kill']}")
    router.close(close_engines=True)


def short_prompts(torch, vocab, seed, n):
    """``n`` unique prompts of 16-128 tokens from ``seed``."""
    rng = torch.Generator().manual_seed(seed)
    lens = torch.randint(16, 129, (n,), generator=rng).tolist()
    return [torch.randint(0, vocab, (k,), generator=rng).numpy()
            for k in lens]


def scale_part(torch, lm, card, counters, runs, solo):
    """Phase 17 (d): the synchronous shed (one replica with a queue bound
    of 4 takes 12 submits with no tick between: 4 accepted, 8 raise
    ``QueueFullError``) and the autoscaler (three bursts of 8 on one
    replica with a queue bound of 8: a second replica on the same model
    within 3 ticks, retired within 5 s of the drain). Whole-prompt
    streams equal ``generate()``."""
    from adapt_tpu_torch.config import RouterConfig, SchedulerConfig
    from adapt_tpu_torch.runtime.router import FleetAutoscaler, FleetRouter
    from adapt_tpu_torch.runtime.scheduler import QueueFullError
    from adapt_tpu_torch.utils.metrics import global_metrics

    reg = global_metrics()
    sched = SchedulerConfig(max_queue_depth=4, preempt=False, degrade=False)
    router = FleetRouter({"r0": router_replica(lm, scheduler=sched)})
    cursor = flight_cursor()
    before = reg.snapshot(window=True)

    def shed_run():
        accepted, shed = {}, 0
        for p in short_prompts(torch, lm.vocab, 171, 12):
            try:
                accepted[router.submit(p, 16)] = p
            except QueueFullError:
                shed += 1
        return accepted, shed, router.run()

    accepted, shed, out = counted(counters, "router_shed",
                                  ("flash_attn_fwd", "paged_attn"), runs,
                                  shed_run)
    counters_now = reg.snapshot(since=before)["counters"]
    kinds = [d["kind"] for d in router.placements()["decisions"]]
    if (len(accepted) != sched.max_queue_depth or shed != 8
            or router.shed != shed or kinds.count("shed") != shed
            or counters_now.get("router.shed_total") != shed):
        raise AssertionError(f"phase 17 (d) shed: {len(accepted)} accepted, "
                             f"{shed} shed, books {router.shed} / "
                             f"{kinds.count('shed')} / "
                             f"{counters_now.get('router.shed_total')}")
    for sid, p in accepted.items():
        if not np.array_equal(out[sid], solo(p, None, "native", 16)):
            raise AssertionError(f"phase 17 (d) shed: request {sid} differs "
                                 "from generate()")
    no_leave("phase 17 (d) shed", cursor, router)
    router.close(close_engines=True)

    cfg = RouterConfig(min_replicas=1, max_replicas=2,
                       scale_up_queue_frac=0.5, autoscale_dwell_s=0.0,
                       scale_down_idle_s=0.5)
    sched = SchedulerConfig(max_queue_depth=8, preempt=False, degrade=False)
    router = FleetRouter({"r0": router_replica(lm, scheduler=sched)},
                         config=cfg)
    scaler = FleetAutoscaler(
        router, lambda i: (f"auto{i}", router_replica(lm, scheduler=sched)),
        cfg)
    cursor = flight_cursor()
    bursts = [short_prompts(torch, lm.vocab, 172 + k, 8) for k in range(3)]

    def scale_run():
        t0 = time.perf_counter()
        prompts, ticks = {}, []

        def tick():
            router.tick()
            ticks.append(scaler.scale_ups)

        def submit(burst):
            for p in burst:
                prompts[router.submit(p, 32)] = p

        submit(bursts[0])
        tick()
        submit(bursts[1])
        tick()
        if not scaler.scale_ups:
            tick()
        submit(bursts[2])  # a full queue on r0: raises without a spawn
        out = router.run()
        up_at = ticks.index(1) + 1 if 1 in ticks else None
        return prompts, out, up_at, time.perf_counter() - t0

    prompts, out, up_at, wall = counted(
        counters, "router_autoscale", ("flash_attn_fwd", "paged_attn"), runs,
        scale_run)
    torch.cuda.synchronize()
    ups = flight_since(cursor, "scale_up")
    if scaler.scale_ups != 1 or up_at is None or len(ups) != 1:
        raise AssertionError(f"phase 17 (d): scale_up {ups} after "
                             f"{up_at} ticks")
    decisions = router.placements()["decisions"]
    served = {n: sum(d["replica"] == n for d in decisions)
              for n in ("r0", ups[0]["replica"])}
    for sid, p in prompts.items():
        if not np.array_equal(out[sid], solo(p, None, "native", 32)):
            raise AssertionError(f"phase 17 (d) autoscale: request {sid} "
                                 "differs from generate()")
    t0 = time.monotonic()
    while not scaler.scale_downs and time.monotonic() - t0 < 5.0:
        time.sleep(0.05)
        router.tick()
    down_s = time.monotonic() - t0
    downs = flight_since(cursor, "scale_down")
    leaves = flight_since(cursor, "replica_leave")
    if (scaler.scale_downs != 1 or len(downs) != 1 or router.failed
            or [e["reason"] for e in leaves] != ["drain"]
            or router.stats()["replicas_live"] != 1):
        raise AssertionError(f"phase 17 (d): scale_down {downs}, leaves "
                             f"{leaves} {down_s:.2f} s after the drain")
    ntok = sum(len(v) for v in out.values())
    print(f"phase 17 (d) on {card}: shed {shed} of 12 at a queue bound of 4 "
          f"(accepted streams equal generate()); autoscaler: scale_up "
          f"({ups[0]['replica']}, queue frac {ups[0]['queue_frac']}) at tick "
          f"{up_at}, placements {served}, 24 streams equal generate(), "
          f"{ntok} tokens in {wall:.3f} s; scale_down of "
          f"{downs[0]['replica']} {down_s:.2f} s after the drain; launches "
          f"{runs['router_shed']} / {runs['router_autoscale']}")
    router.close(close_engines=True)


def prefill_tier_part(torch, lm, card, counters, runs, waves, colo, solo,
                      int8_bar):
    """Phase 17 (e): two replicas behind a ``FleetRouter`` with a
    ``PrefillWorker`` tier (2 slots, prefill_chunk 256) on phase 7's
    traffic, native and on int8 pools: one ``kv_handoff`` (one tile,
    adopted) for each prompt of 600+ tokens, K4 (K4q) launched in the tier,
    ``disagg.pages_streamed`` above 0, streams held to the same replicas
    served collocated (``colo``: (a)'s run for native; an int8 run here).
    Then a page-size and a KV-dtype mismatch raise ``ValueError`` at
    ``add_replica``."""
    from adapt_tpu_torch.config import DisaggConfig
    from adapt_tpu_torch.runtime.disagg import PrefillWorker
    from adapt_tpu_torch.runtime.router import FleetRouter
    from adapt_tpu_torch.utils.metrics import global_metrics

    reg = global_metrics()
    for kv in ("native", "int8"):
        bar = 0.1 if kv == "native" else int8_bar
        if kv != "native":
            router = FleetRouter({"r0": router_replica(lm, kv),
                                  "r1": router_replica(lm, kv)})
            run = FleetRun(router)
            prompts, out, _ = counted(
                counters, f"router_collocated_{kv}", ("paged_attn",), runs,
                lambda: serve_waves(router, waves, 64, run.on_token))
            colo = run.reference(prompts, out)
            router.close(close_engines=True)
        worker = PrefillWorker(lm, page_size=128, slots=2, prefill_chunk=256,
                               kv_cache_dtype=kv)
        k4 = tier_k4(worker)
        router = FleetRouter(
            {"r0": router_replica(lm, kv), "r1": router_replica(lm, kv)},
            prefill=worker, disagg=DisaggConfig(prompt_threshold=600,
                                                busy_prompt_threshold=600))
        run = FleetRun(router)
        cursor = flight_cursor()
        before = reg.snapshot(window=True)
        path = f"router_prefill_{kv}"
        prompts, out, wall = counted(
            counters, path, ("paged_chunk_attn", "paged_attn"), runs,
            lambda: serve_waves(router, waves, 64, run.on_token))
        torch.cuda.synchronize()
        win = reg.snapshot(since=before)
        streamed = win["counters"].get("disagg.pages_streamed", 0.0)
        handoffs = flight_since(cursor, "kv_handoff")
        nlong = sum(1 for p in prompts.values() if len(p) >= 600)
        if (len(handoffs) != nlong or k4[0] == 0 or streamed <= 0
                or any(h["tiles"] != 1 or not h["adopted"] for h in handoffs)):
            raise AssertionError(f"phase 17 (e) {kv}: handoffs {handoffs} "
                                 f"for {nlong} long prompts, K4 in the tier "
                                 f"{k4[0]}, pages streamed {streamed}")
        no_leave(f"phase 17 (e) {kv}", cursor, router)
        st = router.stats()
        if st["pages_in_use"] != 0 or worker.stats()["pages_in_use"] != 0:
            raise AssertionError(f"phase 17 (e) {kv}: pools not drained {st}")
        exempt, paths, moved = hold_streams(
            torch, lm, f"phase 17 (e) {kv}", run, prompts, out, colo, solo,
            64, kv, bar)
        ntok = sum(len(v) for v in out.values())
        print(f"phase 17 (e) FleetRouter[2 replicas + prefill tier, {kv}] on "
              f"{card}: {len(handoffs)} handoffs to "
              f"{sorted({h['replica'] for h in handoffs})} "
              f"({win['counters'].get('disagg.handoff_bytes', 0.0):.0f} wire "
              f"bytes, {streamed:.0f} pages, 1 tile each, all adopted), K4 "
              f"{k4[0]} in the tier and "
              f"{runs[path]['paged_chunk_attn'] - k4[0]} in decode; streams held to the fleet collocated (paths "
              f"{paths}, {moved} moved, {len(exempt)} tie exemptions at bar "
              f"{bar:.4f}); {ntok} tokens in {wall:.3f} s = {ntok / wall:.1f} "
              f"tok/s; launches {runs[path]}")
        rep = router._replicas["r0"].engine  # the int8 run's
        router.close(close_engines=True)
    for what, tier in (
        ("page size", PrefillWorker(lm, page_size=64, slots=1,
                                    kv_cache_dtype="int8")),
        ("kv dtype", PrefillWorker(lm, page_size=128, slots=1)),
    ):
        try:
            FleetRouter({"r0": rep}, prefill=tier)
        except ValueError as e:
            print(f"phase 17 (e): a {what} mismatch refused at add_replica: "
                  f"{e}")
            continue
        raise AssertionError(f"phase 17 (e): a {what} mismatch was accepted")


def router_phase(torch, A, D, P, lm, card, kernels, solo, waves, int8_bar):
    """Phase 17: the fleet router over replicas sharing the card: (a)
    placement, (b) affinity against random, (c) a lost lease, (d) shed and
    autoscale, (e) the prefill tier across replicas. Adds
    ``router_launches`` (phase 17's launches of each kernel, its runs
    summed) to every row of ``kernels``."""
    t_phase = time.perf_counter()
    counters = {"flash_attn_fwd": A.flash_attn_fwd,
                "decode_attn": D.decode_attn, "paged_attn": P.paged_attn,
                "paged_chunk_attn": P.paged_chunk_attn,
                "paged_verify_attn": P.paged_verify_attn}
    runs: dict = {}
    marks = [time.perf_counter()]
    solo_ref, colo = placement_part(torch, lm, card, counters, runs, waves,
                                    solo)
    marks.append(time.perf_counter())
    affinity_part(torch, lm, card, counters, runs, solo)
    marks.append(time.perf_counter())
    kill_part(torch, lm, card, counters, runs, waves, solo_ref, solo)
    marks.append(time.perf_counter())
    scale_part(torch, lm, card, counters, runs, solo)
    marks.append(time.perf_counter())
    prefill_tier_part(torch, lm, card, counters, runs, waves, colo, solo,
                      int8_bar)
    marks.append(time.perf_counter())
    totals: dict = {}
    for path, launches in runs.items():
        rows = FLEET_ROWS["int8" if path.endswith("int8") else "native"]
        for k, n in launches.items():
            if k in rows:
                totals[rows[k]] = totals.get(rows[k], 0) + n
    for kr in kernels:
        kr["router_launches"] = totals.get(kr["name"], 0)
    print(f"phase 17 launches by path: {json.dumps(runs)}")
    took = ", ".join(f"({part}) {b - a:.1f}"
                     for part, a, b in zip("abcde", marks, marks[1:]))
    print(f"phase 17 (fleet router and autoscaler) took "
          f"{time.perf_counter() - t_phase:.1f} s on {card} ({took})")


# -- phase 18: tensor-parallel shards on one card ------------------------------

#: Phase 18's kernel rows by path kind: int8 paths count into the int8
#: rows, except the speculative path's draft, whose strips are native.
TP_ROWS = {
    "native": dict(FLEET_ROWS["native"]),
    "int8": dict(FLEET_ROWS["int8"],
                 paged_verify_attn="paged_verify_attn[int8]"),
}
TP_ROWS["spec_int8"] = dict(TP_ROWS["int8"], decode_attn="decode_attn")


def tp_paged_waves(waves):
    """Phase 18's paged traffic, cut from phase 7's: wave 1 the first
    shared-prefix prompt, the shortest unique one (a whole-prompt
    admission) and the first long one (chunked at 256), wave 2 three more
    shared-prefix prompts (prefix hits)."""
    return ([waves[0][0], min(waves[0][1:5], key=len), waves[0][5]],
            list(waves[1][:3]))


def f32_copy(torch, lm):
    """``lm``'s weights held in f32 at the same widths: the reference whose
    distance from ``lm`` (bf16, one shard) sets phase 18's bars, so that
    no limit comes from the tp code under test."""
    from adapt_tpu_torch.models.transformer_lm import TransformerLM

    b = lm.blocks[0]
    ref = TransformerLM(lm.vocab, b.dim, lm.depth, b.heads, b.mlp_dim,
                        lm.max_len, torch.float32, f"{lm.name}_f32",
                        b.kv_heads, device=lm.device)
    ref.load_state_dict(lm.state_dict())
    return ref.eval()


def tp_precision(torch, lm, lm32, slms, prompts, label="phase 18"):
    """Phase 18's precision gate: over ``prompts``' full forwards, e1 is
    the largest |logit| difference of ``lm`` (bf16, one shard) from its f32
    copy ``lm32`` and e_tp that of each tp model in ``slms``; each e_tp
    must be at most 2 x e1 (the tp forward as close to the f32 model as
    the unsharded bf16 one, give or take rounding order). Prints the f32
    logits' mean spread (best minus mean logit a position: what a token
    picked at random lies below the best). Returns e1."""
    from adapt_tpu_torch.models.transformer_lm import logits_full

    e1, etp, spread = 0.0, dict.fromkeys(slms, 0.0), []
    for p in prompts:
        want = logits_full(lm32, p[None])[0]
        e1 = max(e1, float((logits_full(lm, p[None])[0] - want).abs().max()))
        for tp, slm in slms.items():
            etp[tp] = max(etp[tp], float(
                (logits_full(slm, p[None])[0] - want).abs().max()))
        spread.append(float((want.max(-1).values - want.mean(-1)).mean()))
    print(f"{label} precision: largest logit difference from the f32 copy "
          f"over {len(prompts)} prompts: tp=1 (bf16) e1 {e1:.4f}, "
          + ", ".join(f"tp={tp} {e:.4f}" for tp, e in etp.items())
          + f" (limit 2 x e1 = {2 * e1:.4f}); f32 logits' mean spread "
          f"{np.mean(spread):.4f}")
    bad = {tp: e for tp, e in etp.items() if e > 2 * e1}
    if bad:
        raise AssertionError(f"{label} precision: tp logits {bad} further "
                             f"than 2 x e1 = {2 * e1:.4f} from the f32 copy")
    return e1


def deficits(torch, lm32, prompt, toks):
    """Teacher-forced along a stream: how far each token of ``toks`` lies
    below the f32 copy's best logit at its position, given the stream's
    own history (one full forward over ``prompt`` + ``toks``)."""
    from adapt_tpu_torch.models.transformer_lm import logits_full

    if len(toks) == 0:
        return np.zeros(0)
    seq = np.concatenate([prompt, toks[:-1]]).astype(np.int64)
    lg = logits_full(lm32, seq[None])[0, len(prompt) - 1:]
    pick = torch.as_tensor(np.asarray(toks, np.int64), device=lg.device)
    return (lg.max(-1).values - lg.gather(1, pick[:, None])[:, 0]
            ).cpu().numpy()


def hold_to_tp1(torch, lm32, label, prompts, out, ref, cancelled, steps,
                bar, known=None):
    """Phase 18's stream rule, its bar set without the tp code: every
    stream has its length (the cancelled request cut short alike in both
    runs) and every token of it lies within ``bar`` of the f32 copy's
    best logit given the stream's own history (:func:`deficits`). A tp
    stream may leave tp=1's (``ref``; ``out is ref`` for tp=1's own run,
    the control): random weights put top-2 gaps of 0.0004-0.03 at many
    steps and a tp step sums its partials in another order, so both
    tokens where it leaves must pass the same bar. ``known``: tp=1's
    deficits by request, reused for a stream equal to tp=1's. Returns the
    requests that left tp=1's stream, the largest and mean deficit, and
    the deficits by request."""
    left, worst, every, by_rid = [], 0.0, [], {}
    for rid, p in prompts.items():
        got, want = out[rid], ref[rid]
        if rid == cancelled:
            if not 0 < len(got) < steps or len(got) != len(want):
                raise AssertionError(f"{label}: cancelled request {rid} has "
                                     f"{len(got)} tokens (tp=1 {len(want)})")
        elif len(got) != steps:
            raise AssertionError(f"{label}: request {rid} has {len(got)} "
                                 f"tokens")
        same = np.array_equal(got, want)
        d = (known[rid] if known is not None and same
             else deficits(torch, lm32, p, got))
        by_rid[rid] = d
        every.extend(d.tolist())
        if len(d) and d.max() > bar:
            t = int(d.argmax())
            raise AssertionError(
                f"{label}: request {rid} (prompt {len(p)}) token {t} lies "
                f"{d[t]:.4f} below the f32 copy's best logit (bar {bar:.4f})")
        worst = max(worst, float(d.max()) if len(d) else 0.0)
        diff = np.nonzero(got != want[:len(got)])[0]
        if not same and len(diff):
            t = int(diff[0])
            d1 = deficits(torch, lm32, p, want[:t + 1])[t]
            print(f"{label}: request {rid} (prompt {len(p)}) leaves tp=1's "
                  f"stream at token {t}, {d[t]:.4f} below the f32 best there "
                  f"(tp=1's token {d1:.4f})")
            left.append(rid)
    return left, worst, float(np.mean(every)) if every else 0.0, by_rid


def tp_check_run(label, tp, runs, path, ref_path, st, ref_st,
                 draft=False):
    """tp x the tp=1 run's launches of every kernel (with a replicated
    ``draft``: of the target's K3 / K4 / K5, the draft's K2 launches once,
    and K1 serves both), and each shard holding the logical KV bytes / tp
    (the logical bytes equal to tp=1's)."""
    got, want = runs[path], runs[ref_path]
    scaled = (("paged_attn", "paged_chunk_attn", "paged_verify_attn")
              if draft else tuple(want))
    if (any(got[k] != tp * want[k] for k in scaled)
            or draft and got["decode_attn"] != want["decode_attn"]):
        raise AssertionError(f"{label}: launches {got}, not {tp} x tp=1's "
                             f"{want}")
    if (st["tp"] != tp or st["cache_bytes"] != ref_st["cache_bytes"]
            or st["cache_bytes_per_device"] * tp != st["cache_bytes"]):
        raise AssertionError(f"{label}: tp {st['tp']}, cache bytes "
                             f"{st['cache_bytes']} (tp=1 "
                             f"{ref_st['cache_bytes']}), per shard "
                             f"{st['cache_bytes_per_device']}")


def tp_serving_part(torch, lm, lm32, slms, card, counters, runs, dprompts,
                    pwaves, rates, bar):
    """Phase 18 (a): phase 6's first 8 prompts (32 tokens, dense strips)
    and :func:`tp_paged_waves` (64 tokens, paged, prefix hits and a
    chunked prompt), each with a mid-flight cancel, served at tp=1, 2 and 4
    (shards of ``lm`` on the one card): streams, tp=1's included, held by
    :func:`hold_to_tp1` at ``bar``, every kernel's launches tp x tp=1's,
    per-shard cache bytes x tp the logical bytes."""
    from adapt_tpu_torch.config import KernelConfig

    for layout in ("slots", "paged"):
        want = (("flash_attn_fwd", "decode_attn") if layout == "slots" else
                ("flash_attn_fwd", "paged_attn", "paged_chunk_attn"))
        ref = None
        for tp in (1, 2, 4):
            model = lm if tp == 1 else slms[tp]
            path = f"tp{tp}_{layout}"
            if layout == "slots":
                out, ids, cancelled, wall, ntok, _, st = counted(
                    counters, path, want, runs,
                    lambda: drive_batcher(torch, model, dprompts, 32,
                                          KernelConfig(), 1))
                prompts, steps = dict(zip(ids, dprompts)), 32
            else:
                bat, prompts, out, _, cancelled, _, wall, ntok, _ = counted(
                    counters, path, want, runs,
                    lambda: drive_paged(torch, model, KernelConfig(), pwaves,
                                        None, 1))
                st, steps = bat.stats(), 64
                bat.close()
            rates[layout, tp] = ntok / wall
            label = f"phase 18 (a) {layout} tp={tp}"
            if tp == 1:
                ref = (out, st, None)
            else:
                tp_check_run(label, tp, runs, path, f"tp1_{layout}", st,
                             ref[1])
            left, worst, mean, known = hold_to_tp1(
                torch, lm32, label, prompts, out, ref[0], cancelled, steps,
                bar, ref[2])
            if tp == 1:
                ref = (out, st, known)
            print(f"{label} on {card}: {len(prompts)} requests (1 cancelled"
                  f"), {len(left)} leaving tp=1's stream; token deficits "
                  f"from the f32 copy max {worst:.4f} mean {mean:.5f} (bar "
                  f"{bar:.4f}), "
                  f"{ntok} tokens in {wall:.3f} s = {ntok / wall:.1f} tok/s, "
                  f"cache bytes {st['cache_bytes']} "
                  f"({st['cache_bytes_per_device']} a shard), launches "
                  f"{runs[path]}")


def tp_int8_part(torch, lm, lm32, slm2, draft, card, counters, runs, pwaves,
                 dprompts, bar):
    """Phase 18 (b): at tp=1 and tp=2, :func:`tp_paged_waves` over an int8
    pool (K3q, K4q), then speculative decoding with the 2-layer draft
    replicated (one copy, on the lead device) over an int8 pool (K5q, K4q;
    four of phase 6's prompts a wave, 32 tokens, draft_k 4), each steady
    tick 0 host->device copies and 1 fetch: streams, tp=1's included,
    held by :func:`hold_to_tp1` at ``bar`` (the native bar plus phase 9's
    int8 bar), launches 2 x tp=1's."""
    from adapt_tpu_torch.config import KernelConfig, SpeculativeConfig

    spec = SpeculativeConfig(draft_k=4)
    swaves = (dprompts[:4], dprompts[4:8])
    for kind in ("paged_int8", "spec_int8"):
        want = (("paged_attn", "paged_chunk_attn") if kind == "paged_int8"
                else ("paged_verify_attn", "paged_chunk_attn"))
        ref = None
        for tp in (1, 2):
            model = lm if tp == 1 else slm2
            path = f"tp{tp}_{kind}"
            steady = None
            if kind == "paged_int8":
                bat, prompts, out, _, cancelled, _, wall, ntok, _ = counted(
                    counters, path, want, runs,
                    lambda: drive_paged(torch, model, KernelConfig(), pwaves,
                                        None, 1, kv_cache_dtype="int8"))
                steps = 64
            else:
                bat, prompts, out, cancelled, _, wall, ntok, steady = counted(
                    counters, path, want, runs,
                    lambda: drive_spec(torch, model, draft, spec,
                                       KernelConfig(), "paged", "int8",
                                       swaves, 32, 1, prefill_chunk=256))
                steps = 32
                if steady != (0, 1):
                    raise AssertionError(f"phase 18 (b) {kind} tp={tp}: a "
                                         f"steady tick made {steady}")
            st = bat.stats()
            bat.close()
            label = f"phase 18 (b) {kind} tp={tp}"
            if tp == 1:
                ref = (out, st, None)
            else:
                tp_check_run(label, tp, runs, path, f"tp1_{kind}", st, ref[1],
                             draft=kind == "spec_int8")
            left, worst, mean, known = hold_to_tp1(
                torch, lm32, label, prompts, out, ref[0], cancelled, steps,
                bar, ref[2])
            if tp == 1:
                ref = (out, st, known)
            note = (f", acceptance {st['spec_acceptance']:.4f}, steady tick "
                    f"{steady[0]} host->device copies, {steady[1]} fetch"
                    if steady else "")
            print(f"{label} on {card}: {len(prompts)} requests (1 cancelled"
                  f"), {len(left)} leaving tp=1's stream; token deficits max "
                  f"{worst:.4f} mean {mean:.5f} (bar {bar:.4f}){note}, "
                  f"{ntok} tokens in {wall:.3f} s = "
                  f"{ntok / wall:.1f} tok/s, launches {runs[path]}")


def tp_fleet_part(torch, lm, slm2, card, counters, runs, pwaves, solo):
    """Phase 18 (d): at tp=2, (1) :func:`tp_paged_waves` served twice by a
    paged batcher with a lossless host tier, every cached page evicted
    (spilled) between the rounds: the second round readmits and its streams
    equal an untiered batcher's second round (prefix hits); (2) a
    ``FleetRouter`` with a tp=2 replica and a prefill tier (threshold 600):
    each long prompt's handoff framed as 2 head tiles a leaf and adopted,
    streams held to the same replica served collocated (phase 17's
    rule)."""
    from adapt_tpu_torch.config import CacheTierConfig, DisaggConfig
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
    from adapt_tpu_torch.runtime.disagg import PrefillWorker
    from adapt_tpu_torch.runtime.router import FleetRouter

    want = ("flash_attn_fwd", "paged_attn", "paged_chunk_attn")

    def two_rounds(tier):
        bat = ContinuousBatcher(slm2, slots=8, chunk=8, kv_layout="paged",
                                page_size=128, prefill_chunk=256,
                                cache_tier=tier)
        serve_waves(bat, pwaves)
        if tier is not None:
            bat._pager.evict_cached()
        prompts, out, wall = serve_waves(bat, pwaves)
        return bat, prompts, out, wall

    ref, rprompts, rout, _ = counted(counters, "tp2_tier_reference", want,
                                     runs, lambda: two_rounds(None))
    ref.close()
    tier = CacheTierConfig(warm_codec="lz", spill_pages_per_tick=512,
                           readmit_pages_per_tick=512)
    bat, prompts, out, wall = counted(counters, "tp2_tier", want, runs,
                                      lambda: two_rounds(tier))
    st = bat.stats()
    bat.close()
    if st["tier_spilled"] < 1 or st["tier_readmitted"] < 1:
        raise AssertionError(f"phase 18 (d) tier: spilled "
                             f"{st['tier_spilled']}, readmitted "
                             f"{st['tier_readmitted']}")
    for (r, p), (rr, rp) in zip(prompts.items(), rprompts.items()):
        if not np.array_equal(p, rp) or not np.array_equal(out[r], rout[rr]):
            raise AssertionError(f"phase 18 (d) tier: request {r} (prompt "
                                 f"{len(p)}) differs from the untiered run")
    print(f"phase 18 (d) host KV tier at tp=2 on {card}: {len(prompts)} "
          f"readmitting requests equal the untiered run's; spilled "
          f"{st['tier_spilled']}, readmitted {st['tier_readmitted']} pages "
          f"(each spill assembled from 2 shards' heads, each readmit landed "
          f"per shard); launches {runs['tp2_tier']}")

    router = FleetRouter({"r0": router_replica(slm2)})
    run = FleetRun(router)
    prompts, out, _ = counted(
        counters, "tp2_router_collocated", ("paged_attn",), runs,
        lambda: serve_waves(router, pwaves, 64, run.on_token))
    colo = run.reference(prompts, out)
    router.close(close_engines=True)
    worker = PrefillWorker(lm, page_size=128, slots=2, prefill_chunk=256,
                           device=lm.device)
    router = FleetRouter({"r0": router_replica(slm2)}, prefill=worker,
                         disagg=DisaggConfig(prompt_threshold=600,
                                             busy_prompt_threshold=600))
    run = FleetRun(router)
    cursor = flight_cursor()
    prompts, out, wall = counted(
        counters, "tp2_router_prefill", ("paged_attn",), runs,
        lambda: serve_waves(router, pwaves, 64, run.on_token))
    handoffs = flight_since(cursor, "kv_handoff")
    nlong = sum(1 for p in prompts.values() if len(p) >= 600)
    if (nlong < 1 or len(handoffs) != nlong
            or any(h["tiles"] != 2 or not h["adopted"] for h in handoffs)):
        raise AssertionError(f"phase 18 (d) router: handoffs {handoffs} for "
                             f"{nlong} long prompts")
    no_leave("phase 18 (d) router", cursor, router)
    exempt, paths, moved = hold_streams(torch, lm, "phase 18 (d) router",
                                        run, prompts, out, colo, solo, 64)
    router.close(close_engines=True)
    print(f"phase 18 (d) FleetRouter[tp=2 replica + prefill tier] on {card}:"
          f" {len(handoffs)} handoffs, each leaf framed as 2 head tiles and "
          f"adopted per shard; streams held to the replica collocated (paths "
          f"{paths}, {moved} moved, {len(exempt)} tie exemptions); launches "
          f"{runs['tp2_router_prefill']}")


def check_shard_kernels(torch, A, D, P, Q, dev, errs):
    """Phase 18 (e): K1, K2, K3, K4 and K5 (K2-K5 native and int8) against
    their plain versions at the head counts of GPT-2-small's tp=2 and tp=4
    shards (kv_h 6 and 3, g 1, head_dim 64, bf16) and phase 18 (a)'s
    shapes: K1 at a 512-token prompt, K2 / K3 at 8 rows of 1025 keys / 8
    pages of 128, K4 at a 256-token chunk after 512, K5 at 5 verify rows;
    atol = rtol = 1e-2, K3 == K2 and K4's rows == K1's bit for bit.
    ``errs`` collects the largest error by kernel row name."""
    for kvh in (6, 3):
        g = torch.Generator(device=dev).manual_seed(80 + kvh)

        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(
                torch.bfloat16)

        q, k, v = rnd(1, kvh, 512, 64), rnd(1, kvh, 512, 64), rnd(
            1, kvh, 512, 64)
        out, _ = A.flash_attn_fwd(q, k, v, True)
        torch.cuda.synchronize()
        ref, _ = A._reference_with_lse(q, k, v, True)
        e = close(out, ref, 1e-2, 1e-2, f"K1 at kv_h {kvh}")
        errs["flash_attn_fwd"] = max(errs.get("flash_attn_fwd", 0.0), e)
        for kv in ("native", "int8"):
            tag = "" if kv == "native" else f"[{kv}]"

            def cache(t):
                return t if kv == "native" else quantized(Q, t, kv)

            qd, kp, vp, table, idx = paged_inputs(torch, dev, 8, kvh, 1, 64,
                                                  128, 8, 65, seed=90 + kvh)
            kp, vp = cache(kp), cache(vp)
            strip = (lambda pool: tuple(as_strip(torch, m, table, 1025)
                                        for m in pool)) if kv != "native" \
                else (lambda pool: as_strip(torch, pool, table, 1025))
            ck, cv = strip(kp), strip(vp)
            k2 = D.decode_attn(qd, ck, cv, idx)
            k3 = P.paged_attn(qd, kp, vp, table, idx)
            torch.cuda.synchronize()
            for name, got, plain in (
                ("decode_attn", k2, D.decode_attention_plain(qd, ck, cv,
                                                             idx)),
                ("paged_attn", k3, P.paged_attention_plain(qd, kp, vp, table,
                                                           idx)),
            ):
                e = close(got, plain, 1e-2, 1e-2, f"{name}{tag} kv_h {kvh}")
                errs[name + tag] = max(errs.get(name + tag, 0.0), e)
            if not torch.equal(k3, k2):
                raise AssertionError(f"K3{tag} != K2{tag} at kv_h {kvh}")
            qc, kc, vc, pages = chunk_inputs(torch, dev, kvh, 1, 64, 256, 512)
            kc, vc = cache(kc), cache(vc)
            k4 = P.paged_chunk_attn(qc, kc, vc, pages, 512, 256)
            torch.cuda.synchronize()
            e = close(k4, P.paged_chunk_attention_reference(
                qc, kc, vc, pages, 512, 256), 1e-2, 1e-2,
                f"paged_chunk_attn{tag} kv_h {kvh}")
            errs["paged_chunk_attn" + tag] = max(
                errs.get("paged_chunk_attn" + tag, 0.0), e)
            if kv == "native":
                q_all = torch.zeros(1, kvh, 768, 64, device=dev,
                                    dtype=qc.dtype)
                q_all[:, :, 512:] = qc

                def whole(pool):
                    return pool[pages.long()].movedim(1, 0).reshape(
                        1, kvh, -1, 64)[:, :, :768].contiguous()

                k1, _ = A.flash_attn_fwd(q_all, whole(kc), whole(vc), True)
                torch.cuda.synchronize()
                if not torch.equal(k4, k1[:, :, 512:]):
                    raise AssertionError(f"K4 rows != K1 rows at kv_h {kvh}")
            qv, kv5, vv5, tv, iv = verify_inputs(torch, dev, 8, kvh, 1, 5, 64,
                                                 128, 8, 65, seed=95 + kvh)
            kv5, vv5 = cache(kv5), cache(vv5)
            k5 = P.paged_verify_attn(qv, kv5, vv5, tv, iv, 5)
            torch.cuda.synchronize()
            e = close(k5, P.paged_verify_attention_plain(qv, kv5, vv5, tv, iv,
                                                         5), 1e-2, 1e-2,
                      f"paged_verify_attn{tag} kv_h {kvh}")
            errs["paged_verify_attn" + tag] = max(
                errs.get("paged_verify_attn" + tag, 0.0), e)
        print(f"phase 18 (e) kernels at kv_h {kvh} (g 1, hd 64, bf16): K1, "
              f"K2, K3, K4, K5 native and K2q-K5q int8 within 1e-2 + "
              f"1e-2|ref| of their plain versions; K3 == K2 and K4's rows "
              f"== K1's bit for bit")


def tp_phase(torch, A, D, P, Q, lm, draft, card, kernels, solo, dprompts,
             waves, int8_bar):
    """Phase 18: tensor-parallel serving as tp shards of GPT-2-small on the
    one card (meshes of 2 and 4 shards naming cuda:0): the precision gate
    against an f32 copy (:func:`tp_precision`), whose e1 sets the streams'
    bar (2 x e1, :func:`hold_to_tp1`); (a) streams and
    launches at tp=1 / 2 / 4 on both layouts, (b) an int8 pool and int8
    speculation at tp=2, (c) a steady tp=2 tick, (d) the host tier and the
    router's prefill tier at tp=2, (e) the kernels at the shards' head
    counts. Adds ``tp_launches`` (phase 18's launches of each kernel, its
    runs summed) and ``tp_shard_max_abs_err`` ((e)'s) to every row of
    ``kernels``. Returns the f32 copy, the streams' bar (2 x e1) and the
    sharded models by tp, which phase 19 reuses."""
    from adapt_tpu_torch.core.mesh import MeshSpec, build_mesh
    from adapt_tpu_torch.models.transformer_lm import shard_lm

    t_phase = time.perf_counter()
    counters = {"flash_attn_fwd": A.flash_attn_fwd,
                "decode_attn": D.decode_attn, "paged_attn": P.paged_attn,
                "paged_chunk_attn": P.paged_chunk_attn,
                "paged_verify_attn": P.paged_verify_attn}
    runs: dict = {}
    marks = [time.perf_counter()]
    slms = {tp: shard_lm(lm, build_mesh(MeshSpec((("tp", tp),)),
                                        [lm.device] * tp))
            for tp in (2, 4)}
    pwaves = tp_paged_waves(waves)
    lm32 = f32_copy(torch, lm)
    bar = 2 * tp_precision(torch, lm, lm32, slms, [pwaves[0][0],
                                                    dprompts[0]])
    rates: dict = {}
    tp_serving_part(torch, lm, lm32, slms, card, counters, runs,
                    dprompts[:8], pwaves, rates, bar)
    marks.append(time.perf_counter())
    tp_int8_part(torch, lm, lm32, slms[2], draft, card, counters, runs,
                 pwaves, dprompts, bar + int8_bar)
    marks.append(time.perf_counter())
    for layout in ("slots", "paged"):
        steady_sync_check(torch, slms[2], card, layout, "phase 18 (c) tp=2")
    marks.append(time.perf_counter())
    tp_fleet_part(torch, lm, slms[2], card, counters, runs, pwaves, solo)
    marks.append(time.perf_counter())
    serr: dict = {}
    check_shard_kernels(torch, A, D, P, Q, lm.device, serr)
    marks.append(time.perf_counter())
    totals: dict = {}
    for path, launches in runs.items():
        rows = TP_ROWS["spec_int8" if path.endswith("spec_int8") else
                       "int8" if path.endswith("int8") else "native"]
        for k, n in launches.items():
            if k in rows:
                totals[rows[k]] = totals.get(rows[k], 0) + n
    for kr in kernels:
        kr["tp_launches"] = totals.get(kr["name"], 0)
        kr["tp_shard_max_abs_err"] = serr.get(kr["name"])
    print(f"phase 18 launches by path: {json.dumps(runs)}")
    print("phase 18 tok/s (tp shards of ONE card, not a multi-GPU figure) on "
          f"{card}: " + "; ".join(
              f"{layout} " + ", ".join(f"tp={tp} {rates[layout, tp]:.1f}"
                                       for tp in (1, 2, 4))
              for layout in ("slots", "paged")))
    took = ", ".join(f"({part}) {b - a:.1f}"
                     for part, a, b in zip("abcde", marks, marks[1:]))
    print(f"phase 18 (tensor-parallel shards) took "
          f"{time.perf_counter() - t_phase:.1f} s on {card} ({took})")
    return lm32, bar, slms


# -- phase 19: elastic recovery of the tensor-parallel batcher ----------------


def rec_snapshot(bat):
    """Per-shard clones of every block's K and V (both members of a
    quantized pair): the live state a recovery must migrate."""
    return [[[tuple(m.clone() for m in piece) if isinstance(piece, tuple)
              else piece.clone() for piece in c] for c in pair]
            for pair in bat._caches]


def rec_check_concat(torch, label, bat, snap, new_tp):
    """Each new shard's K and V (both members of a pair) ``torch.equal``
    to the ordered concatenation of the snapshot's head ranges; a tp=1
    remnant's plain cache to all of them."""
    for b, (pair, spair) in enumerate(zip(bat._caches, snap)):
        for c, sc in zip(pair, spair):
            new = [c] if new_tp == 1 else list(c)
            if len(new) != new_tp:
                raise AssertionError(f"{label}: block {b} holds {len(new)} "
                                     f"shards, not {new_tp}")
            r = len(sc) // new_tp
            for j, got in enumerate(new):
                olds = sc[j * r:(j + 1) * r]
                pair_of = isinstance(olds[0], tuple)
                want = (tuple(torch.cat([o[m] for o in olds], 1)
                              for m in range(len(olds[0]))) if pair_of
                        else (torch.cat(olds, 1),))
                if not all(torch.equal(g, w) for g, w in zip(
                        got if pair_of else (got,), want)):
                    raise AssertionError(
                        f"{label}: block {b} shard {j}'s KV is not the "
                        "ordered concatenation of the old shards' heads")


class RecRun:
    """One phase 19 run's books: the tokens ``on_token`` delivered (index
    by index, exactly-once checked), the delivered counts at the kill, the
    decode rates before the kill and after the recovery, the recovery's
    summary and wall."""

    def __init__(self):
        self.delivered: dict = {}
        self.at_kill: dict = {}
        self.summary: dict = {}
        self.rates = (0.0, 0.0)
        self.t0 = time.perf_counter()

    def on_token(self, rid, tok, idx):
        self.delivered.setdefault(rid, []).append((idx, int(tok)))

    def ntok(self):
        return sum(len(v) for v in self.delivered.values())

    def stream(self, rid, label):
        got = self.delivered.get(rid, [])
        if [i for i, _ in got] != list(range(len(got))):
            raise AssertionError(f"{label}: request {rid}'s on_token indices "
                                 f"are not each index once")
        return np.asarray([t for _, t in got], np.int64)


def rec_stagger(bat, prompts, steps, run):
    """Half the prompts, two ticks, the rest; tick until every request is
    admitted and none is mid-prefill, then one more tick; every slot must
    then be decoding. Returns the ids."""
    half = len(prompts) // 2
    ids = [bat.submit(p, steps, on_token=run.on_token) for p in prompts[:half]]
    bat.tick()
    bat.tick()
    ids += [bat.submit(p, steps, on_token=run.on_token)
            for p in prompts[half:]]
    while len(bat._queue) or any(s.req is not None and s.pf_done >= 0
                                 for s in bat.slots):
        bat.tick()
    bat.tick()
    live = sum(1 for s in bat.slots if s.req is not None and s.pf_done < 0)
    if live != len(bat.slots):
        raise AssertionError(f"{live} of {len(bat.slots)} slots decoding at "
                             "the kill")
    return ids


def rec_kill(torch, bat, mon, kill, run, auto):
    """Kill members ``kill``: with ``auto`` off the next tick must raise
    ``DeviceLostError`` and ``recover()`` is called by hand."""
    from adapt_tpu_torch.runtime.continuous import DeviceLostError

    torch.cuda.synchronize()
    wall = time.perf_counter() - run.t0
    run.rates = (run.ntok() / wall, 0.0)
    run.at_kill = {r: len(v) for r, v in run.delivered.items()}
    members = bat._mesh.members()
    for k in kill:
        mon.kill(members[k])
    if auto:
        return
    try:
        bat.tick()
    except DeviceLostError:
        pass
    else:
        raise AssertionError("a tick after the kill did not raise "
                             "DeviceLostError (auto_reshard off)")
    run.summary = bat.recover()
    torch.cuda.synchronize()


def rec_finish(torch, bat, run, inside=False):
    """Run to drain and record the decode rate after the recovery (less the
    recovery's wall when it runs ``inside`` the drain's first tick)."""
    t1, n1 = time.perf_counter(), run.ntok()
    out = bat.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1 - (run.summary.get("wall_s", 0.0)
                                       if inside else 0.0)
    run.rates = (run.rates[0], (run.ntok() - n1) / wall)
    return out


def rec_steady(torch, label, bat, counter, want):
    """One tick after the recovery's table upload: 0 host->device copies,
    1 fetch, and ``want`` launches of the decode kernel (a tp=2 step's:
    one a shard, block and step)."""
    bat.tick()  # the first paged tick after a recovery re-uploads the table
    before, n0 = bat.stats(), counter.launches
    if bat.tick() < 1:
        raise AssertionError(f"{label}: the steady tick decoded no slot")
    after, n = bat.stats(), counter.launches - n0
    steady = (after["h2d_transfers"] - before["h2d_transfers"],
              after["d2h_fetches"] - before["d2h_fetches"])
    if steady != (0, 1) or n != want:
        raise AssertionError(f"{label}: a steady tick after the recovery "
                             f"made {steady[0]} host->device copies, "
                             f"{steady[1]} fetches and {n} launches (want 0, "
                             f"1 and {want})")
    return steady, n


def rec_hold(torch, lm32, label, prompts, ids, out, run, ref, bar,
             replayed=False):
    """Phase 19's stream rule (phase 18's, each token given the history it
    was picked from): the tokens delivered up to the kill equal the
    uninterrupted tp=4 run's (``ref``); every token within ``bar`` of the
    f32 copy's best logit given that history (:func:`deficits`). A
    migrated stream is one history: the result equals what ``on_token``
    delivered. A ``replayed`` request has two lives: the first's delivered
    tokens are held along themselves, the last life's result along itself,
    and the tokens it delivered after the kill must be its own. Where the
    last life regenerated another token than the one delivered (a near
    tie, counted in ``regen_mismatches``), the delivered stream splices two
    histories: its deficits along the splice are printed, not gated.
    Returns (streams leaving the uninterrupted one, largest gated deficit,
    largest deficit along a spliced delivered stream, requests whose last
    life left the delivered stream)."""
    left, worst, spliced, regen = 0, 0.0, 0.0, []

    def hold(rid, p, toks):
        d = deficits(torch, lm32, p, toks)
        if len(d) and d.max() > bar:
            t = int(d.argmax())
            raise AssertionError(
                f"{label}: request {rid} (prompt {len(p)}) token {t} lies "
                f"{d[t]:.4f} below the f32 copy's best logit (bar {bar:.4f})")
        return float(d.max()) if len(d) else 0.0

    for rid, p in zip(ids, prompts):
        got = run.stream(rid, label)
        res = np.asarray(out[rid])
        n = run.at_kill.get(rid, 0)
        if ref is not None:
            want = np.asarray(ref[rid])
            if not np.array_equal(got[:n], want[:n]):
                raise AssertionError(f"{label}: request {rid}'s first {n} "
                                     "tokens differ from the uninterrupted "
                                     "run's")
            left += not np.array_equal(got, want)
        if not replayed:
            if not np.array_equal(res, got):
                raise AssertionError(f"{label}: request {rid}'s result "
                                     "differs from what on_token delivered")
            worst = max(worst, hold(rid, p, got))
            continue
        if len(res) != len(got) or not np.array_equal(res[n:], got[n:]):
            raise AssertionError(f"{label}: request {rid}'s last life "
                                 "delivered other tokens than its result")
        worst = max(worst, hold(rid, p, got[:n]), hold(rid, p, res))
        diff = np.nonzero(res[:n] != got[:n])[0]
        if len(diff):
            d = deficits(torch, lm32, p, got)
            regen.append((rid, int(diff[0]), float(d.max())))
            spliced = max(spliced, float(d.max()))
    return left, worst, spliced, regen


def rec_print(label, card, run, st, extra=""):
    sm = run.summary
    print(f"{label} on {card}: recovery wall {sm['wall_s']:.4f} s, moved "
          f"{sm['moved_bytes']} B, host-staged {sm['host_staged_bytes']} B "
          f"(weights: host-staged {sm['weight_host_staged_bytes']} B), tp "
          f"{sm['old_tp']} -> {sm['new_tp']}, lost {sm['lost']}, "
          f"{sm['migrated']} migrated / {sm['replayed']} replayed / "
          f"{sm['dropped']} dropped; tok/s before the kill "
          f"{run.rates[0]:.1f}, after the recovery {run.rates[1]:.1f}; "
          f"cache bytes {st['cache_bytes']} ({st['cache_bytes_per_device']} "
          f"a shard){extra}")


def rec_books(label, st, tp, migrated, replayed):
    if (st["tp"], st["recoveries"], st["recovery_migrated"],
            st["recovery_replayed"], st["recovery_dropped"]) != (
            tp, 1, migrated, replayed, 0):
        raise AssertionError(f"{label}: books tp {st['tp']}, recoveries "
                             f"{st['recoveries']}, migrated "
                             f"{st['recovery_migrated']}, replayed "
                             f"{st['recovery_replayed']}, dropped "
                             f"{st['recovery_dropped']}")
    if st["cache_bytes_per_device"] * tp != st["cache_bytes"]:
        raise AssertionError(f"{label}: {st['cache_bytes_per_device']} a "
                             f"shard x {tp} != {st['cache_bytes']}")


def rec_migrate_run(torch, slm4, layout, prompts, steps, kill, counters,
                    label, new_tp=2):
    """One migrate run on ``slm4`` (8 slots, chunk 8, ``auto_reshard``
    off): staggered until every slot decodes, a snapshot, the kill of
    ``kill``, a tick that raises, ``recover()``, each new shard's KV
    checked against the snapshot, a steady tick, then the drain. ``kill``
    None is the uninterrupted reference. Returns the batcher, ids, results
    and the run's books."""
    from adapt_tpu_torch.config import RecoveryConfig
    from adapt_tpu_torch.control.registry import DeviceHealthMonitor
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

    extra = dict(kv_layout="paged", page_size=128) if layout == "paged" else {}
    mon = DeviceHealthMonitor()
    bat = ContinuousBatcher(slm4, slots=8, chunk=8, health=mon,
                            recovery=RecoveryConfig(auto_reshard=False),
                            **extra)
    run = RecRun()
    ids = rec_stagger(bat, prompts, steps, run)
    steady = None
    if kill is not None:
        snap = rec_snapshot(bat)
        rec_kill(torch, bat, mon, kill, run, auto=False)
        rec_check_concat(torch, label, bat, snap, new_tp)
        del snap
        dec = counters["paged_attn" if layout == "paged" else "decode_attn"]
        steady = rec_steady(torch, label, bat, dec,
                            new_tp * len(bat.lm.blocks) * bat.chunk)
    out = rec_finish(torch, bat, run)
    return bat, ids, out, run, steady


def rec_migrate_part(torch, slm4, lm32, card, counters, runs, prompts, bar):
    """Phase 19 (a): phase 6's first 8 prompts (64 new) staggered on a
    tp=4 batcher (8 slots) until every slot decodes, member 3 killed, on
    dense strips and on a paged pool, then member 0 (the lead) on the pool;
    each against the uninterrupted tp=4 run of its layout."""
    from adapt_tpu_torch.utils.profiling import global_compile_sentinel

    sentinel = global_compile_sentinel()
    for layout, kill in (("slots", None), ("slots", (3,)), ("paged", None),
                         ("paged", (3,)), ("paged", (0,))):
        want = (("flash_attn_fwd", "decode_attn") if layout == "slots" else
                ("flash_attn_fwd", "paged_attn"))
        path = f"rec_{layout}_" + ("ref" if kill is None else
                                   f"kill{kill[0]}")
        label = f"phase 19 (a) {layout} kill {kill}"
        counts0, events0 = sentinel.counts(), sentinel.events
        bat, ids, out, run, steady = counted(
            counters, path, want, runs,
            lambda: rec_migrate_run(torch, slm4, layout, prompts, 64, kill,
                                    counters, label))
        st = bat.stats()
        bat.close()
        if kill is None:
            ref = out
            continue
        if sentinel.counts() != counts0 or sentinel.events != events0:
            raise AssertionError(f"{label}: the compile sentinel moved "
                                 f"({counts0} -> {sentinel.counts()})")
        rec_books(label, st, 2, len(ids), 0)
        left, worst, _, _ = rec_hold(torch, lm32, label, prompts, ids, out,
                                     run, ref, bar)
        rec_print(label, card, run, st,
                  f"; {len(ids)} requests migrated (each new shard's KV the "
                  f"ordered concatenation of the old shards'), {left} leaving "
                  f"the uninterrupted stream after the kill, largest deficit "
                  f"{worst:.4f} (bar {bar:.4f}); a steady tick {steady[0][0]} "
                  f"h2d / {steady[0][1]} fetch / {steady[1]} launches; no "
                  f"compile event; launches {runs[path]}")


def rec_spec_part(torch, slm4, draft, lm32, card, counters, runs, prompts,
                  bar):
    """Phase 19 (b): 8 of phase 6's prompts (40 new) on an int8 pool with
    the 2-layer draft in int8 weights (``draft_k=4``) at tp=4,
    ``auto_reshard`` on: member 1 killed once every slot decodes, the next
    tick recovers (tp=2) inside itself; both members of every ``(values,
    scales)`` pair checked against a snapshot taken as recover() starts."""
    from adapt_tpu_torch.config import SpeculativeConfig
    from adapt_tpu_torch.control.registry import DeviceHealthMonitor
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

    label = "phase 19 (b) int8 speculative"
    spec = SpeculativeConfig(draft_k=4, draft_weight_dtype="int8")

    def go():
        mon = DeviceHealthMonitor()
        bat = ContinuousBatcher(slm4, slots=8, kv_layout="paged",
                                page_size=128, prefill_chunk=256,
                                kv_cache_dtype="int8", draft_lm=draft,
                                speculative=spec, health=mon)
        run = RecRun()
        recover = bat.recover

        def checked_recover():
            snap = rec_snapshot(bat)
            run.summary = recover()
            rec_check_concat(torch, label, bat, snap, 2)
            return run.summary

        bat.recover = checked_recover
        ids = rec_stagger(bat, prompts, 40, run)
        rec_kill(torch, bat, mon, (1,), run, auto=True)
        out = rec_finish(torch, bat, run, inside=True)
        return bat, ids, out, run

    bat, ids, out, run = counted(
        counters, "rec_spec_int8", ("paged_verify_attn", "paged_chunk_attn",
                                    "dequantize_blocks"), runs, go)
    st = bat.stats()
    bat.close()
    if not run.summary:
        raise AssertionError(f"{label}: no recovery ran")
    rec_books(label, st, 2, len(ids), 0)
    _, worst, _, _ = rec_hold(torch, lm32, label, prompts, ids, out, run,
                              None, bar)
    rec_print(label, card, run, st,
              f"; both members of every (values, scales) pair the ordered "
              f"concatenation of the old shards'; largest deficit "
              f"{worst:.4f} (bar {bar:.4f}); acceptance "
              f"{st['spec_acceptance']:.4f}; launches {runs['rec_spec_int8']}")


def rec_replay_part(torch, slm4, lm32, card, counters, runs, prompts, bar):
    """Phase 19 (c): phase 6's first 8 prompts (64 new) on a paged pool at
    tp=4 with ``policy="replay"`` and a ``DispatcherJournal`` in a
    temporary directory: member 2 killed once every slot decodes; every
    in-flight request replays from the journal, re-entering through the
    prefix cache; ``on_token`` delivers each index once; the journal ends
    with nothing pending."""
    import tempfile

    from adapt_tpu_torch.config import RecoveryConfig
    from adapt_tpu_torch.control.journal import DispatcherJournal
    from adapt_tpu_torch.control.registry import DeviceHealthMonitor
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
    from adapt_tpu_torch.utils.tracing import global_flight_recorder

    label = "phase 19 (c) replay from the journal"
    fr = global_flight_recorder()
    with tempfile.TemporaryDirectory() as tmp:
        journal = DispatcherJournal(os.path.join(tmp, "wal"))

        def go():
            mon = DeviceHealthMonitor()
            bat = ContinuousBatcher(slm4, slots=8, chunk=8, kv_layout="paged",
                                    page_size=128, health=mon,
                                    journal=journal,
                                    recovery=RecoveryConfig(
                                        policy="replay", auto_reshard=False))
            run = RecRun()
            ids = rec_stagger(bat, prompts, 64, run)
            hits0 = bat.stats()["prefix_hits"]
            _, cursor = fr.events_since(1 << 62)
            rec_kill(torch, bat, mon, (2,), run, auto=False)
            events = [e["data"] for e in fr.events_since(cursor)[0]
                      if e["kind"] == "replayed_from_journal"]
            out = rec_finish(torch, bat, run)
            return bat, ids, out, run, hits0, events

        bat, ids, out, run, hits0, events = counted(
            counters, "rec_replay", ("flash_attn_fwd", "paged_attn",
                                     "paged_chunk_attn"), runs, go)
        st = bat.stats()
        bat.close()
        pending = journal.pending_ids()
        journal.close()
    if (len(events) != len(ids)
            or any(e["source"] != "journal" for e in events)):
        raise AssertionError(f"{label}: replay events {events}")
    if st["prefix_hits"] <= hits0:
        raise AssertionError(f"{label}: prefix hits {hits0} -> "
                             f"{st['prefix_hits']}: no replay re-entered "
                             "through the prefix cache")
    if pending:
        raise AssertionError(f"{label}: the journal still holds {pending}")
    rec_books(label, st, 2, 0, len(ids))
    _, worst, spliced, regen = rec_hold(torch, lm32, label, prompts, ids,
                                        out, run, None, bar, replayed=True)
    rec_print(label, card, run, st,
              f"; {len(events)} replays from the journal, prefix hits "
              f"{hits0} -> {st['prefix_hits']}, each index delivered once, "
              f"journal empty at drain; regen_mismatches "
              f"{st['regen_mismatches']} in {len(regen)} requests "
              f"(request, first regenerated index that left the delivered "
              f"token, largest deficit along the spliced delivered stream: "
              f"{regen}); largest deficit of a token given its own life's "
              f"history {worst:.4f} (bar {bar:.4f}), along a splice "
              f"{spliced:.4f} (not gated); launches {runs['rec_replay']}")


def reduced_lm(torch, lm, depth):
    """``lm``'s widths at ``depth`` blocks, sharing its embedding, first
    blocks and head."""
    from adapt_tpu_torch.models.transformer_lm import transformer_lm

    vocab, dim, _, heads, mlp = GPT2_SMALL
    small = transformer_lm(vocab, dim, depth, heads, mlp, max_len=1024,
                           dtype=torch.bfloat16, name=f"gpt2_small_{depth}",
                           seed=1, device=lm.device)
    small.load_state_dict({k: v for k, v in lm.state_dict().items()
                           if k in small.state_dict()})
    return small.eval()


def rec_triple_part(torch, lm, card, counters, runs, prompts):
    """Phase 19 (d): a 4-block model of GPT-2-small's widths (its own f32
    copy and e1 bar, :func:`tp_precision`) on dense strips at tp=4, members
    0, 2 and 3 killed: the tp=1 remnant (a plain LM on member 1's device)
    serves on; streams held as in (a)."""
    from adapt_tpu_torch.core.mesh import MeshSpec, build_mesh
    from adapt_tpu_torch.models.transformer_lm import TransformerLM, shard_lm

    small = reduced_lm(torch, lm, 4)
    small32 = f32_copy(torch, small)
    slm = shard_lm(small, build_mesh(MeshSpec((("tp", 4),)),
                                     [lm.device] * 4))
    bar = 2 * tp_precision(torch, small, small32, {4: slm}, prompts[:2],
                           "phase 19 (d)")
    label = "phase 19 (d) triple kill"
    for kill in (None, (0, 2, 3)):
        path = "rec_triple_" + ("ref" if kill is None else "kill")
        bat, ids, out, run, steady = counted(
            counters, path, ("flash_attn_fwd", "decode_attn"), runs,
            lambda: rec_migrate_run(torch, slm, "slots", prompts, 64, kill,
                                    counters, label, new_tp=1))
        st = bat.stats()
        remnant = bat.lm
        bat.close()
        if kill is None:
            ref = out
            continue
    if not isinstance(remnant, TransformerLM):
        raise AssertionError(f"{label}: the remnant runs a "
                             f"{type(remnant).__name__}")
    rec_books(label, st, 1, len(ids), 0)
    left, worst, _, _ = rec_hold(torch, small32, label, prompts, ids, out,
                                 run, ref, bar)
    rec_print(label, card, run, st,
              f"; the remnant a plain 4-block LM on {remnant.device}; "
              f"{left} leaving the uninterrupted stream, largest deficit "
              f"{worst:.4f} (bar {bar:.4f}); a steady tick {steady[0][0]} "
              f"h2d / {steady[0][1]} fetch / {steady[1]} launches; "
              f"launches {runs[path]}")


def recovery_phase(torch, A, D, P, Q, lm, draft, lm32, slm4, card, kernels,
                   dprompts, bar, int8_bar):
    """Phase 19: elastic recovery of the tp=4 batcher on the one card
    (meshes of 4 member ids naming cuda:0), held with phase 18's f32 copy
    and bar: (a) migrate on both layouts, member 3 then the lead, (b) an
    int8 pool with int8 speculation recovering inside a tick, (c) replay
    from a journal, (d) a triple kill to a tp=1 remnant at 4 blocks. Adds
    ``recovery_launches`` (phase 19's launches of each kernel, its runs
    summed) to every row of ``kernels``."""
    t_phase = time.perf_counter()
    counters = {"flash_attn_fwd": A.flash_attn_fwd,
                "decode_attn": D.decode_attn, "paged_attn": P.paged_attn,
                "paged_chunk_attn": P.paged_chunk_attn,
                "paged_verify_attn": P.paged_verify_attn,
                "dequantize_blocks": Q.dequantize_blocks}
    runs: dict = {}
    prompts = list(dprompts[:8])
    marks = [time.perf_counter()]
    rec_migrate_part(torch, slm4, lm32, card, counters, runs, prompts, bar)
    marks.append(time.perf_counter())
    rec_spec_part(torch, slm4, draft, lm32, card, counters, runs, prompts,
                  bar + int8_bar)
    marks.append(time.perf_counter())
    rec_replay_part(torch, slm4, lm32, card, counters, runs, prompts, bar)
    marks.append(time.perf_counter())
    rec_triple_part(torch, lm, card, counters, runs, prompts)
    marks.append(time.perf_counter())
    totals: dict = {}
    for path, launches in runs.items():
        rows = dict(TP_ROWS["spec_int8" if path.endswith("spec_int8") else
                            "native"], dequantize_blocks="dequantize_blocks")
        for k, n in launches.items():
            if k in rows:
                totals[rows[k]] = totals.get(rows[k], 0) + n
    for kr in kernels:
        kr["recovery_launches"] = totals.get(kr["name"], 0)
    print(f"phase 19 launches by path: {json.dumps(runs)}")
    took = ", ".join(f"({part}) {b - a:.1f}"
                     for part, a, b in zip("abcd", marks, marks[1:]))
    print(f"phase 19 (elastic recovery) took "
          f"{time.perf_counter() - t_phase:.1f} s on {card} ({took})")


# -- phase 20: sequence parallelism -------------------------------------------

#: Phase 20 (a)'s q / k / v: b, heads, S, head_dim (bf16).
SP_RING_SHAPE = (1, 12, 4096, 64)


def sp_rings_part(torch, A, dev, card, counters, runs):
    """Phase 20 (a): ``ring_attention`` at b1 h12 S4096 d64 bf16 over rings
    of 2 and 4 ranks naming the card, {flash, jnp} x {contiguous, striped}
    x causal or not, and ``ulysses_attention`` at the same widths, each
    within 1e-2 + 1e-2|ref| of ``attention_reference`` (striped outputs
    unstriped first). K1 launches of each flash ring exactly what its
    layout needs (a contiguous causal ring launches nothing for its dead
    steps); no jnp ring launches K1. Then the device ms per call of the
    striped against the contiguous causal flash ring (printed)."""
    import importlib

    from adapt_tpu_torch.core.mesh import MeshSpec, build_mesh
    from adapt_tpu_torch.parallel.ulysses import ulysses_attention

    R = importlib.import_module("adapt_tpu_torch.parallel.ring_attention")
    g = torch.Generator(device=dev).manual_seed(20)
    S = SP_RING_SHAPE[2]
    q, k, v = (torch.randn(*SP_RING_SHAPE, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    refs = {c: A.attention_reference(q, k, v, causal=c) for c in (False, True)}
    worst, meshes = 0.0, {}
    for sp in (2, 4):
        mesh = meshes[sp] = build_mesh(MeshSpec((("sp", sp),)), [dev] * sp)
        striped = tuple(R.stripe_sequence(t, sp) for t in (q, k, v))
        for impl in ("flash", "jnp"):
            for layout in ("contiguous", "striped"):
                for causal in (False, True):
                    path = (f"ring_{impl}_{layout}_"
                            f"{'causal' if causal else 'full'}_sp{sp}")
                    args = striped if layout == "striped" else (q, k, v)
                    out = counted(
                        counters, path,
                        ("flash_attn_fwd",) if impl == "flash" else (), runs,
                        lambda args=args, impl=impl, layout=layout,
                        causal=causal: R.ring_attention(
                            *args, mesh, causal=causal, block_impl=impl,
                            layout=layout))
                    torch.cuda.synchronize()
                    if layout == "striped":
                        out = R.unstripe_sequence(out, sp)
                    worst = max(worst, close(out, refs[causal], 1e-2, 1e-2,
                                             f"phase 20 (a) {path}"))
                    want = (0 if impl == "jnp" else sp * (sp + 1) // 2
                            if causal and layout == "contiguous" else sp * sp)
                    if runs[path]["flash_attn_fwd"] != want:
                        raise AssertionError(
                            f"phase 20 (a) {path}: "
                            f"{runs[path]['flash_attn_fwd']} K1 launches, "
                            f"want {want}")
        for causal in (False, True):
            path = f"ulysses_{'causal' if causal else 'full'}_sp{sp}"
            out = counted(counters, path, ("flash_attn_fwd",), runs,
                          lambda causal=causal: ulysses_attention(
                              q, k, v, mesh, causal=causal))
            torch.cuda.synchronize()
            worst = max(worst, close(out, refs[causal], 1e-2, 1e-2,
                                     f"phase 20 (a) {path}"))
            if runs[path]["flash_attn_fwd"] != sp:
                raise AssertionError(f"phase 20 (a) {path}: "
                                     f"{runs[path]['flash_attn_fwd']} K1 "
                                     f"launches, want {sp}")
    b, h, _, d = SP_RING_SHAPE
    print(f"phase 20 (a) rings on {card}: 16 ring_attention and 4 "
          f"ulysses_attention calls at b{b} h{h} S{S} d{d} bf16 within 1e-2 + "
          f"1e-2|ref| of attention_reference (largest abs err {worst:.3e}); "
          "K1 launches per call: " + ", ".join(
              f"{p} {n['flash_attn_fwd']}" for p, n in runs.items()
              if n["flash_attn_fwd"]))
    timing = []
    for sp in (2, 4):
        striped = tuple(R.stripe_sequence(t, sp) for t in (q, k, v))
        for layout, args in (("contiguous", (q, k, v)),
                             ("striped", striped)):
            ms, events = device_ms_sum(torch, lambda args=args, sp=sp,
                                       layout=layout: R.ring_attention(
                                           *args, meshes[sp], causal=True,
                                           block_impl="flash", layout=layout))
            timing.append(f"sp{sp} {layout} {ms:.4f} ms ({events:.0f} "
                          "device events)")
    print(f"phase 20 (a) causal flash ring, device ms a call "
          f"(torch.profiler, summed device events; the ranks run one after "
          f"another on one card) on {card}: " + "; ".join(timing)
          + " (not gated)")


def sp_traffic(waves):
    """Phase 20 (b)'s prompts: phase 7's four of 600-900 tokens, then its
    four unique ones of 16-512."""
    return list(waves[0][5:8]) + list(waves[1][7:]) + list(waves[0][1:5])


def sp_batcher(lm, kv, width):
    """Phase 7's paged batcher (slots 8, chunk 8, page 128, the 65-page
    pool, prefill_chunk 256), with ``PrefillConfig(sp_threshold=512,
    sp_width=width)`` unless ``width`` is None."""
    from adapt_tpu_torch.config import PrefillConfig
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

    sp = (PrefillConfig(sp_threshold=512, sp_width=width) if width else None)
    return ContinuousBatcher(lm, slots=8, chunk=8, kv_layout="paged",
                             page_size=128, prefill_chunk=256,
                             kv_cache_dtype=kv, prefill=sp)


def sp_serve(torch, bat, prompts, steps):
    """Submit every prompt at once and run to drain; returns the ids, the
    results and each request's TTFT in s (submit to its first token)."""
    first = {}

    def on_token(rid, tok, idx):
        if idx == 0:
            first[rid] = time.perf_counter()

    t0 = time.perf_counter()
    ids = [bat.submit(p, steps, on_token=on_token) for p in prompts]
    out = bat.run()
    torch.cuda.synchronize()
    return ids, out, {rid: first[rid] - t0 for rid in ids}


def sp_hold(torch, lm, lm32, label, prompts, ids, out, ref_ids, ref_out,
            steps, gap_bar, bar):
    """Phase 20's stream rule: every stream has its length; where it leaves
    the same traffic's stream without sp, the reference's top-2 gap there
    is below ``gap_bar`` (phase 7's tie-aware rule); every token lies within
    ``bar`` of the f32 copy's best logit given the stream's own history
    (phase 18's rule). Returns the exemptions and the largest deficit."""
    exempt, worst = [], 0.0
    for rid, rrid, p in zip(ids, ref_ids, prompts):
        got, want = np.asarray(out[rid]), np.asarray(ref_out[rrid])
        if len(got) != steps:
            raise AssertionError(f"{label}: request {rid} has {len(got)} "
                                 "tokens")
        tg = first_gap(torch, lm, p, got, want)
        if tg is not None:
            t, gap = tg
            print(f"{label}: request {rid} (prompt {len(p)}) leaves the "
                  f"stream without sp at token {t}, top-2 gap {gap:.4f}")
            if gap >= gap_bar:
                raise AssertionError(f"{label}: request {rid} differs at "
                                     f"token {t} with top-2 gap {gap:.4f} "
                                     f">= {gap_bar:.4f}")
            exempt.append(rid)
        d = deficits(torch, lm32, p, got)
        if d.max() > bar:
            t = int(d.argmax())
            raise AssertionError(
                f"{label}: request {rid} (prompt {len(p)}) token {t} lies "
                f"{d[t]:.4f} below the f32 copy's best logit (bar {bar:.4f})")
        worst = max(worst, float(d.max()))
    return exempt, worst


def sp_steady(torch, label, bat, prompt):
    """A fresh long prompt (an sp admission) alone, until it decodes; one
    more tick; then one steady tick must make 0 host->device copies and 1
    fetch. Runs the batcher to drain after."""
    bat.submit(prompt, 64)
    while len(bat._queue) or any(s.req is not None and s.pf_done >= 0
                                 for s in bat.slots):
        bat.tick()
    bat.tick()
    before = bat.stats()
    if bat.tick() < 1:
        raise AssertionError(f"{label}: the steady tick decoded no slot")
    after = bat.stats()
    steady = (after["h2d_transfers"] - before["h2d_transfers"],
              after["d2h_fetches"] - before["d2h_fetches"])
    if steady != (0, 1):
        raise AssertionError(f"{label}: a steady tick made {steady[0]} "
                             f"host->device copies and {steady[1]} fetches "
                             "(want 0 and 1)")
    bat.run()
    return steady


def sp_page_diff(torch, lm, prompt, kv):
    """The largest difference per block between the sp ring's pages (sp 2)
    and the port's own chunked prefill's (a ``PrefillWorker``, K4 / K4q at
    prefill_chunk 256) of ``prompt``, over K and V (a quantized pool
    compared as values x scales)."""
    from adapt_tpu_torch.ops.quantize import kv_values
    from adapt_tpu_torch.parallel.sp_prefill import SPPrefiller, build_sp_mesh
    from adapt_tpu_torch.runtime.disagg import PrefillWorker

    pf = SPPrefiller(lm, build_sp_mesh(2, devices=[lm.device] * 2), 128,
                     kv_cache_dtype=kv)
    _, sp_blocks = pf.prefill(prompt)
    pf.close()
    worker = PrefillWorker(lm, page_size=128, slots=1, prefill_chunk=256,
                           kv_cache_dtype=kv)
    worker.submit(0, prompt)
    outs = []
    while not outs:
        outs = worker.step()
    hd = lm.blocks[0].head_dim

    def values(t):
        if isinstance(t, tuple):
            return kv_values(t[0], hd).float() * t[1].float()
        return t.float()

    return [max(float((values(a) - values(b)).abs().max())
                for a, b in zip(sa, sb))
            for sa, sb in zip(sp_blocks, outs[0].blocks)]


def sp_batcher_part(torch, lm, lm32, card, counters, runs, waves, bar,
                    int8_bar):
    """Phase 20 (b): phase 7's long and unique prompts (32 new tokens)
    through the paged batcher without sp, then with sp_width 2 and 4, on a
    native and an int8 pool: ``sp_prefills`` equal to the prompts of 512+
    tokens, at least as many prefix hits, no sp failure, each stream held
    by :func:`sp_hold` against the run without sp (int8: phase 9's bar, and
    phase 18's bar plus it); then a steady tick after a fresh sp admission.
    Prints the sp pages' largest difference from the chunked prefill's per
    block, the long prompts' TTFT and the K4 launches."""
    prompts = sp_traffic(waves)
    n_long = sum(len(p) >= 512 for p in prompts)
    steps = 32
    for kv, gap_bar, dbar in (("native", 0.1, bar),
                              ("int8", int8_bar, bar + int8_bar)):
        diff = sp_page_diff(torch, lm, prompts[0], kv)
        print(f"phase 20 (b) [{kv}] largest difference per block, sp ring "
              f"pages (plain f32 attention) against the port's chunked "
              f"prefill pages (K4) of a {len(prompts[0])}-token prompt: "
              + ", ".join(f"{d:.4g}" for d in diff) + " (not gated)")
        want = ("paged_attn", "paged_chunk_attn")
        bat = sp_batcher(lm, kv, None)
        ref_ids, ref, ref_ttft = counted(
            counters, f"sp_base_{kv}", want, runs,
            lambda bat=bat: sp_serve(torch, bat, prompts, steps))
        bat.close()
        long_ttft = {None: np.mean([ref_ttft[r] for r, p in zip(ref_ids,
                                                                prompts)
                                    if len(p) >= 512])}
        for width in (2, 4):
            label = f"phase 20 (b) sp{width} [{kv}]"
            path = f"sp{width}_{kv}"
            bat = sp_batcher(lm, kv, width)
            ids, out, ttft = counted(
                counters, path, want, runs,
                lambda bat=bat: sp_serve(torch, bat, prompts, steps))
            st = bat.stats()
            if (st["sp_prefills"] != n_long or st["prefix_hits"] < n_long
                    or st["sp_failures"] or st["sp_width"] != width):
                raise AssertionError(
                    f"{label}: sp_prefills {st['sp_prefills']} (want "
                    f"{n_long}), prefix_hits {st['prefix_hits']}, "
                    f"sp_failures {st['sp_failures']}, sp_width "
                    f"{st['sp_width']}")
            exempt, worst = sp_hold(torch, lm, lm32, label, prompts, ids,
                                    out, ref_ids, ref, steps, gap_bar, dbar)
            long_ttft[width] = np.mean([ttft[r] for r, p in zip(ids, prompts)
                                        if len(p) >= 512])
            steady = sp_steady(torch, label, bat,
                               np.roll(prompts[0], 1).copy())
            if bat.stats()["sp_prefills"] != n_long + 1:
                raise AssertionError(f"{label}: the fresh long admission did "
                                     "not take the sp path")
            bat.close()
            print(f"{label} on {card}: {len(prompts)} requests, sp_prefills "
                  f"{st['sp_prefills']}, prefix_hits {st['prefix_hits']}, "
                  f"sp_failures 0, {len(exempt)} streams leaving the run "
                  f"without sp (each at a top-2 gap below {gap_bar:.4f}), "
                  f"largest deficit {worst:.4f} (bar {dbar:.4f}); steady "
                  f"tick {steady[0]} h2d / {steady[1]} fetch; launches "
                  f"{runs[path]} (without sp: {runs[f'sp_base_{kv}']})")
        print(f"phase 20 (b) [{kv}] mean TTFT of the {n_long} long prompts "
              f"on {card}: without sp {long_ttft[None] * 1e3:.1f} ms, sp2 "
              f"{long_ttft[2] * 1e3:.1f} ms, sp4 {long_ttft[4] * 1e3:.1f} ms "
              "(one card: the ranks run one after another; not gated)")
    return prompts, n_long


def sp_tier_part(torch, lm, lm32, card, counters, runs, prompts, n_long,
                 bar):
    """Phase 20 (c): phase 20 (b)'s traffic behind a ``DisaggServer`` whose
    ``PrefillWorker`` pool (4 pages of 128, 3 allocatable) holds none of
    the long prompts: without sp no handoff (they collocate); with
    sp_width 2 every long prompt hands off, no job fails, and the streams
    pass :func:`sp_hold` against the run without sp."""
    from adapt_tpu_torch.config import DisaggConfig, PrefillConfig
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
    from adapt_tpu_torch.runtime.disagg import DisaggServer, PrefillWorker

    steps = 32

    def serve(sp_cfg):
        decode = ContinuousBatcher(lm, slots=8, chunk=8, kv_layout="paged",
                                   page_size=128, prefill_chunk=256)
        worker = PrefillWorker(lm, page_size=128, slots=2, pool_pages=4,
                               prefill_chunk=256, prefill=sp_cfg)
        srv = DisaggServer(decode, worker, DisaggConfig(
            prompt_threshold=512, busy_prompt_threshold=512))
        sids = [srv.submit(p, steps) for p in prompts]
        out = srv.run()
        torch.cuda.synchronize()
        got = (sids, out, worker.stats(), srv.failed, list(worker.failed_jobs))
        srv.close()
        decode.close()
        return got

    label = "phase 20 (c) prefill tier"
    ref_ids, ref, st0, _, _ = counted(counters, "sp_tier_off",
                                      ("paged_attn",), runs,
                                      lambda: serve(None))
    if st0["handoffs"] != 0:
        raise AssertionError(f"{label}: {st0['handoffs']} handoffs without "
                             "sp from a pool that holds no long prompt")
    ids, out, st, failed, failed_jobs = counted(
        counters, "sp_tier", ("paged_attn", "paged_chunk_attn"), runs,
        lambda: serve(PrefillConfig(sp_threshold=512, sp_width=2)))
    if (st["handoffs"] != n_long or st["sp_prefills"] != n_long or failed
            or failed_jobs or st["sp_failures"]):
        raise AssertionError(f"{label}: handoffs {st['handoffs']}, "
                             f"sp_prefills {st['sp_prefills']} (want "
                             f"{n_long}), failed {failed}, failed_jobs "
                             f"{failed_jobs}, sp_failures "
                             f"{st['sp_failures']}")
    exempt, worst = sp_hold(torch, lm, lm32, label, prompts, ids, out,
                            ref_ids, ref, steps, 0.1, bar)
    print(f"{label} on {card}: a 3-page prefill pool; without sp 0 "
          f"handoffs, with sp_width 2 {st['handoffs']} handoffs "
          f"({st['sp_prefills']} sp prefills), failed_jobs empty, "
          f"{len(exempt)} streams leaving the collocated run's (each at a "
          f"top-2 gap below 0.1), largest deficit {worst:.4f} (bar "
          f"{bar:.4f}); launches {runs['sp_tier']}")


def sp_recovery_part(torch, slm2, lm32, card, counters, runs, prompts, bar):
    """Phase 20 (d): a tp=2 batcher (members 0, 1; phase 18's shards) with
    an (sp=2, tp=2) ring (members 0-3) and a ``DispatcherJournal``; every
    slot decoding, member 1 killed: the tick raises ``DeviceLostError``,
    ``recover()`` goes to tp=1 and rebuilds the ring from the survivors
    {0, 2, 3} at sp=2, tp=1 (members 0 and 2); a later long admission
    takes the sp path. Phase 19's gates: each index delivered once, every
    token within the bar given its own history, the journal empty."""
    import tempfile

    from adapt_tpu_torch.config import PrefillConfig, RecoveryConfig
    from adapt_tpu_torch.control.journal import DispatcherJournal
    from adapt_tpu_torch.control.registry import DeviceHealthMonitor
    from adapt_tpu_torch.parallel.sp_prefill import build_sp_mesh
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

    label = "phase 20 (d) sp x tp recovery"
    n_long = sum(len(p) >= 512 for p in prompts)
    fresh = np.roll(prompts[1], 3).copy()
    with tempfile.TemporaryDirectory() as tmp:
        journal = DispatcherJournal(os.path.join(tmp, "wal"))

        def go():
            mon = DeviceHealthMonitor()
            bat = ContinuousBatcher(
                slm2, slots=8, chunk=8, kv_layout="paged", page_size=128,
                prefill_chunk=256, health=mon, journal=journal,
                recovery=RecoveryConfig(auto_reshard=False),
                prefill=PrefillConfig(sp_threshold=512, sp_width=2),
                sp_mesh=build_sp_mesh(2, 2, devices=[slm2.device] * 4))
            run = RecRun()
            ids = rec_stagger(bat, prompts, 64, run)
            sp0 = bat.stats()["sp_prefills"]
            rec_kill(torch, bat, mon, (1,), run, auto=False)
            ring = [m.id for m in bat._sp._mesh.members()]
            out = rec_finish(torch, bat, run)
            rid = bat.submit(fresh, 32, on_token=run.on_token)
            out.update(bat.run())
            torch.cuda.synchronize()
            return bat, ids, out, run, sp0, ring, rid

        bat, ids, out, run, sp0, ring, rid = counted(
            counters, "sp_recovery", ("paged_attn", "paged_chunk_attn"),
            runs, go)
        st = bat.stats()
        sp_tp = bat._sp.tp
        bat.close()
        pending = journal.pending_ids()
        journal.close()
    if sp0 != n_long or st["sp_prefills"] != n_long + 1:
        raise AssertionError(f"{label}: sp_prefills {sp0} before the kill "
                             f"(want {n_long}), {st['sp_prefills']} after "
                             f"the later admission (want {n_long + 1})")
    if (st["tp"], st["sp_width"], ring, sp_tp) != (1, 2, [0, 2], 1):
        raise AssertionError(f"{label}: tp {st['tp']}, ring members {ring} "
                             f"at sp {st['sp_width']}, tp {sp_tp}")
    if pending:
        raise AssertionError(f"{label}: the journal still holds {pending}")
    rec_books(label, st, 1, len(ids), 0)
    _, worst, _, _ = rec_hold(torch, lm32, label, prompts, ids, out, run,
                              None, bar)
    _, late, _, _ = rec_hold(torch, lm32, label, [fresh], [rid], out, run,
                             None, bar)
    rec_print(label, card, run, st,
              f"; the ring rebuilt from members {{0, 2, 3}} as {ring} at sp "
              f"2, tp 1; sp_prefills {sp0} before the kill, {st['sp_prefills']}"
              f" after a later {len(fresh)}-token admission; each index "
              f"delivered once, journal empty; largest deficit "
              f"{max(worst, late):.4f} (bar {bar:.4f}); launches "
              f"{runs['sp_recovery']}")


def sp_phase(torch, A, lm, lm32, slm2, card, kernels, waves, bar, int8_bar):
    """Phase 20: sequence parallelism on the one card (rings naming cuda:0):
    (a) ring attention and Ulysses (K1), (b) the sp batcher, (c) the
    prefill tier, (d) sp x tp recovery. Streams are held with phase 18's
    f32 copy ``lm32`` and bar (2 x e1; int8 paths plus phase 9's bar).
    Adds ``sp_launches`` (phase 20's launches of each kernel, its runs
    summed) to every row of ``kernels``."""
    from adapt_tpu_torch.ops import paged_attention as P

    t_phase = time.perf_counter()
    counters = {"flash_attn_fwd": A.flash_attn_fwd,
                "paged_attn": P.paged_attn,
                "paged_chunk_attn": P.paged_chunk_attn}
    runs: dict = {}
    marks = [time.perf_counter()]
    sp_rings_part(torch, A, lm.device, card, counters, runs)
    marks.append(time.perf_counter())
    prompts, n_long = sp_batcher_part(torch, lm, lm32, card, counters, runs,
                                      waves, bar, int8_bar)
    marks.append(time.perf_counter())
    sp_tier_part(torch, lm, lm32, card, counters, runs, prompts, n_long, bar)
    marks.append(time.perf_counter())
    sp_recovery_part(torch, slm2, lm32, card, counters, runs, prompts, bar)
    marks.append(time.perf_counter())
    totals: dict = {}
    for path, launches in runs.items():
        rows = FLEET_ROWS["int8" if path.endswith("int8") else "native"]
        for k, n in launches.items():
            if k in rows:
                totals[rows[k]] = totals.get(rows[k], 0) + n
    for kr in kernels:
        kr["sp_launches"] = totals.get(kr["name"], 0)
    print(f"phase 20 launches by path: {json.dumps(runs)}")
    took = ", ".join(f"({part}) {b - a:.1f}"
                     for part, a, b in zip("abcd", marks, marks[1:]))
    print(f"phase 20 (sequence parallelism) took "
          f"{time.perf_counter() - t_phase:.1f} s on {card} ({took})")


# -- phase 21: the multi-rank pipelines ----------------------------------------

#: Phase 21's kernel rows by run kind.
PP_ROWS = {
    "native": {"flash_attn_fwd": "flash_attn_fwd",
               "decode_attn": "decode_attn"},
    "int8": {"flash_attn_fwd": "flash_attn_fwd",
             "decode_attn": "decode_attn[int8]"},
    "int4": {"flash_attn_fwd": "flash_attn_fwd",
             "decode_attn": "decode_attn[int4]"},
    "vit": {"flash_attn_fwd": "flash_attn_fwd",
            "flash_attn_bwd": "flash_attn_bwd"},
}

#: Phase 21 (a)'s runs: (pp, dp, kv_cache_dtype).
PP_RUNS = ((2, 1, "native"), (4, 1, "native"), (2, 1, "int8"),
           (4, 1, "int8"), (2, 1, "int4"), (2, 2, "native"))


def pp_mesh(dev, pp, dp=1, axis="pp"):
    """A (dp, pp) mesh (just pp at dp 1) naming ``dev`` at every entry."""
    from adapt_tpu_torch.core.mesh import MeshSpec, build_mesh

    spec = ((("dp", dp),) if dp > 1 else ()) + ((axis, pp),)
    return build_mesh(MeshSpec(spec), [dev] * (dp * pp))


def pp_batch(torch, prompts):
    """Phase 21 (a)'s batch: ``prompts`` right-padded into one (b, s0)
    tensor, and their lengths."""
    lens = [len(p) for p in prompts]
    batch = np.zeros((len(prompts), max(lens)), np.int64)
    for r, p in enumerate(prompts):
        batch[r, :len(p)] = p
    return torch.from_numpy(batch), lens


def split_prefill_error(torch, lm, batch, lens, ranks):
    """The largest first-token logit difference between ``generate()``'s
    whole-batch prefill and the same rows prefilled ``b / ranks`` at a
    time, as the pipelined microbatches are: what can move a pipelined
    stream off ``generate()``'s on the card (cuBLAS picks its algorithm by
    shape)."""
    from adapt_tpu_torch.models.transformer_lm import generate

    seen = []
    hook = lm.head.register_forward_hook(
        lambda mod, args, o: seen.append(o[:, 0].float()))
    try:
        generate(lm, batch, 1, prompt_lengths=lens)
        mb = len(lens) // ranks
        for m in range(ranks):
            generate(lm, batch[m * mb:(m + 1) * mb], 1,
                     prompt_lengths=lens[m * mb:(m + 1) * mb])
    finally:
        hook.remove()
    return float((seen[0] - torch.cat(seen[1:])).abs().max())


def hold_pp_streams(torch, lm, label, batch, lens, got, ref, bar, err):
    """Phase 7's tie-aware rule: each stream equal to ``ref``'s, or first
    differing at a top-2 gap below ``bar`` (printed with its cause), in at
    most 2 of them. Returns the exempt rows."""
    exempt = []
    for r, n in enumerate(lens):
        hit = first_gap(torch, lm, batch[r, :n].numpy(), got[r], ref[r])
        if hit is None:
            continue
        t, gap = hit
        print(f"tie-aware exemption: {label} stream {r} (prompt {n}) first "
              f"differs from generate() at token {t}, top-2 gap {gap:.4f} "
              f"(bar {bar:.4f}); its microbatch was prefilled {len(lens)} "
              f"/ P rows at a time, whose first-token logits differ from "
              f"the whole batch's by up to {err:.4f}")
        if not gap < bar:
            raise AssertionError(f"{label}: stream {r} differs at token {t}"
                                 f" at a top-2 gap {gap:.4f} >= {bar:.4f}")
        exempt.append(r)
    if len(exempt) > 2:
        raise AssertionError(f"{label}: {len(exempt)} of {len(lens)} streams "
                             "differ (at most 2)")
    return exempt


def pp_weights(torch, lm, placed, ranks, label):
    """Phase 21 (a)'s placement gates: each rank's block bytes (L/P)/L of
    the whole blocks', no rank with every block, the embedding and head
    the model's own tensors (one copy on the card)."""
    def block_bytes(m):
        return sum(t.numel() * t.element_size() for n, t in
                   m.state_dict().items() if n.startswith("decoder_block_"))

    whole = block_bytes(lm)
    own = {n: t.data_ptr() for n, t in lm.state_dict().items()
           if n.startswith(("embed.", "head."))}
    for p, stage in enumerate(placed.stages):
        if stage.depth != lm.depth // ranks or (
                block_bytes(stage) * ranks != whole):
            raise AssertionError(f"{label}: rank {p} holds {stage.depth} "
                                 f"blocks, {block_bytes(stage)} bytes of "
                                 f"{whole}")
        ends = {n: t.data_ptr() for n, t in stage.state_dict().items()
                if n.startswith(("embed.", "head."))}
        if ends != own:
            raise AssertionError(f"{label}: rank {p}'s embedding / head are "
                                 "not the model's one copy")
    return whole // ranks


def exact_launches(label, got, want):
    """Fail unless ``got`` (a path's launches) is ``want``, every kernel
    ``want`` does not name at 0."""
    if any(n != want.get(k, 0) for k, n in got.items()):
        raise AssertionError(f"{label}: launches {got}, want {want}")


def timed(torch, fn):
    """(``fn()``, its host wall in s between two synchronizes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def pp_generate_part(torch, A, D, lm, card, counters, runs, prompts):
    """Phase 21 (a): ``pipelined_generate`` against ``generate()``."""
    from adapt_tpu_torch.models.transformer_lm import generate
    from adapt_tpu_torch.parallel.pipeline_decode import (
        pipelined_generate,
        shard_for_pipeline,
    )

    steps = 32
    batch, lens = pp_batch(torch, prompts)
    b = len(lens)
    errs = {p: split_prefill_error(torch, lm, batch, lens, p) for p in (2, 4)}
    print(f"phase 21 (a) first-token logits of b/P-row prefills against the "
          f"whole batch's on {card}: P 2 {errs[2]:.4f}, P 4 {errs[4]:.4f}")
    ref, walls, gen = {}, {}, {}
    for kv in ("native", "int8", "int4"):
        out, walls[kv] = timed(torch, lambda kv=kv: counted(
            counters, f"phase 21 generate_{kv}", ("flash_attn_fwd",
                                                  "decode_attn"), runs,
            lambda: generate(lm, batch, steps, prompt_lengths=lens,
                             kv_cache_dtype=kv)))
        gen[kv] = runs[f"phase 21 generate_{kv}"]
        ref[kv] = out.cpu().numpy()
    # Steady decode: the tokens after the first over the wall beyond a
    # prefill-only call's.
    _, one = timed(torch, lambda: generate(lm, batch, 1, prompt_lengths=lens))
    rate = {"generate": b * (steps - 1) / (walls["native"] - one)}
    placed = {}
    for pp, dp, kv in PP_RUNS:
        label = f"phase 21 (a) pp={pp} dp={dp} {kv}"
        mesh = pp_mesh(lm.device, pp, dp)
        if pp not in placed:
            before = torch.cuda.memory_allocated()
            placed[pp] = shard_for_pipeline(lm, pp_mesh(lm.device, pp))
            rank_bytes = pp_weights(torch, lm, placed[pp], pp, label)
            print(f"{label}: each rank holds {lm.depth // pp} blocks, "
                  f"{rank_bytes} bytes ({rank_bytes * pp} the whole), the "
                  "embedding and head are the model's own tensors; device "
                  f"memory allocated by the placement "
                  f"{torch.cuda.memory_allocated() - before} bytes")
        path = f"phase 21 pp{pp}_dp{dp}_{kv}"

        def run(s=steps, kv=kv, mesh=mesh, pp=pp, dp=dp):
            return pipelined_generate(
                lm, placed[pp], batch, s, mesh,
                dp_axis="dp" if dp > 1 else None, prompt_lengths=lens,
                kv_cache_dtype=kv)

        got, wall = timed(torch, lambda: counted(
            counters, path, ("flash_attn_fwd", "decode_attn"), runs, run))
        exact_launches(f"{label} (P x dp x generate()'s)", runs[path],
                       {k: pp * dp * n for k, n in gen[kv].items()})
        got = got.cpu().numpy()
        if got.shape != (b, steps) or not ((got >= 0) & (got < lm.vocab)
                                           ).all():
            raise AssertionError(f"{label}: tokens {got.shape} / bad ids")
        bar = 0.1 if kv == "native" else max(0.1, 2 * errs[pp])
        exempt = hold_pp_streams(torch, lm, label, batch, lens, got, ref[kv],
                                 bar, errs[pp])
        note = ""
        if kv == "native":
            _, one = timed(torch, lambda: run(1))
            rate[label] = b * (steps - 1) / (wall - one)
            note = (f", steady decode {rate[label]:.1f} tok/s against "
                    f"generate()'s {rate['generate']:.1f}")
        print(f"{label} on {card}: {b} ragged streams of {steps} tokens, "
              f"{b - len(exempt)} equal to generate(kv_cache_dtype={kv!r})"
              f", {len(exempt)} tie exemptions, {wall:.3f} s{note}; launches "
              f"{runs[path]} (generate()'s {gen[kv]})")
    print(f"phase 21 (a): on one card the token ring brings no memory relief "
          f"and no speed-up (every rank names cuda:0 and runs in turn); no "
          f"gain is claimed")


def tp_forward_parts(torch, V, vit, x, dev):
    """Where a dp x tp forward's difference from ``graph.apply`` comes
    from: the dp row split alone, tp 2 alone, both (largest logit
    differences)."""
    whole = vit.apply(x).float()
    runs = {"dp2": torch.cat([vit.apply(h) for h in x.chunk(2)]),
            "tp2": V.shard_vit(vit, pp_mesh(dev, 2, axis="tp"))(x),
            "dp2_tp2": V.shard_vit(vit, pp_mesh(dev, 2, 2, axis="tp"))(x)}
    return {k: float((t.float() - whole).abs().max()) for k, t in runs.items()}


def pp_train_part(torch, dev, card, counters, runs):
    """Phase 21 (b) and (c): the ViT-B/16 train step over (dp 2, pp 2), and
    ``shard_vit`` at (dp 2, tp 2), on ``dev``."""
    from adapt_tpu_torch.models import vit as V

    num_micro, lr = 2, 0.005
    gen = torch.Generator().manual_seed(21)
    x = torch.randn(8, 224, 224, 3, generator=gen).to(dev)
    y = torch.randint(0, 1000, (8,), generator=gen).to(dev)
    mesh = pp_mesh(dev, 2, 2)
    vits = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        vit = vits[tag] = V.vit_b16(dtype=dtype, device=dev, seed=0)
        depth = sum(n.startswith("encoder_block_") for n in vit.topo_order())
        want = num_micro * 2 * depth  # microbatches x dp shards x blocks
        w0 = {k: t.clone() for k, t in vit.state_dict().items()}
        _, _, g1 = vit_step(torch, vit, x, y, num_micro, lr)
        vit.load_state_dict(w0)
        n = 1 if tag == "f32" else 3
        path = f"phase 21 vit_dp2_pp2_{tag}"
        losses, times, g2 = counted(
            counters, path, ("flash_attn_fwd", "flash_attn_bwd"), runs,
            lambda: vit_step(torch, vit, x, y, num_micro, lr, steps=n,
                             mesh=mesh))
        vit.load_state_dict(w0)
        exact_launches(path, runs[path], {"flash_attn_fwd": n * want,
                                          "flash_attn_bwd": n * want})
        err = grad_error(torch, g2, g1)
        losses = [float(v) for v in losses]
        if tag == "f32" and not err <= 1e-3:
            raise AssertionError(f"{path}: gradients differ from the "
                                 f"one-rank step's by relative L2 {err:.3e}")
        if tag == "bf16" and not (all(np.isfinite(losses))
                                  and losses[-1] < losses[0]):
            raise AssertionError(f"{path}: losses {losses} not falling")
        print(f"phase 21 (b) ViT-B/16 {tag} train step over (dp 2, pp 2) on "
              f"{card}: batch 8 in {num_micro} microbatches, losses "
              f"{[round(v, 6) for v in losses]}, step {times[-1]:.2f} ms, "
              f"largest relative L2 gradient error vs the one-rank step "
              f"{err:.3e}{' (gate 1e-3)' if tag == 'f32' else ''}, launches "
              f"{runs[path]}")
    tp_mesh = pp_mesh(dev, 2, 2, axis="tp")
    for tag, tol in (("f32", 1e-4), ("bf16", 1e-2)):
        vit = vits[tag]
        path = f"phase 21 vit_dp2_tp2_{tag}"
        with torch.no_grad():
            ref = vit.apply(x).float()
            got = counted(counters, path, ("flash_attn_fwd",), runs,
                          lambda: V.shard_vit(vit, tp_mesh)(x)).float()
            parts = tp_forward_parts(torch, V, vit, x, dev)
        print(f"phase 21 (c) ViT-B/16 {tag} on {card}: largest logit "
              f"difference from graph.apply's: {parts}")
        exact_launches(path, runs[path], {"flash_attn_fwd": 2 * 2 * depth})
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not err <= tol * scale:
            raise AssertionError(f"{path}: logits differ from graph.apply's "
                                 f"by {err:.3e} > {tol} x {scale:.3f}")
        print(f"phase 21 (c) ViT-B/16 {tag} over (dp 2, tp 2) on {card}: "
              f"logits of batch 8 within {err:.3e} of graph.apply's "
              f"(gate {tol} x the largest, {scale:.3f}); launches "
              f"{runs[path]}")


def pp_phase(torch, A, D, lm, card, kernels, prompts):
    """Phase 21: the multi-rank pipelines on the one card (meshes naming
    cuda:0): (a) ``pipelined_generate`` of ``prompts`` (phase 6's first 8)
    on the 12-layer model, (b) the dp x pp ViT-B/16 train step, (c) the
    dp x tp ViT-B/16 forward, (d) ``dryrun_multichip(4)``. Adds
    ``pp_launches`` (phase 21's launches of each kernel, its runs summed)
    to every row of ``kernels``."""
    from adapt_tpu_torch.dryrun import dryrun_multichip

    t_phase = time.perf_counter()
    counters = {"flash_attn_fwd": A.flash_attn_fwd,
                "decode_attn": D.decode_attn,
                "flash_attn_bwd": A.flash_attn_bwd}
    runs: dict = {}
    marks = [time.perf_counter()]
    pp_generate_part(torch, A, D, lm, card, counters, runs, prompts)
    marks.append(time.perf_counter())
    pp_train_part(torch, lm.device, card, counters, runs)
    marks.append(time.perf_counter())
    res = counted(counters, "phase 21 dryrun", ("flash_attn_fwd",
                                                "flash_attn_bwd"), runs,
                  lambda: dryrun_multichip(4, [lm.device] * 4))
    print(f"phase 21 (d) dryrun_multichip(4) on {card} (4 entries naming "
          f"{lm.device}): {res}; launches {runs['phase 21 dryrun']}")
    marks.append(time.perf_counter())
    totals: dict = {}
    for path, launches in runs.items():
        if "generate_" in path:
            continue  # the references, not a phase 21 path
        kind = next((k for k in ("int8", "int4") if path.endswith(k)),
                    "vit" if "vit" in path or "dryrun" in path else "native")
        for k, n in launches.items():
            if k in PP_ROWS[kind]:
                row = PP_ROWS[kind][k]
                totals[row] = totals.get(row, 0) + n
    for kr in kernels:
        kr["pp_launches"] = totals.get(kr["name"], 0)
    print(f"phase 21 launches by path: {json.dumps(runs)}")
    took = ", ".join(f"({part}) {b - a:.1f}"
                     for part, a, b in zip(("a", "b-c", "d"), marks,
                                           marks[1:]))
    print(f"phase 21 (multi-rank pipelines) took "
          f"{time.perf_counter() - t_phase:.1f} s on {card} ({took})")


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

    # -- phase 16: pipelined decode, disaggregated prefill, host KV tier ---
    fleet_phase(torch, A, D, P, lm, card, kernels, solo, (wave1, wave2))

    # -- phase 17: the fleet router and autoscaler ------------------------
    router_phase(torch, A, D, P, lm, card, kernels, solo, (wave1, wave2),
                 qbar)

    # -- phase 18: tensor-parallel shards on one card ----------------------
    lm32, bar, slms = tp_phase(torch, A, D, P, Q, lm, draft2, card, kernels,
                               solo, prompts, (wave1, wave2), qbar)

    # -- phase 19: elastic recovery of the tensor-parallel batcher ---------
    recovery_phase(torch, A, D, P, Q, lm, draft2, lm32, slms[4], card,
                   kernels, prompts, bar, qbar)

    # -- phase 20: sequence parallelism ------------------------------------
    sp_phase(torch, A, lm, lm32, slms[2], card, kernels, (wave1, wave2), bar,
             qbar)

    # -- phase 21: the multi-rank pipelines -------------------------------
    pp_phase(torch, A, D, lm, card, kernels, prompts[:8])

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
