#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``adapt_tpu_torch``).

    python3 chip_smoke.py            # the whole check, one CUDA card
    python3 chip_smoke.py --profile  # and a torch.profiler decode breakdown

Phases (no phase failure is caught; any mismatch exits non-zero):

1. the card's name and power limit, torch/CUDA versions; build every
   kernel from ``adapt_tpu_torch/csrc`` (one nvcc per source, in parallel);
2. K1 (``flash_attn_fwd``) against its plain version in bf16 at the
   prefill shapes of the main path, plus ragged, ``valid_from``, window and
   head_dim-128 cases;
3. K2 (``decode_attn``) and K2-split (``decode_attn_split``, split 4)
   against the plain version on the batcher's dense strip (L = 1025), plus
   GQA and ``valid_from`` cases, and split 1 against split 4;
4. GPT-2-small widths (50257 / 768 / 12 layers / 12 heads / 3072, learned
   positions, max_len 1024, bf16, random weights from seed 0):
   ``generate()`` on 4 ragged prompts, then a ``ContinuousBatcher(slots=8,
   chunk=8)`` answering 16 requests (prompts 16-512, 64 new tokens, two
   staggered waves, one cancel), then the same batcher with
   ``KernelConfig(decode_split=4)`` on 8 requests. Launch counts are set
   to 0 just before each batcher path and read just after; every stream
   must equal the port's own ``generate()`` for that prompt alone;
5. each kernel timed at its main-path shape with CUDA events, beside its
   plain version, one PyTorch library call of the same function
   (``scaled_dot_product_attention``, which the port never calls) and its
   bound: max(operations / 989 TFLOP/s, bytes / 3.35 TB/s).

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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


def drive_batcher(torch, lm, prompts, steps, kernel, cancel_at):
    """Serve ``prompts`` in two staggered waves; cancel request
    ``cancel_at`` (if not None) once it is live. Returns (results,
    request ids, cancelled id, wall s, committed tokens, mean TTFT s)."""
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
    from adapt_tpu_torch.utils.metrics import global_metrics

    reg = global_metrics()
    before = reg.snapshot(window=True)
    bat = ContinuousBatcher(lm, slots=8, chunk=8, kernel=kernel)
    half = len(prompts) // 2
    t0 = time.perf_counter()
    ids = [bat.submit(p, steps) for p in prompts[:half]]
    bat.tick()
    bat.tick()
    ids += [bat.submit(p, steps) for p in prompts[half:]]
    cancelled = None
    if cancel_at is not None:
        cancelled = ids[cancel_at]
        bat.cancel(cancelled)
    out = bat.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    win = reg.snapshot(since=before)
    ttft = win["histograms"].get("continuous.ttft_s", {}).get("mean", 0.0)
    tokens = sum(len(v) for v in out.values())
    return out, ids, cancelled, wall, tokens, ttft


def profile_decode(torch, lm, card):
    """``--profile``: where a steady decode tick's time goes. 8 slots
    decode (chunk 8, 256-token prompts); 4 ticks are timed on the host
    clock without the profiler, then 4 more run under ``torch.profiler``
    for device time by kernel. Busy share = kernel time / unprofiled
    wall."""
    from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

    rng = torch.Generator().manual_seed(5)
    bat = ContinuousBatcher(lm, slots=8, chunk=8)
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
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops: their kernels are listed themselves
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0:
            rows.append((dev / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    steps = 4 * bat.chunk
    print(f"profile on {card}: 4 steady ticks = {steps} decode steps of 8 "
          f"slots: wall {wall_ms:.2f} ms ({wall_ms / steps:.3f} ms/step, "
          f"{8 * steps / wall_ms * 1e3:.1f} tok/s); kernels "
          f"{busy:.2f} ms = {busy / wall_ms:.3f} of the wall "
          f"({sum(r[1] for r in rows) / steps:.0f} launches/step)")
    for ms, n, key in rows[:15]:
        print(f"  {ms:9.3f} ms  {n:6d} x  {key[:90]}")


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
    from adapt_tpu_torch.config import KernelConfig
    from adapt_tpu_torch.models.transformer_lm import generate, transformer_lm
    from adapt_tpu_torch.ops import _build
    from adapt_tpu_torch.ops import attention as A
    from adapt_tpu_torch.ops import decode_attention as D

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"kernels built from adapt_tpu_torch/csrc in {_build.build_all():.1f} s")

    errs: dict[str, float] = {}
    check_k1(torch, A, dev, errs)
    check_k2(torch, D, dev, errs)
    # -- phase 4: the full-width path ------------------------------------
    VOCAB, DIM, DEPTH, HEADS, MLP = 50257, 768, 12, 12, 3072
    t0 = time.perf_counter()
    lm = transformer_lm(VOCAB, DIM, DEPTH, HEADS, MLP, max_len=1024,
                        dtype=torch.bfloat16, name="gpt2_small", seed=0)
    print(f"GPT-2-small widths built in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in lm.parameters())} parameters)")
    rng = torch.Generator().manual_seed(0)
    lens = [37, 64, 100, 23]
    prompt = torch.randint(0, VOCAB, (4, max(lens)), generator=rng)
    toks = generate(lm, prompt, 32, prompt_lengths=lens)
    torch.cuda.synchronize()
    if toks.shape != (4, 32) or not bool(((toks >= 0) & (toks < VOCAB)).all()):
        return _fail(f"ragged generate gave {tuple(toks.shape)} / bad ids")
    print(f"generate: 4 ragged prompts {lens}, 32 tokens each, ids in range")

    plens = torch.randint(16, 513, (16,), generator=rng).tolist()
    prompts = [torch.randint(0, VOCAB, (n,), generator=rng).numpy()
               for n in plens]
    runs = {}
    for path, kernel, reqs, cancel_at in (
        ("main", KernelConfig(), prompts, 3),
        ("split4", KernelConfig(decode_split=4), prompts[:8], None),
    ):
        A.flash_attn_fwd.launches = 0
        D.decode_attn.launches = 0
        D.decode_attn_split.launches = 0
        out, ids, cancelled, wall, ntok, ttft = drive_batcher(
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
            ref = generate(lm, p[None], 64,
                           decode_split=kernel.decode_split)[0].cpu().numpy()
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

    # -- phase 5: kernel times at main-path shapes -------------------------
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
    if "--profile" in argv:
        profile_decode(torch, lm, card)
    for kr in kernels:
        print(f"{kr['name']} on {card}: {kr['ms']:.4f} ms (plain "
              f"{kr['plain_ms']:.4f}, sdpa {kr['library_ms']:.4f}, bound "
              f"{kr['bound_ms']:.4f} by {kr['bound_by']}) at {kr['shape']}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
