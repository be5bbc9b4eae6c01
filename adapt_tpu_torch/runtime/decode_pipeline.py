"""Fault-tolerant pipelined decode sessions: generation over stage workers,
with replay — the port of ``adapt_tpu/runtime/decode_pipeline.py``.

Decoder stages run on :class:`~adapt_tpu_torch.control.worker.StageWorker`
s (device-owning executors with heartbeats, kill modes and a deadline
watchdog), microbatches flow through them concurrently, and a worker that
crashes or hangs MID-DECODE is replaced without losing the session.

Decode stages carry state: each holds its blocks' KV caches, advanced one
position a pass, so a lost worker loses cache state later passes need.
Recovery is REPLAY: the committed tokens are a complete recipe for every
stage's caches. Prefill plus "forced" decode passes that feed the known
tokens rebuild them on the replacement, through the same stage programs
(``DecoderBlock.prefill``, K1 on the card, and ``decode_step``, K2 / K2q).
Exactly-once is structural: a token is appended once per (microbatch, pass)
by the single event loop, and results of an earlier epoch are dropped by
their tag.

Scheduling: an event loop drives M microbatches through K stage workers,
submitting (m, k + 1) the moment (m, k) completes, so stage k runs
microbatch m while stage k - 1 runs m + 1. Sampling runs on the event
loop's thread with ``models.transformer_lm``'s per-row keys, and every
stage runs the shapes ``generate()`` runs (the prompt padded to its
power-of-two bucket, caches of ``max_len + 1`` positions, decode rows
padded to a multiple of ``ROW_QUANTUM``), so the output is token for token
``generate()``'s, under mid-decode kills too.

On one card the stage workers share the device (``devices`` defaults to
the card once per stage plus one spare); their launches serialize on the
interpreter, so this path is about recovery, not speed.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import queue
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adapt_tpu_torch import resolve_device
from adapt_tpu_torch.config import FaultConfig
from adapt_tpu_torch.control.registry import WorkerRegistry
from adapt_tpu_torch.control.worker import StageWorker, Task, TaskResult
from adapt_tpu_torch.models.transformer_lm import (
    ROW_QUANTUM,
    TransformerLM,
    _left_align,
    map_cache,
    prompt_bucket,
    sample_next_tokens,
    validate_generate_args,
)
from adapt_tpu_torch.utils.logging import get_logger
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.tracing import global_flight_recorder, global_tracer

log = get_logger("decode_pipeline")


class _ReplayFailure(RuntimeError):
    """A replay step failed (its worker died or hung mid-recovery); names
    the stage to recover next, so the session's retry loop (not the
    caller) handles cascading faults."""

    def __init__(self, stage: int, message: str):
        super().__init__(message)
        self.stage = stage


def _to(x, device):
    """Tensors of a payload tree moved to ``device`` (a no-op there)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        return tuple(_to(t, device) for t in x)
    return x


@dataclasses.dataclass(frozen=True)
class _PrefillPass:
    """Stage input of a prefill pass: token ids (stage 0: the prompt padded
    to its bucket) or the previous stage's hidden states; the ragged
    positions (stage 0) and left-pad counts; ``s0`` the prompt width."""

    x: Any
    pos_ids: Any
    vf: Any
    s0: int

    def to(self, device) -> "_PrefillPass":
        return _PrefillPass(_to(self.x, device), _to(self.pos_ids, device),
                            _to(self.vf, device), self.s0)


@dataclasses.dataclass(frozen=True)
class _DecodePass:
    """Stage input of a decode pass: the fed tokens (stage 0, one a row) or
    hidden states, the stage's caches, the cache index of this position
    and the decode rows' left-pad counts."""

    x: Any
    caches: tuple
    index: int
    vf: Any

    def to(self, device) -> "_DecodePass":
        return _DecodePass(_to(self.x, device), _to(self.caches, device),
                           self.index, _to(self.vf, device))


class _StageModule(nn.Module):
    """One decoder stage as a worker binding: its blocks (and the embedding
    on the first stage, the head on the last) under the LM's own names, so
    its state dict is the LM's, cut. ``forward`` runs a
    :class:`_PrefillPass` or a :class:`_DecodePass`."""

    def __init__(self, mods: dict[str, nn.Module], names: list[str],
                 max_len: int, kv_quant):
        super().__init__()
        for name, m in mods.items():
            self.add_module(name, m)
        self.names = names
        self.first = "embed" in mods
        self.last = "head" in mods
        self.max_len = max_len
        self.kv_quant = kv_quant

    def load_stage_state(self, state: dict) -> "_StageModule":
        self.load_state_dict(state)
        return self

    def forward(self, p):
        if isinstance(p, _PrefillPass):
            return self.prefill(p)
        return self.decode(p)

    def prefill(self, p: _PrefillPass):
        if self.first:
            h = (self.embed(p.x) if p.pos_ids is None
                 else self.embed.embed_positions(p.x, p.pos_ids))
        else:
            h = p.x
        caches = []
        # Decode rows are padded to ROW_QUANTUM, as generate() pads them.
        pad = -h.shape[0] % ROW_QUANTUM
        for name in self.names:
            h, ck, cv = getattr(self, name).prefill(
                h, self.max_len + 1, p.vf, self.kv_quant)
            caches.append(tuple(map_cache(
                lambda t: F.pad(t, (0, 0, 0, 0, 0, 0, 0, pad)), c)
                for c in (ck, cv)))
        out = self.head(h[:, p.s0 - 1:p.s0])[:, 0] if self.last else h
        return out, tuple(caches)

    def decode(self, p: _DecodePass):
        x = p.x
        first_cache = p.caches[0][0]
        rows = (first_cache[0] if isinstance(first_cache, tuple)
                else first_cache).shape[0]
        idx = torch.full((rows,), p.index, dtype=torch.int32, device=x.device)
        if self.first:
            tok = F.pad(x, (0, rows - x.shape[0]))
            pos = idx if p.vf is None else idx - p.vf
            x = self.embed.embed_positions(tok[:, None], pos[:, None])
        for name, (ck, cv) in zip(self.names, p.caches):
            x, _, _ = getattr(self, name).decode_step(x, ck, cv, idx, p.vf)
        out = self.head(x)[:, 0] if self.last else x
        return out, p.caches


def _meta_copy(mods: dict[str, nn.Module]) -> dict[str, nn.Module]:
    """Copies of ``mods`` whose parameters and buffers live on the meta
    device (a worker's ``configure`` allocates them on its own device and
    loads the stage's weights)."""
    memo: dict = {}
    for m in mods.values():
        for p in m.parameters():
            memo[id(p)] = nn.Parameter(p.detach().to("meta"),
                                       requires_grad=False)
        for b in m.buffers():
            memo[id(b)] = b.detach().to("meta")
    return copy.deepcopy(mods, memo)


@dataclasses.dataclass(frozen=True)
class _StageProgram:
    """One stage: a meta-device template of its module (a replacement
    worker takes a fresh copy of it and the same weights; nothing else is
    built) and its weights, the LM's own tensors (the rebind source)."""

    index: int
    first: bool
    last: bool
    block_range: tuple[int, int]
    module: _StageModule
    variables: dict


def _build_stage_programs(lm: TransformerLM, boundaries: Sequence[int],
                          kv_quant: bool = False) -> list[_StageProgram]:
    """Cut the decoder into stages at block ``boundaries`` (stage i runs
    blocks [boundaries[i], boundaries[i + 1])); stage 0 owns the
    embedding, the last stage the head. ``kv_quant`` keeps the stage
    caches int8 (generate()'s scheme), which replay rebuilds
    identically."""
    edges = [0, *boundaries, lm.depth]
    if any(b <= a for a, b in zip(edges, edges[1:])):
        raise ValueError(f"boundaries {list(boundaries)} must be strictly "
                         f"increasing within (0, {lm.depth})")
    n_stages = len(edges) - 1
    state = {k: v.detach() for k, v in lm.state_dict().items()}
    programs = []
    for i in range(n_stages):
        lo, hi = edges[i], edges[i + 1]
        first, last = i == 0, i == n_stages - 1
        names = lm.block_names[lo:hi]
        mods = {n: getattr(lm, n) for n in names}
        if first:
            mods = {"embed": lm.embed, **mods}
        if last:
            mods["head"] = lm.head
        keys = tuple(f"{n}." for n in mods)
        programs.append(_StageProgram(
            index=i, first=first, last=last, block_range=(lo, hi),
            module=_StageModule(_meta_copy(mods), names, lm.max_len,
                                "int8" if kv_quant else False),
            variables={k: v for k, v in state.items() if k.startswith(keys)},
        ))
    return programs


@dataclasses.dataclass
class _MicrobatchState:
    """Where one microbatch is in its token loop."""

    prompt: Any  # its prompt ids padded to the bucket (the replay anchor)
    tokens: list  # committed sampled tokens, (mb,) int64 arrays
    done_rows: np.ndarray  # EOS latch per row
    caches: list  # per-stage caches (on the stage's device)
    phase: str = "prefill"  # prefill | decode | finished
    stage: int = 0  # stage currently (or next) running
    passno: int = 0  # decode pass number (consumes token `passno`)
    carry: Any = None  # activation flowing between stages
    pos_ids: Any = None  # ragged: per-row positions over the bucket
    vf: Any = None  # ragged: per-row left-pad counts (mb,)
    vf_dec: Any = None  # the same padded to the decode rows


class PipelinedDecoder:
    """Multi-stage KV-cache generation over stage workers, with failover.

    ``boundaries`` are block cut points (``[2]`` splits a 4-block LM into
    two stages of two blocks). Stage i runs on ``devices[i]``; devices
    beyond the stage count are failover spares (a stage whose worker dies
    rebinds to the next spare, else doubles up on a survivor). ``devices``
    None means the CUDA card once per stage plus one spare (raising without
    a card); pass CPU devices to run on the CPU."""

    def __init__(self, lm: TransformerLM, boundaries: Sequence[int],
                 devices: Sequence | None = None,
                 fault: FaultConfig | None = None,
                 kv_cache_dtype: str = "native"):
        self.lm = lm
        self.fault = fault or FaultConfig()
        if kv_cache_dtype not in ("native", "int8"):
            raise ValueError(f"kv_cache_dtype={kv_cache_dtype!r}: expected "
                             "'native' or 'int8'")
        self.kv_cache_dtype = kv_cache_dtype
        self.programs = _build_stage_programs(
            lm, boundaries, kv_quant=kv_cache_dtype == "int8")
        if devices is None:
            devices = [resolve_device(None)] * (len(self.programs) + 1)
        devices = [resolve_device(d) for d in devices]
        if not devices:
            raise ValueError("no devices")
        self._spares = devices[len(self.programs):]
        self._stage_devices = [devices[i % len(devices)]
                               for i in range(len(self.programs))]
        self.registry = WorkerRegistry(default_ttl_s=self.fault.lease_ttl_s)
        self.results: "queue.Queue[TaskResult]" = queue.Queue()
        self._wid = itertools.count()
        self._rid = itertools.count()
        self.epoch = 0
        #: One record a recovery: stage, epoch, and its start and end on
        #: the ``time.monotonic`` clock.
        self.recovery_log: list[dict] = []
        self.workers: list[StageWorker] = [
            self._spawn(i, self._stage_devices[i])
            for i in range(len(self.programs))
        ]

    # -- workers -----------------------------------------------------------

    def _spawn(self, stage: int, device) -> StageWorker:
        w = StageWorker(
            worker_id=f"decode-w{next(self._wid)}-s{stage}", device=device,
            registry=self.registry, result_queue=self.results,
            fault=self.fault,
        ).start()
        prog = self.programs[stage]
        # One binding a stage (prefill and decode passes share its one
        # weight copy): a fresh meta copy of the template, allocated on
        # the worker's device and loaded there.
        w.configure(stage, copy.deepcopy(prog.module), prog.variables)
        return w

    def kill_worker(self, stage: int, mode: str = "crash") -> None:
        """Chaos hook: kill the worker serving a stage."""
        self.workers[stage].kill(mode)

    def shutdown(self) -> None:
        for w in self.workers:
            w.stop()

    def __enter__(self) -> "PipelinedDecoder":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- generation --------------------------------------------------------

    @torch.no_grad()
    def generate(self, prompt, steps: int, temperature: float = 0.0,
                 top_k: int | None = None, top_p: float | None = None,
                 eos_id: int | None = None, rng: int | None = None,
                 prompt_lengths=None, num_microbatches: int | None = None,
                 on_token: Callable[[int, int], None] | None = None,
                 ) -> np.ndarray:
        """``generate()`` token for token, served through the stage
        workers with mid-decode failover; returns (b, steps) int64 ids.
        ``on_token(m, s)`` fires after microbatch ``m`` commits token
        ``s`` (a test and chaos hook). Covers the sampling knobs, EOS,
        ragged prompts (``prompt_lengths``) and int8 stage caches."""
        prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(
            prompt) else prompt).to("cpu", torch.int64)
        b, s0 = prompt.shape
        lengths, seed, do_sample = validate_generate_args(
            self.lm, prompt, steps, temperature, top_k, rng, prompt_lengths,
            self.kv_cache_dtype, top_p=top_p)
        bucket = prompt_bucket(s0, self.lm.max_len)
        if prompt_lengths is not None:
            aligned, pos, valid_from = _left_align(prompt, lengths)
            ids = F.pad(aligned, (0, bucket - s0))
            tail = pos[:, -1:] + torch.arange(1, bucket - s0 + 1)[None, :]
            pos_ids = torch.cat([pos, tail], 1)
        else:
            ids = F.pad(prompt, (0, bucket - s0))
            pos_ids = valid_from = None
        n_stages = len(self.programs)
        M = num_microbatches or max(
            d for d in range(1, min(b, n_stages) + 1) if b % d == 0)
        if b % M:
            raise ValueError(f"batch {b} not divisible by {M} microbatches")
        mb = b // M
        rows = -(-mb // ROW_QUANTUM) * ROW_QUANTUM

        def cut(t, m):
            return None if t is None else t[m * mb:(m + 1) * mb]

        states = []
        for m in range(M):
            vf = cut(valid_from, m)
            states.append(_MicrobatchState(
                prompt=cut(ids, m), tokens=[],
                done_rows=np.zeros((mb,), bool), caches=[None] * n_stages,
                carry=cut(ids, m), pos_ids=cut(pos_ids, m), vf=vf,
                vf_dec=None if vf is None else F.pad(vf, (0, rows - mb)),
            ))
        # rid -> (deadline, microbatch, stage, submit perf-time)
        deadlines: dict[int, tuple[float, int, int, float]] = {}
        # Consecutive unrecovered faults (reset by any progress): bounds a
        # flapping stage without capping independent faults.
        consecutive_failures = 0

        def sample(m: int, logits, step: int):
            st = states[m]
            toks = sample_next_tokens(
                logits[:mb].float(), seed, step, temperature,
                do_sample=do_sample, top_k=top_k, top_p=top_p,
                row_offset=m * mb).cpu().numpy()
            if eos_id is not None:
                toks = np.where(st.done_rows, eos_id, toks)
                st.done_rows = st.done_rows | (toks == eos_id)
            st.tokens.append(toks)
            if on_token is not None:
                on_token(m, len(st.tokens) - 1)

        def payload(st, stage: int, x):
            if st.phase == "prefill":
                return _PrefillPass(x, st.pos_ids if stage == 0 else None,
                                    st.vf, s0)
            return _DecodePass(x, st.caches[stage], s0 + st.passno, st.vf_dec)

        def submit(m: int) -> None:
            st = states[m]
            rid = next(self._rid)
            # Stage workers drain their inboxes serially: the deadline
            # scales with the tasks already ahead.
            depth_ahead = self.workers[st.stage].queue_depth
            deadlines[rid] = (
                time.monotonic()
                + self.fault.task_deadline_s * (depth_ahead + 1),
                m, st.stage, time.perf_counter())
            self.workers[st.stage].submit(Task(
                request_id=rid, stage_index=st.stage, attempt=self.epoch,
                payload=payload(st, st.stage, st.carry)))

        def advance(m: int, output, caches) -> None:
            """One (m, stage) result: store its caches, route onward."""
            nonlocal consecutive_failures
            consecutive_failures = 0
            st = states[m]
            st.caches[st.stage] = caches
            if st.stage < n_stages - 1:
                st.carry = output
                st.stage += 1
                submit(m)
                return
            if st.phase == "prefill":
                sample(m, output, 0)
                st.phase, st.passno = "decode", 0
            else:
                sample(m, output, st.passno + 1)
                st.passno += 1
            if len(st.tokens) >= steps:
                st.phase = "finished"
                return
            st.stage = 0
            st.carry = torch.as_tensor(st.tokens[-1])
            submit(m)

        for m in range(M):
            submit(m)

        while any(st.phase != "finished" for st in states):
            try:
                res = self.results.get(timeout=self.fault.watchdog_period_s)
            except queue.Empty:
                res = None
            failed_stage = None
            if res is not None:
                if (res.attempt != self.epoch
                        or res.request_id not in deadlines):
                    continue  # an earlier epoch's, or a recovered task's
                _, m, stage, t_sub = deadlines.pop(res.request_id)
                if res.error is not None:
                    log.error("decode stage %d failed: %s", stage, res.error)
                    failed_stage = stage
                else:
                    tracer = global_tracer()
                    if tracer.enabled:
                        tracer.add_span(
                            "decode.pass", start=t_sub, end=tracer.now(),
                            request=res.request_id, attempt=res.attempt,
                            microbatch=m, stage=stage)
                    advance(m, *res.output)
            if failed_stage is None:
                now = time.monotonic()
                for _rid, (t, _m, stage, _t0) in deadlines.items():
                    if t < now:
                        failed_stage = stage
                        log.warning("decode stage %d missed its deadline "
                                    "(worker %s dead or hung)", stage,
                                    self.workers[stage].worker_id)
                        global_flight_recorder().record(
                            "decode_deadline_miss", stage=stage,
                            worker=self.workers[stage].worker_id)
                        break
            if failed_stage is not None:
                # A replay can hit a second fault; _ReplayFailure routes
                # that stage back here while the retry budget lasts.
                while failed_stage is not None:
                    consecutive_failures += 1
                    if consecutive_failures > self.fault.max_retries:
                        raise RuntimeError(
                            f"decode session failed: stage {failed_stage} "
                            f"unrecoverable after {self.fault.max_retries} "
                            "consecutive retries")
                    try:
                        self._recover(failed_stage, states, s0, deadlines)
                        failed_stage = None
                    except _ReplayFailure as e:
                        log.error("replay hit a second fault: %s", e)
                        failed_stage = e.stage
                # Re-drive every unfinished microbatch from stage 0 of its
                # current pass (replay restored every pre-pass cache).
                for st_m, st in enumerate(states):
                    if st.phase == "finished":
                        continue
                    st.stage = 0
                    st.carry = (torch.as_tensor(st.tokens[-1])
                                if st.phase == "decode" else st.prompt)
                    submit(st_m)

        out = np.stack([np.stack(st.tokens, axis=1) for st in states], 0)
        return out.reshape(b, steps)

    # -- recovery ----------------------------------------------------------

    def _recover(self, stage: int, states, s0: int, deadlines) -> None:
        """Replace the stage's worker and rebuild the mid-decode
        microbatches' caches by replaying their committed tokens (prefill
        plus forced decode passes through the same stage programs). The
        epoch bump invalidates every result in flight; microbatches still
        in prefill need no replay (the event loop re-drives them) and
        finished ones need no caches."""
        t0 = time.monotonic()
        self.epoch += 1
        deadlines.clear()
        dead = self.workers[stage]
        dead.kill("crash")  # also silences a hung worker's exec loop
        self.registry.deregister(dead.worker_id)
        device = (self._spares.pop(0) if self._spares
                  else self._stage_devices[(stage + 1)
                                           % len(self._stage_devices)])
        self._stage_devices[stage] = device
        self.workers[stage] = self._spawn(stage, device)
        global_metrics().inc("decode.recoveries")

        def run(stage_idx, pas):
            """One synchronous replay step. The event loop is parked here,
            so this is the results queue's only reader; stragglers of an
            earlier epoch are dropped by (rid, epoch)."""
            worker = self.workers[stage_idx]
            rid = next(self._rid)
            # Earlier tasks may still sit in this worker's inbox (their
            # results are dropped, but they run): scale the wait.
            depth_ahead = worker.queue_depth
            worker.submit(Task(request_id=rid, stage_index=stage_idx,
                               attempt=self.epoch, payload=pas))
            deadline = time.monotonic() + self.fault.task_deadline_s * (
                depth_ahead + 1)
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise _ReplayFailure(
                        stage_idx, f"replay timed out on stage {stage_idx}")
                try:
                    res = self.results.get(timeout=remaining)
                except queue.Empty:
                    continue
                if res.request_id != rid or res.attempt != self.epoch:
                    continue  # a straggler from before the recovery
                if res.error is not None:
                    raise _ReplayFailure(
                        stage_idx,
                        f"replay failed on stage {stage_idx}: {res.error}")
                return res.output

        n_stages = len(self.programs)
        for st in states:
            if st.phase != "decode":
                continue
            # Prefill over the prompt rebuilds every stage's [0, s0)...
            x = st.prompt
            for k in range(n_stages):
                x, st.caches[k] = run(k, _PrefillPass(
                    x, st.pos_ids if k == 0 else None, st.vf, s0))
            # ...then forced passes replay committed tokens 0 .. n - 2 (the
            # last one is fed by the pass the event loop re-drives).
            for p in range(len(st.tokens) - 1):
                x = torch.as_tensor(st.tokens[p])
                for k in range(n_stages):
                    x, st.caches[k] = run(k, _DecodePass(
                        x, st.caches[k], s0 + p, st.vf_dec))
        t1 = time.monotonic()
        self.recovery_log.append(dict(stage=stage, epoch=self.epoch,
                                      start=t0, end=t1))
        log.warning("decode session recovered stage %d in %.2fs (epoch %d)",
                    stage, t1 - t0, self.epoch)
        global_flight_recorder().record(
            "decode_recovery", stage=stage, epoch=self.epoch,
            worker=self.workers[stage].worker_id,
            duration_s=round(t1 - t0, 4))
