"""Mixture-of-experts MLPs with static routing — the port of
``adapt_tpu/models/moe.py``.

Routing (top-k, k in {1, 2}): a softmax gate over the experts in f32; a
token's choices are the argmax, then the argmax of the rest. Expert
parameters are stacked on a leading expert axis with the JAX package's
names and layouts — ``gate`` (d, E), ``w1`` (E, d, hidden), ``b1`` (E,
hidden), ``w2`` (E, hidden, d), ``b2`` (E, d) — so ``convert.from_flax``
carries them across as they are.

- :class:`MoEDecoderMlp` — the serving layer: dropless and per token,
  each token's output is ``sum_{e in its top-k} gate_e * MLP_e(token)``
  in masked-dense form (every expert evaluates every token through
  expert-stacked ``torch.einsum`` products; the combine weights zero the
  rest). A token's output depends on its own hidden state only, so the
  cached decode, verify and chunked-prefill schedules agree with the full
  forward, and a row's bits do not depend on its batch.
- :class:`MoEMlp` — the training layer: capacity routing (``capacity =
  ceil(cf * N * k / E)`` slots an expert, tokens past it dropped), dispatch
  and combine as one-hot einsums.

Both record the Switch load-balance loss, ``mean(fraction_tokens *
fraction_probs) * E`` over first choices (1.0 at perfect balance), as
``aux_loss`` after each call. The expert products stay library matmuls, as
in the JAX package (no Pallas kernel there either).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class _ExpertParams(nn.Module):
    """The expert-stacked parameter block both MoE layers share (one
    declaration: same names, shapes and dtypes). The gate is f32; the
    expert weights are held in the compute dtype."""

    def __init__(self, dim, num_experts, hidden_dim, dtype, device):
        super().__init__()
        if num_experts < 1:
            raise ValueError(f"num_experts must be >= 1, got {num_experts}")
        kw = dict(dtype=dtype, device=device)
        self.num_experts, self.hidden_dim, self.dtype = (
            num_experts, hidden_dim, dtype)
        self.gate = nn.Parameter(torch.zeros(dim, num_experts,
                                             device=device))
        self.w1 = nn.Parameter(torch.zeros(num_experts, dim, hidden_dim,
                                           **kw))
        self.b1 = nn.Parameter(torch.zeros(num_experts, hidden_dim, **kw))
        self.w2 = nn.Parameter(torch.zeros(num_experts, hidden_dim, dim,
                                           **kw))
        self.b2 = nn.Parameter(torch.zeros(num_experts, dim, **kw))
        self.aux_loss: torch.Tensor | None = None

    def _gates(self, tokens):
        """Softmax gate probabilities (N, E) in f32."""
        return torch.softmax(tokens.float() @ self.gate.float(), dim=-1)


def _check_top_k(top_k: int, num_experts: int) -> None:
    if top_k not in (1, 2):
        raise ValueError(f"top_k must be 1 or 2, got {top_k}")
    if top_k > num_experts:
        # A second pick over a fully masked gate row would re-select
        # expert 0 and double its weight.
        raise ValueError(f"top_k {top_k} exceeds num_experts {num_experts}")


def _topk_combine(gates, top_k: int):
    """Per-token top-k gate weights (N, E) — chosen entries carry their
    gate probability, the rest zero — and the first choice's one-hot."""
    combine = torch.zeros_like(gates)
    first_onehot = None
    remaining = gates
    for choice in range(top_k):
        idx = torch.argmax(remaining, dim=-1)
        onehot = F.one_hot(idx, gates.shape[-1]).to(gates.dtype)
        if choice == 0:
            first_onehot = onehot
        combine = combine + onehot * gates
        remaining = remaining * (1.0 - onehot)
    return combine, first_onehot


def _switch_aux_loss(gates, first_onehot):
    """The load-balance loss over first choices (1.0 at balance)."""
    e = gates.shape[-1]
    importance = first_onehot.sum(dim=0)
    frac_tokens = importance / torch.clamp(importance.sum(), min=1.0)
    return (frac_tokens * gates.mean(dim=0)).sum() * e


def _one_hot_routing(gates, capacity: int, top_k: int):
    """(dispatch (N, E, C), combine (N, E, C), aux loss) from gate
    probabilities (N, E): a token's slot is its prefix count in its
    expert's queue (after earlier choices' kept tokens); tokens past
    ``capacity`` are dropped."""
    n, e = gates.shape
    dispatch = torch.zeros(n, e, capacity, dtype=gates.dtype,
                           device=gates.device)
    combine = torch.zeros_like(dispatch)
    remaining = gates
    base_count = torch.zeros(e, dtype=torch.int64, device=gates.device)
    first_onehot = None
    for choice in range(top_k):
        idx = torch.argmax(remaining, dim=-1)
        onehot = F.one_hot(idx, e).to(gates.dtype)
        if choice == 0:
            first_onehot = onehot
        prob = (gates * onehot).sum(dim=-1)
        pos = (torch.cumsum(onehot, dim=0) - 1.0
               + base_count[None, :].to(gates.dtype)) * onehot
        slot = pos.sum(dim=-1).to(torch.int64)
        keep = slot < capacity
        d = (onehot[:, :, None]
             * F.one_hot(torch.clamp(slot, max=capacity - 1),
                         capacity).to(gates.dtype)[:, None, :]
             * keep[:, None, None].to(gates.dtype))
        dispatch = dispatch + d
        combine = combine + d * prob[:, None, None]
        base_count = base_count + (onehot * keep[:, None].to(gates.dtype)
                                   ).sum(dim=0).to(torch.int64)
        remaining = remaining * (1.0 - onehot)
    return dispatch, combine, _switch_aux_loss(gates, first_onehot)


class MoEDecoderMlp(_ExpertParams):
    """Dropless per-token MoE for the serving paths: (b, s, d) -> (b, s,
    d), masked-dense (see the module doc)."""

    def __init__(self, dim, num_experts=8, hidden_dim=128, top_k=1,
                 dtype=torch.float32, device=None):
        _check_top_k(top_k, num_experts)
        super().__init__(dim, num_experts, hidden_dim, dtype, device)
        self.top_k = top_k

    def forward(self, x):
        b, s, d = x.shape
        tokens = x.reshape(b * s, d)
        gates = self._gates(tokens)
        combine, first_onehot = _topk_combine(gates, self.top_k)
        self.aux_loss = _switch_aux_loss(gates, first_onehot)
        dt = self.dtype
        xt = tokens.to(dt)
        h = F.gelu(torch.einsum("nd,edh->neh", xt, self.w1.to(dt))
                   + self.b1[None].to(dt), approximate="tanh")
        out_e = (torch.einsum("neh,ehd->ned", h, self.w2.to(dt))
                 + self.b2[None].to(dt))
        out = torch.einsum("ned,ne->nd", out_e, combine.to(dt))
        return out.reshape(b, s, d).to(x.dtype)


class MoEMlp(_ExpertParams):
    """Token-routed expert MLP with a static per-expert capacity: (b, s,
    d) -> (b, s, d); dropped tokens output zero."""

    def __init__(self, dim, num_experts=8, hidden_dim=128, top_k=1,
                 capacity_factor=1.25, dtype=torch.float32, device=None):
        _check_top_k(top_k, num_experts)
        super().__init__(dim, num_experts, hidden_dim, dtype, device)
        self.top_k, self.capacity_factor = top_k, capacity_factor

    def forward(self, x):
        b, s, d = x.shape
        n, e = b * s, self.num_experts
        capacity = max(1, math.ceil(self.capacity_factor * n * self.top_k
                                    / e))
        tokens = x.reshape(n, d)
        dt = self.dtype
        gates = self._gates(tokens).to(dt)
        dispatch, combine, aux = _one_hot_routing(gates, capacity,
                                                  self.top_k)
        self.aux_loss = aux
        xt = tokens.to(dt)
        expert_in = torch.einsum("nec,nd->ecd", dispatch, xt)
        h = F.gelu(torch.einsum("ecd,edh->ech", expert_in, self.w1.to(dt))
                   + self.b1[:, None].to(dt), approximate="tanh")
        expert_out = (torch.einsum("ech,ehd->ecd", h, self.w2.to(dt))
                      + self.b2[:, None].to(dt))
        out = torch.einsum("nec,ecd->nd", combine, expert_out)
        return out.reshape(b, s, d).to(x.dtype)
