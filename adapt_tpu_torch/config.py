"""Typed configuration the ported serving core reads — copies of
``adapt_tpu/config.py``'s ``KernelConfig`` and ``SchedulerConfig`` (with
``TenantQuota``, which the latter names), same field names and defaults, so
one config means the same thing in both packages.

What differs is what ``KernelConfig`` selects on this card:

- ``attn_impl`` ``None`` or ``"pallas"``: the hand-written kernel on CUDA
  tensors, its plain PyTorch version on CPU tensors. ``"xla"``: the plain
  version, which a CUDA tensor refuses (``ValueError``) — no config can
  route the card's main path off the kernel.
- ``decode_split`` ``None`` means 1 until the card has measured
  otherwise; the TPU's auto rule is not carried over.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Decode-kernel knobs of the serving tier: ``attn_impl`` (see the
    module docstring) and ``decode_split``, the flash-decoding split of the
    KV length (1 = one stream per kv head; > 1 = per-split partials plus a
    rescale combine)."""

    attn_impl: str | None = None
    decode_split: int | None = None

    def __post_init__(self):
        if self.attn_impl not in (None, "xla", "pallas"):
            raise ValueError(
                f"attn_impl={self.attn_impl!r}: expected None, 'xla' "
                "or 'pallas'"
            )
        if self.decode_split is not None and self.decode_split < 1:
            raise ValueError(
                f"decode_split must be >= 1, got {self.decode_split}"
            )


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant traffic-control knobs: deficit-round-robin ``weight``
    and the queued ``burst`` cap."""

    weight: float = 1.0
    burst: int | None = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.burst is not None and self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Multi-tenant overload control in front of the continuous batcher.
    The port serves the bounded FIFO (``max_queue_depth``) so far; the
    fair-queueing, preemption and degradation fields are carried for
    config parity and take effect when that part is ported."""

    #: Global bound on queued (not yet admitted) requests.
    max_queue_depth: int = 4096
    quantum: float = 1.0
    default_weight: float = 1.0
    quotas: dict[str, TenantQuota] = dataclasses.field(default_factory=dict)
    preempt: bool = True
    preempt_ttft_fraction: float = 0.5
    degrade: bool = True
    degrade_queue_high: float = 0.5
    degrade_queue_low: float = 0.05
    degrade_occupancy: float = 1.0
    degrade_attainment: float = 0.9
    degrade_dwell_s: float = 0.25
    cache_aware: bool = False
    cache_aware_window: int = 16

    def __post_init__(self):
        if self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth}"
            )
        if self.quantum <= 0:
            raise ValueError(f"quantum must be > 0, got {self.quantum}")
        if self.default_weight <= 0:
            raise ValueError(
                f"default_weight must be > 0, got {self.default_weight}"
            )
        if not 0.0 < self.preempt_ttft_fraction <= 1.0:
            raise ValueError(
                "preempt_ttft_fraction must be in (0, 1], got "
                f"{self.preempt_ttft_fraction}"
            )
        if not 0.0 <= self.degrade_queue_low <= self.degrade_queue_high:
            raise ValueError(
                "degrade_queue_low must be in [0, degrade_queue_high] "
                f"({self.degrade_queue_low} vs {self.degrade_queue_high})"
            )
        if not 0.0 <= self.degrade_occupancy <= 1.0:
            raise ValueError(
                "degrade_occupancy must be in [0, 1], got "
                f"{self.degrade_occupancy}"
            )
        if self.degrade_dwell_s < 0:
            raise ValueError(
                f"degrade_dwell_s must be >= 0, got {self.degrade_dwell_s}"
            )
        if self.cache_aware_window < 1:
            raise ValueError(
                "cache_aware_window must be >= 1, got "
                f"{self.cache_aware_window}"
            )
