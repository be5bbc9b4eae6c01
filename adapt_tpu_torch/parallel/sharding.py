"""Head-axis tiling of KV tensors: ``head_tiles``, the one piece of
``adapt_tpu/parallel/sharding.py`` the one-card slices need (the
disaggregated wire's sender-side tiles, ``runtime/disagg.pack_handoff``).
The rest of that file (the tp rules, KV reshard and handoff plans, head
shard fetches) comes with the multi-GPU slice (ROADMAP.md item 11)."""

from __future__ import annotations


def head_tiles(kv_heads: int, parts: int) -> list[tuple[int, int]]:
    """Contiguous even ``(lo, hi)`` tiles of a ``kv_heads`` head axis over
    ``parts`` destination shards: the slices a sender frames so that each
    shard of a head-sharded receiver gets exactly its own heads."""
    kv_heads, parts = int(kv_heads), int(parts)
    if parts < 1:
        raise ValueError(f"parts must be >= 1, got {parts}")
    if kv_heads < 1 or kv_heads % parts:
        raise ValueError(
            f"{parts} tiles must evenly cover {kv_heads} kv heads")
    w = kv_heads // parts
    return [(i * w, (i + 1) * w) for i in range(parts)]
