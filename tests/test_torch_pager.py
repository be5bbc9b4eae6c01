"""The port's ``Pager`` against the JAX package's, operation for operation.

Both allocators are driven through one seeded random sequence of
``alloc`` / ``free_slot`` / ``register`` / ``lookup_share`` /
``release_prefix`` / ``retain`` / ``release_claim`` / ``evict_cached``
(plus the read-only probes): every call returns the same value or raises
the same error, and after every operation both give the same ``table()``,
``stats()``, radix books and probe results, with the pool partition
``in_use + free == num_pages - 1`` throughout."""

import dataclasses
import importlib

import numpy as np
import pytest

from adapt_tpu_torch.runtime import paged as TPG

JPG = importlib.import_module("adapt_tpu.runtime.paged")

P = 4  # tokens per page


def _call(pager, name, *args):
    try:
        return ("ok", getattr(pager, name)(*args))
    except ValueError as e:
        return ("raise", str(e))


def _books(p):
    st = dataclasses.asdict(p.stats())
    return (st, p.table().tolist(), p.radix_evictions,
            [p.owned(s) for s in range(len(p._owned))],
            [p.base(s) for s in range(len(p._owned))])


@pytest.mark.parametrize("seed", range(6))
def test_random_operation_sequence_matches_jax(seed):
    rng = np.random.RandomState(seed)
    num_pages, slots, pps = 12, 3, 5
    mine = TPG.Pager(num_pages, slots, pps, page_tokens=P)
    ref = JPG.Pager(num_pages, slots, pps, page_tokens=P)
    # A few prompts sharing prefixes, so keys collide and hits happen.
    base = rng.randint(0, 9, size=24).astype(np.int32)
    prompts = [base.copy() for _ in range(4)]
    for pr in prompts[1:]:
        pr[rng.randint(P, 24):] = rng.randint(0, 9)  # diverge late
    claims: list[int] = []
    ops = ("alloc", "free_slot", "register", "lookup_share",
           "release_prefix", "retain", "release_claim", "evict_cached",
           "probe")
    for step in range(400):
        op = ops[rng.randint(len(ops))]
        slot = int(rng.randint(slots))
        if op == "alloc":
            args = (slot, int(rng.randint(0, 4)))
        elif op == "free_slot":
            args = (slot,)
        elif op in ("register", "lookup_share"):
            pr = prompts[rng.randint(len(prompts))]
            upto = P * int(rng.randint(1, 6))
            key = TPG.Pager.prefix_key(pr, upto)
            assert key == JPG.Pager.prefix_key(pr, upto)
            if op == "register":
                owned = mine.owned(slot)
                if not owned:
                    continue
                args = (owned[rng.randint(len(owned))], key)
            else:
                args = (slot, key)
        elif op == "release_prefix":
            args = (slot, int(rng.randint(0, 3)))
        elif op == "retain":
            owned = mine.owned(slot)
            if not owned:
                continue
            page = owned[rng.randint(len(owned))]
            claims.append(page)
            args = (page,)
        elif op == "release_claim":
            if not claims:
                continue
            args = (claims.pop(rng.randint(len(claims))),)
        elif op == "evict_cached":
            args = (None if rng.rand() < 0.3 else int(rng.randint(0, 3)),)
        else:  # read-only probes
            pr = prompts[rng.randint(len(prompts))]
            assert mine.radix_probe(pr) == ref.radix_probe(pr)
            assert mine.radix_sketch(3) == ref.radix_sketch(3)
            assert mine.can_alloc(3) == ref.can_alloc(3)
            continue
        got, want = _call(mine, op, *args), _call(ref, op, *args)
        assert got == want, (step, op, args)
        assert _books(mine) == _books(ref), (step, op, args)
        st = mine.stats()
        assert st.in_use + st.free == num_pages - 1, (step, op)
        assert 0 not in sum((mine.owned(s) for s in range(slots)), [])


def test_note_cow_fork_and_record_prefix_match_books():
    mine, ref = TPG.Pager(8, 2, 4, page_tokens=P), JPG.Pager(8, 2, 4,
                                                             page_tokens=P)
    for p in (mine, ref):
        p.note_cow_fork()
        p.record_prefix_match(2, 20)
        p.record_prefix_match(0, 9)
    assert dataclasses.asdict(mine.stats()) == dataclasses.asdict(ref.stats())
    assert mine.num_allocatable == ref.num_allocatable == 7


def test_adopt_cached_and_validation_match_jax():
    mine, ref = TPG.Pager(6, 2, 3, page_tokens=P), JPG.Pager(6, 2, 3,
                                                             page_tokens=P)
    toks = np.arange(12, dtype=np.int32)
    keys = [TPG.Pager.prefix_key(toks, (j + 1) * P) for j in range(3)]
    assert mine.adopt_cached(keys) == ref.adopt_cached(keys)
    assert mine.adopt_cached(keys) == ref.adopt_cached(keys) == []
    assert _books(mine) == _books(ref)
    assert mine.cached_pages() == ref.cached_pages()
    assert mine.resident(keys[0]) and ref.resident(keys[0])
    for cls in (TPG.Pager, JPG.Pager):
        with pytest.raises(ValueError, match="num_pages"):
            cls(1, 1, 1)
        with pytest.raises(ValueError, match="pages_per_slot"):
            cls(4, 1, 0)
        with pytest.raises(ValueError, match="table width"):
            cls(8, 2, 2).alloc(0, 3)
