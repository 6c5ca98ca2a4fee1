"""The port's ``core/paging.py`` against the reference's.

One fixed-seed sequence of allocator and prefix-store operations (alloc,
retain, release, grow_to, rollback_to, put_prefix, lookups with LRU
eviction, release_operator) is applied to both ``PagePool``s; after every
operation the returned page ids, the refcounts, the free lists and
``stats()`` must be equal. The device pool must be all zeros on creation
and in every page a growth adds, with the content of the old pages kept.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import paging as jpg
from repro_torch.core import paging as tpg

torch.set_num_threads(1)

L, PAGE, K, HD = 2, 4, 2, 8


def _like(n, fill):
    """A prefill's paged KV, leaves (L, n, page, K, hd), all ``fill``."""
    a = np.full((L, n, PAGE, K, HD), fill, np.float32)
    return ({"groups": [{"k": jnp.asarray(a), "v": jnp.asarray(a)}]},
            {"groups": [{"k": torch.from_numpy(a.copy()),
                         "v": torch.from_numpy(a.copy())}]})


def _same_state(jp, tp):
    assert tp._refcount == jp._refcount
    assert tp._free == jp._free
    assert tp.stats() == jp.stats()
    assert list(tp.prefix) == list(jp.prefix)
    assert tp.check_invariants() == jp.check_invariants()


def test_helpers_match():
    for tokens in (0, 1, 15, 16, 17, 204, 208):
        assert tpg.pages_for(tokens, 16) == jpg.pages_for(tokens, 16)
    np.testing.assert_array_equal(tpg.prefix_positions(13, 4, 4),
                                  jpg.prefix_positions(13, 4, 4))
    rng = np.random.RandomState(0)
    ctx = rng.randn(1, 16, 8).astype(np.float32)
    query = rng.randint(0, 64, (1, 8)).astype(np.int32)
    assert tpg.prefix_digest(ctx, query) == jpg.prefix_digest(ctx, query)
    assert tpg.prefix_digest(ctx, query) == jpg.prefix_digest(
        jnp.asarray(ctx), jnp.asarray(query))
    assert tpg.prefix_digest(ctx, query + 1) != tpg.prefix_digest(ctx, query)
    assert tpg.TRASH_PAGE == jpg.TRASH_PAGE == 0


def test_op_sequence_matches_reference():
    rng = np.random.RandomState(7)
    jp = jpg.PagePool(page_size=PAGE, max_prefixes=2)
    tp = tpg.PagePool(page_size=PAGE, max_prefixes=2)
    jl, tl = _like(3, 1.0)
    jp.ensure(3, like=jl, capacity_hint=6)
    tp.ensure(3, like=tl, capacity_hint=6)
    _same_state(jp, tp)
    runs = []                       # private page runs, one list per side
    prefix_keys = []
    for step in range(60):
        op = rng.choice(["alloc", "retain_release", "grow", "rollback",
                         "put", "lookup", "release_op"])
        if op == "alloc":
            n = int(rng.randint(1, 5))
            ids = jp.alloc(n)
            assert tp.alloc(n) == ids
            runs.append((list(ids), list(ids)))
        elif op == "retain_release" and runs:
            jr, tr = runs.pop(int(rng.randint(len(runs))))
            jp.retain(jr)
            tp.retain(tr)
            jp.release(jr)
            tp.release(tr)
            jp.release(jr)
            tp.release(tr)
        elif op == "grow" and runs:
            jr, tr = runs[int(rng.randint(len(runs)))]
            tokens = int(rng.randint(1, 6 * PAGE))
            assert tp.grow_to(tr, tokens) == jp.grow_to(jr, tokens)
            assert tr == jr
        elif op == "rollback" and runs:
            jr, tr = runs[int(rng.randint(len(runs)))]
            tokens = int(rng.randint(0, 3 * PAGE))
            assert tp.rollback_to(tr, tokens) == jp.rollback_to(jr, tokens)
            assert tr == jr
        elif op == "put":
            key = (f"op{rng.randint(3)}", f"d{step}")
            ids = jp.alloc(2)
            assert tp.alloc(2) == ids
            logits = rng.randn(1, 5).astype(np.float32)
            jp.put_prefix(key, ids, 7, logits)
            tp.put_prefix(key, ids, 7, logits)
            jp.release(ids)                 # the request finishes
            tp.release(ids)
            prefix_keys.append(key)
        elif op == "lookup" and prefix_keys:
            key = prefix_keys[int(rng.randint(len(prefix_keys)))]
            je, te = jp.lookup_prefix(key), tp.lookup_prefix(key)
            assert (je is None) == (te is None)
            if je is not None:
                assert te.page_ids == je.page_ids
                np.testing.assert_array_equal(te.logits0, je.logits0)
        elif op == "release_op":
            who = f"op{rng.randint(3)}"
            assert tp.release_operator(who) == jp.release_operator(who)
        _same_state(jp, tp)
    assert jp.prefix_evictions > 0 and jp.prefix_hits > 0
    assert jp.num_pages > 6                 # the pool grew on the way
    for jr, tr in runs:
        jp.release(jr)
        tp.release(tr)
    _same_state(jp, tp)


def test_pool_is_zero_on_creation_and_growth():
    tp = tpg.PagePool(page_size=PAGE)
    _, tl = _like(3, 7.0)
    tp.ensure(3, like=tl)
    for a in (tp.kv["groups"][0]["k"], tp.kv["groups"][0]["v"]):
        assert a.shape == (L, 4, PAGE, K, HD)
        assert a.dtype == torch.float32
        assert not a.any()
    ids = tp.alloc(3)
    for a in tp.kv["groups"][0].values():
        a[:, ids] = float("nan")            # live pages hold data
    old = tp.num_pages
    tp.alloc(5)                             # grows: 0 free -> doubling
    assert tp.num_pages > old
    for a in tp.kv["groups"][0].values():
        assert torch.isnan(a[:, ids]).all()
        assert not a[:, old:].any()
        assert not a[:, 0].any()            # the trash page stays clean
    assert tp.page_bytes == 2 * L * PAGE * K * HD * 4


def test_sharded_placement_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpg.PagePool(placement=lambda kv: kv)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpg.PagePool(shards=2)
    with pytest.raises(RuntimeError, match="no prefill"):
        tpg.PagePool().ensure(1)
