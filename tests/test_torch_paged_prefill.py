"""The port's packed paged prefill against the JAX package: the attention
(``paged_prefill_attention`` on CPU tensors, i.e. its plain version)
against JAX's reference and against JAX's Pallas kernel #12 run in
interpret mode; ``append_packed`` and ``copy_blocks``; and the host
allocator ``BlockPool`` and the ``PrefixCache`` trie against the JAX
classes under the same operation traces.

Tolerance: fp32 1e-5 per attention op (``KERNEL_TOL``: the same math,
summed in another order); the padding tail and inactive segments must be
exact zeros; pools, lengths, block ids, refcounts, hits and evictions
must be identical."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import paged_attention as jpa
from repro.serve.paged_kv import BlockPool as JBlockPool
from repro.serve.paged_kv import PagedDenseKVCache as JPaged
from repro.serve.paged_kv import copy_blocks as jcopy_blocks
from repro.serve.prefix_cache import PrefixCache as JPrefixCache

from repro_torch.serve import paged_attention as tpa
from repro_torch.serve.paged_kv import BlockPool, PagedDenseKVCache, copy_blocks
from repro_torch.serve.prefix_cache import PrefixCache

from _property_harness import given, settings, st
from test_torch_parity import KERNEL_TOL, n, one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


def prefill_case(seed, Hq, Hkv, d, bs, nb, segs, total, share=0,
                 neg_tail=True):
    """Inputs of one packed chunk.  ``segs``: (row, past, len) per
    segment, row -1 = inactive; ``total`` > sum(len) leaves a padding
    tail.  Pools hold B * nb blocks under a random permutation; with
    ``neg_tail`` a row's table is -1 past the blocks its tokens fill;
    ``share`` > 0 makes rows 0 and 1 share their first ``share`` blocks
    (a prefix-cache hit)."""
    rng = np.random.default_rng(seed)
    B = max(r for r, _, _ in segs) + 1
    P = B * nb
    kp = rng.standard_normal((P, bs, Hkv, d)).astype(np.float32)
    vp = rng.standard_normal((P, bs, Hkv, d)).astype(np.float32)
    table = rng.permutation(P).reshape(B, nb).astype(np.int32)
    if share:
        table[1, :share] = table[0, :share]
    if neg_tail:
        fill = np.zeros(B, np.int64)
        for r, past, L in segs:
            if r >= 0:
                fill[r] = max(fill[r], -(-(past + L) // bs))
        table[np.arange(nb)[None] >= fill[:, None]] = -1
    cu = np.concatenate([[0], np.cumsum([L for _, _, L in segs])])
    assert cu[-1] <= total
    q = rng.standard_normal((total, Hq, d)).astype(np.float32)
    rows = np.asarray([r for r, _, _ in segs], np.int32)
    past = np.asarray([p for _, p, _ in segs], np.int32)
    return q, kp, vp, table, cu.astype(np.int32), rows, past


# (row, past, len): past 0; a past off the block grid (13, bs 4) ending on
# a block boundary (16); one token; an inactive segment; a padding tail
EDGE_SEGS = [(0, 0, 5), (1, 13, 3), (2, 7, 1), (-1, 0, 4), (3, 9, 6)]
CASES = {
    "d32 4/4": dict(Hq=4, Hkv=4, d=32, bs=4, nb=6, segs=EDGE_SEGS, total=24),
    "d64 8/2": dict(Hq=8, Hkv=2, d=64, bs=4, nb=6, segs=EDGE_SEGS, total=24),
    "d128 8/2 bs8": dict(Hq=8, Hkv=2, d=128, bs=8, nb=3,
                         segs=[(0, 0, 9), (1, 8, 7)], total=16, share=1),
    "shared prefix 4/4": dict(Hq=4, Hkv=4, d=64, bs=4, nb=6,
                              segs=[(0, 4, 6), (1, 8, 5), (2, 0, 3)],
                              total=16, share=2),
}


def _torch_out(q, kp, vp, table, cu, rows, past):
    cache = PagedDenseKVCache(torch.from_numpy(kp), torch.from_numpy(vp),
                              torch.from_numpy(table),
                              torch.zeros(table.shape[0], dtype=torch.int32))
    return tpa.paged_prefill_attention(
        torch.from_numpy(q), cache, torch.from_numpy(cu),
        torch.from_numpy(rows), torch.from_numpy(past),
        scale=q.shape[-1] ** -0.5)


def _jax_out(q, kp, vp, table, cu, rows, past, impl):
    cache = JPaged(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
                   jnp.zeros(table.shape[0], jnp.int32))
    return jpa.paged_prefill_attention(
        jnp.asarray(q), cache, jnp.asarray(cu), jnp.asarray(rows),
        jnp.asarray(past), scale=q.shape[-1] ** -0.5, impl=impl,
        interpret=True)


def _pad_mask(cu, rows, total):
    """(total,) True for tokens that must come back as zeros."""
    dead = np.ones(total, bool)
    for i, r in enumerate(rows):
        if r >= 0:
            dead[cu[i]:cu[i + 1]] = False
    return dead


@pytest.mark.parametrize("case", list(CASES))
def test_paged_prefill_matches_jax_reference(case):
    args = prefill_case(0, **CASES[case])
    got = n(_torch_out(*args))
    want = np.asarray(_jax_out(*args, impl="ref"))
    np.testing.assert_allclose(got, want, **KERNEL_TOL)
    dead = _pad_mask(args[4], args[5], args[0].shape[0])
    assert dead.any() or case == "d128 8/2 bs8"
    assert (got[dead] == 0).all()


@pytest.mark.parametrize("case", ["d32 4/4", "d64 8/2", "shared prefix 4/4"])
def test_paged_prefill_matches_jax_pallas_kernel(case):
    """Against the TPU kernel #12 itself (Pallas, interpret mode)."""
    args = prefill_case(1, **CASES[case])
    got = n(_torch_out(*args))
    want = np.asarray(_jax_out(*args, impl="kernel"))
    np.testing.assert_allclose(got, want, **KERNEL_TOL)


def test_paged_prefill_dispatch_counts_no_launch_on_cpu():
    args = prefill_case(3, **CASES["d32 4/4"])
    before = tpa.LAUNCHES_PREFILL.count
    _torch_out(*args)
    assert tpa.LAUNCHES_PREFILL.count == before
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_prefill_attention_cuda(
            *(torch.from_numpy(a) for a in args[:7]), scale=1.0)


# ----------------------------------------------------------- cache writes
def test_append_packed_matches_jax():
    """Packed-stream append: pools and lengths equal JAX's, with padding
    tokens (row -1), a -1 table entry and a position past the table all
    dropped."""
    rng = np.random.default_rng(4)
    B, nbt, bs, Hkv, d, P = 3, 4, 4, 2, 8, 12
    table = rng.permutation(P).reshape(B, nbt).astype(np.int32)
    table[2, 2:] = -1
    rows = np.asarray([0, 0, 1, 2, 2, -1, 1, 2, 0], np.int32)
    pos = np.asarray([3, 4, 0, 5, 9, 0, 1, 8, 16], np.int32)
    kn = rng.standard_normal((len(rows), Hkv, d)).astype(np.float32)
    vn = rng.standard_normal((len(rows), Hkv, d)).astype(np.float32)
    kp = rng.standard_normal((P, bs, Hkv, d)).astype(np.float32)
    lengths = np.asarray([3, 0, 5], np.int32)

    j = JPaged(jnp.asarray(kp), jnp.asarray(kp * 2), jnp.asarray(table),
               jnp.asarray(lengths)).append_packed(
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(rows),
        jnp.asarray(pos))
    t = PagedDenseKVCache(torch.tensor(kp), torch.tensor(kp * 2),
                          torch.tensor(table), torch.tensor(lengths))
    t = t.append_packed(torch.tensor(kn), torch.tensor(vn),
                        torch.tensor(rows), torch.tensor(pos))
    np.testing.assert_array_equal(n(t.k), np.asarray(j.k))
    np.testing.assert_array_equal(n(t.v), np.asarray(j.v))
    np.testing.assert_array_equal(n(t.length), np.asarray(j.length))


def test_copy_blocks_matches_jax():
    rng = np.random.default_rng(5)
    kp = rng.standard_normal((6, 4, 2, 8)).astype(np.float32)
    table = np.zeros((1, 6), np.int32)
    j = jcopy_blocks(JPaged(jnp.asarray(kp), jnp.asarray(-kp),
                            jnp.asarray(table), jnp.zeros(1, jnp.int32)),
                     jnp.asarray([0, 2]), jnp.asarray([5, 3]))
    t = copy_blocks(PagedDenseKVCache(torch.tensor(kp), torch.tensor(-kp),
                                      torch.tensor(table),
                                      torch.zeros(1, dtype=torch.int32)),
                    [0, 2], [5, 3])
    np.testing.assert_array_equal(n(t.k), np.asarray(j.k))
    np.testing.assert_array_equal(n(t.v), np.asarray(j.v))


# ------------------------------------------------------ host allocators
def _pool_trace(ops, num_blocks):
    """Replay an alloc/free/share/cow trace on both allocators; every
    return value and the refcounts must agree after each op."""
    pools = (JBlockPool(num_blocks, 4), BlockPool(num_blocks, 4))
    owners = []                               # (ids) of live owners
    for kind, arg in ops:
        if kind == "alloc":
            got = [p.alloc(arg) for p in pools]
            assert got[0] == got[1]
            if got[0] is not None:
                owners.append(got[0])
        elif kind == "free" and owners:
            ids = owners.pop(arg % len(owners))
            for p in pools:
                p.decref(ids)
        elif kind == "share" and owners:
            ids = owners[arg % len(owners)]
            for p in pools:
                p.incref(ids)
            owners.append(list(ids))
        elif kind == "cow" and owners:
            ids = owners[arg % len(owners)]
            if ids:
                got = [p.ensure_owned(ids[0]) for p in pools]
                assert got[0] == got[1]
                if got[0] is not None:
                    ids[0] = got[0][0]
        for attr in ("free_blocks", "live_blocks"):
            assert getattr(pools[0], attr) == getattr(pools[1], attr)
        assert [pools[0].refcount(b) for b in range(num_blocks)] == \
            [pools[1].refcount(b) for b in range(num_blocks)]
    for ids in owners:
        for p in pools:
            p.decref(ids)
    assert pools[1].free_blocks == num_blocks


def test_block_pool_trace_matches_jax_deterministic():
    for seed in range(20):
        rng = random.Random(seed)
        ops = [(rng.choice(["alloc", "free", "share", "cow"]),
                rng.randrange(1, 5)) for _ in range(60)]
        _pool_trace(ops, num_blocks=12)


@given(ops=st.lists(st.tuples(
    st.sampled_from(["alloc", "free", "share", "cow"]),
    st.integers(1, 5)), max_size=80), num_blocks=st.integers(4, 24))
@settings(max_examples=25, deadline=None)
def test_block_pool_trace_matches_jax_property(ops, num_blocks):
    _pool_trace(ops, num_blocks)


def test_block_pool_double_free_raises():
    pool = BlockPool(4, 4)
    ids = pool.alloc(2)
    pool.decref(ids)
    with pytest.raises(AssertionError):
        pool.decref(ids[:1])


def _trie_trace(seed, steps=40, bs=4, num_blocks=24):
    """The same insert / lookup / acquire / evict trace on both tries, each
    over its own pool: chains, hits, depths, snapshots, refcounts and
    evictions must agree."""
    rng = np.random.default_rng(seed)
    pools = (JBlockPool(num_blocks, bs), BlockPool(num_blocks, bs))
    tries = (JPrefixCache(bs), PrefixCache(bs))
    prefixes = [rng.integers(0, 3, (bs * 4,)) for _ in range(3)]
    held = []
    for step in range(steps):
        op = rng.integers(0, 4)
        base = prefixes[rng.integers(0, len(prefixes))]
        toks = np.concatenate([base[:bs * int(rng.integers(1, 5))],
                               rng.integers(0, 3, (int(rng.integers(1, 6)),))])
        if op == 0:                                          # insert
            k = (len(toks) // bs) * bs
            got = []
            for pool, trie in zip(pools, tries):
                ids = pool.alloc(k // bs)
                if ids is None:
                    got.append(None)
                    continue
                chain, tip = trie.insert(toks[:k], ids, pool)
                trie.attach_snapshot(tip, {"step": step})
                pool.decref(ids)
                got.append(chain)
            assert got[0] == got[1]
        elif op == 1:                                        # lookup+acquire
            need = bool(rng.integers(0, 2))
            res = [trie.lookup(toks, need) for trie in tries]
            assert res[0][1] == res[1][1]
            assert (res[0][0] is None) == (res[1][0] is None)
            if res[0][0] is not None:
                assert res[0][0].snapshot == res[1][0].snapshot
                ids = [trie.acquire(node, pool) for (node, _), trie, pool
                       in zip(res, tries, pools)]
                assert ids[0] == ids[1]
                held.append(ids[0])
        elif op == 2 and held:                               # release
            ids = held.pop(int(rng.integers(0, len(held))))
            for pool in pools:
                pool.decref(ids)
        else:                                                # evict
            assert tries[0].evict_lru(pools[0]) == \
                tries[1].evict_lru(pools[1])
        assert tries[0].n_nodes == tries[1].n_nodes
        assert (tries[0].hits, tries[0].misses, tries[0].hit_tokens) == \
            (tries[1].hits, tries[1].misses, tries[1].hit_tokens)
        assert [pools[0].refcount(b) for b in range(num_blocks)] == \
            [pools[1].refcount(b) for b in range(num_blocks)]


@pytest.mark.parametrize("seed", range(4))
def test_prefix_cache_trace_matches_jax(seed):
    _trie_trace(seed)


def test_prefix_trie_insert_lookup_refcounts():
    """The JAX package's trie walk-through (tests/test_paged_kv.py) on the
    port's classes."""
    pool = BlockPool(16, 4)
    trie = PrefixCache(4)
    toks = list(range(100, 112))                       # 3 full blocks
    ids = pool.alloc(3)
    chain, tip = trie.insert(toks, ids, pool)
    assert chain == ids and tip is not None
    assert all(pool.refcount(b) == 2 for b in ids)     # row + trie
    trie.attach_snapshot(tip, {"state": "s3"})
    node, depth = trie.lookup(toks + [7, 8], need_snapshot=True)
    assert node is tip and depth == 12
    node2, depth2 = trie.lookup(toks[:9] + [5], need_snapshot=False)
    assert depth2 == 8 and node2.snapshot is None
    assert trie.lookup(toks[:9] + [5], need_snapshot=True) == (None, 0)
    assert trie.lookup(toks[:4], need_snapshot=False) == (None, 0)
    got = trie.acquire(node, pool)
    assert got == ids and all(pool.refcount(b) == 3 for b in ids)
    pool.decref(got)
    ids_b = pool.alloc(3)
    chain_b, _ = trie.insert(toks, ids_b, pool)
    assert chain_b == ids                              # trie authoritative
    pool.decref(ids_b)
    pool.decref(ids)
    free0 = pool.free_blocks
    assert trie.evict_lru(pool)
    assert pool.free_blocks == free0 + 1
    while trie.evict_lru(pool):
        pass
    assert trie.n_nodes == 0 and pool.free_blocks == 16
