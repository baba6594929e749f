"""The port's ``Scheduler`` with a window pool against the JAX package's, on
the acceptance stacks of ``tests/test_paged_serving.py``: ``hybrid_cfg``
(attn, attn_local with W 16, mosa: a dense pool, a window pool and MoSA
caches) and ``dense_window_cfg`` (attn, attn_local: no MoSA, so prefix
hits and preemption are exact).  The same weights (numpy, converted with
``params_from_jax``), the same requests, greedy decoding: identical tokens
and ``stats``, and both pools drained.  Prompts longer than W make the
rings wrap.  Also the window row ops on their own: a row snapshot of a
wrapped ring restored into new block ids, and ``set_window_tables``,
against the JAX package's ``_snap_paged`` / ``_restore_paged`` /
``set_window_tables``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.launch.serve import Server as JServer
from repro.nn.transformer import TransformerLM as JLM
from repro.serve.paged_kv import PagedConfig as JPagedConfig
from repro.serve.paged_kv import PagedWindowKVCache as JPagedWindowKVCache
from repro.serve.scheduler import Scheduler as JScheduler

from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import Server
from repro_torch.serve.paged_kv import PagedConfig, PagedWindowKVCache
from repro_torch.serve.scheduler import Scheduler

from test_paged_serving import dense_window_cfg, hybrid_cfg
from test_torch_parity import (n, numpy_params, one_cpu_thread,  # noqa: F401
                               t, to_jax, torch_config)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

BS, MAX_LEN, BATCH = 8, 64, 2
CONFIGS = {"hybrid": hybrid_cfg, "dense_window": dense_window_cfg}


@pytest.fixture(scope="module")
def stacks():
    """Per config: (cfg, numpy weights) and a cache of (JAX server, port
    server) pairs by pool budget (each JAX server compiles its programs
    once)."""
    out = {}
    for i, (name, make) in enumerate(CONFIGS.items()):
        cfg = make()
        shapes = jax.eval_shape(JLM(cfg).init, jax.random.PRNGKey(0))
        out[name] = (cfg, numpy_params(shapes, seed=10 + i), {})
    return out


def _pair(stacks, name, num_blocks, num_window_blocks=2 * BATCH):
    cfg, params, servers = stacks[name]
    key = (num_blocks, num_window_blocks)
    if key not in servers:
        kw = dict(block_size=BS, num_blocks=num_blocks,
                  num_window_blocks=num_window_blocks)
        servers[key] = (
            JServer(cfg, batch=BATCH, max_len=MAX_LEN, params=to_jax(params),
                    paged=JPagedConfig(**kw)),
            Server(torch_config(cfg), batch=BATCH, max_len=MAX_LEN,
                   params=params_from_jax(cfg, params),
                   paged=PagedConfig(**kw), device="cpu"))
    return servers[key]


def _prompts(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, (L,), dtype=np.int32) for L in lengths]


def _serve_both(stacks, name, requests, num_blocks, **kw):
    jsrv, tsrv = _pair(stacks, name, num_blocks)
    js, ts = JScheduler(jsrv, **kw), Scheduler(tsrv, **kw)
    for prompt, max_new in requests:
        assert js.submit(prompt, max_new) == ts.submit(prompt, max_new)
    jout, tout = js.run(), ts.run()
    assert sorted(jout) == sorted(tout)
    for rid in jout:
        np.testing.assert_array_equal(n(tout[rid]), np.asarray(jout[rid]),
                                      err_msg=f"request {rid}")
    assert ts.stats == js.stats
    return ts, tout


def _drained(ts, prefix=True):
    trie = ts.prefix.n_nodes if prefix else 0
    assert ts.dense_pool.free_blocks + trie == ts.dense_pool.num_blocks
    assert ts.window_pool.free_blocks == ts.window_pool.num_blocks


@pytest.mark.parametrize("name", list(CONFIGS))
def test_window_scheduler_mixed_lengths_match_jax(stacks, name):
    """Mixed lengths, several wrapping the W-16 ring, through 16-slot
    packed chunks (mid-prefill rows paused around decode chunks, their
    rings snapshot and restored); lazy ring growth in decode."""
    cfg = stacks[name][0]
    prompts = _prompts(4, (5, 23, 11, 30, 2), cfg.vocab)
    reqs = [(p, 3 + 2 * i) for i, p in enumerate(prompts)]
    ts, tout = _serve_both(stacks, name, reqs, 24, chunk=4, chunk_tokens=16)
    assert {k: len(v) for k, v in tout.items()} == {
        i: 3 + 2 * i for i in range(5)}
    assert ts.has_window and ts.stats["prefill_chunks"] > 3
    _drained(ts)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_window_scheduler_prefix_hit_matches_jax(stacks, name):
    """A shared 17-token prefix (longer than W): later requests restore
    the boundary snapshot's ring into their own new ring blocks.  The port
    gives the JAX scheduler's tokens and stats; on the stateless
    dense+window stack the hits also give the no-cache tokens."""
    cfg = stacks[name][0]
    rng = np.random.default_rng(5)
    shared = rng.integers(2, cfg.vocab, (17,), dtype=np.int32)
    reqs = [(np.concatenate([shared, rng.integers(2, cfg.vocab, (3,),
                                                  dtype=np.int32)]), 5)
            for _ in range(3)]
    ts, tout = _serve_both(stacks, name, reqs, 32, chunk=4)
    assert ts.stats["prefix_hits"] >= 2
    assert ts.stats["prefix_hit_tokens"] >= 2 * 16
    _drained(ts)
    ts2, tout2 = _serve_both(stacks, name, reqs, 32, chunk=4,
                             prefix_cache=False)
    assert ts2.stats["prefix_hits"] == 0
    _drained(ts2, prefix=False)
    if name == "dense_window":
        for rid in tout:
            assert torch.equal(tout[rid], tout2[rid])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_window_scheduler_preemption_matches_jax(stacks, name):
    """A 5-block dense pool: decode growth runs it dry and the
    latest-admitted row is preempted (its ring blocks freed with its dense
    ones) and recomputed; every request completes and both pools drain."""
    cfg = stacks[name][0]
    reqs = [(p, 14) for p in _prompts(7, (10, 10, 10), cfg.vocab)]
    ts, tout = _serve_both(stacks, name, reqs, 5, chunk=4,
                           prefix_cache=False)
    assert ts.stats["preemptions"] >= 1
    assert {k: len(v) for k, v in tout.items()} == {0: 14, 1: 14, 2: 14}
    _drained(ts, prefix=False)


def test_window_scheduler_eos_matches_jax(stacks):
    cfg = stacks["hybrid"][0]
    (prompt,) = _prompts(8, (20,), cfg.vocab)
    _, tsrv = _pair(stacks, "hybrid", 24)
    probe = Scheduler(tsrv, prefix_cache=False)
    probe.submit(prompt, max_new=8)
    eos = int(probe.run()[0][2])
    ts, tout = _serve_both(stacks, "hybrid", [(prompt, 8)], 24, eos=eos,
                           prefix_cache=False)
    tk = n(tout[0])
    assert tk[-1] == eos and (tk[:-1] != eos).all() and len(tk) == 3
    _drained(ts, prefix=False)


def test_window_scheduler_needs_a_window_budget(stacks):
    cfg, params, _ = stacks["hybrid"]
    srv = Server(torch_config(cfg), batch=BATCH, max_len=MAX_LEN,
                 params=params_from_jax(cfg, params),
                 paged=PagedConfig(block_size=BS, num_blocks=24),
                 device="cpu")
    with pytest.raises(ValueError, match="num_window_blocks"):
        Scheduler(srv)


# ------------------------------------------------------ window row ops
W, HKV, D, NBLK = 32, 2, 4, 12


def _ring_pair():
    """The same wrapped rings in both packages: 3 rows of W 32 in blocks of
    8 from a pool of 12; row 1 has seen 45 tokens (wrapped), row 2 only
    the first two of its blocks (a lazy ring: -1 tail)."""
    rng = np.random.default_rng(3)
    k = rng.standard_normal((NBLK, BS, HKV, D)).astype(np.float32)
    v = rng.standard_normal((NBLK, BS, HKV, D)).astype(np.float32)
    table = np.array([[0, 1, 2, 3], [7, 4, 9, 5], [10, 6, -1, -1]], np.int32)
    pos = np.full((3, W), -1, np.int32)
    pos[1] = [s + W if s < 45 - W else s for s in range(W)]
    pos[2, :11] = np.arange(11)
    length = np.array([0, 45, 11], np.int32)
    jc = JPagedWindowKVCache(*(jnp.asarray(a) for a in
                               (k, v, table, pos, length)))
    tc = PagedWindowKVCache(*(t(a) for a in (k, v, table, pos, length)))
    return jc, tc


def _same_ring(jc, tc):
    for name, a, b in zip(tc._fields, jc, tc):
        np.testing.assert_array_equal(n(b), np.asarray(a), err_msg=name)


def test_window_row_snapshot_restore_matches_jax():
    """Snapshot row 1 (wrapped), point it at new block ids with a -1 tail,
    restore it at row 2: the ring content lands in the new blocks, the
    -1 slots are dropped, as in the JAX package."""
    jc, tc = _ring_pair()
    jsnap = jax.device_get(jserve._snap_paged(jc, 1))
    with torch.inference_mode():
        tsnap = tserve.row_snapshot([{"dense": tc}], 1)[0]["dense"]
    assert set(tsnap) == set(jsnap)
    for key in jsnap:
        np.testing.assert_array_equal(n(tsnap[key]), np.asarray(jsnap[key]),
                                      err_msg=key)
    new = np.array([11, 8, 1, -1], np.int32)
    jsnap = dict(jsnap, block_table=new)
    tsnap = dict(tsnap, block_table=torch.from_numpy(new.copy()))
    jc2 = jserve._restore_paged(jc, jsnap, 2)
    with torch.inference_mode():
        tserve.row_restore([{"dense": tc}], [{"dense": tsnap}], 2)
    _same_ring(jc2, tc)
    # the restored row reads back the snapshot's ring where it has blocks
    with torch.inference_mode():
        back = tserve.row_snapshot([tc], 2)[0]
    keep = np.repeat(new >= 0, BS)
    np.testing.assert_array_equal(n(back["k"])[keep],
                                  n(tsnap["k"])[keep])


def test_set_window_tables_matches_jax():
    jc, tc = _ring_pair()
    row = np.array([6, 2, 11, -1], np.int32)
    jout = jserve.set_window_tables([jc], jnp.asarray(row), 1)
    with torch.inference_mode():
        tout = tserve.set_window_tables([tc], torch.from_numpy(row), 1)
    _same_ring(jout[0], tout[0])
    # dense tables are left alone, and the snapshot tables follow the
    # window row for entries that carry ring content
    from repro_torch.serve.scheduler import _set_snapshot_tables
    snap = [{"block_table": torch.zeros(4, dtype=torch.int32),
             "length": torch.zeros((), dtype=torch.int32)},
            copy.deepcopy(dict(k=torch.zeros(1), block_table=torch.zeros(
                4, dtype=torch.int32)))]
    _set_snapshot_tables(snap, np.arange(4), row)
    assert snap[0]["block_table"].tolist() == [0, 1, 2, 3]
    assert snap[1]["block_table"].tolist() == row.tolist()
