"""The port's ``Scheduler`` against the JAX package's on the ``mosa-paper``
smoke model (2 layers, vocab 512, sparsity 8): the same weights (numpy,
converted with ``params_from_jax``), the same requests, greedy decoding.
Results must be the identical tokens and the scheduler ``stats``
identical (prefix hits and hit tokens, prefilled tokens, chunks,
preemptions): the scheduling decisions are host logic, and the logits
agree to ~1e-5 (fp32, another summation order), far from any argmax tie
at these sizes."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.launch.serve import Server as JServer
from repro.nn.transformer import TransformerLM as JLM
from repro.serve.paged_kv import PagedConfig as JPagedConfig
from repro.serve.scheduler import Scheduler as JScheduler

from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import Server
from repro_torch.serve.loadgen import OpenLoopSource, poisson_workload
from repro_torch.serve.paged_kv import PagedConfig
from repro_torch.serve.scheduler import Scheduler

from test_torch_parity import (n, numpy_params, one_cpu_thread,  # noqa: F401
                               to_jax, torch_config)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

BS, MAX_LEN = 8, 64


def _weights(cfg, seed=0):
    shapes = jax.eval_shape(JLM(cfg).init, jax.random.PRNGKey(0))
    return numpy_params(shapes, seed=seed)


def _pair(cfg, params, num_blocks, batch=2):
    """(JAX server, port server) on the same weights and block budget."""
    jsrv = JServer(cfg, batch=batch, max_len=MAX_LEN, params=to_jax(params),
                   paged=JPagedConfig(block_size=BS, num_blocks=num_blocks))
    tsrv = Server(torch_config(cfg), batch=batch, max_len=MAX_LEN,
                  params=params_from_jax(cfg, params),
                  paged=PagedConfig(block_size=BS, num_blocks=num_blocks),
                  device="cpu")
    return jsrv, tsrv


def _serve_both(cfg, params, requests, num_blocks, **kw):
    """Run the same requests through both schedulers; returns the two
    schedulers and their results."""
    jsrv, tsrv = _pair(cfg, params, num_blocks)
    js, ts = JScheduler(jsrv, **kw), Scheduler(tsrv, **kw)
    for prompt, max_new in requests:
        assert js.submit(prompt, max_new) == ts.submit(prompt, max_new)
    return js, ts, js.run(), ts.run()


def _assert_same(js, ts, jout, tout):
    assert sorted(jout) == sorted(tout)
    for rid in jout:
        np.testing.assert_array_equal(n(tout[rid]), np.asarray(jout[rid]),
                                      err_msg=f"request {rid}")
    assert ts.stats == js.stats


@pytest.fixture(scope="module")
def mosa():
    cfg = get_config("mosa-paper", preset="smoke", variant="mosa")
    return cfg, _weights(cfg)


def _prompts(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, (L,), dtype=np.int32) for L in lengths]


def test_scheduler_mixed_lengths_match_jax(mosa):
    """Mixed prompt lengths through 16-slot packed chunks (segments split
    across chunks, several rows per chunk, decode interleaved with
    paused mid-prefill rows); every block returns but the trie's."""
    cfg, params = mosa
    prompts = _prompts(4, (5, 23, 11, 30, 2), cfg.vocab)
    reqs = [(p, 3 + i) for i, p in enumerate(prompts)]
    js, ts, jout, tout = _serve_both(cfg, params, reqs, 24, chunk=4,
                                     chunk_tokens=16)
    _assert_same(js, ts, jout, tout)
    assert {k: len(v) for k, v in tout.items()} == {i: 3 + i
                                                    for i in range(5)}
    assert ts.stats["prefill_chunks"] > 3
    assert ts.dense_pool.free_blocks + ts.prefix.n_nodes == \
        ts.dense_pool.num_blocks


def test_scheduler_prefix_hit_matches_jax_and_no_recompute(mosa):
    """A shared 17-token prefix: later requests hit the trie (its blocks
    are not prefilled again) and, prefix cache on or off, the port gives
    the JAX scheduler's tokens."""
    cfg, params = mosa
    rng = np.random.default_rng(5)
    shared = rng.integers(2, cfg.vocab, (17,), dtype=np.int32)
    reqs = [(np.concatenate([shared, rng.integers(2, cfg.vocab, (3,),
                                                  dtype=np.int32)]), 5)
            for _ in range(3)]
    js, ts, jout, tout = _serve_both(cfg, params, reqs, 32, chunk=4)
    _assert_same(js, ts, jout, tout)
    assert ts.stats["prefix_hits"] >= 2
    assert ts.stats["prefix_hit_tokens"] >= 2 * 16
    assert ts.stats["prefilled_tokens"] <= 20 + 3 * 8   # shared span once

    js2, ts2, jout2, tout2 = _serve_both(cfg, params, reqs, 32, chunk=4,
                                         prefix_cache=False)
    _assert_same(js2, ts2, jout2, tout2)
    assert ts2.stats["prefix_hits"] == 0


def test_scheduler_preemption_matches_jax(mosa):
    """A 5-block pool: decode growth runs it dry, the latest-admitted row
    is preempted to recompute, and every request still completes with
    its max_new; every block returns."""
    cfg, params = mosa
    reqs = [(p, 12) for p in _prompts(7, (10, 10), cfg.vocab)]
    js, ts, jout, tout = _serve_both(cfg, params, reqs, 5, chunk=4,
                                     prefix_cache=False)
    _assert_same(js, ts, jout, tout)
    assert {k: len(v) for k, v in tout.items()} == {0: 12, 1: 12}
    assert ts.stats["preemptions"] >= 1
    assert ts.dense_pool.free_blocks == ts.dense_pool.num_blocks


def test_scheduler_eos_matches_jax(mosa):
    """EOS ends a request early (the eos token is its last), as in JAX."""
    cfg, params = mosa
    (prompt,) = _prompts(8, (6,), cfg.vocab)
    _, tsrv = _pair(cfg, params, 24)
    probe = Scheduler(tsrv, prefix_cache=False)
    probe.submit(prompt, max_new=8)
    eos = int(probe.run()[0][2])
    js, ts, jout, tout = _serve_both(cfg, params, [(prompt, 8)], 24,
                                     eos=eos, prefix_cache=False)
    _assert_same(js, ts, jout, tout)
    t = n(tout[0])
    assert t[-1] == eos and (t[:-1] != eos).all() and len(t) == 3


def test_scheduler_pure_dense_snapshot_free_hit_matches_jax():
    """Pure paged-dense model: per-row state is table + length only, so a
    hit lands on a mid-chain node without a snapshot, and stays exact."""
    cfg = dataclasses.replace(
        get_config("mosa-paper", preset="smoke", variant="dense"),
        n_layers=2)
    params = _weights(cfg, seed=1)
    rng = np.random.default_rng(9)
    shared = rng.integers(2, cfg.vocab, (17,), dtype=np.int32)
    tail = rng.integers(2, cfg.vocab, (2,), dtype=np.int32)
    reqs = [(shared, 5), (np.concatenate([shared[:12], tail]), 5)]
    js, ts, jout, tout = _serve_both(cfg, params, reqs, 32, chunk=4)
    assert not ts.need_snapshot
    _assert_same(js, ts, jout, tout)
    assert ts.stats["prefix_hits"] >= 1

    _, _, _, off = _serve_both(cfg, params, reqs, 32, chunk=4,
                               prefix_cache=False)
    for rid in off:
        assert torch.equal(tout[rid], off[rid])


def test_scheduler_timed_open_loop_serves_all(mosa):
    """``run(source=OpenLoopSource(...))`` submits at the arrival times and
    drains; every request finishes with its max_new and an SLO record.
    With temperature sampling only counts are compared (JAX's PRNG and a
    torch.Generator draw different numbers)."""
    cfg, params = mosa
    wl = poisson_workload(200.0, 6, seed=3, vocab=cfg.vocab)
    _, tsrv = _pair(cfg, params, 32)
    sched = Scheduler(tsrv, chunk=4, temperature=0.8, seed=1)
    src = OpenLoopSource(wl)
    out = sched.run(source=src)
    assert src.exhausted() and len(src.submitted_rids) == 6
    for rid, a in zip(src.submitted_rids, wl):
        want = min(a.max_new, MAX_LEN - len(a.prompt) + 1)
        assert len(out[rid]) == want
        assert ((out[rid] >= 0) & (out[rid] < cfg.vocab)).all()
    recs = sched.records
    assert len(recs) == 6 and all(r["outcome"] == "finished"
                                  for r in recs.values())
    assert all(r["ttft_s"] is not None for r in recs.values())


def test_scheduler_refuses_unbudgeted_pool(mosa):
    cfg, params = mosa
    tsrv = Server(torch_config(cfg), batch=2, max_len=MAX_LEN,
                  params=params_from_jax(cfg, params),
                  paged=PagedConfig(block_size=BS), device="cpu")
    with pytest.raises(ValueError, match="explicit dense-block budget"):
        Scheduler(tsrv)
