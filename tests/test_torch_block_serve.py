"""Block-choice MoSA serving against the JAX package on the CPU, with
converted weights: the layer's ``prefill`` then streaming ``decode_step``
(``MoSABlockKVCache``), chunked ``prefill_past`` (block-aligned and
unaligned splits, a partial current block straddled), ``Server.generate``
greedy tokens, the ``Scheduler`` (prefix hits, exact for aligned chunks;
preemption), and the host row snapshot of a block cache.

Integer selection state (``bidx``, ``pos``, ``length``) must be exactly
equal; floats (K/V rows, block scores, score sums, outputs) within 1e-5
(``MODULE_TOL``: one layer in another summation order); greedy tokens and
Scheduler ``stats`` identical.  Router scores of random inputs are
distinct, so both frameworks select the same blocks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoSAConfig as JMoSAConfig
from repro.configs.base import get_config
from repro.core.kv_cache import MoSABlockKVCache as JCache
from repro.core.mosa import MoSAAttention as JMoSA
from repro.launch.serve import Server as JServer
from repro.nn.transformer import TransformerLM as JLM
from repro.serve.paged_kv import PagedConfig as JPagedConfig
from repro.serve.scheduler import Scheduler as JScheduler
from repro.serve.scheduler import \
    _router_health_from_snapshot as jhealth_from_snapshot

from repro_torch.configs.base import MoSAConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.kv_cache import MoSABlockKVCache
from repro_torch.core.mosa import MoSAAttention
from repro_torch.launch.serve import Server, row_restore, row_snapshot
from repro_torch.serve.paged_kv import PagedConfig
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.scheduler import \
    _router_health_from_snapshot as health_from_snapshot

from test_torch_modules import state_dict
from test_torch_parity import (MODEL_TOL, MODULE_TOL, n,  # noqa: F401
                               numpy_params, one_cpu_thread, t, to_jax,
                               torch_config)
from test_torch_scheduler import _assert_same

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

D, B, H, DH = 32, 2, 3, 8
INTS = ("pos", "bidx", "length")


def _pair(bs, force=True, seed=0):
    kw = dict(n_mosa_heads=H, n_dense_heads=0, d_head=DH, sparsity=4,
              force_first_token=force, selection_granularity="block",
              sel_block_size=bs)
    jm = JMoSA(D, JMoSAConfig(**kw))
    tm = MoSAAttention(D, MoSAConfig(**kw))
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                          seed)
    tm.load_state_dict(state_dict(params))
    return jm, to_jax(params), tm


def _x(T, seed=1):
    return np.random.default_rng(seed).standard_normal((B, T, D)).astype(
        np.float32) * 0.5


def check_cache(tc, jc, tol=MODULE_TOL):
    assert tc._fields == jc._fields
    for name in jc._fields:
        got, want = n(getattr(tc, name)), np.asarray(getattr(jc, name))
        if name in INTS:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, err_msg=name, **tol)


@pytest.mark.parametrize("bs,T1,with_valid", [(2, 11, False), (4, 13, False),
                                              (4, 14, True)])
def test_block_prefill_then_decode_matches_jax(bs, T1, with_valid):
    """Prefill of a prompt whose last block is partial (right-padded rows
    too), then 9 streaming decode steps, which complete blocks and evict
    candidates: outputs and every cache field after each step."""
    jm, jp, tm = _pair(bs)
    x = _x(T1 + 9)
    CB = 3
    valid = (np.arange(T1)[None] < np.array([[T1], [T1 - 5]])
             if with_valid else None)
    jc = JCache.create(B, H, CB, bs, DH, jnp.float32)
    jy, jc = jax.jit(jm.prefill)(
        jp, jnp.asarray(x[:, :T1]), jc,
        valid=None if valid is None else jnp.asarray(valid))
    with torch.inference_mode():
        tc = MoSABlockKVCache.create(B, H, CB, bs, DH, torch.float32)
        ty, tc = tm.prefill(t(x[:, :T1]), tc,
                            valid=None if valid is None else t(valid))
    np.testing.assert_allclose(n(ty), np.asarray(jy), **MODULE_TOL)
    check_cache(tc, jc)
    if with_valid:
        return
    decode = jax.jit(jm.decode_step)
    for s in range(9):
        xt = x[:, T1 + s:T1 + s + 1]
        jy, jc = decode(jp, jnp.asarray(xt), jc)
        with torch.inference_mode():
            ty, tc = tm.decode_step(t(xt), tc)
        np.testing.assert_allclose(n(ty), np.asarray(jy), err_msg=f"step {s}",
                                   **MODULE_TOL)
        check_cache(tc, jc)


@pytest.mark.parametrize("splits", [(8, 13), (12, 9), (10, 5, 6)])
def test_block_prefill_past_chunked_matches_jax_and_one_shot(splits):
    """Chunked prefill, block-aligned and not (a chunk ends inside a block
    and the next one straddles it), three-way too: every chunk's outputs
    and cache equal the JAX package's, and the final cache is the one-shot
    prefill's (integer state identical, floats within 1e-5), with the last
    chunk's outputs those of the one-shot forward."""
    jm, jp, tm = _pair(4)
    T = sum(splits)
    x = _x(T, seed=12)
    CB = 4
    jc = JCache.create(B, H, CB, 4, DH, jnp.float32)
    with torch.inference_mode():
        tc = MoSABlockKVCache.create(B, H, CB, 4, DH, torch.float32)
        one_y, one_c = tm.prefill(t(x), MoSABlockKVCache.create(
            B, H, CB, 4, DH, torch.float32))
        off = 0
        for i, w in enumerate(splits):
            xs = x[:, off:off + w]
            if i == 0:
                jy, jc = jax.jit(jm.prefill)(jp, jnp.asarray(xs), jc)
                ty, tc = tm.prefill(t(xs), tc)
            else:
                jy, jc = jax.jit(jm.prefill_past)(jp, jnp.asarray(xs), jc)
                ty, tc = tm.prefill_past(t(xs), tc)
            np.testing.assert_allclose(n(ty), np.asarray(jy),
                                       err_msg=f"chunk {i}", **MODULE_TOL)
            check_cache(tc, jc)
            off += w
    check_cache(tc, one_c)
    np.testing.assert_allclose(n(ty), n(one_y[:, T - splits[-1]:]),
                               **MODULE_TOL)


def test_block_prefill_past_right_padded_matches_jax():
    """A suffix with right-pad tokens (``valid``), the form the packed
    prefill hands each segment."""
    jm, jp, tm = _pair(4)
    x = _x(22, seed=13)
    valid = np.arange(13)[None] < np.array([[13], [6]])
    jc = JCache.create(B, H, 3, 4, DH, jnp.float32)
    _, jc = jax.jit(jm.prefill)(jp, jnp.asarray(x[:, :9]), jc)
    jy, jc = jax.jit(jm.prefill_past)(jp, jnp.asarray(x[:, 9:]), jc,
                                      valid=jnp.asarray(valid))
    with torch.inference_mode():
        tc = MoSABlockKVCache.create(B, H, 3, 4, DH, torch.float32)
        _, tc = tm.prefill(t(x[:, :9]), tc)
        ty, tc = tm.prefill_past(t(x[:, 9:]), tc, t(valid))
    np.testing.assert_allclose(n(ty), np.asarray(jy), **MODULE_TOL)
    check_cache(tc, jc)


# ------------------------------------------------------- whole model
def _block_cfg(bs=8, impl="pallas"):
    cfg = get_config("mosa-paper", preset="smoke", variant="mosa",
                     sparsity=4, selection_granularity="block",
                     sel_block_size=bs)
    return dataclasses.replace(cfg, mosa=dataclasses.replace(cfg.mosa,
                                                             impl=impl))


@pytest.fixture(scope="module")
def block_model():
    cfg = _block_cfg()
    shapes = jax.eval_shape(JLM(cfg).init, jax.random.PRNGKey(0))
    return cfg, numpy_params(shapes, seed=2)


def test_block_generate_tokens_match_jax(block_model):
    """``Server.generate`` with paged dense KV (block 8) and block-choice
    MoSA (bs 8, the kernel path: plain versions on the CPU): greedy tokens
    equal the JAX server's, and so do the MoSA caches' block indices."""
    cfg, params = block_model
    G, P = 8, 21
    prompts = np.random.default_rng(3).integers(2, cfg.vocab, (B, P),
                                                dtype=np.int32)
    jsrv = JServer(cfg, batch=B, max_len=48, params=to_jax(params),
                   paged=JPagedConfig(block_size=8))
    tsrv = Server(torch_config(cfg), batch=B, max_len=48,
                  params=params_from_jax(cfg, params),
                  paged=PagedConfig(block_size=8), device="cpu")
    jt, jc = jsrv.generate(jnp.asarray(prompts), G)
    tt, tc = tsrv.generate(torch.from_numpy(prompts), G)
    np.testing.assert_array_equal(n(tt), np.asarray(jt))
    # the JAX caches stack the layers on a leading axis
    (jstack,) = [c for c in jax.tree.leaves(
        jc, is_leaf=lambda x: isinstance(x, JCache)) if isinstance(c, JCache)]
    for u, c in enumerate(tc):
        assert isinstance(c["sparse"], MoSABlockKVCache)
        check_cache(c["sparse"], JCache(*(np.asarray(f)[u] for f in jstack)),
                    MODEL_TOL)


def _serve_both(cfg, params, reqs, num_blocks, **kw):
    jsrv = JServer(cfg, batch=2, max_len=64, params=to_jax(params),
                   paged=JPagedConfig(block_size=8, num_blocks=num_blocks))
    tsrv = Server(torch_config(cfg), batch=2, max_len=64,
                  params=params_from_jax(cfg, params),
                  paged=PagedConfig(block_size=8, num_blocks=num_blocks),
                  device="cpu")
    js, ts = JScheduler(jsrv, **kw), Scheduler(tsrv, **kw)
    for p, m in reqs:
        assert js.submit(p, m) == ts.submit(p, m)
    return js, ts, js.run(), ts.run()


def _shared_prefix_requests(vocab, seed, bare_tail):
    """A 32-token shared prefix: the first request carries ``bare_tail``
    tokens of its own, three more carry 9-24 each; 6 new tokens each."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(2, vocab, (32,), dtype=np.int32)
    tails = [bare_tail] + [int(rng.integers(9, 25)) for _ in range(3)]
    return [(np.concatenate([shared, rng.integers(2, vocab, (L,),
                                                  dtype=np.int32)]), 6)
            for L in tails]


def test_block_scheduler_prefix_hit_exact_matches_jax(block_model):
    """An exact prefix hit on a model whose every layer is MoSA.  Outputs
    of a chunk's tokens feed the next MoSA layer's selection, so a model
    like this one reproduces its tokens only for the same chunk boundaries
    (the JAX package's behaviour too, see the next test).  Here they agree:
    one segment per 16-token chunk, and the first request (33 tokens)
    inserts its snapshot at 32, a chunk boundary of every request.  The
    three later requests hit it; the tokens equal the run without the
    prefix cache, and both runs equal the JAX Scheduler's."""
    cfg, params = block_model
    reqs = _shared_prefix_requests(cfg.vocab, 20, 1)
    kw = dict(chunk=4, chunk_tokens=16, max_prefill_segs=1)
    js, ts, jout, tout = _serve_both(cfg, params, reqs, 40, **kw)
    assert ts.need_snapshot
    _assert_same(js, ts, jout, tout)
    assert ts.stats["prefix_hits"] == 3
    assert ts.stats["prefix_hit_tokens"] == 3 * 32
    js2, ts2, jout2, tout2 = _serve_both(cfg, params, reqs, 40,
                                         prefix_cache=False, **kw)
    _assert_same(js2, ts2, jout2, tout2)
    for rid in tout:
        assert torch.equal(tout[rid], tout2[rid]), rid


def test_block_scheduler_packed_prefix_hits_match_jax(block_model):
    """Prefix hits at 32 with up to 4 segments per 16-token chunk, so
    chunk boundaries fall anywhere: identical tokens and stats to the JAX
    Scheduler.  (With these boundaries the tokens of some requests differ
    from the run without the prefix cache, in both packages.)"""
    cfg, params = block_model
    reqs = _shared_prefix_requests(cfg.vocab, 21, 1)
    js, ts, jout, tout = _serve_both(cfg, params, reqs, 40, chunk=4,
                                     chunk_tokens=16)
    _assert_same(js, ts, jout, tout)
    assert ts.stats["prefix_hits"] >= 2


def test_block_scheduler_preemption_matches_jax(block_model):
    """Preempt-to-recompute on 5 blocks (the case of the JAX package's
    block-choice preemption test): identical tokens and stats, every
    request its max_new, every block back."""
    cfg, params = block_model
    rng = np.random.default_rng(15)
    reqs = [(rng.integers(2, cfg.vocab, (10,), dtype=np.int32), 12)
            for _ in range(2)]
    js, ts, jout, tout = _serve_both(cfg, params, reqs, 5, chunk=4,
                                     prefix_cache=False)
    _assert_same(js, ts, jout, tout)
    assert {k: len(v) for k, v in tout.items()} == {0: 12, 1: 12}
    assert ts.stats["preemptions"] >= 1
    assert ts.dense_pool.free_blocks == ts.dense_pool.num_blocks


def test_block_row_snapshot_round_trip_and_health():
    """A host snapshot of one row of a block cache is a copy (never a
    view), ``row_restore`` writes it back bit for bit, and the Scheduler's
    router health of a block snapshot is the JAX package's."""
    g = torch.Generator().manual_seed(0)
    CB, bs = 3, 4
    c = MoSABlockKVCache(
        torch.randn(3, H, (CB + 1) * bs, DH, generator=g),
        torch.randn(3, H, (CB + 1) * bs, DH, generator=g),
        torch.randint(-1, 64, (3, H, (CB + 1) * bs), generator=g),
        torch.rand(3, H, CB + 1, generator=g),
        torch.randint(-1, 16, (3, H, CB + 1), generator=g),
        torch.randn(3, H, generator=g),
        torch.arange(3, dtype=torch.int32) + 5)
    caches = [{"sparse": c}]
    snap = row_snapshot(caches, 1)
    want = [f[1].clone() for f in c]
    with torch.inference_mode():
        zero = [{"sparse": MoSABlockKVCache(*(torch.zeros_like(f)
                                              for f in c))}]
        for f in c:
            f.zero_()                           # the snapshot is no view
        row_restore(zero, snap, 1)
    for name, a, b in zip(c._fields, zero[0]["sparse"], want):
        assert torch.equal(a[1], b), name
    jsnap = {"sparse": JCache(*(np.asarray(f) for f in snap[0]["sparse"]))}
    got, exp = health_from_snapshot(snap, 40), jhealth_from_snapshot(jsnap,
                                                                     40)
    assert got.keys() == exp.keys() and got
    for k in got:
        np.testing.assert_allclose(got[k], exp[k], rtol=1e-12, err_msg=k)
