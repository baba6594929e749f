"""The packed-prefill layers of the Scheduler slice against the JAX package,
with converted weights, fp32 on the CPU: ``MoSAAttention.prefill_past``
(constant-k and growing-k selection), ``MultiHeadAttention``,
``HybridAttention`` and ``TransformerLM.prefill_packed`` (outputs and every
cache leaf), with an inactive segment and a padding tail in the chunk.

Tolerances: 1e-5 per module (``MODULE_TOL``), 1e-4 for whole-model logits
and caches after a stack of layers (``MODEL_TOL``); selected indices,
lengths and block tables identical.  Router scores of random inputs are
distinct, so both frameworks select the same tokens."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttentionConfig as JAttentionConfig
from repro.configs.base import MoSAConfig as JMoSAConfig
from repro.configs.base import get_config
from repro.core.attention import MultiHeadAttention as JMHA
from repro.core.hybrid import HybridAttention as JHybrid
from repro.core.kv_cache import MoSAKVCache as JMoSAKVCache
from repro.core.mosa import MoSAAttention as JMoSA
from repro.launch.serve import set_dense_tables as jset_tables
from repro.nn.transformer import TransformerLM as JLM
from repro.serve.paged_kv import PagedConfig as JPagedConfig
from repro.serve.paged_kv import PagedDenseKVCache as JPaged

from repro_torch.configs.base import AttentionConfig, MoSAConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.attention import MultiHeadAttention
from repro_torch.core.hybrid import HybridAttention
from repro_torch.core.kv_cache import MoSAKVCache
from repro_torch.core.mosa import MoSAAttention
from repro_torch.launch.serve import set_dense_tables
from repro_torch.nn.transformer import TransformerLM
from repro_torch.serve.paged_kv import PagedConfig, PagedDenseKVCache

from test_torch_parity import (MODEL_TOL, MODULE_TOL, n, numpy_params,
                               one_cpu_thread, t, to_jax,  # noqa: F401
                               torch_config)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

D_MODEL, B = 64, 2


def state_dict(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(state_dict(v, key) if isinstance(v, dict) else {key: t(v)})
    return out


def close(got, want, tol=MODULE_TOL):
    np.testing.assert_allclose(n(got), np.asarray(want), **tol)


def check_mosa_cache(tc, jc, tol=MODULE_TOL):
    np.testing.assert_array_equal(n(tc.idx), np.asarray(jc.idx))
    np.testing.assert_array_equal(n(tc.length), np.asarray(jc.length))
    close(tc.scores, jc.scores, tol)
    close(tc.k, jc.k, tol)
    close(tc.v, jc.v, tol)


# (k_fixed, min_k, capacity): the constant-k schedule, and the growing
# k = T / rho with capacity above k_for(14) = 3 (the case where a prefix
# token ranked in (k_for(prefix), capacity] must survive the boundary)
SCHEDULES = {"constant-k": (6, 2, 6), "growing-k": (0, 2, 8)}


def mosa_pair(k_fixed, min_k, seed=0):
    jcfg = JMoSAConfig(n_mosa_heads=3, sparsity=4, n_dense_heads=0,
                       d_head=8, k_fixed=k_fixed, min_k=min_k)
    jm = JMoSA(D_MODEL, jcfg)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed)
    tm = MoSAAttention(D_MODEL, MoSAConfig(**dataclasses.asdict(jcfg)))
    tm.load_state_dict(state_dict(params))
    return jm, to_jax(params), tm


def _x(seed, T):
    return np.random.default_rng(seed).standard_normal(
        (B, T, D_MODEL)).astype(np.float32)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("with_valid", [False, True])
def test_mosa_prefill_past_matches_jax(schedule, with_valid):
    """prefill(prefix) then prefill_past(suffix): suffix outputs and the
    cache after it equal the JAX package's (a right-padded suffix row
    with ``valid`` too)."""
    k_fixed, min_k, kc = SCHEDULES[schedule]
    jm, jp, tm = mosa_pair(k_fixed, min_k)
    P, cut = 14, 8
    x = _x(1, P)
    valid = np.arange(P - cut)[None] < np.array([[P - cut], [P - cut - 2]])
    jv, tv = (jnp.asarray(valid), t(valid)) if with_valid else (None, None)
    jc = JMoSAKVCache.create(B, 3, kc, 8, jnp.float32)
    _, jc = jm.prefill(jp, jnp.asarray(x[:, :cut]), jc)
    jy, jc = jm.prefill_past(jp, jnp.asarray(x[:, cut:]), jc, None, jv)
    with torch.inference_mode():
        tc = MoSAKVCache.create(B, 3, kc, 8, torch.float32)
        _, tc = tm.prefill(t(x[:, :cut]), tc)
        ty, tc = tm.prefill_past(t(x[:, cut:]), tc, tv)
    close(ty, jy)
    check_mosa_cache(tc, jc)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_mosa_prefill_past_equals_one_shot(schedule):
    """Within the port: prefill(prefix) + prefill_past(suffix) reproduces
    one-shot prefill — identical selected indices, scores and K/V, and the
    suffix outputs of the one-shot selection width; boundary storage is
    capacity-wide."""
    k_fixed, min_k, kc = SCHEDULES[schedule]
    _, _, tm = mosa_pair(k_fixed, min_k)
    P, cut = 14, 8
    x = t(_x(2, P))
    with torch.inference_mode():
        c1 = MoSAKVCache.create(B, 3, kc, 8, torch.float32)
        y1, c1 = tm.prefill(x, c1)
        c2 = MoSAKVCache.create(B, 3, kc, 8, torch.float32)
        _, c2 = tm.prefill(x[:, :cut], c2)
        y2, c2 = tm.prefill_past(x[:, cut:], c2)
    assert torch.equal(c1.idx, c2.idx)
    torch.testing.assert_close(c1.scores, c2.scores, atol=1e-6, rtol=0)
    torch.testing.assert_close(c1.k, c2.k, **MODULE_TOL)
    torch.testing.assert_close(y1[:, cut:], y2, **MODEL_TOL)
    assert ((c2.idx >= 0).sum(-1) == min(kc, P)).all()


# ----------------------------------------------------------- packed chunks
def packed_chunk(seed, C, segs, vocab=None):
    """A chunk: (x or tokens, cu, rows, past) for ``segs`` = (row, past,
    len) per segment (row -1 inactive), C >= the packed length (padding
    tail)."""
    rng = np.random.default_rng(seed)
    cu = np.concatenate([[0], np.cumsum([L for _, _, L in segs])]).astype(
        np.int32)
    rows = np.asarray([r for r, _, _ in segs], np.int32)
    past = np.asarray([p for _, p, _ in segs], np.int32)
    if vocab is None:
        data = rng.standard_normal((1, C, D_MODEL)).astype(np.float32)
    else:
        data = rng.integers(2, vocab, (1, C)).astype(np.int32)
    return data, cu, rows, past


def _meta_of(cu, rows, past, C):
    """The meta dict both frameworks' layer methods take, built by their
    own ``TransformerLM.prefill_packed`` code (recomputed here)."""
    t_ = np.arange(C)
    seg = np.searchsorted(cu[1:], t_, side="right")
    seg = np.where(t_ < cu[-1], seg, -1)
    segc = np.maximum(seg, 0)
    local = t_ - cu[segc]
    row_of_tok = np.where(seg >= 0, rows[segc], -1)
    pos_of_tok = np.where(row_of_tok >= 0, past[segc] + local, 0)
    tok_idx = np.clip(cu[:-1, None] + t_[None], 0, C - 1)
    in_seg = (t_[None] < (cu[1:] - cu[:-1])[:, None]) & (rows >= 0)[:, None]
    meta = dict(cu=cu, rows=rows, past_lens=past, seg_of_tok=seg,
                local_of_tok=local, row_of_tok=row_of_tok,
                pos_of_tok=pos_of_tok, tok_idx=tok_idx, in_seg=in_seg)
    jmeta = {k: jnp.asarray(v.astype(np.int32) if v.dtype != bool else v)
             for k, v in meta.items()}
    tmeta = {k: torch.from_numpy(v if v.dtype == bool else
                                 v.astype(np.int64)) for k, v in meta.items()}
    for k in ("cu", "rows", "past_lens"):
        tmeta[k] = tmeta[k].to(torch.int32)
    return jmeta, tmeta


def paged_caches(B_, nb, bs, Hkv, d, lengths, seed):
    """A JAX and a port paged cache holding ``lengths`` tokens of random
    past KV per row under a shuffled table."""
    rng = np.random.default_rng(seed)
    P = B_ * nb
    kp = rng.standard_normal((P, bs, Hkv, d)).astype(np.float32)
    vp = rng.standard_normal((P, bs, Hkv, d)).astype(np.float32)
    table = rng.permutation(P).reshape(B_, nb).astype(np.int32)
    ln = np.asarray(lengths, np.int32)
    j = JPaged(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
               jnp.asarray(ln))
    tc = PagedDenseKVCache(t(kp), t(vp), t(table), t(ln))
    return j, tc


def check_paged(tc, jc, tol=MODULE_TOL):
    close(tc.k, jc.k, tol)
    close(tc.v, jc.v, tol)
    np.testing.assert_array_equal(n(tc.length), np.asarray(jc.length))
    np.testing.assert_array_equal(n(tc.block_table),
                                  np.asarray(jc.block_table))


# rows 0..2 continue their caches (row 1 from 0 tokens), one inactive
# segment, and a padding tail of 3 slots
SEGS = [(2, 5, 4), (0, 9, 6), (-1, 0, 2), (1, 0, 5)]
C = 20


def test_mha_prefill_packed_matches_jax():
    jcfg = JAttentionConfig(kind="gqa", n_heads=4, n_kv_heads=2, d_head=16)
    jm = JMHA(D_MODEL, jcfg)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 3)
    tm = MultiHeadAttention(D_MODEL, AttentionConfig(
        **dataclasses.asdict(jcfg)))
    tm.load_state_dict(state_dict(params))
    x, cu, rows, past = packed_chunk(4, C, SEGS)
    jc, tc = paged_caches(3, 5, 4, 2, 16, [9, 0, 5], seed=5)
    jmeta, tmeta = _meta_of(cu, rows, past, C)
    jy, jc = jm.prefill_packed(to_jax(params), jnp.asarray(x), jc, jmeta)
    with torch.inference_mode():
        ty, tc = tm.prefill_packed(t(x), tc, tmeta)
    close(ty, jy)
    check_paged(tc, jc)
    # the inactive segment and the padding tail attend nothing
    dead = np.asarray(jmeta["row_of_tok"]) < 0
    assert dead.sum() == 5 and (n(ty)[0, dead] == 0).all()


def test_hybrid_prefill_packed_matches_jax():
    jcfg = JMoSAConfig(n_mosa_heads=3, sparsity=4, n_dense_heads=2,
                       d_head=16, min_k=2)
    jm = JHybrid(D_MODEL, jcfg)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 6)
    tm = HybridAttention(D_MODEL, MoSAConfig(**dataclasses.asdict(jcfg)))
    tm.load_state_dict(state_dict(params))
    jp = to_jax(params)
    ML, bs = 20, 4
    # prefill rows 0 and 2 through a first packed chunk, then continue
    pre_segs = [(0, 0, 9), (2, 0, 5), (-1, 0, 0), (-1, 0, 0)]
    jcache = jm.init_cache(3, ML, jnp.float32,
                           paged=JPagedConfig(bs, num_blocks=15))
    tcache = tm.init_cache(3, ML, torch.float32,
                           paged=PagedConfig(bs, num_blocks=15))
    table = np.random.default_rng(7).permutation(15).reshape(3, 5).astype(
        np.int32)
    jcache["dense"] = jcache["dense"]._replace(block_table=jnp.asarray(table))
    tcache["dense"].block_table.copy_(t(table))
    for seed, segs in ((8, pre_segs), (9, SEGS)):
        x, cu, rows, past = packed_chunk(seed, C, segs)
        jmeta, tmeta = _meta_of(cu, rows, past, C)
        jy, jcache = jm.prefill_packed(jp, jnp.asarray(x), jcache, jmeta)
        with torch.inference_mode():
            ty, tcache = tm.prefill_packed(t(x), tcache, tmeta)
        close(ty, jy)
        check_paged(tcache["dense"], jcache["dense"])
        check_mosa_cache(tcache["sparse"], jcache["sparse"])
    assert n(tcache["dense"].length).tolist() == [15, 5, 9]


def test_lm_prefill_packed_matches_jax():
    """Two chunks through the smoke LM (the second continues rows 0 and 2
    and starts row 1): logits (N, V) at each segment's last token and
    every cache leaf of every layer equal the JAX package's."""
    cfg = get_config("mosa-paper", preset="smoke", variant="mosa")
    jlm = JLM(cfg)
    params = numpy_params(jax.eval_shape(jlm.init, jax.random.PRNGKey(0)), 0)
    tlm = TransformerLM(torch_config(cfg))
    tlm.load_state_dict(params_from_jax(cfg, params))
    jp = to_jax(params)
    ML, bs = 24, 8
    jc = jlm.init_cache(3, ML, jnp.float32,
                        paged=JPagedConfig(bs, num_blocks=9))
    with torch.inference_mode():
        tc = tlm.init_cache(3, ML, torch.float32,
                            paged=PagedConfig(bs, num_blocks=9))
    table = np.asarray([[4, 0, -1], [8, 2, 6], [1, 7, 3]], np.int32)
    for b in range(3):
        jc = jset_tables(jc, jnp.asarray(table[b]), b)
        with torch.inference_mode():
            set_dense_tables(tc, t(table[b]), b)
    for seed, segs in ((10, [(0, 0, 9), (2, 0, 5), (-1, 0, 0)]),
                       (11, [(2, 5, 4), (0, 9, 6), (-1, 0, 2), (1, 0, 5)])):
        toks, cu, rows, past = packed_chunk(seed, C, segs, vocab=cfg.vocab)
        jl, jc = jlm.prefill_packed(jp, jnp.asarray(toks), jc,
                                    jnp.asarray(cu), jnp.asarray(rows),
                                    jnp.asarray(past))
        with torch.inference_mode():
            tl, tc = tlm.prefill_packed(t(toks).long(), tc, t(cu), t(rows),
                                        t(past))
        assert tl.shape == (len(segs), cfg.vocab)
        live = rows >= 0
        close(tl[live], np.asarray(jl)[live], MODEL_TOL)
    stacked = jc["scan"]["pos0"]
    for u in range(cfg.n_layers):
        check_paged(tc[u]["dense"],
                    jax.tree.map(lambda a: a[u], stacked["dense"]), MODEL_TOL)
        check_mosa_cache(tc[u]["sparse"],
                         jax.tree.map(lambda a: a[u], stacked["sparse"]),
                         MODEL_TOL)
    assert n(tc[0]["dense"].length).tolist() == [15, 5, 9]
