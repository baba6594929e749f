"""Block-choice MoSA below the layer, against the JAX package on the CPU:
the router helpers (``block_pool_scores``, ``expand_block_index``, the
top-k over block means with ties), ``MoSABlockKVCache``, the plain
versions of kernels #5-#8 (``kernels.mosa_block``) and the autograd
Function that joins #6-#8.

Oracles: ``repro.kernels.ref.mosa_block_attention_ref`` (pure jnp) at every
block size, and the Pallas kernels themselves in interpret mode
(``mosa_block_attention_pallas`` / ``_fwd_res`` / ``_bwd_pallas``) at one
tiny size with empty blocks, a ragged tail and two segments.

Tolerances: fp32 on both sides, 1e-5 (``KERNEL_TOL``: one attention op in
another summation order); integer selections exactly equal.  At bs = 1 the
block functions must equal the port's token-choice functions bit for bit
(same masks, same float operations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kv_cache as jkv
from repro.core import router as jrouter
from repro.kernels import mosa_block as jblock
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.core import router as trouter
from repro_torch.core.kv_cache import MoSABlockKVCache
from repro_torch.kernels import mosa_attention as kmosa
from repro_torch.kernels import mosa_backward as kbwd
from repro_torch.kernels import mosa_block as kblock
from repro_torch.kernels.mosa_vjp import MoSAAttentionFunction

from test_torch_parity import (KERNEL_TOL, n, one_cpu_thread,  # noqa: F401
                               t)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


# ------------------------------------------------------------ router
@pytest.mark.parametrize("T,bs", [(37, 1), (37, 4), (32, 16), (5, 16),
                                  (48, 2)])
def test_block_pool_scores_match_jax(T, bs):
    """The masked block mean, ragged last block included; bitwise at
    bs = 1."""
    s = np.random.default_rng(T * bs).random((2, 3, T)).astype(np.float32)
    want = np.asarray(jrouter.block_pool_scores(jnp.asarray(s), bs))
    got = n(trouter.block_pool_scores(t(s), bs))
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-6)
    if bs == 1:
        np.testing.assert_array_equal(got, s)


def test_block_topk_ties_and_expansion_match_jax():
    """Top-k over block means where many means tie (repeated scores, and
    all-pad blocks at -1.0): the port's stable ``topk_indices`` picks the
    JAX package's blocks, lower index first; ``expand_block_index`` gives
    the same positions with -1 for empty slots and the ragged tail."""
    rng = np.random.default_rng(3)
    T, bs = 45, 4
    s = np.round(rng.random((2, 5, T)), 1).astype(np.float32)   # ties
    s[..., 30:] = -1.0                                # all-pad blocks tie
    bsc = jrouter.block_pool_scores(jnp.asarray(s), bs)
    for k, force in ((3, True), (9, False), (12, True)):
        jr, jb = jrouter.select_topk(bsc, k, force)
        tr, tb = trouter.select_topk(t(np.asarray(bsc)), k, force)
        np.testing.assert_array_equal(n(tb), np.asarray(jb))
        np.testing.assert_array_equal(n(tr), np.asarray(jr))
    bidx = np.asarray(jb).astype(np.int32)
    bidx[0, 1, 2] = -1
    bidx[1, 0, -1] = T // bs                          # the ragged block
    np.testing.assert_array_equal(
        n(trouter.expand_block_index(t(bidx).long(), bs, T)),
        np.asarray(jrouter.expand_block_index(jnp.asarray(bidx), bs, T)))


def test_block_cache_create_matches_jax():
    j = jkv.MoSABlockKVCache.create(2, 3, 4, 8, 16, jnp.float32)
    c = MoSABlockKVCache.create(2, 3, 4, 8, 16, torch.float32)
    assert c._fields == j._fields
    for name in j._fields:
        np.testing.assert_array_equal(n(getattr(c, name)),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert (c.block_size, c.n_cand, c.kv_entries) == (j.block_size, j.n_cand,
                                                      j.kv_entries)


# ------------------------------------------------------ plain versions
def _inputs(B, H, NB, bs, T, d=16, empty=0, ragged=False, two_segs=False,
            seed=0):
    """Block-major inputs: per (b, h) NB sorted distinct blocks of a
    length-T sequence; ``empty`` random slots set to -1 (sorted last, as
    the layer keeps them); ``ragged`` puts the sequence's last, short block
    in every row; ``two_segs`` splits positions into two documents."""
    rng = np.random.default_rng(seed)
    nbt = -(-T // bs)
    bidx = np.stack([np.sort(rng.permutation(nbt - 1)[:NB]) for _ in
                     range(B * H)]).reshape(B, H, NB).astype(np.int32)
    if ragged:
        bidx[..., -1] = nbt - 1
        bidx = np.sort(bidx, -1)
    for _ in range(empty):
        b, h = rng.integers(B), rng.integers(H)
        bidx[b, h, -1 - rng.integers(NB - 1)] = -1
        bidx[b, h] = np.concatenate([np.sort(bidx[b, h][bidx[b, h] >= 0]),
                                     bidx[b, h][bidx[b, h] < 0]])
    S = NB * bs
    q, k, v = (rng.standard_normal((B, H, S, d)).astype(np.float32)
               for _ in range(3))
    rblk = (1 / (1 + np.exp(-rng.standard_normal((B, H, NB))))).astype(
        np.float32)
    seg = None
    if two_segs:
        pos = np.asarray(jrouter.expand_block_index(jnp.asarray(bidx), bs, T))
        seg = np.where(np.clip(pos, 0, None) < T // 2, 0, 1).astype(np.int32)
    return q, k, v, bidx, rblk, seg


CASES = {"bs1": dict(B=2, H=2, NB=9, bs=1, T=30),
         "bs2 empty": dict(B=2, H=2, NB=5, bs=2, T=30, empty=3),
         "bs4 ragged two segs": dict(B=2, H=3, NB=4, bs=4, T=31, ragged=True,
                                     two_segs=True, empty=2),
         "bs16 ragged": dict(B=1, H=2, NB=2, bs=16, T=40, ragged=True)}


def _tseg(seg):
    return None if seg is None else t(seg)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_forward_matches_jax_ref(case):
    """#5's plain version against ``ref.mosa_block_attention_ref``; #6's
    ``o_pre`` is #5's output before the block score (both zero on
    invalid rows)."""
    kw = CASES[case]
    q, k, v, bidx, rblk, seg = _inputs(**kw)
    bs, T = kw["bs"], kw["T"]
    want = jref.mosa_block_attention_ref(
        *map(jnp.asarray, (q, k, v, bidx, rblk)), bs, T,
        seg=None if seg is None else jnp.asarray(seg))
    got = kblock.mosa_block_attention_ref(t(q), t(k), t(v), t(bidx),
                                          t(rblk), bs, T, seg=_tseg(seg))
    np.testing.assert_allclose(n(got), np.asarray(want), **KERNEL_TOL)
    o_pre, _ = kblock.mosa_block_attention_fwd_res_ref(
        t(q), t(k), t(v), t(bidx), bs, T, seg=_tseg(seg))
    r_tok = np.repeat(rblk, bs, -1)[..., None]
    np.testing.assert_allclose(n(o_pre) * r_tok, np.asarray(want),
                               **KERNEL_TOL)


def test_plain_versions_match_pallas_interpret():
    """#5, #6 and #7/#8 plain against the Pallas kernels in interpret mode
    (tiles of 8 rows, bs 4): empty blocks, a ragged tail, two segments."""
    q, k, v, bidx, rblk, seg = _inputs(B=1, H=2, NB=4, bs=4, T=23,
                                       ragged=True, two_segs=True, empty=1,
                                       seed=5)
    bs, T = 4, 23
    kw = dict(block_q=8, block_k=8, bs=bs, T=T, interpret=True)
    jin = [jnp.asarray(a) for a in (q, k, v, bidx)]
    jseg, tin = jnp.asarray(seg), [t(a) for a in (q, k, v, bidx)]
    want = jblock.mosa_block_attention_pallas(*jin, jseg, jnp.asarray(rblk),
                                              **kw)
    got = kblock.mosa_block_attention_ref(*tin, t(rblk), bs, T, seg=t(seg))
    np.testing.assert_allclose(n(got), np.asarray(want), **KERNEL_TOL)

    jo, jlse = jblock.mosa_block_attention_fwd_res(*jin, jseg,
                                                   jnp.asarray(rblk), **kw)
    o_pre, lse = kblock.mosa_block_attention_fwd_res_ref(*tin, bs, T,
                                                         seg=t(seg))
    np.testing.assert_allclose(n(o_pre), np.asarray(jo), **KERNEL_TOL)
    np.testing.assert_allclose(n(lse), np.asarray(jlse), **KERNEL_TOL)

    rng = np.random.default_rng(6)
    _, ok = kblock.expand_blocks(t(bidx), bs, T)
    gt = rng.standard_normal(q.shape).astype(np.float32) * n(ok)[..., None]
    delta = (gt * n(o_pre)).sum(-1)
    jgrads = jblock.mosa_block_attention_bwd_pallas(
        *jin, jseg, jnp.asarray(gt), jlse, jnp.asarray(delta), **kw)
    tgrads = kblock.mosa_block_attention_bwd_ref(*tin, t(gt), lse, t(delta),
                                                 bs, T, seg=t(seg))
    for name, a, b in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(n(a), np.asarray(b), err_msg=name,
                                   **KERNEL_TOL)


# The fused backward's edge cases of the card's checks, at smoke size:
# S = 64 exactly (4 blocks of 16) and bs 3 (S = 21, not a multiple of 4)
# with a ragged last block and empty slots; and the split backward's S =
# 128.  (inputs, Pallas tile rows)
BWD_EDGE_CASES = {
    "S64 NB4 bs16 ragged two segs": (dict(B=1, H=2, NB=4, bs=16, T=100,
                                          ragged=True, two_segs=True,
                                          empty=1), 32),
    "bs3 S21 ragged empty": (dict(B=2, H=2, NB=7, bs=3, T=50, ragged=True,
                                  empty=3), 21),
    # the split #7/#8's route (S = NB * bs = 128 > 64), one 128-row tile
    "S128 NB8 bs16 ragged two segs": (dict(B=1, H=1, NB=8, bs=16, T=1000,
                                           ragged=True, two_segs=True,
                                           empty=2), 128),
}


@pytest.mark.parametrize("case", list(BWD_EDGE_CASES))
def test_plain_backward_matches_pallas_interpret(case):
    """#7/#8's plain version against ``mosa_block_attention_bwd_pallas`` in
    interpret mode, on g~ (zero on invalid query rows), lse and delta from
    the Pallas training forward; fp32 within ``KERNEL_TOL``."""
    kw, tile = BWD_EDGE_CASES[case]
    q, k, v, bidx, _, seg = _inputs(**kw, seed=11)
    bs, T = kw["bs"], kw["T"]
    jseg = jnp.asarray(seg if seg is not None else
                       np.zeros(q.shape[:3], np.int32))
    jin = [jnp.asarray(a) for a in (q, k, v, bidx)]
    tin = [t(a) for a in (q, k, v, bidx)]
    opts = dict(block_q=tile, block_k=tile, bs=bs, T=T, interpret=True)
    _, jlse = jblock.mosa_block_attention_fwd_res(
        *jin, jseg, jnp.ones(bidx.shape, jnp.float32), **opts)
    o_pre, lse = kblock.mosa_block_attention_fwd_res_ref(*tin, bs, T,
                                                         seg=_tseg(seg))
    np.testing.assert_allclose(n(lse), np.asarray(jlse), **KERNEL_TOL)
    _, ok = kblock.expand_blocks(t(bidx), bs, T)
    gt = (np.random.default_rng(12).standard_normal(q.shape)
          .astype(np.float32) * n(ok)[..., None])
    delta = (gt * n(o_pre)).sum(-1)
    jgrads = jblock.mosa_block_attention_bwd_pallas(
        *jin, jseg, jnp.asarray(gt), jlse, jnp.asarray(delta), **opts)
    tgrads = kblock.mosa_block_attention_bwd_ref(*tin, t(gt), lse, t(delta),
                                                 bs, T, seg=_tseg(seg))
    for name, a, b in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(n(a), np.asarray(b), err_msg=name,
                                   **KERNEL_TOL)


@pytest.mark.parametrize("case", ["bs2 empty", "bs4 ragged two segs"])
def test_function_grads_match_jax_grad(case):
    """``MoSABlockAttentionFunction`` on CPU tensors (the plain versions of
    #6-#8 and the wrapper math): output and dq, dk, dv and the per-block
    dr against ``jax.grad`` through ``ops.mosa_block_attention`` (its
    ``custom_vjp`` over the Pallas kernels, interpret mode).  Gradients
    within 1e-5 (fp32, a few ops deep)."""
    kw = CASES[case]
    q, k, v, bidx, rblk, seg = _inputs(**kw, seed=8)
    bs, T = kw["bs"], kw["T"]
    G = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    jseg = None if seg is None else jnp.asarray(seg)

    def jloss(q, k, v, r):
        out = jops.mosa_block_attention(q, k, v, jnp.asarray(bidx), r,
                                        sel_block_size=bs, T=T, seg=jseg)
        return jnp.sum(out * jnp.asarray(G)), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                       has_aux=True)(
        *map(jnp.asarray, (q, k, v, rblk)))
    leaves = [t(a).requires_grad_() for a in (q, k, v, rblk)]
    out = kblock.mosa_block_attention(*leaves[:3], t(bidx), leaves[3], bs, T,
                                      seg=_tseg(seg))
    grads = torch.autograd.grad((out * t(G)).sum(), leaves)
    np.testing.assert_allclose(n(out), np.asarray(jout), **KERNEL_TOL)
    for name, a, b in zip(("dq", "dk", "dv", "dr_blk"), grads, jg):
        np.testing.assert_allclose(n(a), np.asarray(b), err_msg=name,
                                   **KERNEL_TOL)
    ok = n(kblock.expand_blocks(t(bidx), bs, T)[1])
    assert (n(grads[0])[~ok] == 0).all()      # invalid rows get no dq


def test_bs1_equals_token_functions_bitwise():
    """At bs = 1 the plain versions of #5-#8 and the autograd Function are
    the token-choice ones, bit for bit."""
    q, k, v, bidx, rblk, seg = _inputs(B=2, H=2, NB=12, bs=1, T=40,
                                       two_segs=True, seed=10)
    tq, tk, tv, ti, tr, ts = map(t, (q, k, v, bidx, rblk, seg))
    assert torch.equal(kblock.mosa_block_attention_ref(tq, tk, tv, ti, tr, 1,
                                                       40, seg=ts),
                       kmosa.mosa_attention_ref(tq, tk, tv, ti, tr, seg=ts))
    blk = kblock.mosa_block_attention_fwd_res_ref(tq, tk, tv, ti, 1, 40,
                                                  seg=ts)
    tok = kmosa.mosa_attention_fwd_res_ref(tq, tk, tv, ti, seg=ts)
    assert all(torch.equal(a, b) for a, b in zip(blk, tok))
    gt = torch.randn(tq.shape, generator=torch.Generator().manual_seed(0))
    delta = (gt * tok[0]).sum(-1)
    blk = kblock.mosa_block_attention_bwd_ref(tq, tk, tv, ti, gt, tok[1],
                                              delta, 1, 40, seg=ts)
    tok_g = kbwd.mosa_attention_bwd_ref(tq, tk, tv, ti, gt, tok[1], delta,
                                        seg=ts)
    assert all(torch.equal(a, b) for a, b in zip(blk, tok_g))

    grads = []
    for fn in (lambda *a: kblock.MoSABlockAttentionFunction.apply(
            *a[:3], ti, ts, a[3], 1, 40, None),
               lambda *a: MoSAAttentionFunction.apply(*a[:3], ti, ts, a[3],
                                                      None)):
        leaves = [x.clone().requires_grad_() for x in (tq, tk, tv, tr)]
        out = fn(*leaves)
        grads.append([out] + list(torch.autograd.grad(
            (out * gt).sum(), leaves)))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only; the dispatchers send CPU
    tensors to the plain versions and count no launch."""
    q, k, v, bidx, rblk, _ = _inputs(B=1, H=1, NB=2, bs=4, T=16)
    tq, tk, tv, ti, tr = map(t, (q, k, v, bidx, rblk))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kblock.mosa_block_attention_cuda(tq, tk, tv, ti, tr, 4, 16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kblock.mosa_block_attention_fwd_res_cuda(tq, tk, tv, ti, 4, 16)
    counters = (kblock.LAUNCHES, kblock.LAUNCHES_FWD_RES, kblock.LAUNCHES_DQ,
                kblock.LAUNCHES_DKV)
    before = [c.count for c in counters]
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv, tr)]
    out = kblock.mosa_block_attention(*leaves[:3], ti, leaves[3], 4, 16)
    out.sum().backward()
    kblock.mosa_block_attention(tq, tk, tv, ti, tr, 4, 16)
    assert [c.count for c in counters] == before
