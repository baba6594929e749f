"""Sliding-window dense heads of the port against the JAX package on the
CPU, with weights and inputs made by numpy from a seed: the window rings
(``WindowKVCache``, ``PagedWindowKVCache``: append, decode append,
gather, ring wrap), ``MultiHeadAttention``'s window prefill,
decode and packed prefill on both rings, ``HybridAttention`` with
``dense_impl="kernel"`` (the flash kernel's plain version on the CPU)
against JAX's ``dense_impl="pallas"`` (interpret mode), the gated combine
of block choice beside window heads (forward and every gradient, ``gate``
included), the ``gate`` through ``convert.py`` both ways, the autograd
refusal of ``impl="kernel"``, and a 2-layer ``attn_local``/``attn`` model.

Integer cache state (positions, lengths, tables) must be equal; floats
within 1e-5 (``MODULE_TOL``: one layer in another summation order),
logits after a stack of layers within 1e-4 (``MODEL_TOL``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttentionConfig as JAttentionConfig
from repro.configs.base import BlockSpec as JBlockSpec
from repro.configs.base import MoSAConfig as JMoSAConfig
from repro.configs.base import get_config
from repro.core.attention import MultiHeadAttention as JMHA
from repro.core.hybrid import HybridAttention as JHybrid
from repro.core.kv_cache import WindowKVCache as JWindow
from repro.nn.transformer import TransformerLM as JLM
from repro.serve.paged_kv import PagedWindowKVCache as JPagedWindow

from repro_torch.configs.base import AttentionConfig, MoSAConfig
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.attention import MultiHeadAttention
from repro_torch.core.hybrid import HybridAttention
from repro_torch.core.kv_cache import WindowKVCache
from repro_torch.nn.transformer import TransformerLM
from repro_torch.serve.paged_kv import PagedWindowKVCache

from test_torch_modules import close, state_dict
from test_torch_parity import (MODEL_TOL, MODULE_TOL, n,  # noqa: F401
                               numpy_params, one_cpu_thread, t, to_jax,
                               torch_config)
from test_torch_sched_layers import _meta_of, packed_chunk

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

D_MODEL, B = 64, 2
INTS = ("block_table", "positions", "length")


def check_cache(tc, jc, tol=MODULE_TOL):
    assert tc._fields == jc._fields
    for name in jc._fields:
        got, want = getattr(tc, name), getattr(jc, name)
        if name in INTS:
            np.testing.assert_array_equal(n(got), np.asarray(want),
                                          err_msg=name)
        else:
            close(got, want, **tol)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------- the rings
def test_window_cache_ring_wrap_matches_jax():
    """19 decode appends into a ring of 8: every slot rewritten twice."""
    W, Hkv, d = 8, 2, 4
    rng = np.random.default_rng(0)
    jc = JWindow.create(B, W, Hkv, d, jnp.float32)
    tc = WindowKVCache.create(B, W, Hkv, d, torch.float32)
    # rows at different positions (continuous batching)
    jc = jc._replace(length=jnp.asarray([0, 3], jnp.int32))
    tc = tc._replace(length=torch.tensor([0, 3], dtype=torch.int32))
    for _ in range(19):
        k, v = _rand(rng, B, Hkv, d), _rand(rng, B, Hkv, d)
        jc = jc.append_one(jnp.asarray(k), jnp.asarray(v))
        tc = tc.append_one(t(k), t(v))
        check_cache(tc, jc, dict(atol=0, rtol=0))


def _paged_window_pair(W, bs, table):
    Hkv, d = 2, 4
    table = np.asarray(table, np.int32)
    N = int(table.max()) + 2
    jc = JPagedWindow.create(B, W, Hkv, d, jnp.float32, block_size=bs,
                             num_blocks=N)
    tc = PagedWindowKVCache.create(B, W, Hkv, d, torch.float32,
                                   block_size=bs, num_blocks=N)
    jc = jc._replace(block_table=jnp.asarray(table))
    tc = tc._replace(block_table=t(table))
    return jc, tc


@pytest.mark.parametrize("table", [[[3, 0], [5, 2]], [[4, 1], [-1, 2]]])
def test_paged_window_cache_matches_jax(table):
    """Prefill append longer than the ring with a right-padded row, decode
    appends across the wrap, gather == the ring; a -1 table entry drops
    the KV writes but not the positions, as in the JAX package."""
    W, bs, Hkv, d = 8, 4, 2, 4
    rng = np.random.default_rng(1)
    jc, tc = _paged_window_pair(W, bs, table)
    T = 11
    k, v = _rand(rng, B, T, Hkv, d), _rand(rng, B, T, Hkv, d)
    nv = np.asarray([11, 6], np.int32)
    jc = jc.append(jnp.asarray(k), jnp.asarray(v), n_valid=jnp.asarray(nv))
    tc = tc.append(t(k), t(v), n_valid=t(nv))
    check_cache(tc, jc, dict(atol=0, rtol=0))
    for _ in range(5):
        k1, v1 = _rand(rng, B, Hkv, d), _rand(rng, B, Hkv, d)
        jc = jc.append_one(jnp.asarray(k1), jnp.asarray(v1))
        tc = tc.append_one(t(k1), t(v1))
        check_cache(tc, jc, dict(atol=0, rtol=0))
    for got, want in zip(tc.gather(), jc.gather()):
        np.testing.assert_array_equal(n(got), np.asarray(want))


# ----------------------------------------------------- MHA on the rings
def _mha_pair(window=8, impl="chunked", seed=4):
    jcfg = JAttentionConfig(n_heads=4, n_kv_heads=2, d_head=16, window=window)
    jm = JMHA(D_MODEL, jcfg, rotary_frac=0.5,
              impl="pallas" if impl == "kernel" else "chunked")
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                          seed)
    tm = MultiHeadAttention(D_MODEL, AttentionConfig(**dataclasses.asdict(
        jcfg)), impl=impl, rotary_frac=0.5)
    tm.load_state_dict(state_dict(params))
    return jm, to_jax(params), tm


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_mha_window_prefill_and_decode_match_jax(impl):
    """Contiguous ring: prefill of 13 tokens (row 1 right-padded to 9)
    through the full forward (the flash path with ``impl="kernel"``),
    then 10 decode steps across the wrap."""
    jm, jp, tm = _mha_pair(impl=impl)
    rng = np.random.default_rng(5)
    x = _rand(rng, B, 23, D_MODEL)
    valid = np.arange(13)[None] < np.asarray([13, 9])[:, None]
    jc = JWindow.create(B, 8, 2, 16, jnp.float32)
    jy, jc = jax.jit(jm.prefill)(jp, jnp.asarray(x[:, :13]), jc,
                                 valid=jnp.asarray(valid))
    with torch.inference_mode():
        tc = WindowKVCache.create(B, 8, 2, 16, torch.float32)
        ty, tc = tm.prefill(t(x[:, :13]), tc, valid=t(valid))
    close(ty, jy)
    check_cache(tc, jc)
    decode = jax.jit(jm.decode_step)
    for s in range(13, 23):
        jy, jc = decode(jp, jnp.asarray(x[:, s:s + 1]), jc)
        with torch.inference_mode():
            ty, tc = tm.decode_step(t(x[:, s:s + 1]), tc)
        close(ty, jy, err_msg=f"step {s}", **MODULE_TOL)
        check_cache(tc, jc)


@pytest.mark.parametrize("table", [[[0, 1], [2, 3]], [[5, 1], [0, 3]]])
def test_mha_paged_window_prefill_continue_decode_match_jax(table):
    """Paged ring: a fresh prefill, a past-aware continuation (the ring as
    it was supplies the past keys) and decode steps, identity and shuffled
    tables."""
    jm, jp, tm = _mha_pair()
    rng = np.random.default_rng(6)
    x = _rand(rng, B, 24, D_MODEL)
    jc, tc = _paged_window_pair(8, 4, table)
    jc = JPagedWindow(jnp.zeros((7, 4, 2, 16)), jnp.zeros((7, 4, 2, 16)),
                      jc.block_table, jc.positions, jc.length)
    tc = PagedWindowKVCache(torch.zeros(7, 4, 2, 16), torch.zeros(7, 4, 2, 16),
                            tc.block_table, tc.positions, tc.length)
    prefill = jax.jit(jm.prefill)
    decode = jax.jit(jm.decode_step)
    for a, b in ((0, 6), (6, 17)):
        jy, jc = prefill(jp, jnp.asarray(x[:, a:b]), jc)
        with torch.inference_mode():
            ty, tc = tm.prefill(t(x[:, a:b]), tc)
        close(ty, jy)
        check_cache(tc, jc)
    for s in range(17, 24):
        jy, jc = decode(jp, jnp.asarray(x[:, s:s + 1]), jc)
        with torch.inference_mode():
            ty, tc = tm.decode_step(t(x[:, s:s + 1]), tc)
        close(ty, jy, err_msg=f"step {s}", **MODULE_TOL)
        check_cache(tc, jc)


def test_mha_packed_window_prefill_matches_jax():
    """Two packed chunks over a paged ring of 3 rows: the first starts
    rows 0 and 2 (row 1 inactive, a padding tail), the second continues
    rows 0 and 2 past the wrap and starts row 1."""
    jm, jp, tm = _mha_pair()
    C = 24
    jc = JPagedWindow.create(3, 8, 2, 16, jnp.float32, block_size=4,
                             identity_tables=True)
    tc = PagedWindowKVCache.create(3, 8, 2, 16, torch.float32, block_size=4,
                                   identity_tables=True)
    step = jax.jit(jm.prefill_packed)
    for seed, segs in ((7, [(0, 0, 5), (-1, 0, 3), (2, 0, 9)]),
                       (8, [(2, 9, 6), (1, 0, 4), (0, 5, 11)])):
        x, cu, rows, past = packed_chunk(seed, C, segs)
        jmeta, tmeta = _meta_of(cu, rows, past, C)
        jy, jc = step(jp, jnp.asarray(x), jc, jmeta)
        with torch.inference_mode():
            ty, tc = tm.prefill_packed(t(x), tc, tmeta)
        close(ty, jy)
        check_cache(tc, jc)


# ------------------------------------------------------------ the hybrid
def _hybrid_pair(window, dense_impl="chunked", block=False, seed=9):
    kw = dict(n_mosa_heads=3, sparsity=4, n_dense_heads=2, d_head=16,
              local_window=window)
    if block:
        kw.update(selection_granularity="block", sel_block_size=4)
    jh = JHybrid(D_MODEL, JMoSAConfig(**kw),
                 dense_impl="pallas" if dense_impl == "kernel" else "chunked")
    params = numpy_params(jax.eval_shape(jh.init, jax.random.PRNGKey(0)),
                          seed)
    th = HybridAttention(D_MODEL, MoSAConfig(**kw), dense_impl=dense_impl)
    th.load_state_dict(state_dict(params))
    return jh, to_jax(params), th


@pytest.mark.parametrize("window", [0, 8])
def test_hybrid_dense_kernel_route_matches_jax_pallas(window):
    jh, jp, th = _hybrid_pair(window, dense_impl="kernel")
    assert th.dense_impl == "kernel" and th.dense.impl == "kernel"
    x = _rand(np.random.default_rng(10), B, 24, D_MODEL)
    with torch.no_grad():
        ty = th(t(x))
    close(ty, jax.jit(jh.__call__)(jp, jnp.asarray(x)))


def test_gated_combine_forward_and_grads_match_jax():
    """Block choice beside window heads: the sigmoid gates blend the two
    sides; the output and the gradient of every parameter (``gate``
    included) match the JAX package's."""
    jh, jp, th = _hybrid_pair(8, block=True)
    assert "gate" in jp and th._gated()
    rng = np.random.default_rng(11)
    x = _rand(rng, B, 24, D_MODEL)
    w = _rand(rng, B, 24, D_MODEL)

    def jloss(p):
        return jnp.sum(jh(p, jnp.asarray(x)) * jnp.asarray(w))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    ty = th(t(x))
    loss = (ty * t(w)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = state_dict(jax.tree.map(np.asarray, jg))
    for name, p in th.named_parameters():
        close(p.grad, n(want[name]), err_msg=name, **MODULE_TOL)
    assert float(th.gate.grad.abs().sum()) > 0


def test_gate_round_trip_through_convert():
    """A block-choice window model's ``gate`` leaves go JAX -> port ->
    JAX unchanged, and the port's state_dict has exactly the JAX leaves."""
    cfg = get_config("mosa-paper", preset="smoke", variant="mosa",
                     local_window=16, selection_granularity="block",
                     sel_block_size=8)
    params = numpy_params(jax.eval_shape(JLM(cfg).init,
                                         jax.random.PRNGKey(0)), seed=3)
    sd = params_from_jax(cfg, params)
    model = TransformerLM(torch_config(cfg))
    assert set(sd) == set(model.state_dict())
    assert {k for k in sd if k.endswith(".gate")} == {
        f"layers.{i}.mixer.gate" for i in range(cfg.n_layers)}
    model.load_state_dict(sd)
    back = params_to_jax(cfg, model.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(got[path], leaf)


def test_kernel_impl_refuses_autograd():
    """``impl="kernel"`` is forward-only: with grad enabled and parameters
    that require grad it raises instead of switching path; under no_grad
    it equals the chunked path."""
    _, _, tm = _mha_pair(impl="kernel")
    x = t(_rand(np.random.default_rng(12), B, 12, D_MODEL))
    with pytest.raises(RuntimeError, match="forward-only"):
        tm(x)
    with torch.no_grad():
        got = tm(x)
        tm.impl = "chunked"
        want = tm(x)
    close(got, n(want))


def test_attn_local_and_attn_layers_match_jax():
    """A 2-layer ``attn_local``/``attn`` model (window 8 on the first
    layer only): logits of the full forward, then prefill on a window ring
    and a dense cache and decode steps across the wrap."""
    base = get_config("mosa-paper", preset="smoke", variant="dense")
    cfg = dataclasses.replace(
        base, attention=dataclasses.replace(base.attention, window=8),
        pattern=(JBlockSpec("attn_local", "dense"),
                 JBlockSpec("attn", "dense")))
    jlm = JLM(cfg)
    params = numpy_params(jax.eval_shape(jlm.init, jax.random.PRNGKey(0)),
                          seed=13)
    model = TransformerLM(torch_config(cfg))
    model.load_state_dict(params_from_jax(cfg, params))
    assert model.layers[0].mixer.cfg.window == 8
    assert model.layers[1].mixer.cfg.window == 0
    toks = np.random.default_rng(14).integers(2, cfg.vocab, (B, 20))
    jp = to_jax(params)
    jlogits, _ = jax.jit(jlm.__call__)(jp, jnp.asarray(toks))
    with torch.no_grad():
        tlogits, _ = model(torch.from_numpy(toks))
    close(tlogits, jlogits, **MODEL_TOL)
    jc = jlm.init_cache(B, 32, jnp.float32)
    with torch.inference_mode():
        tc = model.init_cache(B, 32, torch.float32)
        assert [type(c).__name__ for c in tc] == ["WindowKVCache",
                                                  "DenseKVCache"]
        tl, tc = model.prefill(torch.from_numpy(toks[:, :12]), tc)
    jl, jc = jax.jit(jlm.prefill)(jp, jnp.asarray(toks[:, :12]), jc)
    close(tl, jl, **MODEL_TOL)
    decode = jax.jit(jlm.decode_step)
    for s in range(12, 20):
        jl, jc = decode(jp, jnp.asarray(toks[:, s:s + 1]), jc)
        with torch.inference_mode():
            tl, tc = model.decode_step(torch.from_numpy(toks[:, s:s + 1]), tc)
        close(tl, jl, err_msg=f"step {s}", **MODEL_TOL)
