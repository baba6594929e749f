"""The port's attention modules against the JAX package with converted
weights: ``MoSAAttention`` (forward, prefill, streaming decode) and the
paged ``MultiHeadAttention`` (prefill, decode).  fp32 on the CPU;
tolerance 1e-5 (one layer: projections, RoPE, attention, output
projection — summation order differs, so not bitwise).  Router scores of
random inputs are distinct, so both frameworks select the same tokens and
the cache indices match exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttentionConfig as JAttentionConfig
from repro.configs.base import MoSAConfig as JMoSAConfig
from repro.core.attention import MultiHeadAttention as JMHA
from repro.core.kv_cache import DenseKVCache as JDense
from repro.core.kv_cache import MoSAKVCache as JMoSAKVCache
from repro.core.mosa import MoSAAttention as JMoSA
from repro.serve.paged_kv import PagedDenseKVCache as JPaged

from repro_torch.configs.base import AttentionConfig, MoSAConfig
from repro_torch.core.attention import MultiHeadAttention
from repro_torch.core.kv_cache import DenseKVCache, MoSAKVCache
from repro_torch.core.mosa import MoSAAttention
from repro_torch.serve.paged_kv import PagedDenseKVCache

from test_torch_parity import MODULE_TOL, n, numpy_params, t, to_jax

D_MODEL, B = 64, 2


def state_dict(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(state_dict(v, key) if isinstance(v, dict) else {key: t(v)})
    return out


def close(got, want, **tol):
    np.testing.assert_allclose(n(got), np.asarray(want), **(tol or MODULE_TOL))


def mosa_pair(impl, seed=0):
    jcfg = JMoSAConfig(n_mosa_heads=6, sparsity=4, d_head=32,
                       impl="pallas" if impl == "kernel" else "einsum")
    jm = JMoSA(D_MODEL, jcfg)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed)
    tcfg = MoSAConfig(**{**dataclasses.asdict(jcfg), "impl": impl})
    tm = MoSAAttention(D_MODEL, tcfg, impl=impl)
    tm.load_state_dict(state_dict(params))
    return jm, to_jax(params), tm


@pytest.mark.parametrize("impl", ["einsum", "kernel"])
@pytest.mark.parametrize("with_valid", [False, True])
def test_mosa_forward_matches_jax(impl, with_valid):
    jm, jp, tm = mosa_pair(impl)
    T = 24
    x = np.random.default_rng(1).standard_normal((B, T, D_MODEL)).astype(
        np.float32)
    valid = np.arange(T)[None] < np.array([[T], [T - 5]])
    jv = jnp.asarray(valid) if with_valid else None
    tv = t(valid) if with_valid else None
    want = jax.jit(jm.__call__)(jp, jnp.asarray(x), None, jv)
    with torch.inference_mode():
        got = tm(t(x), None, tv)
    close(got, want)


def _check_mosa_cache(tc, jc):
    np.testing.assert_array_equal(n(tc.idx), np.asarray(jc.idx))
    np.testing.assert_array_equal(n(tc.length), np.asarray(jc.length))
    close(tc.scores, jc.scores)
    close(tc.k, jc.k)
    close(tc.v, jc.v)


@pytest.mark.parametrize("impl", ["einsum", "kernel"])
def test_mosa_prefill_and_decode_match_jax(impl):
    """Prefill fills a capacity-wide cache (8 slots for k_for(20) = 5), then
    6 streaming decode steps evict-min and re-sort it; outputs and every
    cache field match at each step."""
    jm, jp, tm = mosa_pair(impl, seed=2)
    T, cap, steps = 20, 8, 6
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, D_MODEL)).astype(np.float32)
    jc = JMoSAKVCache.create(B, 6, cap, 32, jnp.float32)
    tc = MoSAKVCache.create(B, 6, cap, 32, torch.float32)
    jy, jc = jax.jit(jm.prefill)(jp, jnp.asarray(x), jc)
    with torch.inference_mode():
        ty, tc = tm.prefill(t(x), tc)
    close(ty, jy)
    _check_mosa_cache(tc, jc)
    decode = jax.jit(jm.decode_step)
    for _ in range(steps):
        xt = rng.standard_normal((B, 1, D_MODEL)).astype(np.float32)
        jy, jc = decode(jp, jnp.asarray(xt), jc)
        with torch.inference_mode():
            ty, tc = tm.decode_step(t(xt), tc)
        close(ty, jy)
        _check_mosa_cache(tc, jc)


@pytest.mark.parametrize("paged", [True, False])
def test_mha_prefill_and_decode_match_jax(paged):
    """GQA (4 query heads over 2 KV heads), half-rotary as in the hybrid.
    Paged (block size 8): prefill scatters into the pools and attends the
    gathered range; each decode step appends and runs paged decode (the
    plain version on the CPU).  Contiguous: the (B, S, Hkv, d) cache."""
    jcfg = JAttentionConfig(n_heads=4, n_kv_heads=2, d_head=32)
    jm = JMHA(D_MODEL, jcfg, rotary_frac=0.5)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 4)
    tm = MultiHeadAttention(D_MODEL, AttentionConfig(**dataclasses.asdict(jcfg)),
                            rotary_frac=0.5)
    tm.load_state_dict(state_dict(params))
    jp = to_jax(params)
    T, max_len, bs = 20, 48, 8
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T, D_MODEL)).astype(np.float32)
    if paged:
        jc = JPaged.create(B, max_len, 2, 32, jnp.float32, block_size=bs,
                           identity_tables=True)
        tc = PagedDenseKVCache.create(B, max_len, 2, 32, torch.float32,
                                      block_size=bs, identity_tables=True)
    else:
        jc = JDense.create(B, max_len, 2, 32, jnp.float32)
        tc = DenseKVCache.create(B, max_len, 2, 32, torch.float32)
    jy, jc = jax.jit(jm.prefill)(jp, jnp.asarray(x), jc)
    with torch.inference_mode():
        ty, tc = tm.prefill(t(x), tc)
    close(ty, jy)
    decode = jax.jit(jm.decode_step)
    for _ in range(4):
        xt = rng.standard_normal((B, 1, D_MODEL)).astype(np.float32)
        jy, jc = decode(jp, jnp.asarray(xt), jc)
        with torch.inference_mode():
            ty, tc = tm.decode_step(t(xt), tc)
        close(ty, jy)
    np.testing.assert_array_equal(n(tc.length), np.asarray(jc.length))
    jk, jv = jc.gather() if paged else (jc.k, jc.v)
    tk, tv = tc.gather() if paged else (tc.k, tc.v)
    valid = T + 4
    close(tk[:, :valid], jk[:, :valid])
    close(tv[:, :valid], jv[:, :valid])


@pytest.mark.parametrize("fn", ["chunked_attention", "gqa_attention"])
@pytest.mark.parametrize("window", [0, 7])
def test_attention_functions_match_jax(fn, window):
    """The plain attention functions on GQA heads (8 over 2) with a key
    validity mask and a query offset, as the paged prefill calls them; the
    chunked one over 3 ragged chunks."""
    from repro.core import attention as jattn
    from repro_torch.core import attention as tattn
    rng = np.random.default_rng(6)
    Tq, Tk, d = 9, 21, 16
    q = rng.standard_normal((B, 8, Tq, d)).astype(np.float32)
    k, v = (rng.standard_normal((B, 2, Tk, d)).astype(np.float32)
            for _ in range(2))
    q_pos = np.arange(Tq)[None] + np.array([[12], [5]])
    k_pos = np.broadcast_to(np.arange(Tk), (B, Tk))
    k_valid = k_pos < np.array([[21], [14]])
    kw = dict(window=window, **({"chunk": 8} if fn == "chunked_attention"
                               else {}))
    want = getattr(jattn, fn)(*map(jnp.asarray, (q, k, v, q_pos, k_pos)),
                              d ** -0.5, k_valid=jnp.asarray(k_valid), **kw)
    got = getattr(tattn, fn)(*map(t, (q, k, v, q_pos, k_pos)), d ** -0.5,
                             k_valid=t(k_valid), **kw)
    close(got, want)


@pytest.mark.parametrize("k_fixed", [0, 5])
def test_hybrid_kv_total_matches_jax(k_fixed):
    """The paper's KV-entries metric (Table 2; its k also sizes the MoSA
    cache) at T below min_k, at the sparsity's k and at large T."""
    from repro.core.hybrid import HybridAttention as JHybrid
    from repro_torch.core.hybrid import HybridAttention
    jcfg = JMoSAConfig(n_mosa_heads=6, n_dense_heads=2, sparsity=4,
                       d_head=16, k_fixed=k_fixed)
    th = HybridAttention(D_MODEL, MoSAConfig(**dataclasses.asdict(jcfg)))
    for T in (3, 40, 1000):
        assert th.kv_total(T) == JHybrid(D_MODEL, jcfg).kv_total(T)


def test_paged_append_drops_unallocated_and_pad_writes():
    """Writes through a -1 table entry and right-pad tokens never land."""
    tc = PagedDenseKVCache.create(2, 16, 1, 4, torch.float32, block_size=4,
                                  num_blocks=8)
    tc.block_table[0, :2] = torch.tensor([3, 5], dtype=torch.int32)
    kv = torch.ones(2, 6, 1, 4)
    out = tc.append(kv, kv, n_valid=torch.tensor([6, 0]))
    assert int(out.k.sum()) == 6 * 4                 # only row 0's 6 tokens
    assert out.length.tolist() == [6, 0]
    assert out.k[3].sum() == 16 and out.k[5, :2].sum() == 8


def test_scatter_kept_matches_masked_write():
    """The sync-free masked write equals a boolean-mask write, including
    when nothing is kept and when a dropped entry aliases a kept one."""
    from repro_torch.core.kv_cache import scatter_kept
    g = torch.Generator().manual_seed(0)
    for keep in ([True, False, True, False], [False] * 4, [False, True, False, False]):
        dst = torch.randn(3, 4, 2, generator=g)
        want = dst.clone()
        i0 = torch.tensor([1, 0, 2, 1])
        i1 = torch.tensor([3, 0, 1, 3])        # entry 3 aliases entry 0
        vals = torch.randn(4, 2, generator=g)
        k = torch.tensor(keep)
        want[i0[k], i1[k]] = vals[k]
        scatter_kept(dst, i0, i1, vals, k)
        assert torch.equal(dst, want)
