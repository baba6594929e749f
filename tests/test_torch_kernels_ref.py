"""The plain versions of the port's two kernels against the JAX package:
both the JAX oracle and the Pallas kernel run in interpret mode.

Tolerance 1e-5 (atol and rtol): one attention op in fp32 on the CPU in
both frameworks; the sums run in different orders, so agreement is to a
few ulps, not bitwise.  The CUDA kernels themselves run only on the card
(``chip_smoke.py`` holds them against these plain versions there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as kops
from repro.kernels.ref import mosa_attention_ref as jax_mosa_ref
from repro.serve.paged_attention import (paged_attention_kernel,
                                         paged_attention_ref as jax_paged_ref)

from repro_torch.kernels.mosa_attention import (LAUNCHES as MOSA_LAUNCHES,
                                                mosa_attention,
                                                mosa_attention_ref)
from repro_torch.serve.paged_attention import (LAUNCHES as PAGED_LAUNCHES,
                                               paged_attention_decode,
                                               paged_attention_ref)
from repro_torch.serve.paged_kv import PagedDenseKVCache

from test_torch_parity import KERNEL_TOL, n, t


def _mosa_inputs(seed, B, H, S, d, T, neg_keys=0, zero_rows=0, seg=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, d)).astype(np.float32)
               for _ in range(3))
    idx = np.stack([np.stack([
        np.sort(np.concatenate([[0], 1 + rng.choice(T - 1, S - 1,
                                                     replace=False)]))
        for _ in range(H)]) for _ in range(B)]).astype(np.int32)
    flat = idx.reshape(-1)
    flat[rng.choice(flat.size, neg_keys, replace=False)] = -1
    r = (1 / (1 + np.exp(-rng.standard_normal((B, H, S))))).astype(np.float32)
    r.reshape(-1)[rng.choice(r.size, zero_rows, replace=False)] = 0.0
    segs = (np.sort(rng.integers(0, 3, (B, H, S)), -1).astype(np.int32)
            if seg else None)
    return q, k, v, idx, r, segs


MOSA_CASES = {
    "S32": dict(B=2, H=3, S=32, d=64, T=256),
    "ragged_S37_neg_keys_zero_rows": dict(B=2, H=3, S=37, d=64, T=300,
                                          neg_keys=12, zero_rows=8),
    "segments": dict(B=2, H=2, S=37, d=32, T=100, neg_keys=4, zero_rows=3,
                     seg=True),
}


@pytest.mark.parametrize("case", list(MOSA_CASES))
def test_mosa_attention_ref_matches_jax(case):
    q, k, v, idx, r, seg = _mosa_inputs(0, **MOSA_CASES[case])
    jseg = None if seg is None else jnp.asarray(seg)
    want_ref = np.asarray(jax_mosa_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(idx),
                                       jnp.asarray(r), seg=jseg))
    want_ker = np.asarray(kops.mosa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(idx),
        jnp.asarray(r), seg=jseg, interpret=True))
    tseg = None if seg is None else t(seg)
    got = mosa_attention_ref(t(q), t(k), t(v), t(idx), t(r), seg=tseg)
    np.testing.assert_allclose(n(got), want_ref, **KERNEL_TOL)
    np.testing.assert_allclose(n(got), want_ker, **KERNEL_TOL)
    # the dispatcher takes the plain version for CPU tensors, uncounted
    before = MOSA_LAUNCHES.count
    got2 = mosa_attention(t(q), t(k), t(v), t(idx), t(r), seg=tseg)
    assert torch.equal(got2, got) and MOSA_LAUNCHES.count == before


def test_mosa_attention_ref_empty_rows_are_zero():
    """A query with no valid key, or r = 0, yields exact zeros (no NaN)."""
    q, k, v, idx, r, _ = _mosa_inputs(1, B=1, H=1, S=8, d=16, T=64)
    idx[..., :] = -1
    out = mosa_attention_ref(t(q), t(k), t(v), t(idx), t(r))
    assert torch.equal(out, torch.zeros_like(out))
    q, k, v, idx, r, _ = _mosa_inputs(2, B=1, H=1, S=8, d=16, T=64)
    r[..., 3] = 0.0
    out = mosa_attention_ref(t(q), t(k), t(v), t(idx), t(r))
    assert torch.equal(out[..., 3, :], torch.zeros_like(out[..., 3, :]))


def _paged_inputs(seed, B, Hq, Hkv, d, bs, nb, lengths, neg_tail):
    rng = np.random.default_rng(seed)
    N = B * nb
    k_pool = rng.standard_normal((N, bs, Hkv, d)).astype(np.float32)
    v_pool = rng.standard_normal((N, bs, Hkv, d)).astype(np.float32)
    table = rng.permutation(N).reshape(B, nb).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    if neg_tail:
        used = -(-lengths // bs)
        table = np.where(np.arange(nb)[None] < used[:, None], table, -1)
    q = rng.standard_normal((B, Hq, d)).astype(np.float32)
    return q, k_pool, v_pool, table.astype(np.int32), lengths


PAGED_CASES = {
    "gqa_8_2_neg_tail_len1_and_full": dict(
        B=3, Hq=8, Hkv=2, d=64, bs=16, nb=4, lengths=[1, 64, 37],
        neg_tail=True),
    "mha_ragged": dict(B=2, Hq=4, Hkv=4, d=32, bs=8, nb=5, lengths=[33, 17],
                       neg_tail=False),
}


def _pad_lane(x):
    pad = (-x.shape[-1]) % 128
    return jnp.pad(jnp.asarray(x), [(0, 0)] * (x.ndim - 1) + [(0, pad)])


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_attention_ref_matches_jax(case):
    q, kp, vp, table, lengths = _paged_inputs(0, **PAGED_CASES[case])
    d = q.shape[-1]
    scale = d ** -0.5
    want_ref = np.asarray(jax_paged_ref(jnp.asarray(q), jnp.asarray(kp),
                                        jnp.asarray(vp), jnp.asarray(table),
                                        jnp.asarray(lengths), scale))
    # the Pallas kernel takes lane-padded heads (as the JAX dispatcher pads)
    want_ker = np.asarray(paged_attention_kernel(
        _pad_lane(q), _pad_lane(kp), _pad_lane(vp), jnp.asarray(table),
        jnp.asarray(lengths), scale=scale, interpret=True))[..., :d]
    got = paged_attention_ref(t(q), t(kp), t(vp), t(table), t(lengths), scale)
    np.testing.assert_allclose(n(got), want_ref, **KERNEL_TOL)
    np.testing.assert_allclose(n(got), want_ker, **KERNEL_TOL)
    cache = PagedDenseKVCache(t(kp), t(vp), t(table), t(lengths))
    before = PAGED_LAUNCHES.count
    got2 = paged_attention_decode(t(q), cache, scale=scale)
    assert torch.equal(got2, got) and PAGED_LAUNCHES.count == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back: a CPU tensor is refused."""
    from repro_torch.kernels.mosa_attention import mosa_attention_cuda
    from repro_torch.serve.paged_attention import paged_attention_cuda
    q, k, v, idx, r, _ = _mosa_inputs(0, B=1, H=1, S=4, d=8, T=16)
    with pytest.raises(ValueError):
        mosa_attention_cuda(t(q), t(k), t(v), t(idx), t(r))
    q, kp, vp, table, lengths = _paged_inputs(0, **PAGED_CASES["mha_ragged"])
    with pytest.raises(ValueError):
        paged_attention_cuda(t(q), t(kp), t(vp), t(table), t(lengths), 0.1)
