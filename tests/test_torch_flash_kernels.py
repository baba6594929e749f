"""The flash kernels' plain versions (#9 ``flash_attention``, #10
``flash_attention_varlen``) against the JAX package on the CPU: its Pallas
kernels through ``repro.kernels.ops`` (interpret mode) and its oracles
``repro.kernels.ref``, on the cases of its own tests (``test_kernels.py``
``FLASH_CASES`` and ``test_varlen.py``), with inputs made by numpy from a
seed.

Tolerances: fp32 atol = rtol = 1e-5 (one attention op, another summation
order); bf16 inputs against the fp32 reference on the same bf16-rounded
values, rtol 2^-7 (rounding the output) and atol a tenth of the
reference's mean magnitude, at most 2e-2.  The CUDA kernels themselves are
held against these plain versions on the card (``test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref

from repro_torch.kernels import flash_attention as F

from test_torch_parity import KERNEL_TOL, n, one_cpu_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# (B, Hq, Hkv, Tq, Tk, d, window): tests/test_kernels.py FLASH_CASES
FLASH_CASES = [
    (1, 2, 2, 16, 16, 8, 0),
    (2, 4, 2, 50, 50, 36, 0),
    (2, 4, 2, 50, 50, 36, 7),
    (1, 8, 1, 128, 128, 64, 0),     # MQA
    (1, 4, 4, 1, 77, 32, 0),        # decode
    (1, 4, 2, 1, 300, 64, 64),      # windowed decode
    (2, 2, 2, 256, 256, 128, 128),  # with window
]


def _bf16(a):
    """numpy fp32 -> the same values rounded to bf16, still fp32."""
    return n(t(a).to(torch.bfloat16).float())


def _bf16_tol(want):
    return dict(atol=min(2e-2, 0.1 * float(np.abs(want).mean())),
                rtol=2.0 ** -7)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,d,window", FLASH_CASES)
def test_flash_plain_matches_jax_kernel_and_oracle(B, Hq, Hkv, Tq, Tk, d,
                                                   window):
    rng = np.random.default_rng(0)
    q, k, v = (_randn(rng, B, Hq, Tq, d), _randn(rng, B, Hkv, Tk, d),
               _randn(rng, B, Hkv, Tk, d))
    got = n(F.flash_attention(t(q), t(k), t(v), window=window))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(
        got, np.asarray(ops.flash_attention(jq, jk, jv, window=window)),
        **KERNEL_TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref.flash_attention_ref(jq, jk, jv, window=window)),
        **KERNEL_TOL)


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,d,window", FLASH_CASES)
def test_flash_plain_bf16_matches_fp32_oracle(B, Hq, Hkv, Tq, Tk, d, window):
    rng = np.random.default_rng(1)
    q, k, v = (_bf16(_randn(rng, B, Hq, Tq, d)),
               _bf16(_randn(rng, B, Hkv, Tk, d)),
               _bf16(_randn(rng, B, Hkv, Tk, d)))
    got = F.flash_attention(*(t(a, torch.bfloat16) for a in (q, k, v)),
                            window=window)
    assert got.dtype == torch.bfloat16
    want = np.asarray(ref.flash_attention_ref(
        *map(jnp.asarray, (q, k, v)), window=window))
    np.testing.assert_allclose(n(got.float()), want, **_bf16_tol(want))


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _packed(seed, total, Hq, Hkv, d):
    rng = np.random.default_rng(seed)
    return (_randn(rng, total, Hq, d), _randn(rng, total, Hkv, d),
            _randn(rng, total, Hkv, d))


# tests/test_varlen.py:31-80, plus segments of length 1
@pytest.mark.parametrize("lens,window", [([13, 5, 22, 1], 0),
                                         ([13, 5, 22, 1], 8),
                                         ([1, 1, 4, 1, 1], 0),
                                         ([1, 1, 4, 1, 1], 2)])
def test_flash_varlen_plain_matches_jax_and_per_row(lens, window):
    """Packed stream == the JAX kernel, its oracle and the per-row padded
    flash path, segment by segment (fp32, GQA 4/2)."""
    Hq, Hkv, d = 4, 2, 16
    q, k, v = _packed(0, sum(lens), Hq, Hkv, d)
    cu = _cu(lens)
    got = n(F.flash_attention_varlen(t(q), t(k), t(v), t(cu), window=window))
    jargs = (*map(jnp.asarray, (q, k, v)), jnp.asarray(cu))
    np.testing.assert_allclose(
        got, np.asarray(ops.flash_attention_varlen(*jargs, window=window)),
        **KERNEL_TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref.flash_attention_varlen_ref(*jargs,
                                                       window=window)),
        **KERNEL_TOL)
    Pm = max(lens)
    for i, L in enumerate(lens):
        s = int(cu[i])

        def pad(a):
            x = t(a[s:s + L]).transpose(0, 1)
            return torch.nn.functional.pad(x, (0, 0, 0, Pm - L))[None]

        o_pad = F.flash_attention(pad(q), pad(k), pad(v), window=window)
        np.testing.assert_allclose(got[s:s + L],
                                   n(o_pad[0, :, :L].transpose(0, 1)),
                                   err_msg=f"seg {i}", **KERNEL_TOL)


def test_flash_varlen_plain_bf16():
    lens = [9, 31]
    q, k, v = (_bf16(a) for a in _packed(1, sum(lens), 2, 2, 32))
    cu = _cu(lens)
    got = F.flash_attention_varlen(*(t(a, torch.bfloat16) for a in (q, k, v)),
                                   t(cu))
    assert got.dtype == torch.bfloat16
    want = np.asarray(ref.flash_attention_varlen_ref(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(cu)))
    np.testing.assert_allclose(n(got.float()), want, **_bf16_tol(want))


@pytest.mark.parametrize("window", [0, 4])
def test_flash_varlen_padded_tail_is_zero(window):
    """cu[N] < total: the segments match the JAX kernel and the padding
    tail returns zeros (the JAX kernel lets padding tokens attend one
    another; its callers slice them off — the port keeps the mask
    semantics: a padded query row returns zero)."""
    lens, total = [10, 10, 13], 41
    q, k, v = _packed(2, total, 4, 2, 16)
    cu = _cu(lens)
    got = n(F.flash_attention_varlen(t(q), t(k), t(v), t(cu), window=window))
    want = np.asarray(ops.flash_attention_varlen(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(cu), window=window))
    np.testing.assert_allclose(got[:cu[-1]], want[:cu[-1]], **KERNEL_TOL)
    assert not got[cu[-1]:].any()


@pytest.mark.parametrize("cu,total", [([0, 3, 3, 7], 7), ([0, 10, 20, 33], 41),
                                      ([0, 1], 1), ([0, 5], 9)])
def test_segments_from_cu_seqlens_matches_jax(cu, total):
    seg, pos = F.segments_from_cu_seqlens(torch.tensor(cu, dtype=torch.int32),
                                          total)
    jseg, jpos = ops.segments_from_cu_seqlens(jnp.asarray(cu, jnp.int32),
                                              total)
    np.testing.assert_array_equal(n(seg), np.asarray(jseg))
    np.testing.assert_array_equal(n(pos), np.asarray(jpos))
    assert seg.dtype == pos.dtype == torch.int32


def test_flash_entry_points_refuse_autograd_and_count_no_cpu_launch():
    """Forward-only, as the TPU kernels: a call autograd would have to
    differentiate raises on either device; CPU tensors take the plain
    version (no launch counted), and the CUDA wrappers refuse them."""
    rng = np.random.default_rng(3)
    q, k, v = (t(_randn(rng, 1, 2, 8, 16)) for _ in range(3))
    qg = q.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        F.flash_attention(qg, k, v)
    qp, kp, vp = (t(_randn(rng, 8, 2, 16)) for _ in range(3))
    cu = torch.tensor([0, 3, 8], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="forward-only"):
        F.flash_attention_varlen(qp, kp.requires_grad_(), vp, cu)
    before = (F.LAUNCHES.count, F.LAUNCHES_VARLEN.count)
    with torch.no_grad():
        F.flash_attention(qg, k, v)
        F.flash_attention_varlen(qp, kp, vp, cu)
    assert (F.LAUNCHES.count, F.LAUNCHES_VARLEN.count) == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        F.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        F.flash_attention_varlen_cuda(qp, kp.detach(), vp, cu)
