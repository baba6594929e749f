"""The port's training kernels' plain versions and their autograd Function
against the JAX package, on the CPU.

  * ``mosa_attention_fwd_res_ref`` against ``mosa_attention_fwd_res`` and
    ``mosa_attention_bwd_ref`` against ``mosa_attention_bwd_pallas`` (both
    Pallas, interpret mode), on the same inputs, residuals and cotangents;
  * ``MoSAAttentionFunction`` (through ``mosa_attention``) against
    ``jax.grad`` of ``repro.kernels.ops.mosa_attention`` (interpret mode):
    dq, dk, dv and dr;
  * ``torch.autograd.gradcheck`` of the Function in float64.

fp32 tolerance atol = rtol = 3e-5, as the JAX package's own kernel-VJP
test (``tests/test_train_grad.py``): the same math in another summation
order.  Inputs come from numpy with a seed and go to both frameworks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels.mosa_attention import mosa_attention_fwd_res
from repro.kernels.mosa_backward import mosa_attention_bwd_pallas

from repro_torch.kernels.mosa_attention import (mosa_attention,
                                                mosa_attention_fwd_res_ref,
                                                mosa_attention_ref)
from repro_torch.kernels.mosa_backward import mosa_attention_bwd_ref
from repro_torch.kernels.mosa_vjp import MoSAAttentionFunction

from test_torch_parity import one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

TOL = dict(atol=3e-5, rtol=3e-5)

# (B, H, S, d, T, edge): edge = segments, idx = -1 keys and r = 0 rows.
# S = 128 and 256 are the sizes the card's split backward takes (k of the
# IsoFLOP sweep's mosa8 point is 128): JAX's 128-row tiles give one and two
# tiles there.
CASES = [(1, 1, 8, 16, 32, False), (2, 3, 24, 20, 100, False),
         (2, 2, 16, 16, 64, True), (1, 1, 128, 16, 1024, True),
         (1, 1, 256, 16, 1024, True)]


def _inputs(B, H, S, d, T, edge, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, S, d)).astype(np.float32)
                  for _ in range(4))
    idx = np.stack([np.stack([np.sort(np.concatenate(
        [[0], 1 + rng.permutation(T - 1)[:S - 1]])) for _ in range(H)])
        for _ in range(B)]).astype(np.int32)
    r = (1 / (1 + np.exp(-rng.standard_normal((B, H, S))))).astype(np.float32)
    seg = np.zeros((B, H, S), np.int32)
    if edge:
        idx.reshape(-1)[rng.choice(idx.size, 6, replace=False)] = -1
        r.reshape(-1)[rng.choice(r.size, 5, replace=False)] = 0.0
        seg = np.sort(rng.integers(0, 3, (B, H, S)), -1).astype(np.int32)
    return q, k, v, idx, r, seg, g


def _blocks(S):
    """The Pallas tile: the largest of 8, 16 and 128 that divides S."""
    return functools.reduce(lambda a, b: b if S % b == 0 else a,
                            (8, 16, 128), 8)


@pytest.mark.parametrize("case", CASES)
def test_fwd_res_plain_matches_pallas(case):
    q, k, v, idx, r, seg, _ = _inputs(*case)
    bq = _blocks(q.shape[2])
    want_o, want_lse = mosa_attention_fwd_res(
        *map(jnp.asarray, (q, k, v, idx, seg, r)), block_q=bq, block_k=bq,
        interpret=True)
    got_o, got_lse = mosa_attention_fwd_res_ref(
        *map(torch.from_numpy, (q, k, v, idx)), seg=torch.from_numpy(seg))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_bwd_plain_matches_pallas(case):
    q, k, v, idx, r, seg, g = _inputs(*case)
    bq = _blocks(q.shape[2])
    o_pre, lse = mosa_attention_fwd_res(
        *map(jnp.asarray, (q, k, v, idx, seg, r)), block_q=bq, block_k=bq,
        interpret=True)
    o_pre, lse = np.array(o_pre), np.array(lse)
    gt = g * r[..., None]
    delta = (gt * o_pre).sum(-1)
    want = mosa_attention_bwd_pallas(
        *map(jnp.asarray, (q, k, v, idx, seg, gt, lse, delta)), block_q=bq,
        block_k=bq, interpret=True)
    got = mosa_attention_bwd_ref(
        *map(torch.from_numpy, (q, k, v, idx, gt, lse, delta)),
        seg=torch.from_numpy(seg))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("case", CASES)
def test_function_grads_match_jax(case):
    q, k, v, idx, r, seg, g = _inputs(*case)
    edge = case[-1]
    jseg = jnp.asarray(seg) if edge else None

    def jloss(q, k, v, r):
        out = ops.mosa_attention(q, k, v, jnp.asarray(idx), r, seg=jseg,
                                 interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, r)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, r)]
    out = mosa_attention(*leaves[:3], torch.from_numpy(idx), leaves[3],
                         seg=torch.from_numpy(seg) if edge else None)
    assert type(out.grad_fn).__name__ == "MoSAAttentionFunctionBackward"
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    for name, a, b in zip(("dq", "dk", "dv", "dr"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
        assert np.isfinite(a.numpy()).all(), name


def test_function_gradcheck_float64():
    q, k, v, idx, r, seg, _ = _inputs(1, 2, 6, 4, 20, True, seed=1)
    args = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v, r)]
    idx_t, seg_t = torch.from_numpy(idx), torch.from_numpy(seg)
    assert torch.autograd.gradcheck(
        lambda q, k, v, r: MoSAAttentionFunction.apply(q, k, v, idx_t, seg_t,
                                                       r, None), args)


def test_dispatch_takes_the_function_only_under_autograd():
    q, k, v, idx, r, _, _ = _inputs(1, 2, 8, 16, 32, False)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, r)]
    idx_t = torch.from_numpy(idx)
    with torch.no_grad():
        plain = mosa_attention(*leaves[:3], idx_t, leaves[3])
    assert plain.grad_fn is None
    out = mosa_attention(*leaves[:3], idx_t, leaves[3])
    assert type(out.grad_fn).__name__ == "MoSAAttentionFunctionBackward"
    # the Function's forward (o_pre * r) is the serving forward's output
    torch.testing.assert_close(out.detach(), plain, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(
        plain, mosa_attention_ref(*[t.detach() for t in leaves[:3]], idx_t,
                                  leaves[3].detach()), atol=0, rtol=0)
