"""The port's CUDA kernels against their plain versions — on the card only.

Marked ``cuda``: on a machine without a CUDA device every test here skips
(decided in the fixture, never at import).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 2e-5 (same math, another summation order); bf16 inputs
2e-2 against the plain version run in fp32 on the same bf16 values (the
kernel's output is rounded to bf16).  The training kernels (forward with
residuals, dq, dk/dv) and the autograd Function that joins them are held
to the same tolerances at the slice's shape (8, 276, 32, 64) and at the
edge cases: ragged S with idx = -1 keys, r = 0 rows and segments, and two
query tiles with d = 80 and with d = 128 (the widest d the kernels take,
and their largest shared-memory footprint).
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _tol(dtype):
    return 2e-5 if dtype == torch.float32 else 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,d,with_seg", [(32, 64, False), (37, 64, True),
                                          (70, 80, False)])
def test_mosa_attention_kernel_matches_plain(dev, dtype, S, d, with_seg):
    from repro_torch.kernels.mosa_attention import (LAUNCHES,
                                                    mosa_attention_cuda,
                                                    mosa_attention_ref)
    g = torch.Generator(device=dev).manual_seed(0)
    B, H, T = 2, 3, 4 * S
    q, k, v = (torch.randn(B, H, S, d, device=dev, generator=g).to(dtype)
               for _ in range(3))
    idx = torch.rand(B, H, T, device=dev, generator=g).argsort(-1)[..., :S]
    idx = idx.sort(-1).values.to(torch.int32)
    idx[0, 0, 3] = -1
    r = torch.rand(B, H, S, device=dev, generator=g)
    r[1, 2, 5] = 0.0
    seg = (torch.randint(0, 2, (B, H, S), device=dev, generator=g)
           .sort(-1).values.to(torch.int32) if with_seg else None)
    before = LAUNCHES.count
    got = mosa_attention_cuda(q, k, v, idx, r, seg=seg)
    assert LAUNCHES.count == before + 1
    want = mosa_attention_ref(q.float(), k.float(), v.float(), idx, r, seg=seg)
    torch.testing.assert_close(got.float(), want, atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,d,bs", [(4, 4, 64, 16), (8, 2, 64, 16),
                                         (16, 2, 128, 8), (2, 1, 32, 4)])
def test_paged_decode_kernel_matches_plain(dev, dtype, Hq, Hkv, d, bs):
    from repro_torch.serve.paged_attention import (LAUNCHES,
                                                   paged_attention_cuda,
                                                   paged_attention_ref)
    g = torch.Generator(device=dev).manual_seed(1)
    B, nb = 3, 6
    N = B * nb
    kp = torch.randn(N, bs, Hkv, d, device=dev, generator=g).to(dtype)
    vp = torch.randn(N, bs, Hkv, d, device=dev, generator=g).to(dtype)
    table = torch.randperm(N, device=dev, generator=g).view(B, nb)
    lengths = torch.tensor([1, nb * bs, bs + 3], dtype=torch.int32, device=dev)
    used = (lengths.long() + bs - 1) // bs
    table = torch.where(torch.arange(nb, device=dev)[None] < used[:, None],
                        table, -1).to(torch.int32).contiguous()
    q = torch.randn(B, Hq, d, device=dev, generator=g).to(dtype)
    before = LAUNCHES.count
    got = paged_attention_cuda(q, kp, vp, table, lengths, d ** -0.5)
    assert LAUNCHES.count == before + 1
    want = paged_attention_ref(q.float(), kp.float(), vp.float(), table,
                               lengths, d ** -0.5)
    torch.testing.assert_close(got.float(), want, atol=_tol(dtype),
                               rtol=_tol(dtype))


def test_server_defaults_to_the_card(dev):
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import Server
    cfg = get_config("mosa-paper", preset="smoke", variant="mosa")
    assert Server(cfg, batch=1, max_len=32).device.type == "cuda"


def test_select_topk_ties_match_cpu(dev):
    """Equal scores are taken lower index first on the card as on the CPU."""
    from repro_torch.core.router import select_topk
    scores = torch.rand(2, 7, 300, generator=torch.Generator().manual_seed(2))
    scores = scores.mul(10).round().div(10)          # many exact ties
    for k in (1, 9, 40):
        r_c, i_c = select_topk(scores, k)
        r_g, i_g = select_topk(scores.to(dev), k)
        assert torch.equal(i_g.cpu(), i_c) and torch.equal(r_g.cpu(), r_c)


# (B, H, S, d, T, neg_keys, zero_rows, with_seg): the training slice's shape
# and the edge cases of the forward kernel's tests.
TRAIN_CASES = [(8, 276, 32, 64, 1024, 0, 0, False),
               (2, 3, 37, 64, 200, 20, 10, True),
               (1, 2, 70, 80, 300, 5, 0, False),
               (1, 2, 70, 128, 300, 5, 3, True)]


def _train_inputs(dev, B, H, S, d, T, neg_keys, zero_rows, with_seg, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, H, S, d, device=dev, generator=g)
               for _ in range(3))
    perm = torch.rand(B, H, T - 1, device=dev, generator=g).argsort(-1)
    idx = torch.cat([torch.zeros(B, H, 1, device=dev, dtype=torch.long),
                     perm[..., :S - 1] + 1], -1).sort(-1).values
    idx.view(-1)[torch.randint(0, idx.numel(), (neg_keys,), device=dev,
                               generator=g)] = -1
    r = torch.sigmoid(torch.randn(B, H, S, device=dev, generator=g))
    r.view(-1)[torch.randint(0, r.numel(), (zero_rows,), device=dev,
                             generator=g)] = 0.0
    seg = (torch.randint(0, 3, (B, H, S), device=dev, generator=g)
           .sort(-1).values.to(torch.int32) if with_seg else None)
    gout = torch.randn(B, H, S, d, device=dev, generator=g)
    return q, k, v, idx.to(torch.int32), r, seg, gout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", TRAIN_CASES)
def test_mosa_fwd_res_kernel_matches_plain(dev, dtype, case):
    from repro_torch.kernels.mosa_attention import (
        LAUNCHES_FWD_RES, mosa_attention_fwd_res_cuda,
        mosa_attention_fwd_res_ref)
    q, k, v, idx, _, seg, _ = _train_inputs(dev, *case)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    before = LAUNCHES_FWD_RES.count
    o_pre, lse = mosa_attention_fwd_res_cuda(q, k, v, idx, seg=seg)
    assert LAUNCHES_FWD_RES.count == before + 1
    assert o_pre.dtype == lse.dtype == torch.float32
    want_o, want_lse = mosa_attention_fwd_res_ref(q.float(), k.float(),
                                                  v.float(), idx, seg=seg)
    torch.testing.assert_close(o_pre, want_o, atol=_tol(dtype),
                               rtol=_tol(dtype))
    torch.testing.assert_close(lse, want_lse, atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", TRAIN_CASES)
def test_mosa_bwd_kernels_match_plain(dev, dtype, case):
    from repro_torch.kernels.mosa_attention import mosa_attention_fwd_res_ref
    from repro_torch.kernels.mosa_backward import (LAUNCHES_DKV, LAUNCHES_DQ,
                                                   mosa_attention_bwd_cuda,
                                                   mosa_attention_bwd_ref)
    q, k, v, idx, r, seg, gout = _train_inputs(dev, *case)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qf, kf, vf = q.float(), k.float(), v.float()
    o_pre, lse = mosa_attention_fwd_res_ref(qf, kf, vf, idx, seg=seg)
    gt = (gout * r[..., None]).contiguous()
    delta = (gt * o_pre).sum(-1).contiguous()
    before = (LAUNCHES_DQ.count, LAUNCHES_DKV.count)
    got = mosa_attention_bwd_cuda(q, k, v, idx, gt, lse, delta, seg=seg)
    assert (LAUNCHES_DQ.count, LAUNCHES_DKV.count) == (before[0] + 1,
                                                        before[1] + 1)
    want = mosa_attention_bwd_ref(qf, kf, vf, idx, gt, lse, delta, seg=seg)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype, name
        torch.testing.assert_close(a.float(), b, atol=_tol(dtype),
                                   rtol=_tol(dtype), msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", TRAIN_CASES)
def test_mosa_autograd_function_matches_autograd_of_plain(dev, dtype, case):
    """Grads of sum(out * g) for q, k, v and r through the kernels against
    autograd of ``mosa_attention_ref`` (fp32) on the same inputs.  A bf16
    output's cotangent arrives in bf16, so the plain version is given the
    same bf16-rounded g."""
    from repro_torch.kernels import mosa_attention as kmosa
    from repro_torch.kernels.mosa_backward import LAUNCHES_DKV, LAUNCHES_DQ
    q, k, v, idx, r, seg, gout = _train_inputs(dev, *case)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    leaves = [x.clone().requires_grad_() for x in (q, k, v, r)]
    counters = (kmosa.LAUNCHES, kmosa.LAUNCHES_FWD_RES, LAUNCHES_DQ,
                LAUNCHES_DKV)
    before = [c.count for c in counters]
    out = kmosa.mosa_attention(*leaves[:3], idx, leaves[3], seg=seg)
    got = torch.autograd.grad((out.float() * gout).sum(), leaves)
    assert [c.count - b for c, b in zip(counters, before)] == [0, 1, 1, 1]
    ref = [x.detach().float().requires_grad_() for x in (q, k, v, r)]
    want_out = kmosa.mosa_attention_ref(*ref[:3], idx, ref[3], seg=seg)
    want = torch.autograd.grad((want_out * gout.to(dtype).float()).sum(), ref)
    torch.testing.assert_close(out.float(), want_out.detach(),
                               atol=_tol(dtype), rtol=_tol(dtype))
    for name, a, b in zip(("dq", "dk", "dv", "dr"), got, want):
        torch.testing.assert_close(a.float(), b, atol=_tol(dtype),
                                   rtol=_tol(dtype), msg=name)
