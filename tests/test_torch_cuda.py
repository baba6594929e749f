"""The port's CUDA kernels against their plain versions — on the card only.

Marked ``cuda``: on a machine without a CUDA device every test here skips
(decided in the fixture, never at import).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 2e-5 (same math, another summation order); bf16 inputs
2e-2 against the plain version run in fp32 on the same bf16 values (the
kernel's output is rounded to bf16).
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
