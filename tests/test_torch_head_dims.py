"""Head dims on the card's kernels, on the CPU (the launches stubbed).

  * the paged wrappers (``paged_attention_cuda`` for decode #11,
    ``paged_prefill_attention_cuda`` for packed prefill #12) take any
    1 <= d <= 256, as the JAX wrappers' ``_pad_lane`` does: d 16, 24, 48,
    96 and 129-256 reach the kernel at 32, 32, 64, 128 and 256 with q and
    both pools zero-padded on the last axis and the caller's scale, and the
    output comes back sliced to d (the stub runs the plain version on what
    the kernel would get: the padded columns change nothing);
  * at d in ``HEAD_DIMS`` the tensors reach the kernel as they are (no
    copy);
  * at d 160, 192 and 256 every kernel wrapper (paged, MoSA, block, flash)
    passes the head-dim check and then refuses the CPU tensors (no
    fallback); at d 320 each raises a ``ValueError`` naming ROADMAP C.2, on
    any device.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import mosa_attention as kmosa
from repro_torch.kernels import mosa_backward as kbwd
from repro_torch.kernels import mosa_block as kblock
from repro_torch.serve import paged_attention as kpaged

from test_torch_parity import one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

PAD = {16: 32, 24: 32, 48: 64, 96: 128, 32: 32, 64: 64, 128: 128, 1: 32,
       33: 64, 129: 256, 160: 256, 192: 256, 256: 256}


def _pools(rng, N, bs, Hkv, d):
    return (torch.from_numpy(rng.standard_normal((N, bs, Hkv, d))
                             .astype(np.float32)) for _ in range(2))


def _decode_inputs(d, seed=0):
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, bs, nb = 3, 4, 2, 4, 6
    kp, vp = _pools(rng, B * nb, bs, Hkv, d)
    q = torch.from_numpy(rng.standard_normal((B, Hq, d)).astype(np.float32))
    table = torch.from_numpy(rng.permutation(B * nb).reshape(B, nb)
                             .astype(np.int32))
    lengths = torch.tensor([1, 24, 13], dtype=torch.int32)
    return q, kp, vp, table, lengths


def _prefill_inputs(d, seed=1):
    rng = np.random.default_rng(seed)
    Hq, Hkv, bs, nb, B = 4, 2, 4, 6, 2
    kp, vp = _pools(rng, B * nb, bs, Hkv, d)
    table = torch.from_numpy(rng.permutation(B * nb).reshape(B, nb)
                             .astype(np.int32))
    cu = torch.tensor([0, 5, 12], dtype=torch.int32)
    rows = torch.tensor([0, 1], dtype=torch.int32)
    past = torch.tensor([3, 9], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((14, Hq, d)).astype(np.float32))
    return q, kp, vp, table, cu, rows, past


def _recording(calls, plain):
    def kernel(q, k_pool, v_pool, *args, entry):
        calls.append((q, k_pool, v_pool, args, entry))
        return plain(q, k_pool, v_pool, *args)
    return kernel


def _check_padded(calls, d, inputs, scale, entry):
    (q, kp, vp, args, got_entry), = calls
    w = PAD[d]
    assert got_entry == entry + ("_wide" if w == 256 else "")
    for got, orig in zip((q, kp, vp), inputs):
        assert got.shape[-1] == w
        if w == d:
            assert got is orig                 # no copy
        else:
            assert torch.equal(got[..., :d], orig)
            assert not got[..., d:].any()
    assert args[-1] == scale                   # the caller's scale


@pytest.mark.parametrize("d", [16, 24, 48, 96, 32, 64, 128, 1, 33, 129, 160,
                               192, 256])
def test_paged_decode_pads_to_the_kernel_width(monkeypatch, d):
    calls = []
    monkeypatch.setattr(kpaged, "_decode_kernel",
                        _recording(calls, kpaged.paged_attention_ref))
    q, kp, vp, table, lengths = _decode_inputs(d)
    scale = 0.37 * d ** -0.5
    out = kpaged.paged_attention_cuda(q, kp, vp, table, lengths, scale)
    _check_padded(calls, d, (q, kp, vp), scale,
                  "repro_paged_attention_decode")
    assert out.shape == q.shape
    want = kpaged.paged_attention_ref(q, kp, vp, table, lengths, scale)
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("d", [16, 24, 48, 96, 32, 64, 128, 1, 33, 129, 160,
                               192, 256])
def test_paged_prefill_pads_to_the_kernel_width(monkeypatch, d):
    calls = []

    def plain(q, k_pool, v_pool, table, cu, rows, past, scale):
        _, _, row_of_tok, pos = kpaged.packed_token_layout(cu, rows, past,
                                                           q.shape[0])
        return kpaged.paged_prefill_attention_ref(q, k_pool, v_pool, table,
                                                  row_of_tok, pos, scale)

    monkeypatch.setattr(kpaged, "_prefill_kernel", _recording(calls, plain))
    q, kp, vp, table, cu, rows, past = _prefill_inputs(d)
    scale = 0.41 * d ** -0.5
    out = kpaged.paged_prefill_attention_cuda(q, kp, vp, table, cu, rows,
                                              past, scale)
    _check_padded(calls, d, (q, kp, vp), scale,
                  "repro_paged_prefill_attention")
    assert out.shape == q.shape
    torch.testing.assert_close(out, plain(q, kp, vp, table, cu, rows, past,
                                          scale), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("d", [16, 96])
def test_padded_paged_wrappers_still_refuse_cpu_tensors(d):
    """With the real kernels the padded tensors (on the CPU here) are
    refused as any CPU tensor is: no fallback."""
    with pytest.raises(ValueError, match="CUDA"):
        kpaged.paged_attention_cuda(*_decode_inputs(d), 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        kpaged.paged_prefill_attention_cuda(*_prefill_inputs(d), 0.1)


def _wide_calls(d=192):
    B, H, S, T = 1, 2, 8, 16
    q = torch.zeros(B, H, S, d)
    idx = torch.arange(S, dtype=torch.int32).expand(B, H, S).contiguous()
    r = torch.ones(B, H, S)
    gt, lse, delta = torch.zeros(B, H, S, d), torch.zeros(B, H, S), \
        torch.zeros(B, H, S)
    bs = 4
    bidx = torch.arange(S // bs, dtype=torch.int32).expand(
        B, H, S // bs).contiguous()
    rblk = torch.ones(B, H, S // bs)
    bwd = (q, q, q, idx, gt, lse, delta)
    bbwd = (q, q, q, bidx, gt, lse, delta, bs, T)
    fq = torch.zeros(1, 2, 8, d)
    vq = torch.zeros(8, 2, d)
    cu = torch.tensor([0, 8], dtype=torch.int32)
    dq, dkp, dvp, dtab, dlen = _decode_inputs(4)
    pq, pkp, pvp, ptab, pcu, prows, ppast = _prefill_inputs(4)
    wide = (lambda t: torch.zeros(*t.shape[:-1], d))
    return {
        "paged_attention_cuda": lambda: kpaged.paged_attention_cuda(
            wide(dq), wide(dkp), wide(dvp), dtab, dlen, 0.1),
        "paged_prefill_attention_cuda":
            lambda: kpaged.paged_prefill_attention_cuda(
                wide(pq), wide(pkp), wide(pvp), ptab, pcu, prows, ppast, 0.1),
        "mosa_attention_cuda": lambda: kmosa.mosa_attention_cuda(
            q, q, q, idx, r),
        "mosa_attention_row_cuda": lambda: kmosa.mosa_attention_row_cuda(
            q, q, q, idx, r),
        "mosa_attention_stream_cuda":
            lambda: kmosa.mosa_attention_stream_cuda(q, q, q, idx, r),
        "mosa_attention_fwd_res_cuda":
            lambda: kmosa.mosa_attention_fwd_res_cuda(q, q, q, idx),
        "mosa_attention_bwd_cuda": lambda: kbwd.mosa_attention_bwd_cuda(*bwd),
        "mosa_attention_bwd_fused_cuda":
            lambda: kbwd.mosa_attention_bwd_fused_cuda(*bwd),
        "mosa_attention_bwd_dq_cuda":
            lambda: kbwd.mosa_attention_bwd_dq_cuda(*bwd),
        "mosa_attention_bwd_dkv_cuda":
            lambda: kbwd.mosa_attention_bwd_dkv_cuda(*bwd),
        "mosa_block_attention_cuda": lambda: kblock.mosa_block_attention_cuda(
            q, q, q, bidx, rblk, bs, T),
        "mosa_block_attention_fwd_res_cuda":
            lambda: kblock.mosa_block_attention_fwd_res_cuda(
                q, q, q, bidx, bs, T),
        "mosa_block_attention_bwd_cuda":
            lambda: kblock.mosa_block_attention_bwd_cuda(*bbwd),
        "mosa_block_attention_bwd_fused_cuda":
            lambda: kblock.mosa_block_attention_bwd_fused_cuda(*bbwd),
        "mosa_block_attention_bwd_dq_cuda":
            lambda: kblock.mosa_block_attention_bwd_dq_cuda(*bbwd),
        "mosa_block_attention_bwd_dkv_cuda":
            lambda: kblock.mosa_block_attention_bwd_dkv_cuda(*bbwd),
        "flash_attention_cuda": lambda: kflash.flash_attention_cuda(
            fq, fq, fq),
        "flash_attention_varlen_cuda":
            lambda: kflash.flash_attention_varlen_cuda(vq, vq, vq, cu),
    }


@pytest.mark.parametrize("d", [160, 192, 256, 320])
@pytest.mark.parametrize("name", sorted(_wide_calls()))
def test_head_dim_over_128_raises_naming_a9(name, d):
    """Heads over 128 (once refused naming ROADMAP A.9): at d 160, 192 and
    256 the wrapper passes the head-dim check and refuses the CPU tensors
    (no fallback); at d 320 it raises naming ROADMAP C.2."""
    match = "ROADMAP C.2" if d > 256 else "needs CUDA tensors"
    with pytest.raises(ValueError, match=match):
        _wide_calls(d)[name]()


def test_padded_head_dim():
    assert [kpaged.padded_head_dim(d) for d in (
        1, 8, 16, 24, 32, 33, 48, 64, 65, 96, 128, 129, 160, 192, 256)] == \
        [32, 32, 32, 32, 32, 64, 64, 64, 128, 128, 128, 256, 256, 256, 256]
    for d in (0, 257, 320):
        with pytest.raises(ValueError, match="ROADMAP C.2"):
            kpaged.padded_head_dim(d)


WIDE_SRC = (pathlib.Path(__file__).resolve().parents[1] / "src"
            / "repro_torch" / "csrc" / "wide_attention.cu")


def _constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", WIDE_SRC.read_text())
    return int(m.group(1))


@pytest.mark.parametrize("elem", [4, 2])
def test_wide_kernels_fit_shared_memory(elem):
    """The wide route's shared memory, from the source's constants (fp32
    and bf16 rows padded to 260 and 264 elements): the forward and dq (K
    and V tiles of 32 in two stages, the warps' rows), dk/dv (q tiles in T
    and g~ tiles in fp32, two stages, the warps' k and v rows), each under
    the 227 KB a block may hold on an H100, and over 48 KB (the launchers
    raise the limit)."""
    D, TK, W = _constant("kD"), _constant("kTK"), _constant("kWarps")
    assert (D, TK, W) == (256, 32, 8)
    stride = D + (4 if elem == 4 else 8)
    fwd = elem * 4 * TK * stride + 4 * W * D + 4 * 6 * TK
    dq = elem * 4 * TK * stride + 4 * 2 * W * D + 4 * 6 * TK
    dkv = (elem * 2 * TK * stride + 4 * 2 * TK * (D + 4) + 4 * 2 * W * D
           + 4 * 8 * TK)
    for nbytes in (fwd, dq, dkv):
        assert 48 * 1024 < nbytes <= 232448
    assert stride * elem % 16 == 0        # 16-byte cp.async rows


def test_every_family_has_a_wide_entry():
    """Each of the 12 kernels' C entries has a ``_wide`` twin with its
    signature, and the wide route's width is the wrappers' limit."""
    from repro_torch.kernels import build
    assert len(build.WIDE_ENTRIES) == 12
    for name in build.WIDE_ENTRIES:
        assert build.SIGNATURES[f"{name}_wide"] == build.SIGNATURES[name]
        assert f'extern "C" int {name}_wide(' in WIDE_SRC.read_text()
    assert build.MAX_HEAD_DIM == _constant("kD") == max(kpaged.HEAD_DIMS)
