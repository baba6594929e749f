"""The block-choice MoSA backward's route, on the CPU.

  * ``mosa_block_attention_bwd_cuda`` takes the fused kernel (#7 + #8 in
    one launch) when a row's S = NB * bs selected tokens fit one tile
    (``fused_bwd_fits``: S <= 64, d <= 128) and the split #7 and #8
    otherwise; the wrappers are stubbed, so the route is checked without a
    card;
  * the fused block wrapper refuses CPU tensors instead of falling back;
  * ``mosa_block_attention_bwd`` gives CPU tensors the plain version, bit
    for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import mosa_block as kblock


def _inputs(B=2, H=3, NB=5, bs=4, d=16, T=37, seed=0):
    """Block-choice inputs as numpy draws: per (b, h) NB sorted distinct
    blocks of a length-T sequence (block 0 forced, the ragged last block
    when bs does not divide T), one empty slot (-1, sorted last) per row
    of the first head, two segments, and g~ (zero on invalid query rows),
    lse and delta from the plain forward."""
    rng = np.random.default_rng(seed)
    nbt = -(-T // bs)
    bidx = np.stack([np.sort(np.concatenate([[0], 1 + rng.choice(
        nbt - 1, NB - 1, replace=False)])) for _ in range(B * H)])
    bidx = bidx.reshape(B, H, NB)
    bidx[:, 0, -1] = -1
    bidx = torch.from_numpy(bidx.astype(np.int32))
    S = NB * bs
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, H, S, d))
                                   .astype(np.float32)) for _ in range(4))
    pos, ok = kblock.expand_blocks(bidx, bs, T)
    seg = (pos.clamp(min=0) >= T // 2).to(torch.int32)
    o_pre, lse = kblock.mosa_block_attention_fwd_res_ref(q, k, v, bidx, bs,
                                                         T, seg=seg)
    gt = torch.where(ok[..., None], g, 0.0).contiguous()
    delta = (gt * o_pre).sum(-1).contiguous()
    return (q, k, v, bidx, gt, lse, delta, bs, T), seg


@pytest.mark.parametrize("with_seg", [False, True])
@pytest.mark.parametrize("NB,bs", [(5, 4), (9, 1), (3, 3)])
def test_cpu_block_backward_is_the_plain_version(with_seg, NB, bs):
    args, seg = _inputs(NB=NB, bs=bs)
    seg = seg if with_seg else None
    got = kblock.mosa_block_attention_bwd(*args, seg=seg)
    want = kblock.mosa_block_attention_bwd_ref(*args, seg=seg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("NB,bs,d,route", [
    (2, 16, 16, "fused"), (4, 16, 16, "fused"), (37, 1, 16, "fused"),
    (2, 64, 16, "split"), (5, 13, 16, "split"), (2, 16, 128, "fused"),
    (2, 16, 129, "split")])
def test_block_bwd_cuda_route(monkeypatch, NB, bs, d, route):
    """The route ``mosa_block_attention_bwd_cuda`` takes at S = NB * bs
    and d, with the kernel wrappers replaced by recording stubs."""
    taken = []

    def stub(name, n_out):
        def fn(q, *args, **kwargs):
            taken.append(name)
            outs = tuple(torch.zeros_like(q) for _ in range(n_out))
            return outs[0] if n_out == 1 else outs
        return fn

    monkeypatch.setattr(kblock, "mosa_block_attention_bwd_fused_cuda",
                        stub("fused", 3))
    monkeypatch.setattr(kblock, "mosa_block_attention_bwd_dq_cuda",
                        stub("dq", 1))
    monkeypatch.setattr(kblock, "mosa_block_attention_bwd_dkv_cuda",
                        stub("dkv", 2))
    args, seg = _inputs(B=1, H=1, NB=NB, bs=bs, d=d, T=2 * NB * bs + 1)
    dq, dk, dv = kblock.mosa_block_attention_bwd_cuda(*args, seg=seg)
    assert taken == (["fused"] if route == "fused" else ["dq", "dkv"])
    assert dq.shape == dk.shape == dv.shape == args[0].shape


def test_fused_block_wrapper_refuses_cpu_tensors():
    args, seg = _inputs()
    counts = (kblock.LAUNCHES_BWD.count, kblock.LAUNCHES_DQ.count,
              kblock.LAUNCHES_DKV.count)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kblock.mosa_block_attention_bwd_fused_cuda(*args, seg=seg)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kblock.mosa_block_attention_bwd_cuda(*args, seg=seg)
    assert (kblock.LAUNCHES_BWD.count, kblock.LAUNCHES_DQ.count,
            kblock.LAUNCHES_DKV.count) == counts
