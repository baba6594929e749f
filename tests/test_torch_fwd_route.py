"""The MoSA forward's route, on the CPU.

  * ``row_fits``: the one-row kernel takes a row only when its S selected
    tokens fit one thread block (S <= 64) and d <= 128;
  * ``mosa_attention_cuda`` / ``mosa_attention_fwd_res_cuda`` (kernels #1
    and #2) and their block-choice forms (#5 and #6) take the one-row
    kernel where it fits, the wide kernel at d > 128 and the streaming
    kernel otherwise, one launch each (the wrappers are stubbed, so the
    route is checked without a card);
  * every CUDA wrapper, of either route, refuses CPU tensors instead of
    falling back;
  * on the CPU ``mosa_attention`` and ``mosa_block_attention`` (and the
    training forwards) are the plain versions, bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import mosa_attention as kmosa
from repro_torch.kernels import mosa_block as kblock


def _token_inputs(B=2, H=3, S=37, d=16, T=90, seed=0):
    """Expert-choice-like inputs as numpy draws: sorted distinct positions
    with token 0 forced, a few idx = -1 keys, two segments, router scores
    with some zeros."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, S, d))
                                .astype(np.float32)) for _ in range(3))
    idx = np.stack([np.concatenate([[0], np.sort(rng.choice(
        np.arange(1, T), S - 1, replace=False))]) for _ in range(B * H)])
    idx = idx.reshape(B, H, S)
    idx.reshape(-1)[rng.choice(idx.size, min(5, idx.size - 1),
                               replace=False)] = -1
    idx = torch.from_numpy(idx.astype(np.int32))
    seg = torch.from_numpy((np.arange(S) >= S // 2).astype(np.int32)) \
        .expand(B, H, S).contiguous()
    r = rng.uniform(0.1, 1.0, (B, H, S)).astype(np.float32)
    r.reshape(-1)[:2] = 0.0
    return q, k, v, idx, torch.from_numpy(r), seg


def _block_inputs(B=2, H=3, NB=5, bs=4, d=16, T=37, seed=0):
    """Block-choice inputs: per (b, h) NB sorted distinct blocks (block 0
    forced), one empty slot (-1, sorted last) per row of the first head,
    two segments by position, block scores."""
    rng = np.random.default_rng(seed)
    nbt = -(-T // bs)
    bidx = np.stack([np.sort(np.concatenate([[0], 1 + rng.choice(
        nbt - 1, NB - 1, replace=False)])) for _ in range(B * H)])
    bidx = bidx.reshape(B, H, NB)
    bidx[:, 0, -1] = -1
    bidx = torch.from_numpy(bidx.astype(np.int32))
    S = NB * bs
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, S, d))
                                .astype(np.float32)) for _ in range(3))
    pos, _ = kblock.expand_blocks(bidx, bs, T)
    seg = (pos.clamp(min=0) >= T // 2).to(torch.int32)
    rblk = torch.from_numpy(rng.uniform(0.1, 1.0, (B, H, NB))
                            .astype(np.float32))
    return q, k, v, bidx, rblk, seg


@pytest.mark.parametrize("S", [1, 32, 64, 65, 70])
@pytest.mark.parametrize("d", [32, 64, 128, 129, 256])
def test_row_fits(S, d):
    assert kmosa.row_fits(S, d) == (S <= 64 and d <= 128)
    assert kmosa.fwd_route(S, d) == ("row" if S <= 64 and d <= 128 else
                                     "wide" if d > 128 else "stream")


def _stub(taken, name, residuals):
    def fn(q, *args, **kwargs):
        taken.append(name)
        if residuals:
            return (torch.zeros(q.shape, dtype=torch.float32),
                    torch.zeros(q.shape[:-1], dtype=torch.float32))
        return torch.zeros_like(q)
    return fn


@pytest.mark.parametrize("residuals", [False, True])
@pytest.mark.parametrize("S,d,route", [
    (1, 16, "row"), (37, 16, "row"), (64, 128, "row"), (65, 16, "stream"),
    (70, 80, "stream"), (32, 129, "wide"), (64, 256, "wide"),
    (70, 192, "wide")])
def test_fwd_cuda_route(monkeypatch, residuals, S, d, route):
    """The route ``mosa_attention_cuda`` (#1) and
    ``mosa_attention_fwd_res_cuda`` (#2) take at (S, d): one call of the
    one-row, the streaming or (d > 128) the wide wrapper."""
    taken = []
    stem = "mosa_attention_fwd_res" if residuals else "mosa_attention"
    for r in ("row", "stream", "wide"):
        monkeypatch.setattr(kmosa, f"{stem}_{r}_cuda",
                            _stub(taken, r, residuals))
    q, k, v, idx, r, seg = _token_inputs(B=1, H=1, S=S, d=d, T=2 * S + 1)
    if residuals:
        o_pre, lse = kmosa.mosa_attention_fwd_res_cuda(q, k, v, idx, seg=seg)
        assert o_pre.shape == q.shape and lse.shape == q.shape[:-1]
    else:
        assert kmosa.mosa_attention_cuda(q, k, v, idx, r,
                                         seg=seg).shape == q.shape
    assert taken == [route]


@pytest.mark.parametrize("residuals", [False, True])
@pytest.mark.parametrize("d", [128, 129, 256])
@pytest.mark.parametrize("NB,bs", [(2, 16), (4, 16), (37, 1), (2, 64),
                                   (5, 13)])
def test_block_fwd_cuda_route(monkeypatch, residuals, d, NB, bs):
    """The route ``mosa_block_attention_cuda`` (#5) and
    ``mosa_block_attention_fwd_res_cuda`` (#6) take at S = NB * bs and d:
    the one-row kernel at S <= 64 and d <= 128, the wide one at d > 128,
    the streaming one otherwise."""
    taken = []
    stem = ("mosa_block_attention_fwd_res" if residuals
            else "mosa_block_attention")
    for r in ("row", "stream", "wide"):
        monkeypatch.setattr(kblock, f"{stem}_{r}_cuda",
                            _stub(taken, r, residuals))
    T = 2 * NB * bs + 1
    q, k, v, bidx, rblk, seg = _block_inputs(B=1, H=1, NB=NB, bs=bs, d=d,
                                             T=T)
    if residuals:
        kblock.mosa_block_attention_fwd_res_cuda(q, k, v, bidx, bs, T,
                                                 seg=seg)
    else:
        kblock.mosa_block_attention_cuda(q, k, v, bidx, rblk, bs, T, seg=seg)
    want = ("row" if NB * bs <= 64 and d <= 128 else
            "wide" if d > 128 else "stream")
    assert taken == [want]


@pytest.mark.parametrize("route", ["row", "stream", "wide", "routed"])
def test_token_wrappers_refuse_cpu_tensors(route):
    q, k, v, idx, r, seg = _token_inputs()
    sfx = "" if route == "routed" else f"_{route}"
    fwd = getattr(kmosa, f"mosa_attention{sfx}_cuda")
    res = getattr(kmosa, f"mosa_attention_fwd_res{sfx}_cuda")
    before = (kmosa.LAUNCHES.count, kmosa.LAUNCHES_FWD_RES.count)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fwd(q, k, v, idx, r, seg=seg)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        res(q, k, v, idx, seg=seg)
    assert (kmosa.LAUNCHES.count, kmosa.LAUNCHES_FWD_RES.count) == before


@pytest.mark.parametrize("route", ["row", "stream", "wide", "routed"])
def test_block_wrappers_refuse_cpu_tensors(route):
    q, k, v, bidx, rblk, seg = _block_inputs()
    sfx = "" if route == "routed" else f"_{route}"
    fwd = getattr(kblock, f"mosa_block_attention{sfx}_cuda")
    res = getattr(kblock, f"mosa_block_attention_fwd_res{sfx}_cuda")
    before = (kblock.LAUNCHES.count, kblock.LAUNCHES_FWD_RES.count)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fwd(q, k, v, bidx, rblk, 4, 37, seg=seg)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        res(q, k, v, bidx, 4, 37, seg=seg)
    assert (kblock.LAUNCHES.count, kblock.LAUNCHES_FWD_RES.count) == before


@pytest.mark.parametrize("with_seg", [False, True])
@pytest.mark.parametrize("S", [1, 37, 70])
def test_cpu_forward_is_the_plain_version(with_seg, S):
    q, k, v, idx, r, seg = _token_inputs(S=S, T=2 * S + 1)
    seg = seg if with_seg else None
    assert torch.equal(kmosa.mosa_attention(q, k, v, idx, r, seg=seg),
                       kmosa.mosa_attention_ref(q, k, v, idx, r, seg=seg))
    got = kmosa.mosa_attention_fwd_res(q, k, v, idx, seg=seg)
    want = kmosa.mosa_attention_fwd_res_ref(q, k, v, idx, seg=seg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("with_seg", [False, True])
@pytest.mark.parametrize("NB,bs", [(5, 4), (9, 1), (2, 64)])
def test_cpu_block_forward_is_the_plain_version(with_seg, NB, bs):
    T = 2 * NB * bs + 1
    q, k, v, bidx, rblk, seg = _block_inputs(NB=NB, bs=bs, T=T)
    seg = seg if with_seg else None
    assert torch.equal(
        kblock.mosa_block_attention(q, k, v, bidx, rblk, bs, T, seg=seg),
        kblock.mosa_block_attention_ref(q, k, v, bidx, rblk, bs, T, seg=seg))
    got = kblock.mosa_block_attention_fwd_res(q, k, v, bidx, bs, T, seg=seg)
    want = kblock.mosa_block_attention_fwd_res_ref(q, k, v, bidx, bs, T,
                                                   seg=seg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
