"""The packed-prefill kernel's split-and-merge and launch geometry, on the
CPU.

The CUDA kernel (``csrc/paged_prefill.cu``) cuts each query tile's keys
into splits of ``PREFILL_SPLIT_KEYS`` positions, computes a partial
(m, l, acc) per split and merges the splits in order.  The kernel has no
CPU mode, so this file holds a plain PyTorch model of that work split
(``split_merge_model``: the same tiles, splits, skips and merge) against
the JAX package's ``paged_prefill_attention_ref``, at smoke size, on
inputs made by numpy from a seed.  Tolerance: fp32 atol = rtol = 1e-5
(the same math summed in another order).  Cases: a split whose keys are
all masked for some rows of its tile, a 1-token segment at the deepest
position, GQA 8/2 and 6/2, -1 table tails, prefix blocks shared across a
split boundary, a padding tail and an inactive segment.

``prefill_grid`` is checked on the serving slice's chunk (the busy blocks
must fill the H100's 132 SMs, none walking more than one split) and on
edge shapes, and its constants against the kernel source's.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.serve import paged_attention as tpa
from repro_torch.serve.paged_attention import (PREFILL_ROWS,
                                               PREFILL_SPLIT_KEYS,
                                               prefill_grid)

from test_torch_paged_prefill import _jax_out, _pad_mask, prefill_case
from test_torch_parity import KERNEL_TOL, n, one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

H100_SMS = 132
CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "csrc" / "paged_prefill.cu"


def work_blocks(cu, rows, past, Hq, Hkv, nb, bs):
    """The blocks of the kernel's grid that do work, in grid order: one
    (segment, tile, split, KV head, first key, last key) per block.  Tiles
    count the active segments' tiles of PREFILL_ROWS // R tokens; a split
    past its tile's deepest query (or past the row) does no work."""
    tq = PREFILL_ROWS // (Hq // Hkv)
    S = nb * bs
    out, x = [], 0
    for seg in range(len(rows)):
        if rows[seg] < 0:
            continue
        L = int(cu[seg + 1] - cu[seg])
        for tile in range(-(-L // tq)):
            n_tok = min(tq, L - tile * tq)
            key_lim = min(int(past[seg]) + tile * tq + n_tok - 1, S - 1)
            for s in range(key_lim // PREFILL_SPLIT_KEYS + 1):
                k0 = s * PREFILL_SPLIT_KEYS
                k_end = min(k0 + PREFILL_SPLIT_KEYS - 1, key_lim)
                for g in range(Hkv):
                    out.append((x, seg, tile, s, g, k0, k_end))
            x += 1
    return out


def split_merge_model(q, kp, vp, table, cu, rows, past, scale):
    """The kernel's split-and-merge in plain PyTorch: for each (segment,
    tile) the partial (m, l, acc) of every split over its keys, then the
    merge in split order; a tile with one split is normalised directly.
    Returns (out, n_empty): n_empty counts (query row, split) partials
    whose keys were all masked (m = -1e30, l = 0)."""
    total, Hq, d = q.shape
    Hkv, bs, nb = kp.shape[2], kp.shape[1], table.shape[1]
    R = Hq // Hkv
    tq = PREFILL_ROWS // R
    S = nb * bs
    out = torch.zeros(total, Hq, d)
    n_empty = 0
    for seg in range(len(rows)):
        if rows[seg] < 0:
            continue
        bt = table[rows[seg]].long().clamp(min=0)
        kk = kp[bt].reshape(S, Hkv, d)
        vv = vp[bt].reshape(S, Hkv, d)
        L = int(cu[seg + 1] - cu[seg])
        for tile in range(-(-L // tq)):
            t0 = int(cu[seg]) + tile * tq
            n_tok = min(tq, L - tile * tq)
            qpos = int(past[seg]) + tile * tq + torch.arange(n_tok)
            key_lim = min(int(qpos[-1]), S - 1)
            qt = q[t0:t0 + n_tok].reshape(n_tok, Hkv, R, d)
            parts = []
            for s in range(key_lim // PREFILL_SPLIT_KEYS + 1):
                k0 = s * PREFILL_SPLIT_KEYS
                k_end = min(k0 + PREFILL_SPLIT_KEYS - 1, key_lim)
                pos = torch.arange(k0, k_end + 1)
                sc = torch.einsum("tgrd,sgd->tgrs", qt,
                                  kk[k0:k_end + 1]) * scale
                ok = (pos[None, :] <= qpos[:, None])[:, None, None, :]
                sc = torch.where(ok, sc, tpa.NEG_INF)
                m = sc.amax(-1)
                p = torch.where(ok, torch.exp(sc - m[..., None]), 0.0)
                n_empty += int((~ok.any(-1)).sum()) * Hq
                parts.append((m, p.sum(-1),
                              torch.einsum("tgrs,sgd->tgrd", p,
                                           vv[k0:k_end + 1])))
            if len(parts) == 1:
                m, l, acc = parts[0]
                o = acc / l.clamp_min(1e-30)[..., None]
            else:
                m_max = torch.stack([m for m, _, _ in parts]).amax(0)
                l = torch.zeros_like(m_max)
                o = torch.zeros(n_tok, Hkv, R, d)
                for m, ls, acc in parts:
                    w = torch.exp(m - m_max)
                    l = l + w * ls
                    o = o + w[..., None] * acc
                o = o / l.clamp_min(1e-30)[..., None]
            out[t0:t0 + n_tok] = o.reshape(n_tok, Hq, d)
    return out, n_empty


# (row, past, len) per segment, row -1 inactive; all cases span >= 3
# splits of 128 keys.
SPLIT_CASES = {
    # tile 0 of segment 0 holds positions 100..131: its rows below 128
    # see no key of split 1; a 1-token segment at the deepest position; a
    # padding tail
    "masked split rows, R 1": dict(
        Hq=4, Hkv=4, d=32, bs=16, nb=20,
        segs=[(0, 100, 64), (1, 0, 40), (2, 319, 1)], total=112),
    # pasts on, one before and one after the split boundary 256; one token
    # at the deepest position; an inactive segment and a padding tail
    "GQA 8/2, pasts at a split boundary": dict(
        Hq=8, Hkv=2, d=64, bs=16, nb=24,
        segs=[(0, 256, 9), (1, 255, 12), (2, 257, 5), (-1, 0, 3),
              (3, 383, 1)], total=36),
    # rows 0 and 1 share 20 blocks of 8 (160 keys, across key 128)
    "shared prefix across a split, GQA 4/2": dict(
        Hq=4, Hkv=2, d=32, bs=8, nb=40,
        segs=[(0, 250, 20), (1, 130, 6)], total=30, share=20),
    # 32 / R = 10 tokens per tile: 30 of the 32 rows hold queries; bs 4
    "GQA 6/2, bs 4": dict(
        Hq=6, Hkv=2, d=32, bs=4, nb=70,
        segs=[(0, 120, 13), (1, 0, 30), (2, 250, 20)], total=64),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_merge_model_matches_jax_reference(case):
    args = prefill_case(7, **SPLIT_CASES[case])
    q, kp, vp, table, cu, rows, past = args
    scale = q.shape[-1] ** -0.5
    got, n_empty = split_merge_model(
        *(torch.from_numpy(a) for a in (q, kp, vp, table)), cu, rows, past,
        scale)
    want = np.asarray(_jax_out(*args, impl="ref"))
    np.testing.assert_allclose(n(got), want, **KERNEL_TOL)
    dead = _pad_mask(cu, rows, q.shape[0])
    assert dead.any() and (n(got)[dead] == 0).all()
    blocks = work_blocks(cu, rows, past, SPLIT_CASES[case]["Hq"],
                         SPLIT_CASES[case]["Hkv"], table.shape[1],
                         kp.shape[1])
    assert max(b[3] for b in blocks) >= 2        # >= 3 splits in use
    if case.startswith("masked"):
        assert n_empty > 0


def test_split_merge_model_matches_port_plain_version():
    """The model also equals the port's own plain version (the CPU route
    of ``paged_prefill_attention``) on the GQA boundary case."""
    args = prefill_case(8, **SPLIT_CASES["GQA 8/2, pasts at a split "
                                         "boundary"])
    q, kp, vp, table, cu, rows, past = (torch.from_numpy(a) for a in args)
    scale = q.shape[-1] ** -0.5
    got, _ = split_merge_model(q, kp, vp, table, cu, rows, past, scale)
    _, _, row_of_tok, pos = tpa.packed_token_layout(cu, rows, past,
                                                    q.shape[0])
    want = tpa.paged_prefill_attention_ref(q, kp, vp, table, row_of_tok, pos,
                                           scale)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# The serving slice's chunk (chip_smoke [3], [4], [11]): 4 segments of 64
# tokens at pasts 0, 256, 512, 960; Hq = Hkv = 4, d 64, 72 blocks of 16.
SLICE = dict(segs=[(0, 0, 64), (1, 256, 64), (2, 512, 64), (3, 960, 64)],
             total=256, Hq=4, Hkv=4, d=64, nb=72, bs=16)


def _layout(segs):
    cu = np.concatenate([[0], np.cumsum([L for _, _, L in segs])])
    return (cu.astype(np.int32), np.asarray([r for r, _, _ in segs]),
            np.asarray([p for _, p, _ in segs]))


def test_prefill_grid_at_the_slice():
    c = SLICE
    grid, splits, ws = prefill_grid(c["total"], len(c["segs"]), c["Hq"],
                                    c["Hkv"], c["d"], c["nb"], c["bs"])
    assert splits == 9                       # 1152 keys / 128
    assert grid == (256 // 32 + 4 - 1, 9, 4)
    assert ws == (256, 4, 9, 66)
    blocks = work_blocks(*_layout(c["segs"]), c["Hq"], c["Hkv"], c["nb"],
                         c["bs"])
    assert len(blocks) == 136 >= H100_SMS
    assert max(b[6] - b[5] + 1 for b in blocks) == PREFILL_SPLIT_KEYS
    assert all(b[0] < grid[0] and b[3] < grid[1] for b in blocks)


def test_prefill_grid_at_the_scheduler_full_chunk():
    """One 256-token segment at past 768: the last chunk of a 1024-token
    prompt (chip_smoke [4]'s second shape)."""
    grid, splits, _ = prefill_grid(256, 1, 4, 4, 64, 72, 16)
    blocks = work_blocks(*_layout([(0, 768, 256)]), 4, 4, 72, 16)
    assert grid == (8, 9, 4) and len(blocks) == 240


@pytest.mark.parametrize("Hq,Hkv,tq", [(4, 4, 32), (8, 2, 8), (8, 1, 4),
                                       (6, 2, 10), (7, 1, 4)])
def test_prefill_grid_tokens_per_tile(Hq, Hkv, tq):
    grid, _, _ = prefill_grid(100, 3, Hq, Hkv, 32, 4, 16)
    assert grid[0] == -(-100 // tq) + 2 and grid[2] == Hkv


@pytest.mark.parametrize("nb,bs,splits", [(8, 16, 1), (1, 128, 1),
                                          (129, 1, 2), (72, 16, 9),
                                          (40, 16, 5), (3, 43, 2)])
def test_prefill_grid_splits_and_workspace(nb, bs, splits):
    grid, got, ws = prefill_grid(5, 2, 8, 2, 128, nb, bs)
    assert got == splits and grid[1] == splits
    assert ws == (5, 8, splits, 130)
    assert prefill_grid(1, 1, 2, 1, 32, nb, bs)[0] == (1, splits, 1)


def test_prefill_grid_covers_every_tile():
    """However the tokens split into segments (empty and inactive ones
    too), the active segments' tiles fit the grid's first dimension."""
    rng = np.random.default_rng(0)
    for _ in range(300):
        Hkv = int(rng.integers(1, 3))
        Hq = Hkv * int(rng.integers(1, 9))
        N = int(rng.integers(1, 7))
        total = int(rng.integers(1, 200))
        lens = rng.multinomial(int(rng.integers(0, total + 1)),
                               np.ones(N) / N)
        segs = [(int(rng.integers(-1, 3)), int(rng.integers(0, 50)), int(L))
                for L in lens]
        grid, splits, _ = prefill_grid(total, N, Hq, Hkv, 32, 30, 16)
        blocks = work_blocks(*_layout(segs), Hq, Hkv, 30, 16)
        assert all(b[0] < grid[0] and b[3] < splits for b in blocks)


def test_prefill_constants_match_the_kernel_source():
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kRows") == PREFILL_ROWS
    assert const("kSplitKeys") == PREFILL_SPLIT_KEYS
