"""A model of the flash kernel's schedule (kernels #9 and #10,
``csrc/flash_attention.cu``), checked on the CPU.

The model mirrors the kernel's control flow: the launch order of the query
tiles (the last, heaviest tile of every head first), the key tiles each
query tile visits (from its first row's lowest visible key to its last real
row's highest, in steps of ``KKEYS``; the kernel walks them twice, for the
row max and then for the output), and which of them are masked per element
(all others are visible to every row of the tile and take no test).  Over causal and windowed masks, Tq < Tk (``q_offset``), Tq > Tk,
ragged tiles and packed varlen segments with a padding tail, the unmasked
tiles' pairs plus the masked tiles' surviving pairs must be exactly the
visible pairs of the plain versions' masks, each once.  The plain versions'
masks are read off ``flash_attention_ref`` / ``flash_attention_varlen_ref``
themselves: with q = k = 0 every visible key scores the same, and with v
(and so d) the identity the output row of a query is uniform over its
visible keys.  The tile constants are mirrored from the source and checked
against it.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as kf

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "csrc" / "flash_attention.cu")
KROWS = 64   # query rows per block (kRows)
KKEYS = 64   # keys per tile (kKeys)


def key_range(t, n_q, Tk, q_offset, window, seg=None, cu=None):
    """Visible keys [lo, hi] of query t (hi < lo: none), as the kernel's."""
    if t >= n_q:
        return 1, 0
    if seg is not None:
        s = int(seg[t])
        if s < 0 or s >= len(cu) - 1:                 # padding token
            return 1, 0
        lo, hi = int(cu[s]), t
    else:
        lo, hi = 0, min(q_offset + t, Tk - 1)
    if window > 0:
        lo = max(lo, (t if seg is not None else q_offset + t) - window + 1)
    return lo, hi


def tile_plan(qt, Tq, Tk, q_offset, window, seg=None, cu=None):
    """(t0, [(p0, masked), ...]): query tile qt's first row and the key
    tiles it visits, in order."""
    t0 = qt * KROWS
    n_rows = min(KROWS, Tq - t0)
    last = t0 + n_rows - 1
    if seg is not None:
        last = min(last, int(cu[-1]) - 1)
    key_lo, key_hi, lo_max, hi_min = 0, -1, 0, -1
    if last >= t0:
        lo0, hi_min = key_range(t0, Tq, Tk, q_offset, window, seg, cu)
        lo_max, key_hi = key_range(last, Tq, Tk, q_offset, window, seg, cu)
        key_lo = max(lo0, 0)
    rows_full = last == t0 + KROWS - 1
    n_tiles = (key_hi - key_lo) // KKEYS + 1 if key_hi >= key_lo else 0
    tiles = []
    for it in range(n_tiles):
        p0 = key_lo + it * KKEYS
        full = rows_full and p0 >= lo_max and p0 + KKEYS - 1 <= hi_min
        tiles.append((p0, not full))
    return t0, tiles


def launch_order(n_heads, n_qt):
    """(head, query tile) of each block in launch order: the grid is
    (heads, query tiles), x fastest, and block y takes tile n_qt - 1 - y."""
    return [(x, n_qt - 1 - y) for y in range(n_qt) for x in range(n_heads)]


def covered_pairs(Tq, Tk, q_offset, window, seg=None, cu=None):
    """How often the schedule computes each (query, key) pair with a
    nonzero weight: every pair of an unmasked tile, the pairs of a masked
    tile inside the row's visible range."""
    n_qt = -(-Tq // KROWS)
    count = np.zeros((Tq, Tk), dtype=np.int64)
    for _, qt in launch_order(1, n_qt):
        t0, tiles = tile_plan(qt, Tq, Tk, q_offset, window, seg, cu)
        for p0, masked in tiles:
            for t in range(t0, min(t0 + KROWS, Tq)):
                lo, hi = key_range(t, Tq, Tk, q_offset, window, seg, cu)
                for p in range(p0, min(p0 + KKEYS, Tk)):
                    if not masked or lo <= p <= hi:
                        count[t, p] += 1
    return count


def ref_mask(Tq, Tk, window):
    """The visible pairs of ``flash_attention_ref`` (queries the last Tq
    positions of Tk)."""
    q = torch.zeros(1, 1, Tq, Tk, dtype=torch.float64)
    k = torch.zeros(1, 1, Tk, Tk, dtype=torch.float64)
    v = torch.eye(Tk, dtype=torch.float64)[None, None]
    out = kf.flash_attention_ref(q, k, v, window=window)
    return (out[0, 0] > 0).numpy()


def ref_varlen_mask(lens, total, window):
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                      dtype=torch.int32)
    q = torch.zeros(total, 1, total, dtype=torch.float64)
    k = torch.zeros(total, 1, total, dtype=torch.float64)
    v = torch.eye(total, dtype=torch.float64)[:, None, :]
    out = kf.flash_attention_varlen_ref(q, k, v, cu, window=window)
    return (out[:, 0] > 0).numpy(), cu


FLASH_CASES = [  # (Tq, Tk, window)
    (300, 300, 0), (256, 256, 0), (200, 200, 100), (256, 256, 64),
    (77, 200, 0), (130, 333, 70), (1, 300, 64), (100, 40, 0), (64, 64, 1),
    (190, 190, 200)]
VARLEN_CASES = [  # (segment lengths, total, window)
    ([13, 5, 22, 1], 41, 0), ([1, 1, 70, 1, 3], 80, 8), ([100, 37], 137, 0),
    ([65, 64, 1], 130, 16), ([64, 64, 64], 200, 0), ([130, 70], 200, 90)]


@pytest.mark.parametrize("Tq,Tk,window", FLASH_CASES)
def test_flash_tiles_cover_the_visible_pairs_once(Tq, Tk, window):
    want = ref_mask(Tq, Tk, window)
    got = covered_pairs(Tq, Tk, Tk - Tq, window)
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("lens,total,window", VARLEN_CASES)
def test_varlen_tiles_cover_the_visible_pairs_once(lens, total, window):
    """Over the segments the CUDA wrapper hands the kernel
    (``token_segments``: N on the padding tail)."""
    want, cu = ref_varlen_mask(lens, total, window)
    seg = kf.token_segments(cu, total)
    got = covered_pairs(total, total, 0, window, seg.numpy(), cu.numpy())
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("lens,total,window", VARLEN_CASES)
def test_token_segments_match_the_plain_segments(lens, total, window):
    """The wrapper's two-op segments equal the plain version's on every
    real token and are N (padding) on the tail."""
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                      dtype=torch.int32)
    got = kf.token_segments(cu, total)
    want, _ = kf.segments_from_cu_seqlens(cu, total)
    n = int(cu[-1])
    assert got.dtype == torch.int32
    assert torch.equal(got[:n], want[:n])
    assert (got[n:] == len(lens)).all() and (want[n:] == -1).all()


def test_causal_grid_is_walked_heaviest_first():
    """At the dense baseline's T = 1024 the blocks start in nonincreasing
    order of key tiles, and only the diagonal tile of each query tile is
    masked."""
    T = 1024
    n_qt = T // KROWS
    work = []
    for _, qt in launch_order(9, n_qt):
        _, tiles = tile_plan(qt, T, T, 0, 0)
        work.append(len(tiles))
        assert [m for _, m in tiles] == [False] * qt + [True]
    assert work == sorted(work, reverse=True)
    assert work[0] == n_qt and work[-1] == 1


def test_window_tiles_mask_only_the_edges():
    """With W = 256 at T = 1024, a query tile past the first window visits
    five key tiles: the window's edge and the diagonal are masked, the
    three between are not."""
    for qt in range(4, 1024 // KROWS):
        _, tiles = tile_plan(qt, 1024, 1024, 0, 256)
        assert [m for _, m in tiles] == [True, False, False, False, True]


def test_flash_constants_match_the_kernel_source():
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kRows") == KROWS
    assert const("kKeys") == KKEYS
    assert "gridDim.y - 1 - blockIdx.y" in src
