"""A model of the tile schedule that the streaming forward (#1, #2, #5, #6
above S = 64, ``csrc/mosa_attention.cu``) and the split backward kernels
(#3/#4 and #7/#8, ``csrc/mosa_backward.cu``) share
(``csrc/mosa_tiles.cuh``), checked on the CPU.

Each block owns a tile of ``KOWN`` rows (queries for the forward and dq,
keys for dk/dv) and streams the opposite rows in tiles of ``KSTREAM``.
Before it streams, it skips every tile pair in which no pair can pass the
mask: the model mirrors that rule (``plan_tiles`` / ``spans_meet``: a
valid key at or before the last query, in a segment both ranges share) and
the launch order (the forward's and dq's last query tile first, the
heaviest under sorted positions; dk/dv's first key tile first).  Over
sorted and unsorted positions, -1 keys in the middle, segments that cross
tile boundaries, ragged last tiles and block choice's expanded positions,
every pair of the plain versions' mask (``pair_mask``) must fall in a tile
pair the kernel computes, and at the sweep's mosa8 shape (sorted idx, S =
128) a quarter of the tile pairs is skipped.  The tile constants are
mirrored from the source and checked against it.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.mosa_attention import pair_mask
from repro_torch.kernels.mosa_block import expand_blocks

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "csrc"
TILES = CSRC / "mosa_tiles.cuh"
KOWN = 64     # owned rows per block (kOwn)
KSTREAM = 32  # streamed rows per tile (kStream)

_MIN, _MAX = -2 ** 31, 2 ** 31 - 1


# kernel -> whether its owned rows are queries (plan_tiles' kQueries)
OWNS_QUERIES = {"fwd": True, "dq": True, "dkv": False}


def test_constants_match_the_source():
    src = TILES.read_text()
    assert re.search(rf"constexpr int kOwn = {KOWN};", src)
    assert re.search(rf"constexpr int kStream = {KSTREAM};", src)


def test_kernels_use_the_shared_schedule():
    """Each kernel plans with the shared rule and its owned side, and
    launches its owned tiles in the modelled order; no source keeps a
    second copy of the rule."""
    fwd = (CSRC / "mosa_attention.cu").read_text()
    bwd = (CSRC / "mosa_backward.cu").read_text()
    assert "plan_tiles<kBlock, true, kStreamThreads>" in fwd
    assert "plan_tiles<kBlock, true, kSplitThreads>" in bwd
    assert "plan_tiles<kBlock, false, kSplitThreads>" in bwd
    assert fwd.count("(gridDim.y - 1 - blockIdx.y) * kOwn") == 1
    assert bwd.count("(gridDim.y - 1 - blockIdx.y) * kOwn") == 1
    assert "const int o0 = blockIdx.y * kOwn;" in bwd   # dk/dv's
    for src in (fwd, bwd):
        assert "bool spans_meet(" not in src
        assert "void plan_tiles(" not in src
        assert '#include "mosa_tiles.cuh"' in src


def span(pos, key, seg):
    """(qmax, qsmin, qsmax, kmin, ksmin, ksmax) of a set of rows: as
    queries every row, as keys the valid ones (the kernel's Span)."""
    out = [_MIN, _MAX, _MIN, _MAX, _MAX, _MIN]
    if len(pos):
        out[:3] = int(pos.max()), int(seg.min()), int(seg.max())
    if key.any():
        out[3:] = (int(pos[key].min()), int(seg[key].min()),
                   int(seg[key].max()))
    return out


def spans_meet(qs, ks):
    return ks[3] <= qs[0] and ks[4] <= qs[2] and qs[1] <= ks[5]


def launch_order(n_tiles, queries):
    """Owned tiles in the order a row's blocks launch (blockIdx.y): the
    last first where the owned rows are queries."""
    return list(range(n_tiles))[::-1] if queries else list(range(n_tiles))


def plan(pos, key, seg, dq):
    """{owned tile: [streamed tiles computed, in order]} of one row, the
    owned tiles in launch order (``dq``: the owned rows are queries, as
    in the forward)."""
    S = len(pos)
    n_own = -(-S // KOWN)
    n_str = -(-S // KSTREAM)
    out = {}
    for o in launch_order(n_own, dq):
        rows = slice(o * KOWN, min(S, (o + 1) * KOWN))
        own = span(pos[rows], key[rows], seg[rows])
        tiles = []
        for t in range(n_str):
            r = slice(t * KSTREAM, min(S, (t + 1) * KSTREAM))
            sp = span(pos[r], key[r], seg[r])
            if spans_meet(own, sp) if dq else spans_meet(sp, own):
                tiles.append(t)
        out[o] = tiles
    return out


def check_row(pos, key, seg, kernels=tuple(OWNS_QUERIES)):
    """Every pair of the plain mask lies in a computed tile pair of each
    kernel; returns the skipped share of each one's tile pairs."""
    tp, tk, ts = (torch.as_tensor(a)[None, None] for a in (pos, key, seg))
    mask = pair_mask(tp, tp, tk, ts)[0, 0].numpy()     # [query, key]
    shares = []
    for dq in (OWNS_QUERIES[kern] for kern in kernels):
        computed = np.zeros_like(mask)
        tiles = plan(pos, key, seg, dq)
        for o, ts_ in tiles.items():
            for t in ts_:
                own = slice(o * KOWN, (o + 1) * KOWN)
                st = slice(t * KSTREAM, (t + 1) * KSTREAM)
                if dq:
                    computed[own, st] = True
                else:
                    computed[st, own] = True
        assert not (mask & ~computed).any(), "a valid pair was skipped"
        total = len(tiles) * -(-len(pos) // KSTREAM)
        shares.append(1 - sum(map(len, tiles.values())) / total)
    return shares


def token_row(rng, S, T, neg=0, n_segs=1, unsorted=False):
    pos = np.concatenate([[0], 1 + rng.permutation(T - 1)[:S - 1]])
    pos = rng.permutation(pos) if unsorted else np.sort(pos)
    if neg:
        pos[rng.choice(S, neg, replace=False)] = -1
    seg = np.sort(rng.integers(0, n_segs, S))
    return pos, pos >= 0, seg


CASES = {
    "mosa8 sorted": dict(S=128, T=1024),
    "sorted, -1 keys, segments": dict(S=128, T=1024, neg=9, n_segs=3),
    "unsorted (a permutation)": dict(S=128, T=1024, unsorted=True),
    "unsorted, -1 keys, segments": dict(S=192, T=700, neg=7, n_segs=4,
                                        unsorted=True),
    "S 65 ragged, segments": dict(S=65, T=300, neg=4, n_segs=3),
    "S 300 ragged, -1 keys": dict(S=300, T=700, neg=7, n_segs=2),
    "S 1": dict(S=1, T=10),
    "S 96, unsorted, -1 keys, segments": dict(S=96, T=500, neg=5, n_segs=3,
                                             unsorted=True),
    "S 192 ragged key tile, sorted": dict(S=192, T=500, neg=5, n_segs=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_skipped_tiles_hold_no_valid_pair(case):
    rng = np.random.default_rng(list(CASES).index(case))
    for _ in range(20):
        check_row(*token_row(rng, **CASES[case]))


def test_a_quarter_of_mosa8_tile_pairs_is_skipped():
    """Sorted idx at S = 128: each kernel skips the upper off-diagonal
    tile pairs of the row (2 of 8), whatever the positions."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        assert check_row(*token_row(rng, 128, 1024)) == [0.25] * 3


def test_segments_skip_tiles_across_documents():
    """Two documents meeting at a tile boundary: the pairs across them are
    masked, so the tiles wholly in different documents are skipped even
    when the positions are unsorted."""
    rng = np.random.default_rng(1)
    pos = rng.permutation(1000)[:128]
    seg = (np.arange(128) >= 64).astype(np.int64)
    assert check_row(pos, pos >= 0, seg) == [0.5] * 3


@pytest.mark.parametrize("bs,NB,T", [(16, 8, 1000), (1, 128, 1024),
                                     (13, 10, 120), (64, 2, 150)])
def test_block_choice_positions(bs, NB, T):
    """Block choice: the positions the kernels expand from the block table
    (a ragged last block, empty blocks sorted last), two segments; NB * bs
    = 128 as 8 blocks of 16, and bs 64 wider than a key tile."""
    rng = np.random.default_rng(bs)
    nbt = -(-T // bs)
    for _ in range(10):
        bidx = np.sort(rng.permutation(nbt - 1)[:NB - 1])
        bidx = np.concatenate([bidx, [nbt - 1]])
        bidx[rng.choice(NB - 1, min(2, NB - 1), replace=False)] = -1
        bidx = np.concatenate([np.sort(bidx[bidx >= 0]), bidx[bidx < 0]])
        pos, ok = expand_blocks(torch.as_tensor(bidx)[None, None], bs, T)
        pos, ok = pos[0, 0].numpy(), ok[0, 0].numpy()
        seg = (np.clip(pos, 0, None) >= T // 2).astype(np.int64)
        check_row(pos, ok, seg)


@pytest.mark.parametrize("S", [65, 128, 192, 300])
def test_forward_launches_the_heaviest_query_tile_first(S):
    """Under sorted positions a later query tile sees every key tile an
    earlier one sees and more: the launch order (the last query tile
    first) goes from the most computed tile pairs to the fewest."""
    rng = np.random.default_rng(S)
    for _ in range(10):
        pos, key, seg = token_row(rng, S, 4 * S)
        tiles = plan(pos, key, seg, OWNS_QUERIES["fwd"])
        order = list(tiles)
        assert order == launch_order(-(-S // KOWN), True)
        counts = [len(tiles[o]) for o in order]
        assert counts == sorted(counts, reverse=True)
        assert counts[0] == -(-S // KSTREAM)


def test_forward_query_tile_with_no_key_tile():
    """A query tile whose rows are all idx = -1: every key tile is skipped
    (the kernel writes zeros and lse = -1e30 + log(1e-30) there, as the
    plain version), and the mask has no pair in that tile."""
    rng = np.random.default_rng(3)
    pos, key, seg = token_row(rng, 128, 1024, n_segs=2)
    pos[64:] = -1
    key = pos >= 0
    check_row(pos, key, seg, kernels=("fwd",))
    assert plan(pos, key, seg, OWNS_QUERIES["fwd"])[1] == []
