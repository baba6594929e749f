"""The paged-decode kernel's work split and launch geometry, on the CPU.

The CUDA kernel (``csrc/paged_attention.cu``) gives each (row, KV head) a
cluster of ``DECODE_CLUSTER`` thread blocks; block c reads a balanced,
page-aligned span of the row's pages (``decode_spans``), scores it, takes
the row's exact max over the cluster, turns its scores into p = exp(s -
max) and accumulates (l, acc) over its span; the partials are summed in
rank order.  The kernel has no CPU mode, so this file holds a plain
PyTorch model of that work split (``decode_split_model``) against the JAX
package's ``paged_attention_ref`` and its Pallas ``paged_attention_kernel``
(interpret mode), on inputs made by numpy from a seed.  Tolerance: fp32
atol = rtol = 1e-5 (the same math summed in another order).  Cases:
length 1, lengths one position either side of a span boundary, nb * bs,
rows shorter than the cluster's 8 pages, -1 table tails, GQA 8/2, d 32
and 128, bs 8.

A row of length 0 is where the two JAX functions part: the Pallas kernel
(and the CUDA kernel, whose every span is empty) returns exact zeros; the
gather reference masks every score to NEG_INF, so every p is 1 and the row
gets the mean of V over its clamped blocks.  The serving paths never
attend a row of length 0 (ROADMAP C).

``decode_grid`` is checked on the serving slice (the grid must fill the
H100's 132 SMs), on the window switch of very long rows and on the table
switch, and its constants against the kernel source's.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.paged_attention import (paged_attention_kernel,
                                         paged_attention_ref as jax_ref)

from repro_torch.serve import paged_attention as tpa
from repro_torch.serve.paged_attention import (DECODE_CLUSTER, decode_grid,
                                               decode_spans, decode_stages)

from test_torch_kernels_ref import _pad_lane
from test_torch_parity import KERNEL_TOL, n, one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

H100_SMS = 132
SMEM_LIMIT = 232448          # bytes of shared memory a block may use
CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "csrc" / "paged_attention.cu"


def decode_case(seed, Hq, Hkv, d, bs, nb, lengths, neg_tail=True):
    """q (B, Hq, d), pools of B * nb blocks under a random permutation,
    the table, lengths; with ``neg_tail`` each row's table is -1 past the
    blocks its length fills."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    N = B * nb
    kp = rng.standard_normal((N, bs, Hkv, d)).astype(np.float32)
    vp = rng.standard_normal((N, bs, Hkv, d)).astype(np.float32)
    table = rng.permutation(N).reshape(B, nb).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    if neg_tail:
        used = -(-lengths // bs)
        table = np.where(np.arange(nb)[None] < used[:, None], table, -1)
    q = rng.standard_normal((B, Hq, d)).astype(np.float32)
    return q, kp, vp, table.astype(np.int32), lengths


def decode_split_model(q, kp, vp, table, lengths, scale):
    """The kernel's work split in plain PyTorch: per row and KV head, the
    scores of each rank's span, the cluster-wide max, each span's (l, acc)
    with p = exp(s - max), and the sum of the partials in rank order.
    Returns (out, n_empty): n_empty counts (row, rank) spans with no
    position."""
    B, Hq, d = q.shape
    bs, Hkv = kp.shape[1], kp.shape[2]
    nb = table.shape[1]
    R = Hq // Hkv
    out = torch.zeros(B, Hq, d)
    n_empty = 0
    for b in range(B):
        spans = decode_spans(int(lengths[b]), nb, bs)
        qg = q[b].reshape(Hkv, R, d)
        scores, vals = [], []
        for s0, s1 in spans:
            pos = torch.arange(s0, s1)
            blk = table[b, pos // bs].long().clamp(min=0)
            k = kp[blk, pos % bs]                       # (span, Hkv, d)
            scores.append(torch.einsum("grd,sgd->grs", qg, k) * scale)
            vals.append(vp[blk, pos % bs])
            n_empty += s0 == s1
        m = torch.full((Hkv, R), tpa.NEG_INF)
        for s in scores:
            if s.shape[-1]:
                m = torch.maximum(m, s.amax(-1))
        num = torch.zeros(Hkv, R, d)
        den = torch.zeros(Hkv, R)
        for s, v in zip(scores, vals):             # rank order
            p = torch.exp(s - m[..., None])
            den = den + p.sum(-1)
            num = num + torch.einsum("grs,sgd->grd", p, v)
        out[b] = (num / den.clamp_min(1e-30)[..., None]).reshape(Hq, d)
    return out, n_empty


def _jax(q, kp, vp, table, lengths, scale):
    """(JAX gather reference, JAX Pallas kernel in interpret mode)."""
    d = q.shape[-1]
    ref = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                             jnp.asarray(table), jnp.asarray(lengths), scale))
    ker = np.asarray(paged_attention_kernel(
        _pad_lane(q), _pad_lane(kp), _pad_lane(vp), jnp.asarray(table),
        jnp.asarray(lengths), scale=scale, interpret=True))[..., :d]
    return ref, ker


# nb = 10 blocks of 16: at 127 and 128 positions each rank holds one page,
# at 129 the last rank two (one position either side of a span boundary);
# 64 positions are 4 pages < 8 (4 ranks empty), 97 are 7 pages
SPLIT_CASES = {
    "length 1, full row, span boundary +- 1, R 1": dict(
        Hq=4, Hkv=4, d=64, bs=16, nb=10, lengths=[1, 160, 127, 128, 129]),
    "rows shorter than 8 pages, -1 tails, GQA 8/2": dict(
        Hq=8, Hkv=2, d=64, bs=16, nb=10, lengths=[64, 97, 17, 16]),
    "d 32, bs 8, no -1 tails": dict(
        Hq=2, Hkv=1, d=32, bs=8, nb=24, lengths=[191, 192, 65, 9],
        neg_tail=False),
    "d 128, bs 8, GQA 8/2": dict(
        Hq=8, Hkv=2, d=128, bs=8, nb=20, lengths=[160, 63, 64, 65]),
    "R 3, pages not a multiple of 8": dict(
        Hq=6, Hkv=2, d=32, bs=4, nb=30, lengths=[117, 120, 3]),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_decode_split_model_matches_jax(case):
    kw = SPLIT_CASES[case]
    q, kp, vp, table, lengths = decode_case(11, **kw)
    scale = kw["d"] ** -0.5
    got, n_empty = decode_split_model(
        *(torch.from_numpy(a) for a in (q, kp, vp, table)), lengths, scale)
    want_ref, want_ker = _jax(q, kp, vp, table, lengths, scale)
    np.testing.assert_allclose(n(got), want_ref, **KERNEL_TOL)
    np.testing.assert_allclose(n(got), want_ker, **KERNEL_TOL)
    if "shorter" in case:
        assert n_empty > 0           # empty spans contribute nothing


def test_decode_split_model_matches_port_plain_version():
    """The model also equals the port's own plain version (the CPU route of
    ``paged_attention_decode``) on the slice's widths."""
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in decode_case(
        12, Hq=4, Hkv=4, d=64, bs=16, nb=72,
        lengths=[1088, 1087, 1025, 1100, 1152, 1040, 1151, 1096]))
    got, _ = decode_split_model(q, kp, vp, table, lengths, 0.125)
    want = tpa.paged_attention_ref(q, kp, vp, table, lengths, 0.125)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_length_zero_row_is_zero_as_in_the_pallas_kernel():
    """A row of length 0: every span empty, exact zeros, as the Pallas
    kernel gives; the gather reference gives the mean of V over the row's
    clamped blocks (all -1, so block 0 repeated), and so does the port's
    plain version.  The other rows agree with both JAX functions."""
    q, kp, vp, table, lengths = decode_case(
        13, Hq=4, Hkv=2, d=32, bs=8, nb=6, lengths=[0, 17, 48])
    scale = 32 ** -0.5
    got, n_empty = decode_split_model(
        *(torch.from_numpy(a) for a in (q, kp, vp, table)), lengths, scale)
    assert n_empty >= DECODE_CLUSTER
    want_ref, want_ker = _jax(q, kp, vp, table, lengths, scale)
    assert (n(got)[0] == 0).all() and (want_ker[0] == 0).all()
    mean_v = vp[0].mean(0).repeat(2, axis=0)     # (Hkv, d) -> (Hq, d)
    np.testing.assert_allclose(want_ref[0], mean_v, **KERNEL_TOL)
    plain = tpa.paged_attention_ref(
        *(torch.from_numpy(a) for a in (q, kp, vp, table, lengths)), scale)
    np.testing.assert_allclose(n(plain)[0], mean_v, **KERNEL_TOL)
    np.testing.assert_allclose(n(got)[1:], want_ref[1:], **KERNEL_TOL)
    np.testing.assert_allclose(n(got)[1:], want_ker[1:], **KERNEL_TOL)


def test_decode_spans_are_balanced_and_page_aligned():
    rng = np.random.default_rng(0)
    for _ in range(500):
        bs = int(rng.integers(1, 33))
        nb = int(rng.integers(1, 200))
        length = int(rng.integers(-3, nb * bs + 5))
        spans = decode_spans(length, nb, bs)
        assert len(spans) == DECODE_CLUSTER
        L = max(0, min(length, nb * bs))
        assert spans[0][0] == 0 and max(s1 for _, s1 in spans) == L
        pages = []
        for c, (s0, s1) in enumerate(spans):
            assert s0 % bs == 0 and s0 <= s1
            if c:
                assert s0 == max(spans[c - 1][1], spans[c - 1][0])
            pages.append(-(-(s1 - s0) // bs))
        assert sum(pages) == -(-L // bs)
        assert max(pages) - min(pages) <= 1


# The serving slice (chip_smoke [3], [4], [5]): 8 rows, Hq = Hkv = 4, d 64,
# 72 blocks of 16.
def test_decode_grid_at_the_slice():
    grid, cluster, smem, window = decode_grid(8, 4, 4, 64, 72, 16)
    assert grid == (256,) and grid[0] >= H100_SMS and cluster == (8,)
    assert window == 160                 # 9 pages of 16, whole tiles of 32
    assert decode_stages(64) == 6
    # ring 6 x 32 x 64 fp32, scores, 8 partials of 8 outputs, slots, table
    assert smem == 4 * (6 * 32 * 64 + 160 + 64 + (8 + 2 + 8) * 8 + 72)
    # bf16 halves the ring's tiles and doubles their number (at most 8)
    assert decode_grid(8, 4, 4, 64, 72, 16, elem_bytes=2)[2] == \
        smem - 4 * 6 * 32 * 64 + 2 * 8 * 32 * 64


@pytest.mark.parametrize("Hq,Hkv,d,nb,bs,window", [
    (8, 1, 32, 1100, 16, 2048),    # R 8: a span of 2208 > 2048 positions
    (1, 1, 128, 1100, 16, 2208),   # R 1: the same row in one window
    (2, 1, 32, 4200, 2, 1056),     # a table read from device memory
    (4, 4, 64, 1, 1, 32),          # one position: one tile
])
def test_decode_grid_windows(Hq, Hkv, d, nb, bs, window):
    grid, _, smem, got = decode_grid(3, Hq, Hkv, d, nb, bs)
    assert got == window and grid == (8 * 3 * Hkv,)
    span = -(-nb // DECODE_CLUSTER) * bs
    assert (got < span) == (Hq // Hkv * span > tpa.DECODE_SCORE_FLOATS)


def test_decode_grid_fits_shared_memory():
    for d in (32, 64, 128):
        for eb in (2, 4):
            for R in range(1, 9):
                for nb in (1, 72, 4096, 4097, 100_000):
                    for bs in (1, 16, 256):
                        smem = decode_grid(1, R, 1, d, nb, bs, eb)[2]
                        assert smem <= SMEM_LIMIT, (d, eb, R, nb, bs)
    # the table is staged up to DECODE_FULL_TABLE blocks, and read from
    # device memory above (the windows: 512 and 544 positions)
    small = decode_grid(1, 1, 1, 32, 4096, 1)[2]
    big = decode_grid(1, 1, 1, 32, 4097, 1)[2]
    assert small - big == 4 * 4096 - 4 * 32


def test_decode_constants_match_the_kernel_source():
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kCluster") == tpa.DECODE_CLUSTER
    assert const("kThreads") == tpa.DECODE_THREADS
    assert const("kTile") == tpa.DECODE_TILE
    assert const("kRingBytes") == tpa.DECODE_RING_BYTES
    assert const("kMaxStages") == tpa.DECODE_MAX_STAGES
    assert const("kMaxR") == tpa.MAX_GROUP
    assert const("kScoreFloats") == tpa.DECODE_SCORE_FLOATS
    assert const("kFullTable") == tpa.DECODE_FULL_TABLE
