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
and their largest shared-memory footprint).  The backward takes the fused
kernel at S <= 64 and the split dq and dk/dv kernels above: the fused
kernel is held to the plain version (also at S = 1 and at S = 64 with
d = 128), to the split kernels, and to itself (two launches equal bit for
bit); the counters show which route each case takes.  The block-choice
kernels (#5-#8) and their autograd Function are held to the same
tolerances at the slice's shape and at the edge cases of ``BLOCK_CASES``.
The forwards #1, #2, #5 and #6 take the one-row kernel at S <= 64 (d <=
128) and the streaming one above: both routes are held to the plain
version (S = 64 and 65 at d 128 included), the routed call gives its
route's bits, two launches of each route are bitwise equal, and at S <= 32
the two routes agree bit for bit;
the block backward takes the fused #7 + #8 at S = NB * bs <= 64 (held to
the plain version, to the split kernels and to itself, two launches equal
bit for bit) and the split #7 and #8 above; at bs = 1, #5, #6 and the
fused block backward equal #1, #2 (on both routes) and the fused token
backward bit for bit.  The flash kernels #9 and #10 are held to the same
tolerances (GQA, q_offset, windows, ragged tiles, Tq not a multiple of the
64-row tile with the window's edge inside a key tile, segments of length
1, a padding tail that must come back as zeros) and to themselves (two
launches bitwise equal), and the window model is served on the card and
the CPU with identical greedy tokens.  Paged decode (#11) is held at the
serving slice, at the Scheduler mix with a row of length 0 (exact zeros),
at span boundaries of its 8-block cluster, at a row whose scores take two
windows and at a table read from device memory; two launches bitwise
equal, one count per call.  Paged decode and packed prefill also at head
dims 16, 24, 48 and 96, which their wrappers zero-pad to the kernels'
widths (one count per call all the same).  The split #3 and #4 (the
route above S = 64) are held to the plain version and to themselves (two
launches bitwise equal) at S 65, 128, 192 and 300, d 32 to 128, idx = -1
keys anywhere, positions in no order (their tile skipping by value) and
segments across tiles; the split #7 and #8 at NB * bs = 128, and at bs = 1
bit for bit equal to the split #3 and #4.  The streaming forward #1 and #2
(the route above S = 64) is held the same way at S 65, 96, 128, 192 and
300, d 32 to 128, sorted and unsorted idx, -1 keys, r = 0 rows and
segments, and on a query tile whose every key tile is skipped (exact zeros
and the plain lse); #5 and #6 at NB * bs = 128, and at bs = 1 and S 128
bit for bit equal to the streaming #1 and #2.  Every kernel's wide route
(head dims over 128, ``csrc/wide_attention.cu``) is held at d 192 and 256
against its plain version: #1-#4 at S 64 and 70, #5-#8 with a ragged last
block, empty blocks and two segments, #9 with GQA, a window and q_offset,
#10 with a padding tail, #11 and #12 at GQA groups 2, 6 and 7 with a row of
length 0 and padding tokens (exact zeros); two launches bitwise equal.
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
                                          (70, 80, False), (64, 128, True),
                                          (65, 128, False)])
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


# (Hq, Hkv, d, bs, nb, lengths): rows of the old cases (lengths 1, nb * bs
# and bs + 3), the serving slice, the Scheduler mix with a row of length 0,
# span boundaries of the 8-block cluster (1023-1025 positions, 7-9 pages),
# a row whose scores take two windows (R 8, 17593 positions) and a table of
# more blocks than the kernel stages (4200 blocks of 2).
PAGED_DECODE_CASES = {
    "4/4 d64 bs16": (4, 4, 64, 16, 6, [1, 96, 19]),
    "8/2 d64 bs16": (8, 2, 64, 16, 6, [1, 96, 19]),
    "16/2 d128 bs8": (16, 2, 128, 8, 6, [1, 48, 11]),
    "2/1 d32 bs4": (2, 1, 32, 4, 6, [1, 24, 7]),
    "slice": (4, 4, 64, 16, 72,
              [1088, 1087, 1025, 1100, 1152, 1040, 1151, 1096]),
    "scheduler mix, length 0": (4, 4, 64, 16, 72,
                                [0, 130, 1152, 517, 260, 1024, 700, 128]),
    "span boundaries": (8, 2, 64, 16, 72, [1023, 1024, 1025, 127, 128, 129]),
    "two windows, R 8": (8, 1, 32, 16, 1100, [17593, 5]),
    "table from device memory": (2, 1, 32, 2, 4200, [8399, 0, 9]),
    # head dims outside (32, 64, 128): zero-padded to the next of them
    "4/4 d16 bs16, padded to 32": (4, 4, 16, 16, 6, [1, 96, 19]),
    "8/2 d24 bs8, padded to 32": (8, 2, 24, 8, 6, [1, 48, 11]),
    "4/4 d48 bs16, padded to 64": (4, 4, 48, 16, 6, [1, 96, 19]),
    "16/2 d96 bs8, padded to 128": (16, 2, 96, 8, 6, [1, 48, 11]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(PAGED_DECODE_CASES))
def test_paged_decode_kernel_matches_plain(dev, dtype, case):
    """#11 against the plain version (rows of length 0: exact zeros, where
    the plain version, like JAX's gather reference, gives the mean of V);
    two launches bitwise equal; one count per call."""
    from repro_torch.serve.paged_attention import (LAUNCHES,
                                                   paged_attention_cuda,
                                                   paged_attention_ref)
    Hq, Hkv, d, bs, nb, lens = PAGED_DECODE_CASES[case]
    g = torch.Generator(device=dev).manual_seed(1)
    B = len(lens)
    N = B * nb
    kp = torch.randn(N, bs, Hkv, d, device=dev, generator=g).to(dtype)
    vp = torch.randn(N, bs, Hkv, d, device=dev, generator=g).to(dtype)
    table = torch.randperm(N, device=dev, generator=g).view(B, nb)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    used = (lengths.long() + bs - 1) // bs
    table = torch.where(torch.arange(nb, device=dev)[None] < used[:, None],
                        table, -1).to(torch.int32).contiguous()
    q = torch.randn(B, Hq, d, device=dev, generator=g).to(dtype)
    before = LAUNCHES.count
    got = paged_attention_cuda(q, kp, vp, table, lengths, d ** -0.5)
    assert LAUNCHES.count == before + 1
    again = paged_attention_cuda(q, kp, vp, table, lengths, d ** -0.5)
    assert LAUNCHES.count == before + 2
    assert torch.equal(got, again)
    empty = lengths == 0
    assert (got[empty] == 0).all()
    want = paged_attention_ref(q.float(), kp.float(), vp.float(), table,
                               lengths, d ** -0.5)
    torch.testing.assert_close(got[~empty].float(), want[~empty],
                               atol=_tol(dtype), rtol=_tol(dtype))


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


def _train_inputs(dev, B, H, S, d, T, neg_keys, zero_rows, with_seg,
                  unsorted=False, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, H, S, d, device=dev, generator=g)
               for _ in range(3))
    perm = torch.rand(B, H, T - 1, device=dev, generator=g).argsort(-1)
    idx = torch.cat([torch.zeros(B, H, 1, device=dev, dtype=torch.long),
                     perm[..., :S - 1] + 1], -1).sort(-1).values
    if unsorted:          # the same positions in a random order
        idx = idx.gather(-1, torch.rand(B, H, S, device=dev,
                                        generator=g).argsort(-1))
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


# The forward's route boundary: S = 64 and S = 65 at d = 128, beside the
# training cases.
FWD_ROUTE_CASES = TRAIN_CASES + [(1, 3, 64, 128, 300, 4, 3, True),
                                 (1, 3, 65, 128, 300, 4, 3, False),
                                 (2, 3, 1, 64, 10, 0, 0, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FWD_ROUTE_CASES)
def test_mosa_forward_routes(dev, dtype, case):
    """#1 and #2 take the one-row kernel at S <= 64 (d <= 128) and the
    streaming one above: the routed output equals that route's bit for bit;
    the one-row kernel (where it fits) and the streaming kernel (always)
    each match the plain version, and two launches of each are bitwise
    equal.  At S <= 32 (one key tile of the streaming kernel) the two
    routes run the same float operations and agree bit for bit."""
    from repro_torch.kernels import mosa_attention as km
    q, k, v, idx, r, seg, _ = _train_inputs(dev, *case)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qf, kf, vf = q.float(), k.float(), v.float()
    tol = dict(atol=_tol(dtype), rtol=_tol(dtype))
    want = km.mosa_attention_ref(qf, kf, vf, idx, r, seg=seg)
    want_res = km.mosa_attention_fwd_res_ref(qf, kf, vf, idx, seg=seg)
    routes = ["stream"] + (["row"] if km.row_fits(case[2], case[3]) else [])
    outs = {}
    for route in routes:
        fwd = getattr(km, f"mosa_attention_{route}_cuda")
        res = getattr(km, f"mosa_attention_fwd_res_{route}_cuda")
        got, again = (fwd(q, k, v, idx, r, seg=seg) for _ in range(2))
        assert torch.equal(got, again), route
        torch.testing.assert_close(got.float(), want, msg=route, **tol)
        got_res, again_res = (res(q, k, v, idx, seg=seg) for _ in range(2))
        for a, a2, b in zip(got_res, again_res, want_res):
            assert torch.equal(a, a2), route
            torch.testing.assert_close(a, b, msg=route, **tol)
        outs[route] = (got,) + tuple(got_res)
    assert torch.equal(km.mosa_attention_cuda(q, k, v, idx, r, seg=seg), got)
    assert all(torch.equal(a, b) for a, b in zip(
        km.mosa_attention_fwd_res_cuda(q, k, v, idx, seg=seg), got_res))
    if case[2] <= 32:
        assert all(torch.equal(a, b)
                   for a, b in zip(outs["row"], outs["stream"]))


# The streaming forward (#1, #2 above S = 64): S 65, 96, 128, 192 and 300
# (ragged last key and query tiles), d 32, 64, 80 and 128, sorted and
# unsorted idx, idx = -1 keys anywhere, r = 0 rows and segments whose
# boundaries fall inside tiles.  (B, H, S, d, T, neg_keys, zero_rows,
# with_seg, unsorted)
STREAM_CASES = [(1, 3, 65, 128, 300, 4, 3, True, False),
                (2, 3, 96, 32, 500, 5, 2, True, True),
                (2, 3, 128, 64, 1024, 6, 3, True, False),
                (2, 3, 128, 64, 1024, 6, 3, True, True),
                (1, 2, 192, 32, 500, 5, 0, False, True),
                (1, 2, 192, 80, 500, 5, 2, True, False),
                (1, 2, 300, 80, 700, 7, 2, True, False),
                (1, 2, 300, 128, 700, 7, 0, True, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", STREAM_CASES)
def test_streaming_forward_matches_plain_and_is_deterministic(dev, dtype,
                                                              case):
    """The streaming #1 and #2 against their plain versions; two launches
    equal bit for bit (no atomics, each element summed in a fixed order);
    the routed calls take the streaming kernel (one count each) and give
    its bits."""
    from repro_torch.kernels import mosa_attention as km
    q, k, v, idx, r, seg, _ = _train_inputs(dev, *case)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qf, kf, vf = q.float(), k.float(), v.float()
    tol = dict(atol=_tol(dtype), rtol=_tol(dtype))
    got, again = (km.mosa_attention_stream_cuda(q, k, v, idx, r, seg=seg)
                  for _ in range(2))
    assert got.dtype == dtype and torch.equal(got, again)
    torch.testing.assert_close(
        got.float(), km.mosa_attention_ref(qf, kf, vf, idx, r, seg=seg),
        **tol)
    res, res2 = (km.mosa_attention_fwd_res_stream_cuda(q, k, v, idx,
                                                       seg=seg)
                 for _ in range(2))
    want = km.mosa_attention_fwd_res_ref(qf, kf, vf, idx, seg=seg)
    for a, a2, b in zip(res, res2, want):
        assert a.dtype == torch.float32 and torch.equal(a, a2)
        torch.testing.assert_close(a, b, **tol)
    before = (km.LAUNCHES.count, km.LAUNCHES_FWD_RES.count)
    assert torch.equal(km.mosa_attention_cuda(q, k, v, idx, r, seg=seg), got)
    assert all(torch.equal(a, b) for a, b in zip(
        km.mosa_attention_fwd_res_cuda(q, k, v, idx, seg=seg), res))
    assert (km.LAUNCHES.count, km.LAUNCHES_FWD_RES.count) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streaming_forward_query_tile_with_no_key_tile(dev, dtype):
    """A query tile whose every key tile is skipped (all its rows idx = -1,
    so no key can lie at or before them): zeros, and the plain version's
    lse (-1e30 + log(1e-30)), exactly; the other rows as the plain
    version."""
    from repro_torch.kernels import mosa_attention as km
    q, k, v, idx, r, seg, _ = _train_inputs(dev, 2, 3, 128, 64, 1024, 0,
                                            0, True)
    idx[0, 1, 64:] = -1
    idx[1, 2, 70:] = -1
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qf, kf, vf = q.float(), k.float(), v.float()
    tol = dict(atol=_tol(dtype), rtol=_tol(dtype))
    got = km.mosa_attention_stream_cuda(q, k, v, idx, r, seg=seg)
    o_pre, lse = km.mosa_attention_fwd_res_stream_cuda(q, k, v, idx, seg=seg)
    want = km.mosa_attention_ref(qf, kf, vf, idx, r, seg=seg)
    want_o, want_lse = km.mosa_attention_fwd_res_ref(qf, kf, vf, idx,
                                                     seg=seg)
    for out in (got, o_pre):
        assert (out[0, 1, 64:] == 0).all() and (out[1, 2, 70:] == 0).all()
    assert torch.equal(lse[0, 1, 64:], want_lse[0, 1, 64:])
    assert torch.equal(lse[1, 2, 70:], want_lse[1, 2, 70:])
    torch.testing.assert_close(got.float(), want, **tol)
    torch.testing.assert_close(o_pre, want_o, **tol)
    torch.testing.assert_close(lse, want_lse, **tol)


def _bwd_inputs(dev, dtype, case):
    """Kernel inputs of the backward (q, k, v in ``dtype``; g~, lse and
    delta from the plain forward in fp32) and the plain version's grads."""
    from repro_torch.kernels.mosa_attention import mosa_attention_fwd_res_ref
    from repro_torch.kernels.mosa_backward import mosa_attention_bwd_ref
    q, k, v, idx, r, seg, gout = _train_inputs(dev, *case)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qf, kf, vf = q.float(), k.float(), v.float()
    o_pre, lse = mosa_attention_fwd_res_ref(qf, kf, vf, idx, seg=seg)
    gt = (gout * r[..., None]).contiguous()
    delta = (gt * o_pre).sum(-1).contiguous()
    want = mosa_attention_bwd_ref(qf, kf, vf, idx, gt, lse, delta, seg=seg)
    return (q, k, v, idx, gt, lse, delta), seg, want


def _bwd_route(S, d):
    """Launches of (fused, dq, dk/dv) one backward takes at (S, d)."""
    from repro_torch.kernels.mosa_backward import fused_bwd_fits
    return (1, 0, 0) if fused_bwd_fits(S, d) else (0, 1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", TRAIN_CASES)
def test_mosa_bwd_kernels_match_plain(dev, dtype, case):
    """``mosa_attention_bwd_cuda`` takes the fused kernel at S <= 64 and the
    split #3 and #4 above; each case's counters show its route."""
    from repro_torch.kernels.mosa_backward import (LAUNCHES, LAUNCHES_DKV,
                                                   LAUNCHES_DQ,
                                                   mosa_attention_bwd_cuda)
    args, seg, want = _bwd_inputs(dev, dtype, case)
    counters = (LAUNCHES, LAUNCHES_DQ, LAUNCHES_DKV)
    before = [c.count for c in counters]
    got = mosa_attention_bwd_cuda(*args, seg=seg)
    assert tuple(c.count - b for c, b in zip(counters, before)) == \
        _bwd_route(case[2], case[3])
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype, name
        torch.testing.assert_close(a.float(), b, atol=_tol(dtype),
                                   rtol=_tol(dtype), msg=name)


# The fused backward's cases: TRAIN_CASES with S <= 64, S = 1, and S = 64 at
# d = 128 with segments (the largest shared-memory footprint).
FUSED_CASES = [c for c in TRAIN_CASES if c[2] <= 64] + [
    (2, 3, 1, 64, 10, 0, 0, False), (1, 3, 64, 128, 300, 4, 3, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_bwd_matches_plain_and_is_deterministic(dev, dtype, case):
    """The fused kernel against the plain version; two launches equal bit
    for bit (no atomics, a fixed order)."""
    from repro_torch.kernels.mosa_backward import (
        LAUNCHES, mosa_attention_bwd_fused_cuda)
    args, seg, want = _bwd_inputs(dev, dtype, case)
    before = LAUNCHES.count
    got = mosa_attention_bwd_fused_cuda(*args, seg=seg)
    again = mosa_attention_bwd_fused_cuda(*args, seg=seg)
    assert LAUNCHES.count == before + 2
    for name, a, a2, b in zip(("dq", "dk", "dv"), got, again, want):
        assert a.dtype == dtype, name
        assert torch.equal(a, a2), name
        torch.testing.assert_close(a.float(), b, atol=_tol(dtype),
                                   rtol=_tol(dtype), msg=name)


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_bwd_matches_split_kernels(dev, case):
    """Fused against the split #3 and #4 on the card, fp32."""
    from repro_torch.kernels.mosa_backward import (
        mosa_attention_bwd_dkv_cuda, mosa_attention_bwd_dq_cuda,
        mosa_attention_bwd_fused_cuda)
    args, seg, _ = _bwd_inputs(dev, torch.float32, case)
    got = mosa_attention_bwd_fused_cuda(*args, seg=seg)
    split = ((mosa_attention_bwd_dq_cuda(*args, seg=seg),)
             + mosa_attention_bwd_dkv_cuda(*args, seg=seg))
    for name, a, b in zip(("dq", "dk", "dv"), got, split):
        torch.testing.assert_close(a, b, atol=_tol(torch.float32),
                                   rtol=_tol(torch.float32), msg=name)


# The split #3 and #4 (the route above S = 64): (B, H, S, d, T, neg_keys,
# zero_rows, with_seg, unsorted).  S 65, 128, 192 and 300 (a ragged last
# tile of 32 streamed rows and of 64 owned rows), d 32, 64, 80 and 128,
# idx = -1 keys anywhere in the row, positions in no order (so that the
# tile skipping by value meets ranges that overlap), and sorted segments,
# whose boundaries fall inside tiles.
SPLIT_CASES = [(1, 3, 65, 128, 300, 4, 3, True, False),
               (2, 3, 128, 64, 1024, 6, 3, True, False),
               (2, 3, 128, 64, 1024, 6, 3, True, True),
               (1, 2, 192, 32, 500, 5, 0, False, True),
               (1, 2, 300, 80, 700, 7, 2, True, False),
               (1, 2, 300, 128, 700, 7, 0, True, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_bwd_matches_plain_and_is_deterministic(dev, dtype, case):
    """The split #3 and #4 against the plain version; two launches equal
    bit for bit (no atomics, a fixed order); ``mosa_attention_bwd_cuda``
    routes here (one count each) and gives the same bits."""
    from repro_torch.kernels.mosa_backward import (
        LAUNCHES, LAUNCHES_DKV, LAUNCHES_DQ, mosa_attention_bwd_cuda,
        mosa_attention_bwd_dkv_cuda, mosa_attention_bwd_dq_cuda)
    args, seg, want = _bwd_inputs(dev, dtype, case)
    runs = [(mosa_attention_bwd_dq_cuda(*args, seg=seg),)
            + mosa_attention_bwd_dkv_cuda(*args, seg=seg) for _ in range(2)]
    counters = (LAUNCHES, LAUNCHES_DQ, LAUNCHES_DKV)
    before = [c.count for c in counters]
    routed = mosa_attention_bwd_cuda(*args, seg=seg)
    assert tuple(c.count - b for c, b in zip(counters, before)) == \
        _bwd_route(case[2], case[3]) == (0, 1, 1)
    for name, a, a2, r, b in zip(("dq", "dk", "dv"), *runs, routed, want):
        assert a.dtype == dtype, name
        assert torch.equal(a, a2) and torch.equal(a, r), name
        torch.testing.assert_close(a.float(), b, atol=_tol(dtype),
                                   rtol=_tol(dtype), msg=name)


def test_fused_bwd_refuses_rows_past_one_tile(dev):
    from repro_torch.kernels.mosa_backward import (
        mosa_attention_bwd_fused_cuda)
    args, seg, _ = _bwd_inputs(dev, torch.float32, TRAIN_CASES[2])
    with pytest.raises(ValueError, match="S <= 64"):
        mosa_attention_bwd_fused_cuda(*args, seg=seg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", TRAIN_CASES)
def test_mosa_autograd_function_matches_autograd_of_plain(dev, dtype, case):
    """Grads of sum(out * g) for q, k, v and r through the kernels against
    autograd of ``mosa_attention_ref`` (fp32) on the same inputs.  A bf16
    output's cotangent arrives in bf16, so the plain version is given the
    same bf16-rounded g."""
    from repro_torch.kernels import mosa_attention as kmosa
    from repro_torch.kernels.mosa_backward import (LAUNCHES, LAUNCHES_DKV,
                                                   LAUNCHES_DQ)
    q, k, v, idx, r, seg, gout = _train_inputs(dev, *case)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    leaves = [x.clone().requires_grad_() for x in (q, k, v, r)]
    counters = (kmosa.LAUNCHES, kmosa.LAUNCHES_FWD_RES, LAUNCHES,
                LAUNCHES_DQ, LAUNCHES_DKV)
    before = [c.count for c in counters]
    out = kmosa.mosa_attention(*leaves[:3], idx, leaves[3], seg=seg)
    got = torch.autograd.grad((out.float() * gout).sum(), leaves)
    assert tuple(c.count - b for c, b in zip(counters, before)) == \
        (0, 1) + _bwd_route(case[2], case[3])
    ref = [x.detach().float().requires_grad_() for x in (q, k, v, r)]
    want_out = kmosa.mosa_attention_ref(*ref[:3], idx, ref[3], seg=seg)
    want = torch.autograd.grad((want_out * gout.to(dtype).float()).sum(), ref)
    torch.testing.assert_close(out.float(), want_out.detach(),
                               atol=_tol(dtype), rtol=_tol(dtype))
    for name, a, b in zip(("dq", "dk", "dv", "dr"), got, want):
        torch.testing.assert_close(a.float(), b, atol=_tol(dtype),
                                   rtol=_tol(dtype), msg=name)


# Packed prefill (#12): (Hq, Hkv, d, bs, nb, segs, total, share).  segs are
# (row, past, len), row -1 inactive; total past the last segment leaves a
# padding tail; ``share`` blocks at the head of rows 0 and 1 are the same
# (a prefix hit).  The edge segments: past 0; a past off the block grid
# ending on a block boundary; one token; an inactive segment; the tail.
# The kernel cuts keys into splits of 128 positions: the last three cases
# cross split boundaries (pasts on, one before and one after key 256, a
# token at the deepest position, prefix blocks shared across key 128, 10
# tokens per tile at R = 3, one 256-token segment at past 768).
_EDGE = [(0, 0, 5), (1, 13, 3), (2, 7, 1), (-1, 0, 4), (3, 9, 6)]
PREFILL_CASES = [
    (4, 4, 64, 16, 72, [(0, 0, 64), (1, 256, 64), (2, 512, 64),
                        (3, 960, 64)], 256, 0),
    (4, 4, 32, 4, 6, _EDGE, 24, 0),
    (8, 2, 64, 4, 6, _EDGE, 24, 0),
    (8, 2, 128, 8, 5, [(0, 0, 33), (1, 8, 7)], 48, 1),
    (4, 4, 64, 4, 6, [(0, 4, 6), (1, 8, 5), (2, 0, 3)], 16, 2),
    (8, 2, 128, 16, 40, [(0, 256, 9), (1, 255, 12), (2, 257, 17),
                         (3, 639, 1)], 48, 10),
    (6, 2, 32, 4, 70, [(0, 120, 13), (1, 0, 30), (2, 250, 20)], 64, 0),
    (4, 4, 64, 16, 72, [(0, 768, 256)], 256, 0),
    # head dims outside (32, 64, 128): zero-padded to the next of them
    (4, 4, 16, 4, 6, _EDGE, 24, 0),
    (8, 2, 24, 4, 6, _EDGE, 24, 0),
    (4, 4, 48, 16, 40, [(0, 0, 64), (1, 256, 64)], 128, 0),
    (8, 2, 96, 8, 5, [(0, 0, 33), (1, 8, 7)], 48, 1),
]


def _prefill_inputs(dev, Hq, Hkv, d, bs, nb, segs, total, share, seed=4):
    """Pools of B * nb blocks under a random permutation, each row's table
    -1 past the blocks its tokens fill."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = max(r for r, _, _ in segs) + 1
    P = B * nb
    kp = torch.randn(P, bs, Hkv, d, device=dev, generator=g)
    vp = torch.randn(P, bs, Hkv, d, device=dev, generator=g)
    table = torch.randperm(P, device=dev, generator=g).view(B, nb).clone()
    if share:
        table[1, :share] = table[0, :share]
    fill = [0] * B
    for r, past, L in segs:
        if r >= 0:
            fill[r] = max(fill[r], -(-(past + L) // bs))
    fill = torch.tensor(fill, device=dev)
    table = torch.where(torch.arange(nb, device=dev)[None] < fill[:, None],
                        table, -1).to(torch.int32).contiguous()
    lens = [L for _, _, L in segs]
    cu = torch.tensor([0] + [sum(lens[:i + 1]) for i in range(len(lens))],
                      dtype=torch.int32, device=dev)
    rows = torch.tensor([r for r, _, _ in segs], dtype=torch.int32,
                        device=dev)
    past = torch.tensor([p for _, p, _ in segs], dtype=torch.int32,
                        device=dev)
    q = torch.randn(total, Hq, d, device=dev, generator=g)
    return q, kp, vp, table, cu, rows, past


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_paged_prefill_kernel_matches_plain(dev, dtype, case):
    from repro_torch.serve.paged_attention import (
        LAUNCHES_PREFILL, packed_token_layout, paged_prefill_attention_cuda,
        paged_prefill_attention_ref)
    q, kp, vp, table, cu, rows, past = _prefill_inputs(dev, *case)
    q, kp, vp = (x.to(dtype) for x in (q, kp, vp))
    scale = q.shape[-1] ** -0.5
    before = LAUNCHES_PREFILL.count
    got = paged_prefill_attention_cuda(q, kp, vp, table, cu, rows, past,
                                       scale)
    assert LAUNCHES_PREFILL.count == before + 1
    _, _, row_of_tok, pos = packed_token_layout(cu, rows, past, q.shape[0])
    want = paged_prefill_attention_ref(q.float(), kp.float(), vp.float(),
                                       table, row_of_tok, pos, scale)
    torch.testing.assert_close(got.float(), want, atol=_tol(dtype),
                               rtol=_tol(dtype))
    dead = row_of_tok < 0
    assert (got[dead] == 0).all()
    # the splits merge in a fixed order: a second launch gives the same bits
    assert torch.equal(got, paged_prefill_attention_cuda(
        q, kp, vp, table, cu, rows, past, scale))


def test_scheduler_card_matches_cpu(dev):
    """The smoke model's Scheduler on the card (kernels #11, #12) and on the
    CPU (their plain versions), same weights: identical greedy tokens and
    identical stats over mixed lengths and a shared prefix.  A MoSA model
    hits only on a trie node with a snapshot, which a request inserts at
    its own last full block: the first sharing prompt's short tail puts
    that at depth 32, inside the shared 40 tokens, so the second hits."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.serve import paged_attention as kp
    from repro_torch.serve.paged_kv import PagedConfig
    from repro_torch.serve.scheduler import Scheduler
    cfg = get_config("mosa-paper", preset="smoke", variant="mosa")
    cfg = dataclasses.replace(cfg, mosa=dataclasses.replace(cfg.mosa,
                                                            impl="kernel"))
    paged = PagedConfig(block_size=16, num_blocks=20)
    gpu = Server(cfg, batch=2, max_len=128, paged=paged, seed=3)
    state = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
    cpu = Server(cfg, batch=2, max_len=128, paged=paged, params=state,
                 device="cpu")
    g = torch.Generator().manual_seed(5)
    shared = torch.randint(2, cfg.vocab, (40,), generator=g)
    prompts = [torch.randint(2, cfg.vocab, (L,), generator=g)
               for L in (70, 9)]
    prompts += [torch.cat([shared, torch.randint(2, cfg.vocab, (L,),
                                                 generator=g)])
                for L in (5, 30)]
    out = {}
    for name, srv in (("gpu", gpu), ("cpu", cpu)):
        sched = Scheduler(srv, chunk=4, chunk_tokens=64)
        for i, p in enumerate(prompts):
            sched.submit(p, max_new=6 + i)
        before = kp.LAUNCHES_PREFILL.count
        out[name] = (sched.run(), dict(sched.stats),
                     kp.LAUNCHES_PREFILL.count - before)
    (rg, sg, lg), (rc, sc, lc) = out["gpu"], out["cpu"]
    assert sg == sc and sg["prefix_hits"] >= 1
    assert lg == cfg.n_layers * sg["prefill_chunks"] and lc == 0
    for rid in rc:
        assert torch.equal(rg[rid], rc[rid]), rid


# Block choice (#5-#8): (B, H, NB, bs, d, T, empty, two_segs[, lone_rows]).
# The slice's shape (B*H = 2208, NB 2, bs 16, S 32, d 64); bs 4 with a
# ragged last block (T % bs != 0) and empty blocks; two segments; d 32 and
# 128; for the fused backward S = 64 exactly, bs 3 (S = 21, not a multiple
# of 4), bs 1 and rows whose blocks past the first are all empty; bs 64
# (S = 128), wider than the split kernels' 32-key tile; the forward's route
# boundary at d = 128: S = 64 with rows of block 0 alone (one-row) and
# S = 65 as 5 blocks of 13 (streaming); NB * bs = 128 as 8 blocks of 16
# (the streaming forward over four key tiles, the split backward).
BLOCK_CASES = [(8, 276, 2, 16, 64, 1024, 0, False),
               (2, 3, 9, 4, 64, 101, 6, True),
               (2, 3, 5, 8, 32, 77, 3, True),
               (1, 2, 6, 4, 128, 50, 2, False),
               (1, 3, 4, 16, 128, 300, 2, True),
               (2, 3, 7, 3, 64, 50, 5, False),
               (2, 3, 37, 1, 64, 200, 6, True),
               (2, 3, 4, 8, 64, 90, 0, False, 3),
               (1, 2, 2, 64, 64, 150, 0, True),
               (1, 3, 4, 16, 128, 300, 0, False, 2),
               (1, 2, 5, 13, 128, 100, 1, False),
               (1, 3, 8, 16, 64, 1000, 2, True)]


def _block_route(NB, bs, d):
    """Launches of (fused, dq, dk/dv) one block backward takes."""
    from repro_torch.kernels.mosa_backward import fused_bwd_fits
    return [1, 0, 0] if fused_bwd_fits(NB * bs, d) else [0, 1, 1]


def _block_inputs(dev, B, H, NB, bs, d, T, empty, two_segs, lone_rows=0,
                  seed=6):
    """Per (b, h) NB sorted distinct blocks of a length-T sequence, the
    last (short) block in every row; ``empty`` random slots set to -1 and
    sorted last, as the layer keeps them; the first ``lone_rows`` (b, h)
    rows keep their first block alone."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nbt = -(-T // bs)
    perm = torch.rand(B, H, nbt - 1, device=dev, generator=g).argsort(-1)
    bidx = torch.cat([perm[..., :NB - 1],
                      torch.full((B, H, 1), nbt - 1, device=dev)], -1)
    bidx = bidx.sort(-1).values
    if empty:
        flat = bidx.view(-1)
        flat[torch.randint(0, flat.numel(), (empty,), device=dev,
                           generator=g)] = -1
        bidx = torch.where(bidx < 0, 2 ** 31 - 1, bidx).sort(-1).values
        bidx = torch.where(bidx == 2 ** 31 - 1, -1, bidx)
    bidx.view(-1, NB)[:lone_rows, 1:] = -1
    S = NB * bs
    q, k, v = (torch.randn(B, H, S, d, device=dev, generator=g)
               for _ in range(3))
    rblk = torch.sigmoid(torch.randn(B, H, NB, device=dev, generator=g))
    seg = None
    if two_segs:
        pos = (bidx[..., None] * bs + torch.arange(bs, device=dev)).flatten(-2)
        seg = (pos.clamp(min=0) >= T // 2).to(torch.int32)
    gout = torch.randn(B, H, S, d, device=dev, generator=g)
    return q, k, v, bidx.to(torch.int32).contiguous(), rblk, seg, gout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_kernels_match_plain(dev, dtype, case):
    """#5 and #6 against their plain versions (invalid query rows exact
    zeros); the block backward's route (the fused #7 + #8 at S <= 64, the
    split pair above) and the split #7 and #8, called directly, on the
    same g~, lse and delta as theirs."""
    from repro_torch.kernels import mosa_block as kb
    q, k, v, bidx, rblk, seg, gout = _block_inputs(dev, *case)
    bs, T = case[3], case[5]
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qf, kf, vf = q.float(), k.float(), v.float()
    tol = dict(atol=_tol(dtype), rtol=_tol(dtype))
    _, ok = kb.expand_blocks(bidx, bs, T)
    counters = (kb.LAUNCHES, kb.LAUNCHES_FWD_RES, kb.LAUNCHES_BWD,
                kb.LAUNCHES_DQ, kb.LAUNCHES_DKV)
    before = [c.count for c in counters]

    got = kb.mosa_block_attention_cuda(q, k, v, bidx, rblk, bs, T, seg=seg)
    want = kb.mosa_block_attention_ref(qf, kf, vf, bidx, rblk, bs, T,
                                       seg=seg)
    torch.testing.assert_close(got.float(), want, **tol)
    assert (got[~ok] == 0).all()

    o_pre, lse = kb.mosa_block_attention_fwd_res_cuda(q, k, v, bidx, bs, T,
                                                      seg=seg)
    want_o, want_lse = kb.mosa_block_attention_fwd_res_ref(qf, kf, vf, bidx,
                                                           bs, T, seg=seg)
    torch.testing.assert_close(o_pre, want_o, **tol)
    torch.testing.assert_close(lse, want_lse, **tol)
    assert (o_pre[~ok] == 0).all()

    gt = torch.where(ok[..., None], gout, 0.0).contiguous()
    delta = (gt * want_o).sum(-1).contiguous()
    args = (q, k, v, bidx, gt, want_lse, delta, bs, T)
    routed = kb.mosa_block_attention_bwd_cuda(*args, seg=seg)
    route = [c.count - b for c, b in zip(counters, before)][2:]
    assert route == _block_route(case[2], bs, case[4])
    split = ((kb.mosa_block_attention_bwd_dq_cuda(*args, seg=seg),)
             + kb.mosa_block_attention_bwd_dkv_cuda(*args, seg=seg))
    want_g = kb.mosa_block_attention_bwd_ref(qf, kf, vf, bidx, gt, want_lse,
                                             delta, bs, T, seg=seg)
    for name, a, s, b in zip(("dq", "dk", "dv"), routed, split, want_g):
        assert a.dtype == s.dtype == dtype, name
        torch.testing.assert_close(a.float(), b, msg=name, **tol)
        torch.testing.assert_close(s.float(), b, msg=name, **tol)
    assert [c.count - b for c, b in zip(counters, before)] == \
        [1, 1, route[0], route[1] + 1, route[2] + 1]


def _fused_block_bwd_inputs(dev, dtype, case):
    """The block backward's kernel inputs (q, k, v in ``dtype``; g~, lse
    and delta from the plain forward in fp32), seg and the plain grads."""
    from repro_torch.kernels import mosa_block as kb
    q, k, v, bidx, _, seg, gout = _block_inputs(dev, *case)
    bs, T = case[3], case[5]
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qf, kf, vf = q.float(), k.float(), v.float()
    _, ok = kb.expand_blocks(bidx, bs, T)
    o_pre, lse = kb.mosa_block_attention_fwd_res_ref(qf, kf, vf, bidx, bs, T,
                                                     seg=seg)
    gt = torch.where(ok[..., None], gout, 0.0).contiguous()
    delta = (gt * o_pre).sum(-1).contiguous()
    want = kb.mosa_block_attention_bwd_ref(qf, kf, vf, bidx, gt, lse, delta,
                                           bs, T, seg=seg)
    return (q, k, v, bidx, gt, lse, delta, bs, T), seg, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [c for c in BLOCK_CASES
                                  if c[2] * c[3] <= 64])
def test_fused_block_bwd_matches_plain_and_is_deterministic(dev, dtype,
                                                            case):
    """The fused #7 + #8 against the plain version; two launches equal bit
    for bit (no atomics, a fixed order)."""
    from repro_torch.kernels import mosa_block as kb
    args, seg, want = _fused_block_bwd_inputs(dev, dtype, case)
    before = kb.LAUNCHES_BWD.count
    got = kb.mosa_block_attention_bwd_fused_cuda(*args, seg=seg)
    again = kb.mosa_block_attention_bwd_fused_cuda(*args, seg=seg)
    assert kb.LAUNCHES_BWD.count == before + 2
    for name, a, a2, b in zip(("dq", "dk", "dv"), got, again, want):
        assert a.dtype == dtype, name
        assert torch.equal(a, a2), name
        torch.testing.assert_close(a.float(), b, atol=_tol(dtype),
                                   rtol=_tol(dtype), msg=name)


def test_fused_block_bwd_refuses_rows_past_one_tile(dev):
    from repro_torch.kernels import mosa_block as kb
    args, seg, _ = _fused_block_bwd_inputs(dev, torch.float32,
                                           BLOCK_CASES[-1])
    with pytest.raises(ValueError, match="S <= 64"):
        kb.mosa_block_attention_bwd_fused_cuda(*args, seg=seg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BLOCK_CASES[:3])
def test_block_autograd_function_matches_autograd_of_plain(dev, dtype, case):
    """Grads of sum(out * g) for q, k, v and the block scores through
    kernels #6-#8 against autograd of ``mosa_block_attention_ref`` (fp32)
    on the same inputs (the plain version gets the bf16-rounded g)."""
    from repro_torch.kernels import mosa_block as kb
    q, k, v, bidx, rblk, seg, gout = _block_inputs(dev, *case)
    bs, T = case[3], case[5]
    q, k, v = (x.to(dtype) for x in (q, k, v))
    leaves = [x.clone().requires_grad_() for x in (q, k, v, rblk)]
    counters = (kb.LAUNCHES, kb.LAUNCHES_FWD_RES, kb.LAUNCHES_BWD,
                kb.LAUNCHES_DQ, kb.LAUNCHES_DKV)
    before = [c.count for c in counters]
    out = kb.mosa_block_attention(*leaves[:3], bidx, leaves[3], bs, T,
                                  seg=seg)
    got = torch.autograd.grad((out.float() * gout).sum(), leaves)
    assert [c.count - b for c, b in zip(counters, before)] == \
        [0, 1] + _block_route(case[2], bs, case[4])
    ref = [x.detach().float().requires_grad_() for x in (q, k, v, rblk)]
    want_out = kb.mosa_block_attention_ref(*ref[:3], bidx, ref[3], bs, T,
                                           seg=seg)
    want = torch.autograd.grad((want_out * gout.to(dtype).float()).sum(), ref)
    tol = dict(atol=_tol(dtype), rtol=_tol(dtype))
    torch.testing.assert_close(out.float(), want_out.detach(), **tol)
    for name, a, b in zip(("dq", "dk", "dv", "dr_blk"), got, want):
        torch.testing.assert_close(a.float(), b, msg=name, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_forward_routes(dev, dtype, case):
    """#5 and #6 on both routes, as ``test_mosa_forward_routes``: the routed
    output is the one-row kernel's at S = NB * bs <= 64 and the streaming
    kernel's above, each route matches the plain version (invalid query
    rows exact zeros), two launches are bitwise equal, and at S <= 32 the
    routes agree bit for bit."""
    from repro_torch.kernels import mosa_block as kb
    q, k, v, bidx, rblk, seg, _ = _block_inputs(dev, *case)
    bs, T = case[3], case[5]
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qf, kf, vf = q.float(), k.float(), v.float()
    tol = dict(atol=_tol(dtype), rtol=_tol(dtype))
    _, ok = kb.expand_blocks(bidx, bs, T)
    want = kb.mosa_block_attention_ref(qf, kf, vf, bidx, rblk, bs, T,
                                       seg=seg)
    want_res = kb.mosa_block_attention_fwd_res_ref(qf, kf, vf, bidx, bs, T,
                                                   seg=seg)
    routes = ["stream"] + (["row"] if kb.row_fits(case[2] * bs, case[4])
                           else [])
    outs = {}
    for route in routes:
        fwd = getattr(kb, f"mosa_block_attention_{route}_cuda")
        res = getattr(kb, f"mosa_block_attention_fwd_res_{route}_cuda")
        got, again = (fwd(q, k, v, bidx, rblk, bs, T, seg=seg)
                      for _ in range(2))
        assert torch.equal(got, again), route
        torch.testing.assert_close(got.float(), want, msg=route, **tol)
        assert (got[~ok] == 0).all(), route
        got_res, again_res = (res(q, k, v, bidx, bs, T, seg=seg)
                              for _ in range(2))
        for a, a2, b in zip(got_res, again_res, want_res):
            assert torch.equal(a, a2), route
            torch.testing.assert_close(a, b, msg=route, **tol)
        assert (got_res[0][~ok] == 0).all(), route
        outs[route] = (got,) + tuple(got_res)
    assert torch.equal(kb.mosa_block_attention_cuda(q, k, v, bidx, rblk, bs,
                                                    T, seg=seg), got)
    assert all(torch.equal(a, b) for a, b in zip(
        kb.mosa_block_attention_fwd_res_cuda(q, k, v, bidx, bs, T, seg=seg),
        got_res))
    if case[2] * bs <= 32:
        assert all(torch.equal(a, b)
                   for a, b in zip(outs["row"], outs["stream"]))


def test_block_kernels_at_bs1_equal_token_kernels(dev):
    """At bs = 1 kernels #5 and #6 stage the same values and run the same
    float operations as #1 and #2, on the one-row route and on the
    streaming one: bit for bit equal on the same inputs."""
    from repro_torch.kernels import mosa_attention as km
    from repro_torch.kernels import mosa_block as kb
    q, k, v, idx, r, seg, _ = _train_inputs(dev, *TRAIN_CASES[1])
    idx = torch.where(idx < 0, 2 ** 31 - 1, idx).sort(-1).values
    idx = torch.where(idx == 2 ** 31 - 1, -1, idx).to(torch.int32)
    T = 200
    for route in ("row", "stream"):
        blk = getattr(kb, f"mosa_block_attention_{route}_cuda")
        tok = getattr(km, f"mosa_attention_{route}_cuda")
        assert torch.equal(blk(q, k, v, idx, r, 1, T, seg=seg),
                           tok(q, k, v, idx, r, seg=seg)), route
        blk = getattr(kb, f"mosa_block_attention_fwd_res_{route}_cuda")
        tok = getattr(km, f"mosa_attention_fwd_res_{route}_cuda")
        got = blk(q, k, v, idx, 1, T, seg=seg)
        want = tok(q, k, v, idx, seg=seg)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), route


def test_block_stream_at_bs1_equals_token_stream_at_128(dev):
    """At bs = 1 and S = 128 (four key tiles) the streaming #5 and #6 expand
    the same positions and run the same float operations as the streaming
    #1 and #2 (segments, -1 keys sorted last as the block layer keeps
    them): bit for bit equal in fp32 and bf16."""
    from repro_torch.kernels import mosa_attention as km
    from repro_torch.kernels import mosa_block as kb
    case = STREAM_CASES[2]
    q, k, v, idx, r, seg, _ = _train_inputs(dev, *case)
    idx = torch.where(idx < 0, 2 ** 31 - 1, idx).sort(-1).values
    idx = torch.where(idx == 2 ** 31 - 1, -1, idx).to(torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        qq, kk, vv = (x.to(dtype) for x in (q, k, v))
        assert torch.equal(
            kb.mosa_block_attention_stream_cuda(qq, kk, vv, idx, r, 1,
                                                case[4], seg=seg),
            km.mosa_attention_stream_cuda(qq, kk, vv, idx, r, seg=seg)), dtype
        got = kb.mosa_block_attention_fwd_res_stream_cuda(qq, kk, vv, idx, 1,
                                                          case[4], seg=seg)
        want = km.mosa_attention_fwd_res_stream_cuda(qq, kk, vv, idx,
                                                     seg=seg)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), dtype


def test_fused_block_bwd_at_bs1_equals_fused_token_bwd(dev):
    """At bs = 1 the fused block backward stages the same values and runs
    the same float operations as the fused token backward: bit for bit
    equal on the same g~, lse and delta, in fp32 and bf16."""
    from repro_torch.kernels import mosa_attention as km
    from repro_torch.kernels import mosa_backward as kbwd
    from repro_torch.kernels import mosa_block as kb
    q, k, v, idx, r, seg, gout = _train_inputs(dev, *TRAIN_CASES[1])
    idx = torch.where(idx < 0, 2 ** 31 - 1, idx).sort(-1).values
    idx = torch.where(idx == 2 ** 31 - 1, -1, idx).to(torch.int32)
    o_pre, lse = km.mosa_attention_fwd_res_cuda(q, k, v, idx, seg=seg)
    gt = (gout * r[..., None]).contiguous()
    delta = (gt * o_pre).sum(-1).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        qq, kk, vv = (x.to(dtype) for x in (q, k, v))
        blk = kb.mosa_block_attention_bwd_fused_cuda(qq, kk, vv, idx, gt,
                                                     lse, delta, 1, 200,
                                                     seg=seg)
        tok = kbwd.mosa_attention_bwd_fused_cuda(qq, kk, vv, idx, gt, lse,
                                                 delta, seg=seg)
        for name, a, b in zip(("dq", "dk", "dv"), blk, tok):
            assert torch.equal(a, b), (name, dtype)


def test_split_block_bwd_at_bs1_equals_split_token_bwd(dev):
    """At bs = 1 the split #7 and #8 expand the same positions and run the
    same float operations as the split #3 and #4 (S 128, segments, -1
    keys sorted last as the block layer keeps them): bit for bit equal in
    fp32 and bf16."""
    from repro_torch.kernels import mosa_attention as km
    from repro_torch.kernels import mosa_backward as kbwd
    from repro_torch.kernels import mosa_block as kb
    case = SPLIT_CASES[1]
    q, k, v, idx, r, seg, gout = _train_inputs(dev, *case)
    idx = torch.where(idx < 0, 2 ** 31 - 1, idx).sort(-1).values
    idx = torch.where(idx == 2 ** 31 - 1, -1, idx).to(torch.int32)
    o_pre, lse = km.mosa_attention_fwd_res_ref(q, k, v, idx, seg=seg)
    gt = (gout * r[..., None]).contiguous()
    delta = (gt * o_pre).sum(-1).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        qq, kk, vv = (x.to(dtype) for x in (q, k, v))
        bargs = (qq, kk, vv, idx, gt, lse, delta, 1, case[4])
        targs = (qq, kk, vv, idx, gt, lse, delta)
        blk = ((kb.mosa_block_attention_bwd_dq_cuda(*bargs, seg=seg),)
               + kb.mosa_block_attention_bwd_dkv_cuda(*bargs, seg=seg))
        tok = ((kbwd.mosa_attention_bwd_dq_cuda(*targs, seg=seg),)
               + kbwd.mosa_attention_bwd_dkv_cuda(*targs, seg=seg))
        for name, a, b in zip(("dq", "dk", "dv"), blk, tok):
            assert torch.equal(a, b), (name, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_block_bwd_at_128_matches_plain_and_is_deterministic(dev,
                                                                   dtype):
    """The split #7 and #8 at NB * bs = 128 (8 blocks of 16, a ragged last
    block, empty blocks, two segments) against the plain version, two
    launches bitwise equal; the routed block backward takes them (one count
    each) and gives the same bits."""
    from repro_torch.kernels import mosa_block as kb
    case = (1, 3, 8, 16, 64, 1000, 2, True)
    args, seg, want = _fused_block_bwd_inputs(dev, dtype, case)
    runs = [(kb.mosa_block_attention_bwd_dq_cuda(*args, seg=seg),)
            + kb.mosa_block_attention_bwd_dkv_cuda(*args, seg=seg)
            for _ in range(2)]
    counters = (kb.LAUNCHES_BWD, kb.LAUNCHES_DQ, kb.LAUNCHES_DKV)
    before = [c.count for c in counters]
    routed = kb.mosa_block_attention_bwd_cuda(*args, seg=seg)
    assert [c.count - b for c, b in zip(counters, before)] == \
        _block_route(case[2], case[3], case[4]) == [0, 1, 1]
    for name, a, a2, r, b in zip(("dq", "dk", "dv"), *runs, routed, want):
        assert a.dtype == dtype, name
        assert torch.equal(a, a2) and torch.equal(a, r), name
        torch.testing.assert_close(a.float(), b, atol=_tol(dtype),
                                   rtol=_tol(dtype), msg=name)


def test_block_choice_serving_card_matches_cpu(dev):
    """The smoke model with block choice (bs 16) served on the card (#5,
    #11) and on the CPU, same weights: identical greedy tokens and block
    selections, through ``Server.generate`` and through the Scheduler
    (identical stats, a prefix hit)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import mosa_block as kb
    from repro_torch.launch.serve import Server
    from repro_torch.serve.paged_kv import PagedConfig
    from repro_torch.serve.scheduler import Scheduler
    cfg = get_config("mosa-paper", preset="smoke", variant="mosa",
                     selection_granularity="block", sel_block_size=16)
    cfg = dataclasses.replace(cfg, mosa=dataclasses.replace(cfg.mosa,
                                                            impl="kernel"))
    gpu = Server(cfg, batch=2, max_len=128, paged=PagedConfig(16), seed=4)
    state = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
    cpu = Server(cfg, batch=2, max_len=128, paged=PagedConfig(16),
                 params=state, device="cpu")
    prompts = torch.randint(2, cfg.vocab, (2, 75),
                            generator=torch.Generator().manual_seed(6))
    before = kb.LAUNCHES.count
    tg, cg = gpu.generate(prompts, 8)
    assert kb.LAUNCHES.count - before == cfg.n_layers
    tc, cc = cpu.generate(prompts, 8)
    assert torch.equal(tg.cpu(), tc)
    for a, b in zip(cg, cc):
        assert torch.equal(a["sparse"].bidx.cpu(), b["sparse"].bidx)

    paged = PagedConfig(block_size=16, num_blocks=20)
    g = torch.Generator().manual_seed(7)
    shared = torch.randint(2, cfg.vocab, (40,), generator=g)
    reqs = [torch.randint(2, cfg.vocab, (70,), generator=g),
            torch.cat([shared, torch.randint(2, cfg.vocab, (5,),
                                             generator=g)]),
            torch.cat([shared, torch.randint(2, cfg.vocab, (30,),
                                             generator=g)])]
    out = {}
    for name, dv in (("gpu", None), ("cpu", "cpu")):
        srv = Server(cfg, batch=2, max_len=128, paged=paged, params=state,
                     device=dv)
        sched = Scheduler(srv, chunk=4, chunk_tokens=64)
        for i, p in enumerate(reqs):
            sched.submit(p, max_new=6 + i)
        out[name] = (sched.run(), dict(sched.stats))
    (rg, sg), (rc, sc) = out["gpu"], out["cpu"]
    assert sg == sc and sg["prefix_hits"] >= 1
    for rid in rc:
        assert torch.equal(rg[rid], rc[rid]), rid


# (B, Hq, Hkv, Tq, Tk, d, window): causal and windowed, GQA, Tq < Tk
# through q_offset, ragged tiles, d not a multiple of 32, d = 128; Tq not a
# multiple of the 64-row tile with the window's edge inside a key tile
FLASH_CASES = [(2, 4, 4, 100, 100, 64, 0), (2, 8, 2, 130, 130, 64, 32),
               (1, 4, 2, 1, 300, 64, 64), (1, 4, 2, 77, 200, 36, 0),
               (2, 2, 2, 70, 70, 128, 16), (2, 4, 2, 200, 200, 64, 100),
               (1, 2, 2, 150, 290, 64, 70)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(dev, dtype, case):
    from repro_torch.kernels import flash_attention as F
    B, Hq, Hkv, Tq, Tk, d, window = case
    g = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn(B, Hq, Tq, d, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(B, Hkv, Tk, d, device=dev, generator=g).to(dtype)
            for _ in range(2))
    before = F.LAUNCHES.count
    got = F.flash_attention(q, k, v, window=window)
    assert F.LAUNCHES.count == before + 1 and got.dtype == dtype
    want = F.flash_attention_ref(q.float(), k.float(), v.float(),
                                 window=window)
    torch.testing.assert_close(got.float(), want, atol=_tol(dtype),
                               rtol=_tol(dtype))


# (segment lengths, total, Hq, Hkv, d, window): segments of length 1, a
# padding tail (total > sum), GQA, windows
VARLEN_CASES = [([13, 5, 22, 1], 41, 4, 2, 16, 0),
                ([1, 1, 70, 1, 3], 80, 4, 2, 64, 8),
                ([100, 37], 137, 2, 2, 64, 0), ([65, 64, 1], 130, 8, 2, 32, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", VARLEN_CASES)
def test_flash_varlen_kernel_matches_plain(dev, dtype, case):
    from repro_torch.kernels import flash_attention as F
    lens, total, Hq, Hkv, d, window = case
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(total, Hq, d, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(total, Hkv, d, device=dev, generator=g).to(dtype)
            for _ in range(2))
    cu = torch.tensor([0] + list(torch.tensor(lens).cumsum(0)),
                      dtype=torch.int32, device=dev)
    before = F.LAUNCHES_VARLEN.count
    got = F.flash_attention_varlen(q, k, v, cu, window=window)
    assert F.LAUNCHES_VARLEN.count == before + 1
    want = F.flash_attention_varlen_ref(q.float(), k.float(), v.float(), cu,
                                        window=window)
    torch.testing.assert_close(got.float(), want, atol=_tol(dtype),
                               rtol=_tol(dtype))
    assert not got[int(cu[-1]):].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_are_deterministic(dev, dtype):
    """Two launches of #9 and of #10 are bitwise equal (no atomics, a fixed
    order)."""
    from repro_torch.kernels import flash_attention as F
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn(2, 4, 200, 64, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(2, 2, 200, 64, device=dev, generator=g).to(dtype)
            for _ in range(2))
    for window in (0, 100):
        a, b = (F.flash_attention(q, k, v, window=window) for _ in range(2))
        assert torch.equal(a, b), window
    qv, kv, vv = (x[0].transpose(0, 1).contiguous() for x in (q, k, v))
    cu = torch.tensor([0, 70, 71, 190], dtype=torch.int32, device=dev)
    a, b = (F.flash_attention_varlen(qv, kv, vv, cu, window=50)
            for _ in range(2))
    assert torch.equal(a, b)


def test_window_model_serving_card_matches_cpu(dev):
    """The smoke model with window dense heads (W 16), token and block
    choice (gated), served on the card with the flash route and on the
    CPU, same weights: identical greedy tokens over contiguous rings (#9
    once per layer) and over identity-paged rings (#9 never)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as F
    from repro_torch.launch.serve import Server
    from repro_torch.serve.paged_kv import PagedConfig
    prompts = torch.randint(2, 512, (2, 40),
                            generator=torch.Generator().manual_seed(10))
    for block in ({}, dict(selection_granularity="block", sel_block_size=16)):
        cfg = get_config("mosa-paper", preset="smoke", variant="mosa",
                         local_window=16, **block)
        for paged in (None, PagedConfig(16)):
            gpu = Server(cfg, batch=2, max_len=64, paged=paged, seed=5)
            state = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
            cpu = Server(cfg, batch=2, max_len=64, paged=paged, params=state,
                         device="cpu")
            for srv in (gpu, cpu):
                for layer in srv.model.layers:
                    layer.mixer.dense_impl = "kernel"
            before = F.LAUNCHES.count
            tg, _ = gpu.generate(prompts, 8)
            want = cfg.n_layers if paged is None else 0
            assert F.LAUNCHES.count - before == want
            tc, _ = cpu.generate(prompts, 8)
            assert torch.equal(tg.cpu(), tc), (block, paged)


def test_mesh_trainer_world1_nccl_step_matches_plain(dev, tmp_path):
    """The Trainer on a one-rank mesh (NCCL, world 1, mesh (1, 1) under
    ``fsdp_tp``) against the plain Trainer: the same loss and grad norm
    within 1e-6 relative, the same parameters within 1e-6."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train.loop import TrainConfig, Trainer
    kw = dict(preset="smoke", arch_kwargs={"variant": "mosa"}, seq_len=128,
              global_batch=4, microbatch=2, mosa_impl="kernel", steps=2,
              log_every=1)
    plain = Trainer(TrainConfig(**kw))
    p0, _, h0 = plain.run(install_signals=False)
    mesh_lib.init_process_group("cuda", init_method=f"file://{tmp_path}/pg",
                                world_size=1, rank=0)
    try:
        tr = Trainer(TrainConfig(mesh_shape=(1, 1), rule_set="fsdp_tp", **kw))
        assert dist.get_backend() == "nccl" and tr.ctx.world == 1
        p1, _, h1 = tr.run(install_signals=False)
        full, _ = tr.full_state(p1)
    finally:
        dist.destroy_process_group()
    for a, b in zip(h1, h0):
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= 1e-6 * abs(b[k]), (k, a[k], b[k])
    assert full.keys() == p0.keys()
    for k, p in p0.items():
        torch.testing.assert_close(full[k], p.detach(), atol=1e-6, rtol=0)


def test_mesh_server_world1_nccl_matches_plain(dev, tmp_path):
    """``Server`` on a one-rank NCCL mesh (1, 1) under ``tp`` against the
    plain ``Server`` on the same weights, both under deterministic
    algorithms (``index_add_``'s atomics make two runs differ): identical
    greedy tokens, and the paged kernels' launches of the plain run."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.serve import Server
    from repro_torch.serve import paged_attention as P
    from repro_torch.serve.paged_kv import PagedConfig
    cfg = get_config("mosa-paper", preset="smoke", variant="mosa",
                     sparsity=32, seq_len=1024)
    prompts = torch.randint(2, cfg.vocab, (4, 96),
                            generator=torch.Generator().manual_seed(0))
    kw = dict(batch=4, max_len=128, paged=PagedConfig(16), seed=0)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    mesh_lib.init_process_group("cuda", init_method=f"file://{tmp_path}/pg",
                                world_size=1, rank=0)
    try:
        plain = Server(cfg, **kw)
        before = P.LAUNCHES.count
        want, _ = plain.generate(prompts, 16)
        n_plain = P.LAUNCHES.count - before
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
        srv = Server(cfg, mesh=mesh, rule_set="tp", **kw)
        assert dist.get_backend() == "nccl"
        before = P.LAUNCHES.count
        got, _ = srv.generate(prompts, 16)
        assert P.LAUNCHES.count - before == n_plain == cfg.n_layers * 15
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(prev)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The wide route (csrc/wide_attention.cu): every kernel at head dims 192 and
# 256 (q, k, v and the pools zero-padded to 256 by the wrappers) against its
# plain version; each wrapper call one count, two launches bitwise equal.
WIDE_D = [192, 256]


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


def _counted_twice(counter, fn):
    before = counter.count
    got, again = fn(), fn()
    assert counter.count == before + 2
    got, again = (x if isinstance(x, tuple) else (x,) for x in (got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", WIDE_D)
@pytest.mark.parametrize("S,with_seg,unsorted", [(64, False, False),
                                                 (70, True, True)])
def test_wide_mosa_kernels_match_plain(dev, dtype, d, S, with_seg, unsorted):
    """#1, #2 and the split #3 and #4 on the wide route (S 64 and 70, -1
    keys, r = 0 rows, segments, unsorted idx)."""
    from repro_torch.kernels import mosa_attention as km
    from repro_torch.kernels import mosa_backward as kb
    assert km.fwd_route(S, d) == "wide" and not kb.fused_bwd_fits(S, d)
    q, k, v, idx, r, seg, gout = _train_inputs(dev, 2, 3, S, d, 300, 4, 3,
                                               with_seg, unsorted)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qf, kf, vf = q.float(), k.float(), v.float()
    got, = _counted_twice(km.LAUNCHES, lambda: km.mosa_attention_cuda(
        q, k, v, idx, r, seg=seg))
    _close(got, km.mosa_attention_ref(qf, kf, vf, idx, r, seg=seg), dtype)
    o_pre, lse = _counted_twice(
        km.LAUNCHES_FWD_RES, lambda: km.mosa_attention_fwd_res_cuda(
            q, k, v, idx, seg=seg))
    want_o, want_lse = km.mosa_attention_fwd_res_ref(qf, kf, vf, idx,
                                                     seg=seg)
    _close(o_pre, want_o, dtype)
    _close(lse, want_lse, dtype)
    gt = (gout * r[..., None]).contiguous()
    args = (q, k, v, idx, gt, want_lse, (gt * want_o).sum(-1).contiguous())
    want = kb.mosa_attention_bwd_ref(qf, kf, vf, *args[3:], seg=seg)
    dq, = _counted_twice(kb.LAUNCHES_DQ, lambda: kb.mosa_attention_bwd_dq_cuda(
        *args, seg=seg))
    dk, dv = _counted_twice(
        kb.LAUNCHES_DKV, lambda: kb.mosa_attention_bwd_dkv_cuda(*args,
                                                                seg=seg))
    for g, w in zip((dq, dk, dv), want):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", WIDE_D)
@pytest.mark.parametrize("NB,bs,T,empty,two_segs", [(4, 16, 2041, 0, False),
                                                    (5, 13, 200, 3, True)])
def test_wide_block_kernels_match_plain(dev, dtype, d, NB, bs, T, empty,
                                        two_segs):
    """#5-#8 on the wide route; invalid query rows exact zeros."""
    from repro_torch.kernels import mosa_block as kb
    q, k, v, bidx, rblk, seg, gout = _block_inputs(dev, 2, 3, NB, bs, d, T,
                                                   empty, two_segs)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qf, kf, vf = q.float(), k.float(), v.float()
    _, ok = kb.expand_blocks(bidx, bs, T)
    got, = _counted_twice(kb.LAUNCHES, lambda: kb.mosa_block_attention_cuda(
        q, k, v, bidx, rblk, bs, T, seg=seg))
    assert (got[~ok] == 0).all()
    _close(got, kb.mosa_block_attention_ref(qf, kf, vf, bidx, rblk, bs, T,
                                            seg=seg), dtype)
    o_pre, lse = _counted_twice(
        kb.LAUNCHES_FWD_RES, lambda: kb.mosa_block_attention_fwd_res_cuda(
            q, k, v, bidx, bs, T, seg=seg))
    want_o, want_lse = kb.mosa_block_attention_fwd_res_ref(
        qf, kf, vf, bidx, bs, T, seg=seg)
    _close(o_pre, want_o, dtype)
    _close(lse, want_lse, dtype)
    gt = torch.where(ok[..., None], kb.scale_rows(gout, rblk, bs),
                     0.0).contiguous()
    args = (q, k, v, bidx, gt, want_lse, (gt * want_o).sum(-1).contiguous(),
            bs, T)
    want = kb.mosa_block_attention_bwd_ref(qf, kf, vf, *args[3:], seg=seg)
    dq, = _counted_twice(
        kb.LAUNCHES_DQ, lambda: kb.mosa_block_attention_bwd_dq_cuda(
            *args, seg=seg))
    dk, dv = _counted_twice(
        kb.LAUNCHES_DKV, lambda: kb.mosa_block_attention_bwd_dkv_cuda(
            *args, seg=seg))
    for g, w in zip((dq, dk, dv), want):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", WIDE_D)
def test_wide_flash_kernels_match_plain(dev, dtype, d):
    """#9 (GQA 8/4 at W 100, Tq 77 < Tk 200 causal, and gemma3-4b's 2048
    tokens at W 1024) and #10 (W 8, a padding tail of exact zeros) on the
    wide route."""
    from repro_torch.kernels import flash_attention as F
    g = torch.Generator(device=dev).manual_seed(9)
    for Tq, Tk, W in ((300, 300, 100), (77, 200, 0), (2048, 2048, 1024)):
        q = torch.randn(2, 8, Tq, d, device=dev, generator=g).to(dtype)
        k, v = (torch.randn(2, 4, Tk, d, device=dev, generator=g).to(dtype)
                for _ in range(2))
        got, = _counted_twice(F.LAUNCHES, lambda: F.flash_attention_cuda(
            q, k, v, window=W))
        _close(got, F.flash_attention_ref(q.float(), k.float(), v.float(),
                                          window=W), dtype)
    lens, total = [40, 1, 70, 9], 128
    q = torch.randn(total, 8, d, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(total, 2, d, device=dev, generator=g).to(dtype)
            for _ in range(2))
    cu = torch.tensor([0, 40, 41, 111, 120], dtype=torch.int32, device=dev)
    got, = _counted_twice(F.LAUNCHES_VARLEN, lambda: F.flash_attention_varlen_cuda(
        q, k, v, cu, window=8))
    assert (got[sum(lens):] == 0).all()
    _close(got, F.flash_attention_varlen_ref(q.float(), k.float(), v.float(),
                                             cu, window=8), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", WIDE_D)
@pytest.mark.parametrize("Hq,Hkv", [(8, 4), (14, 2), (12, 2), (4, 4)])
def test_wide_paged_kernels_match_plain(dev, dtype, d, Hq, Hkv):
    """#11 (a row of length 0 exact zeros) and #12 (padding and inactive
    segments exact zeros) on the wide route, GQA groups 2, 7, 6 and 1 (the
    4/4 dense side of gemma3-4b-mosa32)."""
    from repro_torch.serve import paged_attention as P
    g = torch.Generator(device=dev).manual_seed(10)
    B, bs, nb = 3, 16, 9
    kp, vp = (torch.randn(B * nb, bs, Hkv, d, device=dev,
                          generator=g).to(dtype) for _ in range(2))
    table = torch.randperm(B * nb, device=dev, generator=g).view(B, nb)
    table = table.to(torch.int32).contiguous()
    lengths = torch.tensor([0, 130, 1], dtype=torch.int32, device=dev)
    q = torch.randn(B, Hq, d, device=dev, generator=g).to(dtype)
    got, = _counted_twice(P.LAUNCHES, lambda: P.paged_attention_cuda(
        q, kp, vp, table, lengths, d ** -0.5))
    assert (got[0] == 0).all()
    want = P.paged_attention_ref(q.float(), kp.float(), vp.float(), table,
                                 lengths, d ** -0.5)
    _close(got[1:], want[1:], dtype)
    segs = [(0, 0, 5), (1, 13, 3), (-1, 0, 4), (2, 9, 6)]
    cu = torch.tensor([0, 5, 8, 12, 18], dtype=torch.int32, device=dev)
    rows = torch.tensor([r for r, _, _ in segs], dtype=torch.int32,
                        device=dev)
    past = torch.tensor([p for _, p, _ in segs], dtype=torch.int32,
                        device=dev)
    qp = torch.randn(24, Hq, d, device=dev, generator=g).to(dtype)
    _, _, row_of_tok, pos = P.packed_token_layout(cu, rows, past, 24)
    got, = _counted_twice(P.LAUNCHES_PREFILL,
                          lambda: P.paged_prefill_attention_cuda(
                              qp, kp, vp, table, cu, rows, past, d ** -0.5))
    assert (got[row_of_tok < 0] == 0).all()
    _close(got, P.paged_prefill_attention_ref(
        qp.float(), kp.float(), vp.float(), table, row_of_tok, pos,
        d ** -0.5), dtype)
