#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU.  Run it from the root of a checkout:

    python3 chip_smoke.py

Phases (any failure raises, so the script exits nonzero):

  1. the card's name and power limit, the CUDA version;
  2. build the hand-written kernels from ``src/repro_torch/csrc`` (nvcc);
  3. hold each kernel against its plain PyTorch version on the card, in
     fp32 and bf16, at the slices' shapes and at edge cases (TF32 is
     switched off for the plain versions' matmuls): MoSA attention and its
     training forward (o_pre, lse) on both routes (the one-row kernel on
     every case with S <= 64, the streaming kernel, called directly, on
     every case, S = 65 and 70 included; the routed call gives its route's
     bits; two launches of each route bitwise equal), the fused backward
     (dq, dk, dv in one launch, every case with S <= 64, S = 1 and S = 64
     at d 32 and 128 included; two launches bitwise equal) and the split dq
     and dk/dv kernels (every case, S = 128 with positions in no order, -1
     keys and segments across tiles included: their tile skipping by
     value), the autograd Function that joins them
     (grads of q, k, v and r against autograd of the plain version; the
     fused route at S <= 64, the split one above, checked by the
     counters), paged decode (the slice, the Scheduler mix with a row of
     length 0 that must be exact zeros, span boundaries of its 8-block
     cluster, a row whose scores take two windows, a table read from
     device memory; two launches bitwise equal) and packed paged
     prefill (padding tokens and inactive segments exact zeros; cases
     across its key splits of 128: pasts on, one before and one after a
     split boundary, a token at the deepest position, prefix blocks shared
     across a split, R = 3; two launches bitwise equal), both also at head
     dims 16, 24, 48 and 96, which the wrappers zero-pad to the kernels'
     widths (every wrapper call one count), and the
     block-choice kernels (#5 and #6 on both routes as #1 and #2, invalid
     query rows exact zeros; the fused #7 + #8 on every case with S = NB *
     bs <= 64, two launches bitwise equal, and the split #7 and #8, called
     directly, on every case) and their autograd Function (the fused route
     at S <= 64, the split one above, checked by the counters) at the block
     slice's shape and at edge cases (a ragged last block, empty blocks,
     two segments, d 32 and 128, S = 64, bs 3 with S not a multiple of 4,
     bs 1, rows with only block 0, bs 64, S = 65 as 5 blocks of 13), plus
     #5/#6 at bs = 1 against #1/#2 on both routes and the fused block
     backward against the fused token backward (each pair bit for bit
     equal, or the phase fails), and the flash kernels #9 and #10 (GQA, Tq
     < Tk through q_offset, windows, ragged tiles, Tq not a multiple of
     the 64-row tile with the window's edge inside a key tile, d 36 and
     128, segments of length 1, a padding tail that must be zeros; two
     launches bitwise equal);
  4. time each kernel, its plain version and one PyTorch yardstick call
     with CUDA events (L2 flushed before every timed launch); #1, #2, #5
     and #6 on the route the slice takes (the one-row kernel) with the
     streaming kernel beside it (``stream_ms``); also the
     autograd Functions' backward prologues (g~, dr, delta; token and
     block choice) on their own, paged decode at a second shape (the
     Scheduler mix: 8 rows of 128-1152 positions) and packed prefill at a
     second shape (one 256-token segment at past 768, the Scheduler's full
     chunk), both in the ``sched`` JSON's kernel_cases; paged decode's
     and the split #3's and #4's (at [24]'s mosa8 shape) device time from
     ``torch.profiler`` too (``device_ms``);
  5. serve ``mosa-paper-tiny-mosa32`` at full width with the kernel path
     and paged dense KV: batch 8, prompt 1024, 128 generated tokens — the
     launch counters must rise by exactly 6 (MoSA attention, one per layer
     in prefill) and 6 * 127 (paged decode) over that one ``generate``,
     and by 0 for the training kernels and packed prefill;
  6. the card against the CPU at the same width and weights: batch 1,
     prompt 256, 8 greedy tokens;
  7. one decode step of phase 5's shapes under ``torch.profiler``: wall
     time, device time, idle share and kernel launches per step;
  8. train ``mosa-paper-tiny-mosa32`` at full width with ``Trainer``
     (``impl="kernel"``, fp32, remat none): seq 1024, global batch 64 as 8
     microbatches of 8, lr 2.5e-4, clip 0.25, 4 AdamW steps, the first
     untimed — over the 3 timed steps the counters of the training forward
     and the fused backward must rise by exactly 6 * 8 * 3 = 144 each, and
     those of the split dq and dk/dv and of MoSA attention (serving) by 0;
     every loss and grad norm finite;
  9. the card against the CPU for training at the same width and weights:
     batch 1 x 256 tokens, one loss and backward — identical selections
     in every layer first, then the loss within 1e-5 relative and every
     grad within 1e-4 of its tensor's max |grad| on the CPU;
 10. one training microbatch of phase 8's shapes under ``torch.profiler``:
     wall time, device time, idle share, launches and the top device items
     with the operator that launched each;
 11. Scheduler serving of ``mosa-paper-tiny-mosa32`` at full width: batch
     8, max_len 1152, 576 blocks of 16, 8-token decode chunks, 256-token
     packed prefill chunks of up to 4 segments, prefix cache on; 32 seeded
     requests (20 of 128-1024 tokens, 12 behind one shared 512-token
     prefix), after an untimed warm pass on a Scheduler of its own (one
     prefill chunk and one decode chunk of it replayed under
     ``torch.profiler``).  Exact checks: every request gets its max_new,
     every block returns but the trie's, launches of packed prefill = 6 x
     prefill chunks, of paged decode = 6 x decode steps, of #1-#4 = 0;
 12. preemption at full width: 6 prompts of 1008 tokens with max_new 64
     on 127 blocks (two prompts and one block): at least one preemption,
     every request complete, every block back;
 13. the Scheduler on the card against the CPU at full width and the same
     weights: batch 2, 128-token chunks, 4 requests of 96-320 tokens (two
     behind a shared 160-token prefix), 8 greedy tokens each — identical
     tokens and identical stats;
 14. block-choice MoSA (``selection_granularity="block"``, blocks of 16)
     served like phase 5: launches over the generate exactly 6 for #5 and
     6 * 127 for paged decode, 0 for every other kernel;
 15. phase 6 for block choice: identical tokens and identical selected
     blocks in every layer; then phase 7 for block choice (one decode
     step profiled);
 16. block-choice training like phase 8: over the 3 timed steps exactly
     144 launches each of #6 and the fused block backward
     (``mosa_block_attention_bwd``), 0 for #1-#5 and the split #7, #8;
 17. phase 9 for block choice: identical block selections in every layer,
     the loss within 1e-5 relative, every grad within 1e-4;
 18. the block-choice Scheduler at full width (batch 8, 576 blocks of 16,
     256-token chunks of one segment each): a 512-token prefix with one
     token of its own and 7 prompts continuing the prefix by 64-256
     tokens, 16 tokens each, with the prefix cache on and off — identical
     tokens, at least one hit; launches of packed prefill = 6 x chunks, of
     paged decode = 6 x decode steps, of #1-#8 = 0;
 19. phase 13 for block choice;
 20. the window model (``mosa-paper-tiny-mosa32`` with ``local_window=256``:
     4 sliding-window dense heads) served like phase 5 with the dense side
     on the flash route (``dense_impl="kernel"``): over contiguous window
     rings exactly 6 launches of #9 (``flash_attention``, the prefill's
     full forward) and 6 of #1, 0 of paged decode; over paged rings
     (``PagedConfig(16)``, 20b) 6 of #1 and 0 of #9 and paged decode (the
     paged window prefill and the ring decode are plain PyTorch);
 21. the card against the CPU for 20 and 20b: batch 1, prompt 384 (the
     ring wraps), 8 greedy tokens — identical tokens;
 22. block choice beside the window heads (the gated combine) served like
     20: exactly 6 launches of #5 and 6 of #9, identical tokens and block
     selections on the card and the CPU;
 23. forward-only evaluation: ``TransformerLM.loss`` under
     ``torch.no_grad()`` at 8 x 1024 for the dense baseline
     (``mosa-paper-tiny``, 6 layers x 9 heads) and the window model, every
     dense attention on the flash route — exactly 6 launches of #9 each,
     then, under deterministic algorithms, identical MoSA selections and
     the loss within 1e-5 relative of the chunked route's on the same
     weights; 23c: #10 through ``flash_attention_varlen`` on a packed
     stream of eight prompts — exactly one launch, each segment equal to
     #9 on that segment alone;
 24. the paper's IsoFLOP sweep at full width through ``run_isoflop``:
     ``mosa-paper`` tiny at T 1024, dense, mosa, fixed and routing at
     sparsities 8 and 32 (7 points), 6 steps each of 64 x 1024 tokens as 8
     microbatches, kernel path.  Per point the counters are zeroed before
     and read after: mosa32 exactly 288 each of #2 and the fused backward,
     mosa8 288 of #2 (the streaming route, k = 128) and 288 each of the
     split #3 and #4, every other point 0; every loss finite; the
     Trainer's metrics file and trace (under ``build/isoflop/``)
     hold 6 ``train.step_time_s`` observations and 6 ``train_step`` spans,
     whose median over steps 1-5 gives the step time and tokens/s; the
     dense and mosa budgets within 5%; 24b: one microbatch of mosa8 and
     of mosa32 under ``torch.profiler``, each MoSA kernel's device time
     by name;
 25. the card against the CPU for ``fixed32`` and ``routing32`` at full
     width and the same weights, as phase 9 (routing: identical cluster
     selections in every layer first), under deterministic algorithms.

Phases 3 and 4 hold and time #9 and #10 too.  The last nine lines are the
``serve`` JSON, the ``train`` JSON, the ``sched`` JSON, the ``block``
JSON, the ``window`` JSON, the ``sweep`` JSON, the ``kernels`` JSON, the
``nvidia-smi`` name and power limit, and the result JSON.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
FP32_FLOP_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
FP32_TOL = 2e-5
BF16_TOL = 2e-2              # ceiling of the bf16 tolerance (see bf16_tol)
BF16_RTOL = 2.0 ** -7        # one bf16 ulp: covers rounding the output


def log(*a):
    print(*a, flush=True)


def time_ms(torch, fn, iters=20, warmup=3, flush=None):
    """Mean device time of ``fn()`` in ms over ``iters`` launches, each
    timed by its own CUDA events after an L2 flush."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def device_ms_by_kernel(torch, fn, flush, names, iters=10):
    """Mean device time per call (ms) of the kernels whose names contain
    each of ``names``, from ``torch.profiler`` over ``iters`` calls of
    ``fn``, each after an L2 flush."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for ev in prof.key_averages():
        for name in names:
            if name in ev.key:
                out[name] += ev.device_time_total / 1e3 / iters
    return out


def kernel_label(mangled):
    """A kernel's name and template arguments from its mangled name, e.g.
    ``mosa_bwd_dq_kernel<float,false,1>`` (ptxas's logs print mangled
    names): the last <length><name> component of the nested name, then
    its template arguments."""
    i, name = (3 if mangled.startswith("_ZN") else 2), None
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    if not name:
        return mangled[:60]
    if not mangled.startswith("I", i):
        return name
    args = re.findall(r"f|13__nv_bfloat16|Lb[01]|Li-?\d+",
                      mangled[i + 1:mangled.find("EE", i)])
    names = {"f": "float", "13__nv_bfloat16": "bf16", "Lb0": "false",
             "Lb1": "true"}
    return f"{name}<" + ",".join(names.get(a, a[2:]) for a in args) + ">"


def bf16_tol(want):
    """(atol, rtol) for a bf16 kernel output against its plain version in
    fp32 on the same bf16-rounded inputs.  The kernels compute in fp32 and
    round only the output (relative error <= 2**-8), which ``BF16_RTOL``
    covers; ``atol`` is a tenth of the reference's mean magnitude, capped
    at ``BF16_TOL``, so an error of the size of a typical output fails."""
    return min(BF16_TOL, 0.1 * want.float().abs().mean().item()), BF16_RTOL


def max_err(torch, got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bad.any():
        raise AssertionError(f"kernel disagrees with its plain version: max "
                             f"abs err {err.max().item():.3e} (atol "
                             f"{atol:.2e}, rtol {rtol:.2e})")
    return err.max().item()


def check_case(torch, kernel, plain, name, case, errs, parts=None,
               zeros=()):
    """Runs ``kernel`` in fp32 and bf16 against ``plain`` in fp32 on the
    same (rounded) inputs; records the fp32 error of the slice's case.
    With ``parts``, both return a tuple of outputs, each checked and
    recorded as ``name.part``; the fp32 error of [24]'s mosa8 case is
    recorded as ``label@sweep``.  The parts named in ``zeros`` are zero in
    exact arithmetic on this case (dq and dk at S = 1, where a softmax over
    one key passes no gradient to its score): in both dtypes the kernel's
    output and the plain version's must each lie within ``FP32_TOL`` of
    zero, since both are fp32 rounding noise."""
    labels = [name] if parts is None else [f"{name}.{p}" for p in parts]
    zero_labels = {f"{name}.{p}" for p in zeros}
    for dt in (torch.float32, torch.bfloat16):
        got, want = kernel(dt), plain(dt)
        if parts is None:
            got, want = (got,), (want,)
        torch.cuda.synchronize()
        for label, g, w in zip(labels, got, want):
            if label in zero_labels:
                atol, rtol = FP32_TOL, 0.0
                max_err(torch, w, torch.zeros_like(w), atol, rtol)
                e = max_err(torch, g, torch.zeros_like(g), atol, rtol)
                log(f"  {label:31s} {case:40s} {str(dt):15s} max|out| "
                    f"{e:.3e} (zero in exact arithmetic; atol {atol:.2e})")
                continue
            atol, rtol = ((FP32_TOL, FP32_TOL) if dt == torch.float32
                          else bf16_tol(w))
            e = max_err(torch, g, w, atol, rtol)
            if dt == torch.float32 and case.startswith("slice"):
                errs[label] = e
            if dt == torch.float32 and case.startswith("sweep"):
                errs[f"{label}@sweep"] = e
            log(f"  {label:31s} {case:40s} {str(dt):15s} max|err| {e:.3e} "
                f"(atol {atol:.2e}, rtol {rtol:.2e})")


def check_fwd_routes(torch, name, case, routed, row, stream, S, d):
    """A forward kernel's routes on one case of S selected tokens of width
    d, in fp32 and bf16: the routed wrapper gives the bits of the route it
    takes (the one-row kernel where the row fits, else the streaming one),
    two launches of each route are bitwise equal, and at S <= 32 (one key
    tile of the streaming kernel, so the same float operations) the two
    routes agree bit for bit.  Each of ``routed``, ``row``, ``stream`` maps
    a dtype to the output (a tensor or a tuple)."""
    from repro_torch.kernels.mosa_attention import row_fits
    fits = row_fits(S, d)
    def same(a, b):
        a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
        return all(torch.equal(x, y) for x, y in zip(a, b))

    for dt in (torch.float32, torch.bfloat16):
        want = (row if fits else stream)(dt)
        if not same(routed(dt), want):
            raise AssertionError(f"{name} ({case}, {dt}): the routed call is "
                                 "not its route's output")
        for fn in ((row, stream) if fits else (stream,)):
            if not same(fn(dt), fn(dt)):
                raise AssertionError(f"{name} ({case}, {dt}): two launches "
                                     "differ")
        if S <= 32 and not same(want, stream(dt)):
            raise AssertionError(f"{name} ({case}, {dt}): the one-row and "
                                 "streaming kernels differ at S <= 32")
    log(f"  {name:31s} {case:40s} routed to the "
        f"{'one-row' if fits else 'streaming'} kernel; two launches of "
        "each route bitwise equal (fp32, bf16)"
        + ("; the routes bitwise equal" if S <= 32 else ""))


# ----------------------------------------------------------------- inputs
def mosa_inputs(torch, B, H, S, d, T, dev, gen, neg_keys=0, zero_rows=0,
                with_seg=False, unsorted=False):
    """Expert-choice-like inputs: per (b, h) S sorted distinct positions of
    a length-T sequence, token 0 forced (``unsorted``: the same positions
    in a random order); ``neg_keys`` random slots set to -1, ``zero_rows``
    random rows with r = 0."""
    q, k, v = (torch.randn(B, H, S, d, device=dev, generator=gen)
               for _ in range(3))
    perm = torch.rand(B, H, T - 1, device=dev, generator=gen).argsort(-1)
    idx = torch.cat([torch.zeros(B, H, 1, device=dev, dtype=torch.long),
                     perm[..., :S - 1] + 1], -1).sort(-1).values
    if unsorted:
        idx = idx.gather(-1, torch.rand(B, H, S, device=dev,
                                        generator=gen).argsort(-1))
    if neg_keys:
        flat = idx.view(-1)
        flat[torch.randint(0, flat.numel(), (neg_keys,), device=dev,
                           generator=gen)] = -1
    r = torch.sigmoid(torch.randn(B, H, S, device=dev, generator=gen))
    if zero_rows:
        r.view(-1)[torch.randint(0, r.numel(), (zero_rows,), device=dev,
                                 generator=gen)] = 0.0
    seg = (torch.randint(0, 3, (B, H, S), device=dev, generator=gen)
           .sort(-1).values.to(torch.int32) if with_seg else None)
    return q, k, v, idx.to(torch.int32), r, seg


def paged_inputs(torch, B, Hq, Hkv, d, bs, nb, lengths, dev, gen,
                 neg_tail=False):
    """Pools of B * nb blocks under a random permutation of block ids;
    ``neg_tail`` marks every block past a row's length as -1."""
    N = B * nb
    kp = torch.randn(N, bs, Hkv, d, device=dev, generator=gen)
    vp = torch.randn(N, bs, Hkv, d, device=dev, generator=gen)
    table = torch.randperm(N, device=dev, generator=gen).view(B, nb)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if neg_tail:
        used = (lengths.long() + bs - 1) // bs
        table = torch.where(torch.arange(nb, device=dev)[None] < used[:, None],
                            table, -1)
    q = torch.randn(B, Hq, d, device=dev, generator=gen)
    return q, kp, vp, table.to(torch.int32).contiguous(), lengths


# ---------------------------------------------------------------- checks
# [24]'s mosa8 point: (B, H, S, d) of its #2, #3 and #4 (a microbatch of 8
# rows, 69 MoSA heads, k = 1024 // 8 selected tokens)
SWEEP_MOSA8 = (8, 69, 128, 64)
SWEEP_MOSA8_NAME = "mosa8 8x69x128"
MOSA_CASES = {
    "slice (8,276,32,64)": dict(B=8, H=276, S=32, d=64, T=1024),
    # [24]'s mosa8 (k = 128 > 64: the streaming #2, the split #3 and #4)
    "sweep mosa8 (8,69,128,64)": dict(zip("BHSd", SWEEP_MOSA8), T=1024),
    "ragged S=37, idx=-1 keys, r=0 rows, seg": dict(
        B=2, H=3, S=37, d=64, T=200, neg_keys=20, zero_rows=10,
        with_seg=True),
    "two query tiles, d=80": dict(B=1, H=2, S=70, d=80, T=300, neg_keys=5),
    # boundaries of the fused backward (S <= 64 in one tile)
    "S=1": dict(B=2, H=3, S=1, d=64, T=10),
    "S=64 d=128, seg (largest smem)": dict(
        B=1, H=3, S=64, d=128, T=300, neg_keys=4, zero_rows=3,
        with_seg=True),
    "S=64 d=32, idx=-1 keys": dict(B=2, H=2, S=64, d=32, T=300, neg_keys=12),
    # the first S past the one-row kernels (streaming forward, split bwd)
    "S=65 d=128, seg": dict(B=1, H=3, S=65, d=128, T=300, neg_keys=4,
                            zero_rows=3, with_seg=True),
    # the split backward's tile skipping by value: positions in no order,
    # -1 keys in the middle, segments across tile boundaries
    "S=128 unsorted idx, -1 keys, seg": dict(
        B=2, H=3, S=128, d=64, T=1024, neg_keys=6, zero_rows=3,
        with_seg=True, unsorted=True),
}


def check_train_kernels(torch, dev, gen, errs):
    """The training forward, the backward kernels (on the same g~, lse and
    delta as their plain version: the fused kernel on every case with S <=
    64, two of its launches bitwise equal; the split #3 and #4, called
    directly, on every case) and the autograd Function end to end (grads of
    sum(out * g) for q, k, v and r against autograd of
    ``mosa_attention_ref``; the fused route at S <= 64, the split route
    above)."""
    from repro_torch.kernels import mosa_attention as kmosa
    from repro_torch.kernels import mosa_backward as kbwd
    for case, kw in MOSA_CASES.items():
        q, k, v, idx, r, seg = mosa_inputs(torch, dev=dev, gen=gen, **kw)
        g = torch.randn(q.shape, device=dev, generator=gen)

        def on(fn):
            return lambda dt: fn(q.to(dt), k.to(dt), v.to(dt), idx, seg=seg)

        def plain_fwd(dt):
            return kmosa.mosa_attention_fwd_res_ref(
                *(t.to(dt).float() for t in (q, k, v)), idx, seg=seg)

        check_case(torch, on(kmosa.mosa_attention_fwd_res_cuda), plain_fwd,
                   "mosa_attention_fwd_res", case, errs, ("o_pre", "lse"))
        check_case(torch, on(kmosa.mosa_attention_fwd_res_stream_cuda),
                   plain_fwd, "mosa_attention_fwd_res[stream]", case, errs,
                   ("o_pre", "lse"))
        check_fwd_routes(torch, "mosa_attention_fwd_res", case,
                         on(kmosa.mosa_attention_fwd_res_cuda),
                         on(kmosa.mosa_attention_fwd_res_row_cuda),
                         on(kmosa.mosa_attention_fwd_res_stream_cuda),
                         kw["S"], kw["d"])

        def bwd(fn, dt, cast):
            qq, kk, vv = (cast(t.to(dt)) for t in (q, k, v))
            o_pre, lse = kmosa.mosa_attention_fwd_res_ref(
                *(t.float() for t in (qq, kk, vv)), idx, seg=seg)
            gt = (g * r[..., None]).contiguous()
            delta = (gt * o_pre).sum(-1).contiguous()
            return fn(qq, kk, vv, idx, gt, lse, delta, seg=seg)

        def split(*args, **opts):
            return ((kbwd.mosa_attention_bwd_dq_cuda(*args, **opts),)
                    + kbwd.mosa_attention_bwd_dkv_cuda(*args, **opts))

        def plain(dt):
            return bwd(kbwd.mosa_attention_bwd_ref, dt, lambda t: t.float())

        fused = kbwd.fused_bwd_fits(kw["S"], kw["d"])
        zeros = ("dq", "dk") if kw["S"] == 1 else ()
        if fused:
            check_case(
                torch, lambda dt: bwd(kbwd.mosa_attention_bwd_fused_cuda, dt,
                                      lambda t: t),
                plain, "mosa_attention_bwd", case, errs, ("dq", "dk", "dv"),
                zeros)
            for dt in (torch.float32, torch.bfloat16):
                first, again = (bwd(kbwd.mosa_attention_bwd_fused_cuda, dt,
                                    lambda t: t) for _ in range(2))
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    raise AssertionError(f"fused backward not deterministic "
                                         f"on {case} in {dt}")
            log(f"  {'mosa_attention_bwd':31s} {case:40s} two launches "
                "bitwise equal (fp32, bf16)")
        check_case(torch, lambda dt: bwd(split, dt, lambda t: t), plain,
                   "mosa_attention_bwd_split", case, errs, ("dq", "dk", "dv"),
                   zeros)

        def function_grads(dt, plain):
            # a bf16 output's cotangent arrives in bf16: the plain version
            # gets the same rounded g
            leaves = [t.to(dt).float() if plain else t.to(dt)
                      for t in (q, k, v)] + [r]
            leaves = [t.clone().requires_grad_() for t in leaves]
            fn = kmosa.mosa_attention_ref if plain else kmosa.mosa_attention
            out = fn(*leaves[:3], idx, leaves[3], seg=seg)
            gg = g.to(dt).float() if plain else g
            return torch.autograd.grad((out.float() * gg).sum(), leaves)

        counters = (kbwd.LAUNCHES, kbwd.LAUNCHES_DQ, kbwd.LAUNCHES_DKV)
        before = [c.count for c in counters]
        check_case(torch, lambda dt: function_grads(dt, False),
                   lambda dt: function_grads(dt, True),
                   "mosa_attention_function", case, errs,
                   ("dq", "dk", "dv", "dr"), zeros)
        # one backward per dtype, through the route this case's S takes
        route = [c.count - b for c, b in zip(counters, before)]
        if route != ([2, 0, 0] if fused else [0, 2, 2]):
            raise AssertionError(f"the Function's backward on {case} took "
                                 f"{route} launches of (fused, dq, dkv)")
    # the error of each kernel's row in the kernels JSON
    errs["mosa_attention_fwd_res"] = max(errs["mosa_attention_fwd_res.o_pre"],
                                         errs["mosa_attention_fwd_res.lse"])
    errs["mosa_attention_bwd"] = max(errs[f"mosa_attention_bwd.{p}"]
                                     for p in ("dq", "dk", "dv"))
    # the split #3 and #4 run on a main path only at [24]'s mosa8 (their
    # S 32 errors stay as "[S 32]"), and so does the streaming #2
    for at, tag in (("@sweep", ""), ("", "[S 32]")):
        errs[f"mosa_attention_bwd_dq{tag}"] = errs[
            f"mosa_attention_bwd_split.dq{at}"]
        errs[f"mosa_attention_bwd_dkv{tag}"] = max(
            errs[f"mosa_attention_bwd_split.dk{at}"],
            errs[f"mosa_attention_bwd_split.dv{at}"])
    errs[f"mosa_attention_fwd_res[{SWEEP_MOSA8_NAME}]"] = max(
        errs["mosa_attention_fwd_res.o_pre@sweep"],
        errs["mosa_attention_fwd_res.lse@sweep"])


# Block choice (#5-#8): the slice's shape (B*H = 2208, NB 2, bs 16, S 32,
# d 64) and edge cases: a ragged last block (T % bs != 0) in every case but
# the slice, empty blocks (bidx -1, sorted last), two segments, d 32 and
# 128; for the fused backward S = 64 exactly, bs 3 (S = 21, so the staged
# tile pads to 24 rows), bs 1 and rows whose blocks past block 0 are all
# empty; a block wider than the split kernels' 32-key tile (S = 128, the
# split route's case).
BLOCK_CASES = {
    "slice (8,276) NB=2 bs=16 d=64": dict(B=8, H=276, NB=2, bs=16, d=64,
                                          T=1024),
    "bs=4, T % bs != 0, empty blocks": dict(B=2, H=3, NB=9, bs=4, d=64,
                                            T=101, empty=6),
    "bs=8 d=32, two segments, empty": dict(B=2, H=3, NB=5, bs=8, d=32,
                                           T=77, empty=3, two_segs=True),
    "bs=4 d=128, two segments, empty": dict(B=1, H=2, NB=6, bs=4, d=128,
                                            T=50, empty=2, two_segs=True),
    "S=64 (NB=4 bs=16) d=128, two segs": dict(B=1, H=3, NB=4, bs=16, d=128,
                                              T=300, empty=2, two_segs=True),
    "bs=3 (S=21), T % bs != 0, empty": dict(B=2, H=3, NB=7, bs=3, d=64, T=50,
                                            empty=5),
    "bs=1 (NB=37), two segments, empty": dict(B=2, H=3, NB=37, bs=1, d=64,
                                              T=200, empty=6, two_segs=True),
    "rows with only block 0": dict(B=2, H=3, NB=4, bs=8, d=64, T=90,
                                   lone_rows=3),
    "bs=64, wider than a key tile": dict(B=1, H=2, NB=2, bs=64, d=64, T=150,
                                         two_segs=True),
    # the first S past the one-row kernels at d 128 (streaming forward)
    "S=65 (NB=5 bs=13) d=128, empty": dict(B=1, H=2, NB=5, bs=13, d=128,
                                           T=100, empty=1),
}


def block_inputs(torch, B, H, NB, bs, d, T, dev, gen, empty=0,
                 two_segs=False, lone_rows=0):
    """Per (b, h) NB sorted distinct blocks of a length-T sequence: block 0
    (forced, as the layer forces it), the last, short block when bs does
    not divide T, and random others; ``empty`` random slots set to -1 and
    sorted last, as the layer keeps them; the first ``lone_rows`` (b, h)
    rows keep block 0 alone."""
    nbt = -(-T // bs)
    ragged = int(T % bs != 0)
    perm = torch.rand(B, H, nbt - 1 - ragged, device=dev,
                      generator=gen).argsort(-1)
    bidx = torch.cat([torch.zeros(B, H, 1, device=dev, dtype=torch.long),
                      perm[..., :NB - 1 - ragged] + 1,
                      torch.full((B, H, ragged), nbt - 1, device=dev)], -1)
    bidx = bidx.sort(-1).values
    if empty:
        bidx.view(-1)[torch.randint(0, bidx.numel(), (empty,), device=dev,
                                    generator=gen)] = -1
        key = torch.where(bidx < 0, 2 ** 31 - 1, bidx).sort(-1).values
        bidx = torch.where(key == 2 ** 31 - 1, -1, key)
    bidx.view(-1, NB)[:lone_rows, 1:] = -1
    S = NB * bs
    q, k, v = (torch.randn(B, H, S, d, device=dev, generator=gen)
               for _ in range(3))
    rblk = torch.sigmoid(torch.randn(B, H, NB, device=dev, generator=gen))
    seg = None
    if two_segs:
        pos = (bidx[..., None] * bs + torch.arange(bs, device=dev)).flatten(-2)
        seg = (pos.clamp(min=0) >= T // 2).to(torch.int32)
    return q, k, v, bidx.to(torch.int32).contiguous(), rblk, seg


def check_block_kernels(torch, dev, gen, errs):
    """#5 and #6 against their plain versions (invalid query rows exact
    zeros); the backward kernels on the same g~, lse and delta as theirs:
    the fused #7 + #8 on every case with S <= 64, two of its launches
    bitwise equal, and the split #7 and #8, called directly, on every case;
    the autograd Function against autograd of ``mosa_block_attention_ref``
    (the fused route at S <= 64, the split route above)."""
    from repro_torch.kernels import mosa_backward as kbwd
    from repro_torch.kernels import mosa_block as kb
    for case, kw in BLOCK_CASES.items():
        q, k, v, bidx, rblk, seg = block_inputs(torch, dev=dev, gen=gen,
                                                **kw)
        bs, T = kw["bs"], kw["T"]
        _, ok = kb.expand_blocks(bidx, bs, T)
        g = torch.randn(q.shape, device=dev, generator=gen)

        def zeros_outside(out, name):
            if (out[~ok] != 0).any():
                raise AssertionError(f"{name} ({case}): invalid query rows "
                                     "not zero")
            return out

        def on(fn, *rb):
            return lambda dt: fn(q.to(dt), k.to(dt), v.to(dt), bidx, *rb, bs,
                                 T, seg=seg)

        S, d = kw["NB"] * bs, kw["d"]
        for route in ("", "_stream"):
            fwd = getattr(kb, f"mosa_block_attention{route}_cuda")
            check_case(
                torch,
                lambda dt: zeros_outside(on(fwd, rblk)(dt),
                                         "mosa_block_attention"),
                lambda dt: kb.mosa_block_attention_ref(
                    *(x.to(dt).float() for x in (q, k, v)), bidx, rblk, bs,
                    T, seg=seg),
                f"mosa_block_attention{route and '[stream]'}", case, errs)
            res = getattr(kb, f"mosa_block_attention_fwd_res{route}_cuda")
            check_case(
                torch,
                lambda dt: tuple(zeros_outside(x, "fwd_res") if i == 0 else x
                                 for i, x in enumerate(on(res)(dt))),
                lambda dt: kb.mosa_block_attention_fwd_res_ref(
                    *(x.to(dt).float() for x in (q, k, v)), bidx, bs, T,
                    seg=seg),
                f"mosa_block_attention_fwd_res{route and '[stream]'}", case,
                errs, ("o_pre", "lse"))
        check_fwd_routes(torch, "mosa_block_attention", case,
                         on(kb.mosa_block_attention_cuda, rblk),
                         on(kb.mosa_block_attention_row_cuda, rblk),
                         on(kb.mosa_block_attention_stream_cuda, rblk), S, d)
        check_fwd_routes(torch, "mosa_block_attention_fwd_res", case,
                         on(kb.mosa_block_attention_fwd_res_cuda),
                         on(kb.mosa_block_attention_fwd_res_row_cuda),
                         on(kb.mosa_block_attention_fwd_res_stream_cuda), S,
                         d)

        def bwd(fn, dt, cast):
            qq, kk, vv = (cast(x.to(dt)) for x in (q, k, v))
            o_pre, lse = kb.mosa_block_attention_fwd_res_ref(
                *(x.float() for x in (qq, kk, vv)), bidx, bs, T, seg=seg)
            gt = torch.where(ok[..., None], g, 0.0).contiguous()
            delta = (gt * o_pre).sum(-1).contiguous()
            return fn(qq, kk, vv, bidx, gt, lse, delta, bs, T, seg=seg)

        def split(*args, **opts):
            return ((kb.mosa_block_attention_bwd_dq_cuda(*args, **opts),)
                    + kb.mosa_block_attention_bwd_dkv_cuda(*args, **opts))

        def plain(dt):
            return bwd(kb.mosa_block_attention_bwd_ref, dt,
                       lambda x: x.float())

        fused = kbwd.fused_bwd_fits(kw["NB"] * bs, kw["d"])
        if fused:
            check_case(
                torch, lambda dt: bwd(kb.mosa_block_attention_bwd_fused_cuda,
                                      dt, lambda x: x),
                plain, "mosa_block_attention_bwd", case, errs,
                ("dq", "dk", "dv"))
            for dt in (torch.float32, torch.bfloat16):
                first, again = (bwd(kb.mosa_block_attention_bwd_fused_cuda,
                                    dt, lambda x: x) for _ in range(2))
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    raise AssertionError(f"fused block backward not "
                                         f"deterministic on {case} in {dt}")
            log(f"  {'mosa_block_attention_bwd':31s} {case:40s} two launches "
                "bitwise equal (fp32, bf16)")
        check_case(torch, lambda dt: bwd(split, dt, lambda x: x), plain,
                   "mosa_block_attention_bwd_split", case, errs,
                   ("dq", "dk", "dv"))

        def function_grads(dt, plain):
            leaves = [x.to(dt).float() if plain else x.to(dt)
                      for x in (q, k, v)] + [rblk]
            leaves = [x.clone().requires_grad_() for x in leaves]
            fn = (kb.mosa_block_attention_ref if plain
                  else kb.mosa_block_attention)
            out = fn(*leaves[:3], bidx, leaves[3], bs, T, seg=seg)
            gg = g.to(dt).float() if plain else g
            return torch.autograd.grad((out.float() * gg).sum(), leaves)

        counters = (kb.LAUNCHES_BWD, kb.LAUNCHES_DQ, kb.LAUNCHES_DKV)
        before = [c.count for c in counters]
        check_case(torch, lambda dt: function_grads(dt, False),
                   lambda dt: function_grads(dt, True),
                   "mosa_block_attention_function", case, errs,
                   ("dq", "dk", "dv", "dr_blk"))
        # one backward per dtype, through the route this case's S takes
        route = [c.count - b for c, b in zip(counters, before)]
        if route != ([2, 0, 0] if fused else [0, 2, 2]):
            raise AssertionError(f"the block Function's backward on {case} "
                                 f"took {route} launches of (fused, dq, dkv)")
    errs["mosa_block_attention_fwd_res"] = max(
        errs["mosa_block_attention_fwd_res.o_pre"],
        errs["mosa_block_attention_fwd_res.lse"])
    errs["mosa_block_attention_bwd"] = max(
        errs[f"mosa_block_attention_bwd.{p}"] for p in ("dq", "dk", "dv"))
    errs["mosa_block_attention_bwd_dq"] = errs[
        "mosa_block_attention_bwd_split.dq"]
    errs["mosa_block_attention_bwd_dkv"] = max(
        errs["mosa_block_attention_bwd_split.dk"],
        errs["mosa_block_attention_bwd_split.dv"])
    check_block_bs1(torch, dev, gen)


def check_block_bs1(torch, dev, gen):
    """#5, #6 and the fused block backward at bs = 1 against #1, #2 and
    the fused token backward on the same inputs (the backward on the same
    g~, lse and delta), the forwards on both routes: the block kernels
    stage the same values and run the same float operations, so each pair
    must agree bit for bit."""
    from repro_torch.kernels import mosa_attention as km
    from repro_torch.kernels import mosa_backward as kbwd
    from repro_torch.kernels import mosa_block as kb
    q, k, v, idx, r, seg = mosa_inputs(torch, 2, 3, 37, 64, 200, dev, gen,
                                       zero_rows=10, with_seg=True)
    o_pre, lse = km.mosa_attention_fwd_res_cuda(q, k, v, idx, seg=seg)
    gt = (torch.randn(q.shape, device=dev, generator=gen)
          * r[..., None]).contiguous()
    delta = (gt * o_pre).sum(-1).contiguous()

    def flat(ts):
        return torch.cat([t.flatten() for t in ts])

    pairs = []
    for route in ("row", "stream"):
        pairs += [
            (f"#5 vs #1 ({route})",
             getattr(kb, f"mosa_block_attention_{route}_cuda")(
                 q, k, v, idx, r, 1, 200, seg=seg),
             getattr(km, f"mosa_attention_{route}_cuda")(
                 q, k, v, idx, r, seg=seg)),
            (f"#6 vs #2 ({route})",
             flat(getattr(kb, f"mosa_block_attention_fwd_res_{route}_cuda")(
                 q, k, v, idx, 1, 200, seg=seg)),
             flat(getattr(km, f"mosa_attention_fwd_res_{route}_cuda")(
                 q, k, v, idx, seg=seg)))]
    pairs.append((
        "fused block bwd vs fused token bwd",
        flat(kb.mosa_block_attention_bwd_fused_cuda(q, k, v, idx, gt, lse,
                                                    delta, 1, 200, seg=seg)),
        flat(kbwd.mosa_attention_bwd_fused_cuda(q, k, v, idx, gt, lse, delta,
                                                seg=seg))))
    for name, a, b in pairs:
        e = max_err(torch, a, b, FP32_TOL, FP32_TOL)
        log(f"  bs=1 {name}: bitwise equal {torch.equal(a, b)}, max|err| "
            f"{e:.3e}")
        if not torch.equal(a, b):
            raise AssertionError(f"bs=1 {name}: not bit for bit equal")


# Packed prefill (#12): segments (row, past, len), row -1 inactive; the
# total past the last segment is a padding tail; ``share`` blocks at the
# head of rows 0 and 1 are the same physical blocks (a prefix hit).
PREFILL_SLICE_SEGS = [(0, 0, 64), (1, 256, 64), (2, 512, 64), (3, 960, 64)]
PREFILL_EDGE_SEGS = [(0, 0, 5), (1, 13, 3), (2, 7, 1), (-1, 0, 4),
                     (3, 9, 6)]
PREFILL_SLICE = "slice 256 tok/4 segs, pasts 0-960 d=64"
# the last 256-token chunk of a 1024-token prompt (one segment)
PREFILL_FULL_CHUNK = "1 seg 256 tok, past 768 d=64"
PREFILL_CASES = {
    PREFILL_SLICE: dict(
        Hq=4, Hkv=4, d=64, bs=16, nb=72, segs=PREFILL_SLICE_SEGS, total=256),
    "d=32 4/4: past 0, off-grid past ending on a block, 1 token, row -1, "
    "pad tail": dict(Hq=4, Hkv=4, d=32, bs=4, nb=6, segs=PREFILL_EDGE_SEGS,
                     total=24),
    "d=64 GQA 8/2, same edges": dict(Hq=8, Hkv=2, d=64, bs=4, nb=6,
                                     segs=PREFILL_EDGE_SEGS, total=24),
    "d=128 GQA 8/2 bs=8, shared prefix block": dict(
        Hq=8, Hkv=2, d=128, bs=8, nb=5, segs=[(0, 0, 33), (1, 8, 7)],
        total=48, share=1),
    "d=64 4/4, rows sharing 2 prefix blocks": dict(
        Hq=4, Hkv=4, d=64, bs=4, nb=6, segs=[(0, 4, 6), (1, 8, 5),
                                             (2, 0, 3)], total=16, share=2),
    # across the kernel's key splits of 128 positions (5 splits here):
    # pasts on, one before and one after key 256, one token at the deepest
    # position (639), rows 0 and 1 sharing 10 blocks (160 keys), -1 tails
    "d=128 GQA 8/2 bs=16 nb=40: pasts at a split boundary, deepest token, "
    "shared prefix across a split": dict(
        Hq=8, Hkv=2, d=128, bs=16, nb=40,
        segs=[(0, 256, 9), (1, 255, 12), (2, 257, 17), (3, 639, 1)],
        total=48, share=10),
    "d=32 GQA 6/2 bs=4 nb=70: 10 tokens per tile, 3 splits": dict(
        Hq=6, Hkv=2, d=32, bs=4, nb=70,
        segs=[(0, 120, 13), (1, 0, 30), (2, 250, 20)], total=64),
    PREFILL_FULL_CHUNK: dict(
        Hq=4, Hkv=4, d=64, bs=16, nb=72, segs=[(0, 768, 256)], total=256),
    # head dims outside (32, 64, 128), zero-padded by the wrapper
    "d=16 (padded to 32) 4/4, same edges": dict(
        Hq=4, Hkv=4, d=16, bs=4, nb=6, segs=PREFILL_EDGE_SEGS, total=24),
    "d=24 (padded to 32) GQA 8/2, same edges": dict(
        Hq=8, Hkv=2, d=24, bs=4, nb=6, segs=PREFILL_EDGE_SEGS, total=24),
    "d=48 (padded to 64) 4/4 bs=16 nb=40, pasts across splits": dict(
        Hq=4, Hkv=4, d=48, bs=16, nb=40, segs=[(0, 0, 64), (1, 256, 64)],
        total=128),
    "d=96 (padded to 128) GQA 8/2 bs=8, shared prefix block": dict(
        Hq=8, Hkv=2, d=96, bs=8, nb=5, segs=[(0, 0, 33), (1, 8, 7)],
        total=48, share=1),
}


def prefill_inputs(torch, dev, gen, Hq, Hkv, d, bs, nb, segs, total,
                   share=0):
    """A packed chunk over pools of B * nb blocks under a random
    permutation; each row's table is -1 past the blocks its tokens fill."""
    B = max(r for r, _, _ in segs) + 1
    P = B * nb
    kp = torch.randn(P, bs, Hkv, d, device=dev, generator=gen)
    vp = torch.randn(P, bs, Hkv, d, device=dev, generator=gen)
    table = torch.randperm(P, device=dev, generator=gen).view(B, nb).clone()
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
    q = torch.randn(total, Hq, d, device=dev, generator=gen)
    return q, kp, vp, table, cu, rows, past


def counted_once(counter, fn, what):
    """``fn()``, which must add exactly one to ``counter``."""
    before = counter.count
    out = fn()
    if counter.count != before + 1:
        raise AssertionError(f"{what}: {counter.count - before} counts for "
                             "one wrapper call")
    return out


def check_prefill_kernel(torch, dev, gen, errs):
    from repro_torch.serve.paged_attention import (
        LAUNCHES_PREFILL, packed_token_layout, paged_prefill_attention_cuda,
        paged_prefill_attention_ref)
    for case, kw in PREFILL_CASES.items():
        q, kp, vp, table, cu, rows, past = prefill_inputs(torch, dev, gen,
                                                          **kw)
        _, _, row_of_tok, pos = packed_token_layout(cu, rows, past,
                                                    q.shape[0])
        scale = kw["d"] ** -0.5

        def kernel(dt):
            args = (q.to(dt), kp.to(dt), vp.to(dt), table, cu, rows, past,
                    scale)
            out = counted_once(LAUNCHES_PREFILL,
                               lambda: paged_prefill_attention_cuda(*args),
                               f"paged_prefill_attention ({case})")
            dead = row_of_tok < 0
            if dead.any() and (out[dead] != 0).any():
                raise AssertionError(f"paged_prefill_attention ({case}): "
                                     "padding/inactive tokens not zero")
            if not torch.equal(out, paged_prefill_attention_cuda(*args)):
                raise AssertionError(f"paged_prefill_attention ({case}): "
                                     "two launches differ")
            return out

        check_case(
            torch, kernel,
            lambda dt: paged_prefill_attention_ref(
                *(t.to(dt).float() for t in (q, kp, vp)), table, row_of_tok,
                pos, scale),
            "paged_prefill_attention", case, errs)


# Paged decode (#11): rows of ``lengths`` over nb blocks of bs; each
# (row, KV head) is a cluster of 8 blocks that split the row's pages.
DECODE_SLICE = "slice B=8 Hq=Hkv=4 d=64 bs=16 nb=72"
DECODE_SLICE_LENGTHS = [1088, 1087, 1025, 1100, 1152, 1040, 1151, 1096]
# [4] times the decode and prefill slices at this head dim (padded to 64)
PAD_CASE = "d 48, padded to 64"
# the Scheduler's rows at one decode step (scattered tables)
DECODE_MIX = "Scheduler mix, 8 rows of 128-1152"
DECODE_MIX_LENGTHS = [130, 1152, 517, 260, 1024, 700, 128, 900]
DECODE_CASES = {
    DECODE_SLICE: dict(B=8, Hq=4, Hkv=4, d=64, bs=16, nb=72,
                       lengths=DECODE_SLICE_LENGTHS),
    "Scheduler mix with a row of length 0 (zeros)": dict(
        B=8, Hq=4, Hkv=4, d=64, bs=16, nb=72,
        lengths=[0] + DECODE_MIX_LENGTHS[1:], neg_tail=True),
    # 1023-1025 positions: 64 or 65 pages over 8 blocks; 127-129: 8 or 9
    "span boundaries +-1, GQA 8/2": dict(
        B=6, Hq=8, Hkv=2, d=64, bs=16, nb=72,
        lengths=[1023, 1024, 1025, 127, 128, 129], neg_tail=True),
    "GQA 8/2, lengths 1 and nb*bs, -1 tail": dict(
        B=3, Hq=8, Hkv=2, d=64, bs=16, nb=5, lengths=[1, 80, 37],
        neg_tail=True),
    "GQA 16/2 d=128 bs=8": dict(B=2, Hq=16, Hkv=2, d=128, bs=8, nb=9,
                                lengths=[70, 3], neg_tail=True),
    "d=32": dict(B=2, Hq=2, Hkv=1, d=32, bs=4, nb=20, lengths=[77, 40]),
    # R 8: a block's span (2208 positions) takes two score windows
    "R 8, 17593 positions: two score windows": dict(
        B=1, Hq=8, Hkv=1, d=32, bs=16, nb=1100, lengths=[17593],
        neg_tail=True),
    # more blocks than the kernel stages: table entries from device memory
    "4200 blocks of 2: table from device memory": dict(
        B=2, Hq=2, Hkv=1, d=32, bs=2, nb=4200, lengths=[8399, 5],
        neg_tail=True),
    # head dims outside (32, 64, 128): the wrapper zero-pads q and the
    # pools to the next of them and slices the output back
    "d=16 (padded to 32), GQA 8/2": dict(
        B=3, Hq=8, Hkv=2, d=16, bs=16, nb=9, lengths=[1, 144, 37],
        neg_tail=True),
    "d=24 (padded to 32), 4/4 bs=8": dict(
        B=3, Hq=4, Hkv=4, d=24, bs=8, nb=20, lengths=[160, 77, 9]),
    "d=48 (padded to 64), GQA 8/2": dict(
        B=3, Hq=8, Hkv=2, d=48, bs=16, nb=72, lengths=[1152, 1025, 130],
        neg_tail=True),
    "d=96 (padded to 128), GQA 16/2 bs=8": dict(
        B=2, Hq=16, Hkv=2, d=96, bs=8, nb=9, lengths=[70, 3],
        neg_tail=True),
}


def check_decode_kernel(torch, dev, gen, errs):
    """#11 on every ``DECODE_CASES`` entry: rows of length 0 exact zeros
    (the plain version, like JAX's gather reference, gives the mean of V
    there; the TPU kernel gives zeros, ROADMAP C), two launches bitwise
    equal, the other rows against the plain version."""
    from repro_torch.serve.paged_attention import (LAUNCHES,
                                                   paged_attention_cuda,
                                                   paged_attention_ref)
    for case, kw in DECODE_CASES.items():
        q, kp, vp, table, lengths = paged_inputs(torch, dev=dev, gen=gen,
                                                 **kw)
        scale = kw["d"] ** -0.5
        empty = lengths == 0

        def kernel(dt):
            args = (q.to(dt), kp.to(dt), vp.to(dt), table, lengths, scale)
            out = counted_once(LAUNCHES, lambda: paged_attention_cuda(*args),
                               f"paged_attention_decode ({case})")
            if (out[empty] != 0).any():
                raise AssertionError(f"paged_attention_decode ({case}): a "
                                     "row of length 0 is not zero")
            if not torch.equal(out, paged_attention_cuda(*args)):
                raise AssertionError(f"paged_attention_decode ({case}): "
                                     "two launches differ")
            return out

        def plain(dt):
            out = paged_attention_ref(*(t.to(dt).float() for t in (q, kp, vp)),
                                      table, lengths, scale)
            return torch.where(empty[:, None, None], 0.0, out)

        check_case(torch, kernel, plain, "paged_attention_decode", case, errs)


def check_kernels(torch, dev):
    from repro_torch.kernels import mosa_attention as km
    from repro_torch.kernels.mosa_attention import (mosa_attention_cuda,
                                                    mosa_attention_ref)
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"mosa_attention": 0.0, "paged_attention_decode": 0.0}

    for case, kw in MOSA_CASES.items():
        q, k, v, idx, r, seg = mosa_inputs(torch, dev=dev, gen=gen, **kw)

        def on(fn):
            return lambda dt: fn(q.to(dt), k.to(dt), v.to(dt), idx, r,
                                 seg=seg)

        def plain(dt):
            return mosa_attention_ref(*(t.to(dt).float() for t in (q, k, v)),
                                      idx, r, seg=seg)

        check_case(torch, on(mosa_attention_cuda), plain, "mosa_attention",
                   case, errs)
        check_case(torch, on(km.mosa_attention_stream_cuda), plain,
                   "mosa_attention[stream]", case, errs)
        check_fwd_routes(torch, "mosa_attention", case,
                         on(mosa_attention_cuda),
                         on(km.mosa_attention_row_cuda),
                         on(km.mosa_attention_stream_cuda), kw["S"],
                         kw["d"])
    check_train_kernels(torch, dev, gen, errs)

    check_decode_kernel(torch, dev, gen, errs)
    check_prefill_kernel(torch, dev, gen, errs)
    check_block_kernels(torch, dev, gen, errs)
    check_flash_kernels(torch, dev, gen, errs)
    return errs


# ---------------------------------------------------------------- timing
def time_kernels(torch, dev):
    """Times at the slice's shapes (fp32): kernel, plain version, and one
    PyTorch call computing the same attention (``library_ms``, a yardstick
    the port never calls), plus the bound from bytes and operations."""
    import torch.nn.functional as F
    from repro_torch.kernels.mosa_attention import (
        mosa_attention_cuda, mosa_attention_ref, mosa_attention_stream_cuda)
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {}

    B, H, S, d = 8, 276, 32, 64
    q, k, v, idx, r, _ = mosa_inputs(torch, B, H, S, d, 1024, dev, gen)
    mask = (idx[..., :, None] >= idx[..., None, :]) & (idx >= 0)[..., None, :]
    pairs = int(mask.sum())
    nbytes = 4 * B * H * S * d * 4 + B * H * S * (4 + 4)
    flops = 4 * pairs * d
    out["mosa_attention"] = dict(
        ms=time_ms(torch, lambda: mosa_attention_cuda(q, k, v, idx, r),
                   flush=flush),
        stream_ms=time_ms(torch, lambda: mosa_attention_stream_cuda(
            q, k, v, idx, r), flush=flush),
        plain_ms=time_ms(torch, lambda: mosa_attention_ref(q, k, v, idx, r),
                         flush=flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), flush=flush),
        bytes=nbytes, flops=flops)
    out.update(time_train_kernels(torch, q, k, v, idx, r, mask, pairs, flush,
                                  gen)[0])
    # [24]'s mosa8 (k = 128): the streaming #2 and the split #3 and #4 at
    # the shape their main path gives them; the split rows' S 32 times
    # (a shape whose route is the fused kernel) stay as "[S 32]"
    q, k, v, idx, r, _ = mosa_inputs(torch, *SWEEP_MOSA8, 1024, dev, gen)
    mask = (idx[..., :, None] >= idx[..., None, :]) & (idx >= 0)[..., None, :]
    mosa8, split_calls = time_train_kernels(torch, q, k, v, idx, r, mask,
                                            int(mask.sum()), flush, gen)
    for name in ("mosa_attention_bwd_dq", "mosa_attention_bwd_dkv"):
        out[f"{name}[S 32]"] = out[name]
        out[name] = mosa8[name]
    out[f"mosa_attention_fwd_res[{SWEEP_MOSA8_NAME}]"] = mosa8[
        "mosa_attention_fwd_res"]

    decode_calls = {}
    for name, lens in (("paged_attention_decode", DECODE_SLICE_LENGTHS),
                       (f"paged_attention_decode[{DECODE_MIX}]",
                        DECODE_MIX_LENGTHS)):
        out[name], decode_calls[name] = time_decode_kernel(
            torch, dev, gen, flush, lens)
    prefill_calls = {}
    for name, case in (("paged_prefill_attention", PREFILL_SLICE),
                       (f"paged_prefill_attention[{PREFILL_FULL_CHUNK}]",
                        PREFILL_FULL_CHUNK)):
        out[name], prefill_calls[name] = time_prefill_kernel(
            torch, dev, gen, flush, case)
    # the pad route (ROADMAP C item 1): the slices at d 48, which the
    # wrappers zero-pad to 64 (q and both pools copied on every call)
    out[f"paged_attention_decode[{PAD_CASE}]"], _ = time_decode_kernel(
        torch, dev, gen, flush, DECODE_SLICE_LENGTHS, d=48)
    out[f"paged_prefill_attention[{PAD_CASE}]"], _ = time_prefill_kernel(
        torch, dev, gen, flush, PREFILL_SLICE, d=48)
    out.update(time_block_kernels(torch, dev, gen, flush))
    out.update(time_flash_kernels(torch, dev, gen, flush))

    for name, t in out.items():
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = t["flops"] / FP32_FLOP_PER_S * 1e3
        t["bound_ms"] = max(t_bytes, t_ops)
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        stream = (f"  streaming route {t['stream_ms']:.4f} ms"
                  if "stream_ms" in t else "")
        log(f"  {name:24s} kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f}"
            f" ms  library {t['library_ms']:.4f} ms  bound {t['bound_ms']:.4f}"
            f" ms ({t['bound_by']}: {t['bytes'] / 1e6:.2f} MB, "
            f"{t['flops'] / 1e9:.3f} GFLOP){stream}")
    # Device times after every event timing (a profiler session slows the
    # event timings that follow it): #11, whose ~0.01 ms an event pair
    # around the Python wrapper may overstate, and #12's two launches apart.
    for name, call in decode_calls.items():
        out[name]["device_ms"] = device_ms_by_kernel(
            torch, call, flush, ("paged_decode_kernel",))["paged_decode_kernel"]
        log(f"  {name}: kernel {out[name]['device_ms']:.4f} ms (device time, "
            "torch.profiler)")
    # the split #3 and #4 at mosa8, each kernel's own device time
    for name, kernel in (("mosa_attention_bwd_dq", "mosa_bwd_dq_kernel"),
                         ("mosa_attention_bwd_dkv", "mosa_bwd_dkv_kernel")):
        out[name]["device_ms"] = device_ms_by_kernel(
            torch, split_calls[name], flush, (kernel,))[kernel]
        log(f"  {name} at {SWEEP_MOSA8_NAME}: kernel "
            f"{out[name]['device_ms']:.4f} ms (device time, torch.profiler)")
    for name, call in prefill_calls.items():
        parts = device_ms_by_kernel(torch, call, flush,
                                    ("split_kernel", "merge_kernel"))
        out[name].update(split_kernel_ms=parts["split_kernel"],
                         merge_kernel_ms=parts["merge_kernel"])
        log(f"  {name}: split kernel {parts['split_kernel']:.4f} ms, merge "
            f"kernel {parts['merge_kernel']:.4f} ms (device time, "
            "torch.profiler)")
    return out


def time_decode_kernel(torch, dev, gen, flush, lens, d=64):
    """#11 (fp32) over rows of ``lens`` positions: Hq = Hkv = 4, d 64 (or
    ``d``: outside 32, 64, 128 the wrapper's pad route), 72 blocks of 16
    under scattered tables.  Bytes: each valid position's K and
    V read once, q and the output, the table and lengths; operations: 4*d
    per (query head, valid position).  The yardstick is one SDPA call over
    the rows' KV gathered (outside the timing) to (B, Hkv, nb * bs, d) with
    a boolean length mask.  Returns the timings and the kernel's call
    (``time_kernels`` takes its device time once every event timing is
    done)."""
    import torch.nn.functional as F
    from repro_torch.serve.paged_attention import (paged_attention_cuda,
                                                   paged_attention_ref)
    B, Hq, Hkv, bs, nb = len(lens), 4, 4, 16, 72
    q, kp, vp, table, lengths = paged_inputs(torch, B, Hq, Hkv, d, bs, nb,
                                             lens, dev, gen)
    scale = d ** -0.5
    kk = kp[table.long()].reshape(B, nb * bs, Hkv, d).transpose(1, 2)
    vv = vp[table.long()].reshape(B, nb * bs, Hkv, d).transpose(1, 2)
    kk, vv = kk.contiguous(), vv.contiguous()
    kmask = (torch.arange(nb * bs, device=dev)[None] < lengths[:, None].long())
    kmask = kmask[:, None, None, :]
    nbytes = (sum(lens) * Hkv * d * 2 * 4 + 2 * B * Hq * d * 4 + B * nb * 4
              + B * 4)

    def call():
        return paged_attention_cuda(q, kp, vp, table, lengths, scale)

    return dict(
        ms=time_ms(torch, call, flush=flush),
        plain_ms=time_ms(torch, lambda: paged_attention_ref(
            q, kp, vp, table, lengths, scale), flush=flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kk, vv, attn_mask=kmask, scale=scale),
            flush=flush),
        bytes=nbytes, flops=4 * sum(lens) * Hq * d), call


def time_prefill_kernel(torch, dev, gen, flush, case, d=None):
    """#12 on the chunk ``PREFILL_CASES[case]`` (fp32): the slice's 256
    packed tokens in 4 segments of 64 with pasts 0, 256, 512, 960, or one
    segment of 256 at past 768; bs 16; ``d`` overrides the case's head
    dim (outside 32, 64, 128: the wrapper's pad route).  Bytes: q and the output, and each
    active segment's visible K/V read once; operations: 4*d per valid
    (query, key) pair and query head, counted from this run's segments.
    The yardstick is one SDPA call over the per-segment KV gathered (outside
    the timing) into a padded batch, with a boolean causal mask.  Returns
    the timings and the kernel's call (``time_kernels`` times its two
    launches apart with ``torch.profiler`` once every event timing is
    done)."""
    import torch.nn.functional as F
    from repro_torch.serve.paged_attention import (
        packed_token_layout, paged_prefill_attention_cuda,
        paged_prefill_attention_ref)
    kw = dict(PREFILL_CASES[case], **({} if d is None else {"d": d}))
    q, kp, vp, table, cu, rows, past = prefill_inputs(torch, dev, gen, **kw)
    Hq, Hkv, d, bs = kw["Hq"], kw["Hkv"], kw["d"], kw["bs"]
    scale = d ** -0.5
    _, _, row_of_tok, pos = packed_token_layout(cu, rows, past, q.shape[0])
    segs = [(r, p, L) for r, p, L in kw["segs"] if r >= 0]
    visible = sum(p + L for _, p, L in segs)
    pairs = sum(L * p + L * (L + 1) // 2 for _, p, L in segs)
    n_tok = sum(L for _, _, L in segs)
    nbytes = (2 * n_tok * Hq * d * 4 + visible * Hkv * d * 2 * 4
              + table.numel() * 4 + 3 * len(segs) * 4 + 4)
    # SDPA yardstick: (N, Hq, Lmax, d) queries, (N, Hkv->Hq, Smax, d) keys
    N, Lmax = len(segs), max(L for _, _, L in segs)
    Smax = max(p + L for _, p, L in segs)
    qs = torch.zeros(N, Hq, Lmax, d, device=dev)
    ks = torch.zeros(N, Hq, Smax, d, device=dev)
    vs = torch.zeros(N, Hq, Smax, d, device=dev)
    mask = torch.zeros(N, 1, Lmax, Smax, dtype=torch.bool, device=dev)
    off = 0
    for i, (r, p, L) in enumerate(segs):
        qs[i, :, :L] = q[off:off + L].transpose(0, 1)
        bt = table[r].long().clamp(min=0)
        kk = kp[bt].reshape(-1, Hkv, d)[:p + L].transpose(0, 1)
        vv = vp[bt].reshape(-1, Hkv, d)[:p + L].transpose(0, 1)
        ks[i, :, :p + L] = kk.repeat_interleave(Hq // Hkv, 0)
        vs[i, :, :p + L] = vv.repeat_interleave(Hq // Hkv, 0)
        qpos = p + torch.arange(L, device=dev)
        mask[i, 0, :L, :p + L] = (torch.arange(p + L, device=dev)[None]
                                  <= qpos[:, None])
        off += L
    mask[:, :, :, 0] |= True          # padded query rows: keep one key

    def call():
        return paged_prefill_attention_cuda(q, kp, vp, table, cu, rows,
                                            past, scale)

    return dict(
        ms=time_ms(torch, call, flush=flush),
        plain_ms=time_ms(torch, lambda: paged_prefill_attention_ref(
            q, kp, vp, table, row_of_tok, pos, scale), flush=flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=scale), flush=flush),
        bytes=nbytes, flops=4 * pairs * Hq * d), call


def time_block_kernels(torch, dev, gen, flush):
    """#5-#8 at the block slice's shapes (fp32): 8 x 276 rows of NB = 2
    blocks of 16 (S 32), d 64, T 1024.  Bytes: q, k, v (and g~ in the
    backward) read once, the block table and scores (NB per row, not S),
    lse and delta, each output written once; operations: 2*d per product of
    two d-vectors over the valid (query, key) pairs of this run's blocks.
    The yardstick is SDPA with the equivalent boolean mask over the
    expanded positions (forward for #5 and #6, its backward for the fused
    #7 + #8 and for each of the split #7 and #8, which computes dq, dk and
    dv in one call).  Also timed and logged: the block Function's backward
    prologue (the block mask, g~, dr per block, delta) on its own."""
    import torch.nn.functional as F
    from repro_torch.kernels import mosa_block as kb
    kw = BLOCK_CASES["slice (8,276) NB=2 bs=16 d=64"]
    q, k, v, bidx, rblk, _ = block_inputs(torch, dev=dev, gen=gen, **kw)
    B, H, S, d = q.shape
    NB, bs, T = kw["NB"], kw["bs"], kw["T"]
    pos, ok = kb.expand_blocks(bidx, bs, T)
    mask = ((pos[..., :, None] >= pos[..., None, :]) & ok[..., None, :])
    pairs = int(mask.sum())
    vec, row, blk = B * H * S * d * 4, B * H * S * 4, B * H * NB * 4
    o_pre, lse = kb.mosa_block_attention_fwd_res_cuda(q, k, v, bidx, bs, T)
    g = torch.randn(q.shape, device=dev, generator=gen)
    gt = torch.where(ok[..., None], g, 0.0).contiguous()
    delta = (gt * o_pre).sum(-1).contiguous()
    bwd_args = (q, k, v, bidx, gt, lse, delta, bs, T)
    plain_bwd_ms = time_ms(torch, lambda: kb.mosa_block_attention_bwd_ref(
        *bwd_args), flush=flush)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    sdpa = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    sdpa_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        sdpa, leaves, g, retain_graph=True), flush=flush)
    sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), flush=flush)

    def prologue():   # MoSABlockAttentionFunction.backward before the kernel
        _, ok = kb.expand_blocks(bidx, bs, T)
        gt = torch.where(ok[..., None], kb.scale_rows(g, rblk, bs),
                         0.0).contiguous()
        dr = (g * o_pre).sum(-1).unflatten(-1, (-1, bs)).sum(-1)
        return gt, dr, (gt * o_pre).sum(-1).contiguous()

    prologue_ms = time_ms(torch, prologue, flush=flush)
    log(f"  the block Function's backward prologue (mask, g~, dr, delta): "
        f"{prologue_ms:.4f} ms")
    return {
        "mosa_block_attention_bwd": dict(
            ms=time_ms(torch, lambda: kb.mosa_block_attention_bwd_fused_cuda(
                *bwd_args), flush=flush),
            plain_ms=plain_bwd_ms, library_ms=sdpa_bwd_ms,
            bytes=7 * vec + 2 * row + blk, flops=10 * pairs * d,
            prologue_ms=prologue_ms),
        "mosa_block_attention": dict(
            ms=time_ms(torch, lambda: kb.mosa_block_attention_cuda(
                q, k, v, bidx, rblk, bs, T), flush=flush),
            stream_ms=time_ms(
                torch, lambda: kb.mosa_block_attention_stream_cuda(
                    q, k, v, bidx, rblk, bs, T), flush=flush),
            plain_ms=time_ms(torch, lambda: kb.mosa_block_attention_ref(
                q, k, v, bidx, rblk, bs, T), flush=flush),
            library_ms=sdpa_ms, bytes=4 * vec + 2 * blk,
            flops=4 * pairs * d),
        "mosa_block_attention_fwd_res": dict(
            ms=time_ms(torch, lambda: kb.mosa_block_attention_fwd_res_cuda(
                q, k, v, bidx, bs, T), flush=flush),
            stream_ms=time_ms(
                torch, lambda: kb.mosa_block_attention_fwd_res_stream_cuda(
                    q, k, v, bidx, bs, T), flush=flush),
            plain_ms=time_ms(torch, lambda: kb.mosa_block_attention_fwd_res_ref(
                q, k, v, bidx, bs, T), flush=flush),
            library_ms=sdpa_ms, bytes=4 * vec + row + blk,
            flops=4 * pairs * d),
        "mosa_block_attention_bwd_dq": dict(
            ms=time_ms(torch, lambda: kb.mosa_block_attention_bwd_dq_cuda(
                *bwd_args), flush=flush),
            plain_ms=plain_bwd_ms, library_ms=sdpa_bwd_ms,
            bytes=5 * vec + 2 * row + blk, flops=6 * pairs * d),
        "mosa_block_attention_bwd_dkv": dict(
            ms=time_ms(torch, lambda: kb.mosa_block_attention_bwd_dkv_cuda(
                *bwd_args), flush=flush),
            plain_ms=plain_bwd_ms, library_ms=sdpa_bwd_ms,
            bytes=6 * vec + 2 * row + blk, flops=8 * pairs * d),
    }


def time_train_kernels(torch, q, k, v, idx, r, mask, pairs, flush, gen):
    """The training kernels at the shapes of ``q`` (fp32; the fused
    backward only where it fits).  Bytes: each
    input read once, each output written once; operations: 2*d per product
    of two d-vectors over the valid (query, key) pairs of this run's
    indices.  The plain versions compute dq, dk and dv in one call, and the
    yardstick of the backward is one call of SDPA's backward, which
    computes all three too: both numbers stand in the fused kernel's row
    and in each of the split #3 and #4 rows (compare those with the sum of
    the two).  Also timed and logged: the Function's backward prologue
    (g~, dr, delta; ``kernels/mosa_vjp.py``) on its own.  Returns the
    times and the split #3's and #4's calls (for their device times, taken
    after every event timing)."""
    import torch.nn.functional as F
    from repro_torch.kernels.mosa_attention import (
        mosa_attention_fwd_res_cuda, mosa_attention_fwd_res_ref,
        mosa_attention_fwd_res_stream_cuda)
    from repro_torch.kernels.mosa_backward import (
        fused_bwd_fits, mosa_attention_bwd_dkv_cuda,
        mosa_attention_bwd_dq_cuda, mosa_attention_bwd_fused_cuda,
        mosa_attention_bwd_ref)
    B, H, S, d = q.shape
    vec, row = B * H * S * d * 4, B * H * S * 4      # fp32 (.., d) / (..)
    o_pre, lse = mosa_attention_fwd_res_cuda(q, k, v, idx)
    g = torch.randn(q.shape, device=q.device, generator=gen)
    gt = (g * r[..., None]).contiguous()
    delta = (gt * o_pre).sum(-1).contiguous()
    bwd_args = (q, k, v, idx, gt, lse, delta)
    plain_bwd_ms = time_ms(torch, lambda: mosa_attention_bwd_ref(*bwd_args),
                           flush=flush)
    # SDPA's backward alone: the graph is kept and only the backward timed
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    sdpa = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    sdpa_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        sdpa, leaves, g, retain_graph=True), flush=flush)

    def prologue():       # MoSAAttentionFunction.backward before the kernel
        gt = (g * r[..., None]).contiguous()
        dr = (g * o_pre).sum(-1)
        return gt, dr, (gt * o_pre).sum(-1).contiguous()

    prologue_ms = time_ms(torch, prologue, flush=flush)
    log(f"  the Function's backward prologue (g~, dr, delta) at "
        f"({B},{H},{S},{d}): {prologue_ms:.4f} ms")

    def dq_call():
        return mosa_attention_bwd_dq_cuda(*bwd_args)

    def dkv_call():
        return mosa_attention_bwd_dkv_cuda(*bwd_args)

    out = {} if not fused_bwd_fits(S, d) else {
        "mosa_attention_bwd": dict(
            ms=time_ms(torch, lambda: mosa_attention_bwd_fused_cuda(
                *bwd_args), flush=flush),
            plain_ms=plain_bwd_ms, library_ms=sdpa_bwd_ms,
            bytes=7 * vec + 3 * row, flops=10 * pairs * d,
            prologue_ms=prologue_ms)}
    return {
        **out,
        "mosa_attention_fwd_res": dict(
            ms=time_ms(torch, lambda: mosa_attention_fwd_res_cuda(
                q, k, v, idx), flush=flush),
            stream_ms=time_ms(
                torch, lambda: mosa_attention_fwd_res_stream_cuda(
                    q, k, v, idx), flush=flush),
            plain_ms=time_ms(torch, lambda: mosa_attention_fwd_res_ref(
                q, k, v, idx), flush=flush),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), flush=flush),
            bytes=3 * vec + row + vec + row, flops=4 * pairs * d),
        "mosa_attention_bwd_dq": dict(
            ms=time_ms(torch, dq_call, flush=flush),
            plain_ms=plain_bwd_ms, library_ms=sdpa_bwd_ms,
            bytes=4 * vec + 3 * row + vec, flops=6 * pairs * d),
        "mosa_attention_bwd_dkv": dict(
            ms=time_ms(torch, dkv_call, flush=flush),
            plain_ms=plain_bwd_ms, library_ms=sdpa_bwd_ms,
            bytes=4 * vec + 3 * row + 2 * vec, flops=8 * pairs * d,
            prologue_ms=prologue_ms),
    }, {"mosa_attention_bwd_dq": dq_call, "mosa_attention_bwd_dkv": dkv_call}


def kernel_counters():
    """Every kernel's launch counter, by kernel name."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import mosa_attention as kmosa
    from repro_torch.kernels import mosa_backward as kbwd
    from repro_torch.kernels import mosa_block as kblock
    from repro_torch.serve import paged_attention as kpaged
    return {c.name: c for c in (kmosa.LAUNCHES, kmosa.LAUNCHES_FWD_RES,
                                kbwd.LAUNCHES, kbwd.LAUNCHES_DQ,
                                kbwd.LAUNCHES_DKV,
                                kblock.LAUNCHES, kblock.LAUNCHES_FWD_RES,
                                kblock.LAUNCHES_BWD, kblock.LAUNCHES_DQ,
                                kblock.LAUNCHES_DKV,
                                kflash.LAUNCHES, kflash.LAUNCHES_VARLEN,
                                kpaged.LAUNCHES, kpaged.LAUNCHES_PREFILL)}


def want_launches(**counts):
    """Expected launch counts: ``counts`` by kernel name, 0 for every other
    kernel."""
    return {name: counts.get(name, 0) for name in kernel_counters()}


# -------------------------------------------------------------- main path
def slice_config(**mosa):
    """``mosa-paper-tiny-mosa32`` on the kernel path; ``mosa`` overrides
    fields of its MoSA config (block choice: ``selection_granularity`` and
    ``sel_block_size``)."""
    from repro_torch.configs.base import get_config
    cfg = get_config("mosa-paper", preset="full", size="tiny", variant="mosa")
    return dataclasses.replace(cfg, mosa=dataclasses.replace(
        cfg.mosa, impl="kernel", **mosa))


BLOCK_MOSA = dict(selection_granularity="block", sel_block_size=16)


def serve_slice(torch, cfg=None):
    """Paged serving at full width through ``Server.generate``: batch 8,
    prompt 1024, 128 greedy tokens.  Expected launches over the counted
    generate: one MoSA prefill kernel per layer (#1, or #5 with block
    choice) and the paged decode kernel per layer and decode step."""
    from repro_torch.launch.serve import Server
    from repro_torch.serve.paged_kv import PagedConfig

    cfg = cfg or slice_config()
    block = cfg.mosa.selection_granularity == "block"
    B, P, G, max_len = 8, 1024, 128, 1152
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.mosa.n_dense_heads} dense + {cfg.mosa.n_mosa_heads} MoSA heads,"
        f" vocab {cfg.vocab}, {cfg.param_dtype}, "
        f"{cfg.mosa.selection_granularity} choice"
        + (f" (blocks of {cfg.mosa.sel_block_size})" if block else ""))
    server = Server(cfg, batch=B, max_len=max_len,
                    paged=PagedConfig(block_size=16), seed=0)
    n_params = sum(p.numel() for p in server.model.parameters())
    prompts = torch.randint(2, cfg.vocab, (B, P),
                            generator=torch.Generator().manual_seed(1))

    def timed_generate(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, caches = server.generate(prompts, n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, toks, caches

    timed_generate(2)                                   # warm-up
    prefill_s = min(timed_generate(1)[0] for _ in range(3))

    # The decode steps of the counted generate are timed on their own:
    # decode_many is wrapped for that one call.
    decode_many = server.model.decode_many
    span = {}

    def timed_decode_many(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode_many(*args)
        torch.cuda.synchronize()
        span["decode_s"] = time.perf_counter() - t0
        return out

    server.model.decode_many = timed_decode_many
    counters = kernel_counters()
    for c in counters.values():
        c.count = 0
    torch.cuda.reset_peak_memory_stats()
    gen_s, toks, caches = timed_generate(G)
    launches = {name: c.count for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    del server.model.decode_many

    want = want_launches(**{
        "mosa_block_attention" if block else "mosa_attention": cfg.n_layers,
        "paged_attention_decode": cfg.n_layers * (G - 1)})
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if toks.shape != (B, G) or not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"bad tokens {toks.shape}")
    for c in caches:
        sc = c["sparse"]
        if not torch.isfinite(sc.k).all() or not torch.isfinite(c["dense"].k).all():
            raise AssertionError("non-finite cache contents")
        if block and not ((sc.bidx[..., :-1] >= 0).sum(-1) > 0).all():
            raise AssertionError("a MoSA head holds no candidate block")
        if int(c["dense"].length.min()) != P + G - 1:
            raise AssertionError("dense cache length wrong")
    res = dict(params=n_params, prefill_ms=prefill_s * 1e3,
               generate_s=gen_s, decode_s=span["decode_s"],
               decode_tok_s=B * (G - 1) / span["decode_s"],
               peak_gib=peak / 2 ** 30, launches=launches)
    log(f"  {n_params / 1e6:.1f} M parameters; batch {B} x prompt {P} + "
        f"{G} tokens")
    log(f"  prefill {res['prefill_ms']:.2f} ms (generate of 1 token, best of 3)"
        f"; generate {gen_s:.3f} s, of which {G - 1} decode steps "
        f"{span['decode_s']:.3f} s = {res['decode_tok_s']:.1f} tok/s")
    log(f"  peak device memory {res['peak_gib']:.3f} GiB; launches over the "
        f"generate call: {launches}")
    return server, cfg, prompts, res


def profile_decode(torch, server, prompts, steps=3):
    """Wall time, device time and kernel launches of one decode step at
    the slice's shapes (after a fresh prefill), from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    model = server.model
    with torch.inference_mode():
        logits, caches = model.prefill(prompts.cuda(), server.new_cache())
        tok = logits[:, -1].argmax(-1)[:, None]
        for _ in range(2):                                   # warm-up
            logits, caches = model.decode_step(tok, caches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, caches = model.decode_step(tok, caches)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                logits, caches = model.decode_step(tok, caches)
            torch.cuda.synchronize()
    res = profile_summary(torch, prof, wall_ms, steps)
    log(f"  decode step: {wall_ms:.2f} ms wall, {res['device_ms']:.2f} ms on "
        f"the device (idle share {res['idle_share']:.2f}), "
        f"{res['launches']:.0f} kernel launches")
    log("  kernels by device time per step:")
    for ms, count, name in res.pop("top"):
        log(f"    {ms:7.3f} ms {count:5.0f}x  {name[:90]}")
    return res


def profile_summary(torch, prof, wall_ms, steps):
    """Kernel rows only (an operator's row repeats its kernels' time):
    device ms per step, idle share against ``wall_ms``, launches per step
    and the top ten kernels as (ms per step, launches per step, name)."""
    events = prof.key_averages()
    kernels = sorted((e for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    res = dict(wall_ms=wall_ms, device_ms=device_us / 1e3 / steps,
               launches=launches / steps)
    res["idle_share"] = max(0.0, 1 - res["device_ms"] / wall_ms)
    res["top"] = [(e.self_device_time_total / 1e3 / steps, e.count / steps,
                   e.key) for e in kernels[:10]]
    return res


def cross_check(torch, server, cfg, prompts, P=256, paged=True):
    """The card against the CPU: same weights, batch 1, prompt ``P``, the
    dense side on ``server``'s route, paged dense/window KV (or contiguous
    caches with ``paged=False``).  With block choice every layer's
    selected blocks must be identical too."""
    from repro_torch.launch.serve import Server
    from repro_torch.serve.paged_kv import PagedConfig
    G = 8
    state = {k: v.detach().cpu() for k, v in server.model.state_dict().items()}
    kw = dict(batch=1, max_len=P + G,
              paged=PagedConfig(block_size=16) if paged else None)
    gpu = Server(cfg, params=state, **kw)
    cpu = Server(cfg, params=state, device="cpu", **kw)
    for srv in (gpu, cpu):
        for dst, src in zip(srv.model.layers, server.model.layers):
            dst.mixer.dense_impl = src.mixer.dense_impl
    p = prompts[:1, :P]
    with torch.inference_mode():
        lg, _ = gpu.model.prefill(p.cuda(), gpu.new_cache())
        lc, _ = cpu.model.prefill(p, cpu.new_cache())
    err = (lg.cpu() - lc).abs().max().item()
    tg, cg = gpu.generate(p, G)
    tc, cc = cpu.generate(p, G)
    log(f"  prefill logits max|gpu - cpu| {err:.3e} (tol 1e-3); tokens "
        f"gpu {tg[0].tolist()} cpu {tc[0].tolist()}")
    if not err <= 1e-3:
        raise AssertionError(f"prefill logits differ by {err}")
    if not torch.equal(tg.cpu(), tc):
        raise AssertionError("greedy tokens differ between card and CPU")
    if cfg.mosa.selection_granularity == "block":
        differ = [int((a["sparse"].bidx.cpu() != b["sparse"].bidx).any(-1)
                      .sum()) for a, b in zip(cg, cc)]
        log(f"  heads whose blocks differ, per layer: {differ}")
        if any(differ):
            raise AssertionError(f"block selections differ: {differ}")
    return err


# ------------------------------------------------------------- training
TRAIN_STEPS = 4             # the first is untimed


def train_slice(torch, **mosa):
    """Full-width training through ``Trainer``: the counters are zeroed
    once the untimed first step has returned, and read after the last.
    ``mosa`` overrides the MoSA config (block choice)."""
    from repro_torch.train.loop import TrainConfig, Trainer
    cfg = TrainConfig(arch="mosa-paper", preset="full",
                      arch_kwargs={"variant": "mosa", **mosa}, seq_len=1024,
                      global_batch=64, microbatch=8, lr=2.5e-4,
                      clip_norm=0.25, steps=TRAIN_STEPS, mosa_impl="kernel",
                      remat="none", log_every=1, seed=0)
    trainer = Trainer(cfg)
    mc = trainer.model_cfg
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(f"  {mc.name}: {mc.n_layers} layers, {n_params / 1e6:.1f} M "
        f"parameters, {mc.param_dtype}/{mc.compute_dtype}, remat {mc.remat}, "
        f"impl {mc.mosa.impl}; batch {cfg.global_batch} x {cfg.seq_len} in "
        f"{cfg.microbatch} microbatches, lr {cfg.lr} (warmup {cfg.warmup}), "
        f"clip {cfg.clip_norm}")
    counters = kernel_counters()
    step_fn, calls = trainer.train_step, {"n": 0}

    def first_step_uncounted(*args):
        out = step_fn(*args)
        calls["n"] += 1
        if calls["n"] == 1:
            torch.cuda.synchronize()
            for c in counters.values():
                c.count = 0
        return out

    trainer.train_step = first_step_uncounted
    torch.cuda.reset_peak_memory_stats()
    _, _, history = trainer.run(install_signals=False)
    launches = {name: c.count for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    trainer.train_step = step_fn

    timed = TRAIN_STEPS - 1
    per_layer = mc.n_layers * cfg.microbatch * timed
    # S = k = 32 (token choice) or 2 blocks of 16: the fused backward
    names = (("mosa_block_attention_fwd_res", "mosa_block_attention_bwd")
             if mc.mosa.selection_granularity == "block"
             else ("mosa_attention_fwd_res", "mosa_attention_bwd"))
    want = want_launches(**{name: per_layer for name in names})
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    losses = [h["loss"] for h in history]
    gnorms = [h["grad_norm"] for h in history]
    if len(history) != TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"bad history: losses {losses}, grad norms "
                             f"{gnorms}")
    step_s = statistics.median(h["dt"] for h in history[1:])
    tokens = cfg.global_batch * cfg.seq_len
    res = dict(params=n_params, step_ms=step_s * 1e3,
               tokens_per_s=tokens / step_s, peak_gib=peak / 2 ** 30,
               losses=losses, grad_norms=gnorms,
               step_ms_each=[h["dt"] * 1e3 for h in history],
               launches={k: v / timed for k, v in launches.items()},
               launches_total=launches)
    log(f"  step {res['step_ms']:.1f} ms (median of {timed}; each "
        f"{[round(x, 1) for x in res['step_ms_each']]}) = "
        f"{res['tokens_per_s']:.0f} tokens/s; peak device memory "
        f"{res['peak_gib']:.3f} GiB")
    log(f"  losses {losses}; grad norms {gnorms}")
    log(f"  launches over the {timed} timed steps: {launches} "
        f"(per step: {res['launches']})")
    return trainer, res


def layer_selections(torch, model, tokens):
    """Each MoSA layer's selected indices (B, H, k) on ``tokens``: tokens,
    or blocks with block choice."""
    from repro_torch.core.router import block_pool_scores, select_topk
    out = []
    T = tokens.shape[1]
    with torch.no_grad():
        x = model.embed(tokens)
        for layer in model.layers:
            sp = layer.mixer.sparse
            scores = sp.router.scores(layer.norm1(x))
            if sp.cfg.selection_granularity == "block":
                scores, k = (block_pool_scores(scores, sp.cfg.sel_block_size),
                             sp.kb_for(T))
            else:
                k = sp.k_for(T)
            _, idx = select_topk(scores, k, sp.cfg.force_first_token)
            out.append(idx.cpu())
            x, _ = layer(x)
    return out


def train_cross_check(torch, trainer):
    """The card against the CPU for training: the same weights, batch 1 x
    256 tokens, one loss and backward.  Selections first: a near-tie of
    router scores must show as a selection difference, not hide in a
    looser tolerance."""
    return model_cross_check(torch, trainer.model, trainer.model_cfg,
                             layer_selections)


def model_cross_check(torch, gpu, mc, selections, seq_len=256):
    """``train_cross_check`` of the model ``gpu`` (config ``mc``) at batch
    1 x ``seq_len`` with ``selections(torch, model, tokens)`` (None: no
    selection to hold) for the per-layer selections; the parameters
    without a gradient must be exactly the model's ``gradient_free()``
    (the routing centroids), and are skipped."""
    from repro_torch.data.pipeline import PackedLMDataset, SyntheticCorpus
    from repro_torch.nn.transformer import TransformerLM
    cpu = TransformerLM(mc, device="cpu")
    cpu.load_state_dict({k: v.detach().cpu()
                         for k, v in gpu.state_dict().items()})
    batch = PackedLMDataset(SyntheticCorpus(vocab=mc.vocab, seed=1),
                            seq_len=seq_len, global_batch=1).batch_at(0)
    batch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    card = next(gpu.parameters()).device
    differ = []
    if selections is not None:
        sel_g = selections(torch, gpu, batch["tokens"].to(card))
        sel_c = selections(torch, cpu, batch["tokens"])
        differ = [int((a != b).any(-1).sum()) for a, b in zip(sel_g, sel_c)]
        log(f"  heads whose selection differs, per layer: {differ}")
        if any(differ):
            raise AssertionError(f"selections differ between card and CPU: "
                                 f"{differ} heads per layer")
    out = {}
    for name, model, dev in (("gpu", gpu, card), ("cpu", cpu, "cpu")):
        loss, _ = model.loss({k: v.to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
        out[name] = (loss.item(), [None if g is None else g.cpu()
                                   for g in grads])
    (lg, gg), (lc, gc) = out["gpu"], out["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    names = [k for k, _ in cpu.named_parameters()]
    if [a is None for a in gg] != [b is None for b in gc]:
        raise AssertionError("card and CPU differ in which parameters get "
                             "a gradient")
    unreached = {k for k, b in zip(names, gc) if b is None}
    if unreached != cpu.gradient_free():
        raise AssertionError(f"the loss does not reach {unreached}; the "
                             f"model's gradient-free set is "
                             f"{cpu.gradient_free()}")
    worst = max((((a - b).abs().max() / b.abs().max()).item(), k)
                for k, a, b in zip(names, gg, gc) if a is not None)
    log(f"  loss gpu {lg:.7f} cpu {lc:.7f} (rel {loss_rel:.2e}, tol 1e-5); "
        f"worst grad max|gpu - cpu| / max|cpu| {worst[0]:.2e} in {worst[1]} "
        f"(tol 1e-4)")
    if not loss_rel <= 1e-5:
        raise AssertionError(f"training loss differs by {loss_rel:.2e}")
    if not worst[0] <= 1e-4:
        raise AssertionError(f"grad of {worst[1]} differs by {worst[0]:.2e}")
    return dict(loss_rel=loss_rel, grad_rel=worst[0], heads_differ=differ)


def profile_train(torch, trainer, steps=2):
    """One training microbatch (8 x 1024: the loss, its backward) under
    ``torch.profiler``: kernel rows only, and the top device items with the
    operator that launched each."""
    from torch.profiler import ProfilerActivity, profile
    model, cfg = trainer.model, trainer.cfg
    mb = cfg.global_batch // cfg.microbatch
    batch = trainer.device_batch({k: v[:mb] for k, v in
                                trainer.dataset.batch_at(0).items()})
    params = list(model.parameters())

    def microbatch():
        loss, _ = model.loss(batch, with_health=True)
        return torch.autograd.grad(loss, params)

    microbatch()                                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        microbatch()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            microbatch()
        torch.cuda.synchronize()
    res = profile_summary(torch, prof, wall_ms, steps)
    top = res.pop("top")
    res["mosa_kernels_ms"] = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and "mosa_" in e.key) / 1e3 / steps
    # each MoSA kernel's device time per microbatch, by its short name
    # (template instances summed)
    res["mosa_kernels"] = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "mosa_" in e.key):
            m = re.search(r"\w+_kernel", e.key)
            name = m.group(0) if m else e.key
            res["mosa_kernels"][name] = (res["mosa_kernels"].get(name, 0.0)
                                         + e.self_device_time_total / 1e3
                                         / steps)
    by_op = {}
    for e in prof.events():
        for kern in getattr(e, "kernels", ()):
            key = (e.name, kern.name)
            ms, n = by_op.get(key, (0.0, 0))
            by_op[key] = (ms + kern.duration / 1e3 / steps, n + 1 / steps)
    res["top"] = [dict(op=op, kernel=kern, ms=ms, count=n) for (op, kern), (
        ms, n) in sorted(by_op.items(), key=lambda kv: -kv[1][0])[:12]]
    log(f"  microbatch {mb} x {cfg.seq_len}: {wall_ms:.2f} ms wall, "
        f"{res['device_ms']:.2f} ms on the device (idle share "
        f"{res['idle_share']:.2f}; the MoSA kernels "
        f"{res['mosa_kernels_ms']:.2f} ms), {res['launches']:.0f} kernel "
        "launches")
    log("  kernels by device time per microbatch:")
    for ms, count, name in top:
        log(f"    {ms:7.3f} ms {count:5.0f}x  {name[:90]}")
    log("  top device items by launching operator:")
    for t in res["top"]:
        log(f"    {t['ms']:7.3f} ms {t['count']:5.0f}x  {t['op'][:40]:40s} "
            f"{t['kernel'][:60]}")
    return res


# ------------------------------------------------------ Scheduler serving
SCHED_MAX_LEN, SCHED_BS, SCHED_BLOCKS = 1152, 16, 576


def sched_requests(vocab, seed=2):
    """32 requests from a seeded numpy generator: 20 prompts of 128-1024
    tokens, and 12 behind one shared 512-token prefix with 64-512 tokens of
    their own — except the first of those 12, whose own part is 1-15
    tokens.  A MoSA model can only hit the trie on a node with a snapshot,
    which a request inserts at its own last full block: that first request
    inserts exactly the shared prefix, and the other 11 can hit it.  Each
    ``max_new`` in 16-128 fits ``max_len``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, vocab, int(rng.integers(128, 1025)))
               for _ in range(20)]
    shared = rng.integers(2, vocab, 512)
    tails = [int(rng.integers(1, 16))] + [int(rng.integers(64, 513))
                                          for _ in range(11)]
    shared_prompts = [np.concatenate([shared, rng.integers(2, vocab, L)])
                      for L in tails]
    order = list(rng.permutation(32))
    # the bare-prefix request goes first among the shared ones
    first_shared = min(i for i, j in enumerate(order) if j >= 20)
    k = order.index(20)
    order[first_shared], order[k] = order[k], order[first_shared]
    allp = prompts + shared_prompts
    reqs = [(allp[j].astype(np.int32), int(rng.integers(16, 129)))
            for j in order]
    assert all(len(p) + m - 1 <= SCHED_MAX_LEN for p, m in reqs)
    return reqs


class SyncedServerCalls:
    """Wraps a Server's ``prefill_packed`` and ``decode_many`` so that each
    returns only when the card has finished (the Scheduler's spans around
    them then time device work, not the enqueue), and optionally replays
    the ``profile_at``-th call of each under ``torch.profiler``: the rows it
    touches are snapshot first and restored before the replay, so the
    replay computes the same chunk.  ``uninstall`` restores the methods."""

    def __init__(self, torch, server, profile_at=None):
        self.torch, self.server = torch, server
        self.calls = {"prefill_packed": 0, "decode_many": 0}
        self.profile_at = profile_at
        self.profiles = {}
        for name in self.calls:
            setattr(server, name, self._wrap(name, getattr(server, name)))

    def uninstall(self):
        for name in self.calls:
            delattr(self.server, name)

    def _wrap(self, name, fn):
        torch = self.torch
        from repro_torch.launch.serve import row_restore, row_snapshot

        def call(*args):
            self.calls[name] += 1
            caches = args[1]
            profile = self.calls[name] == self.profile_at
            if profile:
                snaps = [row_snapshot(caches, b)
                         for b in range(self.server.batch)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            if profile:
                from torch.profiler import ProfilerActivity, profile as prof
                with torch.inference_mode():
                    for b, sn in enumerate(snaps):
                        row_restore(caches, sn, b)
                with prof(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as pr:
                    out = fn(*args)
                    torch.cuda.synchronize()
                self.profiles[name] = (pr, wall_ms)
            return out
        return call


def report_chunk_profile(torch, name, prof, wall_ms):
    res = profile_summary(torch, prof, wall_ms, 1)
    top = res.pop("top")
    by_op = {}
    for e in prof.events():
        for kern in getattr(e, "kernels", ()):
            key = e.name
            ms, n = by_op.get(key, (0.0, 0))
            by_op[key] = (ms + kern.duration / 1e3, n + 1)
    res["top_ops"] = [dict(op=op, ms=ms, count=n) for op, (ms, n) in sorted(
        by_op.items(), key=lambda kv: -kv[1][0])[:8]]
    log(f"  {name}: {wall_ms:.2f} ms wall, {res['device_ms']:.2f} ms on the "
        f"device (idle share {res['idle_share']:.2f}), "
        f"{res['launches']:.0f} kernel launches")
    log("    top kernels:")
    for ms, count, kname in top[:6]:
        log(f"      {ms:7.3f} ms {count:5.0f}x  {kname[:80]}")
    log("    top launching operators:")
    for t in res["top_ops"]:
        log(f"      {t['ms']:7.3f} ms {t['count']:5.0f}x  {t['op'][:80]}")
    return res


def sched_slice(torch):
    """[11]: the timed full-width Scheduler run, after a warm pass."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.launch.serve import Server
    from repro_torch.serve.paged_kv import PagedConfig
    from repro_torch.serve.scheduler import Scheduler
    cfg = slice_config()
    server = Server(cfg, batch=8, max_len=SCHED_MAX_LEN,
                    paged=PagedConfig(block_size=SCHED_BS,
                                      num_blocks=SCHED_BLOCKS), seed=0)
    kw = dict(chunk=8, chunk_tokens=256, max_prefill_segs=4)
    log(f"  Server(batch 8, max_len {SCHED_MAX_LEN}, {SCHED_BLOCKS} blocks "
        f"of {SCHED_BS}); Scheduler({kw}, prefix_cache=True)")

    # warm pass on a Scheduler of its own; its 2nd prefill chunk and 2nd
    # decode chunk are replayed under the profiler
    rng = np.random.default_rng(7)
    synced = SyncedServerCalls(torch, server, profile_at=2)
    warm = Scheduler(server, prefix_cache=True, **kw)
    for L in (700, 600, 500, 400, 300):
        warm.submit(rng.integers(2, cfg.vocab, L), max_new=24)
    warm.run()
    synced.uninstall()
    profiles = {name: report_chunk_profile(torch, name, *synced.profiles[name])
                for name in ("prefill_packed", "decode_many")}
    del warm

    reqs = sched_requests(cfg.vocab)
    obs.set_enabled(True)
    obs.registry().reset()
    obs.tracer().reset()
    sched = Scheduler(server, prefix_cache=True, **kw)
    rids = [sched.submit(p, m) for p, m in reqs]
    synced = SyncedServerCalls(torch, server)
    counters = kernel_counters()
    for c in counters.values():
        c.count = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = sched.run(max_steps=100_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.count for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    synced.uninstall()

    st = dict(sched.stats)
    snap = obs.registry().snapshot()
    decode_steps = int(snap["counters"]["server.decode_steps"])
    for rid, (p, m) in zip(rids, reqs):
        toks = out[rid]
        if len(toks) != m or not ((toks >= 0) & (toks < cfg.vocab)).all():
            raise AssertionError(f"request {rid}: {len(toks)} tokens, want "
                                 f"{m}")
    pool = sched.dense_pool
    if pool.free_blocks + sched.prefix.n_nodes != pool.num_blocks:
        raise AssertionError(f"blocks leaked: {pool.free_blocks} free + "
                             f"{sched.prefix.n_nodes} trie nodes != "
                             f"{pool.num_blocks}")
    want = want_launches(
        paged_attention_decode=cfg.n_layers * decode_steps,
        paged_prefill_attention=cfg.n_layers * st["prefill_chunks"])
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if st["prefix_hits"] < 1:
        raise AssertionError(f"no prefix hit: {st}")
    spans = obs.tracer().spans()

    def span_s(name):
        d = [s.dur for s in spans if s.name == name]
        return sum(d), len(d)

    pre_s, n_pre = span_s("prefill_chunk")
    dec_s, n_dec = span_s("decode_chunk")
    counts = snap["counters"]

    ttft = obs.registry().histogram("serve.ttft_s").percentiles()
    gen_tokens = sum(m for _, m in reqs)
    res = dict(wall_s=wall, requests=len(reqs), req_s=len(reqs) / wall,
               generated_tokens=gen_tokens, gen_tok_s=gen_tokens / wall,
               prompt_tokens=int(sum(len(p) for p, _ in reqs)),
               ttft_p50_s=ttft["p50"], ttft_p90_s=ttft["p90"],
               prefill_chunk_ms=1e3 * pre_s / n_pre,
               decode_chunk_ms=1e3 * dec_s / n_dec,
               prefill_chunks_s=pre_s, decode_chunks_s=dec_s,
               other_s=wall - pre_s - dec_s, decode_chunks=n_dec,
               pauses=int(counts.get("serve.pauses", 0)),
               resumes=int(counts.get("serve.resumes", 0)),
               decode_steps=decode_steps, stats=st,
               packed_efficiency=st["prefilled_tokens"]
               / st["prefill_chunk_slots"],
               peak_gib=peak / 2 ** 30, launches=launches,
               profile=profiles)
    log(f"  {len(reqs)} requests ({res['prompt_tokens']} prompt tokens, "
        f"{gen_tokens} generated) in {wall:.2f} s: {res['req_s']:.2f} req/s, "
        f"{res['gen_tok_s']:.1f} generated tok/s")
    log(f"  TTFT p50 {ttft['p50']:.3f} s, p90 {ttft['p90']:.3f} s; mean "
        f"prefill chunk {res['prefill_chunk_ms']:.2f} ms, mean decode chunk "
        f"{res['decode_chunk_ms']:.2f} ms ({n_dec} chunks, {decode_steps} "
        f"decode steps)")
    log(f"  wall: prefill chunks {pre_s:.2f} s, decode chunks {dec_s:.2f} s, "
        f"the rest (admission, pauses/resumes, prefix inserts, sampling) "
        f"{res['other_s']:.2f} s; {res['pauses']} pauses, {res['resumes']} "
        f"resumes")
    log(f"  stats {st}; packed efficiency {res['packed_efficiency']:.3f}; "
        f"peak device memory {res['peak_gib']:.3f} GiB")
    log(f"  launches over the run: {launches}")
    return server, res


def preempt_slice(torch, server):
    """[12]: 6 prompts of 1008 tokens (63 blocks), max_new 64, on 127
    blocks: two rows fit, and the first decode growth past a block
    boundary runs the pool dry."""
    import numpy as np
    from repro_torch.launch.serve import Server
    from repro_torch.serve.paged_kv import PagedConfig
    from repro_torch.serve.scheduler import Scheduler
    tight = Server(server.model_cfg, batch=8, max_len=SCHED_MAX_LEN,
                   paged=PagedConfig(block_size=SCHED_BS, num_blocks=127),
                   params=server.model.state_dict())
    sched = Scheduler(tight, chunk=8, chunk_tokens=256, max_prefill_segs=4,
                      prefix_cache=False)
    rng = np.random.default_rng(3)
    rids = [sched.submit(rng.integers(2, tight.model_cfg.vocab, 1008), 64)
            for _ in range(6)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sched.run(max_steps=100_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = dict(sched.stats)
    if st["preemptions"] < 1:
        raise AssertionError(f"no preemption: {st}")
    if [len(out[r]) for r in rids] != [64] * 6:
        raise AssertionError(f"lengths {[len(out[r]) for r in rids]}")
    if sched.dense_pool.free_blocks != sched.dense_pool.num_blocks:
        raise AssertionError("blocks leaked after preemption")
    log(f"  6 x 1008-token prompts, 64 tokens each, on 127 blocks: "
        f"{wall:.2f} s, stats {st}; every block back")
    return dict(wall_s=wall, stats=st)


def sched_cross_check(torch, server):
    """[13] and [19]: the Scheduler on the card and on the CPU, the weights
    and config of ``server``."""
    import numpy as np
    from repro_torch.launch.serve import Server
    from repro_torch.serve.paged_kv import PagedConfig
    from repro_torch.serve.scheduler import Scheduler
    cfg = server.model_cfg
    rng = np.random.default_rng(4)
    shared = rng.integers(2, cfg.vocab, 160)
    prompts = [np.concatenate([shared, rng.integers(2, cfg.vocab, 8)]),
               rng.integers(2, cfg.vocab, 96),
               np.concatenate([shared, rng.integers(2, cfg.vocab, 150)]),
               rng.integers(2, cfg.vocab, 320)]
    max_len = 336
    paged = PagedConfig(block_size=SCHED_BS, num_blocks=2 * max_len // 16)
    state = {k: v.detach().cpu() for k, v in server.model.state_dict().items()}
    out = {}
    for name, dev in (("gpu", None), ("cpu", "cpu")):
        srv = Server(cfg, batch=2, max_len=max_len, paged=paged,
                     params=state, device=dev)
        sched = Scheduler(srv, chunk=8, chunk_tokens=128, max_prefill_segs=2)
        for p in prompts:
            sched.submit(p, 8)
        out[name] = (sched.run(), dict(sched.stats))
    (rg, sg), (rc, sc) = out["gpu"], out["cpu"]
    log(f"  stats gpu {sg}")
    log(f"  stats cpu {sc}")
    for rid in sorted(rc):
        log(f"  request {rid}: gpu {rg[rid].tolist()} cpu {rc[rid].tolist()}")
    if sg != sc:
        raise AssertionError("Scheduler stats differ between card and CPU")
    if sg["prefix_hits"] < 1:
        raise AssertionError("no prefix hit in the cross-check")
    if any(not torch.equal(rg[r], rc[r]) for r in rc):
        raise AssertionError("Scheduler tokens differ between card and CPU")
    return dict(stats=sg)


def block_sched_slice(torch, server):
    """[18]: the block-choice Scheduler at full width: a bare 512-token
    prefix (with one token of its own) and 7 prompts that continue the
    prefix by 64-256 tokens, 16 tokens each, with the prefix cache on (the
    counted run) and off.  The 7 wait for the first one's snapshot at its
    last full block (512) and hit it.  A block-choice snapshot at a block
    boundary holds completed blocks only, a function of the prefix; but
    every layer of this model is MoSA, and a chunk's outputs feed the next
    layer's selection, so tokens reproduce only for the same chunk
    boundaries.  One segment per 256-token chunk makes them the same in
    both runs (multiples of 256 from each row's start: 0, or the hit at
    512), so the tokens must be identical with and without the cache."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.serve.scheduler import Scheduler
    cfg = server.model_cfg
    rng = np.random.default_rng(8)
    shared = rng.integers(2, cfg.vocab, 512)
    tails = [1] + [int(rng.integers(64, 257)) for _ in range(7)]
    prompts = [np.concatenate([shared, rng.integers(2, cfg.vocab, L)])
               for L in tails]
    kw = dict(chunk=8, chunk_tokens=256, max_prefill_segs=1)
    out = {}
    for cached in (True, False):
        obs.set_enabled(True)
        obs.registry().reset()
        sched = Scheduler(server, prefix_cache=cached, **kw)
        rids = [sched.submit(p.astype(np.int32), 16) for p in prompts]
        counters = kernel_counters()
        for c in counters.values():
            c.count = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = sched.run(max_steps=100_000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: c.count for name, c in counters.items()}
        steps = int(obs.registry().snapshot()["counters"]
                    ["server.decode_steps"])
        st = dict(sched.stats)
        want = want_launches(
            paged_attention_decode=cfg.n_layers * steps,
            paged_prefill_attention=cfg.n_layers * st["prefill_chunks"])
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
        if any(len(res[r]) != 16 for r in rids):
            raise AssertionError("a request did not get its 16 tokens")
        out[cached] = dict(tokens=[res[r] for r in rids], stats=st,
                           wall_s=wall, decode_steps=steps,
                           launches=launches,
                           peak_gib=torch.cuda.max_memory_allocated()
                           / 2 ** 30)
        log(f"  prefix cache {'on ' if cached else 'off'}: {wall:.2f} s, "
            f"stats {st}, {steps} decode steps, launches {launches}")
    on, off = out[True], out[False]
    if on["stats"]["prefix_hits"] < 1:
        raise AssertionError(f"no prefix hit: {on['stats']}")
    if any(not torch.equal(a, b) for a, b in zip(on["tokens"],
                                                 off["tokens"])):
        raise AssertionError("tokens differ with and without the prefix "
                             "cache")
    log(f"  identical tokens with and without the prefix cache; "
        f"{on['stats']['prefix_hits']} hits of "
        f"{on['stats']['prefix_hit_tokens']} tokens")
    for r in out.values():
        del r["tokens"]
    return {"prefix_cache_on": on, "prefix_cache_off": off}


# ------------------------------------------------ the flash kernels (#9, #10)
# #9 cases: (B, Hq, Hkv, Tq, Tk, d, window); the slice's first: the window
# model's dense heads (4, d 64, W 256) over the batch of 1024-token prompts.
FLASH_CHECK_CASES = {
    "slice window (8,4,1024,64) W=256": (8, 4, 4, 1024, 1024, 64, 256),
    "dense baseline (8,9,1024,64) causal": (8, 9, 9, 1024, 1024, 64, 0),
    "GQA 8/2, T=300 (ragged tiles)": (2, 8, 2, 300, 300, 64, 0),
    "Tq 1 < Tk 300 (q_offset), W=64, GQA 4/2": (1, 4, 2, 1, 300, 64, 64),
    "Tq 77 < Tk 200, d=36, W=0": (2, 4, 2, 77, 200, 36, 0),
    "d=128, W=128, T=256": (2, 2, 2, 256, 256, 128, 128),
    # Tq not a multiple of the 64-row tile, the window edge inside key tiles
    "Tq 200, W=100, GQA 4/2": (2, 4, 2, 200, 200, 64, 100),
    "Tq 150 < Tk 290, W=70": (1, 2, 2, 150, 290, 64, 70),
}
# #10 cases: (segment lengths, total, Hq, Hkv, d, window); total past the
# last segment is a padding tail (must come back as zeros)
VARLEN_CHECK_CASES = {
    "slice 8 prompts 128-1024, 4 heads d=64, W=256": ("slice", 256),
    "segments of length 1, pad tail, GQA 4/2, d=16": (
        [1, 1, 13, 1, 5, 1], 30, 4, 2, 16, 0),
    "W=8, GQA 8/2, d=64, pad tail": ([40, 1, 70, 9], 128, 8, 2, 64, 8),
    "W=0, one segment, d=128": ([200], 200, 2, 2, 128, 0),
}


def varlen_slice_lengths():
    """Eight seeded prompt lengths in [128, 1024] (the packed #10 stream)."""
    import numpy as np
    return [int(x) for x in np.random.default_rng(3).integers(128, 1025, 8)]


def varlen_inputs(torch, dev, gen, lens, total, Hq, Hkv, d):
    q = torch.randn(total, Hq, d, device=dev, generator=gen)
    k, v = (torch.randn(total, Hkv, d, device=dev, generator=gen)
            for _ in range(2))
    cu = torch.tensor([0] + [sum(lens[:i + 1]) for i in range(len(lens))],
                      dtype=torch.int32, device=dev)
    return q, k, v, cu


def check_flash_kernels(torch, dev, gen, errs):
    """#9 and #10 against their plain versions (fp32 and bf16); the varlen
    padding tail must be exact zeros; two launches bitwise equal."""
    from repro_torch.kernels import flash_attention as kf
    for case, (B, Hq, Hkv, Tq, Tk, d, W) in FLASH_CHECK_CASES.items():
        q = torch.randn(B, Hq, Tq, d, device=dev, generator=gen)
        k, v = (torch.randn(B, Hkv, Tk, d, device=dev, generator=gen)
                for _ in range(2))
        check_case(
            torch,
            lambda dt: kf.flash_attention_cuda(q.to(dt), k.to(dt), v.to(dt),
                                               window=W),
            lambda dt: kf.flash_attention_ref(
                *(x.to(dt).float() for x in (q, k, v)), window=W),
            "flash_attention", case, errs)
        check_twice(torch, "flash_attention", case,
                    lambda dt: kf.flash_attention_cuda(
                        q.to(dt), k.to(dt), v.to(dt), window=W))
    for case, spec in VARLEN_CHECK_CASES.items():
        if spec[0] == "slice":
            lens = varlen_slice_lengths()
            lens, total, Hq, Hkv, d, W = lens, sum(lens), 4, 4, 64, spec[1]
        else:
            lens, total, Hq, Hkv, d, W = spec
        q, k, v, cu = varlen_inputs(torch, dev, gen, lens, total, Hq, Hkv, d)

        def kernel(dt):
            out = kf.flash_attention_varlen_cuda(q.to(dt), k.to(dt),
                                                 v.to(dt), cu, window=W)
            if (out[sum(lens):] != 0).any():
                raise AssertionError(f"flash_attention_varlen ({case}): "
                                     "padding tail not zero")
            return out

        check_case(
            torch, kernel,
            lambda dt: kf.flash_attention_varlen_ref(
                *(x.to(dt).float() for x in (q, k, v)), cu, window=W),
            "flash_attention_varlen", case, errs)
        check_twice(torch, "flash_attention_varlen", case, kernel)


def check_twice(torch, name, case, kernel):
    """Two launches of ``kernel(dtype)`` bitwise equal, fp32 and bf16."""
    for dt in (torch.float32, torch.bfloat16):
        if not torch.equal(kernel(dt), kernel(dt)):
            raise AssertionError(f"{name} ({case}, {dt}): two launches "
                                 "differ")
    log(f"  {name:31s} {case:40s} two launches bitwise equal (fp32, bf16)")


def flash_pairs(q_pos, k_pos, window):
    """Visible (query, key) pairs of the causal/windowed mask."""
    ok = q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    return ok


def time_flash_kernels(torch, dev, gen, flush):
    """#9 and #10 at the slice's shapes (fp32): #9 with the window at the
    window model's (8, 4, 1024, 64), W 256, and causal at the dense
    baseline's (8, 9, 1024, 64); #10 over one packed stream of the eight
    seeded prompts (4 heads, d 64) at W 256 and W 0.  Bytes: q, k, v (and
    cu_seqlens) read once, o written once; operations: 4*d per visible
    (query, key) pair and query head, counted from this run's masks.  The
    yardstick is SDPA with the boolean causal/window mask (#10: the
    block-diagonal causal mask of the whole stream).  The first of each
    pair is the kernel's row in the ``kernels`` line; the other is
    reported beside it."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kf
    out = {}
    for name, (B, H, T, d, W) in (
            ("flash_attention", (8, 4, 1024, 64, 256)),
            ("flash_attention[causal 8x9x1024]", (8, 9, 1024, 64, 0))):
        q, k, v = (torch.randn(B, H, T, d, device=dev, generator=gen)
                   for _ in range(3))
        pos = torch.arange(T, device=dev)
        mask = flash_pairs(pos, pos, W)
        out[name] = dict(
            ms=time_ms(torch, lambda: kf.flash_attention_cuda(q, k, v,
                                                              window=W),
                       flush=flush),
            plain_ms=time_ms(torch, lambda: kf.flash_attention_ref(
                q, k, v, window=W), flush=flush),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), flush=flush),
            bytes=4 * B * H * T * d * 4, flops=4 * d * B * H * int(mask.sum()))
    lens = varlen_slice_lengths()
    total, H, d = sum(lens), 4, 64
    q, k, v, cu = varlen_inputs(torch, dev, gen, lens, total, H, H, d)
    seg, _ = kf.segments_from_cu_seqlens(cu, total)
    qh, kh, vh = (x.transpose(0, 1)[None].contiguous() for x in (q, k, v))
    pos = torch.arange(total, device=dev)
    for name, W in (("flash_attention_varlen", 256),
                    ("flash_attention_varlen[W 0]", 0)):
        mask = flash_pairs(pos, pos, W) & (seg[:, None] == seg[None, :])
        out[name] = dict(
            ms=time_ms(torch, lambda: kf.flash_attention_varlen_cuda(
                q, k, v, cu, window=W), flush=flush),
            plain_ms=time_ms(torch, lambda: kf.flash_attention_varlen_ref(
                q, k, v, cu, window=W), flush=flush),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask), flush=flush),
            bytes=4 * total * H * d * 4 + cu.numel() * 4,
            flops=4 * d * H * int(mask.sum()))
    log(f"  #10 stream: prompts {lens} ({total} tokens)")
    return out


# ------------------------------------------ window dense heads ([20]-[23])
WINDOW = 256


def window_serve(torch, cfg, paged, want):
    """Batch serving of a window model at full width through
    ``Server.generate`` (batch 8, prompt 1024, 128 greedy tokens, max_len
    1152), dense side on the flash route; ``want``: the exact launches over
    the counted generate.  One decode step is then profiled, as in [7].
    Returns (server, prompts, result)."""
    from repro_torch.launch.serve import Server
    from repro_torch.serve.paged_kv import PagedConfig
    B, P, G, max_len = 8, 1024, 128, 1152
    server = Server(cfg, batch=B, max_len=max_len,
                    paged=PagedConfig(block_size=16) if paged else None,
                    seed=0)
    for layer in server.model.layers:
        layer.mixer.dense_impl = "kernel"
    prompts = torch.randint(2, cfg.vocab, (B, P),
                            generator=torch.Generator().manual_seed(1))

    def timed_generate(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, caches = server.generate(prompts, n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, toks, caches

    timed_generate(2)                                   # warm-up
    prefill_s = min(timed_generate(1)[0] for _ in range(3))
    decode_many = server.model.decode_many
    span = {}

    def timed_decode_many(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = decode_many(*args)
        torch.cuda.synchronize()
        span["decode_s"] = time.perf_counter() - t0
        return res

    server.model.decode_many = timed_decode_many
    counters = kernel_counters()
    for c in counters.values():
        c.count = 0
    torch.cuda.reset_peak_memory_stats()
    gen_s, toks, caches = timed_generate(G)
    launches = {name: c.count for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    del server.model.decode_many
    if launches != want_launches(**want):
        raise AssertionError(f"launch counts {launches} != "
                             f"{want_launches(**want)}")
    if toks.shape != (B, G) or not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"bad tokens {toks.shape}")
    ring = "PagedWindowKVCache" if paged else "WindowKVCache"
    for c in caches:
        dc = c["dense"]
        if type(dc).__name__ != ring:
            raise AssertionError(f"dense cache is {type(dc).__name__}")
        if not torch.isfinite(c["sparse"].k).all() or \
                not torch.isfinite(dc.k).all():
            raise AssertionError("non-finite cache contents")
        if int(dc.length.min()) != P + G - 1 or \
                int(dc.positions.max()) != P + G - 2 or \
                int(dc.positions.min()) != P + G - 1 - WINDOW:
            raise AssertionError("window ring does not hold the last "
                                 f"{WINDOW} positions")
    res = dict(prefill_ms=prefill_s * 1e3, generate_s=gen_s,
               decode_s=span["decode_s"],
               decode_tok_s=B * (G - 1) / span["decode_s"],
               peak_gib=peak / 2 ** 30, launches=launches)
    res["decode_step"] = profile_decode(torch, server, prompts)
    log(f"  {cfg.name}, local_window {cfg.mosa.local_window}, "
        f"{cfg.mosa.selection_granularity} choice, "
        f"{'paged' if paged else 'contiguous'} rings: prefill "
        f"{res['prefill_ms']:.2f} ms (best of 3); {G - 1} decode steps "
        f"{span['decode_s']:.3f} s = {res['decode_tok_s']:.1f} tok/s; peak "
        f"{res['peak_gib']:.3f} GiB; launches {launches}")
    return server, prompts, res


def window_slice(torch):
    """[20]-[22]: the window model served over contiguous and paged rings,
    card against CPU, and block choice beside the window heads (gated)."""
    out = {}
    cfg = slice_config(local_window=WINDOW)
    log(f"[20] main path: window-model batch serving at full width "
        f"({cfg.mosa.n_dense_heads} window heads, W {WINDOW})")
    server, prompts, out["contiguous"] = window_serve(
        torch, cfg, False, dict(flash_attention=cfg.n_layers,
                                mosa_attention=cfg.n_layers))
    log("[21] card vs CPU for window serving (contiguous rings), prompt 384")
    out["contiguous"]["cross_check_err"] = cross_check(
        torch, server, cfg, prompts, P=384, paged=False)
    del server
    log("[20b] main path: window-model serving over paged rings "
        "(PagedConfig(16))")
    server, prompts, out["paged"] = window_serve(
        torch, cfg, True, dict(mosa_attention=cfg.n_layers))
    log("[21b] card vs CPU for window serving (paged rings), prompt 384")
    out["paged"]["cross_check_err"] = cross_check(torch, server, cfg,
                                                  prompts, P=384, paged=True)
    del server
    bcfg = slice_config(local_window=WINDOW, **BLOCK_MOSA)
    log("[22] main path: block choice beside the window heads (gated "
        "combine), contiguous rings")
    server, prompts, out["block"] = window_serve(
        torch, bcfg, False, dict(flash_attention=bcfg.n_layers,
                                 mosa_block_attention=bcfg.n_layers))
    if not all(layer.mixer._gated() for layer in server.model.layers):
        raise AssertionError("block choice beside window heads is not gated")
    out["block"]["cross_check_err"] = cross_check(
        torch, server, bcfg, prompts, P=384, paged=False)
    del server
    return out


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """Deterministic algorithms for the block: ``index_add_``, which sums
    the MoSA heads' outputs into the tokens, then adds in a fixed order
    instead of by CUDA atomics.  Without it the last bits of the residual
    stream change from run to run and, over ~13,000 top-k decisions per
    loss, now and then flip a near-tied selection in a later layer, which
    moves the loss by ~1e-5 whatever the dense route.  Ops without a
    deterministic form (cuBLAS without a fixed workspace) only warn, and
    those warnings are silenced."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def eval_loss(torch, cfg, label):
    """[23]: ``TransformerLM.loss`` under ``torch.no_grad()`` at 8 x 1024
    with every dense attention on the flash route (exactly one #9 launch
    per layer), then the same weights on the chunked route: with MoSA
    layers each layer's selections must be identical first (a near-tie
    shows as a selection difference), then the two losses within 1e-5
    relative.  Both run under ``deterministic_algorithms``."""
    from repro_torch.core.attention import MultiHeadAttention
    from repro_torch.nn.transformer import TransformerLM
    dev = torch.device("cuda")
    with torch.no_grad():
        model = TransformerLM(cfg, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(0))
    model.eval()
    toks = torch.randint(2, cfg.vocab, (8, 1025),
                         generator=torch.Generator().manual_seed(4)).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def set_route(impl):
        for layer in model.layers:
            if isinstance(layer.mixer, MultiHeadAttention):
                layer.mixer.impl = impl
            else:
                layer.mixer.dense_impl = impl

    def timed_loss():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            loss, _ = model.loss(batch)
        torch.cuda.synchronize()
        return loss.item(), (time.perf_counter() - t0) * 1e3

    res, sel = {}, {}
    with deterministic_algorithms(torch):
        for impl in ("kernel", "chunked"):
            set_route(impl)
            timed_loss()                               # warm-up
            if impl == "kernel":
                counters = kernel_counters()
                for c in counters.values():
                    c.count = 0
            loss, ms = timed_loss()
            if impl == "kernel":
                launches = {name: c.count for name, c in counters.items()}
                want = {"flash_attention": cfg.n_layers}
                if cfg.mosa is not None:
                    want["mosa_attention"] = cfg.n_layers
                if launches != want_launches(**want):
                    raise AssertionError(f"{label}: launch counts {launches} "
                                         f"!= {want_launches(**want)}")
                res["launches"] = launches
            if cfg.mosa is not None:
                sel[impl] = layer_selections(torch, model, batch["tokens"])
            res[f"loss_{impl}"], res[f"ms_{impl}"] = loss, ms
    if sel:
        differ = [int((a != b).any(-1).sum())
                  for a, b in zip(sel["kernel"], sel["chunked"])]
        log(f"  {label}: heads whose selection differs between the routes, "
            f"per layer: {differ}")
        if any(differ):
            raise AssertionError(f"{label}: selections differ between the "
                                 f"flash and chunked routes: {differ}")
    rel = abs(res["loss_kernel"] - res["loss_chunked"]) / abs(
        res["loss_chunked"])
    res["rel_diff"] = rel
    log(f"  {label} ({cfg.name}): loss {res['loss_kernel']:.6f} (flash, "
        f"{res['ms_kernel']:.1f} ms) vs {res['loss_chunked']:.6f} (chunked, "
        f"{res['ms_chunked']:.1f} ms), rel diff {rel:.2e} (tol 1e-5); "
        f"launches {res['launches']}")
    if not (math.isfinite(res["loss_kernel"]) and rel <= 1e-5):
        raise AssertionError(f"{label}: flash loss differs from chunked by "
                             f"{rel:.2e}")
    del model
    return res


def varlen_entry(torch):
    """[23c] #10 through its entry point ``flash_attention_varlen``: the
    packed stream of the eight seeded prompts (4 heads, d 64, W 256) under
    ``torch.no_grad()`` — exactly one launch of #10 and none of another
    kernel — then each segment held against #9 on that segment alone."""
    from repro_torch.kernels import flash_attention as kf
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    lens = varlen_slice_lengths()
    q, k, v, cu = varlen_inputs(torch, dev, gen, lens, sum(lens), 4, 4, 64)
    counters = kernel_counters()
    for c in counters.values():
        c.count = 0
    with torch.no_grad():
        out = kf.flash_attention_varlen(q, k, v, cu, window=WINDOW)
    torch.cuda.synchronize()
    launches = {name: c.count for name, c in counters.items()}
    if launches != want_launches(flash_attention_varlen=1):
        raise AssertionError(f"launch counts {launches}")
    err = 0.0
    for a, b in zip(cu[:-1].tolist(), cu[1:].tolist()):
        one = kf.flash_attention(*(x[a:b].transpose(0, 1)[None]
                                   for x in (q, k, v)), window=WINDOW)
        err = max(err, max_err(torch, out[a:b], one[0].transpose(0, 1),
                               FP32_TOL, FP32_TOL))
    log(f"  packed stream of {len(lens)} prompts ({sum(lens)} tokens): "
        f"launches {launches}; max|packed - per-prompt #9| {err:.3e}")
    return dict(launches=launches, per_row_err=err)


# ------------------------------------------- the IsoFLOP sweep ([24], [25])
SWEEP_STEPS = 6              # per point; step 0 untimed
SWEEP_VARIANTS = ("dense", "mosa", "fixed", "routing")


def sweep_heads(torch, cfg):
    """The sparse heads of a point's first layer as the model builds it
    (on the meta device: no memory, no init); a dense point's attention
    heads."""
    from repro_torch.nn.transformer import TransformerLM
    mixer = TransformerLM(cfg, device="meta").layers[0].mixer
    return (mixer.sparse.n_heads if hasattr(mixer, "sparse")
            else mixer.cfg.n_heads)


def sweep_launches(point):
    """Exact launches of one point's ``SWEEP_STEPS`` steps (6 layers x 8
    microbatches each): k = 32 takes the one-row #2 and the fused
    backward, k = 128 the streaming #2 and the split #3 and #4; the dense
    and baseline points run no kernel."""
    if point.variant != "mosa":
        return want_launches()
    n = point.cfg.n_layers * 8 * SWEEP_STEPS
    k = 1024 // point.sparsity
    names = (("mosa_attention_fwd_res", "mosa_attention_bwd") if k <= 64
             else ("mosa_attention_fwd_res", "mosa_attention_bwd_dq",
                   "mosa_attention_bwd_dkv"))
    return want_launches(**{name: n for name in names})


def isoflop_slice(torch):
    """[24]: the paper's IsoFLOP sweep at full width through
    ``run_isoflop`` (the ``Trainer``, kernel path): tiny at T 1024, dense,
    mosa, fixed and routing at sparsities 8 and 32, ``SWEEP_STEPS`` steps
    of 64 x 1024 tokens as 8 microbatches per point.  Per point: the
    counters zeroed just before and read just after (exact, see
    ``sweep_launches``), every loss finite, the metrics file's
    ``train.step_time_s`` and the trace's ``train_step`` spans one per
    step; the step time (median over steps 1-5) comes from those spans."""
    from repro_torch import obs
    from repro_torch.train.isoflop import (budget_match_error, isoflop_sweep,
                                           run_isoflop)
    points = isoflop_sweep(preset="full", size="tiny", T=1024,
                           sparsities=(8, 32), variants=SWEEP_VARIANTS)
    err = budget_match_error([p for p in points
                              if p.variant in ("dense", "mosa")])
    log(f"  {len(points)} points; budget_match_error over dense and mosa "
        f"{err:.4f} (tol 0.05), over all {budget_match_error(points):.4f}")
    if not err < 0.05:
        raise AssertionError(f"dense/mosa budgets differ by {err:.4f}")
    out_dir = ROOT / "build" / "isoflop"           # git-ignored
    out_dir.mkdir(parents=True, exist_ok=True)
    counters = kernel_counters()
    ref = points[0].flops_fwd_per_token
    tokens = 64 * 1024
    rows, totals = [], want_launches()
    for pt in points:
        mpath = out_dir / f"{pt.name}.metrics.jsonl"
        tpath = out_dir / f"{pt.name}.trace.json"
        mpath.unlink(missing_ok=True)
        obs.registry().reset()
        obs.tracer().reset()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        for c in counters.values():
            c.count = 0
        res = run_isoflop([pt], steps=SWEEP_STEPS, seq_len=1024,
                          global_batch=64, train_kw={
                              "microbatch": 8, "mosa_impl": "kernel",
                              "log_every": 1, "metrics_path": str(mpath),
                              "trace_path": str(tpath)})[pt.name]
        launches = {name: c.count for name, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        want = sweep_launches(pt)
        if launches != want:
            raise AssertionError(f"{pt.name}: launch counts {launches} != "
                                 f"{want}")
        totals = {k: totals[k] + v for k, v in launches.items()}
        losses = [h["loss"] for h in res["loss_curve"]]
        if len(losses) != SWEEP_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{pt.name}: bad loss curve {losses}")
        snap = obs.read_last_snapshot(str(mpath))
        n_obs = snap["histograms"]["train.step_time_s"]["count"]
        spans = [e for e in json.loads(tpath.read_text())["traceEvents"]
                 if e.get("name") == "train_step"]
        if n_obs != SWEEP_STEPS or len(spans) != SWEEP_STEPS:
            raise AssertionError(f"{pt.name}: {n_obs} train.step_time_s "
                                 f"observations, {len(spans)} train_step "
                                 f"spans; want {SWEEP_STEPS} each")
        step_ms = [e["dur"] / 1e3 for e in spans]
        med = statistics.median(step_ms[1:])
        row = dict(name=pt.name, variant=pt.variant, sparsity=pt.sparsity,
                   heads=sweep_heads(torch, pt.cfg),
                   flops_fwd_per_token=pt.flops_fwd_per_token,
                   flops_ratio=pt.flops_fwd_per_token / ref,
                   step_ms=med, step_ms_each=step_ms,
                   tokens_per_s=tokens / (med / 1e3),
                   losses=losses, peak_gib=peak / 2 ** 30,
                   launches={k: v for k, v in launches.items() if v})
        rows.append(row)
        log(f"  {pt.name}: {row['variant']} sparsity {row['sparsity']}, "
            f"{row['heads']} heads; {row['flops_fwd_per_token']} FLOPs/token "
            f"({row['flops_ratio']:.4f} x dense); step {med:.1f} ms (median "
            f"of steps 1-{SWEEP_STEPS - 1}; each "
            f"{[round(x, 1) for x in step_ms]}) = {row['tokens_per_s']:.0f} "
            f"tokens/s; peak {row['peak_gib']:.3f} GiB; losses "
            f"{[round(x, 4) for x in losses]}; launches {row['launches']}")
    return dict(points=rows, budget_match_error=err,
                budget_match_error_all=budget_match_error(points),
                launches_total=totals)


def profile_sweep_mosa(torch):
    """[24b]: one microbatch (8 x 1024) of the sweep's mosa8 and mosa32
    points under ``torch.profiler``, as [10]: where their steps' device
    time goes, the MoSA kernels' share included, each MoSA kernel by name
    (mosa8's split backward: ``mosa_bwd_dq_kernel`` and
    ``mosa_bwd_dkv_kernel``)."""
    from repro_torch.train.isoflop import isoflop_sweep
    from repro_torch.train.loop import TrainConfig, Trainer
    out = {}
    for pt in isoflop_sweep(preset="full", size="tiny", T=1024,
                            sparsities=(8, 32), variants=("mosa",)):
        trainer = Trainer(TrainConfig(seq_len=1024, global_batch=64,
                                      microbatch=8, mosa_impl="kernel"),
                          model_cfg=pt.cfg)
        trainer.init_state()
        log(f"  {pt.name}:")
        out[pt.name] = profile_train(torch, trainer)
        log("  its MoSA kernels per microbatch (device ms): " + ", ".join(
            f"{name} {ms:.3f}" for name, ms in sorted(
                out[pt.name]["mosa_kernels"].items(), key=lambda kv: -kv[1])))
        del trainer
    return out


def cluster_selections(torch, model, tokens):
    """Each routing layer's cluster members (B, H, rho, k) on ``tokens``."""
    out = []
    T = tokens.shape[1]
    with torch.no_grad():
        x = model.embed(tokens)
        for layer in model.layers:
            sp = layer.mixer.sparse
            qk = sp._normalized_qk(layer.norm1(x))
            out.append(sp._cluster_select(qk.float(),
                                          max(T // sp.sparsity, 2)).cpu())
            x, _ = layer(x)
    return out


def sweep_cross_check(torch, variant, sparsity):
    """[25]: the sweep's ``mosa-paper-tiny-{variant}{sparsity}`` at full
    width on the card and the CPU with the same (seeded) weights: one loss
    and backward, under ``deterministic_algorithms`` (the heads' outputs
    are summed by ``index_add_``; routing's clusters overlap).  The
    selections first (routing's clusters, MoSA's tokens), then the loss
    within 1e-5 relative and every grad within 1e-4 of its tensor's max
    |grad| (the centroids get none).  The baselines at batch 1 x 256; mosa8
    on the kernel path at 1 x 1024, so that k = 128 takes [24]'s route
    (the streaming #2, the split #3 and #4: one launch each per layer,
    counted exactly, beside one #1 per layer from the selections' no-grad
    walk)."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.nn.transformer import TransformerLM
    cfg = get_config("mosa-paper", preset="full", size="tiny",
                     variant=variant, sparsity=sparsity)
    selections, T, want = {"routing": cluster_selections,
                           "mosa": layer_selections}.get(variant), 256, None
    if variant == "mosa":
        cfg = dataclasses.replace(cfg, mosa=dataclasses.replace(
            cfg.mosa, impl="kernel"))
        T = 1024
        want = want_launches(**dict.fromkeys(
            ("mosa_attention", "mosa_attention_fwd_res",
             "mosa_attention_bwd_dq", "mosa_attention_bwd_dkv"),
            cfg.n_layers))
    dev = torch.device("cuda")
    with torch.no_grad():
        gpu = TransformerLM(cfg, device=dev)
        gpu.init(torch.Generator(device=dev).manual_seed(0))
    counters = kernel_counters()
    for c in counters.values():
        c.count = 0
    with deterministic_algorithms(torch):
        res = model_cross_check(torch, gpu, cfg, selections, seq_len=T)
    launches = {name: c.count for name, c in counters.items()}
    if want is not None and launches != want:
        raise AssertionError(f"{variant}{sparsity} cross check: launch "
                             f"counts {launches} != {want}")
    res["launches"] = {k: v for k, v in launches.items() if v}
    del gpu
    return res


def main():
    if not (SRC / "repro_torch").is_dir():
        sys.exit(f"chip_smoke.py: {SRC / 'repro_torch'} not found; run it "
                 "from a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.launch.serve import Server
    from repro_torch.serve.paged_kv import PagedConfig

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    lib = build.library()
    log(f"[2] kernels built in {lib.build_seconds:.1f} s -> "
        f"{lib.path.relative_to(ROOT)}")
    for f in sorted(lib.path.parent.glob("*.log")):
        kernel = ""
        for line in f.read_text().splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                kernel = kernel_label(m.group(1))
            elif "registers" in line or "spill" in line:
                log(f"    {f.stem} {kernel}: "
                    f"{line.strip().replace('ptxas info    : ', '')}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[3] kernels vs plain versions (TF32 off: "
        "torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False)")
    errs = check_kernels(torch, dev)

    log("[4] kernel times at the slice's shapes (fp32, L2 flushed)")
    times = time_kernels(torch, dev)

    log("[5] main path: paged MoSA serving at full width")
    server, cfg, prompts, res = serve_slice(torch)

    log("[6] card vs CPU at full width")
    cross_check(torch, server, cfg, prompts)

    log("[7] one decode step at the slice's shapes, profiled")
    res["decode_step"] = profile_decode(torch, server, prompts)
    del server

    log("[8] main path: training at full width")
    trainer, train = train_slice(torch)

    train["fused_bwd"] = {k: times["mosa_attention_bwd"][k] for k in (
        "ms", "prologue_ms", "bound_ms", "library_ms")}

    log("[9] card vs CPU for training at full width")
    train["cross_check"] = train_cross_check(torch, trainer)

    log("[10] one training microbatch at the slice's shapes, profiled")
    train["microbatch"] = profile_train(torch, trainer)
    del trainer

    log("[11] main path: Scheduler serving at full width")
    sched_server, sched = sched_slice(torch)

    log("[12] preemption at full width")
    sched["preempt"] = preempt_slice(torch, sched_server)

    log("[13] card vs CPU for the Scheduler at full width")
    sched["cross_check"] = sched_cross_check(torch, sched_server)
    del sched_server
    sched["kernel_cases"] = {name: times[name] for name in (
        "paged_prefill_attention",
        f"paged_prefill_attention[{PREFILL_FULL_CHUNK}]",
        f"paged_attention_decode[{DECODE_MIX}]",
        f"paged_attention_decode[{PAD_CASE}]",
        f"paged_prefill_attention[{PAD_CASE}]")}

    block = {}
    log("[14] main path: block-choice paged serving at full width")
    bserver, bcfg, bprompts, block["serve"] = serve_slice(
        torch, slice_config(**BLOCK_MOSA))

    log("[15] card vs CPU for block-choice serving at full width")
    block["serve"]["cross_check_err"] = cross_check(torch, bserver, bcfg,
                                                    bprompts)
    block["serve"]["decode_step"] = profile_decode(torch, bserver, bprompts)
    del bserver

    log("[16] main path: block-choice training at full width")
    btrainer, block["train"] = train_slice(torch, **BLOCK_MOSA)

    block["train"]["fused_bwd"] = {k: times["mosa_block_attention_bwd"][k]
                                   for k in ("ms", "prologue_ms", "bound_ms",
                                             "library_ms")}

    log("[17] card vs CPU for block-choice training at full width")
    block["train"]["cross_check"] = train_cross_check(torch, btrainer)
    del btrainer

    log("[18] main path: block-choice Scheduler at full width, prefix hits")
    bsched_server = Server(slice_config(**BLOCK_MOSA), batch=8,
                           max_len=SCHED_MAX_LEN,
                           paged=PagedConfig(block_size=SCHED_BS,
                                             num_blocks=SCHED_BLOCKS), seed=0)
    block["sched"] = block_sched_slice(torch, bsched_server)

    log("[19] card vs CPU for the block-choice Scheduler at full width")
    block["sched"]["cross_check"] = sched_cross_check(torch, bsched_server)
    del bsched_server

    window = window_slice(torch)
    log("[23] main path: forward-only evaluation through #9 (loss at "
        "8 x 1024, no_grad)")
    from repro_torch.configs.base import get_config
    window["eval_dense"] = eval_loss(
        torch, get_config("mosa-paper", preset="full", size="tiny",
                          variant="dense"), "dense baseline")
    window["eval_window"] = eval_loss(torch, slice_config(local_window=WINDOW),
                                      "window model")
    log("[23c] main path: #10 through flash_attention_varlen")
    window["varlen_entry"] = varlen_entry(torch)
    window["kernel_cases"] = {name: times[name] for name in (
        "flash_attention[causal 8x9x1024]", "flash_attention_varlen[W 0]")}

    log(f"[24] main path: the IsoFLOP sweep at full width ({SWEEP_STEPS} "
        "steps per point)")
    sweep = isoflop_slice(torch)

    log("[24b] one microbatch of mosa8 and of mosa32, profiled")
    sweep["microbatch"] = profile_sweep_mosa(torch)

    log("[25] card vs CPU for the sweep at full width (fixed32, routing32, "
        "mosa8)")
    sweep["cross_check"] = {f"{v}{s}": sweep_cross_check(torch, v, s)
                            for v, s in (("fixed", 32), ("routing", 32),
                                         ("mosa", 8))}
    sweep["kernel_cases"] = {
        name: {**times[name], "max_abs_err": errs[name]}
        for name in (f"mosa_attention_fwd_res[{SWEEP_MOSA8_NAME}]",
                     "mosa_attention_bwd_dq", "mosa_attention_bwd_dkv",
                     "mosa_attention_bwd_dq[S 32]",
                     "mosa_attention_bwd_dkv[S 32]")}

    sources = {
        "mosa_attention": ("src/repro_torch/csrc/mosa_attention.cu",
                           "src/repro/kernels/mosa_attention.py:55"),
        "mosa_attention_fwd_res": ("src/repro_torch/csrc/mosa_attention.cu",
                                   "src/repro/kernels/mosa_attention.py:110"),
        "mosa_attention_bwd": ("src/repro_torch/csrc/mosa_backward.cu",
                               "src/repro/kernels/mosa_backward.py:49, "
                               "src/repro/kernels/mosa_backward.py:100"),
        "mosa_attention_bwd_dq": ("src/repro_torch/csrc/mosa_backward.cu",
                                  "src/repro/kernels/mosa_backward.py:49"),
        "mosa_attention_bwd_dkv": ("src/repro_torch/csrc/mosa_backward.cu",
                                   "src/repro/kernels/mosa_backward.py:100"),
        "paged_attention_decode": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/serve/paged_attention.py:87"),
        "paged_prefill_attention": ("src/repro_torch/csrc/paged_prefill.cu",
                                    "src/repro/serve/paged_attention.py:260"),
        "mosa_block_attention": ("src/repro_torch/csrc/mosa_attention.cu",
                                 "src/repro/kernels/mosa_block.py:67"),
        "mosa_block_attention_fwd_res": (
            "src/repro_torch/csrc/mosa_attention.cu",
            "src/repro/kernels/mosa_block.py:128"),
        "mosa_block_attention_bwd": (
            "src/repro_torch/csrc/mosa_backward.cu",
            "src/repro/kernels/mosa_block.py:182, "
            "src/repro/kernels/mosa_block.py:227"),
        "mosa_block_attention_bwd_dq": (
            "src/repro_torch/csrc/mosa_backward.cu",
            "src/repro/kernels/mosa_block.py:182"),
        "mosa_block_attention_bwd_dkv": (
            "src/repro_torch/csrc/mosa_backward.cu",
            "src/repro/kernels/mosa_block.py:227"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:26"),
        "flash_attention_varlen": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:116"),
    }
    # launches: serving's kernels from [5], training's from [8], packed
    # prefill's from [11], block choice's from [14] and [16], the flash
    # kernels' from [20] and [23c], the split #3 and #4 from [24]
    launches = {name: (res["launches"][name]
                       or train["launches_total"][name]
                       or sched["launches"][name]
                       or block["serve"]["launches"][name]
                       or block["train"]["launches_total"][name]
                       or window["contiguous"]["launches"][name]
                       or window["varlen_entry"]["launches"][name]
                       or sweep["launches_total"][name])
                for name in sources}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], max_abs_err=errs[name],
                    ms=times[name]["ms"], plain_ms=times[name]["plain_ms"],
                    bound_ms=times[name]["bound_ms"],
                    bound_by=times[name]["bound_by"],
                    library_ms=times[name]["library_ms"],
                    **{k: times[name][k] for k in ("stream_ms", "device_ms")
                       if k in times[name]})
               for name, (src, rep) in sources.items()]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"serve": {
        k: res[k] for k in ("prefill_ms", "decode_tok_s", "decode_s",
                            "generate_s", "peak_gib", "params",
                            "decode_step")}}))
    print(json.dumps({"train": train}))
    print(json.dumps({"sched": sched}))
    print(json.dumps({"block": block}))
    print(json.dumps({"window": window}))
    print(json.dumps({"sweep": sweep}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
