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
     bs 1, rows with only block 0, bs 64, S = 65 as 5 blocks of 13, S =
     128 as 8 blocks of 16), plus #5/#6 at bs = 1 against #1/#2 on both
     routes (S 37, and S 128 on the streaming one) and the fused block
     backward against the fused token backward (each pair bit for bit
     equal, or the phase fails), and the flash kernels #9 and #10 (GQA, Tq
     < Tk through q_offset, windows, ragged tiles, Tq not a multiple of
     the 64-row tile with the window's edge inside a key tile, d 36 and
     128, segments of length 1, a padding tail that must be zeros; two
     launches bitwise equal);
  4. time each kernel, its plain version and one PyTorch yardstick call
     with CUDA events (L2 flushed before every timed launch); #1, #2, #5
     and #6 on the route the slice takes (the one-row kernel) with the
     streaming kernel beside it (``stream_ms``), and #1 and #2 at [24]'s
     mosa8 shape (the streaming kernel, beside SDPA); also the
     autograd Functions' backward prologues (g~, dr, delta; token and
     block choice) on their own, paged decode at a second shape (the
     Scheduler mix: 8 rows of 128-1152 positions) and packed prefill at a
     second shape (one 256-token segment at past 768, the Scheduler's full
     chunk), both in the ``sched`` JSON's kernel_cases; paged decode's
     and the streaming #2's and the split #3's and #4's (at [24]'s mosa8
     shape) device time from ``torch.profiler`` too (``device_ms``);
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
     by name (mosa8's streaming forward named on its own line);
 25. the card against the CPU for ``fixed32`` and ``routing32`` at full
     width and the same weights, as phase 9 (routing: identical cluster
     selections in every layer first), under deterministic algorithms;
 26. the window pool of the Scheduler at full width: the JAX package's
     acceptance stack for it (dense, window and MoSA layers: (attn,
     attn_local, mosa) x 2 at the slice's widths, W 256) served like phase
     11 with a window pool of every row's whole ring (8 x 16 blocks):
     every request gets its max_new, every dense block returns but the
     trie's and every window block returns; launches of paged decode = 4
     (the paged dense layers: 2 attn, 2 MoSA dense sides) x decode steps,
     of packed prefill = 4 x prefill chunks, of every other kernel 0 (the
     ring's prefill and decode are plain PyTorch); the share of the wall
     spent pausing mid-prefill rows;
 27. that stack preempted as phase 12 (every block of both pools back)
     and on the card against the CPU as phase 13 (the 320-token prompt
     wraps the ring): identical tokens and stats;
 28. ``RequestPool`` (the non-paged fallback) over the slice's model:
     batch 8, max_len 1152, 24 seeded prompts of 100-1000 tokens (pow2
     buckets), 32 tokens each: every request complete, exactly 6 x 24
     launches of #1 (``prefill_one``) and 0 of every other kernel; then the
     pool on the card and the CPU (batch 2, 4 requests): identical tokens;
     28b: ``generate_stepwise`` at phase 5's shapes: its tokens equal
     ``generate``'s (both under deterministic algorithms), exactly 6
     launches of #1 and 6 x 127 of paged decode;
 29. phase 8's training under the remat policies ``none``, ``full``,
     ``mosa`` and ``dots_saveable``: exact launches (144 of the training
     forward under ``none``, 288 under the others: forward and recompute;
     144 of the fused backward), peak device memory and median step, one
     microbatch's own peak memory and its wall and device time under
     ``torch.profiler``; then
     under deterministic algorithms one 1 x 256 loss and backward per
     policy: the loss bitwise ``none``'s, every grad within 1e-6 of its
     tensor's max |grad|, ``mosa`` keeping exactly the 2 tagged tensors
     per layer and ``dots_saveable`` only matrix products.  Gate: ``full``
     and ``mosa`` below ``none`` in peak memory;
 30. phase 8's training on a one-rank mesh: the Trainer with ``mesh_shape``
     (1, 1) over ``data`` and ``model`` starts a world-1 NCCL process group
     and runs the sharded step (``repro_torch.dist.parallel``), once under
     ``fsdp_tp`` (with a ``ckpt_dir``: heartbeats and a checkpoint of the
     gathered full tensors) and once under ``tp``, beside a plain Trainer
     of phase 8's configuration, all three under deterministic algorithms
     (``index_add_``'s atomics make two runs of phase 8 differ by ~1e-5):
     every loss and grad norm within 1e-6 relative of the plain run's (and
     whether bitwise; the differences to phase 8's own values beside),
     exactly 144 launches each of #2 and the fused backward over the 3
     timed steps, a heartbeat file, the straggler summary; step ms and peak
     memory beside the plain run's and phase 8's;
 31. tensor-parallel MoSA: layer 0 of phase 8's model at 8 x 1024 cut into
     ``model`` = 4 rank-local shards (1 dense + 69 MoSA heads each), each
     through the rank-local forward a rank of a (1, 4) mesh runs before
     its all-reduce, and its backward: #2 and the fused backward exactly
     once per shard, identical selections (a difference only on an exact
     fp32 tie), the shards' sum within 1e-5 relative of the unsharded
     layer, every shard's grads within 1e-5 of the unsharded slices;
 32. ``compressed_all_reduce`` of phase 30's last gradients on its NCCL
     group (top-k 1 % and int8): kept + residual is the gradient bit for
     bit and the reduction is kept; the compression and the all-reduce
     timed with CUDA events;
 33. phase 5's generate through a ``Server`` on a (1, 1) mesh over
     ``data`` and ``model`` (phase 30's world-1 NCCL group) under ``tp``,
     beside a plain ``Server`` in the same call, both under deterministic
     algorithms: identical tokens and exactly phase 5's launches (6 of
     #1, 762 of #11) for both; prefill ms, decode tok/s and one profiled
     decode step of each;
 34. phase 11's Scheduler traffic on that mesh in timed mode (an
     ``OpenLoopSource`` whose 32 arrivals are all due at the start, read
     by rank 0), beside a plain run, both deterministic: identical tokens
     and stats, exactly phase 11's launches (#11 and #12); the wall and
     the pause share of each;
 35. tensor-parallel serving: layer 0 of phase 5's model as ``model`` = 4
     rank-local shards (1 dense + 69 MoSA heads, one KV head of paged
     cache each) through ``local_prefill`` over 8 x 1024, a packed chunk
     through ``local_prefill_packed`` and 8 ``local_decode_step``s: #1,
     #12 and #11 exactly once per shard and stage, each shard's MoSA
     caches the unsharded layer's head slices (identical picks; the
     unsharded router's GEMM cut into the shards' head slices, so that
     both round alike), the shards' outputs summed within 1e-5 relative
     of the unsharded layer's; then the dense side's
     ``seq_sharded`` decode over 4 position slices, each in a thread of
     its own, merged within 1e-5 relative of the unsplit decode;
 36. the wide route (head dims over 128, ``csrc/wide_attention.cu``): all
     12 kernels at d 160, 192 and 256 against their plain versions, fp32
     and bf16, under phase 3's tolerances (#1-#4 at gemma3-4b-mosa32's
     (4, 32, 64) and at S 70 and 128 with -1 keys, r = 0 rows, segments
     and unsorted idx; #5-#8 with a ragged last block, empty blocks and
     two segments; #9 with GQA, windows and q_offset; #10 with a padding
     tail; #11 at GQA groups 2, 6 and 7 with a row of length 0; #12 at
     the gemma3-4b chunk and phase 3's edges), each wrapper call one
     count, two launches bitwise equal; then each timed at d 256 as phase
     4 times the others, beside its bound and SDPA at the same shape;
 37. ``qwen2-1.5b``, ``yi-9b``, ``musicgen-large``, ``gemma3-4b`` and
     ``yi-34b`` served one after another at full width in bf16, random
     weights from seed 0: ``Server.generate`` of batch 4 x a 2048-token
     prompt + 32 greedy tokens on paged KV (yi-34b at the deepest depth
     that leaves 4 GiB of the card free, full depth if it does), exactly
     one launch of #11 per global attention layer and decode step and 0
     of every other kernel; depth, parameters, peak memory, the caches'
     bytes (``cache_nbytes``), prefill ms and decode tok/s of each; then
     its first two layers (gemma3-4b: a local and a global one) in bf16
     against fp32 on the same weights (prefill logits within 5% of the
     largest logit), and in fp32 at full width and 2 layers (the
     vocabulary cut to 512 where its tables pass 2 GiB) card against CPU:
     identical greedy tokens;
 38. gemma3-4b's other paths at full width: the Scheduler (8 requests of
     100-1000 tokens; exactly 5 x chunks of #12 and 5 x decode steps of
     #11 at d 256, both pools back), the contiguous window rings with
     every attention layer on the kernel route (exactly 29 launches of #9
     at d 256 per generate), and ``gemma3-4b-mosa32`` (32 MoSA + 4 dense
     heads of d 256 a layer) through ``generate`` as phase 37 (34 of #1,
     34 x 31 of #11), with its bf16 and card-vs-CPU checks.

Phases 3 and 4 hold and time #9 and #10 too.  The last fifteen lines are
the ``serve`` JSON, the ``train`` JSON, the ``sched`` JSON (phases 26 and
27 under ``window``), the ``block`` JSON, the ``window`` JSON, the
``sweep`` JSON, the ``pool`` JSON (28, 28b), the ``remat`` JSON (29), the
``dist`` JSON (30-35), the ``wide`` JSON (36's times), the ``archs`` JSON
(37), the ``gemma`` JSON (38), the ``kernels`` JSON (with each kernel's
launches in 33-35, ``launches_mesh``, its launches at d 256 in 37 and 38,
``launches_d256``, and its d 256 row from 36, ``d256``), the
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
    same (rounded) inputs; records the fp32 error of the slice's case as
    ``label``, of [24]'s mosa8 case as ``label@sweep``, and the largest
    fp32 error of every case so far as ``label@max``.
    With ``parts``, both return a tuple of outputs, each checked and
    recorded as ``name.part``.  The parts named in ``zeros`` are zero in
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
            if dt == torch.float32:
                errs[f"{label}@max"] = max(e, errs.get(f"{label}@max", 0.0))
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
    errs[f"mosa_attention[{SWEEP_MOSA8_NAME}]"] = errs["mosa_attention@sweep"]


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
    # the streaming forward over four key tiles, the split backward
    "NB*bs=128 (NB=8 bs=16), empty, segs": dict(B=2, H=3, NB=8, bs=16,
                                                d=64, T=1000, empty=3,
                                                two_segs=True),
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
    # S 128: the streaming kernels over four key tiles
    q, k, v, idx, r, seg = mosa_inputs(torch, 2, 3, 128, 64, 1024, dev, gen,
                                       neg_keys=6, zero_rows=3,
                                       with_seg=True)
    pairs += [
        ("#5 vs #1 (stream, S 128)",
         kb.mosa_block_attention_stream_cuda(q, k, v, idx, r, 1, 1024,
                                             seg=seg),
         km.mosa_attention_stream_cuda(q, k, v, idx, r, seg=seg)),
        ("#6 vs #2 (stream, S 128)",
         flat(kb.mosa_block_attention_fwd_res_stream_cuda(q, k, v, idx, 1,
                                                           1024, seg=seg)),
         flat(km.mosa_attention_fwd_res_stream_cuda(q, k, v, idx,
                                                    seg=seg)))]
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
    pairs = int(mask.sum())
    mosa8, mosa8_calls = time_train_kernels(torch, q, k, v, idx, r, mask,
                                            pairs, flush, gen)
    for name in ("mosa_attention_bwd_dq", "mosa_attention_bwd_dkv"):
        out[f"{name}[S 32]"] = out[name]
        out[name] = mosa8[name]
    fwd8 = f"mosa_attention_fwd_res[{SWEEP_MOSA8_NAME}]"
    out[fwd8] = mosa8["mosa_attention_fwd_res"]
    mosa8_calls[fwd8] = mosa8_calls.pop("mosa_attention_fwd_res")
    # #1's streaming route at the same shape (no main path runs #1 above
    # S = 64; serving a mosa8 model would), beside SDPA with the bool mask
    fwd1 = f"mosa_attention[{SWEEP_MOSA8_NAME}]"
    B8, H8, S8, d8 = SWEEP_MOSA8
    out[fwd1] = dict(
        ms=time_ms(torch, lambda: mosa_attention_cuda(q, k, v, idx, r),
                   flush=flush),
        plain_ms=time_ms(torch, lambda: mosa_attention_ref(q, k, v, idx, r),
                         flush=flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), flush=flush),
        bytes=4 * B8 * H8 * S8 * d8 * 4 + B8 * H8 * S8 * (4 + 4),
        flops=4 * pairs * d8)
    mosa8_calls[fwd1] = lambda: mosa_attention_cuda(q, k, v, idx, r)

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
    # the streaming #2 and #1 and the split #3 and #4 at mosa8, each
    # kernel's own device time
    for name, kernel in ((fwd8, "mosa_fwd_stream_kernel"),
                         (fwd1, "mosa_fwd_stream_kernel"),
                         ("mosa_attention_bwd_dq", "mosa_bwd_dq_kernel"),
                         ("mosa_attention_bwd_dkv", "mosa_bwd_dkv_kernel")):
        out[name]["device_ms"] = device_ms_by_kernel(
            torch, mosa8_calls[name], flush, (kernel,))[kernel]
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


def time_decode_kernel(torch, dev, gen, flush, lens, d=64, Hq=4, Hkv=4,
                       nb=72):
    """#11 (fp32) over rows of ``lens`` positions: Hq = Hkv = 4, d 64 (or
    ``d``: outside 32, 64, 128, 256 the wrapper's pad route), 72 blocks of
    16 (or ``Hq``, ``Hkv``, ``nb``) under scattered tables.  Bytes: each valid position's K and
    V read once, q and the output, the table and lengths; operations: 4*d
    per (query head, valid position).  The yardstick is one SDPA call over
    the rows' KV gathered (outside the timing) to (B, Hkv, nb * bs, d) with
    a boolean length mask.  Returns the timings and the kernel's call
    (``time_kernels`` takes its device time once every event timing is
    done)."""
    import torch.nn.functional as F
    from repro_torch.serve.paged_attention import (paged_attention_cuda,
                                                   paged_attention_ref)
    B, bs = len(lens), 16
    q, kp, vp, table, lengths = paged_inputs(torch, B, Hq, Hkv, d, bs, nb,
                                             lens, dev, gen)
    scale = d ** -0.5
    kk = kp[table.long()].reshape(B, nb * bs, Hkv, d).transpose(1, 2)
    vv = vp[table.long()].reshape(B, nb * bs, Hkv, d).transpose(1, 2)
    kk, vv = (x.repeat_interleave(Hq // Hkv, 1).contiguous()
              for x in (kk, vv))
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


def time_prefill_kernel(torch, dev, gen, flush, case, d=None, **over):
    """#12 on the chunk ``PREFILL_CASES[case]`` (fp32): the slice's 256
    packed tokens in 4 segments of 64 with pasts 0, 256, 512, 960, or one
    segment of 256 at past 768; bs 16; ``d`` overrides the case's head
    dim (outside 32, 64, 128, 256: the wrapper's pad route) and ``over``
    any other field of the case.  Bytes: q and the output, and each
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
    kw = dict(PREFILL_CASES[case], **({} if d is None else {"d": d}), **over)
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
    times and the calls of #2 and the split #3 and #4 (for their device
    times, taken after every event timing)."""
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
    }, {"mosa_attention_fwd_res": lambda: mosa_attention_fwd_res_cuda(
        q, k, v, idx), "mosa_attention_bwd_dq": dq_call,
        "mosa_attention_bwd_dkv": dkv_call}


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


def serve_slice(torch, cfg=None, **server_kw):
    """Paged serving at full width through ``Server.generate``: batch 8,
    prompt 1024, 128 greedy tokens.  Expected launches over the counted
    generate: one MoSA prefill kernel per layer (#1, or #5 with block
    choice) and the paged decode kernel per layer and decode step.
    ``server_kw``: more ``Server`` arguments (a mesh).  Returns the
    server, the config, the prompts, the results and the tokens."""
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
                    paged=PagedConfig(block_size=16), seed=0, **server_kw)
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
    return server, cfg, prompts, res, toks


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
    caches with ``paged=False``): the prefill logits, the logits of G - 1
    decode steps and the G greedy tokens.  With block choice every layer's
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
            if hasattr(src.mixer, "dense_impl"):
                dst.mixer.dense_impl = src.mixer.dense_impl
    p = prompts[:1, :P]
    tg, cg = gpu.generate(p, G)
    tc, cc = cpu.generate(p, G)
    with torch.inference_mode():
        lg, kg = gpu.model.prefill(p.cuda(), gpu.new_cache())
        lc, kc = cpu.model.prefill(p, cpu.new_cache())
        err = (lg.cpu() - lc).abs().max().item()
        # the decode steps' logits, both fed the CPU's greedy tokens: a
        # repeated token (as a tied table's self-logit gives) still shows
        # a wrong decode path here
        derr = 0.0
        for t in range(G - 1):
            tok = tc[:, t:t + 1]
            lg, kg = gpu.model.decode_step(tok.cuda(), kg)
            lc, kc = cpu.model.decode_step(tok, kc)
            derr = max(derr, (lg.cpu() - lc).abs().max().item())
    log(f"  prefill logits max|gpu - cpu| {err:.3e}, {G - 1} decode steps' "
        f"{derr:.3e} (tol 1e-3); tokens gpu {tg[0].tolist()} cpu "
        f"{tc[0].tolist()}")
    if not err <= 1e-3:
        raise AssertionError(f"prefill logits differ by {err}")
    if not derr <= 1e-3:
        raise AssertionError(f"decode logits differ by {derr}")
    if not torch.equal(tg.cpu(), tc):
        raise AssertionError("greedy tokens differ between card and CPU")
    if cfg.mosa is not None and cfg.mosa.selection_granularity == "block":
        differ = [int((a["sparse"].bidx.cpu() != b["sparse"].bidx).any(-1)
                      .sum()) for a, b in zip(cg, cc)]
        log(f"  heads whose blocks differ, per layer: {differ}")
        if any(differ):
            raise AssertionError(f"block selections differ: {differ}")
    return dict(prefill=err, decode=derr)


# ------------------------------------------------------------- training
TRAIN_STEPS = 4             # the first is untimed


def train_slice(torch, remat="none", mesh=None, **mosa):
    """Full-width training through ``Trainer`` under the remat policy
    ``remat``: the counters are zeroed once the untimed first step has
    returned, and read after the last.  ``mosa`` overrides the MoSA config
    (block choice); ``mesh`` adds ``TrainConfig`` fields (``mesh_shape``,
    ``rule_set``, ``ckpt_dir``: [30])."""
    from repro_torch.train.loop import TrainConfig, Trainer
    cfg = TrainConfig(arch="mosa-paper", preset="full",
                      arch_kwargs={"variant": "mosa", **mosa}, seq_len=1024,
                      global_batch=64, microbatch=8, lr=2.5e-4,
                      clip_norm=0.25, steps=TRAIN_STEPS, mosa_impl="kernel",
                      remat=remat, log_every=1, seed=0, **(mesh or {}))
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

    step_peaks = []

    def first_step_uncounted(*args):
        out = step_fn(*args)
        calls["n"] += 1
        step_peaks.append(torch.cuda.max_memory_allocated())
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
    # S = k = 32 (token choice) or 2 blocks of 16: the fused backward; a
    # remat policy runs the training forward again in the backward
    names = (("mosa_block_attention_fwd_res", "mosa_block_attention_bwd")
             if mc.mosa.selection_granularity == "block"
             else ("mosa_attention_fwd_res", "mosa_attention_bwd"))
    want = want_launches(**{names[0]: per_layer * (1 + (remat != "none")),
                            names[1]: per_layer})
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
               step_peak_gib=max(step_peaks) / 2 ** 30,
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


def sched_slice(torch, cfg=None, window_blocks=0):
    """[11] and [26]: the timed full-width Scheduler run of ``cfg``
    (default the slice's model), after a warm pass; ``window_blocks``: the
    window pool of a model with window layers.  Paged kernels: one launch
    per paged dense layer (cache) and decode step or prefill chunk."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.launch.serve import Server
    from repro_torch.serve.paged_kv import PagedConfig, PagedDenseKVCache
    from repro_torch.serve.scheduler import Scheduler, _cache_leaves
    cfg = cfg or slice_config()
    server = Server(cfg, batch=8, max_len=SCHED_MAX_LEN,
                    paged=PagedConfig(block_size=SCHED_BS,
                                      num_blocks=SCHED_BLOCKS,
                                      num_window_blocks=window_blocks),
                    seed=0)
    kw = dict(chunk=8, chunk_tokens=256, max_prefill_segs=4)
    log(f"  Server(batch 8, max_len {SCHED_MAX_LEN}, {SCHED_BLOCKS} blocks "
        f"of {SCHED_BS}, {window_blocks} window blocks); Scheduler({kw}, "
        f"prefix_cache=True)")

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
    wpool = sched.window_pool
    if wpool is not None and wpool.free_blocks != wpool.num_blocks:
        raise AssertionError(f"window blocks leaked: {wpool.free_blocks} "
                             f"free of {wpool.num_blocks}")
    n_paged = sum(isinstance(x, PagedDenseKVCache)
                  for x in _cache_leaves(sched.caches))
    want = want_launches(
        paged_attention_decode=n_paged * decode_steps,
        paged_prefill_attention=n_paged * st["prefill_chunks"])
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
    pause_s = obs.registry().histogram("serve.pause_s").sum
    gen_tokens = sum(m for _, m in reqs)
    res = dict(wall_s=wall, requests=len(reqs), req_s=len(reqs) / wall,
               generated_tokens=gen_tokens, gen_tok_s=gen_tokens / wall,
               prompt_tokens=int(sum(len(p) for p, _ in reqs)),
               ttft_p50_s=ttft["p50"], ttft_p90_s=ttft["p90"],
               prefill_chunk_ms=1e3 * pre_s / n_pre,
               decode_chunk_ms=1e3 * dec_s / n_dec,
               prefill_chunks_s=pre_s, decode_chunks_s=dec_s,
               other_s=wall - pre_s - dec_s, decode_chunks=n_dec,
               pause_s=pause_s, pause_share=pause_s / wall,
               paged_dense_layers=n_paged,
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
        f"{res['other_s']:.2f} s; {res['pauses']} pauses ({pause_s:.2f} "
        f"s, {res['pause_share']:.3f} of the wall), {res['resumes']} "
        f"resumes")
    log(f"  stats {st}; packed efficiency {res['packed_efficiency']:.3f}; "
        f"peak device memory {res['peak_gib']:.3f} GiB")
    log(f"  launches over the run: {launches}")
    return server, res


def preempt_slice(torch, server):
    """[12] and [27]: 6 prompts of 1008 tokens (63 blocks), max_new 64, on
    127 blocks (and ``server``'s window pool): two rows fit, and the first
    decode growth past a block boundary runs the pool dry."""
    import numpy as np
    from repro_torch.launch.serve import Server
    from repro_torch.serve.paged_kv import PagedConfig
    from repro_torch.serve.scheduler import Scheduler
    tight = Server(server.model_cfg, batch=8, max_len=SCHED_MAX_LEN,
                   paged=PagedConfig(
                       block_size=SCHED_BS, num_blocks=127,
                       num_window_blocks=server.paged.num_window_blocks),
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
    for pool in (sched.dense_pool, sched.window_pool):
        if pool is not None and pool.free_blocks != pool.num_blocks:
            raise AssertionError(f"{pool.name} blocks leaked after "
                                 "preemption")
    log(f"  6 x 1008-token prompts, 64 tokens each, on 127 blocks: "
        f"{wall:.2f} s, stats {st}; every block back")
    return dict(wall_s=wall, stats=st)


def sched_cross_check(torch, server):
    """[13], [19] and [27]: the Scheduler on the card and on the CPU, the
    weights and config of ``server``."""
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
    # a window model's rings: two rows' worth (the 320-token prompt wraps)
    window_blocks = 2 * WINDOW // SCHED_BS if server.paged.num_window_blocks \
        else 0
    paged = PagedConfig(block_size=SCHED_BS, num_blocks=2 * max_len // 16,
                        num_window_blocks=window_blocks)
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
    """Two launches of ``kernel(dtype)`` (a tensor or a tuple) bitwise
    equal, fp32 and bf16."""
    for dt in (torch.float32, torch.bfloat16):
        a, b = kernel(dt), kernel(dt)
        a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
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
        stream_ms = out[pt.name]["mosa_kernels"].get("mosa_fwd_stream_kernel",
                                                     0.0)
        log(f"  the streaming forward #2 (mosa_fwd_stream_kernel): "
            f"{stream_ms:.3f} ms a microbatch")
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


# ------------------------------------- the window Scheduler ([26], [27])
WINDOW_SCHED_BLOCKS = 8 * WINDOW // SCHED_BS    # every row's whole ring


def window_stack_config():
    """[26]'s model: the JAX package's acceptance stack for the window pool
    (``hybrid_cfg`` of ``tests/test_paged_serving.py``: dense, window and
    MoSA layers in one stack) at the slice's widths: (attn, attn_local,
    mosa) x 2, the attention layers 9 heads of d 64, ``attn_local`` a ring
    of W 256, the MoSA layers 276 + 4 heads at sparsity 32, kernel path."""
    from repro_torch.configs.base import BlockSpec
    cfg = slice_config()
    unit = tuple(BlockSpec(m, "dense") for m in ("attn", "attn_local", "mosa"))
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-window-stack",
        attention=dataclasses.replace(cfg.attention, window=WINDOW),
        pattern=unit * (cfg.n_layers // 3))


def window_sched_slice(torch):
    """[26] and [27]: the window stack through the Scheduler at full width
    (dense pool as [11], a window pool of every row's whole ring), then
    preemption on a dense pool of 127 blocks, then the card against the
    CPU at [13]'s shapes (the 320-token prompt wraps the ring)."""
    cfg = window_stack_config()
    log(f"  {cfg.name}: {[s.mixer for s in cfg.pattern]}, attention "
        f"{cfg.attention.n_heads} heads of d {cfg.attention.d_head}, window "
        f"{cfg.attention.window}; MoSA {cfg.mosa.n_mosa_heads} + "
        f"{cfg.mosa.n_dense_heads} heads at sparsity {cfg.mosa.sparsity}")
    server, res = sched_slice(torch, cfg, WINDOW_SCHED_BLOCKS)
    log("[27] window stack: preemption, then card vs CPU")
    res["preempt"] = preempt_slice(torch, server)
    res["cross_check"] = sched_cross_check(torch, server)
    del server
    return res


# ------------------------------ the non-paged fallbacks ([28], [28b])
POOL_REQUESTS, POOL_MAX_NEW = 24, 32


def pool_requests(vocab, n, lo, hi, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


def request_pool_slice(torch):
    """[28]: ``RequestPool`` over the slice's model on a non-paged
    ``Server`` (batch 8, max_len 1152, decode chunks of 8): 24 seeded
    prompts of 100-1000 tokens (pow2 buckets 128-1024), 32 greedy tokens
    each, after a warm pass of two requests.  Exact: every request gets
    its 32 tokens; one MoSA prefill kernel (#1) per layer and admission
    (``prefill_one``), no other kernel (contiguous caches: the decode is
    plain PyTorch).  Then the pool on the card and the CPU (batch 2, 4
    requests of 70-300 tokens, 8 tokens each, deterministic algorithms):
    identical tokens."""
    from repro_torch.launch.serve import RequestPool, Server
    cfg = slice_config()
    server = Server(cfg, batch=8, max_len=SCHED_MAX_LEN, seed=0)
    warm = RequestPool(server, chunk=8)
    for p in pool_requests(cfg.vocab, 2, 100, 300, seed=8):
        warm.submit(p, 8)
    warm.run()
    prompts = pool_requests(cfg.vocab, POOL_REQUESTS, 100, 1000, seed=6)
    pool = RequestPool(server, chunk=8)
    rids = [pool.submit(p, POOL_MAX_NEW) for p in prompts]
    counters = kernel_counters()
    for c in counters.values():
        c.count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pool.run(max_steps=100_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.count for name, c in counters.items()}
    if [len(out[r]) for r in rids] != [POOL_MAX_NEW] * len(rids):
        raise AssertionError(f"lengths {[len(out[r]) for r in rids]}")
    want = want_launches(mosa_attention=cfg.n_layers * len(rids))
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    gen = POOL_MAX_NEW * len(rids)
    res = dict(wall_s=wall, requests=len(rids), generated_tokens=gen,
               gen_tok_s=gen / wall, req_s=len(rids) / wall,
               prompt_tokens=int(sum(len(p) for p in prompts)),
               launches=launches)
    log(f"  {len(rids)} requests ({res['prompt_tokens']} prompt tokens, "
        f"{gen} generated) in {wall:.2f} s: {res['req_s']:.2f} req/s, "
        f"{res['gen_tok_s']:.1f} generated tok/s; launches {launches}")
    del server

    state = None
    small = pool_requests(cfg.vocab, 4, 70, 300, seed=9)
    toks = {}
    with deterministic_algorithms(torch):
        for name, dev in (("gpu", None), ("cpu", "cpu")):
            srv = Server(cfg, batch=2, max_len=336, params=state, device=dev,
                         seed=0)
            if state is None:
                state = {k: v.detach().cpu()
                         for k, v in srv.model.state_dict().items()}
            p2 = RequestPool(srv, chunk=8)
            for p in small:
                p2.submit(p, 8)
            toks[name] = p2.run()
            del srv
    for rid in sorted(toks["cpu"]):
        log(f"  request {rid} ({len(small[rid])} tokens): gpu "
            f"{toks['gpu'][rid].tolist()} cpu {toks['cpu'][rid].tolist()}")
    if any(not torch.equal(toks["gpu"][r], toks["cpu"][r])
           for r in toks["cpu"]):
        raise AssertionError("RequestPool tokens differ between card and "
                             "CPU")
    res["cross_check"] = "identical tokens"
    return res


def stepwise_slice(torch):
    """[28b]: ``generate_stepwise`` (one decode step and one sample per
    token) at [5]'s shapes (batch 8, prompt 1024, 128 tokens, paged) beside
    ``generate`` on the same weights: identical tokens; exactly 6 launches
    of #1 and 6 x 127 of paged decode (#11) over the stepwise call.  Both
    run under ``deterministic_algorithms``: with ``index_add_``'s atomics
    two calls of ``generate`` itself can differ by a near-tied token."""
    from repro_torch.launch.serve import Server
    from repro_torch.serve.paged_kv import PagedConfig
    cfg = slice_config()
    B, P, G = 8, 1024, 128
    server = Server(cfg, batch=B, max_len=SCHED_MAX_LEN,
                    paged=PagedConfig(block_size=16), seed=0)
    prompts = torch.randint(2, cfg.vocab, (B, P),
                            generator=torch.Generator().manual_seed(1))

    def timed(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, _ = fn(prompts, n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, toks

    with deterministic_algorithms(torch):
        timed(server.generate, 2)                      # warm-up
        timed(server.generate_stepwise, 2)
        gen_s, want = timed(server.generate, G)
        counters = kernel_counters()
        for c in counters.values():
            c.count = 0
        step_s, got = timed(server.generate_stepwise, G)
        launches = {name: c.count for name, c in counters.items()}
    exp = want_launches(mosa_attention=cfg.n_layers,
                        paged_attention_decode=cfg.n_layers * (G - 1))
    if launches != exp:
        raise AssertionError(f"launch counts {launches} != {exp}")
    if not torch.equal(got, want):
        raise AssertionError("generate_stepwise tokens differ from "
                             "generate's")
    res = dict(stepwise_s=step_s, generate_s=gen_s,
               stepwise_tok_s=B * G / step_s, generate_tok_s=B * G / gen_s,
               launches=launches)
    log(f"  batch {B} x prompt {P} + {G} tokens: generate_stepwise "
        f"{step_s:.3f} s ({res['stepwise_tok_s']:.1f} tok/s), generate "
        f"{gen_s:.3f} s ({res['generate_tok_s']:.1f} tok/s); identical "
        f"tokens; launches {launches}")
    del server
    return res


# ------------------------------------------------ remat policies ([29])
REMAT_POLICIES = ("none", "full", "mosa", "dots_saveable")


@contextlib.contextmanager
def kept_by(policy):
    """Record which ops' outputs the selective remat ``policy`` keeps in the
    first forward (not the recompute): a list of (op, tag name)."""
    from repro_torch.nn import remat as remat_lib
    decide, kept = remat_lib.SELECTIVE[policy], []

    def recording(ctx, op, *args, **kwargs):
        out = decide(ctx, op, *args, **kwargs)
        if out == remat_lib.CheckpointPolicy.MUST_SAVE and \
                not ctx.is_recompute:
            kept.append((str(op), args[-1] if op in remat_lib.TAG_OPS
                         else None))
        return out

    remat_lib.SELECTIVE[policy] = recording
    try:
        yield kept
    finally:
        remat_lib.SELECTIVE[policy] = decide


@contextlib.contextmanager
def counted_ops():
    """Count the aten ops that run inside the block, by name."""
    from torch.utils._python_dispatch import TorchDispatchMode
    counts = {}

    class Counting(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[str(func)] = counts.get(str(func), 0) + 1
            return func(*args, **(kwargs or {}))

    with Counting():
        yield counts


def microbatch_peak_gib(torch, trainer):
    """Peak device memory of one training microbatch (8 x 1024: the loss,
    its backward) above what is allocated before it (weights, optimizer
    state): the activations a remat policy keeps, and the grads."""
    model, cfg = trainer.model, trainer.cfg
    mb = cfg.global_batch // cfg.microbatch
    batch = trainer.device_batch({k: v[:mb] for k, v in
                                  trainer.dataset.batch_at(0).items()})
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss, _ = model.loss(batch, with_health=True)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del loss, grads
    return peak / 2 ** 30


def remat_slice(torch):
    """[29]: [8]'s Trainer under each remat policy (4 steps, the first
    untimed): exact launches (the training forward twice under every
    policy but ``none``: forward and recompute), peak device memory over
    the run, the median step; then one microbatch's own peak memory and,
    under ``torch.profiler``, its wall and device time (as [10]).  Then,
    under deterministic algorithms, one
    1 x 256 loss and backward of one model per policy: the loss bitwise
    ``none``'s, every grad within 1e-6 of its tensor's max |grad|; under
    ``mosa`` exactly the two tagged tensors per layer kept and its
    backward (the recompute) one gather (aten ``index``) per layer short
    of ``full``'s, under ``dots_saveable`` only matrix products.  Gate:
    ``full`` and ``mosa`` below ``none`` in peak memory."""
    from repro_torch.data.pipeline import PackedLMDataset, SyntheticCorpus
    from repro_torch.nn.transformer import TransformerLM
    from repro_torch.train.step import with_remat
    out = {}
    for policy in REMAT_POLICIES:
        log(f"  remat {policy}:")
        trainer, res = train_slice(torch, remat=policy)
        out[policy] = {k: res[k] for k in ("step_ms", "tokens_per_s",
                                           "peak_gib", "step_ms_each",
                                           "losses", "launches_total")}
        out[policy]["microbatch_peak_gib"] = microbatch_peak_gib(torch,
                                                                 trainer)
        out[policy]["microbatch"] = profile_train(torch, trainer)
        del trainer
        torch.cuda.empty_cache()
    peaks = {p: out[p]["peak_gib"] for p in REMAT_POLICIES}
    log(f"  peak GiB over the run {peaks}; one microbatch's own peak GiB "
        f"{ {p: round(out[p]['microbatch_peak_gib'], 3) for p in REMAT_POLICIES} }"
        f"; step ms "
        f"{ {p: round(out[p]['step_ms'], 1) for p in REMAT_POLICIES} }")
    for p in ("full", "mosa"):
        if not peaks[p] < peaks["none"]:
            raise AssertionError(f"remat {p} peak {peaks[p]:.3f} GiB is not "
                                 f"below none's {peaks['none']:.3f}")

    cfg = slice_config()
    dev = torch.device("cuda")
    with torch.no_grad():
        model = TransformerLM(cfg, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(0))
    batch = PackedLMDataset(SyntheticCorpus(vocab=cfg.vocab, seed=1),
                            seq_len=256, global_batch=1).batch_at(0)
    batch = {k: torch.from_numpy(v).long().to(dev) for k, v in batch.items()}
    params = list(model.parameters())
    names = [k for k, _ in model.named_parameters()]
    ref, checks, gathers = None, {}, {}
    with deterministic_algorithms(torch):
        for policy in REMAT_POLICIES:
            model.cfg = with_remat(cfg, policy)
            with contextlib.ExitStack() as stack:
                kept = (stack.enter_context(kept_by(policy))
                        if policy in ("mosa", "dots_saveable") else None)
                loss, _ = model.loss(batch)
                with counted_ops() as ops:
                    grads = torch.autograd.grad(loss, params)
            gathers[policy] = ops.get("aten.index.Tensor", 0)
            if ref is None:
                ref = (loss.item(), grads)
                continue
            worst = max((((g - r).abs().max() / r.abs().max()).item(), k)
                        for k, g, r in zip(names, grads, ref[1]))
            checks[policy] = dict(loss=loss.item(), grad_rel=worst[0],
                                  kept=len(kept) if kept is not None else 0)
            log(f"  {policy}: loss {loss.item():.7f} (none "
                f"{ref[0]:.7f}); worst grad {worst[0]:.2e} in {worst[1]}"
                + (f"; kept {len(kept)} outputs of "
                   f"{sorted({op for op, _ in kept})}" if kept else ""))
            if loss.item() != ref[0]:
                raise AssertionError(f"remat {policy}: loss {loss.item()} "
                                     f"!= none's {ref[0]}")
            if not worst[0] <= 1e-6:
                raise AssertionError(f"remat {policy}: grad of {worst[1]} "
                                     f"differs by {worst[0]:.2e}")
            if policy == "mosa" and sorted(kept) != sorted(
                    [("repro_torch.checkpoint_gather.default", "mosa_gather"),
                     ("repro_torch.checkpoint_name.default", "mosa_router")]
                    * cfg.n_layers):
                raise AssertionError(f"remat mosa kept {kept}")
            if policy == "mosa" and \
                    gathers["mosa"] != gathers["full"] - cfg.n_layers:
                raise AssertionError(f"remat mosa gathers in its backward "
                                     f"{gathers['mosa']} times, full "
                                     f"{gathers['full']}: the recompute "
                                     f"should take the kept gathers")
            if policy == "dots_saveable" and not {op for op, _ in kept} <= {
                    "aten.mm.default", "aten.bmm.default",
                    "aten.addmm.default", "aten.baddbmm.default"}:
                raise AssertionError(f"remat dots_saveable kept {kept}")
    log(f"  token gathers (aten index) in the backward: {gathers}")
    out["cross_policy"] = checks
    out["backward_gathers"] = gathers
    del model
    return out


# ----------------------------------------- training on a mesh ([30]-[32])
MESH_DIR = ROOT / "build" / "mesh_train"
COMPRESS_FRAC = 0.01


def mesh_train_slice(torch, train):
    """[30]: [8]'s Trainer on a one-rank mesh (NCCL, world 1, mesh (1, 1)
    over data and model) under ``fsdp_tp`` and ``tp``, beside a plain
    Trainer of [8]'s configuration, all three under deterministic
    algorithms: ``index_add_``'s atomics make two runs of [8] itself
    differ (a near-tied top-k pick flips now and then, ~1e-5 on the loss),
    so the gate holds the mesh runs to the plain run of the same call:
    every loss and grad norm within 1e-6 relative (and whether bitwise);
    the relative differences to [8]'s own values are reported beside.
    Also exactly 144 launches each of #2 and the fused backward over the 3
    timed steps (0 of the split #3/#4 and of serving's kernels), a
    heartbeat file (the ``fsdp_tp`` run has a ``ckpt_dir``, so it also
    writes the gathered checkpoint at its end), the straggler summary;
    step ms and peak memory beside the plain run's and [8]'s.  Returns
    (the ``tp`` trainer, the last step's gradients after the dp
    reduction, results)."""
    import shutil
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.dist.parallel import TrainShards
    out = {}
    keys = ("losses", "grad_norms")
    reduce_grads = TrainShards.reduce_grads
    grads, calls = {}, {"n": 0}

    def recording(self, g):
        """Keep the last step's reduced gradients (only those: a copy kept
        from an earlier step would count in the next step's peak)."""
        red = reduce_grads(self, g)
        calls["n"] += 1
        if calls["n"] == TRAIN_STEPS:
            grads.update(red)
        return red

    with deterministic_algorithms(torch):
        log("  plain Trainer, [8]'s configuration (deterministic):")
        trainer, plain = train_slice(torch)
        out["plain"] = {k: plain[k] for k in (
            "step_ms", "step_ms_each", "tokens_per_s", "step_peak_gib",
            "losses", "grad_norms")}
        log("  one microbatch of the plain run, profiled:")
        out["plain"]["microbatch"] = profile_train(torch, trainer)
        del trainer
        torch.cuda.empty_cache()
        out["plain"]["rel_to_8"] = {k: max(abs(a - b) / abs(b) for a, b in
                                           zip(plain[k], train[k]))
                                    for k in keys}
        for rule_set in ("fsdp_tp", "tp"):
            mesh = dict(mesh_shape=(1, 1), rule_set=rule_set)
            if rule_set == "fsdp_tp":
                shutil.rmtree(MESH_DIR, ignore_errors=True)
                mesh["ckpt_dir"] = str(MESH_DIR)
            TrainShards.reduce_grads = recording
            calls["n"] = 0
            grads.clear()
            try:
                log(f"  rule set {rule_set} on a (1, 1) mesh "
                    "(deterministic):")
                trainer, res = train_slice(torch, mesh=mesh)
            finally:
                TrainShards.reduce_grads = reduce_grads
            ctx = trainer.ctx
            backend = torch.distributed.get_backend()
            if backend != "nccl" or ctx.world != 1:
                raise AssertionError(f"mesh run on {backend}, world "
                                     f"{ctx.world}")
            rel = {k: max(abs(a - b) / abs(b) for a, b in
                          zip(res[k], plain[k])) for k in keys}
            rel8 = {k: max(abs(a - b) / abs(b) for a, b in
                           zip(res[k], train[k])) for k in keys}
            bitwise = all(res[k] == plain[k] for k in keys)
            log(f"  vs the plain run: worst relative difference of the "
                f"losses {rel['losses']:.2e}, of the grad norms "
                f"{rel['grad_norms']:.2e}; bitwise equal: {bitwise} (vs "
                f"[8]'s own values: {rel8['losses']:.2e}, "
                f"{rel8['grad_norms']:.2e})")
            if not max(rel.values()) <= 1e-6:
                raise AssertionError(f"mesh {rule_set}: losses or grad "
                                     f"norms off the plain run by {rel}")
            summary = trainer.monitor.summary()
            log(f"  straggler summary: {summary}")
            entry = dict(rule_set=rule_set, step_ms=res["step_ms"],
                         step_ms_each=res["step_ms_each"],
                         tokens_per_s=res["tokens_per_s"],
                         peak_gib=res["peak_gib"],
                         step_peak_gib=res["step_peak_gib"],
                         losses=res["losses"], grad_norms=res["grad_norms"],
                         rel_to_plain=rel, bitwise_plain=bitwise,
                         rel_to_8=rel8, straggler=summary,
                         launches_total=res["launches_total"])
            if rule_set == "fsdp_tp":
                beat = MESH_DIR / "heartbeats" / "rank_0.json"
                hb = json.loads(beat.read_text())
                if hb["step"] != TRAIN_STEPS - 1 or hb["rank"] != 0:
                    raise AssertionError(f"heartbeat {hb}")
                entry["heartbeat"] = hb
                entry["checkpoint_step"] = ckpt_lib.latest_step(
                    str(MESH_DIR))
                if entry["checkpoint_step"] != TRAIN_STEPS:
                    raise AssertionError(
                        f"checkpoint at {entry['checkpoint_step']}")
                log(f"  heartbeat {hb}; checkpoint of full tensors at step "
                    f"{entry['checkpoint_step']}")
                shutil.rmtree(MESH_DIR, ignore_errors=True)
                del trainer
                torch.cuda.empty_cache()
            log(f"  step {res['step_ms']:.1f} ms (plain "
                f"{plain['step_ms']:.1f}, [8] {train['step_ms']:.1f}); peak "
                f"{res['step_peak_gib']:.3f} GiB through the last step "
                f"(plain {plain['step_peak_gib']:.3f}, [8] "
                f"{train['step_peak_gib']:.3f})")
            out[rule_set] = entry
        log("  one microbatch of the tp run, profiled:")
        out["tp"]["microbatch"] = profile_train(torch, trainer)
    return trainer, grads, out


def shard_selections(torch, sparse, x):
    from repro_torch.core.router import select_topk
    with torch.no_grad():
        scores = sparse.router.scores(x)
        _, idx = select_topk(scores, sparse.k_for(x.shape[1]),
                             sparse.cfg.force_first_token)
    return scores, idx


def tp_shards_slice(torch, m=4):
    """[31]: layer 0 of [8]'s model (4 dense + 276 MoSA heads, d_model 512)
    at 8 x 1024, fp32, the kernel route, split into ``model`` = 4 rank-local
    shards (1 dense + 69 MoSA heads: the raw ``tp`` placements of a (1, 4)
    mesh), each run through ``HybridAttention.local_forward`` (what a rank
    runs before its all-reduce) and its backward on the card.  Gates: #2
    and the fused backward launched exactly once per shard; identical
    selections (a difference only on an exact fp32 tie, printed with its
    router-score gap); the shards' outputs summed within 1e-5 relative of
    the unsharded layer; each shard's parameter grads within 1e-5 of the
    max |grad| of the matching slices of the unsharded grads."""
    import copy
    from repro_torch.data.pipeline import PackedLMDataset, SyntheticCorpus
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.parallel import TensorParallel, shard_model
    from repro_torch.nn.transformer import TransformerLM
    cfg = slice_config()
    dev = torch.device("cuda")
    with torch.no_grad():
        model = TransformerLM(cfg, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(0))
    batch = PackedLMDataset(SyntheticCorpus(vocab=cfg.vocab, seed=0),
                            seq_len=1024, global_batch=64).batch_at(0)
    tokens = torch.from_numpy(batch["tokens"][:8]).long().to(dev)
    layer = model.layers[0].mixer
    with torch.no_grad():
        x = model.layers[0].norm1(model.embed(tokens))
    dy = torch.randn(x.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(3))
    names = [k for k, _ in layer.named_parameters()]
    full = dict(layer.named_parameters())
    y = layer(x)
    want_g = dict(zip(names, torch.autograd.grad(
        y, [full[k] for k in names], dy)))
    scores, idx = shard_selections(torch, layer.sparse, x)
    mesh = {"data": 1, "model": m}
    specs = shd.resolve_specs(shd.param_shapes(layer), layer.specs(),
                              shd.mesh_rules(mesh, "tp"), mesh)
    counters = kernel_counters()
    want = want_launches(mosa_attention_fwd_res=1, mosa_attention_bwd=1)
    total, res, ties = torch.zeros_like(y), {"shards": []}, []
    for r in range(m):
        shard = shard_model(copy.deepcopy(layer), TensorParallel(None, r, m),
                            specs, {"data": 0, "model": r}, mesh)
        h = shard.sparse.router.w.shape[0]
        s_r, idx_r = shard_selections(torch, shard.sparse, x)
        ref_idx = idx[:, r * h:(r + 1) * h]
        diff = (idx_r != ref_idx).any(-1).nonzero().tolist()
        for b, hh in diff:
            a = set(idx_r[b, hh].tolist()) ^ set(ref_idx[b, hh].tolist())
            vals = s_r[b, hh, sorted(a)]
            gap = (vals.max() - vals.min()).item()
            ties.append(dict(shard=r, row=b, head=r * h + hh,
                             positions=sorted(a), gap=gap))
            log(f"  shard {r} row {b} head {r * h + hh}: selections differ "
                f"at {sorted(a)}, router-score gap {gap:.3e}")
        params = dict(shard.named_parameters())
        for c in counters.values():
            c.count = 0
        part = shard.local_forward(x)
        grads = torch.autograd.grad(part, [params[k] for k in names], dy)
        torch.cuda.synchronize()
        launches = {k: c.count for k, c in counters.items()}
        if launches != want:
            raise AssertionError(f"shard {r}: launches {launches} != {want}")
        total += part.detach()
        worst = (0.0, "")
        for k, g in zip(names, grads):
            sl = shd.local_slices(want_g[k].shape, specs[k], mesh,
                                  {"data": 0, "model": r})
            ref = want_g[k][sl]
            err = ((g - ref).abs().max() / ref.abs().max()).item()
            worst = max(worst, (err, k))
        res["shards"].append(dict(mosa_heads=h, dense_cols=shard.dense.q_cols,
                                  grad_rel=worst[0], worst_grad=worst[1],
                                  selection_diffs=len(diff)))
        log(f"  shard {r}: {h} MoSA heads, dense columns "
            f"{shard.dense.q_cols}; launches {launches}; worst grad "
            f"{worst[0]:.2e} ({worst[1]})")
        if not worst[0] <= 1e-5:
            raise AssertionError(f"shard {r}: grad of {worst[1]} off by "
                                 f"{worst[0]:.2e}")
        del shard, grads, part
    if any(t["gap"] != 0.0 for t in ties):
        raise AssertionError(f"selection flips without an exact tie: {ties}")
    out_rel = ((total - y.detach()).abs().max() / y.abs().max()).item()
    log(f"  sum of the {m} shards vs the unsharded layer: {out_rel:.2e} "
        f"relative; selection differences {len(ties)} (all exact ties)")
    if not out_rel <= 1e-5:
        raise AssertionError(f"shards sum off by {out_rel:.2e}")
    res.update(out_rel=out_rel, ties=ties)
    return res


def compress_slice(torch, grads):
    """[32]: ``compressed_all_reduce`` of the last [30] step's gradients on
    its NCCL group (world 1): per scheme, kept + residual is the gradient
    bit for bit and the reduction is kept; CUDA-event times of the
    compression and of the all-reduce."""
    from repro_torch.optim import grad_compression as gc
    n = sum(g.numel() for g in grads.values())
    out = {"values": n}

    def timed(fn):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        r = fn()
        e.record()
        torch.cuda.synchronize()
        return r, s.elapsed_time(e)

    _, out["none_ms"] = timed(lambda: gc.compressed_all_reduce(grads))
    for scheme in ("topk", "int8"):
        comp = ((lambda g: gc.topk_compress(g, COMPRESS_FRAC))
                if scheme == "topk" else gc.int8_compress)
        pairs, c_ms = timed(lambda: {k: comp(g) for k, g in grads.items()})
        kept = {k: p[0] for k, p in pairs.items()}
        (red, res), total_ms = timed(lambda: gc.compressed_all_reduce(
            grads, None, scheme, topk_frac=COMPRESS_FRAC))
        exact = all(torch.equal(kept[k] + res[k], grads[k]) for k in grads)
        same = all(torch.equal(red[k], kept[k]) for k in grads)
        nonzero = sum(int((kept[k] != 0).sum()) for k in grads)
        log(f"  {scheme}: compression {c_ms:.2f} ms, compression + "
            f"all-reduce {total_ms:.2f} ms over {n} values; kept + "
            f"residual == g bitwise: {exact}; reduction == kept: {same}; "
            f"{nonzero} values kept nonzero")
        if not (exact and same):
            raise AssertionError(f"{scheme}: kept + residual {exact}, "
                                 f"reduction {same}")
        out[scheme] = dict(compress_ms=c_ms, compress_all_reduce_ms=total_ms,
                           kept_nonzero=nonzero)
        del pairs, kept, red, res
    log(f"  plain all-reduce of the {n} values: {out['none_ms']:.2f} ms")
    return out


# ------------------------------------------------------ serving on a mesh
def world1_mesh(torch):
    """A (1, 1) mesh over ``data`` and ``model`` on the running world-1
    NCCL process group ([30]'s)."""
    from repro_torch.launch import mesh as mesh_lib
    if torch.distributed.get_backend() != "nccl":
        raise AssertionError(f"process group on "
                             f"{torch.distributed.get_backend()}")
    return mesh_lib.make_mesh((1, 1), ("data", "model"))


def mesh_serve_slice(torch, five):
    """[33]: [5]'s generate (paged, 8 x 1024 prompts, 128 greedy tokens) on
    a world-1 NCCL mesh (1, 1) under ``tp`` beside a plain ``Server`` in
    the same call, both under deterministic algorithms (``index_add_``'s
    atomics make two generates differ).  Gates: identical tokens; exactly
    [5]'s launches (6 of #1, 762 of #11, 0 of every other kernel, as
    ``serve_slice`` checks) for both.  Reports prefill ms and decode tok/s
    of both and one profiled decode step of each."""
    mesh = world1_mesh(torch)
    out, toks = {}, {}
    with deterministic_algorithms(torch):
        for name, kw in (("plain", {}),
                         ("mesh", dict(mesh=mesh, rule_set="tp"))):
            log(f"  {name} Server (deterministic):")
            server, _, prompts, res, toks[name] = serve_slice(torch, **kw)
            if name == "mesh" and (server.ctx is None
                                   or server.ctx.world != 1):
                raise AssertionError("the mesh Server has no mesh")
            if res["launches"] != five["launches"]:
                raise AssertionError(f"{name}: launches {res['launches']} "
                                     f"!= [5]'s {five['launches']}")
            log(f"  one decode step of the {name} Server, profiled:")
            res["decode_step"] = profile_decode(torch, server, prompts)
            out[name] = {k: res[k] for k in (
                "prefill_ms", "decode_tok_s", "decode_s", "generate_s",
                "peak_gib", "launches", "decode_step")}
            del server
            torch.cuda.empty_cache()
    same = torch.equal(toks["plain"], toks["mesh"])
    log(f"  tokens of the mesh Server == the plain Server's: {same}; "
        f"prefill {out['mesh']['prefill_ms']:.2f} ms (plain "
        f"{out['plain']['prefill_ms']:.2f}), decode "
        f"{out['mesh']['decode_tok_s']:.1f} tok/s (plain "
        f"{out['plain']['decode_tok_s']:.1f})")
    if not same:
        raise AssertionError("mesh Server tokens differ from the plain "
                             "Server's")
    out["tokens_equal"] = same
    return out


def mesh_sched_slice(torch, eleven):
    """[34]: [11]'s Scheduler traffic (32 requests, prefix cache, batch 8,
    576 blocks, 256-token chunks) in timed mode — an ``OpenLoopSource``
    whose 32 arrivals are all due at the start, which rank 0 reads (on a
    world of one no broadcast is needed), so the schedule is [11]'s — on a
    world-1 NCCL mesh under ``tp`` beside a plain ``Server``'s run, both
    under deterministic algorithms.  Gates: identical tokens and stats;
    every request its ``max_new``; exactly [11]'s launches (#11 and #12,
    0 of every other kernel) for both.  Reports the wall and the pause
    share of both."""
    from repro_torch import obs
    from repro_torch.launch.serve import Server
    from repro_torch.serve.loadgen import Arrival, OpenLoopSource
    from repro_torch.serve.paged_kv import PagedConfig
    from repro_torch.serve.scheduler import Scheduler
    cfg = slice_config()
    mesh = world1_mesh(torch)
    reqs = sched_requests(cfg.vocab)
    kw = dict(chunk=8, chunk_tokens=256, max_prefill_segs=4)
    runs = {}
    with deterministic_algorithms(torch):
        for name, skw in (("plain", {}),
                          ("mesh", dict(mesh=mesh, rule_set="tp"))):
            server = Server(cfg, batch=8, max_len=SCHED_MAX_LEN,
                            paged=PagedConfig(block_size=SCHED_BS,
                                              num_blocks=SCHED_BLOCKS),
                            seed=0, **skw)
            obs.set_enabled(True)
            obs.registry().reset()
            obs.tracer().reset()
            sched = Scheduler(server, prefix_cache=True, **kw)
            src = OpenLoopSource([Arrival(0.0, "", p, m) for p, m in reqs])
            counters = kernel_counters()
            for c in counters.values():
                c.count = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sched.run(max_steps=100_000, source=src)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: c.count for k, c in counters.items()}
            pause_s = obs.registry().histogram("serve.pause_s").sum
            toks = [out[rid] for rid in src.submitted_rids]
            for t, (_, m) in zip(toks, reqs):
                if len(t) != m:
                    raise AssertionError(f"{name}: {len(t)} tokens, want "
                                         f"{m}")
            if launches != eleven["launches"]:
                raise AssertionError(f"{name}: launches {launches} != "
                                     f"[11]'s {eleven['launches']}")
            runs[name] = dict(wall_s=wall, pause_s=pause_s,
                              pause_share=pause_s / wall,
                              stats=dict(sched.stats), launches=launches,
                              toks=toks)
            log(f"  {name}: {len(reqs)} requests in {wall:.2f} s, pauses "
                f"{pause_s:.2f} s ({pause_s / wall:.3f} of the wall); "
                f"stats {sched.stats}")
            del server, sched
            torch.cuda.empty_cache()
    same = all(torch.equal(a, b) for a, b in zip(runs["plain"].pop("toks"),
                                                  runs["mesh"].pop("toks")))
    stats_same = runs["plain"]["stats"] == runs["mesh"]["stats"]
    log(f"  mesh vs plain: identical tokens {same}, identical stats "
        f"{stats_same}; launches {runs['mesh']['launches']}")
    if not (same and stats_same):
        raise AssertionError(f"mesh Scheduler: tokens equal {same}, stats "
                             f"equal {stats_same}")
    runs["tokens_equal"], runs["stats_equal"] = same, stats_same
    return runs


class ThreadAllReduce:
    """``tp_all_reduce`` for ``n`` rank-local shards run in ``n`` threads of
    one process: each thread's tensor is put in its rank's slot, and after
    a barrier every thread takes the max or the sum of the slots in rank
    order (on the card's one stream, in launch order)."""

    def __init__(self, torch, n):
        import threading
        self.torch, self.slots = torch, [None] * n
        self.barrier = threading.Barrier(n, timeout=120)

    def __call__(self, t, tp, op="sum"):
        self.slots[tp.rank] = t
        self.barrier.wait()
        vals = self.torch.stack(self.slots)
        red = vals.amax(0) if op == "max" else vals.sum(0)
        self.barrier.wait()
        return t.copy_(red)


def rel_to(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def tp_serve_shards_slice(torch, m=4, dims=(8, 1024, 1152, 64, 8)):
    """[35]: layer 0 of [5]'s model served as ``model`` = 4 rank-local
    shards (1 dense + 69 MoSA heads each: the raw ``tp`` placements of a
    (1, 4) mesh, as [31]), each through ``local_prefill`` over 8 x 1024
    (``dims``: batch, prompt, max_len, chunk segment, decode steps), a
    packed chunk through ``local_prefill_packed`` (4 segments of 64
    tokens continuing rows 0-3) and 8 ``local_decode_step``s, on its own
    paged caches (identity tables, 1 KV head), beside the unsharded layer
    on the same inputs, under deterministic algorithms.  Gates: per shard
    exactly one #1 launch in the prefill, one #12 in the chunk and one #11
    per decode step; the shards' MoSA caches (idx, scores, k, v) the
    unsharded cache's head slices (idx identical; the values within 1e-6
    relative, and whether bitwise); the shards' outputs summed within
    1e-5 relative of the unsharded layer's at every stage.  The unsharded
    layer's router GEMM is cut into the shards' 4 head slices (see below;
    the rounding between the two is reported).  Then the dense side's
    ``seq_sharded`` decode: a
    contiguous cache of 1152 positions split into 4 slices of 288, each
    served by its own rank-local copy in a thread of its own (the
    all-reduces across the threads, ``ThreadAllReduce``), 4 steps: every
    copy's output within 1e-5 relative of the unsplit decode."""
    import copy
    import threading
    from repro_torch.core import attention as attn
    from repro_torch.core.kv_cache import DenseKVCache
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.parallel import TensorParallel, shard_model
    from repro_torch.nn.transformer import TransformerLM, packed_meta
    from repro_torch.serve.paged_kv import PagedConfig
    cfg = slice_config()
    dev = torch.device("cuda")
    B, P, L, SEG, STEPS = dims
    with torch.no_grad():
        model = TransformerLM(cfg, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(2, cfg.vocab, (B, P + SEG + STEPS),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    layer = model.layers[0].mixer
    with torch.inference_mode():
        x = model.layers[0].norm1(model.embed(tokens))
    x_pre, x_dec = x[:, :P], x[:, P + SEG:]
    x_chunk = x[:4, P:P + SEG].reshape(1, 4 * SEG, -1)
    meta = packed_meta([0, SEG, 2 * SEG, 3 * SEG, 4 * SEG], [0, 1, 2, 3],
                       [P] * 4, 4 * SEG, dev)
    paged = PagedConfig(16)
    counters = kernel_counters()

    def serve(mod, local):
        """(prefill, chunk, decode outputs, MoSA caches after each stage,
        launches of each stage) of ``mod`` on fresh caches."""
        pre, pk, dec = ((mod.local_prefill, mod.local_prefill_packed,
                         mod.local_decode_step) if local else
                        (mod.prefill, mod.prefill_packed, mod.decode_step))
        caches = mod.init_cache(B, L, torch.float32, paged=paged,
                                device=dev)
        outs, snaps, launches = [], [], []
        stages = [lambda c: pre(x_pre, c), lambda c: pk(x_chunk, c, meta)]
        stages += [lambda c, i=i: dec(x_dec[:, i:i + 1], c)
                   for i in range(STEPS)]
        with torch.inference_mode():
            for k, stage in enumerate(stages):
                for c in counters.values():
                    c.count = 0
                y, caches = stage(caches)
                torch.cuda.synchronize()
                launches.append({n: c.count for n, c in counters.items()
                                 if c.count})
                outs.append(y)
                if k in (0, 1, STEPS + 1):
                    snaps.append(tuple(t.clone() for t in caches["sparse"]))
        return outs, snaps, launches, caches

    # The unsharded layer's router scores come from one GEMM over its 276
    # heads, a shard's from one over its 69: cuBLAS rounds the two shapes
    # otherwise (~1e-7), which flips a pick at a near-tie and, at a top-k
    # or one-shot-width boundary, that pick's output.  The reference
    # therefore cuts its router GEMM as the shards do (the same products,
    # concatenated); the size of the rounding is reported.
    router, hs = layer.sparse.router, cfg.mosa.n_mosa_heads // m

    def sliced_scores(xx):
        return torch.cat([torch.sigmoid(torch.einsum(
            "bth,nh->bnt", xx.float(), router.w[r * hs:(r + 1) * hs]))
            for r in range(m)], 1)

    res = {"shards": []}
    with deterministic_algorithms(torch), torch.inference_mode():
        res["router_rounding"] = (router.scores(x_pre)
                                  - sliced_scores(x_pre)).abs().max().item()
    log(f"  router scores, one GEMM vs {m} head slices: max difference "
        f"{res['router_rounding']:.2e}")
    router.scores = sliced_scores
    with deterministic_algorithms(torch):
        try:
            ref, ref_snaps, ref_launches, _ = serve(layer, False)
        finally:
            del router.scores
        mesh = {"data": 1, "model": m}
        specs = shd.resolve_specs(shd.param_shapes(layer), layer.specs(),
                                  shd.mesh_rules(mesh, "tp"), mesh)
        total = [torch.zeros_like(y) for y in ref]
        want = ([{"mosa_attention": 1}, {"paged_prefill_attention": 1}]
                + [{"paged_attention_decode": 1}] * STEPS)
        shard_launches = {}
        ties = []
        for r in range(m):
            shard = shard_model(copy.deepcopy(layer),
                                TensorParallel(None, r, m), specs,
                                {"data": 0, "model": r}, mesh)
            outs, snaps, launches, caches = serve(shard, True)
            if launches != want:
                raise AssertionError(f"shard {r}: launches {launches} != "
                                     f"{want}")
            for lc in launches:
                for n, c in lc.items():
                    shard_launches[n] = shard_launches.get(n, 0) + c
            kv_heads = caches["dense"].k.shape[-2]
            h = shard.sparse.wq.shape[0]
            if kv_heads * m != 4 or h * m != cfg.mosa.n_mosa_heads:
                raise AssertionError(f"shard {r}: {kv_heads} KV heads, {h} "
                                     "MoSA heads")
            for t, y in zip(total, outs):
                t += y
            worst, bitwise = 0.0, True
            for stage, (got, full) in enumerate(zip(snaps, ref_snaps)):
                gi, gs, gk, gv = got[3], got[2], got[0], got[1]
                sl = slice(r * h, (r + 1) * h)
                wi, ws, wk, wv = (full[3][:, sl], full[2][:, sl],
                                  full[0][:, sl], full[1][:, sl])
                diff = (gi != wi).any(-1)
                for b, hh in diff.nonzero().tolist():
                    a = set(gi[b, hh].tolist()) ^ set(wi[b, hh].tolist())
                    ties.append(dict(shard=r, stage=stage, row=b,
                                     head=r * h + hh, positions=sorted(a)))
                ok = ~diff
                for g, w in ((gs, ws), (gk, wk), (gv, wv)):
                    fin = torch.isfinite(w) & ok.reshape(
                        ok.shape + (1,) * (w.dim() - ok.dim()))
                    gg = torch.where(fin, g, 0.0)
                    ww = torch.where(fin, w, 0.0)
                    bitwise &= bool(torch.equal(gg, ww))
                    worst = max(worst, rel_to(gg, ww))
            res["shards"].append(dict(mosa_heads=h, kv_heads=kv_heads,
                                      dense_cols=shard.dense.q_cols,
                                      cache_rel=worst, cache_bitwise=bitwise,
                                      launches=launches))
            log(f"  shard {r}: {h} MoSA heads, {kv_heads} KV head (columns "
                f"{shard.dense.q_cols}); launches per stage as wanted; its "
                f"MoSA caches vs the unsharded slices: worst {worst:.2e} "
                f"relative, bitwise {bitwise}")
            if not worst <= 1e-6:
                raise AssertionError(f"shard {r}: MoSA cache off by "
                                     f"{worst:.2e}")
            del shard, caches
        if ties:
            log(f"  selection differences: {ties}")
            raise AssertionError(f"MoSA selections differ: {ties}")
        rel = [rel_to(t, y) for t, y in zip(total, ref)]
        log(f"  sum of the {m} shards vs the unsharded layer: prefill "
            f"{rel[0]:.2e}, chunk {rel[1]:.2e}, decode steps worst "
            f"{max(rel[2:]):.2e} relative")
        if not max(rel) <= 1e-5:
            raise AssertionError(f"shards' sums off by {rel}")
        res.update(out_rel=rel, launches_unsharded=ref_launches,
                   launches_total=shard_launches)

        # the dense side's seq-sharded decode, 4 position slices
        dense, n_seq = layer.dense, min(4, STEPS)
        cache = DenseKVCache.create(B, L, 4, cfg.mosa.d_head, torch.float32,
                                    dev)
        with torch.inference_mode():
            _, cache = dense.prefill(x_pre, cache)
            unsplit = DenseKVCache(*(t.clone() for t in cache))
            want_y = []
            for i in range(n_seq):
                y, unsplit = dense.decode_step(x_dec[:, i:i + 1], unsplit)
                want_y.append(y)
        n = L // m
        mods, slices = [], []
        for r in range(m):
            mod = copy.deepcopy(dense)
            mod.mesh_tp, mod.seq_sharded = TensorParallel(None, r, m), True
            mods.append(mod)
            slices.append(DenseKVCache(cache.k[:, r * n:(r + 1) * n].clone(),
                                       cache.v[:, r * n:(r + 1) * n].clone(),
                                       cache.length.clone()))
        results, errors = [None] * m, []

        def worker(r):
            try:
                with torch.inference_mode():
                    c, ys = slices[r], []
                    if mods[r]._serve_mode(c) != "seq":
                        raise AssertionError("not a seq-sharded decode")
                    for i in range(n_seq):
                        y, c = mods[r].decode_step(x_dec[:, i:i + 1], c)
                        ys.append(y)
                    results[r] = ys
            except BaseException as e:          # noqa: BLE001
                errors.append((r, repr(e)))

        reduce, attn.tp_all_reduce = attn.tp_all_reduce, ThreadAllReduce(
            torch, m)
        try:
            threads = [threading.Thread(target=worker, args=(r,))
                       for r in range(m)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            attn.tp_all_reduce = reduce
        if errors:
            raise AssertionError(f"seq-sharded decode: {errors}")
        seq_rel = max(rel_to(y, w) for ys in results
                      for y, w in zip(ys, want_y))
        log(f"  seq_sharded dense decode, {m} slices of {n} positions, "
            f"{n_seq} steps: worst {seq_rel:.2e} relative to the unsplit "
            "decode")
        if not seq_rel <= 1e-5:
            raise AssertionError(f"seq-sharded decode off by {seq_rel:.2e}")
        res["seq_rel"] = seq_rel
    del model
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------- wide-head kernels ([36])
# Head dims over 128 take each family's wide route (csrc/wide_attention.cu,
# the inputs zero-padded to 256); [36] holds all 12 kernels at these dims.
WIDE_DIMS = (160, 192, 256)
# gemma3-4b-mosa32's MoSA rows in prefill: batch 4 x 32 heads, k = 2048 /
# 32 = 64 selected tokens of width 256
WIDE_MOSA = dict(B=4, H=32, S=64, T=2048)
WIDE_BLOCK = dict(B=4, H=32, NB=4, bs=16, T=2048)
# gemma3-4b's #9 shape: batch 4 x 8 query heads (4 KV heads) x 2048 tokens
WIDE_FLASH = (4, 8, 4, 2048)
WIDE_WINDOW = 1024
# #11 at gemma3-4b's decode: 4 rows of 2080 positions (2048 + 32), pages 16
WIDE_DECODE = dict(B=4, Hq=8, Hkv=4, bs=16, nb=130, lengths=[2080] * 4)
# #12 at one Scheduler chunk of gemma3-4b: [11]'s chunk of 4 segments
WIDE_PREFILL = dict(PREFILL_CASES[PREFILL_SLICE], Hq=8, Hkv=4)


def wide_mosa_cases(d):
    return {f"(4,32,64) as gemma3-4b-mosa32, -1 keys, d={d}": dict(
                WIDE_MOSA, d=d, neg_keys=5),
            f"S 128 unsorted, segments, -1 keys, d={d}": dict(
                B=1, H=4, S=128, T=1024, d=d, unsorted=True, with_seg=True,
                neg_keys=9),
            f"S 70, r = 0 rows, d={d}": dict(B=2, H=3, S=70, T=300, d=d,
                                              zero_rows=3)}


def wide_block_cases(d):
    return {f"4x32 rows NB 4 bs 16, ragged T, d={d}": dict(
                WIDE_BLOCK, T=2041, d=d),
            f"NB 5 bs 13, empty blocks, two segments, d={d}": dict(
                B=1, H=4, NB=5, bs=13, T=200, d=d, empty=3, two_segs=True)}


def check_wide_mosa(torch, dev, gen, errs, d):
    """#1-#4 at head dim d on the wide route: the forwards against their
    plain versions, the split backward on the plain forward's g~, lse and
    delta; each wrapper call one count, two launches bitwise equal."""
    from repro_torch.kernels import mosa_attention as km
    from repro_torch.kernels import mosa_backward as kb
    for case, kw in wide_mosa_cases(d).items():
        if km.fwd_route(kw["S"], d) != "wide":
            raise AssertionError(f"({kw['S']}, {d}) is not on the wide route")
        q, k, v, idx, r, seg = mosa_inputs(torch, dev=dev, gen=gen, **kw)
        g = torch.randn(q.shape, device=dev, generator=gen)

        def fwd(dt):
            return counted_once(km.LAUNCHES, lambda: km.mosa_attention_cuda(
                q.to(dt), k.to(dt), v.to(dt), idx, r, seg=seg),
                f"mosa_attention ({case})")

        def res(dt):
            return counted_once(
                km.LAUNCHES_FWD_RES, lambda: km.mosa_attention_fwd_res_cuda(
                    q.to(dt), k.to(dt), v.to(dt), idx, seg=seg),
                f"mosa_attention_fwd_res ({case})")

        check_case(torch, fwd, lambda dt: km.mosa_attention_ref(
            *(t.to(dt).float() for t in (q, k, v)), idx, r, seg=seg),
            "mosa_attention", case, errs)
        check_case(torch, res, lambda dt: km.mosa_attention_fwd_res_ref(
            *(t.to(dt).float() for t in (q, k, v)), idx, seg=seg),
            "mosa_attention_fwd_res", case, errs, ("o_pre", "lse"))

        def bwd_args(dt, cast):
            qq, kk, vv = (cast(t.to(dt)) for t in (q, k, v))
            o_pre, lse = km.mosa_attention_fwd_res_ref(
                *(t.float() for t in (qq, kk, vv)), idx, seg=seg)
            gt = (g * r[..., None]).contiguous()
            return (qq, kk, vv, idx, gt, lse,
                    (gt * o_pre).sum(-1).contiguous())

        def split(dt):
            args = bwd_args(dt, lambda t: t)
            dq = counted_once(kb.LAUNCHES_DQ, lambda: kb.mosa_attention_bwd_dq_cuda(
                *args, seg=seg), f"mosa_attention_bwd_dq ({case})")
            dk, dv = counted_once(
                kb.LAUNCHES_DKV, lambda: kb.mosa_attention_bwd_dkv_cuda(
                    *args, seg=seg), f"mosa_attention_bwd_dkv ({case})")
            return dq, dk, dv

        check_case(torch, split, lambda dt: kb.mosa_attention_bwd_ref(
            *bwd_args(dt, lambda t: t.float()), seg=seg),
            "mosa_attention_bwd[split]", case, errs, ("dq", "dk", "dv"))
        for name, fn in (("mosa_attention", fwd), ("fwd_res", res),
                         ("bwd", split)):
            check_twice(torch, name, case, fn)


def check_wide_block(torch, dev, gen, errs, d):
    """#5-#8 at head dim d on the wide route, as ``check_wide_mosa``;
    invalid query rows exact zeros."""
    from repro_torch.kernels import mosa_block as kb
    for case, kw in wide_block_cases(d).items():
        q, k, v, bidx, rblk, seg = block_inputs(torch, dev=dev, gen=gen,
                                                **kw)
        bs, T = kw["bs"], kw["T"]
        _, ok = kb.expand_blocks(bidx, bs, T)
        g = torch.randn(q.shape, device=dev, generator=gen)

        def fwd(dt):
            out = counted_once(kb.LAUNCHES, lambda: kb.mosa_block_attention_cuda(
                q.to(dt), k.to(dt), v.to(dt), bidx, rblk, bs, T, seg=seg),
                f"mosa_block_attention ({case})")
            if (out[~ok] != 0).any():
                raise AssertionError(f"mosa_block_attention ({case}): "
                                     "invalid query rows not zero")
            return out

        def res(dt):
            return counted_once(
                kb.LAUNCHES_FWD_RES,
                lambda: kb.mosa_block_attention_fwd_res_cuda(
                    q.to(dt), k.to(dt), v.to(dt), bidx, bs, T, seg=seg),
                f"mosa_block_attention_fwd_res ({case})")

        check_case(torch, fwd, lambda dt: kb.mosa_block_attention_ref(
            *(t.to(dt).float() for t in (q, k, v)), bidx, rblk, bs, T,
            seg=seg), "mosa_block_attention", case, errs)
        check_case(torch, res, lambda dt: kb.mosa_block_attention_fwd_res_ref(
            *(t.to(dt).float() for t in (q, k, v)), bidx, bs, T, seg=seg),
            "mosa_block_attention_fwd_res", case, errs, ("o_pre", "lse"))

        def bwd_args(dt, cast):
            qq, kk, vv = (cast(t.to(dt)) for t in (q, k, v))
            o_pre, lse = kb.mosa_block_attention_fwd_res_ref(
                *(t.float() for t in (qq, kk, vv)), bidx, bs, T, seg=seg)
            gt = torch.where(ok[..., None], kb.scale_rows(g, rblk, bs),
                             0.0).contiguous()
            return (qq, kk, vv, bidx, gt, lse,
                    (gt * o_pre).sum(-1).contiguous(), bs, T)

        def split(dt):
            args = bwd_args(dt, lambda t: t)
            dq = counted_once(
                kb.LAUNCHES_DQ, lambda: kb.mosa_block_attention_bwd_dq_cuda(
                    *args, seg=seg), f"mosa_block_attention_bwd_dq ({case})")
            dk, dv = counted_once(
                kb.LAUNCHES_DKV,
                lambda: kb.mosa_block_attention_bwd_dkv_cuda(*args, seg=seg),
                f"mosa_block_attention_bwd_dkv ({case})")
            return dq, dk, dv

        check_case(torch, split, lambda dt: kb.mosa_block_attention_bwd_ref(
            *bwd_args(dt, lambda t: t.float()), seg=seg),
            "mosa_block_attention_bwd[split]", case, errs, ("dq", "dk", "dv"))
        for name, fn in (("mosa_block_attention", fwd),
                         ("block fwd_res", res), ("block bwd", split)):
            check_twice(torch, name, case, fn)


def check_wide_dense(torch, dev, gen, errs, d):
    """#9-#12 at head dim d on the wide route: flash (GQA, q_offset,
    windows, gemma3-4b's 4 x 2048 at W 1024 and causal), varlen (a padding
    tail exact zeros), paged decode (GQA 2, 6, 7 and 1, a row of length 0
    exact zeros, gemma3-4b's and gemma3-4b-mosa32's 2080 positions) and
    packed prefill ([3]'s edges, gemma3-4b's chunk); each wrapper call one
    count, two launches bitwise equal."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.serve import paged_attention as kp
    for case, (B, Hq, Hkv, Tq, Tk, W) in {
            f"GQA 8/4, T 300, W 100, d={d}": (2, 8, 4, 300, 300, 100),
            f"Tq 77 < Tk 200, GQA 4/2, causal, d={d}": (1, 4, 2, 77, 200, 0),
            f"Tq 1 < Tk 300, W 64, d={d}": (1, 2, 2, 1, 300, 64),
            f"gemma3-4b 4 x 8/4 x 2048, W {WIDE_WINDOW}, d={d}": (
                *WIDE_FLASH, WIDE_FLASH[3], WIDE_WINDOW),
            f"gemma3-4b 4 x 8/4 x 2048, causal, d={d}": (
                *WIDE_FLASH, WIDE_FLASH[3], 0)}.items():
        q = torch.randn(B, Hq, Tq, d, device=dev, generator=gen)
        k, v = (torch.randn(B, Hkv, Tk, d, device=dev, generator=gen)
                for _ in range(2))

        def flash(dt):
            return counted_once(kf.LAUNCHES, lambda: kf.flash_attention_cuda(
                q.to(dt), k.to(dt), v.to(dt), window=W),
                f"flash_attention ({case})")

        check_case(torch, flash, lambda dt: kf.flash_attention_ref(
            *(x.to(dt).float() for x in (q, k, v)), window=W),
            "flash_attention", case, errs)
        check_twice(torch, "flash_attention", case, flash)
    for case, (lens, total, Hq, Hkv, W) in {
            f"W 8, GQA 8/2, pad tail, d={d}": ([40, 1, 70, 9], 128, 8, 2, 8),
            f"one segment, causal, d={d}": ([200], 200, 2, 2, 0)}.items():
        q, k, v, cu = varlen_inputs(torch, dev, gen, lens, total, Hq, Hkv, d)

        def varlen(dt):
            out = counted_once(
                kf.LAUNCHES_VARLEN, lambda: kf.flash_attention_varlen_cuda(
                    q.to(dt), k.to(dt), v.to(dt), cu, window=W),
                f"flash_attention_varlen ({case})")
            if (out[sum(lens):] != 0).any():
                raise AssertionError(f"flash_attention_varlen ({case}): "
                                     "padding tail not zero")
            return out

        check_case(torch, varlen, lambda dt: kf.flash_attention_varlen_ref(
            *(x.to(dt).float() for x in (q, k, v)), cu, window=W),
            "flash_attention_varlen", case, errs)
        check_twice(torch, "flash_attention_varlen", case, varlen)
    for case, kw in {
            f"gemma3-4b decode 4 x 2080, GQA 8/4, d={d}": WIDE_DECODE,
            f"gemma3-4b-mosa32 dense side 4 x 2080, 4/4 (R 1), d={d}": dict(
                WIDE_DECODE, Hq=4, Hkv=4),
            f"GQA 14/2 (R 7), a row of length 0, d={d}": dict(
                B=3, Hq=14, Hkv=2, bs=16, nb=9, lengths=[0, 130, 1],
                neg_tail=True),
            f"GQA 12/2 (R 6) bs 8, d={d}": dict(
                B=2, Hq=12, Hkv=2, bs=8, nb=20, lengths=[77, 160])}.items():
        q, kpool, vpool, table, lengths = paged_inputs(
            torch, d=d, dev=dev, gen=gen, **kw)
        scale = d ** -0.5
        empty = lengths == 0

        def decode(dt):
            out = counted_once(kp.LAUNCHES, lambda: kp.paged_attention_cuda(
                q.to(dt), kpool.to(dt), vpool.to(dt), table, lengths, scale),
                f"paged_attention_decode ({case})")
            if (out[empty] != 0).any():
                raise AssertionError(f"paged_attention_decode ({case}): a "
                                     "row of length 0 is not zero")
            return out

        def plain(dt):
            out = kp.paged_attention_ref(
                *(t.to(dt).float() for t in (q, kpool, vpool)), table,
                lengths, scale)
            return torch.where(empty[:, None, None], 0.0, out)

        check_case(torch, decode, plain, "paged_attention_decode", case, errs)
        check_twice(torch, "paged_attention_decode", case, decode)
    for case, kw in {
            f"gemma3-4b chunk 4 segs GQA 8/4, d={d}": WIDE_PREFILL,
            f"edges, GQA 8/2 bs 4, d={d}": dict(
                Hq=8, Hkv=2, bs=4, nb=6, segs=PREFILL_EDGE_SEGS, total=24),
            f"GQA 14/2 bs 16, shared prefix, d={d}": dict(
                Hq=14, Hkv=2, bs=16, nb=40,
                segs=[(0, 256, 9), (1, 255, 12), (2, 639, 1)], total=32,
                share=10)}.items():
        q, kpool, vpool, table, cu, rows, past = prefill_inputs(
            torch, dev, gen, **dict(kw, d=d))
        _, _, row_of_tok, pos = kp.packed_token_layout(cu, rows, past,
                                                       q.shape[0])
        scale = d ** -0.5

        def prefill(dt):
            out = counted_once(
                kp.LAUNCHES_PREFILL, lambda: kp.paged_prefill_attention_cuda(
                    q.to(dt), kpool.to(dt), vpool.to(dt), table, cu, rows,
                    past, scale), f"paged_prefill_attention ({case})")
            if (out[row_of_tok < 0] != 0).any():
                raise AssertionError(f"paged_prefill_attention ({case}): "
                                     "padding/inactive tokens not zero")
            return out

        check_case(torch, prefill, lambda dt: kp.paged_prefill_attention_ref(
            *(t.to(dt).float() for t in (q, kpool, vpool)), table,
            row_of_tok, pos, scale), "paged_prefill_attention", case, errs)
        check_twice(torch, "paged_prefill_attention", case, prefill)


def check_wide_kernels(torch, dev):
    """[36]: all 12 kernels at head dims 160, 192 and 256 against their
    plain versions, fp32 and bf16, under [3]'s tolerances.  Returns the
    largest fp32 error of each kernel at d 256, by the names of the
    ``kernels`` line (the routed backward at d 256 is the split pair)."""
    gen = torch.Generator(device=dev).manual_seed(36)
    for d in WIDE_DIMS:
        log(f"  -- head dim {d} (the wide route, padded to 256)")
        e = {}
        check_wide_mosa(torch, dev, gen, e, d)
        check_wide_block(torch, dev, gen, e, d)
        check_wide_dense(torch, dev, gen, e, d)
    def m(label):
        return e[f"{label}@max"]

    out = {name: m(name) for name in (
        "mosa_attention", "mosa_block_attention", "flash_attention",
        "flash_attention_varlen", "paged_attention_decode",
        "paged_prefill_attention")}
    for stem in ("mosa_attention", "mosa_block_attention"):
        split = {p: m(f"{stem}_bwd[split].{p}") for p in ("dq", "dk", "dv")}
        out[f"{stem}_fwd_res"] = max(m(f"{stem}_fwd_res.o_pre"),
                                     m(f"{stem}_fwd_res.lse"))
        out[f"{stem}_bwd"] = max(split.values())     # routed: the split pair
        out[f"{stem}_bwd_dq"] = split["dq"]
        out[f"{stem}_bwd_dkv"] = max(split["dk"], split["dv"])
    return out


def time_wide_kernels(torch, dev):
    """[36]'s times at d 256 (fp32, L2 flushed before every launch, as
    [4]): each kernel, its plain version and SDPA at the same shape (with
    the boolean mask of this run's pairs; the backward's yardstick is
    SDPA's backward, which computes dq, dk and dv), and the bound from
    bytes (each input read once, each output written once) and operations
    (4*d per visible pair and head forward, 6*d / 8*d / 10*d for dq, dk+dv,
    all three).  Shapes: #1-#4 at gemma3-4b-mosa32's (4, 32, 64, 256), #2-
    #4 also at S 128; #5-#8 at 4 x 32 rows of 4 blocks of 16; #9 at (4, 8,
    2048, 256) with 4 KV heads at W 1024 and causal; #10 over [4]'s eight
    seeded prompts, 8 heads (4 KV), W 1024; #11 at 4 rows of 2080
    positions, GQA 8/4, pages of 16; #12 at [11]'s chunk of 4 segments,
    GQA 8/4."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import mosa_attention as km
    from repro_torch.kernels import mosa_backward as kb
    from repro_torch.kernels import mosa_block as kbl
    gen = torch.Generator(device=dev).manual_seed(37)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    d, out = 256, {}

    def put(name, shape, call, plain, library, nbytes, flops):
        out[name] = dict(shape=shape, ms=time_ms(torch, call, flush=flush),
                         plain_ms=time_ms(torch, plain, flush=flush),
                         library_ms=time_ms(torch, library, flush=flush),
                         bytes=nbytes, flops=flops)

    def sdpa_pair(q, k, v, mask, g):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        y = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        return (lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=mask),
                lambda: torch.autograd.grad(y, leaves, g, retain_graph=True))

    B, H = WIDE_MOSA["B"], WIDE_MOSA["H"]
    for tag, S in (("", 64), ("[S 128]", 128)):
        q, k, v, idx, r, _ = mosa_inputs(torch, B, H, S, d, 2048, dev, gen)
        mask = km.pair_mask(idx, idx, idx >= 0, None)
        pairs, shape = int(mask.sum()), f"({B},{H},{S},{d})"
        vec, row = B * H * S * d * 4, B * H * S * 4
        o_pre, lse = km.mosa_attention_fwd_res_cuda(q, k, v, idx)
        g = torch.randn(q.shape, device=dev, generator=gen)
        gt = (g * r[..., None]).contiguous()
        args = (q, k, v, idx, gt, lse, (gt * o_pre).sum(-1).contiguous())
        fwd, bwd = sdpa_pair(q, k, v, mask, g)
        if not tag:
            put("mosa_attention", shape,
                lambda: km.mosa_attention_cuda(q, k, v, idx, r),
                lambda: km.mosa_attention_ref(q, k, v, idx, r), fwd,
                4 * vec + 2 * row, 4 * pairs * d)
        put(f"mosa_attention_fwd_res{tag}", shape,
            lambda: km.mosa_attention_fwd_res_cuda(q, k, v, idx),
            lambda: km.mosa_attention_fwd_res_ref(q, k, v, idx), fwd,
            4 * vec + 2 * row, 4 * pairs * d)
        plain = (lambda: kb.mosa_attention_bwd_ref(*args))
        put(f"mosa_attention_bwd{tag}", shape,
            lambda: kb.mosa_attention_bwd_cuda(*args), plain, bwd,
            7 * vec + 3 * row, 10 * pairs * d)
        put(f"mosa_attention_bwd_dq{tag}", shape,
            lambda: kb.mosa_attention_bwd_dq_cuda(*args), plain, bwd,
            5 * vec + 3 * row, 6 * pairs * d)
        put(f"mosa_attention_bwd_dkv{tag}", shape,
            lambda: kb.mosa_attention_bwd_dkv_cuda(*args), plain, bwd,
            6 * vec + 3 * row, 8 * pairs * d)

    kw = dict(WIDE_BLOCK, d=d)
    q, k, v, bidx, rblk, _ = block_inputs(torch, dev=dev, gen=gen, **kw)
    NB, bs, T = kw["NB"], kw["bs"], kw["T"]
    pos, ok = kbl.expand_blocks(bidx, bs, T)
    mask = (pos[..., :, None] >= pos[..., None, :]) & ok[..., None, :]
    S = NB * bs
    pairs, shape = int(mask.sum()), f"({B},{H}) NB {NB} bs {bs} d {d}"
    vec, row, blk = B * H * S * d * 4, B * H * S * 4, B * H * NB * 4
    o_pre, lse = kbl.mosa_block_attention_fwd_res_cuda(q, k, v, bidx, bs, T)
    g = torch.randn(q.shape, device=dev, generator=gen)
    gt = torch.where(ok[..., None], g, 0.0).contiguous()
    args = (q, k, v, bidx, gt, lse, (gt * o_pre).sum(-1).contiguous(), bs, T)
    fwd, bwd = sdpa_pair(q, k, v, mask, g)
    plain = (lambda: kbl.mosa_block_attention_bwd_ref(*args))
    put("mosa_block_attention", shape,
        lambda: kbl.mosa_block_attention_cuda(q, k, v, bidx, rblk, bs, T),
        lambda: kbl.mosa_block_attention_ref(q, k, v, bidx, rblk, bs, T),
        fwd, 4 * vec + 2 * blk, 4 * pairs * d)
    put("mosa_block_attention_fwd_res", shape,
        lambda: kbl.mosa_block_attention_fwd_res_cuda(q, k, v, bidx, bs, T),
        lambda: kbl.mosa_block_attention_fwd_res_ref(q, k, v, bidx, bs, T),
        fwd, 4 * vec + row + blk, 4 * pairs * d)
    put("mosa_block_attention_bwd", shape,
        lambda: kbl.mosa_block_attention_bwd_cuda(*args), plain, bwd,
        7 * vec + 2 * row + blk, 10 * pairs * d)
    put("mosa_block_attention_bwd_dq", shape,
        lambda: kbl.mosa_block_attention_bwd_dq_cuda(*args), plain, bwd,
        5 * vec + 2 * row + blk, 6 * pairs * d)
    put("mosa_block_attention_bwd_dkv", shape,
        lambda: kbl.mosa_block_attention_bwd_dkv_cuda(*args), plain, bwd,
        6 * vec + 2 * row + blk, 8 * pairs * d)

    B, Hq, Hkv, T = WIDE_FLASH
    q = torch.randn(B, Hq, T, d, device=dev, generator=gen)
    k, v = (torch.randn(B, Hkv, T, d, device=dev, generator=gen)
            for _ in range(2))
    ke, ve = (x.repeat_interleave(Hq // Hkv, 1) for x in (k, v))
    p_ = torch.arange(T, device=dev)
    for name, W in (("flash_attention", WIDE_WINDOW),
                    ("flash_attention[causal]", 0)):
        mask = flash_pairs(p_, p_, W)
        put(name, f"({B},{Hq}/{Hkv},{T},{d}) W {W}",
            lambda: kf.flash_attention_cuda(q, k, v, window=W),
            lambda: kf.flash_attention_ref(q, k, v, window=W),
            lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                   attn_mask=mask),
            2 * B * (Hq + Hkv) * T * d * 4, 4 * d * B * Hq * int(mask.sum()))
    lens = varlen_slice_lengths()
    total = sum(lens)
    q, k, v, cu = varlen_inputs(torch, dev, gen, lens, total, Hq, Hkv, d)
    seg, _ = kf.segments_from_cu_seqlens(cu, total)
    p_ = torch.arange(total, device=dev)
    mask = flash_pairs(p_, p_, WIDE_WINDOW) & (seg[:, None] == seg[None, :])
    qh = q.transpose(0, 1)[None].contiguous()
    kh, vh = (x.repeat_interleave(Hq // Hkv, 1).transpose(0, 1)[None]
              .contiguous() for x in (k, v))
    put("flash_attention_varlen", f"{total} tokens {Hq}/{Hkv} d {d} W "
        f"{WIDE_WINDOW}",
        lambda: kf.flash_attention_varlen_cuda(q, k, v, cu,
                                               window=WIDE_WINDOW),
        lambda: kf.flash_attention_varlen_ref(q, k, v, cu,
                                              window=WIDE_WINDOW),
        lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
        2 * total * (Hq + Hkv) * d * 4 + cu.numel() * 4,
        4 * d * Hq * int(mask.sum()))

    dk = WIDE_DECODE
    out["paged_attention_decode"], _ = time_decode_kernel(
        torch, dev, gen, flush, dk["lengths"], d=d, Hq=dk["Hq"],
        Hkv=dk["Hkv"], nb=dk["nb"])
    out["paged_attention_decode"]["shape"] = (
        f"{len(dk['lengths'])} rows x {dk['lengths'][0]}, {dk['Hq']}/"
        f"{dk['Hkv']} d {d} bs {dk['bs']}")
    out["paged_prefill_attention"], _ = time_prefill_kernel(
        torch, dev, gen, flush, PREFILL_SLICE, d=d, Hq=WIDE_PREFILL["Hq"],
        Hkv=WIDE_PREFILL["Hkv"])
    out["paged_prefill_attention"]["shape"] = (
        f"[11]'s chunk, 4 segs, {WIDE_PREFILL['Hq']}/{WIDE_PREFILL['Hkv']} "
        f"d {d}")
    for name, t in out.items():
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = t["flops"] / FP32_FLOP_PER_S * 1e3
        t["bound_ms"] = max(t_bytes, t_ops)
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"  {name:30s} {t['shape']:34s} kernel {t['ms']:.4f} ms  plain "
            f"{t['plain_ms']:.4f} ms  SDPA {t['library_ms']:.4f} ms  bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    return out


# ------------------------------ the public architectures ([37], [38])
# Served one after another in bf16 (the configs' own dtype) at full width,
# random weights from seed 0: batch 4 x a 2048-token prompt + 32 greedy
# tokens on paged KV (pages of 16).
ARCH_SERVE = ("qwen2-1.5b", "yi-9b", "musicgen-large", "gemma3-4b", "yi-34b")
ARCH_B, ARCH_P, ARCH_G = 4, 2048, 32
FREE_GIB = 4.0              # the card memory a run must leave free
# bf16 prefill against fp32 on the same weights (2 layers, card), each as a
# relative Frobenius error ||x_bf16 - x_fp32|| / ||x_fp32||: of every
# layer's mixer output (the h its block adds to the residual; the largest
# of the layers), and of the last position's logits over the tokens that
# are not in the prompt, centred on their mean (a tied table gives a
# prompt token a self-logit of |e|^2, which says nothing of the mixers).
# The control: the fp32 run with layer 0's mixer output dropped.  The
# limits lie between the largest sound reading and the smallest control
# on the H100 (PERF.md §6, PR 27): mixers 0.0061 against layer 1's 0.021
# (gemma3-4b), logits 0.0050 against 0.094 (qwen2, yi, musicgen; gemma's
# embedding scale leaves its logits blind to one mixer: 0.0014).
BF16_MIXER_TOL = 0.012
BF16_LOGIT_TOL = 0.02
# the card-vs-CPU check (fp32, 2 layers; ``cross_check`` generates 8): a
# window ring of min(window, max_len) slots must be whole pages of 16, so
# max_len = CROSS_P + CROSS_G is a multiple of 16
CROSS_P, CROSS_G = 120, 8


def arch_config(name, **over):
    from repro_torch.configs.base import get_config
    cfg = get_config(name, preset="full")
    return dataclasses.replace(cfg, **over) if over else cfg


def gemma_mosa_config():
    """``gemma3-4b-mosa32``: gemma3-4b with every attention layer a MoSA
    hybrid of 32 sparse heads (k = T / 32) and 4 dense heads, all of d 256,
    on the kernel path."""
    cfg = arch_config("gemma3-4b").with_mosa(sparsity=32, n_mosa_heads=32)
    return dataclasses.replace(cfg, mosa=dataclasses.replace(cfg.mosa,
                                                             impl="kernel"))


def cut_depth(cfg, n, start=0):
    """``cfg`` with layers [start, start + n) of its pattern."""
    pat = cfg.resolved_pattern()[start:start + n]
    return dataclasses.replace(cfg, n_layers=n,
                               pattern=pat if cfg.pattern else ())


def two_layer_start(cfg):
    """The first layer of a 2-layer cut that holds both mixer kinds of a
    mixed pattern (gemma3-4b: a local and a global layer), else 0."""
    pat = cfg.resolved_pattern()
    i = next((i for i, b in enumerate(pat) if b != pat[0]), 1)
    return i - 1


def fp32_cfg(cfg, vocab=None):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32",
                               vocab=vocab or cfg.vocab)


def want_arch_launches(cfg, G):
    """One packed-free generate: MoSA layers launch #1 once (prefill) and
    #11 per decode step on their dense heads; global attention layers (a
    paged dense cache) #11 per decode step; window layers (paged rings)
    and every prefill of a dense cache run plain PyTorch."""
    pat = cfg.resolved_pattern()
    n_mosa = sum(b.mixer == "mosa" for b in pat)
    n_dense = sum(b.mixer == "attn" for b in pat) + n_mosa
    counts = {"paged_attention_decode": n_dense * (G - 1)}
    if n_mosa:
        counts["mosa_attention"] = n_mosa
    return want_launches(**counts)


def free_cuda(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def arch_generate(torch, cfg, B=ARCH_B, P=ARCH_P, G=ARCH_G, label=""):
    """``Server.generate`` of ``cfg`` on paged KV: a warm-up generate of one
    token, then the counted generate of G tokens with its decode steps
    timed on their own (prefill ms: the rest of that call, the prefill and
    the first token's sampling).  The launches over the counted call must
    be exactly ``want_arch_launches``.  Returns the server, the prompts and
    the results."""
    from repro_torch.core.kv_cache import cache_nbytes
    from repro_torch.launch.serve import Server
    from repro_torch.serve.paged_kv import PagedConfig
    t_build = time.perf_counter()
    server = Server(cfg, batch=B, max_len=P + G,
                    paged=PagedConfig(block_size=16), seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    n_params = sum(p.numel() for p in server.model.parameters())
    prompts = torch.randint(2, cfg.vocab, (B, P),
                            generator=torch.Generator().manual_seed(1))

    def timed_generate(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, caches = server.generate(prompts, n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, toks, caches

    timed_generate(1)                                   # warm-up
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
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    gen_s, toks, caches = timed_generate(G)
    launches = {name: c.count for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    del server.model.decode_many
    want = want_arch_launches(cfg, G)
    if launches != want:
        raise AssertionError(f"{cfg.name}: launch counts {launches} != "
                             f"{want}")
    if toks.shape != (B, G) or not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"{cfg.name}: bad tokens {tuple(toks.shape)}")
    total = torch.cuda.mem_get_info()[1]
    res = dict(depth=cfg.n_layers, params=n_params, build_s=build_s,
               prefill_ms=(gen_s - span["decode_s"]) * 1e3, generate_s=gen_s,
               decode_s=span["decode_s"],
               decode_tok_s=B * (G - 1) / span["decode_s"],
               peak_gib=peak / 2 ** 30, free_gib=(total - peak) / 2 ** 30,
               cache_bytes=cache_nbytes(caches), launches={
                   k: v for k, v in launches.items() if v})
    log(f"  {label or cfg.name}: {cfg.n_layers} layers, {n_params / 1e9:.3f} B"
        f" parameters ({cfg.param_dtype}, built in {build_s:.1f} s); batch "
        f"{B} x prompt {P} + {G} tokens; prefill {res['prefill_ms']:.1f} ms, "
        f"decode {res['decode_tok_s']:.1f} tok/s; peak "
        f"{res['peak_gib']:.2f} GiB ({res['free_gib']:.2f} GiB of the card "
        f"free); caches {res['cache_bytes'] / 2 ** 30:.3f} GiB; launches "
        f"{res['launches']}")
    del caches
    return server, prompts, res


def arch_depth(torch, cfg):
    """The deepest depth <= n_layers whose predicted peak leaves FREE_GIB
    of the card free: the peak of a 2-layer run of the same generate, plus
    one layer's weights and caches for each layer more."""
    from repro_torch.nn.transformer import TransformerLM
    total = torch.cuda.mem_get_info()[1]
    two = cut_depth(cfg, 2)
    meta = TransformerLM(two, device="meta")
    size = cfg.pdtype.itemsize
    layer = sum(p.numel() for p in meta.layers[0].parameters()) * size
    a = cfg.attention       # a layer's paged K and V at most
    cache = 2 * ARCH_B * (ARCH_P + ARCH_G) * a.n_kv_heads * a.d_head * size
    full = (sum(p.numel() for p in meta.parameters())
            + (cfg.n_layers - 2) * layer // size) * size
    if full + cfg.n_layers * cache + 16 * 2 ** 30 < total - FREE_GIB * 2 ** 30:
        return cfg.n_layers, None       # far from the limit: no probe
    server, _, probe = arch_generate(torch, two, G=2, label=f"{cfg.name} "
                                     "(2-layer probe)")
    del server
    free_cuda(torch)
    room = total - FREE_GIB * 2 ** 30 - probe["peak_gib"] * 2 ** 30
    return min(cfg.n_layers, 2 + int(room // (layer + cache))), probe


def prefill_readout(torch, srv, prompt, drop=None):
    """``srv``'s prefill of ``prompt``: the last position's logits and each
    layer's mixer output, in fp32; ``drop``: a layer whose mixer output is
    replaced by zeros."""
    mixed = []
    for i, layer in enumerate(srv.model.layers):
        def read(*a, _prefill=layer.mixer.prefill, _i=i, **k):
            h, cache = _prefill(*a, **k)
            if _i == drop:
                h = torch.zeros_like(h)
            mixed.append(h.float())
            return h, cache
        layer.mixer.prefill = read
    with torch.inference_mode():
        lg, _ = srv.model.prefill(prompt, srv.new_cache())
    return lg[0, -1].float(), mixed


@contextlib.contextmanager
def replayed_selections(torch, record=None, replay=None):
    """MoSA's top-k selections (``core.mosa.select_topk``, in call order):
    appended to ``record``, or taken from ``replay`` (the router scores of
    this run gathered at the replayed indices), with the share of heads
    whose own selection differs appended to ``replay_flips``."""
    from repro_torch.core import mosa
    own = mosa.select_topk
    calls = iter(replay or ())
    flips = []

    def select(scores, k, force_first=True):
        r, idx = own(scores, k, force_first)
        if record is not None:
            record.append(idx)
        if replay is not None:
            want = next(calls)
            flips.append((want != idx).any(-1).float().mean().item())
            r, idx = torch.gather(scores, -1, want), want
        return r, idx

    mosa.select_topk = select
    try:
        yield flips
    finally:
        mosa.select_topk = own


def bf16_vs_fp32(torch, state, cfg, prompts, label):
    """The bf16 weights ``state`` (a 2-layer cut of the full run's) in bf16
    and in fp32 on the card, one 256-token prompt: the relative error of
    the mixer outputs and of the logits (``BF16_MIXER_TOL``), with the
    control's readings beside them.  The fp32 run takes the bf16 run's
    MoSA selections, so that a near-tie that bf16's rounding of the router
    input flips (ROADMAP C, "Top-k ties") does not read as error; the
    share of heads whose fp32 selection differs is reported."""
    from repro_torch.launch.serve import Server
    from repro_torch.serve.paged_kv import PagedConfig
    prompt = prompts[:1, :256].cuda()
    runs, picks = {}, []
    for name, c, drop in (("bf16", cfg, None), ("fp32", fp32_cfg(cfg), None),
                          ("control", fp32_cfg(cfg), 0)):
        srv = Server(c, batch=1, max_len=256, params=state,
                     paged=PagedConfig(block_size=16))
        with replayed_selections(
                torch, record=picks if name == "bf16" else None,
                replay=picks if name == "fp32" else None) as flips:
            runs[name] = prefill_readout(torch, srv, prompt, drop)
        if name == "fp32":
            flipped = max(flips, default=0.0)
        del srv
    l32, h32 = runs["fp32"]
    keep = torch.ones_like(l32, dtype=torch.bool)
    keep[prompt[0]] = False
    mean = l32[keep].mean()

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    # the control's mixer reading is layer 1's: layer 0's reads 1 exactly
    read = {name: dict(mixer=max(rel(a, b) for a, b in list(zip(h, h32))[first:]),
                       logits=rel(l[keep] - mean, l32[keep] - mean))
            for name, first in (("bf16", 0), ("control", 1))
            for l, h in (runs[name],)}
    l16 = runs["bf16"][0]
    log(f"  {label}: bf16 vs fp32 prefill (2 layers, card), relative error "
        f"of the mixer outputs {read['bf16']['mixer']:.5f} (tol "
        f"{BF16_MIXER_TOL}), of the logits {read['bf16']['logits']:.5f} "
        f"(tol {BF16_LOGIT_TOL}); control (layer 0's mixer dropped): layer "
        f"1's mixer {read['control']['mixer']:.5f}, the logits "
        f"{read['control']['logits']:.5f}; top-1 "
        f"{'equal' if l16.argmax() == l32.argmax() else 'differs'}"
        + (f"; MoSA heads whose fp32 selection differs (replayed): "
           f"{flipped:.4f} at most" if picks else ""))
    if not (torch.isfinite(l16).all()
            and read["bf16"]["mixer"] <= BF16_MIXER_TOL
            and read["bf16"]["logits"] <= BF16_LOGIT_TOL):
        raise AssertionError(f"{label}: bf16 off fp32: {read['bf16']}")
    return dict(read["bf16"], control=read["control"],
                **({"selection_flips": flipped} if picks else {}))


def two_layer_state(server, cfg):
    """The 2-layer cut's weights of a served model, on the host, layer
    indices renumbered from 0."""
    start = two_layer_start(cfg)
    out = {}
    for k, v in server.model.state_dict().items():
        parts = k.split(".")
        if parts[0] == "layers":
            i = int(parts[1]) - start
            if not 0 <= i < 2:
                continue
            k = ".".join(["layers", str(i)] + parts[2:])
        out[k] = v.detach().cpu()
    return out


def arch_cross_check(torch, cfg, label):
    """The card against the CPU in fp32 at full width and 2 layers (a cut
    holding both mixer kinds of a mixed pattern), the vocabulary cut to
    512 where its tables would pass 2 GiB in fp32: ``cross_check``'s
    prefill and decode logits (1e-3) and identical greedy tokens, batch 1,
    prompt ``CROSS_P``, ``CROSS_G`` tokens."""
    from repro_torch.launch.serve import Server
    tables = cfg.vocab * cfg.d_model * 4 * (1 if cfg.tie_embeddings else 2)
    vocab = 512 if tables > 2 * 2 ** 30 else cfg.vocab
    c32 = fp32_cfg(cut_depth(cfg, 2, two_layer_start(cfg)), vocab)
    server = Server(c32, batch=1, max_len=CROSS_P + CROSS_G, seed=0)
    prompts = torch.randint(2, vocab, (1, CROSS_P),
                            generator=torch.Generator().manual_seed(5))
    log(f"  {label}: fp32, 2 layers ({[b.mixer for b in c32.pattern] or 'uniform'})"
        f", vocab {vocab}")
    err = cross_check(torch, server, c32, prompts, P=CROSS_P)
    del server
    free_cuda(torch)
    return dict(vocab=vocab, logits_err=err)


def arch_slice(torch):
    """[37]: the five architectures one after another."""
    out = {}
    for name in ARCH_SERVE:
        cfg = arch_config(name)
        t0 = time.perf_counter()
        depth, probe = arch_depth(torch, cfg)
        run = cut_depth(cfg, depth) if depth < cfg.n_layers else cfg
        server, prompts, res = arch_generate(torch, run)
        if depth < cfg.n_layers:
            res["reduced"] = (f"n_layers {cfg.n_layers} -> {depth}: the "
                              f"weights and the peak leave {FREE_GIB} GiB "
                              "of the card free")
            res["probe"] = probe
            log(f"  reduced: {res['reduced']}")
        if res["free_gib"] < FREE_GIB:
            raise AssertionError(f"{name}: {res['free_gib']:.2f} GiB free")
        state = two_layer_state(server, run)
        del server
        free_cuda(torch)
        res["bf16_vs_fp32"] = bf16_vs_fp32(
            torch, state, cut_depth(run, 2, two_layer_start(run)), prompts,
            name)
        del state
        res["cross_check"] = arch_cross_check(torch, cfg, name)
        res["seconds"] = time.perf_counter() - t0
        out[name] = res
        free_cuda(torch)
    return out


def gemma_window_contiguous(torch, B=ARCH_B, P=ARCH_P, G=8):
    """[38](b): gemma3-4b on contiguous caches with every attention layer
    on the kernel route: its window layers' prefill is the flash kernel #9
    at d 256 (once per window layer in the generate); the global layers'
    prefill and every decode step are plain PyTorch."""
    from repro_torch.launch.serve import Server
    cfg = arch_config("gemma3-4b")
    server = Server(cfg, batch=B, max_len=P + G, seed=0)
    for layer in server.model.layers:
        layer.mixer.impl = "kernel"
    prompts = torch.randint(2, cfg.vocab, (B, P),
                            generator=torch.Generator().manual_seed(1))
    server.generate(prompts, 1)                          # warm-up
    counters = kernel_counters()
    for c in counters.values():
        c.count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, _ = server.generate(prompts, G)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {name: c.count for name, c in counters.items()}
    n_local = sum(b.mixer == "attn_local" for b in cfg.resolved_pattern())
    want = want_launches(flash_attention=n_local)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError("bad tokens")
    log(f"  contiguous rings, window layers on #9: generate of {G} tokens "
        f"{gen_s:.3f} s; launches {n_local} of #9, 0 of the others")
    del server
    free_cuda(torch)
    return dict(generate_s=gen_s, launches={"flash_attention": n_local})


def gemma_sched_slice(torch):
    """[38](a): gemma3-4b through the Scheduler on paged KV at full width:
    batch 4, max_len 1152, pages of 16 (the dense pool every row's whole
    length, the window pool every row's whole ring), 256-token chunks of up
    to 4 segments, prefix cache on; 8 seeded requests of 100-1000 tokens
    with 8-16 new each.  Exact checks: every request its max_new, both
    pools back (the dense one but the trie's), packed prefill #12 = global
    layers x prefill chunks, paged decode #11 = global layers x decode
    steps, every other kernel 0 (the window rings are plain PyTorch)."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.launch.serve import Server
    from repro_torch.serve.paged_kv import PagedConfig
    from repro_torch.serve.scheduler import Scheduler
    cfg = arch_config("gemma3-4b")
    B, max_len, bs = 4, 1152, 16
    window = cfg.attention.window
    server = Server(cfg, batch=B, max_len=max_len, seed=0, paged=PagedConfig(
        block_size=bs, num_blocks=B * max_len // bs,
        num_window_blocks=B * window // bs))
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(2, cfg.vocab, int(rng.integers(100, 1001))),
             int(rng.integers(8, 17))) for _ in range(8)]
    obs.set_enabled(True)
    obs.registry().reset()
    sched = Scheduler(server, prefix_cache=True, chunk=8, chunk_tokens=256,
                      max_prefill_segs=4)
    rids = [sched.submit(p, m) for p, m in reqs]
    counters = kernel_counters()
    for c in counters.values():
        c.count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sched.run(max_steps=100_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.count for name, c in counters.items()}
    st = dict(sched.stats)
    steps = int(obs.registry().snapshot()["counters"]["server.decode_steps"])
    for rid, (p, m) in zip(rids, reqs):
        if len(out[rid]) != m:
            raise AssertionError(f"request {rid}: {len(out[rid])} tokens, "
                                 f"want {m}")
    pool, wpool = sched.dense_pool, sched.window_pool
    if pool.free_blocks + sched.prefix.n_nodes != pool.num_blocks or \
            wpool.free_blocks != wpool.num_blocks:
        raise AssertionError("blocks leaked")
    n_global = sum(b.mixer == "attn" for b in cfg.resolved_pattern())
    want = want_launches(paged_attention_decode=n_global * steps,
                         paged_prefill_attention=n_global
                         * st["prefill_chunks"])
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    gen = sum(m for _, m in reqs)
    log(f"  {len(reqs)} requests ({sum(len(p) for p, _ in reqs)} prompt "
        f"tokens, {gen} generated) in {wall:.2f} s; {st['prefill_chunks']} "
        f"prefill chunks, {steps} decode steps; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    del server, sched
    free_cuda(torch)
    return dict(wall_s=wall, gen_tok_s=gen / wall, decode_steps=steps,
                stats=st, launches={k: v for k, v in launches.items() if v})


def gemma_slice(torch):
    """[38]: gemma3-4b's Scheduler, its contiguous window path, and
    gemma3-4b-mosa32 through generate (#1 at d 256 in prefill, #11 at d
    256 on its 4 dense heads), with that model's card-vs-CPU check."""
    out = {}
    log("  (a) the Scheduler: #12 and #11 at d 256, window pool")
    out["sched"] = gemma_sched_slice(torch)
    log("  (b) contiguous window rings: #9 at d 256")
    out["contiguous"] = gemma_window_contiguous(torch)
    log("  (c) gemma3-4b-mosa32 through generate")
    cfg = gemma_mosa_config()
    server, prompts, res = arch_generate(torch, cfg)
    state = two_layer_state(server, cfg)
    del server
    free_cuda(torch)
    res["bf16_vs_fp32"] = bf16_vs_fp32(torch, state, cut_depth(cfg, 2),
                                       prompts, cfg.name)
    del state
    res["cross_check"] = arch_cross_check(torch, cfg, cfg.name)
    out["mosa32"] = res
    return out


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
    server, cfg, prompts, res, _ = serve_slice(torch)

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
    bserver, bcfg, bprompts, block["serve"], _ = serve_slice(
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
    log("[26] main path: the window stack through the Scheduler at full "
        "width (window pool)")
    sched["window"] = window_sched_slice(torch)

    log("[28] main path: RequestPool (non-paged) at full width")
    pool = request_pool_slice(torch)

    log("[28b] main path: generate_stepwise at the slice's shapes")
    pool["stepwise"] = stepwise_slice(torch)

    log("[29] main path: training under each remat policy at full width")
    remat = remat_slice(torch)

    log("[30] main path: [8]'s training on a one-rank mesh (NCCL, world 1)")
    mesh_trainer, last_grads, dist_res = mesh_train_slice(torch, train)
    log("[31] tensor-parallel MoSA: layer 0 as 4 rank-local shards")
    dist_res["shards"] = tp_shards_slice(torch)
    log("[32] compressed all-reduce of [30]'s last gradients (NCCL)")
    dist_res["compress"] = compress_slice(torch, last_grads)
    del mesh_trainer, last_grads
    torch.cuda.empty_cache()
    log("[33] main path: [5]'s Server on a world-1 NCCL mesh under tp")
    dist_res["mesh_serve"] = mesh_serve_slice(torch, res)
    log("[34] main path: [11]'s Scheduler on that mesh, timed mode")
    dist_res["mesh_sched"] = mesh_sched_slice(torch, sched)
    log("[35] tensor-parallel serving: layer 0 as 4 rank-local shards")
    dist_res["serve_shards"] = tp_serve_shards_slice(torch)
    torch.distributed.destroy_process_group()
    free_cuda(torch)

    t36 = time.perf_counter()
    log("[36] wide-head kernels: all 12 at d 160, 192 and 256 against their "
        "plain versions (fp32, bf16), then timed at d 256 (fp32, L2 flushed)")
    wide_errs = check_wide_kernels(torch, dev)
    wide = time_wide_kernels(torch, dev)
    log(f"  [36] {time.perf_counter() - t36:.1f} s")
    t37 = time.perf_counter()
    log(f"[37] main path: {', '.join(ARCH_SERVE)} served at full width in "
        f"bf16 (batch {ARCH_B} x {ARCH_P} + {ARCH_G}, paged KV)")
    archs = arch_slice(torch)
    log(f"  [37] {time.perf_counter() - t37:.1f} s")
    t38 = time.perf_counter()
    log("[38] main path: gemma3-4b's Scheduler, contiguous window path and "
        "gemma3-4b-mosa32 at full width")
    gemma = gemma_slice(torch)
    log(f"  [38] {time.perf_counter() - t38:.1f} s")

    sweep["kernel_cases"] = {
        name: {**times[name], "max_abs_err": errs[name]}
        for name in (f"mosa_attention_fwd_res[{SWEEP_MOSA8_NAME}]",
                     f"mosa_attention[{SWEEP_MOSA8_NAME}]",
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
    # the mesh phases' launches: the mesh run of [33] and of [34], the 4
    # shards of [35] together
    launches_mesh = {name: {
        "33": dist_res["mesh_serve"]["mesh"]["launches"][name],
        "34": dist_res["mesh_sched"]["mesh"]["launches"][name],
        "35": dist_res["serve_shards"]["launches_total"].get(name, 0)}
        for name in sources}
    # the d 256 routes' launches on the main paths of [37] (gemma3-4b) and
    # [38] (its Scheduler, contiguous window path and gemma3-4b-mosa32)
    launches_d256 = {name: sum(
        run["launches"].get(name, 0) for run in (
            archs["gemma3-4b"], gemma["sched"], gemma["contiguous"],
            gemma["mosa32"])) for name in sources}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name],
                    launches_mesh=launches_mesh[name],
                    max_abs_err=errs[name],
                    ms=times[name]["ms"], plain_ms=times[name]["plain_ms"],
                    bound_ms=times[name]["bound_ms"],
                    bound_by=times[name]["bound_by"],
                    library_ms=times[name]["library_ms"],
                    **{k: times[name][k] for k in ("stream_ms", "device_ms")
                       if k in times[name]},
                    launches_d256=launches_d256[name],
                    d256=dict(source="src/repro_torch/csrc/wide_attention.cu",
                              max_abs_err=wide_errs[name], **{
                        k: wide[name][k] for k in (
                            "shape", "ms", "plain_ms", "library_ms",
                            "bound_ms", "bound_by")}))
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
    print(json.dumps({"pool": pool}))
    print(json.dumps({"remat": remat}))
    print(json.dumps({"dist": dist_res}))
    print(json.dumps({"wide": wide}))
    print(json.dumps({"archs": archs}))
    print(json.dumps({"gemma": gemma}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
