#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU.  Run it from the root of a checkout:

    python3 chip_smoke.py

Phases (any failure raises, so the script exits nonzero):

  1. the card's name and power limit, the CUDA version;
  2. build the hand-written kernels from ``src/repro_torch/csrc`` (nvcc);
  3. hold each kernel against its plain PyTorch version on the card, in
     fp32 and bf16, at the slices' shapes and at edge cases (TF32 is
     switched off for the plain versions' matmuls): MoSA attention, its
     training forward (o_pre, lse), the dq and dk/dv backward kernels, the
     autograd Function that joins them (grads of q, k, v and r against
     autograd of the plain version) and paged decode;
  4. time each kernel, its plain version and one PyTorch yardstick call
     with CUDA events (L2 flushed before every timed launch);
  5. serve ``mosa-paper-tiny-mosa32`` at full width with the kernel path
     and paged dense KV: batch 8, prompt 1024, 128 generated tokens — the
     launch counters must rise by exactly 6 (MoSA attention, one per layer
     in prefill) and 6 * 127 (paged decode) over that one ``generate``,
     and by 0 for the training kernels;
  6. the card against the CPU at the same width and weights: batch 1,
     prompt 256, 8 greedy tokens;
  7. one decode step of phase 5's shapes under ``torch.profiler``: wall
     time, device time, idle share and kernel launches per step;
  8. train ``mosa-paper-tiny-mosa32`` at full width with ``Trainer``
     (``impl="kernel"``, fp32, remat none): seq 1024, global batch 64 as 8
     microbatches of 8, lr 2.5e-4, clip 0.25, 4 AdamW steps, the first
     untimed — over the 3 timed steps the counters of the training forward,
     dq and dk/dv must rise by exactly 6 * 8 * 3 = 144 each, and MoSA
     attention's (serving) by 0; every loss and grad norm finite;
  9. the card against the CPU for training at the same width and weights:
     batch 1 x 256 tokens, one loss and backward — identical selections
     in every layer first, then the loss within 1e-5 relative and every
     grad within 1e-4 of its tensor's max |grad| on the CPU;
 10. one training microbatch of phase 8's shapes under ``torch.profiler``:
     wall time, device time, idle share, launches and the top device items
     with the operator that launched each.

The last five lines are the ``serve`` JSON, the ``train`` JSON, the
``kernels`` JSON, the ``nvidia-smi`` name and power limit, and the result
JSON.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

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


def check_case(torch, kernel, plain, name, case, errs, parts=None):
    """Runs ``kernel`` in fp32 and bf16 against ``plain`` in fp32 on the
    same (rounded) inputs; records the fp32 error of the slice's case.
    With ``parts``, both return a tuple of outputs, each checked and
    recorded as ``name.part``."""
    labels = [name] if parts is None else [f"{name}.{p}" for p in parts]
    for dt in (torch.float32, torch.bfloat16):
        got, want = kernel(dt), plain(dt)
        if parts is None:
            got, want = (got,), (want,)
        torch.cuda.synchronize()
        for label, g, w in zip(labels, got, want):
            atol, rtol = ((FP32_TOL, FP32_TOL) if dt == torch.float32
                          else bf16_tol(w))
            e = max_err(torch, g, w, atol, rtol)
            if dt == torch.float32 and case.startswith("slice"):
                errs[label] = e
            log(f"  {label:31s} {case:40s} {str(dt):15s} max|err| {e:.3e} "
                f"(atol {atol:.2e}, rtol {rtol:.2e})")


# ----------------------------------------------------------------- inputs
def mosa_inputs(torch, B, H, S, d, T, dev, gen, neg_keys=0, zero_rows=0,
                with_seg=False):
    """Expert-choice-like inputs: per (b, h) S sorted distinct positions of
    a length-T sequence, token 0 forced; ``neg_keys`` random slots set to
    -1, ``zero_rows`` random rows with r = 0."""
    q, k, v = (torch.randn(B, H, S, d, device=dev, generator=gen)
               for _ in range(3))
    perm = torch.rand(B, H, T - 1, device=dev, generator=gen).argsort(-1)
    idx = torch.cat([torch.zeros(B, H, 1, device=dev, dtype=torch.long),
                     perm[..., :S - 1] + 1], -1).sort(-1).values
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
MOSA_CASES = {
    "slice (8,276,32,64)": dict(B=8, H=276, S=32, d=64, T=1024),
    "ragged S=37, idx=-1 keys, r=0 rows, seg": dict(
        B=2, H=3, S=37, d=64, T=200, neg_keys=20, zero_rows=10,
        with_seg=True),
    "two query tiles, d=80": dict(B=1, H=2, S=70, d=80, T=300, neg_keys=5),
}


def check_train_kernels(torch, dev, gen, errs):
    """The training forward, the two backward kernels (on the same g~, lse
    and delta as their plain version) and the autograd Function end to end
    (grads of sum(out * g) for q, k, v and r against autograd of
    ``mosa_attention_ref``)."""
    from repro_torch.kernels import mosa_attention as kmosa
    from repro_torch.kernels.mosa_backward import (mosa_attention_bwd_cuda,
                                                   mosa_attention_bwd_ref)
    for case, kw in MOSA_CASES.items():
        q, k, v, idx, r, seg = mosa_inputs(torch, dev=dev, gen=gen, **kw)
        g = torch.randn(q.shape, device=dev, generator=gen)
        check_case(
            torch,
            lambda dt: kmosa.mosa_attention_fwd_res_cuda(
                q.to(dt), k.to(dt), v.to(dt), idx, seg=seg),
            lambda dt: kmosa.mosa_attention_fwd_res_ref(
                *(t.to(dt).float() for t in (q, k, v)), idx, seg=seg),
            "mosa_attention_fwd_res", case, errs, ("o_pre", "lse"))

        def bwd(fn, dt, cast):
            qq, kk, vv = (cast(t.to(dt)) for t in (q, k, v))
            o_pre, lse = kmosa.mosa_attention_fwd_res_ref(
                *(t.float() for t in (qq, kk, vv)), idx, seg=seg)
            gt = (g * r[..., None]).contiguous()
            delta = (gt * o_pre).sum(-1).contiguous()
            return fn(qq, kk, vv, idx, gt, lse, delta, seg=seg)

        check_case(
            torch, lambda dt: bwd(mosa_attention_bwd_cuda, dt, lambda t: t),
            lambda dt: bwd(mosa_attention_bwd_ref, dt, lambda t: t.float()),
            "mosa_attention_bwd", case, errs, ("dq", "dk", "dv"))

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

        check_case(torch, lambda dt: function_grads(dt, False),
                   lambda dt: function_grads(dt, True),
                   "mosa_attention_function", case, errs,
                   ("dq", "dk", "dv", "dr"))
    # the error of each kernel's row in the kernels JSON
    errs["mosa_attention_fwd_res"] = max(errs["mosa_attention_fwd_res.o_pre"],
                                         errs["mosa_attention_fwd_res.lse"])
    errs["mosa_attention_bwd_dq"] = errs["mosa_attention_bwd.dq"]
    errs["mosa_attention_bwd_dkv"] = max(errs["mosa_attention_bwd.dk"],
                                         errs["mosa_attention_bwd.dv"])


def check_kernels(torch, dev):
    from repro_torch.kernels.mosa_attention import (mosa_attention_cuda,
                                                    mosa_attention_ref)
    from repro_torch.serve.paged_attention import (paged_attention_cuda,
                                                   paged_attention_ref)
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"mosa_attention": 0.0, "paged_attention_decode": 0.0}

    for case, kw in MOSA_CASES.items():
        q, k, v, idx, r, seg = mosa_inputs(torch, dev=dev, gen=gen, **kw)
        check_case(
            torch,
            lambda dt: mosa_attention_cuda(q.to(dt), k.to(dt), v.to(dt), idx,
                                           r, seg=seg),
            lambda dt: mosa_attention_ref(*(t.to(dt).float() for t in (q, k, v)),
                                          idx, r, seg=seg),
            "mosa_attention", case, errs)
    check_train_kernels(torch, dev, gen, errs)

    paged_cases = {
        "slice B=8 Hq=Hkv=4 d=64 bs=16 nb=72": dict(
            B=8, Hq=4, Hkv=4, d=64, bs=16, nb=72,
            lengths=[1088, 1087, 1025, 1100, 1152, 1040, 1151, 1096]),
        "GQA 8/2, lengths 1 and nb*bs, -1 tail": dict(
            B=3, Hq=8, Hkv=2, d=64, bs=16, nb=5, lengths=[1, 80, 37],
            neg_tail=True),
        "GQA 16/2 d=128 bs=8": dict(B=2, Hq=16, Hkv=2, d=128, bs=8, nb=9,
                                    lengths=[70, 3], neg_tail=True),
        "d=32": dict(B=2, Hq=2, Hkv=1, d=32, bs=4, nb=20, lengths=[77, 40]),
    }
    for case, kw in paged_cases.items():
        q, kp, vp, table, lengths = paged_inputs(torch, dev=dev, gen=gen, **kw)
        scale = kw["d"] ** -0.5
        check_case(
            torch,
            lambda dt: paged_attention_cuda(q.to(dt), kp.to(dt), vp.to(dt),
                                            table, lengths, scale),
            lambda dt: paged_attention_ref(
                *(t.to(dt).float() for t in (q, kp, vp)), table, lengths,
                scale),
            "paged_attention_decode", case, errs)
    return errs


# ---------------------------------------------------------------- timing
def time_kernels(torch, dev):
    """Times at the slice's shapes (fp32): kernel, plain version, and one
    PyTorch call computing the same attention (``library_ms``, a yardstick
    the port never calls), plus the bound from bytes and operations."""
    import torch.nn.functional as F
    from repro_torch.kernels.mosa_attention import (mosa_attention_cuda,
                                                    mosa_attention_ref)
    from repro_torch.serve.paged_attention import (paged_attention_cuda,
                                                   paged_attention_ref)
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
        plain_ms=time_ms(torch, lambda: mosa_attention_ref(q, k, v, idx, r),
                         flush=flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), flush=flush),
        bytes=nbytes, flops=flops)
    out.update(time_train_kernels(torch, q, k, v, idx, r, mask, pairs, flush,
                                  gen))

    Bp, Hq, Hkv, dp, bs, nb = 8, 4, 4, 64, 16, 72
    lens = [1088, 1087, 1025, 1100, 1152, 1040, 1151, 1096]
    qd, kp, vp, table, lengths = paged_inputs(torch, Bp, Hq, Hkv, dp, bs, nb,
                                              lens, dev, gen)
    scale = dp ** -0.5
    kk = kp[table.long()].reshape(Bp, nb * bs, Hkv, dp).transpose(1, 2)
    vv = vp[table.long()].reshape(Bp, nb * bs, Hkv, dp).transpose(1, 2)
    kk, vv = kk.contiguous(), vv.contiguous()
    kmask = (torch.arange(nb * bs, device=dev)[None] < lengths[:, None].long())
    kmask = kmask[:, None, None, :]
    nbytes = (sum(lens) * Hkv * dp * 2 * 4 + 2 * Bp * Hq * dp * 4
              + Bp * nb * 4 + Bp * 4)
    flops = 4 * sum(lens) * Hq * dp
    out["paged_attention_decode"] = dict(
        ms=time_ms(torch, lambda: paged_attention_cuda(
            qd, kp, vp, table, lengths, scale), flush=flush),
        plain_ms=time_ms(torch, lambda: paged_attention_ref(
            qd, kp, vp, table, lengths, scale), flush=flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kk, vv, attn_mask=kmask, scale=scale),
            flush=flush),
        bytes=nbytes, flops=flops)

    for name, t in out.items():
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = t["flops"] / FP32_FLOP_PER_S * 1e3
        t["bound_ms"] = max(t_bytes, t_ops)
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"  {name:24s} kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f}"
            f" ms  library {t['library_ms']:.4f} ms  bound {t['bound_ms']:.4f}"
            f" ms ({t['bound_by']}: {t['bytes'] / 1e6:.2f} MB, "
            f"{t['flops'] / 1e9:.3f} GFLOP)")
    return out


def time_train_kernels(torch, q, k, v, idx, r, mask, pairs, flush, gen):
    """The training kernels at the slice's shapes (fp32).  Bytes: each
    input read once, each output written once; operations: 2*d per product
    of two d-vectors over the valid (query, key) pairs of this run's
    indices.  The plain versions compute dq, dk and dv in one call, and the
    yardstick of #3 and #4 is one call of SDPA's backward, which computes
    all three too: both numbers stand in each of the two rows, to compare
    with the sum of the two kernels."""
    import torch.nn.functional as F
    from repro_torch.kernels.mosa_attention import (
        mosa_attention_fwd_res_cuda, mosa_attention_fwd_res_ref)
    from repro_torch.kernels.mosa_backward import (
        mosa_attention_bwd_dkv_cuda, mosa_attention_bwd_dq_cuda,
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
    return {
        "mosa_attention_fwd_res": dict(
            ms=time_ms(torch, lambda: mosa_attention_fwd_res_cuda(
                q, k, v, idx), flush=flush),
            plain_ms=time_ms(torch, lambda: mosa_attention_fwd_res_ref(
                q, k, v, idx), flush=flush),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), flush=flush),
            bytes=3 * vec + row + vec + row, flops=4 * pairs * d),
        "mosa_attention_bwd_dq": dict(
            ms=time_ms(torch, lambda: mosa_attention_bwd_dq_cuda(*bwd_args),
                       flush=flush),
            plain_ms=plain_bwd_ms, library_ms=sdpa_bwd_ms,
            bytes=4 * vec + 3 * row + vec, flops=6 * pairs * d),
        "mosa_attention_bwd_dkv": dict(
            ms=time_ms(torch, lambda: mosa_attention_bwd_dkv_cuda(*bwd_args),
                       flush=flush),
            plain_ms=plain_bwd_ms, library_ms=sdpa_bwd_ms,
            bytes=4 * vec + 3 * row + 2 * vec, flops=8 * pairs * d),
    }


def kernel_counters():
    """Every kernel's launch counter, by kernel name."""
    from repro_torch.kernels import mosa_attention as kmosa
    from repro_torch.kernels import mosa_backward as kbwd
    from repro_torch.serve import paged_attention as kpaged
    return {c.name: c for c in (kmosa.LAUNCHES, kmosa.LAUNCHES_FWD_RES,
                                kbwd.LAUNCHES_DQ, kbwd.LAUNCHES_DKV,
                                kpaged.LAUNCHES)}


# -------------------------------------------------------------- main path
def serve_slice(torch):
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.serve.paged_kv import PagedConfig

    cfg = get_config("mosa-paper", preset="full", size="tiny", variant="mosa")
    cfg = dataclasses.replace(cfg, mosa=dataclasses.replace(cfg.mosa,
                                                            impl="kernel"))
    B, P, G, max_len = 8, 1024, 128, 1152
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.mosa.n_dense_heads} dense + {cfg.mosa.n_mosa_heads} MoSA heads,"
        f" vocab {cfg.vocab}, {cfg.param_dtype}")
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

    want = {"mosa_attention": cfg.n_layers, "mosa_attention_fwd_res": 0,
            "mosa_attention_bwd_dq": 0, "mosa_attention_bwd_dkv": 0,
            "paged_attention_decode": cfg.n_layers * (G - 1)}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if toks.shape != (B, G) or not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"bad tokens {toks.shape}")
    for c in caches:
        sc = c["sparse"]
        if not torch.isfinite(sc.k).all() or not torch.isfinite(c["dense"].k).all():
            raise AssertionError("non-finite cache contents")
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


def cross_check(torch, server, cfg, prompts):
    """The card against the CPU: same weights, batch 1, prompt 256."""
    from repro_torch.launch.serve import Server
    from repro_torch.serve.paged_kv import PagedConfig
    P, G = 256, 8
    state = {k: v.detach().cpu() for k, v in server.model.state_dict().items()}
    kw = dict(batch=1, max_len=P + G, paged=PagedConfig(block_size=16))
    gpu = Server(cfg, params=state, **kw)
    cpu = Server(cfg, params=state, device="cpu", **kw)
    p = prompts[:1, :P]
    with torch.inference_mode():
        lg, _ = gpu.model.prefill(p.cuda(), gpu.new_cache())
        lc, _ = cpu.model.prefill(p, cpu.new_cache())
    err = (lg.cpu() - lc).abs().max().item()
    tg, _ = gpu.generate(p, G)
    tc, _ = cpu.generate(p, G)
    log(f"  prefill logits max|gpu - cpu| {err:.3e} (tol 1e-3); tokens "
        f"gpu {tg[0].tolist()} cpu {tc[0].tolist()}")
    if not err <= 1e-3:
        raise AssertionError(f"prefill logits differ by {err}")
    if not torch.equal(tg.cpu(), tc):
        raise AssertionError("greedy tokens differ between card and CPU")
    return err


# ------------------------------------------------------------- training
TRAIN_STEPS = 4             # the first is untimed


def train_slice(torch):
    """Full-width training through ``Trainer``: the counters are zeroed
    once the untimed first step has returned, and read after the last."""
    from repro_torch.train.loop import TrainConfig, Trainer
    cfg = TrainConfig(arch="mosa-paper", preset="full",
                      arch_kwargs={"variant": "mosa"}, seq_len=1024,
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
    want = {"mosa_attention": 0, "mosa_attention_fwd_res": per_layer,
            "mosa_attention_bwd_dq": per_layer,
            "mosa_attention_bwd_dkv": per_layer, "paged_attention_decode": 0}
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
    """Each MoSA layer's selected indices (B, H, k) on ``tokens``."""
    from repro_torch.core.router import select_topk
    out = []
    with torch.no_grad():
        x = model.embed(tokens)
        for layer in model.layers:
            sp = layer.mixer.sparse
            _, idx = select_topk(sp.router.scores(layer.norm1(x)),
                                 sp.k_for(tokens.shape[1]),
                                 sp.cfg.force_first_token)
            out.append(idx.cpu())
            x, _ = layer(x)
    return out


def train_cross_check(torch, trainer):
    """The card against the CPU for training: the same weights, batch 1 x
    256 tokens, one loss and backward.  Selections first: a near-tie of
    router scores must show as a selection difference, not hide in a
    looser tolerance."""
    from repro_torch.data.pipeline import PackedLMDataset, SyntheticCorpus
    from repro_torch.nn.transformer import TransformerLM
    mc = trainer.model_cfg
    gpu = trainer.model
    cpu = TransformerLM(mc, device="cpu")
    cpu.load_state_dict({k: v.detach().cpu()
                         for k, v in gpu.state_dict().items()})
    batch = PackedLMDataset(SyntheticCorpus(vocab=mc.vocab, seed=1),
                            seq_len=256, global_batch=1).batch_at(0)
    batch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    card = next(gpu.parameters()).device
    sel_g = layer_selections(torch, gpu, batch["tokens"].to(card))
    sel_c = layer_selections(torch, cpu, batch["tokens"])
    differ = [int((a != b).any(-1).sum()) for a, b in zip(sel_g, sel_c)]
    log(f"  heads whose selection differs, per layer: {differ}")
    if any(differ):
        raise AssertionError(f"selections differ between card and CPU: "
                             f"{differ} heads per layer")
    out = {}
    for name, model, dev in (("gpu", gpu, card), ("cpu", cpu, "cpu")):
        loss, _ = model.loss({k: v.to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[name] = (loss.item(), [g.cpu() for g in grads])
    (lg, gg), (lc, gc) = out["gpu"], out["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    names = [k for k, _ in cpu.named_parameters()]
    worst = max((((a - b).abs().max() / b.abs().max()).item(), k)
                for k, a, b in zip(names, gg, gc))
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
        f"{res['idle_share']:.2f}), {res['launches']:.0f} kernel launches")
    log("  kernels by device time per microbatch:")
    for ms, count, name in top:
        log(f"    {ms:7.3f} ms {count:5.0f}x  {name[:90]}")
    log("  top device items by launching operator:")
    for t in res["top"]:
        log(f"    {t['ms']:7.3f} ms {t['count']:5.0f}x  {t['op'][:40]:40s} "
            f"{t['kernel'][:60]}")
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
        for line in f.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {f.stem}: {line.strip()}")

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

    log("[9] card vs CPU for training at full width")
    train["cross_check"] = train_cross_check(torch, trainer)

    log("[10] one training microbatch at the slice's shapes, profiled")
    train["microbatch"] = profile_train(torch, trainer)

    sources = {
        "mosa_attention": ("src/repro_torch/csrc/mosa_attention.cu",
                           "src/repro/kernels/mosa_attention.py:55"),
        "mosa_attention_fwd_res": ("src/repro_torch/csrc/mosa_attention.cu",
                                   "src/repro/kernels/mosa_attention.py:110"),
        "mosa_attention_bwd_dq": ("src/repro_torch/csrc/mosa_backward.cu",
                                  "src/repro/kernels/mosa_backward.py:49"),
        "mosa_attention_bwd_dkv": ("src/repro_torch/csrc/mosa_backward.cu",
                                   "src/repro/kernels/mosa_backward.py:100"),
        "paged_attention_decode": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/serve/paged_attention.py:87"),
    }
    # launches: serving's kernels from [5], training's from [8]
    launches = {name: res["launches"][name] or train["launches_total"][name]
                for name in sources}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], max_abs_err=errs[name],
                    ms=times[name]["ms"], plain_ms=times[name]["plain_ms"],
                    bound_ms=times[name]["bound_ms"],
                    bound_by=times[name]["bound_by"],
                    library_ms=times[name]["library_ms"])
               for name, (src, rep) in sources.items()]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"serve": {
        k: res[k] for k in ("prefill_ms", "decode_tok_s", "decode_s",
                            "generate_s", "peak_gib", "params",
                            "decode_step")}}))
    print(json.dumps({"train": train}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
