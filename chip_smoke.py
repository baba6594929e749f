#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU.  Run it from the root of a checkout:

    python3 chip_smoke.py

Phases (any failure raises, so the script exits nonzero):

  1. the card's name and power limit, the CUDA version;
  2. build the hand-written kernels from ``src/repro_torch/csrc`` (nvcc);
  3. hold each kernel against its plain PyTorch version on the card, in
     fp32 and bf16, at the serving slice's shapes and at edge cases
     (TF32 is switched off for the plain versions' matmuls);
  4. time each kernel, its plain version and one PyTorch yardstick call
     with CUDA events (L2 flushed before every timed launch);
  5. serve ``mosa-paper-tiny-mosa32`` at full width with the kernel path
     and paged dense KV: batch 8, prompt 1024, 128 generated tokens — the
     launch counters must rise by exactly 6 (MoSA attention, one per layer
     in prefill) and 6 * 127 (paged decode) over that one ``generate``;
  6. the card against the CPU at the same width and weights: batch 1,
     prompt 256, 8 greedy tokens;
  7. one decode step of phase 5's shapes under ``torch.profiler``: wall
     time, device time, idle share and kernel launches per step.

The last four lines are the ``serve`` JSON, the ``kernels`` JSON, the
``nvidia-smi`` name and power limit, and the result JSON.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
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


def check_case(torch, kernel, plain, name, case, errs):
    """Runs ``kernel`` in fp32 and bf16 against ``plain`` in fp32 on the
    same (rounded) inputs; records the fp32 error of the slice's case."""
    for dt in (torch.float32, torch.bfloat16):
        got, want = kernel(dt), plain(dt)
        torch.cuda.synchronize()
        atol, rtol = ((FP32_TOL, FP32_TOL) if dt == torch.float32
                      else bf16_tol(want))
        e = max_err(torch, got, want, atol, rtol)
        if dt == torch.float32 and case.startswith("slice"):
            errs[name] = e
        log(f"  {name:23s} {case:40s} {str(dt):15s} max|err| {e:.3e} "
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
def check_kernels(torch, dev):
    from repro_torch.kernels.mosa_attention import (mosa_attention_cuda,
                                                    mosa_attention_ref)
    from repro_torch.serve.paged_attention import (paged_attention_cuda,
                                                   paged_attention_ref)
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"mosa_attention": 0.0, "paged_attention_decode": 0.0}

    mosa_cases = {
        "slice (8,276,32,64)": dict(B=8, H=276, S=32, d=64, T=1024),
        "ragged S=37, idx=-1 keys, r=0 rows, seg": dict(
            B=2, H=3, S=37, d=64, T=200, neg_keys=20, zero_rows=10,
            with_seg=True),
        "two query tiles, d=80": dict(B=1, H=2, S=70, d=80, T=300,
                                      neg_keys=5),
    }
    for case, kw in mosa_cases.items():
        q, k, v, idx, r, seg = mosa_inputs(torch, dev=dev, gen=gen, **kw)
        check_case(
            torch,
            lambda dt: mosa_attention_cuda(q.to(dt), k.to(dt), v.to(dt), idx,
                                           r, seg=seg),
            lambda dt: mosa_attention_ref(*(t.to(dt).float() for t in (q, k, v)),
                                          idx, r, seg=seg),
            "mosa_attention", case, errs)

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


# -------------------------------------------------------------- main path
def serve_slice(torch):
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import mosa_attention as kmosa
    from repro_torch.launch.serve import Server
    from repro_torch.serve import paged_attention as kpaged
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
    counters = (kmosa.LAUNCHES, kpaged.LAUNCHES)
    for c in counters:
        c.count = 0
    torch.cuda.reset_peak_memory_stats()
    gen_s, toks, caches = timed_generate(G)
    launches = {c.name: c.count for c in counters}
    peak = torch.cuda.max_memory_allocated()
    del server.model.decode_many

    want = {"mosa_attention": cfg.n_layers,
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
    events = prof.key_averages()
    # kernel events only: an operator's row repeats its kernels' time
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
    log(f"  decode step: {wall_ms:.2f} ms wall, {res['device_ms']:.2f} ms on "
        f"the device (idle share {res['idle_share']:.2f}), "
        f"{res['launches']:.0f} kernel launches")
    log("  kernels by device time per step:")
    for e in kernels[:10]:
        log(f"    {e.self_device_time_total / 1e3 / steps:7.3f} ms "
            f"{e.count / steps:5.0f}x  {e.key[:90]}")
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

    sources = {
        "mosa_attention": ("src/repro_torch/csrc/mosa_attention.cu",
                           "src/repro/kernels/mosa_attention.py:55"),
        "paged_attention_decode": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/serve/paged_attention.py:87"),
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=res["launches"][name], max_abs_err=errs[name],
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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
