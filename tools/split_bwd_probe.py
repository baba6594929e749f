#!/usr/bin/env python3
"""Where the split MoSA backward kernels (#3 dq, #4 dk/dv) spend their time.

Run from the root of a checkout, on one NVIDIA GPU:

    python3 tools/split_bwd_probe.py

It builds variants of ``src/repro_torch/csrc/mosa_backward.cu`` and
``mosa_tiles.cuh`` (each with the port's build, ``kernels/build.py``, into
its own library):

  * ``kernel``        -- the source as it is;
  * ``no phase A``    -- S and dP are not computed (zeros): the time
                         without the score products;
  * ``no phase B``    -- the output products (dS k; dS^T q, P^T g~) are
                         not computed;
  * ``no tile copies``-- the streamed tiles' q, k, v and g~ are not copied
                         (their per-row words are);
  * ``no skipping``   -- every tile pair is computed, none skipped by value;
  * ``no phase A or B`` -- neither product;
  * ``no A, B, P/dS math`` -- neither product, and the scratch gets zeros
                         in place of P and dS (no exp, no mask);
  * ``skeleton``      -- all of the last three and no tile copies: what
                         is left is the block's plan, its owned copies,
                         the barriers and the stores;

and two designs not taken, whose gradients are right:

  * ``one block an SM`` -- launch bounds of one block per SM (up to 255
                         registers, no spills, 8 warps an SM);
  * ``dk/dv 8 x 4 tiles`` -- dk/dv's phase B as dq's: 8 x 4 tiles over
                         halves of the queries, at two blocks an SM.

Every variant above the last two gives wrong gradients: only its time
means anything.  Each is timed (CUDA events, L2 flushed before every launch) at
the IsoFLOP sweep's mosa8 shape (8, 69, 128, 64), fp32, sorted idx, in the
order kernel, variants, variants reversed, kernel; the printed time is the
mean of a variant's two readings.  The last line is one JSON object with
every number.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "split_bwd_probe"
sys.path.insert(0, str(ROOT / "src"))

# (part, [(text in a source, its replacement), ...])
ZERO_SD = ("for (int r = 0; r < 4; ++r) for (int m = 0; m < 4; ++m) "
           "sc[r][m] = dp[r][m] = 0.f;")
PARTS = {
    "A": [
        ("    tile_dots(qo, L.dsT, go, L.dsF, st.k, L.dsT, st.v, L.dsT, "
         "pa.o0, pa.j0,\n              pa.c0, pa.c1, sc, dp);", ZERO_SD),
        ("    tile_dots(ko, L.dsT, vo, L.dsT, st.q, L.dsT, st.g, L.dsF, "
         "pa.o0, pa.j0,\n              pa.c0, pa.c1, sc, dp);", ZERO_SD)],
    "B": [
        ("          outer<kR>(acc[w], a, ld4(st.k + j * L.dsT + pb.cb + "
         "64 * w));", "          ;"),
        ("          outer<kR>(ak[w], a_k, ld4(st.q + j * L.dsT + c));\n"
         "          outer<kR>(av[w], a_v, ld4(st.g + j * L.dsF + c));",
         "          ;")],
    "copies": [
        ("    stage_rows(kv, L.dsT, src, ns,", "    if (false) stage_rows(kv, L.dsT, src, ns,"),
        ("    stage_rows(st.q, L.dsT,", "    if (false) stage_rows(st.q, L.dsT,"),
        ("    stage_rows(st.g, L.dsF,", "    if (false) stage_rows(st.g, L.dsF,")],
    "skipping": [
        ("      need[t] = kQueries ? spans_meet(own, sp) : "
         "spans_meet(sp, own);", "      need[t] = 1;")],
    "P/dS math": [
        ("        dst[(pa.j0 + kSG * m) * L.ps + i] = ok ? p * (ev - delta_i) "
         ": 0.f;", "        dst[(pa.j0 + kSG * m) * L.ps + i] = 0.f;"),
        ("        P[j * L.ps + i] = p;\n        dS[j * L.ps + i] = ok ? p * "
         "(ev - delta_j) : 0.f;",
         "        P[j * L.ps + i] = 0.f;\n        dS[j * L.ps + i] = 0.f;")],
    "one block": [
        ("(kSplitThreads, kCW == 1 ? 2 : 1)\nmosa_bwd_dq_kernel",
         "(kSplitThreads, 1)\nmosa_bwd_dq_kernel"),
        ("(kSplitThreads, kCW == 1 ? 2 : 1)\nmosa_bwd_dkv_kernel",
         "(kSplitThreads, 1)\nmosa_bwd_dkv_kernel")],
    "dk/dv 8 x 4": [
        ("  constexpr int kR = 4;\n  const PhaseA pa(tid, L.dpad);",
         "  constexpr int kR = kCW == 1 ? 8 : 4;\n"
         "  const PhaseA pa(tid, L.dpad);"),
        ("  cp_async_wait_all();\n\n  T* out_k",
         "  cp_async_wait_all();\n"
         "  if constexpr (PhaseB<kR>::kJS == 2) {\n"
         "    float* red = reinterpret_cast<float*>(base + L.own_bytes);\n"
         "    add_halves<kCW * kR * 4>(&ak[0][0][0], red, pb.js);\n"
         "    add_halves<kCW * kR * 4>(&av[0][0][0], red, pb.js);\n"
         "  }\n"
         "  if (pb.js != 0) return;\n\n  T* out_k"),
        ("  if (dq && L.bytes < L.own_bytes + red)",
         "  if (L.bytes < L.own_bytes + red)")],
}
VARIANTS = {"no phase A": ["A"], "no phase B": ["B"],
            "no tile copies": ["copies"], "no skipping": ["skipping"],
            "no phase A or B": ["A", "B"],
            "no A, B, P/dS math": ["A", "B", "P/dS math"],
            "skeleton": ["A", "B", "P/dS math", "copies"],
            "one block an SM": ["one block"],
            "dk/dv 8 x 4 tiles": ["dk/dv 8 x 4"]}
SHAPE = (8, 69, 128, 64)


def time_ms(torch, fn, flush, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def build_variants(build, variants, parts, out):
    """{"kernel": the library as it is, variant: its library}: each variant
    is a copy of ``build.CSRC`` under ``out`` with its parts' replacements
    made (each text must occur in some source), built with the port's own
    build.  Leaves ``build`` pointing at the last variant."""
    libs = {"kernel": build.library()}
    src = build.CSRC
    for name, names in variants.items():
        tag = "".join(c if c.isalnum() else "_" for c in name)
        vdir = out / ("csrc_" + tag)
        if vdir.exists():
            shutil.rmtree(vdir)
        shutil.copytree(src, vdir)
        files = {f: f.read_text() for f in vdir.iterdir()}
        for old, new in (r for part in names for r in parts[part]):
            hits = [f for f, text in files.items() if old in text]
            if not hits:
                sys.exit(f"{name}: {old!r} is in no source")
            for f in hits:
                files[f] = files[f].replace(old, new)
        for f, text in files.items():
            f.write_text(text)
        build.CSRC, build.BUILD_ROOT, build._LIBRARY = vdir, out / tag, None
        libs[name] = build.library()
    return libs


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("split_bwd_probe.py: no CUDA device")
    from repro_torch.kernels import build
    from repro_torch.kernels import mosa_backward as kb
    from repro_torch.kernels.mosa_attention import mosa_attention_fwd_res_ref

    libs = build_variants(build, VARIANTS, PARTS, OUT)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, S, d = SHAPE
    q, k, v = (torch.randn(B, H, S, d, device=dev, generator=gen)
               for _ in range(3))
    perm = torch.rand(B, H, 1023, device=dev, generator=gen).argsort(-1)
    idx = torch.cat([torch.zeros(B, H, 1, device=dev, dtype=torch.long),
                     perm[..., :S - 1] + 1], -1).sort(-1).values.int()
    r = torch.sigmoid(torch.randn(B, H, S, device=dev, generator=gen))
    o_pre, lse = mosa_attention_fwd_res_ref(q, k, v, idx)
    g = torch.randn(q.shape, device=dev, generator=gen)
    gt = (g * r[..., None]).contiguous()
    delta = (gt * o_pre).sum(-1).contiguous()
    args = (q, k, v, idx, gt, lse, delta)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; shape {SHAPE} fp32", flush=True)
    order = list(libs) + list(libs)[::-1]
    res = {name: {"dq_ms": [], "dkv_ms": []} for name in libs}
    for name in order:
        build._LIBRARY = libs[name]
        res[name]["dq_ms"].append(time_ms(
            torch, lambda: kb.mosa_attention_bwd_dq_cuda(*args), flush))
        res[name]["dkv_ms"].append(time_ms(
            torch, lambda: kb.mosa_attention_bwd_dkv_cuda(*args), flush))
    out = {}
    for name, t in res.items():
        out[name] = {key: sum(v) / len(v) for key, v in t.items()}
        print(f"  {name:20s} dq {out[name]['dq_ms']:.4f} ms  dk/dv "
              f"{out[name]['dkv_ms']:.4f} ms  (readings "
              f"{[round(x, 4) for x in t['dq_ms']]}, "
              f"{[round(x, 4) for x in t['dkv_ms']]})", flush=True)
    print(json.dumps({"card": smi, "shape": SHAPE, "times": out}))


if __name__ == "__main__":
    main()
