#!/usr/bin/env python3
"""Where the streaming MoSA forward (#2, the route above S = 64) spends its
time.

Run from the root of a checkout, on one NVIDIA GPU:

    python3 tools/stream_fwd_probe.py

It builds variants of ``src/repro_torch/csrc/mosa_attention.cu`` and
``mosa_tiles.cuh`` (each with the port's build, ``kernels/build.py``, into
its own library, as ``tools/split_bwd_probe.py`` does):

  * ``kernel``         -- the source as it is;
  * ``no phase A``     -- the scores S = (scale q) k^T are not computed
                          (zeros): the time without the score products;
  * ``no phase B``     -- the output products P V are not computed;
  * ``no softmax``     -- the row maxes' and sums' shuffles and the
                          exponentials are not computed (P = the masked
                          scores, every correction 1);
  * ``no tile copies`` -- the key tiles' K and V are not copied (their
                          per-key words are);
  * ``no skipping``    -- every tile pair is computed, none skipped by
                          value;
  * ``no phase A or B`` -- neither product;
  * ``no A, B, softmax`` -- neither product nor the softmax;
  * ``skeleton``       -- all of the last and no tile copies: what is
                          left is the block's plan, its q copy and scaling,
                          the barriers and the stores.

Every variant but the first gives wrong outputs: only its time means
anything.  Each is timed (CUDA events, L2 flushed before every launch) at
the IsoFLOP sweep's mosa8 shape (8, 69, 128, 64), fp32, sorted idx, in the
order kernel, variants, variants reversed, kernel; the printed time is the
mean of a variant's two readings.  SDPA's forward with the bool mask on the
same inputs is timed beside them, as a yardstick.  The last line is one
JSON object with every number.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "stream_fwd_probe"
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from split_bwd_probe import build_variants, time_ms  # noqa: E402

# (part, [(text in a source, its replacement), ...])
PARTS = {
    "A": [("      for (int c = 0; c < L.dpad; c += 4) {\n"
           "        float4 x[4], y[4];",
           "      for (int c = 0; c < 0; c += 4) {\n"
           "        float4 x[4], y[4];")],
    "B": [("      for (int j = 0; j < kStream; j += 4) {\n"
           "        float pa[8][4];",
           "      for (int j = 0; j < 0; j += 4) {\n"
           "        float pa[8][4];")],
    "softmax": [
        ("          mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, o));",
         "          ;"),
        ("        for (int m = 0; m < 4; ++m) pr[m] = ok[m] ? expf(x[m] - "
         "m_new) : 0.f;", "        for (int m = 0; m < 4; ++m) pr[m] = x[m];"),
        ("        const float corr = expf(m_r[a] - m_new);",
         "        const float corr = 1.f;"),
        ("          sum += __shfl_xor_sync(kFullMask, sum, o);", "          ;")],
    "copies": [("    stage_rows(kv, L.dsT, src, ns, d, vec, tid, "
                "kStreamThreads);",
                "    if (false) stage_rows(kv, L.dsT, src, ns, d, vec, tid, "
                "kStreamThreads);")],
    "skipping": [("      need[t] = kQueries ? spans_meet(own, sp) : "
                  "spans_meet(sp, own);", "      need[t] = 1;")],
}
VARIANTS = {"no phase A": ["A"], "no phase B": ["B"],
            "no softmax": ["softmax"], "no tile copies": ["copies"],
            "no skipping": ["skipping"], "no phase A or B": ["A", "B"],
            "no A, B, softmax": ["A", "B", "softmax"],
            "skeleton": ["A", "B", "softmax", "copies"]}
SHAPE = (8, 69, 128, 64)


def main():
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("stream_fwd_probe.py: no CUDA device")
    from repro_torch.kernels import build
    from repro_torch.kernels import mosa_attention as km

    libs = build_variants(build, VARIANTS, PARTS, OUT)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, S, d = SHAPE
    q, k, v = (torch.randn(B, H, S, d, device=dev, generator=gen)
               for _ in range(3))
    perm = torch.rand(B, H, 1023, device=dev, generator=gen).argsort(-1)
    idx = torch.cat([torch.zeros(B, H, 1, device=dev, dtype=torch.long),
                     perm[..., :S - 1] + 1], -1).sort(-1).values.int()
    mask = (idx[..., :, None] >= idx[..., None, :]) & (idx >= 0)[..., None, :]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; shape {SHAPE} fp32", flush=True)
    order = list(libs) + list(libs)[::-1]
    res = {name: [] for name in libs}
    for name in order:
        build._LIBRARY = libs[name]
        res[name].append(time_ms(
            torch, lambda: km.mosa_attention_fwd_res_stream_cuda(q, k, v, idx),
            flush))
    sdpa = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), flush)
    out = {name: sum(t) / len(t) for name, t in res.items()}
    for name, t in res.items():
        print(f"  {name:20s} {out[name]:.4f} ms  (readings "
              f"{[round(x, 4) for x in t]})", flush=True)
    print(f"  SDPA forward (bool mask) {sdpa:.4f} ms", flush=True)
    print(json.dumps({"card": smi, "shape": SHAPE, "fwd_res_stream_ms": out,
                      "sdpa_ms": sdpa}))


if __name__ == "__main__":
    main()
