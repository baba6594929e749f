#!/usr/bin/env python3
"""Where the window model's top-k selections rest on an exact fp32 tie.

Run from the root of a checkout, on one NVIDIA GPU:

    python3 tools/router_tie_probe.py

It builds chip_smoke's window model (``mosa-paper-tiny-mosa32`` with
``local_window=256``, the weights and the 8 x 1024 tokens of chip_smoke
[23]) and runs its layers under deterministic algorithms with the dense
heads on three routes: the flash kernel #9, the chunked route, and an
exact route (the same masked attention in fp64, rounded once to fp32).
It prints, per layer, how many (batch, head) selections of the flash
route differ from the chunked and the exact route's, the heads whose last
free top-k slot is an exact fp32 tie on the exact route with each route's
scores of the two tied tokens, and the error of #9 and of the chunked
route against fp64 on seeded inputs of the window shape.
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def exact_attention(torch, q, k, v, q_pos, k_pos, scale, window=0, **_):
    """The dense heads' masked attention in fp64, rounded once."""
    from repro_torch.core.attention import _mask_bias
    ok = _mask_bias(q_pos, k_pos, window) == 0
    B, Hq, Tq, d = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, Tq, d).double()
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.double()) * scale
    ok = ok.reshape(1, 1, 1, Tq, -1) if ok.dim() == 2 else ok[:, None, None]
    s = torch.where(ok, s, -1e300)
    p = torch.where(ok, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.double()) / p.sum(-1, True)
    return out.reshape(B, Hq, Tq, d).to(v.dtype)


def main():
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("router_tie_probe.py: no CUDA device")
    import chip_smoke as cs
    from repro_torch.core import attention as att
    from repro_torch.core.router import select_topk
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.nn.transformer import TransformerLM
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cs.slice_config(local_window=cs.WINDOW)
    with torch.no_grad():
        model = TransformerLM(cfg, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(0))
    model.eval()
    toks = torch.randint(2, cfg.vocab, (8, 1025),
                         generator=torch.Generator().manual_seed(4)).to(dev)
    chunked = att.chunked_attention

    def run(route):
        att.chunked_attention = (chunked if route != "exact" else
                                 lambda *a, **kw: exact_attention(torch, *a,
                                                                  **kw))
        impl = "kernel" if route == "flash" else "chunked"
        for layer in model.layers:
            layer.mixer.dense_impl = impl
        scores, sels = [], []
        with torch.no_grad():
            x = model.embed(toks[:, :-1])
            for layer in model.layers:
                sp = layer.mixer.sparse
                s = sp.router.scores(layer.norm1(x))
                sels.append(select_topk(s, sp.k_for(1024),
                                        sp.cfg.force_first_token)[1])
                scores.append(s)
                x, _ = layer(x)
        att.chunked_attention = chunked
        return scores, sels

    with cs.deterministic_algorithms(torch):
        R = {r: run(r) for r in ("flash", "chunked", "exact")}
    out = {"differ_from_chunked": [], "differ_from_exact": [],
           "ties_per_layer": [], "ties": []}
    for L in range(cfg.n_layers):
        for ref in ("chunked", "exact"):
            out[f"differ_from_{ref}"].append(int(
                (R["flash"][1][L] != R[ref][1][L]).any(-1).sum()))
        # the exact route's last free slot (the first token is forced)
        k = model.layers[L].mixer.sparse.k_for(1024) - 1
        free = R["exact"][0][L][..., 1:]
        vals, idx = free.sort(dim=-1, descending=True, stable=True)
        tied = (vals[..., k - 1] == vals[..., k]).nonzero().tolist()
        out["ties_per_layer"].append(len(tied))
        for b, h in tied[:4]:
            pair = [int(idx[b, h, k - 1]) + 1, int(idx[b, h, k]) + 1]
            out["ties"].append(dict(layer=L, batch=b, head=h, tokens=pair,
                                    scores={r: [R[r][0][L][b, h, t].item()
                                                for t in pair] for r in R}))
    g = torch.Generator(device=dev).manual_seed(3)
    q, kk, v = (torch.randn(8, 4, 1024, 64, device=dev, generator=g)
                for _ in range(3))
    pos = torch.arange(1024, device=dev)
    want = exact_attention(torch, q.double(), kk.double(), v.double(), pos,
                           pos, 64 ** -0.5, cs.WINDOW)
    for name, got in (("flash", kf.flash_attention(q, kk, v,
                                                   window=cs.WINDOW)),
                      ("chunked", chunked(q, kk, v, pos, pos, 64 ** -0.5,
                                          window=cs.WINDOW))):
        err = (got.double() - want).abs()
        out[f"{name}_err_vs_fp64"] = dict(max=err.max().item(),
                                          mean=err.mean().item())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
