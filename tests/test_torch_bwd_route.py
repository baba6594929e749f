"""The MoSA backward's route and the kernel library's C signatures, on the
CPU.

  * ``fused_bwd_fits``: the fused kernel takes a row only when its S
    selected tokens fit one tile (S <= 64) and d <= 128;
  * ``mosa_attention_bwd_cuda`` takes the fused kernel where it fits and
    the split dq and dk/dv kernels otherwise (the wrappers are stubbed, so
    the route is checked without a card), and the fused wrapper refuses CPU
    tensors instead of falling back;
  * ``mosa_attention_bwd`` gives CPU tensors the plain version, bit for
    bit;
  * every ``extern "C" int repro_*(`` entry of ``src/repro_torch/csrc/*.cu``
    stands in ``build.SIGNATURES`` with the same parameter kinds in the same
    order (a ``c_int`` where the C side takes a pointer would cut the
    pointer on the card), and every signature names an entry.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import mosa_backward as kbwd

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "csrc"
_ENTRY = re.compile(r'extern "C" int (repro_\w+)\(([^)]*)\)')
_KIND = {build._P: "P", build._I: "I", build._F: "F"}


def c_entries():
    """{name: parameter kinds ("P", "I", "F")} of every C entry point."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in _ENTRY.findall(src.read_text()):
            kinds = []
            for p in params.split(","):
                p = " ".join(p.split())
                if "*" in p:
                    kinds.append("P")
                elif p.startswith("int "):
                    kinds.append("I")
                elif p.startswith("float "):
                    kinds.append("F")
                else:
                    raise AssertionError(f"{name}: unparsed parameter {p!r}")
            out[name] = "".join(kinds)
    return out


ENTRIES = c_entries()


@pytest.mark.parametrize("S", [1, 32, 64, 65, 70])
@pytest.mark.parametrize("d", [32, 64, 128, 129])
def test_fused_bwd_fits(S, d):
    assert kbwd.fused_bwd_fits(S, d) == (S <= 64 and d <= 128)


def _inputs(B=2, H=3, S=37, d=16, T=90, seed=0):
    """Expert-choice-like inputs as numpy draws: sorted distinct positions
    with token 0 forced and a few idx = -1 keys, two segments, and g~, lse
    and delta from the plain forward."""
    from repro_torch.kernels.mosa_attention import mosa_attention_fwd_res_ref
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, H, S, d))
                                   .astype(np.float32)) for _ in range(4))
    idx = np.stack([np.concatenate([[0], np.sort(rng.choice(
        np.arange(1, T), S - 1, replace=False))]) for _ in range(B * H)])
    idx = idx.reshape(B, H, S)
    idx.reshape(-1)[rng.choice(idx.size, min(5, idx.size - 1),
                               replace=False)] = -1
    idx = torch.from_numpy(idx.astype(np.int32))
    seg = torch.from_numpy((np.arange(S) >= S // 2).astype(np.int32)) \
        .expand(B, H, S).contiguous()
    r = torch.from_numpy(rng.uniform(0.1, 1.0, (B, H, S)).astype(np.float32))
    o_pre, lse = mosa_attention_fwd_res_ref(q, k, v, idx, seg=seg)
    gt = (g * r[..., None]).contiguous()
    delta = (gt * o_pre).sum(-1).contiguous()
    return (q, k, v, idx, gt, lse, delta), seg


@pytest.mark.parametrize("with_seg", [False, True])
def test_cpu_backward_is_the_plain_version(with_seg):
    args, seg = _inputs()
    seg = seg if with_seg else None
    got = kbwd.mosa_attention_bwd(*args, seg=seg)
    want = kbwd.mosa_attention_bwd_ref(*args, seg=seg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S,d,route", [(1, 16, "fused"), (37, 16, "fused"),
                                       (64, 128, "fused"), (65, 16, "split"),
                                       (70, 80, "split")])
def test_bwd_cuda_route(monkeypatch, S, d, route):
    """The route ``mosa_attention_bwd_cuda`` takes at (S, d), with the
    kernel wrappers replaced by recording stubs."""
    taken = []

    def stub(name, n_out):
        def fn(q, *args, **kwargs):
            taken.append(name)
            outs = tuple(torch.zeros_like(q) for _ in range(n_out))
            return outs[0] if n_out == 1 else outs
        return fn

    monkeypatch.setattr(kbwd, "mosa_attention_bwd_fused_cuda",
                        stub("fused", 3))
    monkeypatch.setattr(kbwd, "mosa_attention_bwd_dq_cuda", stub("dq", 1))
    monkeypatch.setattr(kbwd, "mosa_attention_bwd_dkv_cuda", stub("dkv", 2))
    args, seg = _inputs(B=1, H=1, S=S, d=d, T=2 * S + 1)
    dq, dk, dv = kbwd.mosa_attention_bwd_cuda(*args, seg=seg)
    assert taken == (["fused"] if route == "fused" else ["dq", "dkv"])
    assert dq.shape == dk.shape == dv.shape == args[0].shape


def test_fused_wrapper_refuses_cpu_tensors():
    args, seg = _inputs()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kbwd.mosa_attention_bwd_fused_cuda(*args, seg=seg)


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_c_entry_matches_its_ctypes_signature(name):
    assert name in build.SIGNATURES, f"{name} has no ctypes signature"
    kinds = "".join(_KIND[t] for t in build.SIGNATURES[name])
    assert kinds == ENTRIES[name], (
        f"{name}: C takes {ENTRIES[name]}, ctypes declares {kinds}")


def test_every_signature_names_a_c_entry():
    assert set(build.SIGNATURES) == set(ENTRIES)
    assert "repro_mosa_attention_bwd" in ENTRIES
