"""Build and load the hand-written CUDA kernels.

Every ``*.cu`` under ``repro_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into an object file (one ``nvcc`` per source, all started
together), and the objects are linked into one shared library with a plain
C interface, loaded with ``ctypes``.  The build runs at first use, into
``build/repro_torch/<hash>/`` at the root of the checkout (listed in
``.gitignore``), keyed by a hash of the sources and flags; a finished build
is reused.  Nothing here runs at import time.

``LaunchCounter`` is the per-kernel count of launches: a wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = GENCODE + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"
# dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the library's entry points (see the csrc sources).
SIGNATURES = {
    "repro_mosa_attention": [_P] * 7 + [_I] * 3 + [_F, _I, _P],
    "repro_mosa_attention_fwd_res": [_P] * 7 + [_I] * 3 + [_F, _I, _P],
    "repro_mosa_attention_bwd_dq": [_P] * 9 + [_I] * 3 + [_F, _I, _P],
    "repro_mosa_attention_bwd_dkv": [_P] * 10 + [_I] * 3 + [_F, _I, _P],
    "repro_mosa_attention_bwd": [_P] * 11 + [_I] * 3 + [_F, _I, _P],
    "repro_mosa_block_attention": [_P] * 7 + [_I] * 5 + [_F, _I, _P],
    "repro_mosa_block_attention_fwd_res": [_P] * 7 + [_I] * 5 + [_F, _I, _P],
    "repro_mosa_block_attention_bwd_dq": [_P] * 9 + [_I] * 5 + [_F, _I, _P],
    "repro_mosa_block_attention_bwd_dkv": [_P] * 10 + [_I] * 5 + [_F, _I, _P],
    "repro_mosa_block_attention_bwd": [_P] * 11 + [_I] * 5 + [_F, _I, _P],
    "repro_flash_attention": [_P] * 4 + [_I] * 8 + [_F, _I, _P],
    "repro_flash_attention_varlen": [_P] * 6 + [_I] * 6 + [_F, _I, _P],
    "repro_paged_attention_decode": [_P] * 6 + [_I] * 6 + [_F, _I, _P],
    "repro_paged_prefill_attention": [_P] * 9 + [_I] * 7 + [_F, _I, _P],
}


class LaunchCounter:
    """Plain integer count of one kernel's launches."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0


class KernelLibrary:
    """The built library: ``lib`` (ctypes handle), where it lives, and how
    long the build took (0 when an earlier build was reused)."""

    def __init__(self, path: pathlib.Path, build_seconds: float):
        self.path = path
        self.build_seconds = build_seconds
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


_LIBRARY: KernelLibrary | None = None


def library() -> KernelLibrary:
    """The kernel library, built on first use."""
    global _LIBRARY
    if _LIBRARY is None:
        t0 = time.perf_counter()
        path, built = _build()
        _LIBRARY = KernelLibrary(path, time.perf_counter() - t0 if built else 0.0)
    return _LIBRARY


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build() -> tuple[pathlib.Path, bool]:
    out_dir = BUILD_ROOT / source_hash()
    so = out_dir / LIB_NAME
    if so.exists():
        return so, False
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [pathlib.Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(sources, objs)]
        try:
            for src, p in zip(sources, procs):
                log, _ = p.communicate()
                (out_dir / (src.stem + ".log")).write_text(log)
                if p.returncode:
                    raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        tmp_so = pathlib.Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, *GENCODE, "-shared", "-o", str(tmp_so),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_so, so)   # atomic: concurrent builders never see half
    return so, True


def check_launch(rc: int, name: str):
    """Raise if a launcher returned a nonzero ``cudaGetLastError()``."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")


def check_tensor(name, t, shape, dtype, device):
    """Validate one kernel argument; raise on anything the kernel does
    not take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.requires_grad:
        raise ValueError(f"{name} requires grad; a kernel takes no autograd "
                         "inputs (differentiable calls go through the "
                         "autograd Functions of mosa_vjp and mosa_block)")
