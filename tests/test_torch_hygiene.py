"""Import hygiene of the port and its device policy: ``repro_torch``
imports neither JAX nor the JAX package, imports no kernel toolchain at
import time, and its entry points refuse to fall back to the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = ("jax", "repro", "triton")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax_and_no_reference_package():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 10
    bad = [(str(f.relative_to(SRC)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_imports_with_jax_and_reference_blocked():
    """A fresh interpreter where ``import jax`` / ``import repro`` fail still
    imports the whole serving (batch and Scheduler) and training paths,
    block choice's and the flash kernels included."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None;"
            "sys.modules['triton'] = None;"
            "import repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.kernels.build, repro_torch.kernels.mosa_vjp, "
            "repro_torch.kernels.mosa_block, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.launch.train, repro_torch.serve.scheduler, "
            "repro_torch.obs, repro_torch.serve.loadgen, "
            "repro_torch.serve.prefix_cache; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_imports_no_jax():
    root = SRC.parent
    mods = list(_imports(root / "chip_smoke.py"))
    assert not [m for m in mods if m.split(".")[0] in ("jax", "repro")], mods


def test_server_refuses_cpu_fallback(monkeypatch):
    """``Server(cfg)`` means the card: with no CUDA device it raises rather
    than running on the CPU."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import Server
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("mosa-paper", preset="smoke", variant="mosa")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(cfg, batch=1, max_len=32)


def test_serve_cli_refuses_cpu_fallback(monkeypatch):
    """``python -m repro_torch.launch.serve`` without ``--device`` means the
    card: with no CUDA device it raises rather than running on the CPU."""
    from repro_torch.launch.serve import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--preset", "smoke", "--variant", "mosa", "--batch", "1",
              "--prompt-len", "4", "--gen", "2", "--max-len", "16"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--preset", "smoke", "--variant", "mosa", "--load-rate", "1"])
