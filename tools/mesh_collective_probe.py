#!/usr/bin/env python3
"""What one tensor-parallel collective of the serving path costs the host
on a world-1 NCCL mesh, beside the copy it wraps.

Run from the root of a checkout, on one NVIDIA GPU:

    python3 tools/mesh_collective_probe.py

A decode step of ``mosa-paper-tiny-mosa32`` on a (1, 1) mesh makes 14
collectives: per layer the mixer's and the MLP's ``reduce_from`` (a clone
and an all-reduce of 8 x 512 fp32), the embedding's, and the logits'
``gather_last`` (an all-gather of 8 x 8000).  For each, and for the clone
alone, this times ``N`` calls back to back on the host clock (one
``torch.cuda.synchronize`` at the end) and with CUDA events around the
same ``N`` calls, with and without deterministic algorithms, and prints
microseconds per call.  It also prints the ``TORCH_NCCL_*`` and ``NCCL_*``
settings of the environment.  The last line is one JSON object with every
number.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 2000


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("mesh_collective_probe.py: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.dist.parallel import TensorParallel, gather_last, \
        reduce_from
    from repro_torch.launch import mesh as mesh_lib
    path = tempfile.mktemp(prefix="collective_probe_")
    mesh_lib.init_process_group("cuda", init_method=f"file://{path}",
                                world_size=1, rank=0)
    mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
    tp = TensorParallel(mesh.get_group("model"), 0, 1)
    env = {k: v for k, v in os.environ.items()
           if k.startswith(("TORCH_NCCL", "NCCL_"))}
    print(f"environment: {env}")
    x = torch.randn(8, 1, 512, device="cuda")
    logits = torch.randn(8, 1, 8000, device="cuda")
    calls = {
        "clone": lambda: x.contiguous().clone(),
        "reduce_from": lambda: reduce_from(x, tp),
        "gather_last": lambda: gather_last(logits, tp),
    }
    out = {"env": env, "n": N, "us_per_call": {}}
    for det in (False, True):
        torch.use_deterministic_algorithms(det, warn_only=True)
        for name, fn in calls.items():
            with torch.inference_mode():
                for _ in range(50):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(N):
                    fn()
                host = (time.perf_counter() - t0) / N * 1e6
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / N * 1e6
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                for _ in range(N):
                    fn()
                e.record()
                torch.cuda.synchronize()
                dev = s.elapsed_time(e) / N * 1e3
            key = f"{name}{' (deterministic)' if det else ''}"
            out["us_per_call"][key] = dict(host_enqueue=host, wall=wall,
                                           events=dev)
            print(f"{key:32s} enqueue {host:8.2f} us, with the sync "
                  f"{wall:8.2f} us, events {dev:8.2f} us a call")
    torch.use_deterministic_algorithms(False)
    torch.distributed.destroy_process_group()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
