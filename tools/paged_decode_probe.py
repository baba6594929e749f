#!/usr/bin/env python3
"""What holds the paged decode kernel (#11) above its byte bound.

Run from the root of a checkout, on one NVIDIA GPU:

    python3 tools/paged_decode_probe.py [--parent DIR]

It builds variants of ``src/repro_torch/csrc/paged_attention.cu`` with
``nvcc`` (each into its own library, a plain C interface as the port's):

  * ``kernel``       -- the source as it is;
  * ``2 blocks/SM``  -- the launch bounds asking for 2 blocks per SM at
                        every kR (more registers, fewer resident clusters);
  * ``no cluster``   -- the same grid and traffic with the cluster
                        barriers made block barriers and every read of a
                        peer's shared memory a read of the block's own: its
                        output is wrong, its time is what the cluster costs;

and, with ``--parent DIR``, the decode kernel of another checkout's
``DIR/repro_torch/csrc`` (e.g. an earlier commit unpacked with ``git
archive``).  For each it prints the registers and spills ``ptxas``
reports, how many 8-block clusters of the fp32, d 64, R 1 instantiation
fit the card at once (``cudaOccupancyMaxActiveClusters``), and the time
of one call (fp32, Hq = Hkv = 4 unless noted, d 64, 72 blocks of 16,
scattered tables, L2 flushed before every launch): CUDA events around the
C entry, and the kernel's device time from ``torch.profiler``, at the
serving slice (8 rows of 1025-1152 positions), one position per row (the
fixed latency), the Scheduler mix (8 rows of 128-1152), and the slice's
bytes as 32 rows of one KV head with identity tables (contiguous pages).
The last line is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "paged_decode_probe"

CLUSTERS = r'''
extern "C" int probe_max_clusters(int smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(256);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  repro::allow_smem(paged_decode_kernel<float, 64, 1>, smem);
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      &n, (void*)paged_decode_kernel<float, 64, 1>, &cfg);
  return e ? -static_cast<int>(e) : n;
}
'''
BOUNDS = "__launch_bounds__(kThreads, kR <= 4 ? 3 : 2)"
NO_CLUSTER = [
    ("__global__ void __cluster_dims__(kCluster, 1, 1) ", "__global__ void "),
    ("  cg::cluster_group cluster = cg::this_cluster();\n"
     "  const int rank = static_cast<int>(cluster.block_rank());",
     "  const int rank = blockIdx.x % kCluster;"),
    ("cluster.sync();", "__syncthreads();"),
    ("*cluster.map_shared_rank(mx + r, c)", "mx[r]"),
    ("*cluster.map_shared_rank(mrg + rank * share + e % share, e / share)",
     "mrg[rank * share + e % share]"),
    ("*cluster.map_shared_rank(lall + rank * kMaxR + r, c)",
     "lall[c * kMaxR + r]"),
]
VARIANTS = {
    "kernel": [],
    "2 blocks/SM": [(BOUNDS, "__launch_bounds__(kThreads, 2)")],
    "no cluster": NO_CLUSTER,
}
SLICE = [1088, 1087, 1025, 1100, 1152, 1040, 1151, 1096]
MIX = [130, 1152, 517, 260, 1024, 700, 128, 900]
CASES = {          # rows' lengths, KV heads (= query heads), identity tables
    "slice": (SLICE, 4, False),
    "1 position per row": ([1] * 8, 4, False),
    "Scheduler mix": (MIX, 4, False),
    "slice bytes as 32 rows x 1 head, identity tables": (SLICE * 4, 1, True),
}


def write_variant(name, src_dir, subs, clusters):
    d = OUT / name.replace(" ", "_").replace("/", "_")
    d.mkdir(parents=True)
    shutil.copy(src_dir / "common.cuh", d / "common.cuh")
    s = (src_dir / "paged_attention.cu").read_text()
    for a, b in subs:
        if a not in s:
            raise SystemExit(f"variant {name!r}: {a!r} not in the source")
        s = s.replace(a, b)
    if clusters:
        s += CLUSTERS
    (d / "k.cu").write_text(s)
    return d


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path,
                    help="a checkout's src directory whose decode kernel "
                         "to time beside this one")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("paged_decode_probe.py: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels.build import NVCC_FLAGS, SIGNATURES, _nvcc
    from repro_torch.serve.paged_attention import decode_grid

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    dirs = {n: write_variant(n, CSRC, subs, n != "no cluster")
            for n, subs in VARIANTS.items()}
    if args.parent:
        dirs["parent"] = write_variant(
            "parent", args.parent.resolve() / "repro_torch" / "csrc", [],
            False)
    nvcc = _nvcc()
    procs = {n: subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
         str(d / "k.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for n, d in dirs.items()}
    smem = decode_grid(8, 4, 4, 64, 72, 16)[2]
    res = {"card": smi, "variants": {}}
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on {n}:\n{log}")
        lib = ctypes.CDLL(str(dirs[n] / "lib.so"))
        fn = lib.repro_paged_attention_decode
        fn.argtypes = SIGNATURES["repro_paged_attention_decode"]
        fn.restype = ctypes.c_int
        libs[n] = fn
        regs = sorted({int(w) for line in log.splitlines()
                       if "registers" in line
                       for w in [line.split("Used ")[1].split()[0]]})
        spills = sorted({int(line.split("bytes spill stores")[0].split()[-1])
                         for line in log.splitlines()
                         if "spill stores" in line})
        v = {"registers": regs, "spill_store_bytes": spills}
        if n not in ("no cluster", "parent"):
            lib.probe_max_clusters.argtypes = [ctypes.c_int]
            v["max_active_clusters"] = lib.probe_max_clusters(smem)
        res["variants"][n] = v
        print(n, json.dumps(v), flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    res["cases"] = {}
    for case, (lens, H, identity) in CASES.items():
        B = len(lens)
        q, kp, vp, table, lengths = cs.paged_inputs(torch, B, H, H, 64, 16, 72,
                                                    lens, dev, gen)
        if identity:
            table = torch.arange(B * 72, device=dev,
                                 dtype=torch.int32).view(B, 72).contiguous()
        out = torch.empty_like(q)

        def call(fn):
            rc = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    table.data_ptr(), lengths.data_ptr(), out.data_ptr(), B,
                    H, H, 64, 16, 72, 0.125, 0, stream)
            if rc:
                raise SystemExit(f"launch failed: {rc}")
            return out

        row = {}
        for n, fn in list(libs.items()) + list(libs.items())[::-1]:
            row.setdefault(n, {}).setdefault("event_ms", []).append(
                cs.time_ms(torch, lambda: call(fn), iters=50, flush=flush))
        for n, fn in libs.items():       # the profiler after every event
            row[n]["device_ms"] = cs.device_ms_by_kernel(
                torch, lambda: call(fn), flush,
                ("paged_decode_kernel",))["paged_decode_kernel"]
        res["cases"][case] = row
        print(case, json.dumps(row), flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
