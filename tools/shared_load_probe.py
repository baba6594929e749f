#!/usr/bin/env python3
"""What a warp's 16-byte shared-memory load costs, by address pattern.

Run from the root of a checkout, on one NVIDIA GPU:

    python3 tools/shared_load_probe.py

It builds one small kernel with ``nvcc`` (a plain C interface, loaded with
``ctypes``, as the port's kernels) in which every thread of 8 blocks per
SM of 256 threads issues 4096 16-byte loads (``LDS.128``) from shared
memory, each feeding two FMAs, with the warp's addresses in one pattern:

  * ``32 addresses``         -- every lane its own 16 bytes, consecutive;
  * ``one address``          -- the whole warp the same 16 bytes;
  * ``4 addresses``          -- each quarter-warp (8 lanes) one address;
  * ``8 addresses``          -- lane % 8: every quarter-warp all 8;
  * ``8 rows, stride 68``    -- lane % 8 times 68 floats: 8 padded rows of
                                the split backward's staged tiles.

For each it prints the time of one launch (CUDA events) and the SM clocks
one warp's load costs at the card's boost clock (1.98 GHz on the H100 SXM).
The split backward kernels (``csrc/mosa_backward.cu``) give every
quarter-warp one address of their owned operand for this reason.  The
last line is one JSON object with every number.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "shared_load_probe"
SOURCE = r'''
#include <cuda_runtime.h>

__global__ void lds_probe(float* out, int iters, int mode) {
  __shared__ float4 buf[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x)
    buf[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  int idx;
  if (mode == 0) idx = lane;
  else if (mode == 1) idx = 0;
  else if (mode == 2) idx = lane / 8;
  else if (mode == 3) idx = lane % 8;
  else idx = (lane % 8) * 17;
  float a0 = 0.f, a1 = 0.f;
  int off = 0;
#pragma unroll 8
  for (int i = 0; i < iters; ++i) {
    const float4 x = buf[(idx + off) & 2047];
    a0 = fmaf(x.x, x.y, a0);
    a1 = fmaf(x.z, x.w, a1);
    off += 128;  // 2 KB on: the same banks
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = a0 + a1;
}

extern "C" int lds_probe_run(float* out, int blocks, int threads, int iters,
                             int mode) {
  lds_probe<<<blocks, threads>>>(out, iters, mode);
  return static_cast<int>(cudaGetLastError());
}
'''
PATTERNS = ["32 addresses", "one address", "4 addresses", "8 addresses",
            "8 rows, stride 68"]
THREADS, ITERS, BOOST_HZ = 256, 4096, 1.98e9


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("shared_load_probe.py: no CUDA device")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "probe.cu").write_text(SOURCE)
    so = OUT / "probe.so"
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(so),
                    str(OUT / "probe.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.lds_probe_run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = 8 * sms
    out = torch.empty(blocks * THREADS, device="cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    res = {}
    for mode, name in enumerate(PATTERNS):
        def run():
            rc = lib.lds_probe_run(out.data_ptr(), blocks, THREADS, ITERS,
                                   mode)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")
        run()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(5):
            run()
        e.record()
        torch.cuda.synchronize()
        ms = s.elapsed_time(e) / 5
        loads_per_sm = blocks * THREADS / 32 * ITERS / sms
        clk = ms * 1e-3 * BOOST_HZ / loads_per_sm
        res[name] = dict(ms=ms, clocks_per_warp_load=clk)
        print(f"  {name:20s} {ms:.3f} ms, {clk:.2f} SM clocks per warp's "
              "16-byte load", flush=True)
    print(json.dumps({"card": smi, "shared_loads": res}))


if __name__ == "__main__":
    main()
