"""CLI face of the port's training loop (``repro_torch.train.loop``).

  PYTHONPATH=src python -m repro_torch.launch.train --preset smoke \\
      --variant mosa --device cpu --steps 4

  # the paper's IsoFLOP sweep (dense vs MoSA at one matched budget):
  PYTHONPATH=src python -m repro_torch.launch.train --isoflop \\
      --preset smoke --device cpu --steps 2 --batch 2 --seq 64

  # on a mesh: one process per device, the mesh from elastic_plan
  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 4 -m repro_torch.launch.train --preset smoke \
      --variant mosa --rule-set fsdp_tp --steps 4

Runs on the card unless ``--device`` names another device, and raises
without CUDA (``--device cpu`` under ``torch.distributed.run`` takes
gloo).  The flags are ``repro.launch.train``'s, with ``--device``;
``--rule-set`` places the parameters on the mesh (``tp`` or ``fsdp_tp``)
that a world above 1 brings; ``--mosa-impl kernel`` takes the
hand-written MoSA kernels (their plain versions on the CPU).  The final
JSON carries the straggler monitor's summary.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.train.loop import TrainConfig, Trainer


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="mosa-paper")
    p.add_argument("--preset", default="smoke")
    p.add_argument("--variant", default=None,
                   help="mosa-paper variant: dense|mosa|fixed|routing|pure")
    p.add_argument("--sparsity", type=int, default=None)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=200)
    p.add_argument("--rule-set", default="tp", choices=["tp", "fsdp_tp"])
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--microbatch", type=int, default=1,
                   help="gradient-accumulation splits per step")
    p.add_argument("--compute", default=None,
                   choices=[None, "bfloat16", "float32"],
                   help="bfloat16 = bf16-compute/fp32-master")
    p.add_argument("--remat", default=None,
                   choices=[None, "none", "full", "dots_saveable", "mosa"],
                   help="per-block activation remat: none, full (keep the "
                        "block inputs), dots_saveable (keep the matmul "
                        "outputs) or mosa (keep the MoSA gather and router "
                        "scores)")
    p.add_argument("--mosa-impl", default=None,
                   choices=[None, "einsum", "kernel"],
                   help="kernel = the hand-written MoSA kernels (forward "
                        "with residuals + backward)")
    p.add_argument("--isoflop", action="store_true",
                   help="run the FLOP-matched dense-vs-MoSA sweep instead "
                        "of a single config")
    p.add_argument("--metrics-path", default=None,
                   help="write an obs metrics snapshot here on exit "
                        "(.jsonl appends)")
    p.add_argument("--trace-path", default=None,
                   help="write a Chrome-trace JSON of the run here on exit")
    p.add_argument("--no-health-in-step", action="store_true",
                   help="router health via a standalone forward at log time")
    p.add_argument("--device", default=None,
                   help="torch device; default the card (raises without "
                        "CUDA)")
    args = p.parse_args(argv)

    if args.isoflop:
        from repro_torch.train.isoflop import isoflop_sweep, run_isoflop
        points = isoflop_sweep(
            preset=args.preset, T=args.seq,
            sparsities=(args.sparsity,) if args.sparsity else (8,))
        results = run_isoflop(
            points, steps=args.steps, seq_len=args.seq,
            global_batch=args.batch, ckpt_root=args.ckpt_dir,
            train_kw={"lr": args.lr, "warmup": args.warmup,
                      "log_every": args.log_every,
                      "microbatch": args.microbatch,
                      "compute": args.compute, "remat": args.remat,
                      "mosa_impl": args.mosa_impl, "device": args.device,
                      "metrics_path": args.metrics_path,
                      "trace_path": args.trace_path})
        print(json.dumps(results, indent=2, default=float))
        return
    akw = {}
    if args.variant is not None:
        akw["variant"] = args.variant
    if args.sparsity is not None:
        akw["sparsity"] = args.sparsity
    cfg = TrainConfig(arch=args.arch, preset=args.preset, steps=args.steps,
                      global_batch=args.batch, seq_len=args.seq, lr=args.lr,
                      warmup=args.warmup, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, log_every=args.log_every,
                      rule_set=args.rule_set,
                      arch_kwargs=akw, microbatch=args.microbatch,
                      compute=args.compute, remat=args.remat,
                      mosa_impl=args.mosa_impl,
                      health_in_step=not args.no_health_in_step,
                      metrics_path=args.metrics_path,
                      trace_path=args.trace_path, device=args.device)
    trainer = Trainer(cfg)
    _, _, history = trainer.run()
    if trainer.rank == 0:
        print(json.dumps({"final": history[-1] if history else None,
                          "straggler": trainer.monitor.summary()}))
    if trainer.mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
