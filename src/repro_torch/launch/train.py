"""CLI face of the port's training loop (``repro_torch.train.loop``).

  PYTHONPATH=src python -m repro_torch.launch.train --preset smoke \\
      --variant mosa --device cpu --steps 4

Runs on the card unless ``--device`` names another device, and raises
without CUDA.  The flags are ``repro.launch.train``'s, without
``--rule-set`` (no mesh yet) and with ``--device``; ``--mosa-impl kernel``
takes the hand-written MoSA kernels (their plain versions on the CPU).
``--isoflop`` raises until ``train/isoflop.py`` is ported.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.train.loop import TrainConfig, Trainer


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="mosa-paper")
    p.add_argument("--preset", default="smoke")
    p.add_argument("--variant", default=None,
                   help="mosa-paper variant: dense|mosa|pure")
    p.add_argument("--sparsity", type=int, default=None)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=200)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--microbatch", type=int, default=1,
                   help="gradient-accumulation splits per step")
    p.add_argument("--compute", default=None,
                   choices=[None, "bfloat16", "float32"],
                   help="bfloat16 = bf16-compute/fp32-master")
    p.add_argument("--remat", default=None,
                   choices=[None, "none", "full", "dots_saveable", "mosa"])
    p.add_argument("--mosa-impl", default=None,
                   choices=[None, "einsum", "kernel"],
                   help="kernel = the hand-written MoSA kernels (forward "
                        "with residuals + backward)")
    p.add_argument("--isoflop", action="store_true",
                   help="the FLOP-matched dense-vs-MoSA sweep (not ported)")
    p.add_argument("--no-health-in-step", action="store_true",
                   help="router health via a standalone forward at log time")
    p.add_argument("--device", default=None,
                   help="torch device; default the card (raises without "
                        "CUDA)")
    args = p.parse_args(argv)

    if args.isoflop:
        raise NotImplementedError("--isoflop needs train/isoflop.py, which "
                                  "is not ported yet (ROADMAP A)")
    akw = {}
    if args.variant is not None:
        akw["variant"] = args.variant
    if args.sparsity is not None:
        akw["sparsity"] = args.sparsity
    cfg = TrainConfig(arch=args.arch, preset=args.preset, steps=args.steps,
                      global_batch=args.batch, seq_len=args.seq, lr=args.lr,
                      warmup=args.warmup, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, log_every=args.log_every,
                      arch_kwargs=akw, microbatch=args.microbatch,
                      compute=args.compute, remat=args.remat,
                      mosa_impl=args.mosa_impl,
                      health_in_step=not args.no_health_in_step,
                      device=args.device)
    trainer = Trainer(cfg)
    _, _, history = trainer.run()
    print(json.dumps({"final": history[-1] if history else None}))


if __name__ == "__main__":
    main()
