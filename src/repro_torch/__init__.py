"""PyTorch/CUDA port of the MoSA system (the JAX package ``repro`` is the
reference it is tested against).

The layout mirrors ``repro``: ``configs/``, ``core/``, ``nn/``, ``serve/``,
``kernels/``, ``optim/``, ``train/``, ``data/``, ``checkpoint/``, ``dist/``,
``launch/``.  This package imports ``torch`` and ``numpy``
only — never ``jax`` and never ``repro``.  Hand-written Hopper kernels live
under ``csrc/`` and are built with ``nvcc`` at first use
(``repro_torch.kernels.build``); on a CPU tensor every kernel wrapper runs
its plain PyTorch version instead.
"""
