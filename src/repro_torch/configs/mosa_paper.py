"""The paper's own model family (App. C Table 4) as configs.

``mosa-paper`` with ``size`` tiny|small|medium|large and ``variant``
dense | mosa | fixed | routing | pure, exactly as ``repro.configs.mosa_paper``
builds them.  Head counts come from the IsoFLOP solver in
``repro_torch.core.flops`` (Table 5: 276 MoSA heads for tiny at sparsity 32).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (AttentionConfig, BlockSpec, ModelConfig,
                                      MoSAConfig, register)
from repro_torch.core.flops import PAPER_MODELS


def paper_config(size: str = "tiny", variant: str = "dense",
                 sparsity: int = 32, seq_len: int = 1024,
                 n_mosa_heads: int | None = None,
                 local_window: int = 0, dtype: str = "float32",
                 selection_granularity: str = "token",
                 sel_block_size: int = 16) -> ModelConfig:
    pm = PAPER_MODELS[size]
    base = dict(
        family="dense", n_layers=pm.n_layers, d_model=pm.h, d_ff=pm.d_ff,
        vocab=8000, max_seq_len=seq_len,
        param_dtype=dtype, compute_dtype=dtype,
        attention=AttentionConfig(kind="gqa", n_heads=pm.n_heads,
                                  n_kv_heads=pm.n_heads, d_head=pm.hp),
        ffn_act="gelu", tie_embeddings=False)
    if variant == "dense":
        return ModelConfig(name=f"mosa-paper-{size}", **base)

    if variant == "pure":
        n_sparse = n_mosa_heads or pm.pure_mosa_heads(sparsity, seq_len)
        n_dense = 0
    else:
        n_sparse = n_mosa_heads or pm.hybrid_mosa_heads(sparsity, seq_len)
        n_dense = 4
    mosa = MoSAConfig(n_mosa_heads=max(n_sparse, 1), sparsity=sparsity,
                      n_dense_heads=n_dense, d_head=pm.hp,
                      local_window=local_window,
                      selection_granularity=selection_granularity,
                      sel_block_size=sel_block_size)
    pattern = tuple(BlockSpec("mosa", "dense") for _ in range(pm.n_layers))
    name = f"mosa-paper-{size}-{variant}{sparsity}"
    sparse_variant = variant if variant in ("fixed", "routing") else "mosa"
    return ModelConfig(name=name, pattern=pattern, mosa=mosa,
                       sparse_variant=sparse_variant, **base)


def config(preset: str = "full", size: str = "tiny", variant: str = "dense",
           **kw):
    if preset == "smoke":
        cfg = paper_config("tiny", variant, sparsity=kw.pop("sparsity", 8),
                           seq_len=kw.pop("seq_len", 128), **kw)
        return dataclasses.replace(cfg, n_layers=2, vocab=512,
                                   name=cfg.name + "-smoke",
                                   pattern=cfg.pattern[:2] if cfg.pattern else ())
    return paper_config(size, variant, **kw)


register("mosa-paper", config)
