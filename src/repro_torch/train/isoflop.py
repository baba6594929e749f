"""IsoFLOP sweep protocol (paper §4 / App. A) over the resumable loop
(port of ``repro.train.isoflop``).

The paper's headline claim is FLOP-matched: at a fixed forward-pass budget
(the dense baseline's), a hybrid that trades its dense heads for
``hybrid_mosa_heads(sparsity)`` MoSA heads reaches lower perplexity.
``repro_torch.core.flops`` reproduces the published budget tables (Table
4) and head counts (Table 5); this module turns those numbers into
runnable configs and drives ``repro_torch.train.loop.Trainer`` over them:

  * ``isoflop_sweep``  — the (variant, sparsity) grid at one model size /
    budget, every point carrying its analytic per-token forward FLOPs so the
    match is auditable;
  * ``run_isoflop``    — trains each point through the resumable loop (own
    checkpoint directory per point: a preempted sweep resumes mid-point)
    and reports final loss/ppl and the FLOP accounting (per-token forward,
    3x for the train step, totals for the run).

The accounting is the JAX package's, unchanged: ``analytic_flops_per_token``
counts ``n_mosa_heads`` heads of the sparse variant, while the routing
layer builds ``max(1, n_mosa_heads // sparsity)`` (``core.hybrid``), so a
routing point reads far over the dense budget (ROADMAP C records it as a
property of the reference).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.flops import (flops_dense_head, flops_ffn,
                                    flops_fixed_head, flops_mosa_head,
                                    flops_routing_head)


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    name: str
    variant: str                 # dense | mosa | fixed | routing | pure
    sparsity: int                # 1 for dense
    cfg: ModelConfig
    flops_fwd_per_token: int     # analytic forward FLOPs / token (App. A)


def analytic_flops_per_token(cfg: ModelConfig, T: int) -> int:
    """Per-token forward FLOPs of one config under the paper's App. A
    accounting (attention + FFN; embeddings excluded like the paper).

    ``k`` is the selection width the model runs — ``MoSAAttention.k_for``
    with its ``min_k`` floor and T-clamps — not the bare ``T // sparsity``
    of the solver: at small T / high sparsity the floor dominates."""
    h = cfg.d_model
    per_layer = flops_ffn(T, h, cfg.d_ff)
    if cfg.mosa is None:
        per_layer += cfg.attention.n_heads * flops_dense_head(
            T, h, cfg.attention.d_head)
    else:
        m = cfg.mosa
        if m.k_fixed > 0:                          # MoSAAttention.k_for
            k = min(m.k_fixed, T)
        else:
            k = max(min(T // m.sparsity, T), min(m.min_k, T))
        per_layer += m.n_dense_heads * flops_dense_head(T, h, m.d_head)
        head_fn = {"mosa": flops_mosa_head, "fixed": flops_fixed_head,
                   "routing": flops_routing_head}[cfg.sparse_variant]
        per_layer += m.n_mosa_heads * head_fn(T, k, h, m.d_head)
    return cfg.n_layers * per_layer // T


def isoflop_sweep(size: str = "tiny", sparsities: Sequence[int] = (8, 32),
                  T: int = 1024, preset: str = "full",
                  variants: Sequence[str] = ("dense", "mosa"),
                  **arch_kw) -> list[SweepPoint]:
    """The FLOP-matched grid at one budget: the dense baseline plus one
    point per (variant, sparsity), head counts from the Table-5 solver."""
    points = []
    for variant in variants:
        for sp in ((1,) if variant == "dense" else tuple(sparsities)):
            kw = dict(size=size, variant=variant, seq_len=T, **arch_kw)
            if variant != "dense":
                kw["sparsity"] = sp
            cfg = get_config("mosa-paper", preset=preset, **kw)
            points.append(SweepPoint(
                name=cfg.name, variant=variant, sparsity=sp, cfg=cfg,
                flops_fwd_per_token=analytic_flops_per_token(cfg, T)))
    return points


def budget_match_error(points: Sequence[SweepPoint]) -> float:
    """Max relative deviation of any point's budget from the dense
    baseline's (the solver floors head counts, so MoSA points sit at or
    just under the budget)."""
    dense = [p for p in points if p.variant == "dense"]
    if not dense:
        raise ValueError("sweep has no dense baseline")
    ref = dense[0].flops_fwd_per_token
    return max(abs(p.flops_fwd_per_token - ref) / ref for p in points)


def run_isoflop(points: Sequence[SweepPoint], steps: int, seq_len: int,
                global_batch: int, ckpt_root: Optional[str] = None,
                train_kw: Optional[dict] = None) -> dict:
    """Train every sweep point through the resumable loop.

    Each point checkpoints under ``<ckpt_root>/<point.name>``: rerunning
    the same sweep after a kill resumes each point from its last boundary
    (``Trainer.restore_or_init``).  ``train_kw``: further ``TrainConfig``
    fields (``device``, ``mosa_impl``, ``metrics_path``...).  Returns
    {point name: {final metrics, FLOP accounting, loss curve}}."""
    from repro_torch.train.loop import TrainConfig, Trainer

    results = {}
    for pt in points:
        cfg = TrainConfig(
            seq_len=seq_len, global_batch=global_batch, steps=steps,
            ckpt_dir=(os.path.join(ckpt_root, pt.name)
                      if ckpt_root else None),
            **(train_kw or {}))
        trainer = Trainer(cfg, model_cfg=pt.cfg)
        _, _, history = trainer.run(install_signals=False)
        final = history[-1] if history else {}
        tokens = steps * global_batch * seq_len
        results[pt.name] = {
            "variant": pt.variant,
            "sparsity": pt.sparsity,
            "flops_fwd_per_token": pt.flops_fwd_per_token,
            # fwd + bwd ~ 3x fwd (the standard train-step accounting)
            "flops_train_per_token": 3 * pt.flops_fwd_per_token,
            "flops_total": 3 * pt.flops_fwd_per_token * tokens,
            "tokens": tokens,
            "final": {k: final.get(k) for k in
                      ("step", "loss", "ppl", "ce") if k in final},
            "loss_curve": [{"step": h["step"], "loss": h["loss"]}
                           for h in history],
        }
    return results
