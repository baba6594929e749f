"""gemma3-4b [hf:google/gemma-3-1b-pt; unverified].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144; 5:1 local:global
interleave (window 1024), 128k context.  Embedding scaled by sqrt(d_model)
(gemma convention).
"""

from __future__ import annotations

from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig, register


def _pattern(n_layers, period=6):
    # 5 local then 1 global per period; remainder layers local.
    return tuple(
        BlockSpec("attn" if (i % period) == period - 1 else "attn_local",
                  "dense")
        for i in range(n_layers))


def _full():
    return ModelConfig(
        name="gemma3-4b", family="dense",
        n_layers=34, d_model=2560, d_ff=10240, vocab=262144,
        pattern=_pattern(34),
        attention=AttentionConfig(kind="gqa", n_heads=8, n_kv_heads=4,
                                  d_head=256, rope_theta=1000000.0,
                                  window=1024),
        ffn_act="gelu", tie_embeddings=True, max_seq_len=131072,
        notes="local layers window=1024; global layers full attention. "
              "long_500k: global layers switch to MoSA (mosa_hybrid).")


def _smoke():
    return ModelConfig(
        name="gemma3-smoke", family="dense",
        n_layers=6, d_model=64, d_ff=128, vocab=512,
        pattern=_pattern(6),
        attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=2,
                                  d_head=16, window=16),
        ffn_act="gelu", tie_embeddings=True,
        max_seq_len=256, param_dtype="float32", compute_dtype="float32")


def config(preset: str = "full", **kw):
    return _full() if preset == "full" else _smoke()


register("gemma3-4b", config)
