"""musicgen-large [arXiv:2306.05284; hf] — decoder backbone over EnCodec tokens.

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.  The EnCodec frontend is a
STUB per the assignment: ``input_specs`` supplies precomputed frame
embeddings (B, T, d_model); the model trains/serves over them with the
2048-way codebook head.
"""

from __future__ import annotations

from repro_torch.configs.base import AttentionConfig, ModelConfig, register


def _full():
    return ModelConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, d_ff=8192, vocab=2048,
        attention=AttentionConfig(kind="gqa", n_heads=32, n_kv_heads=32,
                                  d_head=64, rope_theta=10000.0),
        ffn_act="gelu", norm="layernorm", frontend="audio_stub",
        max_seq_len=32768,
        notes="audio decoder backbone; EnCodec frontend stubbed")


def _smoke():
    return ModelConfig(
        name="musicgen-smoke", family="audio",
        n_layers=2, d_model=64, d_ff=128, vocab=128,
        attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=4, d_head=16),
        ffn_act="gelu", norm="layernorm", frontend="audio_stub",
        max_seq_len=256, param_dtype="float32", compute_dtype="float32")


def config(preset: str = "full", **kw):
    return _full() if preset == "full" else _smoke()


register("musicgen-large", config)
