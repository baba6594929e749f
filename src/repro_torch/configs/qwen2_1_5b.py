"""qwen2-1.5b [arXiv:2407.10671; hf] — dense GQA with QKV bias.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936; tied embeddings.
"""

from __future__ import annotations

from repro_torch.configs.base import AttentionConfig, ModelConfig, register


def _full():
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, d_ff=8960, vocab=151936,
        attention=AttentionConfig(kind="gqa", n_heads=12, n_kv_heads=2,
                                  d_head=128, qkv_bias=True,
                                  rope_theta=1000000.0),
        tie_embeddings=True, max_seq_len=32768,
        notes="QKV bias; long_500k in mosa_hybrid mode.")


def _smoke():
    return ModelConfig(
        name="qwen2-smoke", family="dense",
        n_layers=2, d_model=64, d_ff=128, vocab=512,
        attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=2,
                                  d_head=16, qkv_bias=True),
        tie_embeddings=True, max_seq_len=256,
        param_dtype="float32", compute_dtype="float32")


def config(preset: str = "full", **kw):
    return _full() if preset == "full" else _smoke()


register("qwen2-1.5b", config)
