"""yi-9b [arXiv:2403.04652; hf] — llama-arch GQA dense.

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""

from __future__ import annotations

from repro_torch.configs.base import AttentionConfig, ModelConfig, register


def _full():
    return ModelConfig(
        name="yi-9b", family="dense",
        n_layers=48, d_model=4096, d_ff=11008, vocab=64000,
        attention=AttentionConfig(kind="gqa", n_heads=32, n_kv_heads=4,
                                  d_head=128, rope_theta=10000.0),
        max_seq_len=32768,
        notes="pure full attention; long_500k in mosa_hybrid mode.")


def _smoke():
    return ModelConfig(
        name="yi-9b-smoke", family="dense",
        n_layers=2, d_model=64, d_ff=128, vocab=512,
        attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=1, d_head=16),
        max_seq_len=256, param_dtype="float32", compute_dtype="float32")


def config(preset: str = "full", **kw):
    return _full() if preset == "full" else _smoke()


register("yi-9b", config)
