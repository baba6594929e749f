"""yi-34b [arXiv:2403.04652; hf] — llama-arch GQA dense.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""

from __future__ import annotations

from repro_torch.configs.base import AttentionConfig, ModelConfig, register


def _full():
    return ModelConfig(
        name="yi-34b", family="dense",
        n_layers=60, d_model=7168, d_ff=20480, vocab=64000,
        attention=AttentionConfig(kind="gqa", n_heads=56, n_kv_heads=8,
                                  d_head=128, rope_theta=5000000.0),
        max_seq_len=32768,
        notes="pure full attention: long_500k runs in mosa_hybrid mode "
              "(MoSA global + sliding-window local), see DESIGN §5.")


def _smoke():
    return ModelConfig(
        name="yi-34b-smoke", family="dense",
        n_layers=2, d_model=64, d_ff=128, vocab=512,
        attention=AttentionConfig(kind="gqa", n_heads=8, n_kv_heads=2, d_head=8),
        max_seq_len=256, param_dtype="float32", compute_dtype="float32")


def config(preset: str = "full", **kw):
    return _full() if preset == "full" else _smoke()


register("yi-34b", config)
