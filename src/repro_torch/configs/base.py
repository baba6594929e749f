"""Model configuration dataclasses + the architecture registry.

Plain-dataclass mirror of ``repro.configs.base``: the same classes with the
same field names (a test holds the field sets equal), so a configuration
reads identically in both packages.  Differences:

  * ``pdtype`` / ``cdtype`` return ``torch`` dtypes;
  * ``MoSAConfig.impl`` takes ``"einsum"`` (plain PyTorch, the port of the
    XLA path) or ``"kernel"`` (the hand-written CUDA kernel on a CUDA
    tensor, its plain version on a CPU tensor) — the counterpart of the JAX
    package's ``"pallas"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared_experts: int = 0
    d_shared: int = 0
    router_aux_loss: float = 0.01
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 128
    nope_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoSAConfig:
    """``n_mosa_heads`` expert-choice sparse heads (k = T/sparsity tokens per
    head) beside ``n_dense_heads`` dense heads (the paper's hybrid)."""

    n_mosa_heads: int
    sparsity: int = 32
    n_dense_heads: int = 4
    d_head: int = 64
    force_first_token: bool = True
    min_k: int = 2
    local_window: int = 0
    k_fixed: int = 0
    impl: str = "einsum"          # einsum | kernel
    selection_granularity: str = "token"
    sel_block_size: int = 16


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_layers: tuple = ()
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.333
    conv1d_kernel: int = 4
    qkv_block_size: int = 4


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    kind: str = "gqa"
    n_heads: int = 8
    n_kv_heads: int = 8
    d_head: int = 64
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int = 0
    mrope_sections: tuple = ()
    softmax_scale: Optional[float] = None
    mla: Optional[MLAConfig] = None


# ---------------------------------------------------------------------------
# Block / model
# ---------------------------------------------------------------------------

# mixer kinds: attn | attn_local | mosa | mamba | slstm | mlstm
# ffn kinds:   dense | moe | none
@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str
    ffn: str


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attention: AttentionConfig
    pattern: tuple = ()
    moe: Optional[MoEConfig] = None
    mosa: Optional[MoSAConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    norm: str = "rmsnorm"
    ffn_act: str = "swiglu"
    tie_embeddings: bool = False
    max_seq_len: int = 4096
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    frontend: str = "none"
    remat: str = "none"
    scan_layers: bool = True
    sparse_variant: str = "mosa"
    notes: str = ""

    def resolved_pattern(self) -> tuple:
        if self.pattern:
            if len(self.pattern) != self.n_layers:
                raise ValueError(f"{self.name}: pattern length "
                                 f"{len(self.pattern)} != n_layers "
                                 f"{self.n_layers}")
            return self.pattern
        ffn = "moe" if self.moe is not None else "dense"
        mixer = "mosa" if self.mosa is not None else "attn"
        return tuple(BlockSpec(mixer, ffn) for _ in range(self.n_layers))

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def with_mosa(self, sparsity: int = 32, n_mosa_heads: int | None = None,
                  local_window: int = 0, k_fixed: int = 0,
                  selection_granularity: str = "token",
                  sel_block_size: int = 16) -> "ModelConfig":
        """A MoSA-hybrid variant of this config (the paper's technique), as
        the JAX package's ``with_mosa``: every softmax-attention mixer
        (``attn``, ``attn_local``) becomes a ``mosa`` hybrid mixer (4 dense
        + N sparse heads of the config's d_head); attention-free mixers are
        untouched; a config with no attention raises.  The default N is the
        FLOP-matched ``max(1, n_heads - 4) * sparsity // 2``, and the name
        gains ``-mosa<sparsity>``."""
        pat = self.resolved_pattern()
        kinds = {b.mixer for b in pat}
        if not (kinds & {"attn", "attn_local"}):
            raise ValueError(f"{self.name}: MoSA inapplicable (attention-free)")
        if n_mosa_heads is None:
            n_mosa_heads = max(1, self.attention.n_heads - 4) * sparsity // 2
        mosa = MoSAConfig(n_mosa_heads=n_mosa_heads, sparsity=sparsity,
                          n_dense_heads=4, d_head=self.attention.d_head,
                          local_window=local_window, k_fixed=k_fixed,
                          selection_granularity=selection_granularity,
                          sel_block_size=sel_block_size)
        new_pat = tuple(
            dataclasses.replace(b, mixer="mosa")
            if b.mixer in ("attn", "attn_local") else b for b in pat)
        return dataclasses.replace(
            self, name=self.name + f"-mosa{sparsity}", pattern=new_pat,
            mosa=mosa)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(name: str, fn: Callable[..., ModelConfig]):
    _REGISTRY[name] = fn
    return fn


def config_names():
    _load_all()
    return sorted(_REGISTRY)


def get_config(name: str, preset: str = "full", **kw) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](preset=preset, **kw)


def _load_all():
    # Importing a config module registers it.  The ported ones: the paper's
    # own model family and the dense GQA architectures (ROADMAP A.9a, A.9b).
    from repro_torch.configs import (  # noqa: F401
        gemma3_4b, mosa_paper, musicgen_large, qwen2_1_5b, yi_34b, yi_9b)
