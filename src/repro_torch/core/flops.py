"""The paper's FLOP accounting (App. A) — used for IsoFLOP matching.

These formulas reproduce the paper's published numbers exactly, and the tests
gate on that:
  * Table 4 forward-pass budgets (Tiny 54.76G … Large 1130.65G @ T=1024)
  * Table 5 FLOP-matched MoSA head counts (hybrid and pure)
"""

from __future__ import annotations

import dataclasses


def flops_dense_head(T: int, h: int, hp: int) -> int:
    """8hh'T (QKVO) + 4h'T^2 (attention)."""
    return 8 * h * hp * T + 4 * hp * T * T


def flops_mosa_head(T: int, k: int, h: int, hp: int) -> int:
    """8hh'k + 4h'k^2 + routing overhead (2hT + h'k)."""
    return 8 * h * hp * k + 4 * hp * k * k + 2 * h * T + hp * k


def flops_fixed_head(T: int, k: int, h: int, hp: int) -> int:
    return 8 * h * hp * k + 4 * hp * k * k


def flops_routing_head(T: int, k: int, h: int, hp: int) -> int:
    """rho (6hh'k + 4h'k^2) + 2h'T, rho = T/k (Q=K tying -> 3 projections)."""
    rho = T // k
    return rho * (6 * h * hp * k + 4 * hp * k * k) + 2 * hp * T


def flops_ffn(T: int, h: int, d_ff: int) -> int:
    """Two matmuls h<->d_ff: 4*h*d_ff*T  (paper uses d_ff=4h -> 16h^2T)."""
    return 4 * h * d_ff * T


@dataclasses.dataclass(frozen=True)
class PaperModel:
    """A dense baseline in the paper's hyperparameter space (App. C)."""

    name: str
    n_layers: int
    h: int
    d_ff: int
    hp: int
    n_heads: int

    def dense_flops(self, T: int = 1024) -> int:
        per_layer = self.n_heads * flops_dense_head(T, self.h, self.hp) \
            + flops_ffn(T, self.h, self.d_ff)
        return self.n_layers * per_layer

    def hybrid_mosa_heads(self, sparsity: int, T: int = 1024,
                          n_dense: int = 4) -> int:
        """Max MoSA heads s.t. hybrid FLOPs <= dense baseline (4 dense kept)."""
        k = T // sparsity
        budget = self.n_heads * flops_dense_head(T, self.h, self.hp)
        budget -= n_dense * flops_dense_head(T, self.h, self.hp)
        per = flops_mosa_head(T, k, self.h, self.hp)
        return max(0, budget // per)

    def pure_mosa_heads(self, sparsity: int, T: int = 1024) -> int:
        k = T // sparsity
        budget = self.n_heads * flops_dense_head(T, self.h, self.hp)
        return max(0, budget // flops_mosa_head(T, k, self.h, self.hp))

    def kv_total(self, T: int, n_dense: int, n_mosa: int, sparsity: int) -> int:
        """Paper's KV metric: KV = T*H_dense + k*H_mosa (Table 2)."""
        return T * n_dense + (T // sparsity) * n_mosa


# App. C, Table 4.
PAPER_MODELS = {
    "tiny": PaperModel("tiny", 6, 512, 2048, 64, 9),
    "small": PaperModel("small", 9, 1024, 4096, 64, 9),
    "medium": PaperModel("medium", 18, 1024, 4096, 64, 9),
    "large": PaperModel("large", 27, 1280, 5120, 64, 16),
}

# Published values for validation (Table 4, T=1024).
TABLE4_GFLOPS = {"tiny": 54.76, "small": 219.85, "medium": 430.70,
                 "large": 1130.65}

# Published hybrid-MoSA head counts (Table 5, bottom block).
TABLE5_HYBRID_HEADS = {
    "tiny": {2: 13, 4: 31, 8: 69, 16: 142, 32: 276, 64: 505, 128: 848, 256: 1277},
    "small": {2: 11, 4: 26, 8: 54, 16: 109, 32: 210, 64: 381},
}

# Table 5, pure-MoSA rows we can cross-check.
TABLE5_PURE_HEADS = {"tiny": {2: 23}}
