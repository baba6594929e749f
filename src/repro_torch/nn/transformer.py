"""Transformer assembly: blocks, LM head, loss, serving (port of
``repro.nn.transformer``).

The JAX package scans a periodic run of layers over stacked parameters;
here the layers are a plain ``nn.ModuleList`` walked by a Python loop, and
the serving caches are a list with one entry per layer.  ``find_period``
is kept: the weight converter needs it to unstack the JAX parameters.

Training: ``forward`` (fp32 logits, aux loss), ``backbone`` (optionally
with the router health of every MoSA layer) and ``loss`` (masked next-token
cross-entropy; packed rows through ``segments``/``positions``).  Remat
``none`` and ``full`` (``torch.utils.checkpoint`` per block, non-reentrant:
the block's forward runs again in the backward); ``mosa`` and
``dots_saveable`` are not ported yet.

Ported mixers: ``mosa`` (the hybrid) and ``attn``; FFN: ``dense``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.core.attention import MultiHeadAttention
from repro_torch.core.hybrid import HybridAttention
from repro_torch.core.kv_cache import DenseKVCache
from repro_torch.nn.ffn import MLP
from repro_torch.nn.layers import Embedding, LayerNorm, Linear, RMSNorm
from repro_torch.serve.paged_kv import PagedDenseKVCache


def sample_logits(logits, generator: torch.Generator | None = None,
                  temperature: float = 0.0, top_k: int = 0):
    """Sample next tokens from (B, V) logits on their device.  Greedy
    (argmax) when ``temperature <= 0``.  Returns (B,) int64."""
    logits = logits.float()
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if temperature <= 0.0:
        return logits.argmax(-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def find_period(pattern, max_head: int = 4):
    """Locate the largest scannable periodic run, allowing a few unrolled
    head layers before it.  Returns (head_end, p, n_units, tail_start):
    layers [0, head_end) and [tail_start, n) are unrolled; [head_end,
    tail_start) are ``n_units`` super-blocks of period ``p``.  (0, 0, 0, 0)
    = all unrolled.  Same result as the JAX package's function."""
    n = len(pattern)
    best = (0, 0, 0, 0, 0)  # coverage, -head, head, p, units
    for head in range(0, min(max_head, n) + 1):
        sub = pattern[head:]
        m = len(sub)
        for p in range(1, m // 2 + 1):
            units = m // p
            if units < 2:
                break
            prefix = units * p
            if all(sub[i] == sub[i % p] for i in range(prefix)):
                cand = (prefix, -head, head, p, units)
                if cand > best:
                    best = cand
                break
    if best[0] == 0:
        return 0, 0, 0, 0
    _, _, head, p, units = best
    return head, p, units, head + p * units


class Block(nn.Module):
    """norm -> mixer -> +residual; norm -> ffn -> +residual (pre-LN)."""

    def __init__(self, cfg: ModelConfig, spec: BlockSpec, device=None):
        super().__init__()
        self.cfg, self.spec = cfg, spec
        c = cfg
        norm = RMSNorm if c.norm == "rmsnorm" else LayerNorm
        self.norm1 = norm(c.d_model, param_dtype=c.pdtype,
                          compute_dtype=c.cdtype, device=device)
        if spec.mixer == "mosa":
            self.mixer = HybridAttention(
                c.d_model, c.mosa, c.attention.rope_theta, rotary_frac=0.5,
                param_dtype=c.pdtype, compute_dtype=c.cdtype,
                variant=c.sparse_variant, impl=c.mosa.impl, device=device)
        elif spec.mixer == "attn":
            acfg = c.attention
            if acfg.window:
                raise NotImplementedError("window attention is not ported yet")
            self.mixer = MultiHeadAttention(c.d_model, acfg, c.pdtype,
                                            c.cdtype, rotary_frac=1.0,
                                            device=device)
        else:
            raise NotImplementedError(f"mixer {spec.mixer!r} is not ported yet")
        if spec.ffn == "dense":
            self.norm2 = norm(c.d_model, param_dtype=c.pdtype,
                              compute_dtype=c.cdtype, device=device)
            self.ffn = MLP(c.d_model, c.d_ff, c.ffn_act, c.pdtype, c.cdtype,
                           device=device)
        else:
            raise NotImplementedError(f"ffn {spec.ffn!r} is not ported yet")

    def init(self, generator: torch.Generator):
        for m in (self.norm1, self.mixer, self.norm2, self.ffn):
            m.init(generator)

    def _ffn(self, x):
        return x + self.ffn(self.norm2(x))

    def forward(self, x, positions=None, segments=None):
        """Training forward: (x, aux) with aux a 0-d fp32 zero (the dense
        FFN has no auxiliary loss).  ``segments``: optional (B, T)
        document ids of packed rows."""
        xin = self.norm1(x)
        if segments is None:
            h = self.mixer(xin, positions)
        else:
            h = self.mixer(xin, positions, segments=segments)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._ffn(x + h), aux

    # ---------------------------------------------------------------- serving
    def init_cache(self, batch, max_len, dtype, paged=None, device=None):
        c = self.cfg
        if self.spec.mixer == "mosa":
            return self.mixer.init_cache(batch, max_len, dtype, paged=paged,
                                         device=device)
        a = c.attention
        if paged is not None:
            return PagedDenseKVCache.create(
                batch, max_len, a.n_kv_heads, a.d_head, dtype,
                block_size=paged.block_size, num_blocks=paged.num_blocks,
                identity_tables=paged.num_blocks == 0, device=device)
        return DenseKVCache.create(batch, max_len, a.n_kv_heads, a.d_head,
                                   dtype, device)

    def prefill(self, x, cache, positions=None, valid=None):
        h, cache = self.mixer.prefill(self.norm1(x), cache, positions, valid)
        return self._ffn(x + h), cache

    def decode_step(self, x, cache, positions=None):
        h, cache = self.mixer.decode_step(self.norm1(x), cache, positions)
        return self._ffn(x + h), cache


class TransformerLM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.embed = Embedding(c.vocab, c.d_model, c.pdtype, c.cdtype,
                               device=device)
        self.layers = nn.ModuleList(
            Block(c, s, device=device) for s in c.resolved_pattern())
        norm = RMSNorm if c.norm == "rmsnorm" else LayerNorm
        self.final_norm = norm(c.d_model, param_dtype=c.pdtype,
                               compute_dtype=c.cdtype, device=device)
        self.unembed = (None if c.tie_embeddings else
                        Linear(c.d_model, c.vocab, param_dtype=c.pdtype,
                               compute_dtype=c.cdtype, device=device))

    def init(self, generator: torch.Generator):
        """Fill every parameter from ``generator`` (random weights; they
        never match the JAX package's threefry init)."""
        self.embed.init(generator)
        for layer in self.layers:
            layer.init(generator)
        self.final_norm.init(generator)
        if self.unembed is not None:
            self.unembed.init(generator)
        return self

    def _logits(self, x):
        c = self.cfg
        if c.tie_embeddings:
            return self.embed.attend(x)
        return (x.to(c.cdtype) @ self.unembed.w.to(c.cdtype)).float()

    # -------------------------------------------------------------- training
    HEALTH_KEYS = ("sel_entropy", "drop_rate", "head_util")

    def _maybe_remat(self, block):
        policy = self.cfg.remat
        if policy == "none":
            return block
        if policy == "full":
            return lambda *a: checkpoint(block, *a, use_reentrant=False)
        raise NotImplementedError(
            f"remat {policy!r} is not ported yet (ROADMAP A: remat "
            "mosa/dots_saveable); use 'none' or 'full'")

    def backbone(self, x, positions=None, segments=None,
                 collect_health: bool = False):
        """(B, T, h) -> (hidden states, aux loss).  With
        ``collect_health=True`` also the router health averaged over every
        MoSA layer, each from that layer's real input, without gradient:
        (x, aux, health) ({} for a model without MoSA layers)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        totals, n_routed = {}, 0
        for layer in self.layers:
            if collect_health and layer.spec.mixer == "mosa":
                with torch.no_grad():
                    s = layer.mixer.router_health(layer.norm1(x))
                totals = {k: totals.get(k, 0.0) + s[k]
                          for k in self.HEALTH_KEYS}
                n_routed += 1
            x, a = self._maybe_remat(layer)(x, positions, segments)
            aux = aux + a
        if not collect_health:
            return x, aux
        return x, aux, {k: v / n_routed for k, v in totals.items()}

    def _forward(self, tokens, positions=None, segments=None,
                 collect_health: bool = False):
        x = self.embed(tokens)
        health = {}
        if collect_health:
            x, aux, health = self.backbone(x, positions, segments, True)
        else:
            x, aux = self.backbone(x, positions, segments)
        return self._logits(self.final_norm(x)), aux, health

    def forward(self, tokens, positions=None, segments=None):
        """tokens (B, T) -> (logits fp32 (B, T, vocab), aux loss)."""
        logits, aux, _ = self._forward(tokens, positions, segments)
        return logits, aux

    def loss(self, batch, with_health: bool = False):
        """batch: {"tokens" (B, T), "labels" (B, T)}, labels < 0 masked;
        packed rows add "segments" (B, T) document ids and per-document
        "positions".  Returns (loss, metrics) with metrics ``ce``, ``aux``,
        ``ppl`` and ``tokens`` (0-d tensors), plus the router health keys
        when ``with_health``."""
        labels = batch["labels"]
        logits, aux, health = self._forward(
            batch["tokens"], batch.get("positions"), batch.get("segments"),
            collect_health=with_health)
        logits = logits.float()
        mask = (labels >= 0).float()
        gold = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])
        nll = (torch.logsumexp(logits, -1) - gold[..., 0]) * mask
        denom = mask.sum().clamp_min(1.0)
        ce = nll.sum() / denom
        metrics = {"ce": ce, "aux": aux, "ppl": torch.exp(ce),
                   "tokens": denom, **health}
        return ce + aux, metrics

    def router_health(self, tokens, positions=None):
        """Router health averaged over every MoSA layer for ``tokens`` ({}
        without MoSA layers): the standalone face of
        ``backbone(collect_health=True)``."""
        with torch.no_grad():
            _, _, health = self.backbone(self.embed(tokens), positions,
                                         collect_health=True)
        return health

    # ---------------------------------------------------------------- serving
    def init_cache(self, batch, max_len, dtype=None, paged=None, device=None):
        """One cache per layer; ``paged``: optional ``PagedConfig``."""
        dtype = dtype or self.cfg.cdtype
        device = device if device is not None else self.embed.table.device
        return [layer.init_cache(batch, max_len, dtype, paged=paged,
                                 device=device) for layer in self.layers]

    def prefill(self, tokens, caches, positions=None, valid=None,
                last_pos=None):
        """tokens (B, T) -> (logits (B, 1, V) at ``last_pos`` (default the
        last token), caches).  ``valid``: (B, T) bool, False marks right-pad
        tokens."""
        x = self.embed(tokens)
        new = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer.prefill(x, cache, positions, valid)
            new.append(cache)
        x = self.final_norm(x)
        if last_pos is None:
            xl = x[:, -1:]
        else:
            xl = torch.gather(x, 1, last_pos.long()[:, None, None].expand(
                -1, 1, x.shape[-1]))
        return self._logits(xl), new

    def decode_step(self, token, caches, positions=None):
        """token: (B, 1) -> (logits (B, 1, V), caches)."""
        x = self.embed(token)
        new = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer.decode_step(x, cache, positions)
            new.append(cache)
        return self._logits(self.final_norm(x)), new

    def decode_many(self, tok, caches, generator=None, n: int = 1,
                    temperature: float = 0.0, top_k: int = 0,
                    return_logits: bool = False):
        """``n`` decode steps with sampling on the device (a Python loop
        where the JAX package scans).  ``tok``: (B, 1), the last emitted
        token.  Returns (tokens (B, n), caches), or with
        ``return_logits=True`` (tokens, logits (B, n, V), caches)."""
        toks, logits_all = [], []
        for _ in range(n):
            logits, caches = self.decode_step(tok, caches)
            nxt = sample_logits(logits[:, -1], generator, temperature, top_k)
            toks.append(nxt)
            if return_logits:
                logits_all.append(logits[:, -1])
            tok = nxt[:, None]
        B = tok.shape[0]
        out = (torch.stack(toks, 1) if toks else
               torch.zeros((B, 0), dtype=torch.long, device=tok.device))
        if return_logits:
            return out, torch.stack(logits_all, 1), caches
        return out, caches
