"""Transformer assembly: blocks, LM head, loss, serving (port of
``repro.nn.transformer``).

The JAX package scans a periodic run of layers over stacked parameters;
here the layers are a plain ``nn.ModuleList`` walked by a Python loop, and
the serving caches are a list with one entry per layer.  ``find_period``
is kept: the weight converter needs it to unstack the JAX parameters.

Training: ``forward`` (fp32 logits, aux loss), ``backbone`` (optionally
with the router health of every MoSA layer) and ``loss`` (masked next-token
cross-entropy; packed rows through ``segments``/``positions``).  Remat
per block: ``none``, ``full``, ``dots_saveable`` and ``mosa``
(``repro_torch.nn.remat``).

Ported mixers: ``mosa`` (the hybrid; MoSA or, train-only, the fixed /
routing baselines on its sparse side), ``attn`` and ``attn_local`` (as
the JAX package builds them: ``attn`` drops a configured window,
``attn_local`` defaults it to 1024); FFN: ``dense``.  A window attention
layer serves from a window ring (``WindowKVCache``, or
``PagedWindowKVCache`` under a ``PagedConfig``).

``specs()`` names the logical axes of every parameter, keyed like the
``state_dict`` (the JAX ``specs()`` tree with its scan units unstacked).
On a mesh (``dist.parallel.shard_model``; ``mesh`` holds the
``MeshContext``) the modules compute on their shards, serving builds
this rank's caches (``init_cache``) and gives every rank the full logits
(all-gathered across the vocabulary slices, so every rank samples the
same tokens), the loss takes the
logsumexp and the gold logit across the vocabulary slices, and
``loss(denom=...)`` divides by the mask count of the whole microbatch
across the data-parallel ranks, so that the ranks' losses sum to one
device's.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.core.attention import MultiHeadAttention
from repro_torch.core.hybrid import HybridAttention
from repro_torch.core.kv_cache import DenseKVCache, WindowKVCache
from repro_torch.dist.parallel import (copy_to, gather_last, logsumexp,
                                       reduce_from)
from repro_torch.nn.ffn import MLP
from repro_torch.nn.layers import Embedding, LayerNorm, Linear, RMSNorm
from repro_torch.nn.remat import remat
from repro_torch.serve.paged_attention import packed_token_layout
from repro_torch.serve.paged_kv import PagedDenseKVCache, PagedWindowKVCache


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


def packed_meta(cu_seqlens, rows, past_lens, C: int, device) -> dict:
    """The layout of a packed prefill chunk of ``C`` token slots that the
    layers' ``prefill_packed`` read: the segments' offsets, rows and pasts
    as int32 tensors, each token's segment, offset, row and position (-1
    / 0 for padding), and the (N, C) gather that unpacks the segments."""
    cu = torch.as_tensor(cu_seqlens, device=device).to(torch.int32)
    rows = torch.as_tensor(rows, device=device).to(torch.int32)
    past = torch.as_tensor(past_lens, device=device).to(torch.int32)
    seg, local, row_of_tok, _ = packed_token_layout(cu, rows, past, C)
    segc = seg.clamp(min=0)
    pos_of_tok = torch.where(row_of_tok >= 0, past.long()[segc] + local, 0)
    t = torch.arange(C, device=device)
    cul = cu.long()
    tok_idx = (cul[:-1, None] + t[None]).clamp(0, C - 1)          # (N, C)
    seg_len = cul[1:] - cul[:-1]
    in_seg = (t[None] < seg_len[:, None]) & (rows >= 0)[:, None]
    return dict(cu=cu, rows=rows, past_lens=past, seg_of_tok=seg,
                local_of_tok=local, row_of_tok=row_of_tok,
                pos_of_tok=pos_of_tok, tok_idx=tok_idx, in_seg=in_seg)


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
        elif spec.mixer in ("attn", "attn_local"):
            acfg = c.attention
            if spec.mixer == "attn" and acfg.window:
                acfg = dataclasses.replace(acfg, window=0)
            if spec.mixer == "attn_local" and not acfg.window:
                acfg = dataclasses.replace(acfg, window=1024)
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

    def specs(self):
        return {f"{name}.{k}": v
                for name in ("norm1", "mixer", "norm2", "ffn")
                for k, v in getattr(self, name).specs().items()}

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
        window = self.mixer.cfg.window
        hkv = self.mixer.cache_heads()          # this rank's, on a mesh
        if window:
            W = min(window, max_len)
            if paged is not None:
                return PagedWindowKVCache.create(
                    batch, W, hkv, a.d_head, dtype,
                    block_size=paged.block_size,
                    num_blocks=paged.num_window_blocks,
                    identity_tables=paged.num_window_blocks == 0,
                    device=device)
            return WindowKVCache.create(batch, W, hkv, a.d_head, dtype,
                                        device)
        if paged is not None:
            return PagedDenseKVCache.create(
                batch, max_len, hkv, a.d_head, dtype,
                block_size=paged.block_size, num_blocks=paged.num_blocks,
                identity_tables=paged.num_blocks == 0, device=device)
        return DenseKVCache.create(batch, max_len, hkv, a.d_head, dtype,
                                   device)

    def prefill(self, x, cache, positions=None, valid=None,
                continued: bool = False):
        """``continued``: ``cache`` holds a restored prompt prefix and ``x``
        is the suffix (only the MoSA mixer needs to know: the dense paged
        caches are past-aware through their lengths)."""
        if self.spec.mixer == "mosa":
            h, cache = self.mixer.prefill(self.norm1(x), cache, positions,
                                          valid, continued=continued)
        else:
            h, cache = self.mixer.prefill(self.norm1(x), cache, positions,
                                          valid)
        return self._ffn(x + h), cache

    def prefill_packed(self, x, cache, meta):
        """Packed chunked prefill of one layer (``meta``: see
        ``TransformerLM.prefill_packed``)."""
        h, cache = self.mixer.prefill_packed(self.norm1(x), cache, meta)
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
                               compute_dtype=c.cdtype, in_axis="embed",
                               out_axis="vocab", device=device))
        self.mesh = None        # a dist.parallel.MeshContext on a mesh

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

    def specs(self) -> dict:
        """Logical axes of every parameter, keyed like the state_dict."""
        out = {f"embed.{k}": v for k, v in self.embed.specs().items()}
        for i, layer in enumerate(self.layers):
            out.update({f"layers.{i}.{k}": v
                        for k, v in layer.specs().items()})
        out.update({f"final_norm.{k}": v
                    for k, v in self.final_norm.specs().items()})
        if self.unembed is not None:
            out.update({f"unembed.{k}": v
                        for k, v in self.unembed.specs().items()})
        return out

    def _vocab_owner(self):
        return self.embed if self.cfg.tie_embeddings else self.unembed

    def _logits(self, x):
        """fp32 logits; on a mesh with the vocabulary sharded, this rank's
        slice of them."""
        c = self.cfg
        x = copy_to(x, self._vocab_owner().tp)
        if c.tie_embeddings:
            return self.embed.attend(x)
        return (x.to(c.cdtype) @ self.unembed.w.to(c.cdtype)).float()

    def _full_logits(self, x):
        logits = self._logits(x)
        tp = self._vocab_owner().tp
        return logits if tp is None else gather_last(logits, tp)

    def _nll(self, logits, labels):
        """Per-token negative log-likelihood (labels clamped at 0): the
        logsumexp and the gold logit over the vocabulary slices on a
        mesh, never the gathered logits."""
        owner = self._vocab_owner()
        gold_ix = labels.clamp_min(0).long()[..., None]
        if owner.tp is None:
            gold = torch.gather(logits, -1, gold_ix)[..., 0]
            return torch.logsumexp(logits, -1) - gold
        lo, hi = owner.vocab_range
        lse = logsumexp(logits, owner.tp)
        local = gold_ix - lo
        ok = (local >= 0) & (local < hi - lo)
        gold = torch.gather(logits, -1, local.clamp(0, hi - lo - 1))
        gold = reduce_from(torch.where(ok, gold, 0.0)[..., 0], owner.tp)
        return lse - gold

    # -------------------------------------------------------------- training
    HEALTH_KEYS = ("sel_entropy", "drop_rate", "head_util")

    def _maybe_remat(self, block):
        return remat(block, self.cfg.remat)

    def gradient_free(self) -> set:
        """Names of the parameters that the loss never reaches (each
        module's ``GRADIENT_FREE``: the routing baseline's centroids)."""
        return {f"{name}.{p}" if name else p
                for name, mod in self.named_modules()
                for p in getattr(mod, "GRADIENT_FREE", ())}

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
                    s = (layer.mixer.router_health(layer.norm1(x))
                         if self.mesh is None else
                         layer.mixer.router_health(layer.norm1(x),
                                                   self._rows_sum()))
                if s is not None:       # None: a baseline, no router
                    totals = {k: totals.get(k, 0.0) + s[k]
                              for k in self.HEALTH_KEYS}
                    n_routed += 1
            x, a = self._maybe_remat(layer)(x, positions, segments)
            aux = aux + a
        if not collect_health:
            return x, aux
        return x, aux, {k: v / n_routed for k, v in totals.items()}

    def _rows_sum(self):
        """Sums a tensor over the data-parallel ranks (router health on a
        mesh); None off a mesh."""
        ctx = self.mesh
        if ctx is None:
            return None
        return lambda t: ctx.all_reduce(t.contiguous(), ctx.dp_axes)

    def _embed_tokens(self, tokens=None, inputs_embeds=None):
        """The backbone's input: ``inputs_embeds`` (a stub frontend's
        precomputed frame or patch embeddings) cast to the compute dtype
        when given, else the token embeddings, scaled by sqrt(d_model) for
        the gemma family (an RMSNorm config whose name starts with
        "gemma", as the JAX package decides it; the factor is rounded to
        the compute dtype first, as there)."""
        c = self.cfg
        if inputs_embeds is not None:
            return inputs_embeds.to(c.cdtype)
        x = self.embed(tokens)
        if c.norm == "rmsnorm" and c.name.startswith("gemma"):
            x = x * torch.tensor(c.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def _forward(self, tokens, positions=None, segments=None,
                 collect_health: bool = False, inputs_embeds=None):
        x = self._embed_tokens(tokens, inputs_embeds)
        health = {}
        if collect_health:
            x, aux, health = self.backbone(x, positions, segments, True)
        else:
            x, aux = self.backbone(x, positions, segments)
        return self._logits(self.final_norm(x)), aux, health

    def forward(self, tokens=None, positions=None, segments=None,
                inputs_embeds=None):
        """tokens (B, T) (or ``inputs_embeds`` (B, T, h)) -> (logits fp32
        (B, T, vocab), aux loss)."""
        x, aux = self.backbone(self._embed_tokens(tokens, inputs_embeds),
                               positions, segments)
        return self._full_logits(self.final_norm(x)), aux

    def loss(self, batch, with_health: bool = False, denom=None):
        """batch: {"tokens" (B, T) or "embeds" (B, T, h), "labels" (B,
        T)}, labels < 0 masked;
        packed rows add "segments" (B, T) document ids and per-document
        "positions".  Returns (loss, metrics) with metrics ``ce``, ``aux``,
        ``ppl`` and ``tokens`` (0-d tensors), plus the router health keys
        when ``with_health``.  ``denom``: the mask count to divide by (on
        a mesh, the whole microbatch's across the data-parallel ranks;
        default this batch's)."""
        labels = batch["labels"]
        logits, aux, health = self._forward(
            batch.get("tokens"), batch.get("positions"),
            batch.get("segments"), collect_health=with_health,
            inputs_embeds=batch.get("embeds"))
        logits = logits.float()
        mask = (labels >= 0).float()
        nll = self._nll(logits, labels) * mask
        if denom is None:
            denom = mask.sum().clamp_min(1.0)
        elif self.mesh is not None:     # a share of the dp ranks' mean
            aux = aux / self.mesh.dp_size
        ce = nll.sum() / denom
        metrics = {"ce": ce, "aux": aux, "ppl": torch.exp(ce),
                   "tokens": denom, **health}
        return ce + aux, metrics

    def router_health(self, tokens=None, positions=None, inputs_embeds=None):
        """Router health averaged over every MoSA layer for ``tokens`` ({}
        without MoSA layers): the standalone face of
        ``backbone(collect_health=True)``."""
        with torch.no_grad():
            _, _, health = self.backbone(
                self._embed_tokens(tokens, inputs_embeds), positions,
                collect_health=True)
        return health

    # ---------------------------------------------------------------- serving
    def init_cache(self, batch, max_len, dtype=None, paged=None, device=None,
                   seq_sharded: bool = False):
        """One cache per layer; ``paged``: optional ``PagedConfig``.  On a
        mesh, this rank's caches (``dist.parallel.local_caches``): its rows
        of ``batch`` over dp, its heads over ``model``, and with
        ``seq_sharded`` its slice of the positions of the contiguous dense
        and window caches."""
        dtype = dtype or self.cfg.cdtype
        device = device if device is not None else self.embed.table.device
        if self.mesh is not None:
            return self._mesh_caches(batch, max_len, dtype, paged, device,
                                     seq_sharded)
        return [layer.init_cache(batch, max_len, dtype, paged=paged,
                                 device=device) for layer in self.layers]

    def _mesh_caches(self, batch, max_len, dtype, paged, device,
                     seq_sharded):
        """The caches' local shapes from the full ones (a model on
        ``meta``) under ``cache_spec``; every layer is told whether its
        contiguous cache is seq-sharded and must serve its cache as
        placed: a MoSA cache of other heads than the layer's, or a dense
        cache of heads that the layer cannot serve, raises."""
        from repro_torch.dist import sharding as shd
        from repro_torch.dist.parallel import local_caches
        ctx = self.mesh
        full = TransformerLM(self.cfg, device="meta").init_cache(
            batch, max_len, dtype, paged=paged, device="meta")
        caches = local_caches(full, ctx.mesh, ctx.rule_set, seq_sharded,
                              paged, device)
        specs = shd.cache_shardings(full, ctx.mesh, ctx.rule_set,
                                    seq_sharded)
        for layer, cache, spec in zip(self.layers, caches, specs):
            mha, dc, dsp = layer.mixer, cache, spec
            if isinstance(mha, HybridAttention):
                held = cache["sparse"].k.shape[1]
                if held != mha.sparse.wq.shape[0]:
                    raise ValueError(
                        f"a MoSA cache of {held} heads beside "
                        f"{mha.sparse.wq.shape[0]} heads of weights")
                mha, dc, dsp = mha.dense, cache.get("dense"), spec.get(
                    "dense")
            if mha is None:
                continue
            mha.seq_sharded = (isinstance(dc, (DenseKVCache, WindowKVCache))
                               and len(dsp.k) > 1
                               and shd.TP_AXIS in shd.spec_axes(dsp.k[1]))
            mha._serve_mode(dc)
        return caches

    def prefill(self, tokens, caches, positions=None, valid=None,
                last_pos=None, continued: bool = False, inputs_embeds=None):
        """tokens (B, T) (or ``inputs_embeds`` (B, T, h), with ``tokens``
        None) -> (logits (B, 1, V) at ``last_pos`` (default the last
        token), caches).  ``valid``: (B, T) bool, False marks right-pad
        tokens.  ``continued``: the caches hold a restored prompt prefix
        (a prefix-cache hit) and ``tokens`` are the suffix."""
        x = self._embed_tokens(tokens, inputs_embeds)
        new = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer.prefill(x, cache, positions, valid, continued)
            new.append(cache)
        x = self.final_norm(x)
        if last_pos is None:
            xl = x[:, -1:]
        else:
            xl = torch.gather(x, 1, last_pos.long()[:, None, None].expand(
                -1, 1, x.shape[-1]))
        return self._full_logits(xl), new

    def prefill_packed(self, tokens, caches, cu_seqlens, rows, past_lens):
        """Packed multi-segment chunked prefill over paged caches.

        tokens: (1, C) — N prompt segments flattened back to back (the tail
        past ``cu[N]`` is padding); cu_seqlens: (N + 1,) offsets; rows:
        (N,) batch row per segment (-1 = inactive); past_lens: (N,) tokens
        already in each row's caches.  Returns ``(logits (N, V), caches)``:
        each segment's logits at its LAST token in this chunk (only
        segments completing their prompt have meaningful ones)."""
        C = tokens.shape[1]
        meta = packed_meta(cu_seqlens, rows, past_lens, C, tokens.device)
        cul = meta["cu"].long()
        x = self._embed_tokens(tokens)
        new = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer.prefill_packed(x, cache, meta)
            new.append(cache)
        x = self.final_norm(x)
        last = (cul[1:] - 1).clamp(0, C - 1)                      # (N,)
        return self._full_logits(x[0][last]), new

    def decode_step(self, token, caches, positions=None):
        """token: (B, 1) -> (logits (B, 1, V), caches)."""
        x = self._embed_tokens(token)
        new = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer.decode_step(x, cache, positions)
            new.append(cache)
        return self._full_logits(self.final_norm(x)), new

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
