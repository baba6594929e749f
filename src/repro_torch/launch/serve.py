"""Serving entry points (port of ``Server``, ``RequestPool`` and the CLI of
``repro.launch.serve``).

``Server(cfg, ...)`` holds a ``TransformerLM`` on the card (by default)
or on a device mesh (``mesh=``, or ``torch.distributed.run`` with more
than one process; see ``Server.__init__``) and serves whole batches:
``generate`` runs one prefill over the prompts and then ``gen_len - 1``
decode steps, greedy by default;
``generate_stepwise`` does the same with one ``decode_step`` and one sample
per token (the per-token baseline of the chunked decoder).  With
``paged=PagedConfig(...)`` the dense heads keep their KV in block-paged
pools (window rings in ``PagedWindowKVCache`` pools for sliding-window
heads); the MoSA heads keep their O(k) streaming cache.  Auto-sized pools
(``num_blocks == 0``) give identity block tables for ``generate``; an
explicit budget leaves the tables unallocated for
``repro_torch.serve.scheduler.Scheduler``, which drives the per-row ops:
``prefill_packed`` (packed chunked prefill), ``decode_many``,
``snapshot_row`` / ``restore_row``, ``grow_tables`` and
``grow_window_tables``.

``RequestPool`` is the non-paged fallback: continuous batching over fixed
slots of one contiguous batched cache, refilled between decode chunks by a
batch-1 masked prefill (``prefill_one``) written into the freed row
(``write_slot``).

On a mesh every rank runs this same code on its shards: the weights cut
by the rule set's placements (``dist.parallel.shard_model``), the caches
by ``dist.sharding.cache_spec`` (``dist.parallel.local_caches``: the MoSA
heads and the dense heads over ``model`` — head-parallel prefill and
decode, one all-reduce a layer —, the rows over the data-parallel axes,
and under ``seq_sharded`` the contiguous dense caches' positions over
``model``).  Every rank gets the full logits and samples the same tokens;
``generate`` all-gathers the rows of the data-parallel ranks.

The caches are written IN PLACE and every cache op runs under
``torch.inference_mode()`` (a tensor made there refuses in-place writes
outside it).  A row snapshot is a host copy, never a view of the device
caches.

CLI (the card unless ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.serve --preset smoke \\
      --variant mosa --batch 4 --prompt-len 32 --gen 16 [--stepwise]
  PYTHONPATH=src python -m repro_torch.launch.serve --preset smoke \\
      --variant mosa --load-rate 4 --load-n 16
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.serve --device cpu \\
      --preset smoke --variant mosa   # a mesh of 4 ranks; rank 0 prints
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \\
      --preset full --max-len 2080 --prompt-len 2048 --gen 32
``--arch`` takes every registered config (``configs.base.config_names``:
mosa-paper, qwen2-1.5b, yi-9b, yi-34b, musicgen-large, gemma3-4b) and
``--preset`` its ``smoke`` or ``full`` preset; ``--variant`` is
mosa-paper's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.nn.transformer import TransformerLM, sample_logits
from repro_torch.serve.paged_kv import (PagedConfig, PagedDenseKVCache,
                                        PagedWindowKVCache)

PAGED_CACHE_TYPES = (PagedDenseKVCache, PagedWindowKVCache)
# The fields of a paged cache shared by every row (behind block ids); the
# block table, positions and length are per row.
POOL_FIELDS = frozenset({"k", "v"})


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raises when CUDA is absent rather than
    falling back to the CPU (pass ``device="cpu"`` for that)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        device = "cuda"
    return torch.device(device)


# ---------------------------------------------------- batch-row cache ops
# The caches are a list with one entry per layer: a cache NamedTuple
# (attention layers) or a dict {"sparse": MoSAKVCache or MoSABlockKVCache,
# "dense": a dense or window cache} (MoSA hybrid layers).  Every field of a
# contiguous or MoSA cache is per row; the pools of a paged cache
# (``POOL_FIELDS``) are shared by every row and stay behind block ids.

def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _map_layers(fn, caches, *others):
    """Apply ``fn(cache, *other)`` to every cache object of the layer list,
    recursing through the hybrid layers' dicts."""
    def one(c, *o):
        if isinstance(c, dict):
            return {k: one(c[k], *(x[k] for x in o)) for k in c}
        return fn(c, *o)
    return [one(c, *o) for c, *o in zip(caches, *others)]


def _row_fields(c):
    """(name, tensor) of the per-row fields of cache ``c``."""
    paged = isinstance(c, PAGED_CACHE_TYPES)
    return [(name, f) for name, f in zip(c._fields, c)
            if not (paged and name in POOL_FIELDS)]


def row_slice(caches, b: int):
    """A batch-of-1 view of row ``b``: row fields sliced (views), pools
    shared, so the in-place appends of ``model.prefill`` on the view write
    through to the batched caches; ``row_write`` stores what the prefill
    returns anew (lengths, MoSA caches)."""
    def one(c):
        rows = dict(_row_fields(c))
        return type(c)(*(f[b:b + 1] if name in rows else f
                         for name, f in zip(c._fields, c)))
    return _map_layers(one, caches)


def row_write(caches, row, b: int):
    """Write a batch-of-1 row (a ``row_slice`` view after a prefill, or a
    separate batch-1 cache) into row ``b`` in place; returns ``caches``.
    Paged pools are not copied: a row view's writes already landed in
    them."""
    def one(dst, src):
        for (_, d), (_, s) in zip(_row_fields(dst), _row_fields(src)):
            d[b:b + 1] = s.to(d.device, d.dtype)
        return dst
    _map_layers(one, caches, row)
    return caches


def _snap_window(c: PagedWindowKVCache, b: int) -> dict:
    """Row ``b`` of a window ring: its table, positions and length, and —
    since ring blocks are written in place and never shared — the ring's
    content gathered in the ring layout (W, Hkv, d), bounded by W."""
    bt = c.block_table[b].long().clamp(min=0)
    rest = c.k.shape[2:]
    return {"block_table": _host(c.block_table[b]),
            "k": _host(c.k[bt].reshape(c.window, *rest)),
            "v": _host(c.v[bt].reshape(c.window, *rest)),
            "positions": _host(c.positions[b]), "length": _host(c.length[b])}


def _restore_window(c: PagedWindowKVCache, s: dict, b: int) -> None:
    """Inverse of ``_snap_window`` at row ``b``: the ring content is
    scattered into the blocks of ``s["block_table"]`` (the caller may have
    rewritten it to fresh block ids); slots behind a -1 entry are
    dropped."""
    table = torch.as_tensor(s["block_table"]).to("cpu", torch.long)
    bs = c.block_size
    slots = torch.arange(c.window)
    blk = table[slots // bs]
    keep = blk >= 0
    if bool(keep.any()):
        dev = c.k.device
        blk, off = blk[keep].to(dev), (slots % bs)[keep].to(dev)
        c.k[blk, off] = torch.as_tensor(s["k"])[keep].to(dev, c.k.dtype)
        c.v[blk, off] = torch.as_tensor(s["v"])[keep].to(dev, c.v.dtype)
    for name in ("block_table", "positions", "length"):
        f = getattr(c, name)
        f[b] = torch.as_tensor(s[name]).to(f.device, f.dtype)


def row_snapshot(caches, b: int):
    """Host-restorable state of row ``b``: the paged caches' block table and
    length (and a window ring's content and positions), and the whole row
    of every other cache (bounded by its k, or by W).  The dense paged KV
    itself stays behind block ids."""
    def one(c):
        if isinstance(c, PagedDenseKVCache):
            return {"block_table": _host(c.block_table[b]),
                    "length": _host(c.length[b])}
        if isinstance(c, PagedWindowKVCache):
            return _snap_window(c, b)
        return type(c)(*(_host(f[b:b + 1]) for f in c))
    return _map_layers(one, caches)


def row_restore(caches, snap, b: int):
    """Write a ``row_snapshot`` back at row ``b`` in place (admission reset,
    prefix restore, preempt-resume); returns ``caches``."""
    def one(c, s):
        if isinstance(c, PagedDenseKVCache):
            c.block_table[b] = torch.as_tensor(s["block_table"]).to(
                c.block_table.device, c.block_table.dtype)
            c.length[b] = torch.as_tensor(s["length"]).to(
                c.length.device, c.length.dtype)
        elif isinstance(c, PagedWindowKVCache):
            _restore_window(c, s, b)
        else:
            for f, sf in zip(c, s):
                f[b:b + 1] = sf.to(f.device, f.dtype)
        return c
    _map_layers(one, caches, snap)
    return caches


def _set_tables(kind, caches, row, b: int):
    row = torch.as_tensor(row)

    def one(c):
        if type(c) is kind:
            c.block_table[b] = row.to(c.block_table.device,
                                      c.block_table.dtype)
        return c
    _map_layers(one, caches)
    return caches


def set_dense_tables(caches, dense_row, b: int):
    """Point row ``b``'s dense block tables (every paged dense layer shares
    one logical chain) at ``dense_row``, in place — the decode-time growth
    write; returns ``caches``."""
    return _set_tables(PagedDenseKVCache, caches, dense_row, b)


def set_window_tables(caches, window_row, b: int):
    """Point row ``b``'s window-ring block tables at ``window_row``, in
    place — the lazy-ring growth write (rings allocate blocks on first
    write, not at admission; -1 tail entries mean 'not yet written this
    far'); returns ``caches``."""
    return _set_tables(PagedWindowKVCache, caches, window_row, b)


def _world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


class Server:
    def __init__(self, model_cfg, max_len: int = 256, batch: int = 4,
                 params: Optional[dict] = None,
                 paged: Optional[PagedConfig] = None, device=None,
                 seed: int = 0, mesh=None, rule_set: str = "tp",
                 seq_sharded: bool = False):
        """``params``: a ``state_dict`` for ``TransformerLM`` (e.g. from
        ``repro_torch.convert.params_from_jax``); ``None`` draws random
        weights from ``torch.Generator`` seeded with ``seed``.

        ``mesh``: a ``DeviceMesh`` (``repro_torch.launch.mesh``) to serve
        on, under ``rule_set`` (``"tp"`` or ``"fsdp_tp"``); with ``None``
        and a world above 1 (``torch.distributed.run``) the mesh is
        ``elastic_plan(world, tp=1)``'s, and in a world of 1 there is no
        mesh.  ``seq_sharded``: the contiguous dense and window caches hold
        a slice of the positions on each ``model`` rank (the batch-1
        long-context layout) instead of a slice of the heads."""
        self.model_cfg = model_cfg
        self.max_len = max_len
        self.batch = batch
        self.paged = paged
        self.rule_set, self.seq_sharded = rule_set, seq_sharded
        self.mesh = self.ctx = None
        if mesh is not None or _world_size() > 1:
            from repro_torch.dist.fault_tolerance import elastic_plan
            from repro_torch.dist.parallel import MeshContext
            from repro_torch.launch import mesh as mesh_lib
            self.device = mesh_lib.init_process_group(device)
            if mesh is None:
                plan = elastic_plan(dist.get_world_size(), tp=1)
                mesh = mesh_lib.make_mesh(plan["shape"], plan["axes"],
                                          self.device.type)
            self.mesh, self.ctx = mesh, MeshContext(mesh, rule_set)
        else:
            self.device = resolve_device(device)
        with torch.no_grad():
            self.model = TransformerLM(model_cfg, device=self.device)
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                self.model.init(gen)
            else:
                self.model.load_state_dict(params)
        self.model.eval()
        # this rank's rows of a batch of ``batch`` (all of them off a
        # mesh, and where the data-parallel axes do not divide it)
        self.row_axes, self.rows = (), (0, batch)
        if self.ctx is not None:
            self._shard()

    @torch.no_grad()
    def _shard(self):
        """Cut the model to this rank's ``model`` shards under the rule
        set's placements (``param_specs``).  Under ``fsdp_tp`` the weights
        rest sharded over dp, and serving keeps no optimizer state: they
        are gathered once, here, into the working weights."""
        from repro_torch.dist import sharding as shd
        from repro_torch.dist.parallel import TrainShards, shard_model
        ctx, model = self.ctx, self.model
        specs = shd.param_specs(model, self.mesh, self.rule_set)
        shapes = shd.param_shapes(model)
        shard_model(model, ctx.tp, specs, ctx.coords, ctx.sizes)
        model.mesh = ctx
        shards = TrainShards(model, ctx, specs, shapes)
        if any(s.dp_dim is not None for s in shards.shards.values()):
            shards.gather_weights(shards.rest_params())
        self.row_axes = shd.dp_axes(self.mesh, self.rule_set, self.batch)
        i, n = shd.shard_index(self.row_axes, ctx.coords, ctx.sizes)
        w = self.batch // n
        self.rows = (i * w, (i + 1) * w)

    def _local_rows(self, t):
        """This rank's rows of a tensor of the whole batch."""
        return t[self.rows[0]:self.rows[1]]

    def _gather_rows(self, t):
        """The whole batch of a tensor of this rank's rows (all-gathered
        over the data-parallel axes that hold the rows)."""
        if not self.row_axes:
            return t
        group = self.ctx.group(self.row_axes)
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts)

    @torch.inference_mode()
    def new_cache(self, batch: Optional[int] = None):
        """Empty caches for ``batch`` rows (default the server's); on a mesh
        this rank's (its rows, heads or positions)."""
        batch = self.batch if batch is None else batch
        paged = self.paged if batch == self.batch else None
        return self.model.init_cache(batch, self.max_len, paged=paged,
                                     device=self.device,
                                     seq_sharded=self.seq_sharded)

    # ------------------------------------------------ the Scheduler's ops
    @torch.inference_mode()
    def prefill_packed(self, tokens, caches, cu_seqlens, rows, past_lens):
        """One packed prefill chunk (``TransformerLM.prefill_packed``):
        tokens (1, C); returns (logits (N, V), caches)."""
        reg = obs.registry()
        if reg.enabled:
            reg.inc("server.prefill_dispatches")
            reg.set("server.prefill_tokens", tokens.shape[-1])
        return self.model.prefill_packed(tokens.to(self.device), caches,
                                         cu_seqlens, rows, past_lens)

    @torch.inference_mode()
    def decode_many(self, tok, caches, generator=None, n: int = 1,
                    temperature: float = 0.0, top_k: int = 0):
        """``n`` decode steps of every row with sampling on the device;
        tok (B, 1).  Returns (tokens (B, n), caches).  With rows over the
        data-parallel ranks a ``tok`` of the whole batch is cut to this
        rank's rows, and the tokens are this rank's."""
        if tok.shape[0] == self.batch:
            tok = self._local_rows(tok)
        reg = obs.registry()
        if reg.enabled:       # dispatch counters only — no device sync
            reg.inc("server.decode_dispatches")
            reg.inc("server.decode_steps", n)
            reg.set("server.decode_batch", tok.shape[0])
        return self.model.decode_many(tok, caches, generator, n, temperature,
                                      top_k)

    @torch.inference_mode()
    def sample(self, logits, generator=None, temperature: float = 0.0,
               top_k: int = 0):
        return sample_logits(logits, generator, temperature, top_k)

    @torch.inference_mode()
    def snapshot_row(self, caches, b: int):
        return row_snapshot(caches, b)

    @torch.inference_mode()
    def restore_row(self, caches, snap, b: int):
        return row_restore(caches, snap, b)

    @torch.inference_mode()
    def grow_tables(self, caches, dense_row, b: int):
        return set_dense_tables(caches, dense_row, b)

    @torch.inference_mode()
    def grow_window_tables(self, caches, window_row, b: int):
        return set_window_tables(caches, window_row, b)

    # ------------------------------------------------------ single rows
    @torch.inference_mode()
    def prefill_one(self, tokens, caches, valid=None, last_pos=None):
        """Batch-1 masked prefill into a batch-1 cache (``new_cache(1)``):
        tokens (1, T) right-padded, ``valid`` (1, T) False on pads,
        ``last_pos`` (1,) the last real token, whose logits come back.
        Returns (logits (1, 1, V), caches)."""
        return self.model.prefill(tokens.to(self.device), caches,
                                  valid=valid, last_pos=last_pos)

    @torch.inference_mode()
    def write_slot(self, caches, row, b: int):
        """Write the batch-1 cache ``row`` into row ``b`` of ``caches``, in
        place (on a mesh, where this rank holds row ``b``); returns
        ``caches``."""
        r0, r1 = self.rows
        if not r0 <= b < r1:
            return caches
        return row_write(caches, row, b - r0)

    @torch.inference_mode()
    def prefill_row(self, prompt, caches, b: int, valid=None, last_pos=None,
                    continued: bool = False):
        """Prefill row ``b`` of the batched caches in place through a row
        view (paged appends land in the row's blocks); ``continued``: the
        row holds a restored prompt prefix and ``prompt`` (1, T) is the
        suffix.  Returns (logits (1, 1, V), caches)."""
        row = row_slice(caches, b)
        logits, row = self.model.prefill(prompt.to(self.device), row,
                                         valid=valid, last_pos=last_pos,
                                         continued=continued)
        return logits, row_write(caches, row, b)

    # ------------------------------------------------------ batch serving
    def _check_generate(self, prompts, gen_len: int) -> None:
        B, P = prompts.shape
        if B != self.batch:
            raise ValueError(f"batch {B} != server batch {self.batch}")
        if self.paged is not None and (self.paged.num_blocks
                                       or self.paged.num_window_blocks):
            raise ValueError("generate needs auto-sized paged pools "
                             "(identity block tables); budgeted pools are "
                             "managed by repro_torch.serve.scheduler")
        if P + gen_len - 1 > self.max_len:
            raise ValueError(f"prompt ({P}) + {gen_len - 1} decode steps "
                             f"exceeds max_len {self.max_len}")

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, gen_len: int,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 top_k: int = 0):
        """prompts: (B, P) integer -> ((B, gen_len) int64, caches).  One
        prefill, then ``gen_len - 1`` decode steps; greedy when
        ``temperature == 0``.  With rows over the data-parallel ranks each
        rank runs its rows and the tokens of every row come back,
        all-gathered (the caches are this rank's)."""
        self._check_generate(prompts, gen_len)
        prompts = self._local_rows(prompts.to(self.device))
        caches = self.new_cache()
        logits, caches = self.model.prefill(prompts, caches)
        tok0 = sample_logits(logits[:, -1], generator, temperature, top_k)
        toks, caches = self.decode_many(tok0[:, None], caches, generator,
                                        gen_len - 1, temperature, top_k)
        return self._gather_rows(torch.cat([tok0[:, None], toks],
                                           dim=1)), caches

    @torch.inference_mode()
    def generate_stepwise(self, prompts: torch.Tensor, gen_len: int,
                          temperature: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          top_k: int = 0):
        """``generate`` as the per-token loop: one ``decode_step`` and one
        sample per token, dispatched from the host (the baseline of the
        chunked ``decode_many``); the same tokens as ``generate``."""
        self._check_generate(prompts, gen_len)
        caches = self.new_cache()
        logits, caches = self.model.prefill(
            self._local_rows(prompts.to(self.device)), caches)
        tok = sample_logits(logits[:, -1], generator, temperature,
                            top_k)[:, None]
        out = [tok]
        for _ in range(gen_len - 1):
            logits, caches = self.model.decode_step(tok, caches)
            tok = sample_logits(logits[:, -1], generator, temperature,
                                top_k)[:, None]
            out.append(tok)
        return self._gather_rows(torch.cat(out, dim=1)), caches


def check_one_dp_rank(server, what: str) -> None:
    """Continuous batching runs on a mesh of one data-parallel rank (its
    rows on every rank, heads over ``model``); rows over dp need pools
    replicated over dp and prefix blocks shared across ranks (ROADMAP
    A.7c)."""
    ctx = getattr(server, "ctx", None)
    if ctx is not None and ctx.dp_size > 1:
        raise ValueError(
            f"{what} on a mesh with {ctx.dp_size} data-parallel ranks is "
            "not ported: its rows over dp need replicated pools and prefix "
            "blocks shared across ranks (ROADMAP A.7c); serve on a mesh of "
            "one data-parallel rank")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: torch.Tensor           # (P,) int64 token ids, on the CPU
    max_new: int
    generated: list = dataclasses.field(default_factory=list)


class RequestPool:
    """Continuous batching over fixed slots of one contiguous batched cache
    (the non-paged fallback; a paged ``Server`` is driven by
    ``repro_torch.serve.scheduler.Scheduler``).

    Decode runs in chunks (``Server.decode_many``).  Between chunks,
    requests that finished (EOS, their ``max_new``, or the global
    ``max_steps`` budget) free their slot and queued requests take it: the
    prompt is prefilled batch-of-one (``prefill_one``) and written into
    that row of the batched caches (``write_slot``); every cache keeps a
    per-row length, so rows at different positions coexist.

    Length policy (clamps, not errors): each request prefills at its own
    power-of-two bucket, capped at the server's ``max_len``.  Longer prompts are LEFT-truncated
    to their most recent tokens; shorter ones are RIGHT-padded with a
    ``valid`` mask and ``last_pos``, so pads stay out of attention, of
    MoSA's selection and of the cache lengths.  ``max_new`` is clamped so
    that the real prompt and the completion fit ``max_len``.

    ``eos``: token id that ends a request (included in its output); ``< 0``
    disables it.  Decoding is greedy, as in the JAX pool."""

    def __init__(self, server: Server, eos: int = -1, chunk: int = 8):
        check_one_dp_rank(server, "RequestPool")
        if server.paged is not None:
            raise ValueError("RequestPool is the contiguous-slab fallback; a "
                             "paged Server is driven by "
                             "repro_torch.serve.scheduler.Scheduler instead")
        self.server = server
        self.eos = eos
        self.chunk = chunk
        self.queue: list = []

    def submit(self, prompt, max_new: int) -> int:
        """Queue a request (``prompt``: 1-d token ids); returns its id."""
        rid = len(self.queue)
        p = torch.as_tensor(np.asarray(prompt)).long().reshape(-1).cpu()
        self.queue.append(Request(rid, p, max_new))
        return rid

    def _bucket(self, prompt_len: int) -> int:
        """The request's prefill length: the next power of two, capped at
        ``max_len``."""
        b = 1
        while b < max(prompt_len, 1):
            b *= 2
        return min(b, self.server.max_len)

    def run(self, max_steps: int = 1000) -> dict:
        """Serve every queued request; returns {rid: int32 tokens on the
        CPU}.  ``max_steps`` caps the decode steps of the whole pool: when
        it runs out, in-flight requests return what they have and the rest
        of the queue is left unserved."""
        with torch.inference_mode():
            return self._run(max_steps)

    def _admit(self, r: Request, caches, cur, b: int):
        """Prefill ``r`` into a batch-1 cache, write it into row ``b`` and
        sample its first token."""
        srv = self.server
        bucket = self._bucket(len(r.prompt))
        prompt = r.prompt[-bucket:]
        P = len(prompt)
        # positions P..max_len-1 hold the decoded tokens' KV (pads cost
        # nothing: decode overwrites them)
        r.max_new = min(r.max_new, srv.max_len - P + 1)
        tokens = torch.zeros((1, bucket), dtype=torch.long)
        tokens[0, :P] = prompt
        dev = srv.device
        valid = (torch.arange(bucket) < P)[None].to(dev)
        logits, row = srv.prefill_one(
            tokens, srv.new_cache(batch=1), valid,
            torch.full((1,), P - 1, dtype=torch.long, device=dev))
        srv.write_slot(caches, row, b)
        tok0 = srv.sample(logits[:, -1])
        cur[b, 0] = tok0[0]
        r.generated.append(int(tok0[0]))

    def _run(self, max_steps: int) -> dict:
        srv = self.server
        B = srv.batch
        results: dict = {}
        slots: list = [None] * B
        caches = srv.new_cache()
        cur = torch.zeros((B, 1), dtype=torch.long, device=srv.device)
        steps = 0

        def finish(b):
            r = slots[b]
            results[r.rid] = torch.tensor(r.generated, dtype=torch.int32)
            slots[b] = None

        while self.queue or any(s is not None for s in slots):
            for b in range(B):                 # refill the free slots
                if slots[b] is None and self.queue and steps < max_steps:
                    r = self.queue.pop(0)
                    self._admit(r, caches, cur, b)
                    slots[b] = r
                    if r.max_new <= 1 or r.generated[-1] == self.eos:
                        finish(b)
            if not any(s is not None for s in slots):
                if steps >= max_steps:
                    break
                continue
            if steps >= max_steps:
                for b in range(B):
                    if slots[b] is not None:
                        finish(b)
                break

            # One decode chunk for all rows, clamped to the longest
            # remaining request (n stays in [1, chunk]).
            need = max(r.max_new - len(r.generated)
                       for r in slots if r is not None)
            n = max(min(self.chunk, max_steps - steps, need), 1)
            toks, caches = srv.decode_many(cur, caches, n=n)
            steps += n
            host = toks.cpu().numpy()
            cur = toks[:, -1:].clone()
            for b in range(B):
                r = slots[b]
                if r is None:
                    continue
                for t in host[b]:
                    r.generated.append(int(t))
                    if int(t) == self.eos or len(r.generated) >= r.max_new:
                        finish(b)
                        break
        return results


# -------------------------------------------------------------------- CLI
def _load_run(cfg, args, device):
    """``--load-rate``: seeded open-loop traffic through the timed paged
    Scheduler; the SLO/goodput summary goes to stdout as JSON."""
    from repro_torch.obs.slo import SLOSpec, evaluate
    from repro_torch.serve.loadgen import (OpenLoopSource, bursty_workload,
                                           poisson_workload)
    from repro_torch.serve.scheduler import Scheduler

    nb = -(-args.max_len // 16)
    server = Server(cfg, batch=args.batch, max_len=args.max_len,
                    paged=PagedConfig(block_size=16,
                                      num_blocks=args.batch * nb,
                                      num_window_blocks=4 * args.batch),
                    device=device)
    build = bursty_workload if args.bursty else poisson_workload
    wl = build(args.load_rate, args.load_n, args.load_seed, cfg.vocab)
    sched = Scheduler(server, max_queue=args.max_queue or None,
                      metrics_path=args.metrics_path,
                      trace_path=args.trace_path,
                      temperature=args.temperature, top_k=args.top_k)
    t0 = time.perf_counter()
    sched.run(max_steps=100_000, source=OpenLoopSource(wl))
    dt = time.perf_counter() - t0
    spec = SLOSpec(ttft_s=args.ttft_slo, tpot_s=args.tpot_slo or None)
    ev = evaluate(list(sched.records.values()), spec)
    ev["offered_req_s"] = args.load_rate
    ev["duration_s"] = round(dt, 3)
    ev["device"] = str(server.device)
    print(json.dumps(ev, indent=2, sort_keys=True))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="mosa-paper",
                   help="a registered config (configs.base.config_names)")
    p.add_argument("--preset", default="smoke", help="smoke | full")
    p.add_argument("--variant", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; raises "
                        "without one)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--stepwise", action="store_true",
                   help="use the per-token loop (generate_stepwise) instead "
                        "of the chunked decoder")
    p.add_argument("--metrics-path", default=None,
                   help="write an obs metrics snapshot here on exit "
                        "(.jsonl appends)")
    p.add_argument("--trace-path", default=None,
                   help="write a Chrome-trace JSON of the run here on exit")
    p.add_argument("--load-rate", type=float, default=0.0,
                   help="instead of one batch generate, drive the timed "
                        "Scheduler with a seeded open-loop arrival stream "
                        "at this rate (req/s) and print the SLO/goodput "
                        "summary")
    p.add_argument("--load-n", type=int, default=32,
                   help="requests in the load run")
    p.add_argument("--load-seed", type=int, default=0)
    p.add_argument("--bursty", action="store_true",
                   help="Gamma (CV=3) interarrivals instead of Poisson")
    p.add_argument("--max-queue", type=int, default=0,
                   help="shed arrivals past this queue depth "
                        "(0 = never shed)")
    p.add_argument("--ttft-slo", type=float, default=0.5,
                   help="TTFT SLO in seconds for the load-run goodput")
    p.add_argument("--tpot-slo", type=float, default=0.0,
                   help="TPOT SLO in seconds (0 = no TPOT obligation)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    started = _world_size() > 1 and not dist.is_initialized()
    if started:                   # torch.distributed.run: one mesh
        from repro_torch.launch import mesh as mesh_lib
        device = mesh_lib.init_process_group(args.device)
    try:
        _main(args, device)
    finally:
        if started:
            dist.destroy_process_group()


def _main(args, device):
    from repro_torch.configs.base import get_config

    say = print if not dist.is_initialized() or dist.get_rank() == 0 \
        else (lambda *a, **k: None)
    akw = {"variant": args.variant} if args.variant else {}
    cfg = get_config(args.arch, preset=args.preset, **akw)
    if args.load_rate > 0:
        return _load_run(cfg, args, device)
    server = Server(cfg, batch=args.batch, max_len=args.max_len,
                    paged=PagedConfig(block_size=16), device=device)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(2, cfg.vocab,
                                            (args.batch, args.prompt_len)))
    gen = torch.Generator(device=device).manual_seed(0)

    generate = server.generate_stepwise if args.stepwise else \
        server.generate

    def run():
        toks, _ = generate(prompts, args.gen, args.temperature, gen,
                           args.top_k)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return toks

    run()                                    # warm-up outside the timing
    t0 = time.perf_counter()
    toks = run()
    dt = time.perf_counter() - t0
    where = (f"{device}" if server.mesh is None else
             f"{device}, mesh {dict(server.ctx.sizes)} x {server.rule_set}")
    say(f"generated {tuple(toks.shape)} in {dt:.2f}s on {where} "
        f"({args.batch * args.gen / dt:.1f} tok/s, "
        f"{'stepwise' if args.stepwise else 'chunked'})")
    say(toks[0].tolist())
    # the paper's KV metric, for a model with MoSA layers
    if cfg.mosa is not None:
        from repro_torch.core.hybrid import HybridAttention
        hy = HybridAttention(cfg.d_model, cfg.mosa, device="meta")
        heads = cfg.mosa.n_dense_heads + cfg.mosa.n_mosa_heads
        say(f"KV entries per MoSA layer: {hy.kv_total(args.max_len)} "
            f"(dense equivalent: {args.max_len * heads})")
    obs.dump(args.metrics_path, args.trace_path, tag="serve-cli")


if __name__ == "__main__":
    main()
