"""Block-granular continuous batching over a paged ``Server`` (port of
``repro.serve.scheduler``).

The scheduler admits requests while FREE BLOCKS suffice and grows each
row's dense block chain one block at a time as decode proceeds:

  * **Admission** — a request needs ``ceil(P / bs)`` dense blocks for its
    prompt (minus any prefix-cache hit) plus, on a model with window
    layers, the ring blocks its prompt writes (``ceil(min(P, W) / bs)``:
    the lazy ring); if the pools cannot cover that after LRU-evicting
    unused prefix-cache entries, the request waits.
  * **Decode growth** — before each decode chunk, rows crossing a dense
    block boundary get a fresh block (``Server.grow_tables``), and rows
    whose next tokens reach unallocated ring slots get those ring blocks
    (``Server.grow_window_tables``); a row that has seen W tokens has its
    whole ring.  Allocation always precedes the write: a ring write
    through a -1 entry drops the KV but records the slot's position.
  * **Preempt-to-recompute** — when growth cannot be satisfied, the
    latest-admitted victim releases all its blocks and re-enters the queue
    with ``prompt + generated`` as its new prompt, so the oldest requests
    always run to completion.
  * **Prefix cache** — prompts are matched against the block trie
    (``repro_torch.serve.prefix_cache``); a hit increfs the shared dense
    blocks, restores the boundary snapshot (the MoSA caches, the window
    rings' content scattered into the row's own ring blocks) and prefills
    only the unshared suffix (the exact union selection of
    ``MoSAAttention.prefill_past``).  On a miss the prefill is split at
    the shareable boundary so the inserted snapshot is a function of the
    prefix tokens alone.  A pure paged-dense model needs no snapshot and
    can hit at any chain depth.
  * **Chunked packed prefill** — prompts stream through
    ``Server.prefill_packed`` in ``chunk_tokens``-slot chunks: up to
    ``max_prefill_segs`` pending rows' next segments are packed back to
    back, with ``cu_seqlens``/``rows``/``past_lens`` carrying the
    raggedness.  Decode chunks of live rows interleave between prefill
    chunks: mid-prefill rows are paused (host snapshot + empty tables, so
    the decode dispatch's writes drop) and resumed before their next
    chunk.

On a mesh (the server's ``ctx``) every rank runs the Scheduler on its
shards and must make the same decisions (admission, packing, pauses,
prefix inserts, growth, preemption).  They depend only on host state and
on the sampled tokens, which every rank draws from the same all-gathered
logits, so a step-indexed run needs no collective of its own; a timed run
reads its arrivals on rank 0 alone and broadcasts them (``_pump``).  The
mesh must have one data-parallel rank: rows over dp are ROADMAP A.7c.

Differences from the JAX package: no sharding hints; sampling goes through
``sample_logits`` with a ``torch.Generator`` (greedy by default, as there);
results are int32 CPU tensors; the whole ``run`` loop and every cache op
runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from collections import OrderedDict
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core.kv_cache import MoSABlockKVCache, MoSAKVCache
from repro_torch.serve.paged_kv import (BlockPool, PagedDenseKVCache,
                                        PagedWindowKVCache)
from repro_torch.serve.prefix_cache import PrefixCache

# Bounded retention for per-request SLO records.
RECORDS_KEEP = 8192


class _Submits:
    """Stands for the Scheduler in a timed run's ``source.pump``: submits
    to it and keeps what was submitted (to be broadcast to the other ranks
    of a mesh); any other attribute is the Scheduler's."""

    def __init__(self, sched):
        self._sched, self.submitted = sched, []

    def submit(self, prompt, max_new: int, tenant: str = "") -> int:
        self.submitted.append((_tokens(prompt), max_new, tenant))
        return self._sched.submit(prompt, max_new, tenant=tenant)

    def __getattr__(self, name):
        return getattr(self._sched, name)


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray           # int32 token ids
    max_new: int
    generated: list = dataclasses.field(default_factory=list)
    t_submit: float = 0.0        # tracer clock at submit/requeue
    t_arrival: float = 0.0       # tracer clock at ORIGINAL submit — unlike
    tenant: str = ""             # t_submit it survives preemption, so TTFT
    ttft: Optional[float] = None  # stays arrival-based


def _tokens(prompt) -> np.ndarray:
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.detach().cpu().numpy()
    return np.asarray(prompt).astype(np.int32).reshape(-1)


def _cache_leaves(caches) -> list:
    out = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)
        else:
            out.append(x)

    walk(caches)
    return out


def _paged_entries(snap) -> list:
    """The paged-cache dicts inside a host row snapshot (the only dicts
    carrying a ``block_table`` key; see ``launch.serve.row_snapshot``)."""
    out = []

    def walk(x):
        if isinstance(x, dict):
            if "block_table" in x:
                out.append(x)
                return
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)

    walk(snap)
    return out


def _set_snapshot_tables(snap, dense_row: np.ndarray,
                         window_row: np.ndarray) -> None:
    """Point a host snapshot's block tables at ``dense_row`` /
    ``window_row`` (int32, -1 padded).  Window entries are the ones that
    carry ring content (``"k"``)."""
    for e in _paged_entries(snap):
        row = window_row if "k" in e else dense_row
        e["block_table"] = torch.from_numpy(row.astype(np.int32).copy())


def _table_row(ids: List[int], width: int) -> np.ndarray:
    row = np.full((width,), -1, np.int32)
    row[:len(ids)] = ids
    return row


# ----------------------------------------------- serve-time router health
def _selection_health(pos, wt, n_slots: int) -> dict:
    """Entropy of the selection weight mass over ``n_slots`` (normalized by
    ``log n_slots``), the fraction of slots selected by no head, and the
    mean selection weight, over flat selected slots ``pos`` with weights
    ``wt``."""
    n = max(int(n_slots), 2)
    keep = (pos >= 0) & (pos < n)
    pos, wt = pos[keep], wt[keep]
    counts = np.bincount(pos, minlength=n)
    mass = np.bincount(pos, weights=np.maximum(wt, 0.0), minlength=n)
    tot = mass.sum()
    p = (mass / tot) if tot > 0 else np.full(n, 1.0 / n)
    ent = float(-(p * np.log(np.maximum(p, 1e-12))).sum() / np.log(n))
    return {"sel_entropy": ent,
            "drop_rate": float((counts == 0).mean()),
            "head_util": float(wt.mean()) if wt.size else 0.0}


def _router_health_from_snapshot(snap, P: int) -> dict:
    """MoSA router health of one request from the host row snapshot its
    prefill just produced: each cache's kept tokens scored over the ``P``
    prompt positions (block choice: its candidate blocks over the prompt's
    blocks), averaged over the MoSA layers."""
    samples = []
    for x in _cache_leaves(snap):
        if isinstance(x, MoSAKVCache):
            s, ix, n_slots = x.scores, x.idx, P
        elif isinstance(x, MoSABlockKVCache):
            s, ix = x.bscore[..., :-1], x.bidx[..., :-1]
            n_slots = -(-int(P) // x.block_size)
        else:
            continue
        s = s.double().numpy()
        ix = ix.long().numpy()
        s2 = s.reshape(-1, s.shape[-2] * s.shape[-1])
        i2 = ix.reshape(-1, ix.shape[-2] * ix.shape[-1])
        for row in range(s2.shape[0]):
            valid = np.isfinite(s2[row]) & (i2[row] >= 0)
            samples.append(_selection_health(i2[row][valid], s2[row][valid],
                                             n_slots))
    if not samples:
        return {}
    return {k: float(np.mean([s[k] for s in samples]))
            for k in ("sel_entropy", "drop_rate", "head_util")}


class Scheduler:
    """Continuous batching with block-granular admission.

    ``server``: a ``repro_torch.launch.serve.Server`` built with
    ``paged=PagedConfig(num_blocks=..., num_window_blocks=...)`` —
    explicit budgets (the window one for a model with window layers); the
    worst-case auto sizing would make admission vacuous."""

    def __init__(self, server, eos: int = -1, chunk: int = 8,
                 chunk_tokens: int = 64, max_prefill_segs: int = 4,
                 prefix_cache: bool = True,
                 metrics_path: Optional[str] = None,
                 trace_path: Optional[str] = None,
                 router_health_every: int = 4,
                 max_queue: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0):
        """``chunk``: decode tokens per decode dispatch.  ``chunk_tokens``:
        the packed prefill chunk of C token slots; ``max_prefill_segs``:
        most pending rows packed per chunk (N).

        Observability: metrics and spans go to the global
        ``repro_torch.obs`` registry and tracer; ``metrics_path`` (``.jsonl``
        appends a snapshot line) and ``trace_path`` (Chrome-trace JSON) are
        written when ``run()`` drains.  ``router_health_every``: every Nth
        completed prompt on a MoSA model gets its router health sampled
        from the prefill's row snapshot (0 disables it).

        ``max_queue``: a submit arriving with ``max_queue`` requests
        already waiting is SHED (empty result, ``serve.shed`` counter,
        ``outcome="shed"`` record) instead of queued; ``None`` never sheds.

        Sampling: greedy when ``temperature == 0`` (the default, as the JAX
        scheduler); otherwise ``sample_logits`` with a ``torch.Generator``
        seeded from ``seed`` on the server's device."""
        from repro_torch.launch.serve import check_one_dp_rank
        check_one_dp_rank(server, "Scheduler")
        paged = server.paged
        if paged is None or paged.num_blocks <= 0:
            raise ValueError("Scheduler needs Server(paged=PagedConfig("
                             "num_blocks=...)) with an explicit dense-block "
                             "budget")
        self.server = server
        self.eos = eos
        self.chunk = chunk
        self.chunk_tokens = min(chunk_tokens, server.max_len)
        self.max_segs = max(1, max_prefill_segs)
        self.bs = paged.block_size
        self.temperature = temperature
        self.top_k = top_k
        self.generator = torch.Generator(device=server.device).manual_seed(
            seed)
        self.queue: List[_Request] = []
        self.results: dict = {}

        self.caches = server.new_cache()
        leaves = _cache_leaves(self.caches)
        dense = [x for x in leaves if isinstance(x, PagedDenseKVCache)]
        window = [x for x in leaves if isinstance(x, PagedWindowKVCache)]
        if not dense:
            raise ValueError("paged scheduler needs at least one paged dense "
                             "layer")
        self.nb_max = dense[0].block_table.shape[-1]
        self.has_window = bool(window)
        self.wb = window[0].block_table.shape[-1] if window else 0
        if self.has_window and paged.num_window_blocks <= 0:
            raise ValueError("the model has window layers: pass "
                             "PagedConfig(num_window_blocks=...)")
        # A hit must restore per-row state beyond dense blocks (MoSA top-k
        # sets, window rings) -> only snapshot nodes usable.
        self.need_snapshot = any(
            not isinstance(x, PagedDenseKVCache) for x in leaves)

        self.dense_pool = BlockPool(paged.num_blocks, self.bs, name="dense")
        self.window_pool = (BlockPool(paged.num_window_blocks, self.bs,
                                      name="window")
                            if self.has_window else None)
        self.prefix = PrefixCache(self.bs) if prefix_cache else None
        self._empty_row = server.snapshot_row(self.caches, 0)
        # prefill_chunks * chunk_tokens is the slot count every dispatch
        # pays; prefilled_tokens / prefill_chunk_slots is the packed-token
        # efficiency.
        self.stats = {"prefix_hits": 0, "prefix_hit_tokens": 0,
                      "prefilled_tokens": 0, "prefill_chunks": 0,
                      "prefill_chunk_slots": 0, "preemptions": 0,
                      "max_concurrent": 0}
        self.records: OrderedDict = OrderedDict()
        self.max_queue = max_queue
        self.metrics_path = metrics_path
        self.trace_path = trace_path
        self.router_health_every = router_health_every
        self._has_mosa = any(isinstance(x, (MoSAKVCache, MoSABlockKVCache))
                             for x in leaves)
        self._health_seen = 0

        B = server.batch
        self._slots: List[Optional[dict]] = [None] * B
        self._admit_seq = 0

    def _record_ttft(self, r: _Request, dt: float) -> None:
        r.ttft = dt
        reg = obs.registry()
        reg.observe("serve.ttft_s", dt)
        if r.tenant:
            reg.observe("serve.ttft_s", dt, tenant=r.tenant)

    def _record(self, r: _Request, outcome: str,
                queue_delay: float = 0.0, tpot=None) -> None:
        """Append ``r``'s SLO record (``obs.slo`` schema)."""
        self.records[r.rid] = {
            "rid": r.rid, "tenant": r.tenant, "outcome": outcome,
            "t_arrival": r.t_arrival, "queue_delay_s": queue_delay,
            "ttft_s": r.ttft, "tpot_s": tpot,
            "new_tokens": len(r.generated)}
        while len(self.records) > RECORDS_KEEP:
            self.records.popitem(last=False)

    def _in_flight(self) -> int:
        return sum(s is not None for s in self._slots)

    # ----------------------------------------------------------- interface
    def submit(self, prompt, max_new: int, tenant: str = "") -> int:
        """Queue a request (``prompt``: 1-d token ids, tensor, array or
        list); returns its id."""
        rid = len(self.results) + len(self.queue) + \
            sum(s is not None for s in self._slots)
        now = obs.tracer().now()
        reg = obs.registry()
        reg.inc("serve.submitted")
        if tenant:
            reg.inc("serve.submitted", tenant=tenant)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            r = _Request(rid, np.zeros((0,), np.int32), 0,
                         t_submit=now, t_arrival=now, tenant=tenant)
            self.results[rid] = torch.zeros((0,), dtype=torch.int32)
            self._record(r, "shed")
            reg.inc("serve.shed")
            if tenant:
                reg.inc("serve.shed", tenant=tenant)
            obs.tracer().instant("shed", track=f"req{rid}", tenant=tenant)
            return rid
        self.queue.append(_Request(rid, _tokens(prompt), max_new,
                                   t_submit=now, t_arrival=now,
                                   tenant=tenant))
        reg.set("serve.queue_depth", len(self.queue))
        return rid

    # ------------------------------------------------------------- helpers
    def _alloc_dense(self, n: int):
        """All-or-nothing dense alloc, LRU-evicting prefix entries first."""
        while True:
            ids = self.dense_pool.alloc(n)
            if ids is not None:
                return ids
            if self.prefix is None or not self.prefix.evict_lru(
                    self.dense_pool):
                return None

    def _window_blocks_for(self, tokens: int) -> int:
        """Ring blocks needed once ``tokens`` tokens have been written:
        positions ``0..tokens-1`` land on ring slots ``0..min(tokens,
        W)-1`` (the ring fills in order until it wraps), so the allocated
        blocks are a prefix of the table: growth extends it."""
        W = self.wb * self.bs
        return -(-min(tokens, W) // self.bs)

    def _free_slot(self, b):
        """Release row ``b``'s blocks AND clear its device state: decode
        keeps stepping every row, so a stale block table would scatter the
        dead row's KV into freed blocks (dense or ring) the allocator may
        already have handed to a live request.  The empty template (-1
        tables, zero lengths) makes the dead row's writes drop instead."""
        s = self._slots[b]
        self.dense_pool.decref(s["dense_ids"])
        if self.window_pool is not None:
            self.window_pool.decref(s["window_ids"])
        self._slots[b] = None
        self.caches = self.server.restore_row(
            self.caches, copy.deepcopy(self._empty_row), b)

    def _finish(self, b):
        s = self._slots[b]
        r = s["req"]
        self.results[r.rid] = torch.tensor(r.generated, dtype=torch.int32)
        reg, tr = obs.registry(), obs.tracer()
        now = tr.now()
        tpot = None
        if s.get("t_first") is not None:
            tr.add("decode", s["t_first"], now, track=f"req{r.rid}",
                   tokens=len(r.generated))
            if len(r.generated) >= 2:
                tpot = (now - s["t_first"]) / (len(r.generated) - 1)
                reg.observe("serve.tpot_s", tpot)
                if r.tenant:
                    reg.observe("serve.tpot_s", tpot, tenant=r.tenant)
        tr.instant("finish", track=f"req{r.rid}", tokens=len(r.generated),
                   tenant=r.tenant)
        reg.inc("serve.finished")
        if r.tenant:
            reg.inc("serve.finished", tenant=r.tenant)
        reg.inc("serve.generated_tokens", len(r.generated))
        self._record(r, "finished", queue_delay=s.get("queue_delay", 0.0),
                     tpot=tpot)
        self._free_slot(b)
        reg.set("serve.in_flight", self._in_flight())

    def _preempt(self, b):
        """Preempt-to-recompute: release every block, requeue with
        prompt + generated as the new prompt."""
        s = self._slots[b]
        r = s["req"]
        if r.generated:
            r.prompt = np.concatenate(
                [r.prompt, np.asarray(r.generated, np.int32)])
        reg, tr = obs.registry(), obs.tracer()
        now = tr.now()
        phase_t0 = s["t_first"] if s.get("t_first") is not None \
            else s.get("t_admit", now)
        tr.add(s["phase"], phase_t0, now, track=f"req{r.rid}",
               preempted=True)
        tr.instant("preempt", track=f"req{r.rid}")
        self._free_slot(b)
        self.queue.insert(0, r)
        r.t_submit = now                 # requeue restarts the queue wait
        self.stats["preemptions"] += 1
        reg.inc("serve.preempted")
        if r.tenant:
            reg.inc("serve.preempted", tenant=r.tenant)
        reg.set("serve.in_flight", self._in_flight())

    def _pending_same_prefix(self, prompt_np, P) -> bool:
        """True when a live mid-prefill row will shortly trie-insert a
        shareable prefix of ``prompt_np`` — admitting now would recompute
        those shared blocks."""
        n_share = ((P - 1) // self.bs) * self.bs
        for s in self._slots:
            if s is None or s["phase"] != "prefill":
                continue
            ins = s["insert_at"]
            if ins is None:
                continue
            if self.need_snapshot:
                # hits land only on snapshot-carrying tips: useful iff our
                # prompt contains the row's FULL pending prefix
                d = ins if ins <= n_share else 0
            else:
                # snapshot-free: any block-aligned common depth along the
                # pending chain is a future hit
                d = min(ins, n_share)
            if d >= self.bs and np.array_equal(s["prompt_np"][:d],
                                               prompt_np[:d]):
                return True
        return False

    # ------------------------------------------------------------ admission
    def _admit(self, b, r: _Request) -> Optional[bool]:
        """Admit ``r`` into row ``b``: allocate its blocks, restore its
        snapshot/tables, and park it in ``phase="prefill"`` — the prompt is
        streamed by ``_advance_prefills``.  Returns True, or None when the
        pool cannot cover the prompt."""
        srv = self.server
        prompt_np = r.prompt
        P = min(len(prompt_np), srv.max_len)
        prompt_np = prompt_np[-P:]
        remaining_cap = srv.max_len - P + 1
        r.max_new = min(r.max_new, len(r.generated) + remaining_cap)

        node, depth, chain_ids = None, 0, []
        if self.prefix is not None:
            node, depth = self.prefix.lookup(prompt_np, self.need_snapshot)
            if node is None and self._pending_same_prefix(prompt_np, P):
                # A live mid-prefill row is about to insert this very
                # prefix: wait one round rather than recompute it.
                return None
        n_prompt_blocks = -(-P // self.bs)
        n_new_blocks = n_prompt_blocks - depth // self.bs

        if node is not None:
            chain_ids = self.prefix.acquire(node, self.dense_pool)
        suffix_ids = self._alloc_dense(n_new_blocks)
        if suffix_ids is None:
            if chain_ids:
                self.dense_pool.decref(chain_ids)
            return None
        window_ids: List[int] = []
        if self.window_pool is not None:
            # lazy ring: only the blocks the prompt's P tokens will write
            window_ids = self.window_pool.alloc(self._window_blocks_for(P))
            if window_ids is None:
                self.dense_pool.decref(chain_ids + suffix_ids)
                return None
        dense_ids = chain_ids + suffix_ids

        insert_at = None
        if node is not None:
            if node.snapshot is not None:
                snap = copy.deepcopy(node.snapshot)
            else:
                # snapshot-free hit (pure paged-dense model, any depth):
                # the only per-row state is the table + length
                snap = copy.deepcopy(self._empty_row)
                for e in _paged_entries(snap):
                    e["length"] = torch.full_like(e["length"], depth)
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += depth
        else:
            snap = copy.deepcopy(self._empty_row)
            if self.prefix is not None and (P - 1) // self.bs > 0:
                # Miss: force a chunk boundary at the shareable depth so the
                # snapshot inserted there depends on the prefix tokens alone.
                insert_at = ((P - 1) // self.bs) * self.bs
        _set_snapshot_tables(snap, _table_row(dense_ids, self.nb_max),
                             _table_row(window_ids, max(self.wb, 1)))
        self.caches = srv.restore_row(self.caches, snap, b)

        reg, tr = obs.registry(), obs.tracer()
        now = tr.now()
        tr.add("queued", r.t_submit, now, track=f"req{r.rid}")
        reg.inc("serve.admitted")
        queue_delay = now - r.t_submit
        reg.observe("serve.queue_delay_s", queue_delay)
        if r.tenant:
            reg.observe("serve.queue_delay_s", queue_delay, tenant=r.tenant)
        if node is not None:
            reg.observe("serve.prefix_hit_frac", depth / max(P, 1),
                        bounds=obs.UNIT_BOUNDS)
        self._slots[b] = {"req": r, "dense_ids": dense_ids,
                          "window_ids": window_ids, "length": P,
                          "seq": self._admit_seq, "phase": "prefill",
                          "prompt_np": prompt_np, "done": depth,
                          "insert_at": insert_at, "paused_snap": None,
                          "t_admit": now, "t_first": None,
                          "queue_delay": queue_delay}
        self._admit_seq += 1
        self.stats["max_concurrent"] = max(self.stats["max_concurrent"],
                                           self._in_flight())
        reg.set("serve.in_flight", self._in_flight())
        reg.set_max("serve.max_concurrent", self._in_flight())
        return True

    # ------------------------------------------------------ chunked prefill
    def _advance_prefills(self, cur):
        """One packed prefill chunk: pack the next segments of up to
        ``max_segs`` pending rows (oldest first) into ``chunk_tokens``
        slots, dispatch ONE ``Server.prefill_packed``, then advance each row
        — snapshot-insert at a forced prefix boundary, or sample the first
        token and flip to decode when its prompt completes."""
        srv = self.server
        pending = sorted(
            (b for b in range(len(self._slots))
             if self._slots[b] is not None
             and self._slots[b]["phase"] == "prefill"),
            key=lambda x: self._slots[x]["seq"])
        C = self.chunk_tokens
        segs = []                            # (row, start, take)
        budget = C
        for b in pending:
            if budget == 0 or len(segs) == self.max_segs:
                break
            s = self._slots[b]
            take = min(len(s["prompt_np"]) - s["done"], budget)
            ins = s["insert_at"]
            if ins is not None and s["done"] < ins < s["done"] + take:
                take = ins - s["done"]       # stop AT the boundary
            segs.append((b, s["done"], take))
            budget -= take

        for b, _, _ in segs:                 # resume paused rows
            s = self._slots[b]
            if s["paused_snap"] is not None:
                self.caches = srv.restore_row(self.caches, s["paused_snap"],
                                              b)
                s["paused_snap"] = None
                obs.registry().inc("serve.resumes")

        N = self.max_segs
        buf = np.zeros((C,), np.int32)
        cu = np.zeros((N + 1,), np.int32)
        rows = np.full((N,), -1, np.int32)
        past = np.zeros((N,), np.int32)
        off = 0
        for i, (b, start, take) in enumerate(segs):
            buf[off:off + take] = self._slots[b]["prompt_np"][start:start +
                                                              take]
            rows[i] = b
            past[i] = start
            off += take
            cu[i + 1] = off
        cu[len(segs) + 1:] = off
        reg, tr = obs.registry(), obs.tracer()
        dev = srv.device
        with tr.span("prefill_chunk", track="sched", segs=len(segs),
                     tokens=off):
            logits, self.caches = srv.prefill_packed(
                torch.from_numpy(buf).long()[None].to(dev), self.caches,
                torch.from_numpy(cu).to(dev), torch.from_numpy(rows).to(dev),
                torch.from_numpy(past).to(dev))
        self.stats["prefilled_tokens"] += off
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_chunk_slots"] += C
        reg.inc("serve.prefill_chunks")
        reg.inc("serve.prefilled_tokens", off)
        reg.observe("serve.chunk_packed_efficiency", off / C,
                    bounds=obs.UNIT_BOUNDS)

        for i, (b, start, take) in enumerate(segs):
            s = self._slots[b]
            s["done"] += take
            if s["insert_at"] is not None and s["done"] == s["insert_at"]:
                self._insert_prefix(b)
            if s["done"] == len(s["prompt_np"]):
                s["phase"] = "decode"
                s["length"] = len(s["prompt_np"])
                tok0 = int(srv.sample(logits[i:i + 1], self.generator,
                                      self.temperature, self.top_k)[0])
                r = s["req"]
                r.generated.append(tok0)
                now = tr.now()
                # resumed=True marks a post-preemption re-prefill (the
                # request produced its first token in an earlier life)
                tr.add("prefill", s["t_admit"], now, track=f"req{r.rid}",
                       prompt=len(s["prompt_np"]),
                       resumed=r.ttft is not None)
                s["t_first"] = now
                if r.ttft is None:
                    # arrival-based TTFT: first token minus submit time,
                    # queue wait included; survives preemption
                    self._record_ttft(r, now - r.t_arrival)
                self._sample_router_health(b)
                cur[b, 0] = tok0
                if len(r.generated) >= r.max_new or tok0 == self.eos:
                    self._finish(b)
        return cur

    def _sample_router_health(self, b) -> None:
        """Every ``router_health_every``-th completed prompt on a MoSA
        model: read the row snapshot its prefill just wrote and publish
        sel_entropy / drop_rate / head_util into the registry."""
        if not self._has_mosa or not self.router_health_every:
            return
        reg = obs.registry()
        if not reg.enabled:
            return
        self._health_seen += 1
        if (self._health_seen - 1) % self.router_health_every:
            return
        s = self._slots[b]
        snap = self.server.snapshot_row(self.caches, b)
        stats = _router_health_from_snapshot(snap, len(s["prompt_np"]))
        for k, v in stats.items():
            reg.observe(f"serve.router.{k}", v, bounds=obs.UNIT_BOUNDS)

    def _insert_prefix(self, b):
        """Insert row ``b``'s shareable prefix into the trie.  Called when
        ``done`` hits the forced boundary: the row's device state is then
        exactly the one-shot prefill of ``prompt[:insert_at]`` (packed
        chunking is exact), a function of the prefix tokens alone."""
        srv = self.server
        s = self._slots[b]
        n_share = s["insert_at"]
        snap1 = srv.snapshot_row(self.caches, b)
        chain, tip = self.prefix.insert(
            s["prompt_np"][:n_share], s["dense_ids"][:n_share // self.bs],
            self.dense_pool)
        _set_snapshot_tables(snap1, _table_row(chain, self.nb_max),
                             _table_row([], max(self.wb, 1)))
        self.prefix.attach_snapshot(tip, snap1)
        s["insert_at"] = None

    def _pause_prefills(self):
        """Park every mid-prefill row before a decode dispatch:
        ``decode_many`` steps ALL rows, so its writes would advance the
        row's lengths and corrupt its MoSA selection.  The host snapshot
        preserves the row; the empty template (-1 tables, zero lengths)
        makes the decode writes drop.  ``_advance_prefills`` restores the
        snapshot before the row's next chunk."""
        srv, reg = self.server, obs.registry()
        with reg.timer("serve.pause_s"):
            for b, s in enumerate(self._slots):
                if s is not None and s["phase"] == "prefill" \
                        and s["paused_snap"] is None:
                    s["paused_snap"] = srv.snapshot_row(self.caches, b)
                    self.caches = srv.restore_row(
                        self.caches, copy.deepcopy(self._empty_row), b)
                    reg.inc("serve.pauses")

    # ------------------------------------------------------------- growth
    def _alloc_or_preempt(self, alloc_fn, n: int, b: int, live):
        """``alloc_fn(n)``, preempting latest-admitted victims on failure.
        Only rows newer than ``b`` are victims (the oldest request never
        loses its blocks to a newer one); when none exists, the caller
        preempts ``b`` itself."""
        ids = alloc_fn(n)
        while ids is None:
            s = self._slots[b]
            victims = [x for x in live
                       if self._slots[x] is not None and x != b
                       and self._slots[x]["seq"] > s["seq"]]
            if not victims:
                return None
            victim = max(victims, key=lambda x: self._slots[x]["seq"])
            self._preempt(victim)
            ids = alloc_fn(n)
        return ids

    def _grow_row(self, b: int, n: int, live) -> bool:
        """Cover the next ``n`` decode tokens of row ``b``: dense chain
        blocks, and the ring blocks those tokens' ring slots need
        (allocation always precedes the write).  Returns False iff ``b``
        itself had to be preempted."""
        srv = self.server
        s = self._slots[b]
        needed = min(-(-(s["length"] + n) // self.bs), self.nb_max)
        extra = needed - len(s["dense_ids"])
        if extra > 0:
            ids = self._alloc_or_preempt(self._alloc_dense, extra, b, live)
            if ids is None:
                self._preempt(b)
                return False
            s["dense_ids"].extend(ids)
            self.caches = srv.grow_tables(
                self.caches, _table_row(s["dense_ids"], self.nb_max), b)
        if self.window_pool is not None:
            extra_w = self._window_blocks_for(s["length"] + n) \
                - len(s["window_ids"])
            if extra_w > 0:
                ids = self._alloc_or_preempt(self.window_pool.alloc,
                                             extra_w, b, live)
                if ids is None:
                    self._preempt(b)
                    return False
                s["window_ids"].extend(ids)
                self.caches = srv.grow_window_tables(
                    self.caches, _table_row(s["window_ids"], self.wb), b)
        return True

    # ---------------------------------------------------------------- run
    def run(self, max_steps: int = 1000, source=None):
        """Serve every queued request; returns {rid: generated tokens}.
        EOS, per-request ``max_new`` and a global ``max_steps`` decode
        budget end requests.

        **Timed mode**: ``source`` is a duck-typed arrival stream
        (``repro_torch.serve.loadgen`` builds them) that SUBMITS requests at
        their arrival times.  Protocol: ``pump(sched, now)`` submits every
        request due by ``now`` (seconds since ``run()`` started),
        ``exhausted()`` says no more arrivals will come,
        ``next_arrival_in(now)`` is the wait until the next one.  The loop
        runs until the source is exhausted AND the system drains; while
        idle between arrivals it sleeps (<= 50 ms slices)."""
        with torch.inference_mode():
            return self._run(max_steps, source)

    def _reads_source(self) -> bool:
        """Whether this process reads a timed run's source: off a mesh it
        does; on a mesh rank 0 alone does (``_pump``)."""
        ctx = self.server.ctx
        return ctx is None or ctx.world == 1 or ctx.rank == 0

    def _pump(self, source, now: float, reader: bool) -> bool:
        """Timed mode: submit the requests ``source`` has due by ``now``;
        returns whether it is exhausted.  On a mesh every rank must make
        the same decisions, so rank 0 alone pumps the source and
        broadcasts what it submitted (one small collective per loop), and
        the other ranks submit the same requests in the same order."""
        if reader:
            rec = _Submits(self)
            source.pump(rec, now)
            msg = [(rec.submitted, source.exhausted())]
        else:
            msg = [None]
        if self.server.ctx is None or self.server.ctx.world == 1:
            return msg[0][1]
        dist.broadcast_object_list(msg, src=0)
        submitted, exhausted = msg[0]
        if not reader:
            for prompt, max_new, tenant in submitted:
                self.submit(prompt, max_new, tenant=tenant)
        return exhausted

    def _run(self, max_steps, source):
        srv = self.server
        B = srv.batch
        cur = torch.zeros((B, 1), dtype=torch.long, device=srv.device)
        steps = 0
        timer = obs.registry().timer("serve.run_s")
        timer.__enter__()
        t_run0 = obs.tracer().now()

        def by_phase(phase):
            return [b for b in range(B) if self._slots[b] is not None
                    and self._slots[b]["phase"] == phase]

        reader = self._reads_source()
        while True:
            exhausted = True
            if source is not None:
                exhausted = self._pump(source, obs.tracer().now() - t_run0,
                                       reader)
            if not self.queue and all(s is None for s in self._slots):
                if exhausted:
                    break
                if reader:              # the other ranks wait in _pump
                    wait = source.next_arrival_in(obs.tracer().now()
                                                  - t_run0)
                    if wait is not None and wait > 0:
                        time.sleep(min(wait, 0.05))
                continue
            for b in range(B):
                if self._slots[b] is None and self.queue \
                        and steps < max_steps:
                    if self._admit(b, self.queue[0]) is None:
                        break               # blocks exhausted: wait
                    self.queue.pop(0)
                    obs.registry().set("serve.queue_depth", len(self.queue))
            live_pre, live_dec = by_phase("prefill"), by_phase("decode")
            if not live_pre and not live_dec:
                if steps >= max_steps:
                    break
                if self.queue and not any(self._slots):
                    # nothing live and head-of-queue cannot be admitted
                    raise RuntimeError(
                        "request needs more blocks than the pool has: "
                        f"free={self.dense_pool.free_blocks} of "
                        f"{self.dense_pool.num_blocks}")
                continue
            if steps >= max_steps:
                # Decode budget spent: wind down, but rows caught
                # mid-prefill still stream to completion so every admitted
                # request yields its first token.
                for b in live_dec:
                    self._finish(b)
                if not live_pre:
                    break

            if live_pre:
                # One packed prefill chunk, then (at most) one decode chunk
                # — long prompts interleave with live decodes.
                cur = self._advance_prefills(cur)
                live_dec = by_phase("decode")
            if not live_dec or steps >= max_steps:
                continue

            need = max(self._slots[b]["req"].max_new -
                       len(self._slots[b]["req"].generated)
                       for b in live_dec)
            n = max(min(self.chunk, max_steps - steps, need), 1)

            # Grow the decode rows' chains to cover the next n appended
            # tokens; preempt latest-admitted rows (mid-prefill ones
            # included) when the pool runs dry.
            self._pause_prefills()
            live = [b for b in range(B) if self._slots[b] is not None]
            for b in sorted(live_dec, key=lambda x: self._slots[x]["seq"]):
                if self._slots[b] is None:
                    continue
                self._grow_row(b, n, live)
            live_dec = by_phase("decode")
            if not live_dec:
                continue

            reg, tr = obs.registry(), obs.tracer()
            with tr.span("decode_chunk", track="sched", rows=len(live_dec),
                         n=n):
                toks, self.caches = srv.decode_many(
                    cur, self.caches, self.generator, n, self.temperature,
                    self.top_k)
                steps += n
                host = toks.cpu().numpy()
            reg.inc("serve.decode_chunks")
            reg.inc("serve.decode_tokens", n * len(live_dec))
            reg.observe("serve.decode_batch", len(live_dec))
            cur = toks[:, -1:].clone()
            for b in live_dec:
                s = self._slots[b]
                if s is None:
                    continue
                r = s["req"]
                for t in host[b]:
                    r.generated.append(int(t))
                    s["length"] += 1
                    if int(t) == self.eos or len(r.generated) >= r.max_new:
                        self._finish(b)
                        break
        timer.__exit__(None, None, None)
        reg = obs.registry()
        if reg.enabled:
            reg.set("serve.tokens_per_s",
                    reg.counter("serve.generated_tokens").value /
                    max(timer.dt, 1e-9))
        obs.dump(self.metrics_path, self.trace_path, tag="scheduler")
        return dict(self.results)
