"""Prefix cache: a hash-trie over prompt token blocks (the port's copy of
``repro.serve.prefix_cache``).

Requests in real serving traffic share prompt prefixes (system prompts,
few-shot preambles, multi-turn history).  With paged KV, a shared prefix can
map to SHARED physical blocks: the trie's nodes each cover one full block of
``block_size`` prompt tokens, hold the dense-layer physical block id for
that span, and are refcounted through ``BlockPool`` — a prefix-cache hit
increfs the chain and the new request's block table simply points at the
existing blocks, skipping both the HBM and the prefill compute for the
shared span.

What a node stores:

  * ``block_id``  — the dense-group physical block for this token span
    (dense blocks are append-only, hence immutable once full, hence
    shareable without copy-on-write);
  * ``snapshot``  — attached at chain tips: the host-side row snapshot
    (``repro_torch.launch.serve.row_snapshot``) of all BOUNDED per-row
    state at this boundary — the MoSA top-k caches (O(k)) — everything a
    restored row needs beyond the dense blocks.

Usable hits: models whose only per-row state is paged-dense KV can reuse
ANY chain depth; models with stateful layers (MoSA) need the
boundary snapshot, so only snapshot-bearing nodes are usable
(``need_snapshot=True``).  The chain always covers at most the first
``P - 1`` prompt tokens so a hit still prefills >= 1 token for logits.

Eviction is leaf-first LRU: a leaf's block ref is released back to the
``BlockPool`` (physical memory survives while any live request still
references it — that is the refcount's job, not the trie's).
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import registry as _obs_registry


class _Node:
    __slots__ = ("parent", "tokens", "block_id", "children", "snapshot",
                 "depth", "last_used")

    def __init__(self, parent, tokens, block_id, depth):
        self.parent = parent
        self.tokens = tokens          # tuple — this block's token span
        self.block_id = block_id      # dense-group physical block id
        self.children: dict = {}      # tokens tuple -> _Node
        self.snapshot = None          # host row snapshot at this boundary
        self.depth = depth            # tokens covered up to and incl. here
        self.last_used = 0


class PrefixCache:
    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root = _Node(None, (), -1, 0)
        self._clock = itertools.count(1)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0

    # ------------------------------------------------------------- queries
    def _chain(self, node: _Node) -> List[_Node]:
        out = []
        while node is not None and node is not self.root:
            out.append(node)
            node = node.parent
        return out[::-1]

    def chain_ids(self, node: _Node) -> List[int]:
        return [n.block_id for n in self._chain(node)]

    def lookup(self, tokens: Sequence[int],
               need_snapshot: bool = True) -> Tuple[Optional[_Node], int]:
        """Deepest usable node for ``tokens`` (full blocks of the first
        ``len(tokens) - 1`` only) and the token depth it covers.

        ``need_snapshot``: restrict to snapshot-bearing nodes (stateful
        models — see module docstring)."""
        bs = self.block_size
        toks = [int(t) for t in tokens]
        n_blocks = max(len(toks) - 1, 0) // bs
        node, best, now = self.root, None, next(self._clock)
        for i in range(n_blocks):
            key = tuple(toks[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                break
            node = child
            if child.snapshot is not None or not need_snapshot:
                best = child
        if best is None:
            self.misses += 1
            _obs_registry().inc("prefix.misses")
            return None, 0
        self.hits += 1
        self.hit_tokens += best.depth
        reg = _obs_registry()            # mirrors of the legacy attrs
        reg.inc("prefix.hits")
        reg.inc("prefix.hit_tokens", best.depth)
        for n in self._chain(best):
            n.last_used = now
        return best, best.depth

    def acquire(self, node: _Node, pool) -> List[int]:
        """Incref the chain's dense blocks for a request; returns the ids in
        block order.  Caller decrefs them when the request retires."""
        ids = self.chain_ids(node)
        pool.incref(ids)
        return ids

    # ------------------------------------------------------------ mutation
    def insert(self, tokens: Sequence[int], block_ids: Sequence[int],
               pool) -> Tuple[List[int], Optional[_Node]]:
        """Record a computed prefix: one node per full block of ``tokens``
        (``len(tokens)`` must be ``n * block_size``), ``block_ids`` the
        row's dense blocks for those spans.

        Existing nodes keep THEIR block id (identical content — prefill is
        deterministic in the tokens); new nodes adopt the caller's id and
        the trie takes its own ref.  Returns ``(chain, tip)``: the trie's
        authoritative chain ids — the caller rewrites its snapshot's dense
        tables to these before ``attach_snapshot``, so a later restore
        increfs exactly the blocks the trie owns — and the tip node.
        """
        bs = self.block_size
        toks = [int(t) for t in tokens]
        assert len(toks) % bs == 0, (len(toks), bs)
        n_blocks = len(toks) // bs
        assert len(block_ids) >= n_blocks, (len(block_ids), n_blocks)
        node, chain, now = self.root, [], next(self._clock)
        for i in range(n_blocks):
            key = tuple(toks[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = _Node(node, key, int(block_ids[i]), (i + 1) * bs)
                pool.incref([child.block_id])
                node.children[key] = child
            child.last_used = now
            chain.append(child.block_id)
            node = child
        reg = _obs_registry()
        if reg.enabled:
            reg.inc("prefix.inserts")
            reg.set("prefix.nodes", self.n_nodes)
        return chain, (None if node is self.root else node)

    def attach_snapshot(self, node: Optional[_Node], snapshot) -> None:
        """Attach a boundary snapshot at ``node`` (first writer wins — the
        state is a pure function of the prefix tokens)."""
        if node is not None and node.snapshot is None:
            node.snapshot = snapshot

    def evict_lru(self, pool) -> bool:
        """Drop the least-recently-used LEAF, releasing its block ref.
        Returns False when the trie is empty (nothing left to evict)."""
        leaves = [n for n in self._iter_nodes() if not n.children]
        if not leaves:
            return False
        victim = min(leaves, key=lambda n: n.last_used)
        pool.decref([victim.block_id])
        victim.parent.children.pop(victim.tokens, None)
        victim.snapshot = None
        reg = _obs_registry()
        if reg.enabled:
            reg.inc("prefix.evictions")
            reg.set("prefix.nodes", self.n_nodes)
        return True

    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    @property
    def n_nodes(self) -> int:
        return sum(1 for _ in self._iter_nodes())
