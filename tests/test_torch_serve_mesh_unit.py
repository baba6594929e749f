"""Serving on a mesh, in one process: the cache placements against the
JAX package's (``cache_spec`` for every cache family — the paged pools
included — under both rule sets, with and without ``seq_sharded`` and
layer stacking, on five meshes, a head count and a batch that the mesh
does not divide among them; ``cache_shardings`` over whole models' cache
trees), the rank-local caches that ``local_caches`` builds from them, and
the ``Server`` on a one-rank gloo mesh (1, 1) under each rule set against
the plain ``Server``: ``generate``'s tokens and logits and a Scheduler
run's tokens and stats bit for bit (one thread: the BLAS's thread count
changes its sums).  The spawned ranks are in ``test_torch_serve_mesh.py``."""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import kv_cache as jkvc
from repro.dist import sharding as jshd
from repro.nn.transformer import TransformerLM as JLM
from repro.serve import paged_kv as jpaged

from repro_torch.core import kv_cache as tkvc
from repro_torch.dist import sharding as tshd
from repro_torch.dist.parallel import local_caches
from repro_torch.launch.serve import Server, check_one_dp_rank
from repro_torch.nn.transformer import TransformerLM
from repro_torch.serve import paged_kv as tpaged
from repro_torch.serve.scheduler import Scheduler

from test_torch_dist_unit import MESHES, RULE_SETS, spec_tuple
from test_torch_parity import one_cpu_thread, torch_config  # noqa: F401

# name -> (JAX type, port type, create args, create kwargs)
CACHES = {
    "dense": ("DenseKVCache", (2, 32, 4, 16), {}),
    "window": ("WindowKVCache", (2, 16, 4, 16), {}),
    "mosa": ("MoSAKVCache", (2, 8, 8, 16), {}),
    "block": ("MoSABlockKVCache", (2, 8, 2, 4, 16), {}),
    "paged_dense": ("PagedDenseKVCache", (2, 32, 4, 16),
                    dict(block_size=8)),
    "paged_window": ("PagedWindowKVCache", (2, 16, 4, 16),
                     dict(block_size=8)),
    # a head count that no model axis above 1 divides; a batch of 1
    "dense_h3": ("DenseKVCache", (2, 32, 3, 16), {}),
    "mosa_h6b1": ("MoSAKVCache", (1, 6, 8, 16), {}),
    "paged_h3": ("PagedDenseKVCache", (3, 24, 3, 16), dict(block_size=8)),
}
SHAPES = MESHES + [{"data": 3, "model": 4}]


def _types(kind):
    if kind.startswith("Paged"):
        return getattr(jpaged, kind), getattr(tpaged, kind)
    return getattr(jkvc, kind), getattr(tkvc, kind)


def _both(name, stacked):
    kind, args, kw = CACHES[name]
    jt, tt = _types(kind)
    jc = jax.eval_shape(lambda: jt.create(*args, jnp.float32, **kw))
    tc = tt.create(*args, torch.float32, device="meta", **kw)
    if stacked:
        jc = jax.eval_shape(lambda: jax.tree.map(
            lambda t: jnp.zeros((3,) + t.shape, t.dtype), jc))
        tc = type(tc)(*(torch.empty((3,) + tuple(t.shape), dtype=t.dtype,
                                    device="meta") for t in tc))
    return jc, tc


@pytest.mark.parametrize("name", list(CACHES))
def test_cache_spec_matches_jax(name):
    for shape in SHAPES:
        mesh = SimpleNamespace(shape=dict(shape))
        for rs in RULE_SETS:
            for seq in (False, True):
                for stacked in (False, True):
                    jc, tc = _both(name, stacked)
                    want = jshd.cache_spec(jc, mesh, rs, seq, stacked)
                    got = tshd.cache_spec(tc, mesh, rs, seq, stacked)
                    assert type(got) is type(tc)
                    assert tuple(got) == tuple(spec_tuple(p) for p in want), \
                        (shape, rs, seq, stacked)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("name", ["sp32", "window", "block"])
def test_cache_shardings_of_model_trees_match_jax(name, paged):
    """The whole tree of a smoke model's caches (a list per layer in the
    port, one stacked ``scan`` unit in JAX): every field's placement."""
    kw = dict(preset="smoke", variant="mosa", sparsity=32, seq_len=1024)
    if name == "window":
        kw["local_window"] = 32
    if name == "block":
        kw.update(selection_granularity="block", sel_block_size=8)
    jcfg = jget_config("mosa-paper", **kw)
    pc = dict(block_size=16) if paged else None
    jtree = jax.eval_shape(lambda: JLM(jcfg).init_cache(
        4, 64, jnp.float32,
        paged=jpaged.PagedConfig(**pc) if paged else None))
    ttree = TransformerLM(torch_config(jcfg), device="meta").init_cache(
        4, 64, torch.float32,
        paged=tpaged.PagedConfig(**pc) if paged else None, device="meta")
    unit = jtree["scan"]["pos0"]
    for shape in SHAPES:
        am = jax.sharding.AbstractMesh(tuple(shape.values()), tuple(shape))
        for rs in RULE_SETS:
            for seq in (False, True):
                want = jshd.cache_shardings(jtree, am, rs, seq)["scan"][
                    "pos0"]
                got = tshd.cache_shardings(ttree, shape, rs, seq)
                for layer in got:
                    assert layer.keys() == unit.keys()
                    for side, c in layer.items():
                        for f, spec in zip(c._fields, c):
                            w = spec_tuple(getattr(want[side], f).spec)
                            # the stacked layer axis is replicated
                            assert w[:1] in ((), (None,))
                            assert spec == tuple(w[1:]), (shape, rs, seq,
                                                          side, f)


def test_cache_shardings_positional_fallback():
    """Untyped leaves: dim 0 over the dp axes that divide it, dim 1 over
    ``model`` under ``seq_sharded``, as JAX's fallback."""
    shape = {"data": 2, "model": 4}
    am = jax.sharding.AbstractMesh((2, 4), ("data", "model"))
    tree = {"a": (4, 8, 3), "b": (3, 8), "c": (4, 6)}
    for rs in RULE_SETS:
        for seq in (False, True):
            want = jshd.cache_shardings(
                {k: jax.ShapeDtypeStruct(v, jnp.float32)
                 for k, v in tree.items()}, am, rs, seq)
            got = tshd.cache_shardings(
                {k: torch.empty(v, device="meta") for k, v in tree.items()},
                shape, rs, seq)
            assert got == {k: spec_tuple(v.spec) for k, v in want.items()}


def test_local_caches_shapes_fills_and_identity_tables():
    """(data 2, model 4) under ``tp``: each rank's rows, heads and, with
    ``seq_sharded``, positions; the empty values of every field; an
    identity pool cut to this rank's rows' chains, a budgeted one whole."""
    mesh = {"data": 2, "model": 4}
    full = TransformerLM(torch_config(jget_config(
        "mosa-paper", preset="smoke", variant="mosa", sparsity=32,
        seq_len=1024)), device="meta")
    for paged, seq in ((tpaged.PagedConfig(16), False),
                       (tpaged.PagedConfig(16, num_blocks=40), False),
                       (None, True)):
        tree = full.init_cache(4, 64, torch.float32, paged=paged,
                               device="meta")
        loc = local_caches(tree, mesh, "tp", seq, paged, "cpu")
        sp, dn = loc[0]["sparse"], loc[0]["dense"]
        assert sp.k.shape == (2, 69, 2, 64) and sp.k.device.type == "cpu"
        assert (sp.scores == float("-inf")).all() and (sp.idx == -1).all()
        assert sp.length.shape == (2,) and (sp.length == 0).all()
        if paged is None:                    # seq: 16 of 64, every head
            assert dn.k.shape == (2, 16, 4, 64) and (dn.k == 0).all()
        elif paged.num_blocks:               # budgeted pool: whole
            assert dn.k.shape == (40, 16, 1, 64)
            assert (dn.block_table == -1).all()
            assert dn.block_table.shape == (2, 4)
        else:                                # identity: own rows' chains
            assert dn.k.shape == (8, 16, 1, 64)
            assert dn.block_table.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]


def test_scheduler_and_pool_refuse_dp_ranks():
    stub = SimpleNamespace(ctx=SimpleNamespace(dp_size=2))
    for what in ("Scheduler", "RequestPool"):
        with pytest.raises(ValueError, match="A.7c"):
            check_one_dp_rank(stub, what)
    check_one_dp_rank(SimpleNamespace(ctx=None), "Scheduler")
    check_one_dp_rank(SimpleNamespace(ctx=SimpleNamespace(dp_size=1)),
                      "Scheduler")


def test_server_without_mesh_starts_no_process_group():
    import torch.distributed as dist
    cfg = torch_config(jget_config("mosa-paper", preset="smoke",
                                   variant="mosa"))
    srv = Server(cfg, batch=2, max_len=32, device="cpu")
    assert srv.mesh is None and srv.ctx is None and srv.rows == (0, 2)
    assert not dist.is_initialized()


# --------------------------------------------------- one-rank gloo mesh
def _requests(vocab):
    rng = np.random.default_rng(5)
    shared = rng.integers(2, vocab, (17,), dtype=np.int32)
    return [(np.concatenate([shared, rng.integers(2, vocab, (L,),
                                                  dtype=np.int32)]), 8)
            for L in (3, 9, 1)]


def _serve(srv, prompts, sched_srv, reqs):
    toks, _ = srv.generate(prompts, 6)
    with torch.inference_mode():
        logits, caches = srv.model.prefill(prompts, srv.new_cache())
        tok0 = logits[:, -1].argmax(-1)[:, None]
        _, dec, _ = srv.model.decode_many(tok0, caches, n=5,
                                          return_logits=True)
    sched = Scheduler(sched_srv, chunk=4)
    for p, m in reqs:
        sched.submit(p, m)
    out = sched.run()
    return toks, logits, dec, out, dict(sched.stats)


@pytest.mark.parametrize("rule_set", RULE_SETS)
def test_one_rank_mesh_server_equals_plain_bitwise(rule_set, tmp_path,
                                                   one_cpu_thread):
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    cfg = torch_config(jget_config("mosa-paper", preset="smoke",
                                   variant="mosa"))
    prompts = torch.randint(2, cfg.vocab, (2, 20),
                            generator=torch.Generator().manual_seed(0))
    reqs = _requests(cfg.vocab)
    kw = dict(batch=2, max_len=64, device="cpu", seed=3)
    budget = tpaged.PagedConfig(8, num_blocks=12)
    want = _serve(Server(cfg, paged=tpaged.PagedConfig(16), **kw), prompts,
                  Server(cfg, paged=budget, **kw), reqs)
    mesh_lib.init_process_group("cpu", init_method=f"file://{tmp_path}/pg",
                                world_size=1, rank=0)
    try:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), "cpu")
        got = _serve(
            Server(cfg, paged=tpaged.PagedConfig(16), mesh=mesh,
                   rule_set=rule_set, **kw), prompts,
            Server(cfg, paged=budget, mesh=mesh, rule_set=rule_set, **kw),
            reqs)
    finally:
        dist.destroy_process_group()
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert got[3].keys() == want[3].keys()
    for rid in want[3]:
        assert torch.equal(got[3][rid], want[3][rid]), rid
    assert got[4] == want[4] and want[4]["prefix_hits"] >= 1


# ------------------------------------------- seq-sharded contiguous caches
class _ThreadReduce:
    """``tp_all_reduce`` across ``n`` threads that each serve one rank's
    slice (a barrier, then the max or the sum of the slots in rank
    order)."""

    def __init__(self, n):
        import threading
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=60)

    def __call__(self, t, tp, op="sum"):
        self.slots[tp.rank] = t
        self.barrier.wait()
        vals = torch.stack(self.slots)
        red = vals.amax(0) if op == "max" else vals.sum(0)
        self.barrier.wait()
        return t.copy_(red)


@pytest.mark.parametrize("window", [0, 24])
def test_seq_sharded_dense_and_window_caches(window, monkeypatch):
    """A dense (``window`` 0, 64 positions) or window (a ring of 24 slots)
    contiguous cache split over 4 ranks, each in a thread of its own with
    its own copy of the layer (``seq_sharded``: every head, a quarter of
    the positions or ring slots): the prompt's prefill and 10 decode steps
    (past the ring's wrap) give the whole layer's outputs within 1e-5, and
    together the slices hold the whole cache."""
    import copy
    import threading
    from repro_torch.configs.base import AttentionConfig
    from repro_torch.core import attention as attn
    from repro_torch.dist.parallel import TensorParallel
    m, B, T, steps = 4, 2, 20, 10
    torch.manual_seed(0)
    mha = attn.MultiHeadAttention(64, AttentionConfig(
        n_heads=4, n_kv_heads=2, d_head=16, window=window))
    with torch.no_grad():
        for p in mha.parameters():
            p.normal_(0, 64 ** -0.5)
    x = torch.randn(B, T + steps, 64)

    def make():
        if window:
            return tkvc.WindowKVCache.create(B, window, 2, 16, torch.float32)
        return tkvc.DenseKVCache.create(B, 64, 2, 16, torch.float32)

    def run(mod, cache):
        with torch.inference_mode():
            y, cache = mod.prefill(x[:, :T], cache)
            ys = [y]
            for t in range(T, T + steps):
                y, cache = mod.decode_step(x[:, t:t + 1], cache)
                ys.append(y)
        return ys, cache

    want, whole = run(mha, make())
    full = make()
    n = full.k.shape[1] // m
    results, errors = [None] * m, []

    def rank(r):
        try:
            mod = copy.deepcopy(mha)
            mod.mesh_tp, mod.seq_sharded = TensorParallel(None, r, m), True
            c = type(full)(*(t[:, r * n:(r + 1) * n].clone()
                             if t.dim() > 1 else t.clone() for t in full))
            assert mod._serve_mode(c) == "seq"
            results[r] = run(mod, c)
        except BaseException as e:          # noqa: BLE001
            errors.append((r, repr(e)))

    monkeypatch.setattr(attn, "tp_all_reduce", _ThreadReduce(m))
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(m)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for ys, _ in results:
        for y, w in zip(ys, want, strict=True):
            torch.testing.assert_close(y, w, atol=1e-5, rtol=1e-5)
    for f in ("k", "v") + (("positions",) if window else ()):
        cat = torch.cat([getattr(c, f) for _, c in results], 1)
        assert torch.equal(cat, getattr(whole, f)), f
    assert all(torch.equal(c.length, whole.length) for _, c in results)


# ------------------------------------------------ rank-local serving shards
@pytest.mark.parametrize("granularity", ["token", "block"])
def test_local_serving_shards_sum_to_the_layer(granularity):
    """A hybrid layer (8 MoSA + 4 dense heads) cut into ``model`` = 4
    rank-local shards (the raw ``tp`` placements, ``TensorParallel(None,
    r, 4)``: no collective) served on their own paged caches (one KV head
    each) through ``local_prefill``, ``local_prefill_packed`` and 3
    ``local_decode_step``s: the shards' outputs sum to the whole layer's
    within 1e-5 and their MoSA caches are its head slices (the same picks;
    the values within 1e-6)."""
    import copy
    from repro_torch.configs.base import MoSAConfig
    from repro_torch.core.hybrid import HybridAttention
    from repro_torch.dist.parallel import TensorParallel, shard_model
    from repro_torch.nn.transformer import packed_meta
    m, B, P, L, SEG = 4, 4, 40, 64, 8
    torch.manual_seed(0)
    extra = (dict(selection_granularity="block", sel_block_size=4)
             if granularity == "block" else {})
    layer = HybridAttention(64, MoSAConfig(n_mosa_heads=8, sparsity=4,
                                           n_dense_heads=4, d_head=16,
                                           **extra))
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0, 64 ** -0.5)
    x = torch.randn(B, P + SEG + 3, 64)
    chunk = x[:2, P:P + SEG].reshape(1, 2 * SEG, 64)
    meta = packed_meta([0, SEG, 2 * SEG], [0, 2], [P, P], 2 * SEG, "cpu")
    paged = tpaged.PagedConfig(8)

    def serve(mod, local):
        pre, pk, dec = ((mod.local_prefill, mod.local_prefill_packed,
                         mod.local_decode_step) if local else
                        (mod.prefill, mod.prefill_packed, mod.decode_step))
        c = mod.init_cache(B, L, torch.float32, paged=paged)
        with torch.inference_mode():
            y, c = pre(x[:, :P], c)
            ys = [y]
            y, c = pk(chunk, c, meta)
            ys.append(y)
            for i in range(3):
                y, c = dec(x[:, P + SEG + i:P + SEG + i + 1], c)
                ys.append(y)
        return ys, c

    want, full = serve(layer, False)
    mesh = {"data": 1, "model": m}
    specs = tshd.resolve_specs(tshd.param_shapes(layer), layer.specs(),
                               tshd.mesh_rules(mesh, "tp"), mesh)
    total = [torch.zeros_like(y) for y in want]
    for r in range(m):
        shard = shard_model(copy.deepcopy(layer), TensorParallel(None, r, m),
                            specs, {"data": 0, "model": r}, mesh)
        ys, c = serve(shard, True)
        assert c["dense"].k.shape[2] == 1 and shard.sparse_sharded
        for f, got in zip(c["sparse"]._fields, c["sparse"]):
            want_f = getattr(full["sparse"], f)
            if got.dim() > 1:
                want_f = want_f[:, 2 * r:2 * r + 2]
            if got.is_floating_point():       # a narrower GEMM's rounding
                torch.testing.assert_close(got, want_f, atol=1e-6, rtol=0,
                                           msg=f)
            else:                             # the picks: identical
                assert torch.equal(got, want_f), f
        for t, y in zip(total, ys):
            t += y
    for t, y in zip(total, want):
        torch.testing.assert_close(t, y, atol=1e-5, rtol=1e-5)
