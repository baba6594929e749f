"""Serving on a device mesh: 4 gloo ranks spawned by
``torch.multiprocessing`` (the rank program is
``_torch_mesh_workers.serve_worker``; a ``FileStore`` under ``tmp_path``
does the rendezvous) against the JAX package's single-device serving of
the same converted weights.

The ``mosa-paper`` smoke preset at T = 1024: sparsity 32 gives 276 MoSA
heads (69 a rank over ``model`` = 4), sparsity 8 gives 69 (replicated
over 4).  Its 4 dense heads' weights are replicated (``param_specs`` keeps
the ``heads`` rule only where the model's 9 attention heads divide
``model``), while their caches hold one head a rank (``cache_spec``), so
the dense side serves its cache's head, a share summed over ``model``.

  1. (1, 4) under ``tp``, paged with identity pools, both variants and
     block choice: ``generate``'s greedy tokens equal JAX's, the prefill's
     and every decode step's logits within 1e-5 relative;
  2. the step-indexed Scheduler (a shared prefix, one forced preemption)
     gives JAX's Scheduler's tokens and stats, both variants;
  3. the same requests in timed mode (20 ms apart), whose arrivals rank 0
     alone reads: every rank ends with the same tokens and stats;
  4. (2, 2) under ``fsdp_tp``, the rows over dp: JAX's tokens; the
     Scheduler and the RequestPool refuse that mesh (ROADMAP A.7c);
  5. (1, 4) batch 1 with ``seq_sharded`` dense caches (16 of 64 positions
     a rank): JAX's greedy tokens, logits within 1e-5 relative.

One spawn of 4 ranks, one thread each."""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_mesh_workers as workers
from repro.configs.base import get_config as jget_config
from repro.launch.serve import Server as JServer
from repro.nn.transformer import TransformerLM as JLM
from repro.serve.paged_kv import PagedConfig as JPagedConfig
from repro.serve.scheduler import Scheduler as JScheduler

from repro_torch.convert import params_from_jax

from test_torch_dist_mesh import SPAWN_TIMEOUT_S
from test_torch_parity import numpy_params, to_jax

B, P, G, MAX_LEN = 2, 20, 6, 64
CONFIGS = {
    "sp32": dict(preset="smoke", variant="mosa", sparsity=32, seq_len=1024),
    "sp8": dict(preset="smoke", variant="mosa", sparsity=8, seq_len=1024),
    "block": dict(preset="smoke", variant="mosa", sparsity=32, seq_len=1024,
                  selection_granularity="block", sel_block_size=8),
}
# The weights' seeds.  sp8's with 31 puts two router scores 6e-8 apart at
# the third decode step, where the summation order (JAX's, the port's on
# one device alike) decides which enters a head's top-k; 33 has no tie.
SEEDS = {"sp32": 30, "sp8": 33, "block": 32}
SCHED_PAGED = (8, 5)            # block size, blocks: two rows cannot grow
REL = 1e-5


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_logits(srv, prompts):
    """JAX's prefill logits at the last token and G - 1 greedy decode
    steps' logits."""
    with srv.mesh:
        logits, caches = srv.prefill(srv.params, jnp.asarray(prompts),
                                     srv.new_cache())
        tok0 = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        decode = jax.jit(srv.model.decode_many,
                         static_argnames=("n", "return_logits"))
        _, dec, _ = decode(srv.params, tok0, caches, None, n=G - 1,
                           return_logits=True)
    return np.asarray(logits[:, -1]), np.asarray(dec)


def _sched_requests(vocab):
    rng = np.random.default_rng(5)
    shared = rng.integers(2, vocab, (17,), dtype=np.int32)
    return [(np.concatenate([shared, rng.integers(2, vocab, (3,),
                                                  dtype=np.int32)]), 12)
            for _ in range(3)]


def _spawned(fn, world, tmp):
    """Start ``fn(rank, world, tmp)`` on ``world`` spawned ranks; returns
    a call that waits for them (failing on a rank's error or after
    ``SPAWN_TIMEOUT_S``), so that the caller works meanwhile."""
    ctx = mp.start_processes(fn, args=(world, str(tmp)), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S

    def wait():
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"{fn.__name__} on {world} ranks timed out")
    return wait


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The converted weights and inputs written, the 4 ranks spawned, and
    JAX's references computed while they run."""
    tmp = tmp_path_factory.mktemp("mesh_serve")
    prompts = np.random.default_rng(1).integers(2, 512, (B, P),
                                                dtype=np.int32)
    reqs = _sched_requests(512)
    cfgs, params = {}, {}
    for name, kw in CONFIGS.items():
        cfgs[name] = jget_config("mosa-paper", **kw)
        params[name] = numpy_params(jax.eval_shape(
            JLM(cfgs[name]).init, jax.random.PRNGKey(0)), SEEDS[name])
        torch.save(params_from_jax(cfgs[name], params[name]),
                   tmp / f"{name}.pt")
    torch.save({"configs": CONFIGS, "prompts": torch.from_numpy(
        prompts).long(), "gen": G, "max_len": MAX_LEN,
        "sched_paged": SCHED_PAGED,
        "sched_reqs": [(torch.from_numpy(p), m) for p, m in reqs]},
        tmp / "serve_in.pt")
    wait = _spawned(workers.serve_worker, 4, tmp)
    refs = {}
    for name, cfg in cfgs.items():
        jp = to_jax(params[name])
        srv = JServer(cfg, batch=B, max_len=MAX_LEN, params=jp,
                      paged=JPagedConfig(block_size=16))
        toks, _ = srv.generate(jnp.asarray(prompts), G)
        ref = {"toks": np.asarray(toks)}
        ref["prefill_logits"], ref["decode_logits"] = _jax_logits(srv,
                                                                  prompts)
        if name != "block":
            bs, nb = SCHED_PAGED
            ssrv = JServer(cfg, batch=2, max_len=MAX_LEN, params=jp,
                           paged=JPagedConfig(block_size=bs, num_blocks=nb))
            sched = JScheduler(ssrv, chunk=4)
            for p, m in reqs:
                sched.submit(p, m)
            out = sched.run()
            ref["sched"] = ({k: np.asarray(v) for k, v in out.items()},
                            dict(sched.stats))
        if name == "sp32":
            one = JServer(cfg, batch=1, max_len=MAX_LEN, params=jp)
            toks1, _ = one.generate(jnp.asarray(prompts[:1]), G)
            ref["seq"] = {"toks": np.asarray(toks1)}
            ref["seq"]["prefill_logits"], ref["seq"]["decode_logits"] = \
                _jax_logits(one, prompts[:1])
        refs[name] = ref
    wait()
    return torch.load(tmp / "serve_out.pt"), refs


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_generate_matches_jax_single_device(served, name):
    got, refs = served
    g, r = got[name], refs[name]
    np.testing.assert_array_equal(g["toks"].numpy(), r["toks"])
    assert rel_err(g["prefill_logits"], r["prefill_logits"]) <= REL
    assert rel_err(g["decode_logits"], r["decode_logits"]) <= REL
    # rank 0's caches: its share of the heads, whole rows and pools
    layer = g["caches"][0]
    mosa_heads = 276 if name != "sp8" else 69
    held = mosa_heads // 4 if mosa_heads % 4 == 0 else mosa_heads
    assert layer["sparse"]["k"][:2] == (B, held)
    assert layer["dense"]["k"] == (B * MAX_LEN // 16, 16, 1, 64)
    assert layer["dense"]["block_table"] == (B, MAX_LEN // 16)


@pytest.mark.parametrize("name", ["sp32", "sp8"])
def test_tp_scheduler_matches_jax_scheduler(served, name):
    got, refs = served
    (out, stats), (jout, jstats) = got[name]["sched"], refs[name]["sched"]
    assert sorted(out) == sorted(jout)
    for rid in jout:
        np.testing.assert_array_equal(out[rid].numpy(), jout[rid],
                                      err_msg=f"request {rid}")
    assert stats == jstats
    assert stats["prefix_hits"] >= 1 and stats["preemptions"] >= 1
    assert {k: len(v) for k, v in out.items()} == {0: 12, 1: 12, 2: 12}


@pytest.mark.parametrize("name", ["sp32", "sp8"])
def test_timed_scheduler_same_on_every_rank(served, name):
    ranks = served[0][name]["timed"]
    assert len(ranks) == 4
    toks, stats = ranks[0]
    assert {k: len(t) for k, t in toks.items()} == {0: 12, 1: 12, 2: 12}
    assert all(r == ranks[0] for r in ranks[1:])


def test_fsdp_tp_rows_over_dp_match_jax(served):
    got, refs = served
    g = got["fsdp_tp"]
    np.testing.assert_array_equal(g["toks"].numpy(), refs["sp32"]["toks"])
    assert g["rows"] == (0, 1)                      # rank 0: row 0 of 2
    layer = g["caches"][0]
    # one row; 138 MoSA heads and 2 dense heads over model = 2; the
    # identity pool holds this rank's row alone
    assert layer["sparse"]["k"][:2] == (1, 138)
    assert layer["dense"]["k"] == (MAX_LEN // 16, 16, 2, 64)
    for what in ("Scheduler", "RequestPool"):
        assert "A.7c" in g["errors"][what]


def test_seq_sharded_batch1_matches_jax(served):
    got, refs = served
    g, r = got["seq"], refs["sp32"]["seq"]
    np.testing.assert_array_equal(g["toks"].numpy(), r["toks"])
    assert rel_err(g["prefill_logits"], r["prefill_logits"]) <= REL
    assert rel_err(g["decode_logits"], r["decode_logits"]) <= REL
    assert g["seq_flags"] == [True, True]
    layer = g["caches"][0]
    # every dense head at a quarter of the positions; MoSA by heads
    assert layer["dense"]["k"] == (1, MAX_LEN // 4, 4, 64)
    assert layer["sparse"]["k"][:2] == (1, 69)
