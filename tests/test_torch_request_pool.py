"""The port's non-paged serving fallbacks against the JAX package's, on the
CPU with converted weights: ``RequestPool`` (batch-1 masked prefill into a
freed slot, pow2 buckets, left-truncation, EOS, the ``max_steps`` budget)
on the ``mosa-paper`` smoke model and on the contiguous caches of
``tests/test_paged_serving.py``'s ``hybrid_cfg`` (dense, window ring and
MoSA layers); ``Server.prefill_row`` with ``continued=True`` after a
restored prefix; ``generate_stepwise`` against the port's ``generate``
and JAX's ``generate_stepwise``.  Greedy decoding: identical tokens."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.launch.serve import RequestPool as JRequestPool
from repro.launch.serve import Server as JServer
from repro.nn.transformer import TransformerLM as JLM
from repro.serve.paged_kv import PagedConfig as JPagedConfig

from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import RequestPool, Server
from repro_torch.serve.paged_kv import PagedConfig

from test_paged_serving import hybrid_cfg
from test_torch_parity import (MODEL_TOL, n, numpy_params,  # noqa: F401
                               one_cpu_thread, t, to_jax, torch_config)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

MAX_LEN = 64


def _mosa_cfg():
    return get_config("mosa-paper", preset="smoke", variant="mosa")


CONFIGS = {"mosa": _mosa_cfg, "hybrid": hybrid_cfg}


@pytest.fixture(scope="module")
def models():
    """Per config: (cfg, numpy weights, {batch: (JAX server, port server)})
    over contiguous caches."""
    out = {}
    for i, (name, make) in enumerate(CONFIGS.items()):
        cfg = make()
        shapes = jax.eval_shape(JLM(cfg).init, jax.random.PRNGKey(0))
        out[name] = (cfg, numpy_params(shapes, seed=20 + i), {})
    return out


def _pair(models, name, batch=2):
    cfg, params, servers = models[name]
    if batch not in servers:
        servers[batch] = (
            JServer(cfg, batch=batch, max_len=MAX_LEN, params=to_jax(params)),
            Server(torch_config(cfg), batch=batch, max_len=MAX_LEN,
                   params=params_from_jax(cfg, params), device="cpu"))
    return servers[batch]


def _prompts(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, (L,), dtype=np.int32) for L in lengths]


def _pool_both(models, name, requests, max_steps=1000, **kw):
    jsrv, tsrv = _pair(models, name)
    jp, tp = JRequestPool(jsrv, **kw), RequestPool(tsrv, **kw)
    for prompt, max_new in requests:
        assert jp.submit(prompt, max_new) == tp.submit(prompt, max_new)
    jout, tout = jp.run(max_steps), tp.run(max_steps)
    assert sorted(jout) == sorted(tout)
    for rid in jout:
        np.testing.assert_array_equal(n(tout[rid]), np.asarray(jout[rid]),
                                      err_msg=f"request {rid}")
    return tout


@pytest.mark.parametrize("name", list(CONFIGS))
def test_request_pool_matches_jax(models, name):
    """More requests than slots (refills between chunks), pow2 buckets of
    5 -> 8, 13 -> 16, 33 -> 64 and a 70-token prompt left-truncated to
    max_len; ``max_new`` clamped against the real prompt length."""
    cfg = models[name][0]
    prompts = _prompts(1, (5, 13, 33, 70, 9), cfg.vocab)
    reqs = [(p, m) for p, m in zip(prompts, (6, 3, 9, 20, 4))]
    out = _pool_both(models, name, reqs, chunk=4)
    assert {k: len(v) for k, v in out.items()} == {0: 6, 1: 3, 2: 9, 3: 1,
                                                   4: 4}


def test_request_pool_eos_and_max_steps_match_jax(models):
    """EOS ends a request (the eos token is its last); the global
    ``max_steps`` budget returns partial results and leaves the rest of
    the queue unserved, as in JAX."""
    cfg = models["mosa"][0]
    prompts = _prompts(2, (7, 12, 20), cfg.vocab)
    _, tsrv = _pair(models, "mosa")
    probe = RequestPool(tsrv)
    probe.submit(prompts[0], 8)
    eos = int(probe.run()[0][2])
    out = _pool_both(models, "mosa", [(p, 8) for p in prompts], eos=eos)
    tk = n(out[0])
    assert tk[-1] == eos and (tk[:-1] != eos).all() and len(tk) == 3
    out = _pool_both(models, "mosa", [(p, 12) for p in prompts], chunk=3,
                     max_steps=5)
    assert sorted(out) == [0, 1] and all(len(v) < 12 for v in out.values())


def test_request_pool_right_pad_bucket_equals_unpadded_generate(models):
    """A 5-token prompt prefilled in its 8-slot bucket (3 right pads)
    gives the tokens of an unpadded batch-1 ``generate``: pads stay out of
    attention, selection and cache lengths (``k_fixed`` pins the MoSA
    width, which would otherwise follow the padded length)."""
    cfg = _mosa_cfg()
    cfg = dataclasses.replace(cfg, mosa=dataclasses.replace(cfg.mosa,
                                                            k_fixed=8))
    params = models["mosa"][1]
    srv = Server(torch_config(cfg), batch=1, max_len=32,
                 params=params_from_jax(cfg, params), device="cpu")
    (prompt,) = _prompts(3, (5,), cfg.vocab)
    want, _ = srv.generate(t(prompt).long()[None], 6)
    pool = RequestPool(srv)
    rid = pool.submit(prompt, max_new=6)
    got = pool.run()[rid]
    assert torch.equal(got.long(), want[0])
    jsrv = JServer(cfg, batch=1, max_len=32, params=to_jax(params))
    jpool = JRequestPool(jsrv)
    jpool.submit(prompt, max_new=6)
    np.testing.assert_array_equal(n(got), np.asarray(jpool.run()[0]))


def test_request_pool_refuses_a_paged_server(models):
    cfg, params, _ = models["mosa"]
    srv = Server(torch_config(cfg), batch=2, max_len=MAX_LEN,
                 params=params_from_jax(cfg, params),
                 paged=PagedConfig(block_size=8), device="cpu")
    with pytest.raises(ValueError, match="Scheduler"):
        RequestPool(srv)


# ------------------------------------------------------------ prefill_row
def test_prefill_row_continued_after_restored_prefix_matches_jax(models):
    """Row 1 prefills a 17-token prefix; its snapshot is restored into row
    0, which then prefills a 6-token suffix with ``continued=True`` (the
    MoSA union selection of ``prefill_past``, the paged dense and window
    caches past-aware through their lengths).  Logits, the row's caches
    (MoSA selection, ring, lengths of prefix + suffix) and the greedy next
    token equal JAX's."""
    cfg, params, _ = models["hybrid"]
    paged = dict(block_size=8)
    jsrv = JServer(cfg, batch=2, max_len=MAX_LEN, params=to_jax(params),
                   paged=JPagedConfig(**paged))
    tsrv = Server(torch_config(cfg), batch=2, max_len=MAX_LEN,
                  params=params_from_jax(cfg, params),
                  paged=PagedConfig(**paged), device="cpu")
    prefix, suffix = _prompts(4, (17, 6), cfg.vocab)
    jc = jsrv.new_cache()
    _, jc = jsrv.prefill_row(jsrv.params, jnp.asarray(prefix)[None], jc,
                             jnp.int32(1), None, None, False)
    jc = jsrv.restore_row(jc, jsrv.snapshot_row(jc, jnp.int32(1)),
                          jnp.int32(0))
    jl, jc = jsrv.prefill_row(jsrv.params, jnp.asarray(suffix)[None], jc,
                              jnp.int32(0), None, None, True)
    tc = tsrv.new_cache()
    _, tc = tsrv.prefill_row(t(prefix).long()[None], tc, 1)
    tc = tsrv.restore_row(tc, tsrv.snapshot_row(tc, 1), 0)
    tl, tc = tsrv.prefill_row(t(suffix).long()[None], tc, 0,
                              continued=True)
    np.testing.assert_allclose(n(tl), np.asarray(jl), **MODEL_TOL)
    with torch.inference_mode():
        trow = tsrv.snapshot_row(tc, 0)
    jrow = jax.device_get(jsrv.snapshot_row(jc, jnp.int32(0)))
    jlayers = ([jrow["scan"][f"pos{j}"] for j in range(3)]
               if "scan" in jrow else
               [jrow["tail"][f"layer{i}"] for i in range(3)])
    for i, (tr, jr) in enumerate(zip(trow, jlayers)):
        if "sparse" in tr:                     # the MoSA layer
            tr, jr = tr["sparse"], jr["sparse"]
            np.testing.assert_array_equal(n(tr.idx), np.asarray(jr.idx),
                                          err_msg=f"layer {i}")
            np.testing.assert_allclose(n(tr.k), np.asarray(jr.k),
                                       **MODEL_TOL)
        elif "k" in tr:                        # the window ring
            np.testing.assert_array_equal(n(tr["positions"]),
                                          np.asarray(jr["positions"]))
            np.testing.assert_allclose(n(tr["k"]), np.asarray(jr["k"]),
                                       **MODEL_TOL)
        assert int(tr["length"] if isinstance(tr, dict) else tr.length) \
            == int(np.asarray(jr["length"] if isinstance(jr, dict)
                              else jr.length).reshape(-1)[0]) == 23
    tok = tl[:, -1].argmax(-1)
    np.testing.assert_array_equal(n(tok), np.asarray(jl[:, -1].argmax(-1)))


# ------------------------------------------------------ generate_stepwise
@pytest.mark.parametrize("paged", [False, True])
def test_generate_stepwise_matches_generate_and_jax(models, paged):
    cfg, params, _ = models["hybrid"]
    kw = dict(batch=2, max_len=MAX_LEN)
    jsrv = JServer(cfg, params=to_jax(params),
                   paged=JPagedConfig(block_size=8) if paged else None, **kw)
    tsrv = Server(torch_config(cfg), params=params_from_jax(cfg, params),
                  paged=PagedConfig(block_size=8) if paged else None,
                  device="cpu", **kw)
    prompts = np.stack(_prompts(6, (11, 11), cfg.vocab))
    got, _ = tsrv.generate_stepwise(t(prompts).long(), 9)
    fused, _ = tsrv.generate(t(prompts).long(), 9)
    want, _ = jsrv.generate_stepwise(jnp.asarray(prompts), 9)
    assert got.shape == (2, 9)
    assert torch.equal(got, fused)
    np.testing.assert_array_equal(n(got), np.asarray(want))
