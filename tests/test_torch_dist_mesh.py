"""The port on a mesh, with gloo ranks spawned by ``torch.multiprocessing``
(the rank programs are ``_torch_mesh_workers``; a ``FileStore`` under
``tmp_path`` does the rendezvous, so parallel test workers never race for
a port), held against the JAX package and against the sequential
computation in this process:

  1. one AdamW step of the ``mosa-paper`` smoke model on a (2, 2) mesh
     under ``tp`` and under ``fsdp_tp`` against JAX's single-device step
     from the same converted weights (JAX's ``test_distributed.py`` step
     test with the port's model): the loss and every parameter within 1e-5;
  2. MoSA heads over ``model`` = 4 (on a (data 2, model 4) mesh) against
     JAX's layer, as JAX's head-parallel test; the hybrid over ``model`` =
     8, where a rank's slice of the dense heads is half a head, plain and
     gated (block choice beside window heads); GQA attention at ``model``
     = 8 with replicated kv heads and biases; the hybrid's serving
     (``prefill`` and ``decode_step``) at ``model`` = 8 with 276 MoSA
     heads, against JAX's layer;
  3. the GPipe pipeline over 4 stages against sequential application, its
     gradients against the sequential ones, and JAX's validation errors;
  4. ``compressed_all_reduce`` over ``pod`` of a (pod 2, data 4) mesh:
     ``none`` exact, ``topk`` kept + reduced residual = exact, ``int8`` =
     JAX's arithmetic, also after one error-feedback step;
     ``hints.constrain`` redistributes a DTensor to the resolved placement;
  5. the ``Trainer`` on a (2, 2) mesh under ``fsdp_tp``: 2 steps, a
     checkpoint and 1 resumed step equal 3 uninterrupted steps bit for
     bit; its first checkpoint equals the single-process Trainer's (the
     AdamW moments within 1e-6, the parameters within 1e-5, as in 1.) and
     JAX's ``checkpoint.restore`` reads it; every rank's
     heartbeat; a SIGTERM seen by one rank stops every rank after the same
     step;
  6. in this process, on a one-rank gloo mesh, the Trainer under each rule
     set equals the plain Trainer bit for bit.

Two spawns (4 and 8 ranks), one thread each; ~60 s in one process."""

from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_mesh_workers as workers
from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import AttentionConfig as JAttentionConfig
from repro.configs.base import MoSAConfig as JMoSAConfig
from repro.configs.base import get_config as jget_config
from repro.core.attention import MultiHeadAttention as JMHA
from repro.core.hybrid import HybridAttention as JHybrid
from repro.dist import fault_tolerance as jft
from repro.nn.module import init_shapes
from repro.nn.transformer import TransformerLM as JLM
from repro.optim import grad_compression as jgc
from repro.optim import optimizer as jopt
from repro.optim import schedules as jsched
from repro.train.step import make_train_step as jmake_train_step

from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.convert import params_from_jax
from repro_torch.train.loop import Trainer

from test_torch_parity import numpy_params, one_cpu_thread  # noqa: F401

SPAWN_TIMEOUT_S = 300


def spawn(fn, world, tmp):
    """Run ``fn(rank, world, tmp)`` on ``world`` spawned ranks; fail on a
    rank's error or after ``SPAWN_TIMEOUT_S``."""
    ctx = mp.start_processes(fn, args=(world, str(tmp)), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{fn.__name__} on {world} ranks timed out")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


# ------------------------------------------------------------ the trainer
LR, CLIP, WARMUP = 2.5e-4, 0.25, 1


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The 4-rank run: inputs written, ranks spawned, and the JAX step."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    jcfg = jget_config("mosa-paper", preset="smoke", variant="mosa")
    params = numpy_params(jax.eval_shape(JLM(jcfg).init,
                                         jax.random.PRNGKey(0)), 7)
    rng = np.random.default_rng(8)
    tok = rng.integers(2, jcfg.vocab, (8, 65)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    torch.save(params_from_jax(jcfg, params), tmp / "weights.pt")
    torch.save({k: torch.from_numpy(v).long() for k, v in batch.items()},
               tmp / "batch.pt")
    spawn(workers.train_worker, 4, tmp)

    opt = jopt.adamw(jsched.linear_warmup(LR, WARMUP), clip_norm=CLIP)
    step = jax.jit(jmake_train_step(JLM(jcfg), opt, microbatches=2,
                                    health=True))
    jp = jax.tree.map(jnp.asarray, params)
    jp, jo, _, jm = step(jp, opt.init(jp), jnp.zeros((), jnp.int32),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    ref = {"params": params_from_jax(jcfg, jax.tree.map(np.asarray, jp)),
           "mu": params_from_jax(jcfg, jax.tree.map(np.asarray, jo["mu"])),
           "metrics": {k: float(v) for k, v in jm.items()}}
    return tmp, jcfg, ref


@pytest.mark.parametrize("rule_set", ["tp", "fsdp_tp"])
def test_sharded_step_matches_jax_single_device(trained, rule_set):
    tmp, _, ref = trained
    got = torch.load(tmp / f"step_{rule_set}.pt")
    assert got["step"] == 1
    for k in ("loss", "ce", "grad_norm", "tokens", "sel_entropy",
              "drop_rate", "head_util"):
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                   atol=1e-5, rtol=1e-6, err_msg=k)
    assert set(got["params"]) == set(ref["params"])
    for k, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), ref["params"][k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(got["mu"][k].numpy(),
                                   ref["mu"][k].numpy(), atol=1e-6,
                                   rtol=1e-4, err_msg=k)


def test_fsdp_tp_shards_more_than_tp(trained):
    tmp = trained[0]
    n = {rs: torch.load(tmp / f"step_{rs}.pt")["n_local"]
         for rs in ("tp", "fsdp_tp")}
    total = sum(p.numel() for p in torch.load(
        tmp / "step_tp.pt")["params"].values())
    assert n["tp"] < total and n["fsdp_tp"] < n["tp"]


def test_resume_equals_uninterrupted_bitwise(trained):
    tmp = trained[0]
    res = torch.load(tmp / "resume.pt")
    (full_a, hist_a), (full_b, hist_b) = res["A"], res["B"]
    assert [h["step"] for h in hist_a] == [0, 1, 2]
    assert [h["step"] for h in hist_b] == [2]
    assert hist_b[0]["loss"] == hist_a[2]["loss"]
    assert full_a.keys() == full_b.keys()
    for k in full_a:
        assert torch.equal(full_a[k], full_b[k]), k


def test_checkpoint_equals_single_process_and_jax_reads_it(trained,
                                                           tmp_path):
    tmp, jcfg, _ = trained
    single = Trainer(workers.train_cfg(ckpt_dir=str(tmp_path / "S"),
                                       steps=1))
    single.run(install_signals=False)
    got, extra = tckpt.restore(str(tmp / "B"), step=2)
    assert extra["step"] == 2 and tckpt.latest_step(str(tmp / "A")) == 3
    mesh1, _ = tckpt.restore(str(tmp / "A"), step=3)
    assert mesh1.keys() == got.keys()
    # run A's first checkpoint against the single-process Trainer's
    want, _ = tckpt.restore(str(tmp_path / "S"), step=1)
    first, _ = tckpt.restore(str(tmp / "A"), step=1)
    fw, ff = _flat(want), _flat(first)
    assert fw.keys() == ff.keys()
    for k in fw:
        # the moments (the gradients) within 1e-6; the parameters within
        # the step test's 1e-5: AdamW's normalized update turns a rounding
        # difference of a near-zero gradient into one of up to ~lr
        atol = 1e-6 if k.startswith("opt.") else 1e-5
        np.testing.assert_allclose(ff[k], fw[k], atol=atol, rtol=0,
                                   err_msg=k)
    # JAX's restore reads the mesh's checkpoint into its train-state tree
    shapes = init_shapes(JLM(jcfg))
    target = {"params": shapes,
              "opt": jax.eval_shape(jopt.adamw(1e-3).init, shapes)}
    tree, jextra = jckpt.restore(str(tmp / "A"), target, step=3)
    assert jextra["step"] == 3
    fj, fm = _flat(jax.tree.map(np.asarray, tree)), _flat(mesh1)
    assert fj.keys() == fm.keys()
    for k in fj:
        np.testing.assert_array_equal(fj[k], fm[k], err_msg=k)


def test_heartbeats_of_every_rank(trained):
    tmp = trained[0]
    d = str(tmp / "A")
    assert sorted(os.listdir(os.path.join(d, "heartbeats"))) == [
        f"rank_{r}.json" for r in range(4)]
    assert jft.Heartbeat.stale_ranks(d, timeout_s=3600) == []
    assert jft.Heartbeat.stale_ranks(d, timeout_s=0) == [0, 1, 2, 3]
    beat = json.load(open(os.path.join(d, "heartbeats", "rank_3.json")))
    assert beat["rank"] == 3 and beat["step"] == 2


def test_preemption_on_one_rank_stops_every_rank(trained):
    tmp = trained[0]
    steps = [json.load(open(tmp / f"C_rank{r}.json")) for r in range(4)]
    assert steps == [[0, 1]] * 4
    assert tckpt.latest_step(str(tmp / "C")) == 2


# -------------------------------------------------------------- the layers
LAYER_CASES = {
    # JAX's head-parallel test: 8 MoSA heads, no dense heads, model 4
    "mosa4": ((2, 4), dict(n_mosa_heads=8, sparsity=4, n_dense_heads=0,
                           d_head=16)),
    # model 8: 1 MoSA head and half of a 16-wide dense head per rank
    "hybrid8": ((1, 8), dict(n_mosa_heads=8, sparsity=4, n_dense_heads=4,
                             d_head=16)),
    "gated8": ((1, 8), dict(n_mosa_heads=8, sparsity=4, n_dense_heads=4,
                            d_head=16, selection_granularity="block",
                            sel_block_size=4, local_window=16)),
    # GQA, model 8: a q head a rank, the 2 kv heads replicated (JAX's
    # fallback drops ``kv_heads``: 2 % 8), biases: the kv head of its group
    "gqa8": ((1, 8), dict(attn=dict(n_heads=8, n_kv_heads=2, d_head=16,
                                    qkv_bias=True))),
}


# the hybrid's serving at model = 8: 276 MoSA heads (replicated: 276 % 8)
# and 4 dense heads of 16 (half a head a rank; their caches replicated)
SERVE_SPEC = dict(n_mosa_heads=276, sparsity=4, n_dense_heads=4, d_head=16)
SERVE_PROMPT, SERVE_LEN = 16, 32


def _serve_inputs(tmp, refs):
    """JAX's layer ``prefill`` of a 16-token prompt and 3 ``decode_step``s,
    over a contiguous and a paged (identity tables) dense cache."""
    from repro.serve.paged_kv import PagedConfig as JPagedConfig
    jl = JHybrid(64, JMoSAConfig(**SERVE_SPEC))
    params = numpy_params(jax.eval_shape(jl.init, jax.random.PRNGKey(0)),
                          40)
    x = np.random.default_rng(41).standard_normal(
        (2, SERVE_PROMPT + 3, 64)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    prefill, decode = jax.jit(jl.prefill), jax.jit(jl.decode_step)
    for name, paged in (("dense", None), ("paged", JPagedConfig(8))):
        caches = jl.init_cache(2, SERVE_LEN, jnp.float32, paged=paged)
        y, caches = prefill(jp, jnp.asarray(x[:, :SERVE_PROMPT]), caches)
        ys = [np.asarray(y)]
        for t in range(SERVE_PROMPT, x.shape[1]):
            y, caches = decode(jp, jnp.asarray(x[:, t:t + 1]), caches)
            ys.append(np.asarray(y))
        refs[f"serve8_{name}"] = ys
    torch.save({"mesh": (1, 8), "spec": SERVE_SPEC, "prompt": SERVE_PROMPT,
                "max_len": SERVE_LEN, "x": torch.from_numpy(x),
                "state": {k: torch.from_numpy(np.asarray(v)) for k, v in
                          _flat(params).items()}}, tmp / "serve8_in.pt")


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_layers")
    refs = {}
    for i, (case, (mesh, spec)) in enumerate(LAYER_CASES.items()):
        jl = (JMHA(64, JAttentionConfig(**spec["attn"])) if "attn" in spec
              else JHybrid(64, JMoSAConfig(**spec)))
        shapes = jax.eval_shape(jl.init, jax.random.PRNGKey(0))
        rng = np.random.default_rng(20 + i)
        biases = {k: (0.1 * rng.standard_normal(shapes.pop(k).shape))
                  .astype(np.float32) for k in ("bq", "bk", "bv")
                  if k in shapes}
        params = {**numpy_params(shapes, 10 + i), **biases}
        x = rng.standard_normal((4, 64, 64)).astype(np.float32)
        dy = rng.standard_normal((4, 64, 64)).astype(np.float32)
        y, vjp = jax.vjp(lambda p, xx: jl(p, xx),
                         jax.tree.map(jnp.asarray, params), jnp.asarray(x))
        gp, _ = vjp(jnp.asarray(dy))
        torch.save({"mesh": mesh, "spec": spec,
                    "dropped": ("kv_heads",) if "attn" in spec else (),
                    "state": {k: torch.from_numpy(np.asarray(v)) for k, v in
                              _flat(params).items()},
                    "x": torch.from_numpy(x), "dy": torch.from_numpy(dy)},
                   tmp / f"{case}_in.pt")
        refs[case] = (np.asarray(y), _flat(jax.tree.map(np.asarray, gp)))
    _serve_inputs(tmp, refs)
    g = torch.Generator().manual_seed(0)
    ws = [torch.randn(16, 16, generator=g) * 0.3 for _ in range(4)]
    torch.save({"ws": ws, "x": torch.randn(8, 16, generator=g)},
               tmp / "pipe_in.pt")
    gc = np.random.default_rng(0).standard_normal((2, 256)).astype(np.float32)
    torch.save({"g": torch.from_numpy(gc)}, tmp / "compress_in.pt")
    spawn(workers.layers_worker, 8, tmp)
    return tmp, refs


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_head_parallel_layer_matches_jax(layers, case):
    tmp, refs = layers
    got = torch.load(tmp / f"{case}_out.pt")
    y, grads = refs[case]
    np.testing.assert_allclose(got["y"].numpy(), y, atol=1e-5, rtol=1e-5)
    assert got["grads"].keys() == grads.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(got["grads"][k].numpy(), g, atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    m = LAYER_CASES[case][0][1]
    if case == "gqa8":           # rank 0: q head 0, both kv heads
        assert got["q_cols"] == (0, 16) and got["kv_cols"] is None
        assert got["local_shapes"]["wq"] == (64, 16)
        assert got["local_shapes"]["wk"] == (64, 32)
        return
    assert got["sparse_sharded"]
    assert got["local_shapes"]["sparse.wq"][0] == 8 // m
    if case != "mosa4":          # rank 0's dense columns: half of head 0
        assert got["q_cols"] == (0, 8)
        assert got["local_shapes"]["dense.wq"] == (64, 8)


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_hybrid_serving_at_model8_matches_jax(layers, cache):
    """276 MoSA heads replicated and half a dense head a rank (the dense
    caches replicated, as ``cache_spec`` places 4 heads over 8): prefill
    and every decode step within 1e-5 of JAX's layer."""
    tmp, refs = layers
    got = torch.load(tmp / "serve8_out.pt")[cache]
    assert got["heads"] == (276, 4) and got["mode"] == "full"
    for y, want in zip(got["ys"], refs[f"serve8_{cache}"], strict=True):
        np.testing.assert_allclose(y.numpy(), want, atol=1e-5, rtol=1e-5)


def test_pipeline_matches_sequential(layers):
    tmp = layers[0]
    inp = torch.load(tmp / "pipe_in.pt")
    got = torch.load(tmp / "pipe_out.pt")
    ws = [w.clone().requires_grad_(True) for w in inp["ws"]]
    y = inp["x"]
    for w in ws:
        y = torch.tanh(y @ w) + y
    (y ** 2).sum().backward()
    torch.testing.assert_close(got["y"], y.detach(), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got["grad"], torch.stack([w.grad for w in ws]),
                               atol=1e-4, rtol=1e-5)
    assert "has no 'pipe' axis" in got["errors"]["mesh"]
    assert "leading dims" in got["errors"]["params"]
    assert "not divisible into 3" in got["errors"]["n_microbatches"]


def test_compressed_all_reduce_over_pod(layers):
    tmp = layers[0]
    g = torch.load(tmp / "compress_in.pt")["g"].numpy()
    got = torch.load(tmp / "compress_out.pt")
    exact = g[0] + g[1]
    np.testing.assert_array_equal(got["none"].numpy(), exact)
    topk = got["topk"]
    assert topk["kept_plus_residual_is_g"]
    np.testing.assert_allclose(
        (topk["reduced"] + topk["residual_sum"]).numpy(), exact, atol=1e-6)
    int8 = got["int8"]
    assert int8["kept_plus_residual_is_g"]
    j = [jgc.int8_compress(jnp.asarray(g[p])) for p in range(2)]
    np.testing.assert_array_equal(
        int8["reduced"].numpy(), np.asarray(j[0][0]) + np.asarray(j[1][0]))
    # error feedback: the second call compresses g + the first residual
    for name, comp in (("topk", lambda a: jgc.topk_compress(a, 0.5)),
                       ("int8", jgc.int8_compress)):
        first = [comp(jnp.asarray(g[p])) for p in range(2)]
        second = [comp(jnp.asarray(g[p]) + first[p][1]) for p in range(2)]
        np.testing.assert_array_equal(
            got[name]["reduced2"].numpy(),
            np.asarray(second[0][0]) + np.asarray(second[1][0]))
        np.testing.assert_array_equal(got[name]["residual2"].numpy(),
                                      np.asarray(second[0][1]))


def test_hints_constrain_redistributes_dtensors(layers):
    got = torch.load(layers[0] / "hints_out.pt")
    assert got["y"] == [("shard", 0), ("shard", 1)]
    assert got["z"] == [("replicate",), ("shard", 0)]
    assert got["local"] == (4, 2)
    assert got["same"] and got["plain"]


@pytest.mark.parametrize("rule_set", ["tp", "fsdp_tp"])
def test_one_rank_mesh_trainer_equals_plain_bitwise(rule_set, tmp_path,
                                                    one_cpu_thread):
    """On a one-rank gloo mesh (1, 1) every collective is a copy and every
    sharded computation is the plain one (the vocabulary-parallel
    logsumexp has ``torch.logsumexp``'s backward): the losses, grad norms
    and weights after 2 steps equal the plain Trainer's bit for bit (one
    thread: the BLAS's thread count changes its sums)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    kw = dict(steps=2, global_batch=4, microbatch=2, mosa_impl="kernel",
              warmup=400)
    plain = Trainer(workers.train_cfg(**kw))
    p0, _, h0 = plain.run(install_signals=False)
    mesh_lib.init_process_group("cpu", init_method=f"file://{tmp_path}/pg",
                                world_size=1, rank=0)
    try:
        tr = Trainer(workers.train_cfg(mesh_shape=(1, 1), rule_set=rule_set,
                                       **kw))
        p1, _, h1 = tr.run(install_signals=False)
        full, _ = tr.full_state(p1)
    finally:
        dist.destroy_process_group()
    assert [(h["loss"], h["grad_norm"]) for h in h1] == \
        [(h["loss"], h["grad_norm"]) for h in h0]
    assert full.keys() == p0.keys()
    for k, p in p0.items():
        assert torch.equal(full[k], p.detach()), k
