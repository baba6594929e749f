"""The paper's sparse baselines in the port against the JAX package, on
the CPU, fp32, with converted weights (numpy draws from a seed fed to
both):

  * ``fixed_indices`` equal;
  * ``FixedSparseAttention`` and ``RoutingAttention``: outputs and the
    gradients of x and of every weight within rtol 1e-5 / atol 1e-6 (the
    routing centroids: JAX's gradient is zeros, torch's is None);
  * ``_cluster_select`` indices identical, a duplicated-token tie included
    (lower index first, as ``lax.top_k``); ``ema_centroids`` equal;
  * ``HybridAttention(variant=...)`` and the ``mosa-paper`` smoke
    ``fixed8`` / ``routing8`` models (``TransformerLM.loss`` and every
    gradient within 1e-5 relative);
  * the serving entry points raise for the baselines; the weights
    round-trip through ``convert`` and a port checkpoint restores in the
    JAX package, centroids included; one AdamW step
    leaves the centroids bit for bit where they were, in both packages;
  * ``tests/test_system.py::test_sparse_baselines_run_at_matched_flops``
    ported: both variants train one step with finite loss and grads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import MoSAConfig as JMoSAConfig
from repro.configs.base import get_config as jget_config
from repro.core import baselines as jb
from repro.core.hybrid import HybridAttention as JHybrid
from repro.nn.transformer import TransformerLM as JLM
from repro.optim import optimizer as jopt
from repro.optim import schedules as jsched
from repro.train.step import make_train_step as jmake_train_step

from repro_torch import convert
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs.base import MoSAConfig
from repro_torch.configs.mosa_paper import paper_config
from repro_torch.core import baselines as tb
from repro_torch.core.hybrid import HybridAttention
from repro_torch.nn.transformer import TransformerLM
from repro_torch.optim import optimizer as topt
from repro_torch.optim import schedules as tsched
from repro_torch.train.step import make_train_step

from test_torch_modules import state_dict
from test_torch_parity import (n, numpy_params, one_cpu_thread,  # noqa: F401
                               t, to_jax, torch_config)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
D_MODEL, B, T = 32, 2, 40


def close(got, want, err_msg=""):
    """``got`` within rtol 1e-5 / atol 1e-6 of ``want``, the atol taken
    relative to the tensor's largest entry: a gradient entry sums tens of
    products of O(1) terms, and fp32 sums in another order than XLA's
    differ by a few ulps of those terms, not of the (possibly cancelled)
    result."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(n(got), want, rtol=LAYER_TOL["rtol"],
                               atol=LAYER_TOL["atol"] * scale,
                               err_msg=err_msg)


@pytest.mark.parametrize("T_, k", [(64, 8), (40, 5), (7, 2), (10, 4),
                                   (3, 2)])
def test_fixed_indices_match_jax(T_, k):
    want = np.asarray(jb.fixed_indices(T_, k, (2, 3)))
    got = tb.fixed_indices(T_, k, (2, 3))
    assert got.shape == want.shape
    np.testing.assert_array_equal(n(got), want)


def _layer_pair(kind, seed=0):
    if kind == "fixed":
        jm = jb.FixedSparseAttention(D_MODEL, 3, 8, sparsity=4)
        tm = tb.FixedSparseAttention(D_MODEL, 3, 8, sparsity=4)
    else:
        jm = jb.RoutingAttention(D_MODEL, 2, 8, sparsity=4)
        tm = tb.RoutingAttention(D_MODEL, 2, 8, sparsity=4)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed)
    tm.load_state_dict(state_dict(params))
    return jm, to_jax(params), tm


def _layer_inputs(seed=1, dup=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D_MODEL)).astype(np.float32)
    if dup:                              # repeated tokens tie in every sim
        x[:, 20:30] = x[:, 5:15]
        x[1, 33] = x[1, 2]
    g = rng.standard_normal((B, T, D_MODEL)).astype(np.float32)
    return x, g


@pytest.mark.parametrize("kind", ["fixed", "routing"])
@pytest.mark.parametrize("dup", [False, True])
def test_layer_forward_and_grads_match_jax(kind, dup):
    """Output and the vjp of a seeded cotangent: x and every weight."""
    jm, jp, tm = _layer_pair(kind)
    x, g = _layer_inputs(dup=dup)
    want, vjp = jax.vjp(lambda p, xx: jm(p, xx), jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    xt = t(x).requires_grad_(True)
    got = tm(xt)
    close(got, want)
    names = [k for k, _ in tm.named_parameters()]
    grads = torch.autograd.grad(got, [xt] + [p for _, p in
                                              tm.named_parameters()],
                                t(g), allow_unused=True)
    close(grads[0], jgx)
    for name, gr in zip(names, grads[1:]):
        if name == "centroids":
            assert gr is None
            assert not np.asarray(jgp[name]).any()
            continue
        close(gr, jgp[name], err_msg=name)


@pytest.mark.parametrize("dup", [False, True])
def test_cluster_select_identical(dup):
    """The clusters' members, ties included: duplicated tokens give equal
    rows of ``sim``; both packages take the lower index first."""
    jm, jp, tm = _layer_pair("routing", seed=3)
    x, _ = _layer_inputs(seed=4, dup=dup)
    qk = n(tm._normalized_qk(t(x)).float())
    k = T // 4
    want = np.asarray(jm._cluster_select(jnp.asarray(qk), jp["centroids"],
                                         k))
    got = tm._cluster_select(t(qk), k)
    np.testing.assert_array_equal(n(got), want)
    if dup:
        # the tie is real: some cluster holds a copy and not its original
        sim = np.einsum("bntd,ncd->bnct", qk, n(tm.centroids))
        assert (sim[..., 20:30] == sim[..., 5:15]).all()


def test_ema_centroids_match_jax():
    jm, jp, tm = _layer_pair("routing", seed=5)
    x, _ = _layer_inputs(seed=6)
    y, new = tm(t(x), update_state=True)
    jy, jnew = jm(jp, jnp.asarray(x), update_state=True)
    close(y, jy)
    close(new, jnew)
    # the qk the EMA reads is the layer's own normalized projection
    qk = tm._normalized_qk(t(x))
    idx = tm._cluster_select(qk.float(), T // 4)
    want = jm.ema_centroids(jp, jnp.asarray(n(qk)), jnp.asarray(n(idx)))
    close(tm.ema_centroids(qk, idx), want)


def _hybrid_pair(variant, n_dense=2):
    jcfg = JMoSAConfig(n_mosa_heads=8, sparsity=4, n_dense_heads=n_dense,
                       d_head=8)
    jm = JHybrid(D_MODEL, jcfg, variant=variant)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 7)
    tm = HybridAttention(D_MODEL, MoSAConfig(**dataclasses.asdict(jcfg)),
                         variant=variant)
    tm.load_state_dict(state_dict(params))
    return jm, to_jax(params), tm


@pytest.mark.parametrize("variant", ["fixed", "routing"])
@pytest.mark.parametrize("n_dense", [0, 2])
def test_hybrid_layer_matches_jax(variant, n_dense):
    jm, jp, tm = _hybrid_pair(variant, n_dense)
    if variant == "routing":
        assert tm.sparse.n_heads == 2 == jm._sparse().n_heads
    assert not tm._gated() and tm.router_health(torch.zeros(1, 4, D_MODEL)) \
        is None
    x, g = _layer_inputs(seed=8)
    want, vjp = jax.vjp(lambda p: jm(p, jnp.asarray(x)), jp)
    (jg,) = vjp(jnp.asarray(g))
    got = tm(t(x))
    close(got, want)
    names = [k for k, _ in tm.named_parameters()]
    grads = torch.autograd.grad(got, list(tm.parameters()), t(g),
                                allow_unused=True)
    jflat = state_dict(jax.tree.map(np.asarray, jg))
    for name, gr in zip(names, grads):
        want_g = n(jflat[name])
        if gr is None:
            assert name.endswith("centroids") and not want_g.any()
            continue
        close(gr, want_g, err_msg=name)


def _model_pair(variant):
    jcfg = jget_config("mosa-paper", preset="smoke", variant=variant)
    jmodel = JLM(jcfg)
    params = numpy_params(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)),
                          11)
    model = TransformerLM(torch_config(jcfg))
    model.load_state_dict(convert.params_from_jax(jcfg, params))
    tok = np.random.default_rng(12).integers(2, jcfg.vocab, (2, 65))
    batch = {"tokens": tok[:, :-1].astype(np.int32),
             "labels": tok[:, 1:].astype(np.int32)}
    return jcfg, jmodel, to_jax(params), model, batch


@pytest.mark.parametrize("variant", ["fixed", "routing"])
def test_smoke_model_loss_and_grads_match_jax(variant):
    """``mosa-paper`` smoke fixed8 / routing8 (2 layers): the loss within
    1e-5 relative and every gradient within 1e-5 of its tensor's max |g|."""
    jcfg, jmodel, jp, model, batch = _model_pair(variant)
    (jloss, _), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _ = model.loss({k: t(v).long() for k, v in batch.items()})
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = convert.params_from_jax(jcfg, jax.tree.map(np.asarray, jg))
    for name, gr in zip(names, grads):
        w = want[name].numpy()
        if gr is None:
            assert name.endswith("centroids") and not w.any(), name
            continue
        err = np.abs(n(gr) - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("variant", ["fixed", "routing"])
def test_serving_entry_points_raise(variant):
    _, _, tm = _hybrid_pair(variant)
    x = torch.zeros(1, 4, D_MODEL)
    for call in (lambda: tm.init_cache(1, 16),
                 lambda: tm.prefill(x, {}),
                 lambda: tm.prefill_packed(x, {}, {}),
                 lambda: tm.decode_step(x[:, :1], {})):
        with pytest.raises(NotImplementedError, match="train-only"):
            call()


@pytest.mark.parametrize("variant", ["fixed", "routing"])
def test_convert_round_trip_with_centroids(variant, tmp_path):
    """The weights round-trip through ``convert``; a port checkpoint of
    the train state restores in the JAX package's tree, centroids
    included."""
    jcfg, jmodel, jp, model, _ = _model_pair(variant)
    tree = convert.params_to_jax(jcfg, model.state_dict())
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    assert (jax.tree_util.tree_structure(jax.tree.map(lambda a: 0, tree))
            == jax.tree_util.tree_structure(jax.tree.map(lambda a: 0,
                                                         shapes)))
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_flatten_with_path(jp)[0]):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    back = convert.params_from_jax(jcfg, tree)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    if variant == "routing":
        assert any(k.endswith("sparse.centroids") for k in back)
    params = dict(model.named_parameters())
    opt = _opt(topt, tsched).init(params)
    tckpt.save(str(tmp_path), 1, convert.train_state_to_jax(jcfg, params,
                                                            opt),
               extra_meta={"step": 1})
    target = {"params": jp, "opt": _opt(jopt, jsched).init(jp)}
    restored, _ = jckpt.restore(str(tmp_path), target)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(restored["params"])[0],
            jax.tree_util.tree_flatten_with_path(jp)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


def _opt(o, s):
    return o.adamw(s.linear_warmup(1e-3, 1), clip_norm=0.25)


def test_adamw_step_leaves_centroids_unchanged():
    """The centroids get a zero gradient in both packages: one AdamW step
    (clip included) leaves them bit for bit where they were, while every
    other weight moves; the step's loss and (clipped-over) grad norm are
    JAX's.  (Weight-by-weight, the first AdamW update is ~lr * sign(g):
    the grads' parity is held in ``test_smoke_model_loss_and_grads``.)"""
    jcfg, jmodel, jp, model, batch = _model_pair("routing")
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = dict(model.named_parameters())
    params, _, _, m = make_train_step(model, _opt(topt, tsched))(
        params, _opt(topt, tsched).init(params), 0,
        {k: t(v).long() for k, v in batch.items()})
    jstep = jax.jit(jmake_train_step(jmodel, _opt(jopt, jsched)))
    jp2, _, _, jm = jstep(jp, _opt(jopt, jsched).init(jp),
                          jnp.zeros((), jnp.int32),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    want = convert.params_from_jax(jcfg, jax.tree.map(np.asarray, jp2))
    cents = [k for k in params if k.endswith("centroids")]
    assert cents
    for k, v in params.items():
        if k in cents:
            assert torch.equal(v.detach(), before[k]), k
            assert torch.equal(want[k], before[k]), k
        else:
            assert not torch.equal(v.detach(), before[k]), k
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)


@pytest.mark.parametrize("variant", ["fixed", "routing"])
def test_sparse_baselines_run_at_matched_flops(variant):
    """Port of ``tests/test_system.py:79``: the variant instantiates at the
    paper's tiny width (2 layers, vocab 256) and trains one step with a
    finite loss and finite gradients."""
    cfg = paper_config("tiny", variant, sparsity=8, seq_len=64)
    cfg = dataclasses.replace(cfg, n_layers=2, vocab=256,
                              pattern=cfg.pattern[:2])
    model = TransformerLM(cfg)
    model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(2, 256, (2, 33),
                         generator=torch.Generator().manual_seed(1))
    loss, _ = model.loss({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    assert np.isfinite(loss.item())
    assert all(g is None or torch.isfinite(g).all() for g in grads)
    params = dict(model.named_parameters())
    step = make_train_step(model, _opt(topt, tsched))
    _, _, _, m = step(params, _opt(topt, tsched).init(params), 0,
                      {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))


@pytest.mark.parametrize("variant", ["mosa", "fixed", "routing"])
def test_gradient_free_names_exactly_the_unreached_parameters(variant):
    """``gradient_free()`` names the parameters the loss never reaches:
    the routing baseline's centroids, nothing for MoSA or Fixed."""
    cfg = paper_config("tiny", variant, sparsity=8, seq_len=64)
    cfg = dataclasses.replace(cfg, n_layers=2, vocab=256,
                              pattern=cfg.pattern[:2])
    model = TransformerLM(cfg)
    model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(2, 256, (2, 33),
                         generator=torch.Generator().manual_seed(1))
    loss, _ = model.loss({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    unreached = {k for k, g in zip(names, grads) if g is None}
    assert unreached == model.gradient_free()
    assert unreached == ({f"layers.{i}.mixer.sparse.centroids"
                          for i in range(2)} if variant == "routing"
                         else set())


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_raises_for_a_parameter_cut_off_from_the_loss(
        microbatches):
    """Only the parameters the model names gradient-free get zeros: any
    other parameter the loss does not reach makes the step raise, instead
    of training frozen."""
    cfg = paper_config("tiny", "routing", sparsity=8, seq_len=64)
    cfg = dataclasses.replace(cfg, n_layers=2, vocab=256,
                              pattern=cfg.pattern[:2])
    model = TransformerLM(cfg)
    model.init(torch.Generator().manual_seed(0))
    model.stray = torch.nn.Parameter(torch.zeros(3))
    toks = torch.randint(2, 256, (2, 33),
                         generator=torch.Generator().manual_seed(1))
    params = dict(model.named_parameters())
    step = make_train_step(model, _opt(topt, tsched),
                           microbatches=microbatches)
    with pytest.raises(RuntimeError, match=r"\['stray'\]"):
        step(params, _opt(topt, tsched).init(params), 0,
             {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
