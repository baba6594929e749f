"""The port's training forward and gradients against the JAX package, on
the CPU, with converted weights: ``MoSAAttention`` and ``HybridAttention``
(output, input and parameter gradients, the router weights included),
``TransformerLM.loss`` and its gradients on the ``mosa-paper`` smoke preset
(2 layers, vocab 512), packed rows, ``router_health_stats``, and the remat
policies.

The port's ``impl="kernel"`` (on the CPU: the autograd Function over the
kernels' plain versions) is held against the JAX package's ``pallas``
path (interpret mode), and ``einsum`` against ``einsum``.  Tolerance: fp32,
grads atol 1e-5 and rtol 1e-4 (a stack of layers in another summation
order), the loss rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoSAConfig as JMoSAConfig
from repro.configs.base import get_config as jget_config
from repro.core.hybrid import HybridAttention as JHybrid
from repro.core.mosa import MoSAAttention as JMoSA
from repro.core.router import router_health_stats as jrouter_health_stats
from repro.core.router import select_topk as jselect_topk
from repro.data.pipeline import PackedLMDataset, SyntheticCorpus
from repro.nn.transformer import TransformerLM as JLM

from repro_torch.configs.base import MoSAConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.hybrid import HybridAttention
from repro_torch.core.mosa import MoSAAttention
from repro_torch.core.router import router_health_stats, select_topk
from repro_torch.nn.transformer import TransformerLM
from repro_torch.train.step import with_remat

from test_torch_modules import state_dict
from test_torch_parity import (numpy_params, one_cpu_thread,  # noqa: F401
                               t, to_jax, torch_config)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
D_MODEL = 64
JIMPL = {"einsum": "einsum", "kernel": "pallas"}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _check_grads(got: dict, want_tree, tol=GRAD_TOL):
    want = _flat(jax.tree.map(np.asarray, want_tree))
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], err_msg=k, **tol)


def _packed(B, T, vocab, seed=0):
    ds = PackedLMDataset(SyntheticCorpus(vocab=vocab, seed=seed,
                                         mean_doc_len=24),
                         seq_len=T, global_batch=B, segmented=True)
    return ds.batch_at(0)


def _layer_case(kind, impl, packed):
    """Returns (jax loss fn, jax params, torch module, x, G, segments,
    positions) for a one-layer check of sum(layer(x) * G)."""
    cfg_kw = dict(n_mosa_heads=6, sparsity=4, d_head=16,
                  n_dense_heads=2 if kind == "hybrid" else 0)
    jcfg = JMoSAConfig(**cfg_kw, impl=JIMPL[impl])
    tcfg = MoSAConfig(**cfg_kw, impl=impl)
    if kind == "hybrid":
        jm, tm = JHybrid(D_MODEL, jcfg, impl=JIMPL[impl]), HybridAttention(
            D_MODEL, tcfg, impl=impl)
    else:
        jm, tm = JMoSA(D_MODEL, jcfg, impl=JIMPL[impl]), MoSAAttention(
            D_MODEL, tcfg, impl=impl)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 1)
    tm.load_state_dict(state_dict(params))
    B, T = 2, 24
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, D_MODEL)).astype(np.float32)
    G = rng.standard_normal((B, T, D_MODEL)).astype(np.float32)
    seg = pos = None
    if packed:
        b = _packed(B, T, 512)
        seg, pos = b["segments"], b["positions"]
    return jm, to_jax(params), tm, x, G, seg, pos


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("impl", ["einsum", "kernel"])
@pytest.mark.parametrize("kind", ["mosa", "hybrid"])
def test_layer_forward_and_grads_match_jax(kind, impl, packed):
    jm, jp, tm, x, G, seg, pos = _layer_case(kind, impl, packed)
    jpos = None if pos is None else jnp.asarray(pos)
    jseg = None if seg is None else jnp.asarray(seg)

    def jloss(p, x):
        y = jm(p, x, jpos, segments=jseg)
        return jnp.sum(y * jnp.asarray(G)), y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    xt = t(x).requires_grad_()
    y = tm(xt, None if pos is None else t(pos).long(),
           segments=None if seg is None else t(seg).long())
    names = [k for k, _ in tm.named_parameters()]
    grads = torch.autograd.grad((y * t(G)).sum(),
                                [xt] + [p for _, p in tm.named_parameters()])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **GRAD_TOL)
    _check_grads(dict(zip(names, grads[1:])), jgp)
    router = dict(zip(names, grads[1:]))[
        "router.w" if kind == "mosa" else "sparse.router.w"]
    assert router.abs().max() > 0          # the router learns through dr


def _lm_pair(impl):
    jcfg = jget_config("mosa-paper", preset="smoke", variant="mosa")
    jcfg = dataclasses.replace(
        jcfg, mosa=dataclasses.replace(jcfg.mosa, impl=JIMPL[impl]))
    params = numpy_params(jax.eval_shape(JLM(jcfg).init,
                                         jax.random.PRNGKey(0)), 3)
    model = TransformerLM(torch_config(jcfg))
    model.load_state_dict(params_from_jax(jcfg, params))
    return JLM(jcfg), to_jax(params), model


def _lm_batch(packed, B=2, T=32, vocab=512):
    if packed:
        return _packed(B, T, vocab, seed=4)
    tok = np.random.default_rng(5).integers(2, vocab, (B, T + 1)).astype(
        np.int32)
    labels = tok[:, 1:].copy()
    labels[0, :3] = -1                    # masked labels
    return {"tokens": tok[:, :-1], "labels": labels}


def _torch_batch(batch):
    return {k: t(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("impl,packed", [("einsum", False), ("kernel", False),
                                         ("kernel", True)])
def test_lm_loss_and_grads_match_jax(impl, packed):
    jm, jp, model = _lm_pair(impl)
    batch = _lm_batch(packed)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, with_health=True), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, met = model.loss(_torch_batch(batch), with_health=True)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for k in ("ce", "ppl", "tokens", "sel_entropy", "drop_rate", "head_util"):
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    want = {k: np.asarray(v) for k, v in
            params_from_jax(jm.cfg, jax.tree.map(np.asarray, jg)).items()}
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[k], err_msg=k, **GRAD_TOL)
    if packed:
        return
    # the standalone faces of the same forward: logits and router health
    jlogits, _ = jax.jit(jm.__call__)(jp, jnp.asarray(batch["tokens"]))
    with torch.no_grad():
        logits, aux = model(t(batch["tokens"]).long())
        health = model.router_health(t(batch["tokens"]).long())
    assert logits.dtype == torch.float32 and aux.item() == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    for k, v in health.items():
        np.testing.assert_allclose(v.item(), met[k].item(), rtol=1e-6,
                                   err_msg=k)


def test_router_health_stats_match_jax():
    rng = np.random.default_rng(6)
    scores = (1 / (1 + np.exp(-rng.standard_normal((2, 5, 40))))).astype(
        np.float32)
    for k in (3, 12, 40):
        want = jax.jit(lambda s: jrouter_health_stats(
            *jselect_topk(s, k), 40))(jnp.asarray(scores))
        r, idx = select_topk(t(scores), k)
        got = router_health_stats(r, idx, 40)
        for key in ("sel_entropy", "drop_rate", "head_util"):
            np.testing.assert_allclose(got[key].item(), float(want[key]),
                                       rtol=1e-6, err_msg=key)


def test_remat_full_preserves_loss_and_grads():
    """Remat ``full`` recomputes each block (and the MoSA Function's
    forward) in the backward: the same loss and grads as ``none``."""
    _, _, model = _lm_pair("kernel")
    batch = _torch_batch(_lm_batch(False))
    out = []
    for policy in ("none", "full"):
        model.cfg = with_remat(model.cfg, policy)
        loss, _ = model.loss(batch)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    (l0, g0), (l1, g1) = out
    assert l1.item() == l0.item()
    for a, b in zip(g0, g1):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("policy", ["mosa", "dots_saveable"])
def test_unported_remat_policies_raise(policy):
    _, _, model = _lm_pair("einsum")
    model.cfg = with_remat(model.cfg, policy)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.loss(_torch_batch(_lm_batch(False)))
