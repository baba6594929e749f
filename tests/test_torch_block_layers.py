"""Block-choice MoSA layers and training against the JAX package on the
CPU, with converted weights: ``MoSAAttention`` with
``selection_granularity="block"`` (forward and every gradient, with
segments and per-document positions, a ragged last block), its router
health, ``TransformerLM.loss`` and two ``make_train_step`` steps of the
``mosa-paper`` smoke model with block choice, and the weight converter.

The port's ``impl="kernel"`` (on the CPU: ``MoSABlockAttentionFunction``
over the plain versions of kernels #6-#8) and ``einsum`` are both held to
the JAX package's ``einsum`` path.  Tolerances as for token choice
(``test_torch_train_model``): outputs 1e-5, grads atol 1e-5 / rtol 1e-4,
the loss rtol 1e-5; after two train steps the first moments within
atol 1e-6 / rtol 1e-4 and the parameters within AdamW's bound of 2 lr per
step (see ``test_torch_train_step``).  At bs = 1 the port's block layer
equals its token layer bit for bit, forward and grads (one intra-op
thread)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoSAConfig as JMoSAConfig
from repro.configs.base import get_config as jget_config
from repro.core.mosa import MoSAAttention as JMoSA
from repro.nn.transformer import TransformerLM as JLM
from repro.optim import optimizer as jopt
from repro.optim import schedules as jsched
from repro.train.step import make_train_step as jmake_train_step

from repro_torch.configs.base import MoSAConfig
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.mosa import MoSAAttention
from repro_torch.nn.transformer import TransformerLM
from repro_torch.optim import optimizer as topt
from repro_torch.optim import schedules as tsched
from repro_torch.train.step import make_train_step

from test_torch_modules import state_dict
from test_torch_parity import (numpy_params, one_cpu_thread,  # noqa: F401
                               t, to_jax, torch_config)
from test_torch_train_model import GRAD_TOL, _check_grads, _packed

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

D_MODEL = 64


def _layer(bs, impl, seed=1, **kw):
    base = dict(n_mosa_heads=4, sparsity=2, d_head=16, n_dense_heads=0,
                selection_granularity="block", sel_block_size=bs, **kw)
    jm = JMoSA(D_MODEL, JMoSAConfig(**base))
    tm = MoSAAttention(D_MODEL, MoSAConfig(**base, impl=impl), impl=impl)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                          seed)
    tm.load_state_dict(state_dict(params))
    return jm, to_jax(params), tm


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("impl", ["einsum", "kernel"])
@pytest.mark.parametrize("bs,T", [(4, 30), (16, 40)])
def test_block_layer_forward_and_grads_match_jax(bs, T, impl, packed):
    """sum(layer(x) * G): output, input gradient and every parameter
    gradient (the router's through the per-block dr) against JAX's einsum
    path; T is not a multiple of bs, so the last block is ragged."""
    jm, jp, tm = _layer(bs, impl)
    B = 2
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, D_MODEL)).astype(np.float32)
    G = rng.standard_normal((B, T, D_MODEL)).astype(np.float32)
    seg = pos = None
    if packed:
        b = _packed(B, T, 512)
        seg, pos = b["segments"], b["positions"]
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
    assert dict(zip(names, grads[1:]))["router.w"].abs().max() > 0


def test_block_layer_valid_mask_matches_jax():
    """Right-padded rows (``valid``): pad tokens leave the selection, an
    all-pad block contributes nothing."""
    jm, jp, tm = _layer(4, "kernel")
    T = 29
    x = np.random.default_rng(3).standard_normal((2, T, D_MODEL)).astype(
        np.float32)
    valid = np.arange(T)[None] < np.array([[T], [13]])
    want = jm(jp, jnp.asarray(x), valid=jnp.asarray(valid))
    with torch.no_grad():
        got = tm(t(x), valid=t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("impl", ["einsum", "kernel"])
def test_bs1_block_layer_equals_token_layer_bitwise(impl):
    """sel_block_size = 1: the port's block layer IS its token layer, bit
    for bit — output and every gradient, plain, right-padded and packed."""
    base = dict(n_mosa_heads=3, sparsity=4, d_head=8, n_dense_heads=0)
    mods = [MoSAAttention(32, MoSAConfig(**base, impl=impl, **g), impl=impl)
            for g in ({"selection_granularity": "token"},
                      {"selection_granularity": "block",
                       "sel_block_size": 1})]
    gen = torch.Generator().manual_seed(0)
    mods[0].init(gen)
    mods[1].load_state_dict(mods[0].state_dict())
    B, T = 2, 16
    x = torch.randn(B, T, 32, generator=gen) * 0.5
    valid = torch.arange(T)[None].expand(B, T) < 11
    segs = (torch.arange(T) >= 10).long()[None].expand(B, T)
    pos = torch.where(torch.arange(T) < 10, torch.arange(T),
                      torch.arange(T) - 10)[None].expand(B, T)
    for kw in ({}, {"valid": valid}, {"positions": pos, "segments": segs}):
        res = []
        for m in mods:
            xx = x.clone().requires_grad_()
            y = m(xx, **kw)
            res.append([y] + list(torch.autograd.grad(
                (y ** 2).sum(), [xx] + list(m.parameters()))))
        assert all(torch.equal(a, b) for a, b in zip(*res)), kw


def test_block_router_health_matches_jax():
    """Block choice is scored in block space (entropy over blocks, drop
    rate of unselected blocks)."""
    jm, jp, tm = _layer(4, "einsum")
    x = np.random.default_rng(4).standard_normal((2, 30, D_MODEL)).astype(
        np.float32)
    want = jm.router_health(jp, jnp.asarray(x))
    with torch.no_grad():
        got = tm.router_health(t(x))
    for k in ("sel_entropy", "drop_rate", "head_util"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6,
                                   err_msg=k)


def _block_lm(impl="kernel", seed=3):
    jcfg = jget_config("mosa-paper", preset="smoke", variant="mosa",
                       selection_granularity="block", sel_block_size=4)
    jcfg = dataclasses.replace(jcfg, mosa=dataclasses.replace(
        jcfg.mosa, impl="pallas" if impl == "kernel" else "einsum"))
    params = numpy_params(jax.eval_shape(JLM(jcfg).init,
                                         jax.random.PRNGKey(0)), seed)
    model = TransformerLM(torch_config(jcfg))
    model.load_state_dict(params_from_jax(jcfg, params))
    return jcfg, params, model


def _batch(B=2, T=32, vocab=512, seed=5):
    tok = np.random.default_rng(seed).integers(2, vocab, (B, T + 1)).astype(
        np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


@pytest.mark.parametrize("packed", [False, True])
def test_block_lm_loss_and_grads_match_jax(packed):
    """The smoke LM with block choice (bs 4): loss, router health and every
    gradient; packed rows with segments and positions too."""
    jcfg, params, model = _block_lm()
    batch = _packed(2, 32, 512, seed=4) if packed else _batch()
    jm = JLM(jcfg)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, with_health=True), has_aux=True))(
        to_jax(params), {k: jnp.asarray(v) for k, v in batch.items()})
    loss, met = model.loss({k: t(v).long() for k, v in batch.items()},
                           with_health=True)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for k in ("ce", "sel_entropy", "drop_rate", "head_util"):
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    want = params_from_jax(jcfg, jax.tree.map(np.asarray, jg))
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k,
                                   **GRAD_TOL)


def _opt(o, s, lr=2.5e-4):
    return o.adamw(s.linear_warmup(lr, 2), clip_norm=1.0)


def test_block_train_steps_match_jax():
    """Two ``make_train_step`` steps of the block-choice smoke LM from the
    same weights and batch: loss, grad norm and router health each step,
    and the parameters after them, against JAX's ``make_train_step``."""
    jcfg, params, model = _block_lm()
    batch = _batch(B=4)
    jstep = jax.jit(jmake_train_step(JLM(jcfg), _opt(jopt, jsched),
                                     health=True))
    jp = to_jax(params)
    jo, js = _opt(jopt, jsched).init(jp), jnp.zeros((), jnp.int32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tstep = make_train_step(model, _opt(topt, tsched), health=True)
    tp = dict(model.named_parameters())
    to, ts = _opt(topt, tsched).init(tp), 0
    tb = {k: t(v).long() for k, v in batch.items()}
    for _ in range(2):
        jp, jo, js, jm = jstep(jp, jo, js, jb)
        tp, to, ts, tm = tstep(tp, to, ts, tb)
        for k in ("loss", "ce", "grad_norm", "sel_entropy", "drop_rate",
                  "head_util"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
    # the accumulated gradients (first moments) within the gradients'
    # tolerance; the parameters within AdamW's own bound: its normalized
    # update turns a rounding difference of a near-zero gradient into one
    # of up to 2 lr per step (lr 1.25e-4, then 2.5e-4)
    jmu = params_from_jax(jcfg, jax.tree.map(np.asarray, jo["mu"]))
    for k, m in to["mu"].items():
        np.testing.assert_allclose(m.numpy(), jmu[k].numpy(), atol=1e-6,
                                   rtol=1e-4, err_msg=k)
    want = params_from_jax(jcfg, jax.tree.map(np.asarray, jp))
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   atol=2 * (1.25e-4 + 2.5e-4), rtol=0,
                                   err_msg=k)


def test_block_model_weights_round_trip():
    """Block choice adds no parameter: the converter maps every leaf of a
    block-choice model both ways, and the state dict is the token model's
    key set."""
    jcfg, params, model = _block_lm("einsum")
    tok = TransformerLM(torch_config(dataclasses.replace(
        jcfg, mosa=dataclasses.replace(jcfg.mosa,
                                       selection_granularity="token"))))
    assert set(model.state_dict()) == set(tok.state_dict())
    back = params_to_jax(jcfg, model.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict((jax.tree_util.keystr(k), v) for k, v in
                  jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for k, v in flat_a:
        np.testing.assert_array_equal(flat_b[jax.tree_util.keystr(k)], v)
