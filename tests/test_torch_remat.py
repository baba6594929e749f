"""The remat policies ``mosa`` and ``dots_saveable`` (``repro_torch.nn.remat``)
on the ``mosa-paper`` smoke model: the loss equal to remat ``none``'s and
every grad within 1e-6; loss and grads equal to the JAX package's same
policy at the parity tests' tolerance; and what each policy keeps — per
MoSA layer exactly the two tagged tensors under ``mosa`` (token and block
choice), whose recompute then does not gather again, only matrix products
under ``dots_saveable``, never the output of a factory op (a kernel's
output buffer)."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.convert import params_from_jax
from repro_torch.nn import remat as remat_lib
from repro_torch.nn.transformer import TransformerLM
from repro_torch.train.step import with_remat

from test_torch_parity import one_cpu_thread, torch_config  # noqa: F401
from test_torch_train_model import (GRAD_TOL, _lm_batch, _lm_pair,
                                    _torch_batch)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

POLICIES = ["mosa", "dots_saveable"]


def _loss_and_grads(model, batch, policy):
    model.cfg = with_remat(model.cfg, policy)
    loss, _ = model.loss(batch)
    return loss, torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_preserves_loss_and_grads(policy):
    """On the kernel path (the autograd Function over the kernels' plain
    versions): the forward is the same ops, so the loss is bitwise
    ``none``'s; the recomputed backward gives every grad within 1e-6 of
    its tensor's max |grad|."""
    _, _, model = _lm_pair("kernel")
    batch = _torch_batch(_lm_batch(False))
    l0, g0 = _loss_and_grads(model, batch, "none")
    l1, g1 = _loss_and_grads(model, batch, policy)
    assert l1.item() == l0.item()
    for (name, _), a, b in zip(model.named_parameters(), g0, g1):
        assert (b - a).abs().max() <= 1e-6 * a.abs().max(), name


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_matches_jax(policy):
    """The port under ``policy`` against the JAX package under the same
    policy (``jax.checkpoint`` with ``dots_saveable`` /
    ``save_only_these_names``), einsum path, packed rows."""
    jm, jp, model = _lm_pair("einsum")
    jm = type(jm)(dataclasses.replace(jm.cfg, remat=policy))
    batch = _lm_batch(True)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _loss_and_grads(model, _torch_batch(batch), policy)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = params_from_jax(jm.cfg, jax.tree.map(np.asarray, jg))
    for (k, _), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   err_msg=k, **GRAD_TOL)


def _kept(monkeypatch, model, batch, policy):
    """The ops whose outputs ``policy`` keeps in one loss and backward of
    ``model`` (the first forward's decisions; the recompute asks again)."""
    kept = []
    decide = remat_lib.SELECTIVE[policy]

    def recording(ctx, op, *args, **kwargs):
        out = decide(ctx, op, *args, **kwargs)
        if out == remat_lib.CheckpointPolicy.MUST_SAVE and \
                not ctx.is_recompute:
            kept.append((op, args[-1] if op in remat_lib.TAG_OPS
                         else None))
        return out

    monkeypatch.setitem(remat_lib.SELECTIVE, policy, recording)
    _loss_and_grads(model, batch, policy)
    return kept


class _OpCounts(TorchDispatchMode):
    """Counts the aten ops that run under it."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def _model(granularity):
    _, _, model = _lm_pair("kernel")
    if granularity == "token":
        return model
    cfg = dataclasses.replace(model.cfg, mosa=dataclasses.replace(
        model.cfg.mosa, selection_granularity="block", sel_block_size=4))
    state = model.state_dict()
    model = TransformerLM(cfg)
    model.load_state_dict(state)
    return model


def _backward_ops(model, batch, policy):
    model.cfg = with_remat(model.cfg, policy)
    loss, _ = model.loss(batch)
    with _OpCounts() as mode:
        torch.autograd.grad(loss, list(model.parameters()))
    return mode.counts


@pytest.mark.parametrize("granularity", ["token", "block"])
def test_remat_mosa_keeps_only_the_tagged_tensors(monkeypatch, granularity):
    """Per MoSA layer, the gathered activations and the router scores,
    and nothing else: no factory op (``empty``, ``zeros``: the kernels'
    output buffers), no gather of the loss or of the dense heads."""
    model = _model(granularity)
    kept = _kept(monkeypatch, model, _torch_batch(_lm_batch(False)), "mosa")
    n_mosa = sum(layer.spec.mixer == "mosa" for layer in model.layers)
    assert sorted((str(op), name) for op, name in kept) == sorted(
        [(str(remat_lib.GATHER_OP), "mosa_gather"),
         (str(remat_lib.TAG_OP), "mosa_router")] * n_mosa)


@pytest.mark.parametrize("granularity", ["token", "block"])
def test_remat_mosa_recompute_does_not_gather_again(granularity):
    """The recompute under ``mosa`` takes each MoSA layer's kept gather
    instead of running it: its backward runs one token gather (aten
    ``index``) per MoSA layer fewer than ``full``'s, which gathers again,
    and the tagged gather op never runs in it."""
    model = _model(granularity)
    batch = _torch_batch(_lm_batch(False))
    full = _backward_ops(model, batch, "full")
    mosa = _backward_ops(model, batch, "mosa")
    n_mosa = sum(layer.spec.mixer == "mosa" for layer in model.layers)
    index = torch.ops.aten.index.Tensor
    assert full[index] >= n_mosa > 0
    assert mosa[index] == full[index] - n_mosa
    assert mosa[remat_lib.GATHER_OP] == 0
    assert mosa[remat_lib.TAG_OP] == 0


def test_remat_dots_saveable_keeps_only_matrix_products(monkeypatch):
    _, _, model = _lm_pair("kernel")
    kept = _kept(monkeypatch, model, _torch_batch(_lm_batch(False)),
                 "dots_saveable")
    ops = {op for op, _ in kept}
    assert ops and ops <= {torch.ops.aten.mm.default,
                           torch.ops.aten.bmm.default,
                           torch.ops.aten.addmm.default,
                           torch.ops.aten.baddbmm.default}


def test_unknown_remat_policy_raises():
    _, _, model = _lm_pair("einsum")
    model.cfg = with_remat(model.cfg, "offload")
    with pytest.raises(ValueError, match="remat policy"):
        model.loss(_torch_batch(_lm_batch(False)))
