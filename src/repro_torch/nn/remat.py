"""Activation rematerialization of the transformer blocks (port of the
``remat`` knob of ``repro.nn.transformer``), with
``torch.utils.checkpoint`` (non-reentrant): a block's forward runs again in
the backward, and a policy says which of its ops' outputs are kept instead.

  * ``none`` — no checkpoint: autograd keeps what it needs.
  * ``full`` — only the block's inputs are kept (JAX's
    ``nothing_saveable``).
  * ``dots_saveable`` — the outputs of the matrix products are kept (aten
    ``mm``, ``bmm``, ``addmm``, ``baddbmm``: what ``einsum``, ``matmul``
    and ``linear`` run as); every other op runs again.
  * ``mosa`` — only the tensors tagged by name are kept: per MoSA layer
    the gathered activations (``"mosa_gather"``) and the selected router
    scores (``"mosa_router"``), as JAX's ``save_only_these_names``.

``dots_saveable`` and ``mosa`` are selective checkpoints
(``create_selective_checkpoint_contexts``): the policy sees the aten ops
of the block's forward, and the recompute returns a kept op's output
instead of running the op.  The hand-written kernels launch through
ctypes, outside the dispatcher, into buffers made by ``torch.empty``; no
policy keeps a factory op's output, so the recompute makes new buffers and
launches the kernels again.

The tags are the identity except inside a block under ``mosa``.  There
the gather itself is the op ``repro_torch::checkpoint_gather``, so the
recompute takes the kept activations and does not gather again (the
norm, the router and its top-k still run again: the gather's backward and
the kernels need the indices, as in JAX); the router scores go through
``repro_torch::checkpoint_name``, a copy (a custom op may not return its
input).
"""

from __future__ import annotations

import contextvars
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

POLICIES = ("none", "full", "dots_saveable", "mosa")
MOSA_NAMES = ("mosa_gather", "mosa_router")

# True while a block runs under the ``mosa`` policy (its forward and its
# recompute): ``checkpoint_name`` and ``checkpoint_gather`` then tag.
_TAGGING = contextvars.ContextVar("repro_torch_remat_tagging", default=False)


def gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (B, T, ...) and idx: (B, H, k) -> (B, H, k, ...): row b's tokens
    at idx[b] (the batch dimension written out where JAX vmaps)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, idx]


@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def _tag(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_tag.register_fake
def _(x, name):
    return torch.empty_like(x)


_tag.register_autograd(lambda ctx, grad: (grad, None))


@torch.library.custom_op("repro_torch::checkpoint_gather", mutates_args=())
def _tag_gather(x: torch.Tensor, idx: torch.Tensor,
                name: str) -> torch.Tensor:
    return gather_tokens(x, idx)


@_tag_gather.register_fake
def _(x, idx, name):
    return x.new_empty((*idx.shape, *x.shape[2:]))


def _gather_setup(ctx, inputs, output):
    x, idx, _ = inputs
    ctx.save_for_backward(idx)
    ctx.x_meta = (x.shape, x.dtype, x.device)


def _gather_backward(ctx, grad):
    """The gradient autograd gives ``gather_tokens`` (an accumulating
    ``index_put_`` into zeros)."""
    idx, = ctx.saved_tensors
    shape, dtype, device = ctx.x_meta
    b = torch.arange(shape[0], device=device)[:, None, None]
    gx = torch.zeros(shape, dtype=dtype, device=device)
    return gx.index_put_((b, idx), grad, accumulate=True), None, None


_tag_gather.register_autograd(_gather_backward, setup_context=_gather_setup)
TAG_OP = torch.ops.repro_torch.checkpoint_name.default
GATHER_OP = torch.ops.repro_torch.checkpoint_gather.default
TAG_OPS = frozenset({TAG_OP, GATHER_OP})


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Name ``x`` for the ``mosa`` policy (JAX's ``checkpoint_name``)."""
    return _tag(x, name) if _TAGGING.get() else x


def checkpoint_gather(x: torch.Tensor, idx: torch.Tensor,
                      name: str) -> torch.Tensor:
    """``gather_tokens(x, idx)`` named ``name`` for the ``mosa`` policy."""
    return _tag_gather(x, idx, name) if _TAGGING.get() else \
        gather_tokens(x, idx)


_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_mosa_names(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE
            if op in TAG_OPS and args[-1] in MOSA_NAMES
            else CheckpointPolicy.PREFER_RECOMPUTE)


SELECTIVE = {"dots_saveable": _save_dots, "mosa": _save_mosa_names}


def _tagging(fn):
    def run(*args):
        token = _TAGGING.set(True)
        try:
            return fn(*args)
        finally:
            _TAGGING.reset(token)
    return run


def remat(block, policy: str):
    """``block`` (a callable of tensors) under the remat ``policy``."""
    if policy == "none":
        return block
    if policy == "full":
        return lambda *a: checkpoint(block, *a, use_reentrant=False)
    if policy not in SELECTIVE:
        raise ValueError(f"unknown remat policy {policy!r}: one of "
                         f"{POLICIES}")
    fn = _tagging(block) if policy == "mosa" else block
    context = functools.partial(create_selective_checkpoint_contexts,
                                SELECTIVE[policy])
    return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                 context_fn=context)
