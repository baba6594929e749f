"""The differentiable MoSA inner attention: one ``torch.autograd.Function``
around the training forward and the backward kernels (the counterpart
of ``_build`` in ``repro/kernels/mosa_vjp.py``).

Forward: ``o_pre, lse = mosa_attention_fwd_res(q, k, v, idx, seg)`` (kernel
#2 on the card), then ``out = (o_pre * r).to(q.dtype)``; q, k, v, idx, seg,
r, o_pre and lse are saved.

Backward, with the O(S*d) reductions kept out of the kernels (at the
training slice they take longer than the fused backward kernel itself;
PERF.md):

  g~    = r * g                  (router scaling of the cotangent)
  dr    = rowsum(g * o_pre)      (router-score gradient: through it the
                                  router weights learn expert choice)
  delta = rowsum(g~ * o_pre)     (the softmax correction term)

then ``mosa_attention_bwd`` gives dq, dk and dv: on the card the fused
#3 + #4 kernel when a row fits one tile (S <= 64), the split #3 and #4
otherwise.  idx and seg are integers and get no gradient.

The kernels refuse tensors that require grad, and the tensors autograd
hands the Function (inputs and ``saved_tensors`` alike) do, so every
tensor is detached before it reaches a kernel.  On CPU tensors the same
Function runs the plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.mosa_attention import mosa_attention_fwd_res, wide
from repro_torch.kernels.mosa_backward import mosa_attention_bwd


class MoSAAttentionFunction(torch.autograd.Function):
    """``apply(q, k, v, idx, seg, r, scale)`` -> (B, H, S, d) in q.dtype;
    ``seg`` and ``scale`` may be None.  Gradients for q, k, v and r."""

    @staticmethod
    def forward(ctx, q, k, v, idx, seg, r, scale):
        q, k, v = (t.detach().contiguous() for t in (q, k, v))
        rf = wide(r.detach()).contiguous()
        o_pre, lse = mosa_attention_fwd_res(q, k, v, idx, scale=scale, seg=seg)
        ctx.scale = scale
        ctx.r_dtype = r.dtype
        ctx.save_for_backward(q, k, v, idx, seg, rf, o_pre, lse)
        return (o_pre * rf[..., None]).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, idx, seg, rf, o_pre, lse = (
            None if t is None else t.detach() for t in ctx.saved_tensors)
        g32 = wide(g)
        gt = (g32 * rf[..., None]).contiguous()
        dr = (g32 * o_pre).sum(-1)
        delta = (gt * o_pre).sum(-1).contiguous()
        dq, dk, dv = mosa_attention_bwd(q, k, v, idx, gt, lse, delta,
                                        scale=ctx.scale, seg=seg)
        return dq, dk, dv, None, None, dr.to(ctx.r_dtype), None
