"""Layer-stacked pipeline parallelism, the GPipe schedule (port of
``repro.dist.pipeline``).

Runs on a mesh whose stage axis is named ``pipe`` (pipeline meshes are
built on their own, e.g. ``launch.mesh.make_mesh((4,), ("pipe",))``), one
process per stage.  ``stack_stage_params`` stacks per-stage parameter dicts
along a leading stage dim; ``pipeline_forward`` gives each rank its stage's
slice and runs the fill / steady / drain schedule: ``n_microbatches +
n_stages - 1`` ticks, activations passed to the next stage's rank at every
tick (``shift``, a ring of sends and receives).  Stage 0 takes microbatch
``t`` at tick ``t``; the last stage emits microbatch ``t - (S - 1)`` at
tick ``t``; a sum over ``pipe`` of the outputs, zero on every stage but the
last, replicates them on every rank.  The schedule is differentiable: the
shift's backward shifts the gradients the other way, and the sum's
backward is the identity (each rank differentiates its own copy of the
replicated output), so the same schedule trains.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist import sharding as shd


def stack_stage_params(stage_params: list) -> dict:
    """Stack a list of per-stage dicts of tensors along a new leading
    stage dim."""
    if not stage_params:
        raise ValueError("need at least one stage")
    return {k: torch.stack([p[k] for p in stage_params])
            for k in stage_params[0]}


def _ring(x, group, rank, size, step):
    """Send ``x`` to the rank ``step`` places on in the ring and return
    what the rank ``step`` places back sent."""
    out = torch.empty_like(x)
    dst = dist.get_global_rank(group, (rank + step) % size)
    src = dist.get_global_rank(group, (rank - step) % size)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dst, group),
           dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Shift(torch.autograd.Function):
    """Stage i's activations to stage i + 1 (the last to stage 0); the
    backward sends the gradients from stage i + 1 back to stage i."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.args = (group, rank, size)
        return _ring(x, group, rank, size, 1)

    @staticmethod
    def backward(ctx, g):
        return _ring(g, *ctx.args, -1), None, None, None


class _SumStages(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_forward(stage_fn, stage_params: dict, x, *, mesh,
                     n_microbatches: int, axis: str = "pipe"):
    """Apply ``n_stages`` copies of ``stage_fn`` as a pipeline over
    ``axis``.

    stage_fn:      ``(params, activations) -> activations``, shape-keeping
    stage_params:  dict whose tensors have leading dim ``mesh`` ``axis``
                   size (``stack_stage_params``); this rank uses its
                   stage's slice
    x:             (B, ...) the global batch, the same on every rank;
                   B % n_microbatches == 0

    Returns the (B, ...) output on every rank, equal to applying the
    stages one after the other."""
    sizes = shd.mesh_axes(mesh)
    if axis not in sizes:
        raise ValueError(f"mesh has no {axis!r} axis: {sizes}")
    n_stages = sizes[axis]
    leading = {t.shape[0] for t in stage_params.values()}
    if leading != {n_stages}:
        raise ValueError(f"stage_params leading dims {leading} != mesh "
                         f"{axis} size {n_stages}")
    B = x.shape[0]
    if n_microbatches < 1 or B % n_microbatches != 0:
        raise ValueError(f"batch {B} not divisible into {n_microbatches} "
                         "microbatches")
    mb = B // n_microbatches
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)
    local = {k: t[stage] for k, t in stage_params.items()}
    micro = x.reshape((n_microbatches, mb) + tuple(x.shape[1:]))
    buf = torch.zeros_like(micro[0])
    zeros = torch.zeros_like(micro[0])
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)
    outs = []
    for t in range(n_microbatches + n_stages - 1):
        feed = micro[t] if t < n_microbatches else zeros
        # selects, not branches: every rank's graph holds every shift, so
        # every rank joins every shift's backward
        out = stage_fn(local, torch.where(first, feed, buf))
        if t >= n_stages - 1:
            outs.append(torch.where(last, out, torch.zeros_like(out)))
        buf = _Shift.apply(out, group, stage, n_stages)
    y = _SumStages.apply(torch.stack(outs), group)   # non-zero: last stage
    return y.reshape((n_microbatches * mb,) + tuple(y.shape[2:]))
