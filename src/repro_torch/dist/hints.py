"""Ambient activation-sharding hints (port of ``repro.dist.hints``).

Model code runs mesh-agnostic; a launcher with a mesh opens a
``sharding_hints(mesh=...)`` context, and a layer marks an activation with
``constrain(x, roles)``, where each role names a *class* of mesh axes:

  * ``"dp"``  — the data-parallel axes of the ambient mesh (``pod``/``data``);
  * ``"tp"``  — the tensor-parallel axis (``model``);
  * ``None``  — replicated;
  * a literal mesh-axis name (or tuple of names) passes through.

``resolve(shape, roles)`` gives the placement (a ``dist.sharding`` spec
tuple, or None when nothing would be sharded), divisibility-safe and never
using one mesh axis twice.  ``constrain`` redistributes a ``DTensor`` to
that placement and returns a plain tensor unchanged: the port's modules
compute on plain local shards (``dist.parallel``), so the hint only acts
on DTensors.  Nothing on the ported path calls ``constrain`` yet (its JAX
callers are the MoE, Mamba and xLSTM layers); the Trainer enters the
context around every step, as the JAX Trainer does.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Optional

from repro_torch.dist import sharding as shd

# None, or {"mesh": mesh, "dp": tuple, "tp": str | None}.
_HINTS: ContextVar = ContextVar("repro_torch_sharding_hints", default=None)


@contextmanager
def sharding_hints(mesh=None, dp=None, tp=None):
    """Install ambient hints for the enclosed region.  ``dp`` / ``tp``
    default to the conventional axes present on ``mesh``."""
    axes = shd.mesh_axes(mesh) if mesh is not None else {}
    if dp is None:
        dp = tuple(a for a in shd.DP_AXES if a in axes)
    elif isinstance(dp, str):
        dp = (dp,)
    if tp is None and mesh is not None:
        tp = shd.tp_axis(mesh)
    token = _HINTS.set({"mesh": mesh, "dp": tuple(dp), "tp": tp})
    try:
        yield _HINTS.get()
    finally:
        _HINTS.reset(token)


def current() -> Optional[dict]:
    """The active hint state, or None outside any ``sharding_hints``."""
    return _HINTS.get()


def resolve(shape, roles) -> Optional[tuple]:
    """Per-dim roles -> a placement under the ambient mesh; None when
    there is nothing to constrain (no context, or all replicated)."""
    state = _HINTS.get()
    if state is None or state.get("mesh") is None:
        return None
    mesh = state["mesh"]
    used: set = set()
    out = []
    for dim, role in zip(shape, roles):
        if role is None:
            out.append(None)
            continue
        if role == "dp":
            axes = state["dp"]
        elif role == "tp":
            axes = (state["tp"],) if state["tp"] is not None else ()
        elif isinstance(role, str):
            axes = (role,)
        else:
            axes = tuple(role)
        axes = shd.fit_axes(dim, tuple(a for a in axes if a not in used),
                            mesh)
        if not axes:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out) if out else None


def placements(spec: tuple, mesh) -> list:
    """A spec tuple -> DTensor placements, one per mesh dimension (a mesh
    dimension named by no tensor dim is ``Replicate``)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, entry in enumerate(spec):
        for a in shd.spec_axes(entry):
            out[list(mesh.mesh_dim_names).index(a)] = Shard(d)
    return out


def constrain(x, roles):
    """Redistribute a ``DTensor`` to the resolved placement under the
    ambient hints; a plain tensor, no context or nothing resolved returns
    ``x`` unchanged."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = resolve(x.shape, roles)
    if spec is None:
        return x
    mesh = _HINTS.get()["mesh"]
    return x.redistribute(mesh, placements(spec, mesh))
