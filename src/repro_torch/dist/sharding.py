"""Sharding rule sets: logical model axes -> placements on a mesh (port of
``repro.dist.sharding`` and of ``resolve_spec`` / ``resolve_specs`` from
``repro.nn.module``).

Mesh-axis names, as in the JAX package: data parallelism lives on
``("pod", "data")`` (outer to inner), tensor parallelism on ``"model"``,
pipeline stages on ``"pipe"`` (pipeline meshes only).  Modules name only
*logical* axes (``embed``, ``heads``, ``mlp``, ``vocab``, ...) in their
``specs()``; a rule set maps each logical axis to mesh axes, and
``resolve_spec`` applies the mapping divisibility-safely: a dimension that
the product of the mapped mesh axes does not divide is replicated, and a
mesh axis is used at most once per tensor.

  * ``"tp"``      — width-like axes (mlp, heads, experts, vocab) over
                    ``model``; everything else replicated.
  * ``"fsdp_tp"`` — ``"tp"`` plus the ``embed`` axis over the data-parallel
                    axes.

A placement ("spec") is a tuple with one entry per leading dimension: None
(replicated), a mesh-axis name, or a tuple of names; trailing Nones are
trimmed — ``tuple(jax.sharding.PartitionSpec(...))`` of the JAX package's
result.  Everything here is pure: a "mesh" is anything with a ``shape``
mapping of axis name -> size (the JAX package's convention), a
``torch.distributed.device_mesh.DeviceMesh`` (its ``mesh_dim_names``), or a
plain dict.

Serving caches are placed by ``cache_spec`` / ``cache_shardings`` from the
``CACHE_AXES`` table, which names the logical axis of every dim of every
cache family (the paged pools register theirs from
``repro_torch.serve.paged_kv``): ``batch`` over the data-parallel axes,
``kv_heads`` / ``mosa_heads`` over ``model`` (head-parallel decode), and
``seq`` over ``model`` only under ``seq_sharded`` (the batch-1
long-context layout of the contiguous dense and window caches, where
``seq`` wins over the heads).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

from repro_torch.core import kv_cache as _kvc

# Data-parallel mesh axes, outermost first; tensor-parallel axis name.
DP_AXES = ("pod", "data")
TP_AXIS = "model"

_TP_RULES = {
    "embed": None,
    "vocab": TP_AXIS,
    "mlp": TP_AXIS,
    "heads": TP_AXIS,
    "kv_heads": TP_AXIS,
    "mosa_heads": TP_AXIS,
    "expert": TP_AXIS,
    "expert_mlp": None,
    "batch": DP_AXES,
}

RULE_SETS: Mapping[str, Mapping[str, Any]] = {
    "tp": _TP_RULES,
    "fsdp_tp": {**_TP_RULES, "embed": DP_AXES},
}


# ------------------------------------------------------------ logical specs
@dataclasses.dataclass(frozen=True)
class LogicalSpec:
    """Per-parameter logical axes: one name (or None) per dimension."""

    axes: tuple

    def __iter__(self):
        return iter(self.axes)

    def __len__(self):
        return len(self.axes)


def logical(*axes) -> LogicalSpec:
    return LogicalSpec(tuple(axes))


def mesh_axes(mesh) -> dict:
    """Axis name -> size of ``mesh`` (a DeviceMesh, a dict, or anything
    with a ``shape`` mapping)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _product(axes, sizes) -> int:
    total = 1
    for a in axes or ():
        total *= sizes[a]
    return total


def resolve_spec(shape: Sequence[int], spec: Optional[LogicalSpec],
                 rules: Mapping[str, Any], mesh) -> tuple:
    """One logical spec against a concrete shape -> a placement tuple.
    Divisibility-safe: a dimension that the mapped mesh axes do not divide
    is replicated; a mesh axis already used by an earlier dimension is
    dropped."""
    if spec is None:
        return ()
    sizes = mesh_axes(mesh)
    out, used = [], set()
    for dim, name in zip(shape, spec.axes):
        axes = rules.get(name) if name is not None else None
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes if a not in used)
        total = _product(axes, sizes) if axes else 0
        if not axes or total == 0 or dim == 0 or dim % total:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def resolve_specs(shapes: Mapping[str, Sequence[int]],
                  specs: Mapping[str, LogicalSpec], rules, mesh) -> dict:
    """name -> shape and name -> logical spec -> name -> placement."""
    return {k: resolve_spec(tuple(shapes[k]), specs[k], rules, mesh)
            for k in shapes}


# ------------------------------------------------------------- axis fitting
def fit_axes(dim: int, axes: Sequence[str], mesh) -> tuple:
    """Largest prefix of ``axes`` whose mesh-size product divides ``dim``
    (trimmed from the right, so the outer data-parallel axis survives
    longest)."""
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in axes if a in sizes)
    while axes and dim > 0:
        total = _product(axes, sizes)
        if total > 0 and dim % total == 0:
            return axes
        axes = axes[:-1]
    return ()


def _check(rule_set: str):
    if rule_set not in RULE_SETS:
        raise KeyError(f"unknown rule set {rule_set!r}; have {list(RULE_SETS)}")


def dp_axes(mesh, rule_set: str = "fsdp_tp",
            batch: Optional[int] = None) -> tuple:
    """Data-parallel axes of ``mesh`` (the rule set's ``batch`` mapping),
    trimmed so that they divide ``batch``."""
    _check(rule_set)
    ruled = RULE_SETS[rule_set].get("batch") or ()
    if isinstance(ruled, str):
        ruled = (ruled,)
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in ruled if a in sizes)
    if batch is None:
        return axes
    return fit_axes(batch, axes, mesh)


def tp_axis(mesh) -> Optional[str]:
    return TP_AXIS if TP_AXIS in mesh_axes(mesh) else None


def mesh_rules(mesh, rule_set: str) -> dict:
    """The ``RULE_SETS`` entry restricted to axes that exist on ``mesh``."""
    _check(rule_set)
    sizes = mesh_axes(mesh)
    out = {}
    for name, axes in RULE_SETS[rule_set].items():
        if axes is None:
            out[name] = None
            continue
        if isinstance(axes, str):
            axes = (axes,)
        present = tuple(a for a in axes if a in sizes)
        out[name] = present if present else None
    return out


# ------------------------------------------------------------ public makers
def batch_spec(mesh, rule_set: str = "fsdp_tp",
               batch: Optional[int] = None) -> tuple:
    """Placement of a batch-leading tensor: dim 0 over the dp axes (JAX's
    ``batch_sharding``)."""
    axes = dp_axes(mesh, rule_set, batch)
    if not axes:
        return ()
    return (axes[0] if len(axes) == 1 else axes,)


def param_shapes(model) -> dict:
    """name -> shape of every parameter (a model built on the ``meta``
    device gives them without memory)."""
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def param_specs(model, mesh, rule_set: str = "fsdp_tp",
                shapes=None) -> dict:
    """name -> placement of every parameter of ``model`` (JAX's
    ``param_shardings``).  The ``heads`` / ``kv_heads`` axes label FUSED
    ``n_heads * d_head`` dims, so when the model config names an attention
    config, those rules are dropped unless its head count divides the
    mapped axes (the JAX package's head-granular fallback)."""
    shapes = param_shapes(model) if shapes is None else shapes
    rules = dict(mesh_rules(mesh, rule_set))
    sizes = mesh_axes(mesh)
    att = getattr(getattr(model, "cfg", None), "attention", None)
    if att is not None:
        for rule, n in (("heads", getattr(att, "n_heads", None)),
                        ("kv_heads", getattr(att, "n_kv_heads", None))):
            if n and rules.get(rule) and n % _product(rules[rule], sizes):
                rules[rule] = None
    return resolve_specs(shapes, model.specs(), rules, mesh)


def opt_specs(param_sp: dict) -> dict:
    """Placements of the AdamW state built over the parameters: each
    moment buffer is placed exactly as its parameter (JAX's
    ``opt_shardings``)."""
    return {k: dict(param_sp) for k in ("mu", "nu")}


def train_state_specs(model, mesh, rule_set: str, shapes=None):
    """(param placements, AdamW-moment placements, scalar placement): the
    whole train state (JAX's ``train_state_shardings``)."""
    psp = param_specs(model, mesh, rule_set, shapes)
    return psp, opt_specs(psp), ()


# ------------------------------------------------------------ local shards
def spec_axes(entry) -> tuple:
    """A placement entry -> the tuple of mesh axes it names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_index(axes: Sequence[str], coords: Mapping[str, int],
                sizes: Mapping[str, int]) -> tuple[int, int]:
    """(index, count) of this rank's shard along a dimension placed over
    ``axes``: row-major over the axes, outermost first."""
    idx, count = 0, 1
    for a in axes:
        idx = idx * sizes[a] + coords[a]
        count *= sizes[a]
    return idx, count


def local_slices(shape: Sequence[int], spec: tuple, mesh,
                 coords: Mapping[str, int], only=None) -> tuple:
    """The slices of a tensor of ``shape`` that the rank at mesh
    coordinates ``coords`` holds under ``spec``.  ``only``: keep only the
    dims placed over these mesh axes (e.g. ``{"model"}``)."""
    sizes = mesh_axes(mesh)
    out = []
    for d, n in enumerate(shape):
        axes = spec_axes(spec[d]) if d < len(spec) else ()
        if only is not None and not set(axes) <= set(only):
            axes = ()
        if not axes:
            out.append(slice(None))
            continue
        i, c = shard_index(axes, coords, sizes)
        w = n // c
        out.append(slice(i * w, (i + 1) * w))
    return tuple(out)


# --------------------------------------------------------- cache placements
# The logical axis of every dim of every serving-cache field (JAX's
# ``CACHE_AXES``): ``batch`` -> the rule set's data-parallel axes; ``seq``
# -> ``model`` only under ``seq_sharded``; ``kv_heads`` / ``mosa_heads`` ->
# what the rule set maps them to.  Unlike the parameters' fused dims, a
# cache head dim holds the literal head count, so plain divisibility is
# the guard.
CACHE_AXES: dict = {
    _kvc.DenseKVCache: {
        "k": ("batch", "seq", "kv_heads", None),
        "v": ("batch", "seq", "kv_heads", None),
        "length": ("batch",),
    },
    _kvc.WindowKVCache: {
        "k": ("batch", "seq", "kv_heads", None),
        "v": ("batch", "seq", "kv_heads", None),
        "positions": ("batch", "seq"),
        "length": ("batch",),
    },
    _kvc.MoSAKVCache: {
        "k": ("batch", "mosa_heads", None, None),
        "v": ("batch", "mosa_heads", None, None),
        "scores": ("batch", "mosa_heads", None),
        "idx": ("batch", "mosa_heads", None),
        "length": ("batch",),
    },
    _kvc.MoSABlockKVCache: {
        "k": ("batch", "mosa_heads", None, None),
        "v": ("batch", "mosa_heads", None, None),
        "pos": ("batch", "mosa_heads", None),
        "bscore": ("batch", "mosa_heads", None),
        "bidx": ("batch", "mosa_heads", None),
        "bsum": ("batch", "mosa_heads"),
        "length": ("batch",),
    },
}


def register_cache_axes(cache_type, table) -> None:
    """Add a cache family's logical-axis table (``serve.paged_kv`` registers
    the paged pools at import)."""
    CACHE_AXES[cache_type] = dict(table)


def _entry(axes):
    return axes[0] if len(axes) == 1 else tuple(axes)


def cache_spec(cache, mesh, rule_set: str = "fsdp_tp",
               seq_sharded: bool = False, stacked: bool = False):
    """The placement of every field of one typed cache (a cache NamedTuple
    of tensors, ``meta`` ones included), as a NamedTuple of the same type
    holding placement tuples.  ``stacked``: every dim shifted right by a
    leading, replicated layer axis (JAX's layer-stacked ``scan`` caches;
    the port's caches are a list per layer).  Divisibility-safe: a dim
    that the mapped axes do not divide is replicated; a mesh axis is used
    at most once per tensor, so under ``seq_sharded`` ``seq`` wins over the
    heads."""
    rules = mesh_rules(mesh, rule_set)
    dp = dp_axes(mesh, rule_set)
    tp = tp_axis(mesh)
    sizes = mesh_axes(mesh)
    table = CACHE_AXES[type(cache)]

    def one_field(leaf, names):
        shape = tuple(getattr(leaf, "shape", ()))
        off = 1 if stacked else 0
        spec = [None] * len(shape)
        used: set = set()
        for i, name in enumerate(names):
            d = off + i
            if name is None or d >= len(shape):
                continue
            dim = shape[d]
            if name == "batch":
                axes = fit_axes(dim, tuple(a for a in dp if a not in used),
                                mesh)
            elif name == "seq":
                axes = (tp,) if (seq_sharded and tp and tp not in used
                                 and dim > 0 and dim % sizes[tp] == 0) else ()
            else:
                axes = rules.get(name) or ()
                if isinstance(axes, str):
                    axes = (axes,)
                axes = tuple(a for a in axes if a not in used)
                total = _product(axes, sizes)
                if total == 0 or dim == 0 or dim % total:
                    axes = ()
            if axes:
                spec[d] = _entry(axes)
                used.update(axes)
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    return type(cache)(*(one_field(getattr(cache, f), table[f])
                         for f in cache._fields))


def cache_shardings(caches, mesh, rule_set: str = "fsdp_tp",
                    seq_sharded: bool = False):
    """Placements of a serving-cache tree (lists and dicts of caches, the
    port's one entry per layer): a typed cache through ``cache_spec``; any
    other tensor by JAX's positional fallback (dim 0 over the
    data-parallel axes that divide it, and under ``seq_sharded`` dim 1
    over ``model`` where it divides)."""
    dp = dp_axes(mesh, rule_set)
    tp = tp_axis(mesh)
    sizes = mesh_axes(mesh)

    def one(x):
        if isinstance(x, (list, tuple)) and type(x) not in CACHE_AXES:
            return type(x)(one(v) for v in x)
        if isinstance(x, Mapping):
            return {k: one(v) for k, v in x.items()}
        if type(x) in CACHE_AXES:
            return cache_spec(x, mesh, rule_set, seq_sharded)
        shape = tuple(getattr(x, "shape", ()))
        spec = [None] * len(shape)
        if shape:
            axes = fit_axes(shape[0], dp, mesh)
            if axes:
                spec[0] = _entry(axes)
        if seq_sharded and tp is not None and len(shape) > 1 \
                and shape[1] > 0 and shape[1] % sizes[tp] == 0:
            spec[1] = tp
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    return one(caches)
