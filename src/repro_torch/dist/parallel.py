"""The model and its train state on a device mesh: tensor parallelism over
``model``, data parallelism (and, under ``fsdp_tp``, sharded weights) over
the data-parallel axes.  SPMD: one process per device, every process runs
this same code on its own shards.

``MeshContext(mesh, rule_set)`` holds the process groups of a
``torch.distributed`` ``DeviceMesh`` (``repro_torch.launch.mesh``):
``tp`` (the ``model`` axis), ``dp`` (the data-parallel axes, flattened
outer to inner) and the world.  ``shard_model(model, ctx, specs)`` cuts
every parameter down to the rows or columns that this rank's ``model``
coordinate holds under ``specs`` (``dist.sharding.param_specs``) and tells
each module what it holds:

  * ``Embedding`` / the unembedding ``Linear`` — a slice of the vocabulary
    (``vocab_range``): the lookup masks the ids outside it and sums over
    ``model``; the loss takes the logsumexp and the gold logit across the
    slices (``TransformerLM.loss``), so the logits are never gathered;
  * ``MLP`` — column-parallel input, row-parallel output;
  * ``MultiHeadAttention`` — its columns of the fused heads (``q_cols``,
    ``kv_cols``): whole heads compute locally; a slice that cuts a head
    all-gathers the columns of the heads it needs; replicated kv heads are
    picked per local q group;
  * ``HybridAttention`` — which of its sides are head-sharded; a rank adds
    the output of its own heads, one all-reduce sums the layer, and a
    replicated side is added once, after it.

Both attention modules also learn the ``model`` group whatever their
weights' placement (``mesh_tp``): serving follows the caches' placements,
so replicated dense weights still serve a head-sharded cache by its
heads.

The modules then compute on plain local tensors (the kernels never see a
``DTensor``) and meet their peers only through ``copy_to`` (identity
forward, all-reduce backward), ``reduce_from`` (all-reduce forward,
identity backward) and ``gather_last`` (all-gather forward, all-reduce and
slice backward), Megatron's conjugate pair plus a gather.

Serving (``local_caches``): each rank builds its caches at their local
shapes from ``dist.sharding.cache_spec`` — its rows of the batch under
dp, its heads under ``model``, its slice of the positions of a
``seq_sharded`` contiguous cache — as fresh tensors (the kernels want
contiguous pools), not views of a full cache.

The train state (``TrainShards``): each parameter's at-rest shard is its
TP-local tensor, further cut along the dimension that the rule set places
over the dp axes (``fsdp_tp``'s ``embed``); the AdamW moments are placed as
their parameter.  ``gather_weights`` all-gathers the step's working
weights once per step, ``reduce_grads`` sums the gradients over dp
(all-reduce, then each rank keeps its shard) and averages those of
parameters replicated over ``model`` so that the replicas never drift
apart; ``global_norm`` is the norm of the full tensors, each counted once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.dist import sharding as shd


# ------------------------------------------------------------ collectives
@dataclasses.dataclass
class TensorParallel:
    """A module's tensor-parallel peers: the ``model`` group, this rank's
    index in it and its size.  ``group=None`` with ``size > 1`` runs one
    shard's local compute alone (no collective may be reached)."""

    group: Optional[object]
    rank: int
    size: int


def _all_reduce(t, group, op=dist.ReduceOp.SUM):
    dist.all_reduce(t, op=op, group=group)
    return t


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.rank, ctx.w = group, rank, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g.contiguous().clone(), ctx.group)
        w = ctx.w
        return g[..., ctx.rank * w:(ctx.rank + 1) * w].contiguous(), \
            None, None, None


def tp_all_reduce(t, tp: TensorParallel, op: str = "sum"):
    """In-place all-reduce of ``t`` over ``model`` (``op``: ``"sum"`` or
    ``"max"``); returns ``t``."""
    return _all_reduce(t, tp.group, {"sum": dist.ReduceOp.SUM,
                                     "max": dist.ReduceOp.MAX}[op])


def copy_to(x, tp: Optional[TensorParallel]):
    """Enter a tensor-parallel region: identity forward; the backward sums
    the ranks' partial gradients over ``model``."""
    return x if tp is None else _CopyTo.apply(x, tp.group)


def reduce_from(x, tp: Optional[TensorParallel]):
    """Leave a tensor-parallel region: sum the ranks' partial outputs over
    ``model``; identity backward."""
    return x if tp is None else _ReduceFrom.apply(x, tp.group)


def gather_last(x, tp: TensorParallel):
    """All-gather the last dim over ``model`` (rank order); the backward
    sums the gradient over the ranks and keeps this rank's columns."""
    return _GatherLast.apply(x, tp.group, tp.rank, tp.size)


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` of the last dim across the vocabulary slices of
    ``model``: the same operations (the max, the shifted sum of exps, its
    log), with the max and the sum taken over the ranks, and the same
    backward (``grad * exp(logits - lse)``), so that a one-rank group
    gives ``torch.logsumexp``'s bits."""

    @staticmethod
    def forward(ctx, x, group):
        m = _all_reduce(x.amax(-1, keepdim=True), group, dist.ReduceOp.MAX)
        m.masked_fill_(m.abs() == float("inf"), 0.0)
        out = _all_reduce((x - m).exp_().sum(-1), group)
        out = out.log_().add_(m[..., 0])
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g[..., None] * (x - out[..., None]).exp(), None


def logsumexp(x, tp: Optional[TensorParallel]):
    """The logsumexp of the last dim of the full tensor whose slice over
    ``model`` this rank holds (``torch.logsumexp`` off a mesh)."""
    if tp is None:
        return torch.logsumexp(x, -1)
    return _LogSumExp.apply(x, tp.group)


# ------------------------------------------------------------------ mesh
class MeshContext:
    """The groups of a ``DeviceMesh`` under a rule set: ``tp`` over
    ``model``, ``dp`` over the rule set's data-parallel axes (one group,
    outer to inner), ``world``; this rank's coordinates."""

    def __init__(self, mesh, rule_set: str = "tp"):
        shd.mesh_rules(mesh, rule_set)          # KeyError on an unknown one
        self.mesh, self.rule_set = mesh, rule_set
        self.sizes = shd.mesh_axes(mesh)
        self.coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self._groups = {}
        tp = shd.tp_axis(mesh)
        self.tp = (TensorParallel(self.group((tp,)), self.coords[tp],
                                  self.sizes[tp]) if tp else None)
        self.dp_axes = shd.dp_axes(mesh, rule_set)
        self.dp_group = self.group(self.dp_axes)
        self.dp_rank, self.dp_size = shd.shard_index(self.dp_axes,
                                                     self.coords, self.sizes)

    def group(self, axes: tuple):
        """The process group over mesh ``axes`` that holds this rank
        (created collectively on first use: every rank must ask for the
        same groups in the same order)."""
        axes = tuple(axes)
        if not axes:
            return None
        if axes not in self._groups:
            if len(axes) == 1:
                self._groups[axes] = self.mesh.get_group(axes[0])
            else:
                names = list(self.mesh.mesh_dim_names)
                keep = [names.index(a) for a in axes]
                rest = [i for i in range(len(names)) if i not in keep]
                ranks = self.mesh.mesh.permute(*rest, *keep).reshape(
                    -1, shd._product(axes, self.sizes))
                self._groups[axes], _ = dist.new_subgroups_by_enumeration(
                    [r.tolist() for r in ranks])
        return self._groups[axes]

    def all_reduce(self, t, axes=None, op=dist.ReduceOp.SUM):
        """In-place all-reduce over ``axes`` (default the world)."""
        group = None if axes is None else self.group(tuple(axes))
        if axes is not None and group is None:
            return t
        return _all_reduce(t, group, op)

    def dp_rows(self, batch: dict, microbatches: int) -> dict:
        """This rank's rows of a global batch: each of the ``microbatches``
        consecutive microbatches is split over dp, so that the ranks' i-th
        local microbatches make up the global i-th microbatch."""
        out = {}
        m, n = microbatches, self.dp_size
        for k, x in batch.items():
            if x.shape[0] % (m * n):
                raise ValueError(
                    f"global batch {x.shape[0]} of {k!r} is not divisible "
                    f"by {m} microbatches x {n} data-parallel ranks")
            rows = x.reshape(m, n, x.shape[0] // (m * n), *x.shape[1:])
            out[k] = rows[:, self.dp_rank].reshape(-1, *x.shape[1:])
        return out


# ------------------------------------------------------- model sharding
def _model_slice(shape, spec, ctx_or_sizes, coords):
    return shd.local_slices(shape, spec, ctx_or_sizes, coords,
                            only={shd.TP_AXIS})


def _cols(spec, dim, size, tp):
    """(start, stop) of this rank's slice of dim ``dim`` if it is placed
    over ``model``, else None."""
    axes = shd.spec_axes(spec[dim]) if dim < len(spec) else ()
    if shd.TP_AXIS not in axes:
        return None
    w = size // tp.size
    return tp.rank * w, (tp.rank + 1) * w


def _head_sharded(module, specs, prefix):
    """Whether the head-stacked parameters of a MoSA or baseline module
    (leading dim ``mosa_heads``) are sharded over ``model``."""
    name = next(n for n, _ in module.named_parameters())
    spec = specs[f"{prefix}{name}"]
    return bool(spec) and shd.TP_AXIS in shd.spec_axes(spec[0])


def shard_model(model, tp: Optional[TensorParallel], specs: dict,
                coords: Optional[dict] = None, sizes: Optional[dict] = None):
    """Cut ``model``'s parameters (built full, e.g. from a full state) to
    this rank's ``model`` slices under ``specs`` (name -> placement) and set
    the modules' tensor-parallel attributes (see the module docstring).
    ``coords`` / ``sizes``: the mesh coordinate and axis sizes (default a
    mesh of the ``model`` axis alone at ``tp.rank``).  Returns ``model``."""
    from repro_torch.core.attention import MultiHeadAttention
    from repro_torch.core.hybrid import HybridAttention
    from repro_torch.nn.ffn import MLP
    from repro_torch.nn.layers import Embedding, Linear

    if tp is None:
        return model
    coords = coords or {shd.TP_AXIS: tp.rank}
    sizes = sizes or {shd.TP_AXIS: tp.size}
    for mod_name, mod in model.named_modules():
        pre = f"{mod_name}." if mod_name else ""
        full = {n: tuple(p.shape) for n, p in mod.named_parameters(
            recurse=False)}
        if isinstance(mod, Embedding):
            mod.vocab_range = _cols(specs[pre + "table"], 0,
                                    full["table"][0], tp)
            mod.tp = tp if mod.vocab_range else None
        elif isinstance(mod, Linear) and mod.out_axis == "vocab":
            mod.vocab_range = _cols(specs[pre + "w"], 1, full["w"][1], tp)
            mod.tp = tp if mod.vocab_range else None
        elif isinstance(mod, MLP):
            first = "w_gate" if mod.act == "swiglu" else "w_in"
            mod.tp = tp if _cols(specs[pre + first], 1, full[first][1],
                                 tp) else None
        elif isinstance(mod, MultiHeadAttention):
            mod.q_cols = _cols(specs[pre + "wq"], 1, full["wq"][1], tp)
            mod.kv_cols = _cols(specs[pre + "wk"], 1, full["wk"][1], tp)
            mod.tp = tp if mod.q_cols else None
            mod.mesh_tp = tp
        elif isinstance(mod, HybridAttention):
            mod.mesh_tp = tp
            mod.sparse_sharded = _head_sharded(mod.sparse, specs,
                                               f"{pre}sparse.")
            dense_sharded = mod.dense is not None and _cols(
                specs[f"{pre}dense.wq"], 1, mod.dense.wq.shape[1], tp)
            mod.tp = tp if mod.sparse_sharded or dense_sharded else None
        for n, shape in full.items():
            sl = _model_slice(shape, specs[pre + n], sizes, coords)
            p = getattr(mod, n)
            if any(s != slice(None) for s in sl):
                setattr(mod, n, nn.Parameter(p.detach()[sl].clone(),
                                             requires_grad=p.requires_grad))
    return model


# ------------------------------------------------------------ train state
@dataclasses.dataclass
class ParamShard:
    """One parameter on the mesh: its full shape and placement, the dim
    that the dp axes shard at rest (None: replicated over dp), and whether
    it is replicated over ``model``."""

    name: str
    full_shape: tuple
    spec: tuple
    dp_dim: Optional[int]
    tp_replicated: bool
    n_shards: int                        # distinct at-rest shards


class TrainShards:
    """The train state of a sharded model (see the module docstring)."""

    def __init__(self, model, ctx: MeshContext, specs: dict, full_shapes):
        self.model, self.ctx, self.specs = model, ctx, specs
        self.shards = {}
        dp = set(ctx.dp_axes)
        for name, shape in full_shapes.items():
            spec = specs[name]
            dp_dim = next((d for d, e in enumerate(spec)
                           if e is not None and set(shd.spec_axes(e)) <= dp
                           and shd.spec_axes(e)), None)
            named = {a for e in spec for a in shd.spec_axes(e)}
            self.shards[name] = ParamShard(
                name, tuple(shape), spec, dp_dim,
                shd.TP_AXIS not in named,
                shd._product(named, ctx.sizes))
        self.working = dict(model.named_parameters())

    # -- at rest
    def _dp_slice(self, t, s: ParamShard):
        if s.dp_dim is None:
            return t
        w = t.shape[s.dp_dim] // self.ctx.dp_size
        return t.narrow(s.dp_dim, self.ctx.dp_rank * w, w)

    def rest_params(self) -> dict:
        """The at-rest parameters: the working tensors themselves where
        nothing is dp-sharded, else fresh copies of this rank's shard."""
        return {k: (p if self.shards[k].dp_dim is None else
                    nn.Parameter(self._dp_slice(p.detach(),
                                                self.shards[k]).clone(),
                                 requires_grad=False))
                for k, p in self.working.items()}

    @torch.no_grad()
    def gather_weights(self, rest: dict) -> None:
        """All-gather the dp-sharded parameters into the working weights."""
        g = self.ctx.dp_group
        for k, s in self.shards.items():
            if s.dp_dim is None:
                continue
            parts = [torch.empty_like(rest[k]) for _ in range(
                self.ctx.dp_size)]
            dist.all_gather(parts, rest[k].contiguous(), group=g)
            self.working[k].copy_(torch.cat(parts, s.dp_dim))

    @torch.no_grad()
    def reduce_grads(self, grads: dict) -> dict:
        """Sum the working gradients over dp and keep this rank's shard;
        average those of ``model``-replicated parameters over ``model``."""
        out = {}
        tp = self.ctx.tp
        for k, g in grads.items():
            s = self.shards[k]
            g = self.ctx.all_reduce(g.contiguous(), self.ctx.dp_axes)
            if s.tp_replicated and tp is not None and tp.size > 1:
                g = _all_reduce(g, tp.group).div_(tp.size)
            out[k] = self._dp_slice(g, s).contiguous()
        return out

    def global_norm(self, tree: dict) -> torch.Tensor:
        """The norm of the full tensors whose at-rest shards ``tree``
        holds: each shard's sum of squares, weighted by the share of the
        world that holds the same shard, summed over the world."""
        total = sum(x.float().square().sum() * (
            self.shards[k].n_shards / self.ctx.world)
            for k, x in tree.items())
        return torch.sqrt(self.ctx.all_reduce(total))

    # -- full tensors (checkpoints, weights from elsewhere)
    @torch.no_grad()
    def full(self, k: str, rest_tensor) -> torch.Tensor:
        """The full tensor of parameter ``k`` (or of a state placed as it)
        from this rank's at-rest shard, a new tensor; collective over the
        ranks that hold its other shards."""
        s = self.shards[k]
        t = rest_tensor.detach().clone()
        for d, e in enumerate(s.spec):
            axes = shd.spec_axes(e)
            if not axes:
                continue
            n = shd._product(axes, self.ctx.sizes)
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=self.ctx.group(axes))
            t = torch.cat(parts, d).contiguous()
        return t

    def working_slice(self, k: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's working (``model``-sliced, dp-whole) part of the
        full tensor of parameter ``k``."""
        s = self.shards[k]
        return full[_model_slice(s.full_shape, s.spec, self.ctx.sizes,
                                 self.ctx.coords)]

    def local(self, k: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's at-rest shard of the full tensor of parameter
        ``k``."""
        s = self.shards[k]
        sl = shd.local_slices(s.full_shape, s.spec, self.ctx.sizes,
                              self.ctx.coords)
        return full[sl].contiguous()


# ---------------------------------------------------------- serving caches
# What an empty cache holds in each field (the caches' ``create``); the
# block tables of the paged pools are built apart.
_EMPTY = {"k": 0, "v": 0, "length": 0, "positions": -1, "scores": -math.inf,
          "idx": -1, "pos": -1, "bscore": -math.inf, "bidx": -1, "bsum": 0}


def local_caches(caches, mesh, rule_set: str = "tp",
                 seq_sharded: bool = False, paged=None, device=None):
    """This rank's empty serving caches: ``caches`` is the whole tree at
    full shapes (built on ``meta``: a list per layer of caches and dicts
    of caches), placed by ``cache_shardings``; every dim placed over mesh
    axes keeps its share — the batch rows under dp, the heads under
    ``model``, the positions of a ``seq_sharded`` contiguous cache.

    A paged pool stays whole (its block dim is replicated), except with
    identity tables (``paged.num_blocks == 0``, resp.
    ``num_window_blocks``: ``Server.generate``'s auto-sized pools), where
    a rank's pool holds its own rows' chains alone, numbered from 0.  (The
    JAX package replicates that pool over dp too; the rows and their
    results are the same.)"""
    specs = shd.cache_shardings(caches, mesh, rule_set, seq_sharded)
    sizes = shd.mesh_axes(mesh)

    def shape_of(t, spec):
        return tuple(n // shd._product(
            shd.spec_axes(spec[d]) if d < len(spec) else (), sizes)
            for d, n in enumerate(t.shape))

    def one(c, sp):
        if isinstance(c, dict):
            return {k: one(c[k], sp[k]) for k in c}
        if isinstance(c, list):
            return [one(x, y) for x, y in zip(c, sp)]
        f = {name: shape_of(t, s) for name, t, s in zip(c._fields, c, sp)}
        table = f.pop("block_table", None)
        ids = None
        if table is not None:
            window = "positions" in f
            identity = paged is not None and (
                paged.num_window_blocks if window else paged.num_blocks) == 0
            if identity:
                n = table[0] * table[1]
                ids = torch.arange(n, dtype=torch.int32,
                                   device=device).reshape(table)
                f["k"] = f["v"] = (n,) + f["k"][1:]
            else:
                ids = torch.full(table, -1, dtype=torch.int32, device=device)
        out = {name: torch.full(shape, _EMPTY[name],
                                dtype=getattr(c, name).dtype, device=device)
               for name, shape in f.items()}
        if ids is not None:
            out["block_table"] = ids
        return type(c)(**out)

    return one(caches, specs)
