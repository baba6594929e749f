"""The resumable training driver (port of ``repro.train.loop``).

data pipeline -> model and AdamW state on one device or a mesh -> train step
(microbatch accumulation, mixed precision, remat; ``train.step``) ->
checkpoint / restart -> preemption (SIGTERM -> checkpoint at the next step
boundary) -> router health in the step -> telemetry through ``obs``.

Resumability: a run killed at a step boundary and restarted from its
checkpoint replays the same loss curve bit for bit as an uninterrupted run
on the same device.  The data pipeline is step-indexed
(``Prefetcher(start_step=...)``), the AdamW moments travel with the
checkpoint, and the step counter rides in the manifest.  Checkpoints use
the JAX package's layout and keys (``convert.train_state_to_jax``), so
either package resumes the other's run.

Telemetry, as the JAX Trainer's: each step runs inside the
``train.step_time_s`` registry timer and a ``train_step`` span (track
``train``), whose scope holds the step's one host sync, so on the card
the measured time is the step's device work; ``_publish`` sets the
``train.*`` gauges and the ``train.router.*`` histograms, and
``obs.dump(metrics_path, trace_path, tag="trainer")`` writes the files
when ``run`` exits.

On a mesh, as the JAX Trainer: with ``mesh_shape`` set, or under
``torchrun`` with a world above 1 (then ``elastic_plan(world, tp=1)``),
the Trainer starts the process group (``launch.mesh``: NCCL on the card,
gloo only for ``device="cpu"``), builds a ``DeviceMesh`` with the axes
``("pod", "data", "model")[-len(shape):]``, places every parameter by
``rule_set`` (``dist.sharding.param_specs``: ``tp`` or ``fsdp_tp``) and
runs the sharded step (``dist.parallel``, ``train.step``): each rank
computes on its shards and its rows of the same global batch.  Weights,
whether from the seed, a checkpoint or the JAX package, are made full and
cut to the rank's shards; rank 0 writes checkpoints of full tensors
gathered from the shards, in the JAX layout.  Each rank beats its own
``Heartbeat(ckpt_dir, rank)``; a ``StragglerMonitor`` flags slow steps
(``[straggler]`` on the log line, its summary in ``straggler``); rank 0
prints.  The ranks agree on the step at which a preemption stops the run
(a max all-reduce of the flag at every step boundary), so a signal seen by
one rank leaves no other waiting in a collective.  Without a mesh (world
1, no ``mesh_shape``) there is no process group and the path is the
single-device one.

The trainer runs on the card unless ``TrainConfig.device`` says otherwise,
and raises without CUDA.  ``repro_torch.launch.train`` is the CLI face of
this module.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import convert, obs
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.data.pipeline import (PackedLMDataset, Prefetcher,
                                       SyntheticCorpus)
from repro_torch.dist import hints
from repro_torch.dist import sharding as shd
from repro_torch.dist.fault_tolerance import (Heartbeat, PreemptionHandler,
                                              StragglerMonitor, elastic_plan)
from repro_torch.dist.parallel import MeshContext, TrainShards, shard_model
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import resolve_device
from repro_torch.nn.transformer import TransformerLM
from repro_torch.optim import schedules
from repro_torch.optim.optimizer import adamw
from repro_torch.train.step import make_train_step, mixed_precision


@dataclasses.dataclass
class TrainConfig:
    arch: str = "mosa-paper"
    preset: str = "full"
    seq_len: int = 1024
    global_batch: int = 64
    steps: int = 100
    lr: float = 2.5e-4
    warmup: int = 400
    clip_norm: float = 0.25
    weight_decay: float = 0.0
    seed: int = 0
    rule_set: str = "tp"                 # tp | fsdp_tp, on a mesh
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 200
    keep_last: int = 3
    log_every: int = 10
    mesh_shape: Optional[tuple] = None   # None: elastic_plan(world, tp=1)
    arch_kwargs: dict = dataclasses.field(default_factory=dict)
    microbatch: int = 1                  # grad-accumulation splits per step
    compute: Optional[str] = None        # "bfloat16" -> bf16/fp32-master
    remat: Optional[str] = None          # none|full|dots_saveable|mosa
    mosa_impl: Optional[str] = None      # einsum | kernel
    router_health: bool = True           # log router telemetry
    health_in_step: bool = True          # health as train-step metrics
    metrics_path: Optional[str] = None   # obs snapshot on run() exit
    trace_path: Optional[str] = None     # Chrome-trace JSON on run() exit
    device: Optional[str] = None         # None = the card; "cpu" on request


def _apply_overrides(model_cfg: ModelConfig, cfg: TrainConfig) -> ModelConfig:
    if cfg.compute:
        model_cfg = mixed_precision(model_cfg, cfg.compute)
    if cfg.remat:
        model_cfg = dataclasses.replace(model_cfg, remat=cfg.remat)
    if cfg.mosa_impl and model_cfg.mosa is not None:
        model_cfg = dataclasses.replace(
            model_cfg,
            mosa=dataclasses.replace(model_cfg.mosa, impl=cfg.mosa_impl))
    return model_cfg


def _world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


class Trainer:
    def __init__(self, cfg: TrainConfig,
                 model_cfg: Optional[ModelConfig] = None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.model_cfg = _apply_overrides(
            model_cfg or get_config(cfg.arch, preset=cfg.preset,
                                    **cfg.arch_kwargs), cfg)
        self.mesh = self.ctx = self.shards = None
        self.rank = 0
        if cfg.mesh_shape is not None or _world_size() > 1:
            self._build_mesh()
        else:
            self.model = TransformerLM(self.model_cfg, device=self.device)
        self.optimizer = adamw(
            schedules.linear_warmup(cfg.lr, cfg.warmup),
            weight_decay=cfg.weight_decay, clip_norm=cfg.clip_norm,
            **({} if self.shards is None
               else {"grad_norm": self.shards.global_norm}))
        self._health_in_step = bool(cfg.router_health and cfg.health_in_step
                                    and self._has_router)
        self.train_step = make_train_step(self.model, self.optimizer,
                                          microbatches=cfg.microbatch,
                                          health=self._health_in_step,
                                          shards=self.shards)
        self.dataset = PackedLMDataset(
            SyntheticCorpus(vocab=self.model_cfg.vocab, seed=cfg.seed),
            seq_len=cfg.seq_len, global_batch=cfg.global_batch)
        self.monitor = StragglerMonitor()
        self.preempt: Optional[PreemptionHandler] = None

    def _build_mesh(self):
        """Process group, mesh, placements and this rank's shards (the
        model is built on ``meta`` and only its shards take memory)."""
        cfg = self.cfg
        self.device = mesh_lib.init_process_group(cfg.device)
        if cfg.mesh_shape is not None:
            shape = tuple(cfg.mesh_shape)
            axes = ("pod", "data", "model")[-len(shape):]
        else:
            plan = elastic_plan(dist.get_world_size(), tp=1)
            shape, axes = plan["shape"], plan["axes"]
        self.mesh = mesh_lib.make_mesh(shape, axes, self.device.type)
        self.ctx = MeshContext(self.mesh, cfg.rule_set)
        self.rank = self.ctx.rank
        self.model = TransformerLM(self.model_cfg, device="meta")
        self.specs = shd.param_specs(self.model, self.mesh, cfg.rule_set)
        shapes = shd.param_shapes(self.model)
        shard_model(self.model, self.ctx.tp, self.specs, self.ctx.coords,
                    self.ctx.sizes)
        self.model.to_empty(device=self.device)
        self.model.mesh = self.ctx
        self.shards = TrainShards(self.model, self.ctx, self.specs, shapes)

    # ------------------------------------------------------------------ state
    @torch.no_grad()
    def load_full(self, state: dict):
        """Load a full state_dict (the seed's, a checkpoint's or
        ``convert.params_from_jax``'s): on a mesh each rank keeps its
        shards.  Returns the at-rest parameters."""
        if self.shards is None:
            self.model.load_state_dict(state)
            return dict(self.model.named_parameters())
        for k, p in self.shards.working.items():
            p.copy_(self.shards.working_slice(k, state[k].to(p.device)))
        return self.shards.rest_params()

    def full_state(self, params, opt_state=None):
        """(full parameters, full AdamW moments or None) from the at-rest
        ones; on a mesh a collective over the world."""
        if self.shards is None:
            return params, opt_state
        full = {k: self.shards.full(k, v) for k, v in params.items()}
        if opt_state is None:
            return full, None
        return full, {m: {k: self.shards.full(k, v)
                          for k, v in opt_state[m].items()}
                      for m in ("mu", "nu")}

    def init_state(self):
        """Random weights from a ``torch.Generator`` seeded with ``seed``
        (on a mesh the full model's, cut to this rank's shards), zero AdamW
        moments, step 0."""
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        if self.shards is None:
            with torch.no_grad():
                self.model.init(gen)
            params = dict(self.model.named_parameters())
        else:
            full = TransformerLM(self.model_cfg, device=self.device)
            with torch.no_grad():
                full.init(gen)
            params = self.load_full(full.state_dict())
            del full
        return params, self.optimizer.init(params), 0

    def restore_or_init(self):
        """(params, opt_state, step, start) from the latest checkpoint in
        ``ckpt_dir``, or a fresh state."""
        cfg = self.cfg
        if cfg.ckpt_dir and ckpt_lib.latest_step(cfg.ckpt_dir) is not None:
            tree, extra = ckpt_lib.restore(cfg.ckpt_dir)
            state, opt = convert.train_state_from_jax(self.model_cfg, tree)
            params = self.load_full(state)
            if self.shards is None:
                opt_state = {m: {k: v.to(self.device)
                                 for k, v in opt[m].items()}
                             for m in ("mu", "nu")}
            else:
                opt_state = {m: {k: self.shards.local(k, v.to(self.device))
                                 for k, v in opt[m].items()}
                             for m in ("mu", "nu")}
            step = int(extra.get("step", 0))
            return params, opt_state, step, step
        params, opt_state, step = self.init_state()
        return params, opt_state, step, 0

    # -------------------------------------------------------------- telemetry
    @property
    def _has_router(self) -> bool:
        mc = self.model_cfg
        return (mc.mosa is not None and mc.sparse_variant == "mosa" and
                any(b.mixer == "mosa" for b in mc.resolved_pattern()))

    def router_health(self, batch):
        """Router health on ``batch`` by a standalone forward; {} when the
        model has no learned sparse router."""
        if not self._has_router:
            return {}
        if self.ctx is not None:        # this rank's rows
            batch = self.ctx.dp_rows(batch, 1)
        return {k: float(v)
                for k, v in self.model.router_health(batch["tokens"]).items()}

    def _publish(self, i: int, dt: float, metrics: dict) -> None:
        """Step telemetry through the obs registry, from the same
        already-synced floats as the history and the log line (no extra
        transfer).  ``train.step_time_s`` is observed by the step's timer
        scope, not here."""
        reg = obs.registry()
        if not reg.enabled:
            return
        reg.set("train.step", i)
        reg.set("train.tokens_per_s",
                metrics.get("tokens", 0.0) / max(dt, 1e-9))
        for k in ("loss", "ce", "ppl", "aux", "grad_norm"):
            if k in metrics:
                reg.set(f"train.{k}", metrics[k])
        for k in ("sel_entropy", "drop_rate", "head_util"):
            if k in metrics:
                reg.observe(f"train.router.{k}", metrics[k],
                            bounds=obs.UNIT_BOUNDS)

    def device_batch(self, batch):
        """A numpy batch as int64 tensors on the trainer's device."""
        return {k: torch.as_tensor(v).to(self.device, torch.long)
                for k, v in batch.items()}

    def _stop_requested(self) -> bool:
        """The preemption flag, agreed by every rank on a mesh (max)."""
        flag = bool(self.preempt and self.preempt.requested)
        if self.ctx is None:
            return flag
        t = torch.tensor([float(flag)], device=self.device)
        return bool(self.ctx.all_reduce(t, op=dist.ReduceOp.MAX).item())

    def _save(self, checkpointer, step, params, opt_state):
        """Rank 0 writes the full tensors (gathered from every rank's
        shards on a mesh) in the JAX layout."""
        full, full_opt = self.full_state(params, opt_state)
        if checkpointer is not None:
            checkpointer.save(
                step, convert.train_state_to_jax(self.model_cfg, full,
                                                 full_opt),
                extra_meta={"step": step, "model": self.model_cfg.name})

    # ------------------------------------------------------------------ train
    def run(self, steps: Optional[int] = None, install_signals: bool = True):
        cfg = self.cfg
        steps = steps if steps is not None else cfg.steps
        with hints.sharding_hints(mesh=self.mesh):
            params, opt_state, step, start = self.restore_or_init()
        self.preempt = PreemptionHandler() if install_signals else None
        checkpointer = (ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir,
                                                   cfg.keep_last)
                        if cfg.ckpt_dir and self.rank == 0 else None)
        hb = Heartbeat(cfg.ckpt_dir, rank=self.rank) if cfg.ckpt_dir else None
        prefetch = Prefetcher(self.dataset, start_step=start)
        history = []
        try:
            with hints.sharding_hints(mesh=self.mesh):
                for i in range(start, steps):
                    _, batch = prefetch.next()
                    batch = self.device_batch(batch)
                    with obs.registry().timer("train.step_time_s") as tm, \
                            obs.tracer().span("train_step", track="train",
                                              step=i):
                        params, opt_state, step, metrics = self.train_step(
                            params, opt_state, step, batch)
                        # the one host sync of the step, in the timed scope
                        metrics = {k: float(v) for k, v in metrics.items()}
                    dt = tm.dt
                    straggler = self.monitor.record(i, dt)
                    if hb:
                        hb.beat(i)
                    if i % cfg.log_every == 0 or i == steps - 1:
                        if cfg.router_health and not self._health_in_step:
                            metrics.update(self.router_health(batch))
                        history.append({"step": i, "dt": dt, **metrics})
                    self._publish(i, dt, metrics)
                    if self.rank == 0 and (i % cfg.log_every == 0
                                           or i == steps - 1):
                        health = (f" ent {metrics['sel_entropy']:.2f} "
                                  f"drop {metrics['drop_rate']:.2f}"
                                  if "sel_entropy" in metrics else "")
                        print(f"step {i:6d} loss {metrics['loss']:.4f} "
                              f"ppl {metrics['ppl']:.2f} "
                              f"gnorm {metrics['grad_norm']:.3f}"
                              f"{health} {dt*1e3:.0f}ms"
                              + (" [straggler]" if straggler else ""))
                    stop = self._stop_requested()
                    if cfg.ckpt_dir and ((i + 1) % cfg.ckpt_every == 0
                                         or i == steps - 1 or stop):
                        self._save(checkpointer, i + 1, params, opt_state)
                    if stop:
                        if self.rank == 0:
                            print(f"preemption requested; checkpointed at "
                                  f"{i+1}")
                        break
        finally:
            prefetch.close()
            if checkpointer:
                checkpointer.wait()
            if self.preempt:
                self.preempt.restore()
            obs.dump(cfg.metrics_path, cfg.trace_path, tag="trainer")
        return params, opt_state, history
