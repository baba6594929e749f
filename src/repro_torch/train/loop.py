"""The resumable training driver (port of ``repro.train.loop``).

data pipeline -> model and AdamW state on one device -> train step
(microbatch accumulation, mixed precision, remat; ``train.step``) ->
checkpoint / restart -> preemption (SIGTERM -> checkpoint at the next step
boundary) -> router health in the step.

Resumability: a run killed at a step boundary and restarted from its
checkpoint replays the same loss curve bit for bit as an uninterrupted run
on the same device.  The data pipeline is step-indexed
(``Prefetcher(start_step=...)``), the AdamW moments travel with the
checkpoint, and the step counter rides in the manifest.  Checkpoints use
the JAX package's layout and keys (``convert.train_state_to_jax``), so
either package resumes the other's run.

The trainer runs on the card unless ``TrainConfig.device`` says otherwise,
and raises without CUDA.  Left out for now (ROADMAP A): the mesh and
sharding rule sets, heartbeats and the straggler monitor, and the ``obs``
metrics/trace files (``metrics_path``/``trace_path`` raise).
``repro_torch.launch.train`` is the CLI face of this module.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.data.pipeline import (PackedLMDataset, Prefetcher,
                                       SyntheticCorpus)
from repro_torch.dist.fault_tolerance import PreemptionHandler
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
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 200
    keep_last: int = 3
    log_every: int = 10
    arch_kwargs: dict = dataclasses.field(default_factory=dict)
    microbatch: int = 1                  # grad-accumulation splits per step
    compute: Optional[str] = None        # "bfloat16" -> bf16/fp32-master
    remat: Optional[str] = None          # none | full
    mosa_impl: Optional[str] = None      # einsum | kernel
    router_health: bool = True           # log router telemetry
    health_in_step: bool = True          # health as train-step metrics
    metrics_path: Optional[str] = None   # not ported yet (raises)
    trace_path: Optional[str] = None     # not ported yet (raises)
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


class Trainer:
    def __init__(self, cfg: TrainConfig,
                 model_cfg: Optional[ModelConfig] = None):
        if cfg.metrics_path or cfg.trace_path:
            raise NotImplementedError("metrics_path/trace_path need the obs "
                                      "copy (ROADMAP A), not ported yet")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.model_cfg = _apply_overrides(
            model_cfg or get_config(cfg.arch, preset=cfg.preset,
                                    **cfg.arch_kwargs), cfg)
        self.model = TransformerLM(self.model_cfg, device=self.device)
        self.optimizer = adamw(
            schedules.linear_warmup(cfg.lr, cfg.warmup),
            weight_decay=cfg.weight_decay, clip_norm=cfg.clip_norm)
        self._health_in_step = bool(cfg.router_health and cfg.health_in_step
                                    and self._has_router)
        self.train_step = make_train_step(self.model, self.optimizer,
                                          microbatches=cfg.microbatch,
                                          health=self._health_in_step)
        self.dataset = PackedLMDataset(
            SyntheticCorpus(vocab=self.model_cfg.vocab, seed=cfg.seed),
            seq_len=cfg.seq_len, global_batch=cfg.global_batch)
        self.preempt: Optional[PreemptionHandler] = None

    # ------------------------------------------------------------------ state
    def init_state(self):
        """Random weights from a ``torch.Generator`` seeded with ``seed``,
        zero AdamW moments, step 0."""
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        with torch.no_grad():
            self.model.init(gen)
        params = dict(self.model.named_parameters())
        return params, self.optimizer.init(params), 0

    def restore_or_init(self):
        """(params, opt_state, step, start) from the latest checkpoint in
        ``ckpt_dir``, or a fresh state."""
        cfg = self.cfg
        if cfg.ckpt_dir and ckpt_lib.latest_step(cfg.ckpt_dir) is not None:
            tree, extra = ckpt_lib.restore(cfg.ckpt_dir)
            state, opt = convert.train_state_from_jax(self.model_cfg, tree)
            self.model.load_state_dict(state)
            params = dict(self.model.named_parameters())
            opt_state = {m: {k: v.to(self.device) for k, v in opt[m].items()}
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
        return {k: float(v)
                for k, v in self.model.router_health(batch["tokens"]).items()}

    def device_batch(self, batch):
        """A numpy batch as int64 tensors on the trainer's device."""
        return {k: torch.as_tensor(v).to(self.device, torch.long)
                for k, v in batch.items()}

    # ------------------------------------------------------------------ train
    def run(self, steps: Optional[int] = None, install_signals: bool = True):
        cfg = self.cfg
        steps = steps if steps is not None else cfg.steps
        params, opt_state, step, start = self.restore_or_init()
        self.preempt = PreemptionHandler() if install_signals else None
        checkpointer = (ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir,
                                                   cfg.keep_last)
                        if cfg.ckpt_dir else None)
        prefetch = Prefetcher(self.dataset, start_step=start)
        history = []
        try:
            for i in range(start, steps):
                _, batch = prefetch.next()
                batch = self.device_batch(batch)
                t0 = time.perf_counter()
                params, opt_state, step, metrics = self.train_step(
                    params, opt_state, step, batch)
                # the one host sync of the step
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                if i % cfg.log_every == 0 or i == steps - 1:
                    if cfg.router_health and not self._health_in_step:
                        metrics.update(self.router_health(batch))
                    history.append({"step": i, "dt": dt, **metrics})
                    health = (f" ent {metrics['sel_entropy']:.2f} "
                              f"drop {metrics['drop_rate']:.2f}"
                              if "sel_entropy" in metrics else "")
                    print(f"step {i:6d} loss {metrics['loss']:.4f} "
                          f"ppl {metrics['ppl']:.2f} "
                          f"gnorm {metrics['grad_norm']:.3f}"
                          f"{health} {dt*1e3:.0f}ms")
                want_ckpt = checkpointer and (
                    (i + 1) % cfg.ckpt_every == 0 or i == steps - 1 or
                    (self.preempt and self.preempt.requested))
                if want_ckpt:
                    checkpointer.save(
                        i + 1, convert.train_state_to_jax(
                            self.model_cfg, params, opt_state),
                        extra_meta={"step": i + 1,
                                    "model": self.model_cfg.name})
                if self.preempt and self.preempt.requested:
                    print(f"preemption requested; checkpointed at {i+1}")
                    break
        finally:
            prefetch.close()
            if checkpointer:
                checkpointer.wait()
            if self.preempt:
                self.preempt.restore()
        return params, opt_state, history
