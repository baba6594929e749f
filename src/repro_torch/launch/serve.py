"""Serving entry points (port of ``Server`` and the CLI of
``repro.launch.serve``).

``Server(cfg, ...)`` holds a ``TransformerLM`` on one device (the card by
default) and serves whole batches: ``generate`` runs one prefill over the
prompts and then ``gen_len - 1`` decode steps, greedy by default.  With
``paged=PagedConfig(...)`` the dense heads keep their KV in block-paged
pools (window rings in ``PagedWindowKVCache`` pools for sliding-window
heads); the MoSA heads keep their O(k) streaming cache.  Auto-sized pools
(``num_blocks == 0``) give identity block tables for ``generate``; an
explicit budget leaves the tables unallocated for
``repro_torch.serve.scheduler.Scheduler``, which drives the per-row ops:
``prefill_packed`` (packed chunked prefill), ``decode_many``,
``snapshot_row`` / ``restore_row`` and ``grow_tables``.

The caches are written IN PLACE and every cache op runs under
``torch.inference_mode()`` (a tensor made there refuses in-place writes
outside it).  A row snapshot is a host copy, never a view of the device
caches.

CLI (the card unless ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.serve --preset smoke \\
      --variant mosa --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --preset smoke \\
      --variant mosa --load-rate 4 --load-n 16
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.kv_cache import MoSABlockKVCache, MoSAKVCache
from repro_torch.nn.transformer import TransformerLM, sample_logits
from repro_torch.serve.paged_kv import PagedConfig, PagedDenseKVCache


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raises when CUDA is absent rather than
    falling back to the CPU (pass ``device="cpu"`` for that)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        device = "cuda"
    return torch.device(device)


# ---------------------------------------------------- batch-row cache ops
# The caches are a list with one entry per layer: a ``PagedDenseKVCache``
# (attention layers) or a dict {"sparse": MoSAKVCache or MoSABlockKVCache,
# "dense": PagedDenseKVCache} (MoSA hybrid layers).  The row ops raise for
# window rings (their Scheduler support is not ported yet).  The pools of a paged
# cache are shared by every row and stay behind block ids; its block table
# and length are per row.  A MoSA cache is per row in every field.

def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _map_layers(fn, caches, *others):
    """Apply ``fn(cache, *other)`` to every cache object of the layer list,
    recursing through the hybrid layers' dicts."""
    def one(c, *o):
        if isinstance(c, dict):
            return {k: one(c[k], *(x[k] for x in o)) for k in c}
        return fn(c, *o)
    return [one(c, *o) for c, *o in zip(caches, *others)]


def row_snapshot(caches, b: int):
    """Host-restorable state of row ``b``: the paged caches' block table and
    length, and the whole row of every MoSA cache (bounded by its k).  The
    dense KV itself stays behind block ids."""
    def one(c):
        if isinstance(c, PagedDenseKVCache):
            return {"block_table": _host(c.block_table[b]),
                    "length": _host(c.length[b])}
        if isinstance(c, (MoSAKVCache, MoSABlockKVCache)):
            return type(c)(*(_host(f[b:b + 1]) for f in c))
        raise NotImplementedError(f"row ops of {type(c).__name__} are not "
                                  "ported")
    return _map_layers(one, caches)


def row_restore(caches, snap, b: int):
    """Write a ``row_snapshot`` back at row ``b`` in place (admission reset,
    prefix restore, preempt-resume); returns ``caches``."""
    def one(c, s):
        if isinstance(c, PagedDenseKVCache):
            c.block_table[b] = torch.as_tensor(s["block_table"]).to(
                c.block_table.device, c.block_table.dtype)
            c.length[b] = torch.as_tensor(s["length"]).to(
                c.length.device, c.length.dtype)
        else:
            for f, sf in zip(c, s):
                f[b:b + 1] = sf.to(f.device, f.dtype)
        return c
    _map_layers(one, caches, snap)
    return caches


def set_dense_tables(caches, dense_row, b: int):
    """Point row ``b``'s dense block tables (every paged dense layer shares
    one logical chain) at ``dense_row``, in place — the decode-time growth
    write; returns ``caches``."""
    row = torch.as_tensor(dense_row)

    def one(c):
        if isinstance(c, PagedDenseKVCache):
            c.block_table[b] = row.to(c.block_table.device,
                                      c.block_table.dtype)
        return c
    _map_layers(one, caches)
    return caches


class Server:
    def __init__(self, model_cfg, max_len: int = 256, batch: int = 4,
                 params: Optional[dict] = None,
                 paged: Optional[PagedConfig] = None, device=None,
                 seed: int = 0):
        """``params``: a ``state_dict`` for ``TransformerLM`` (e.g. from
        ``repro_torch.convert.params_from_jax``); ``None`` draws random
        weights from ``torch.Generator`` seeded with ``seed``."""
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.max_len = max_len
        self.batch = batch
        self.paged = paged
        with torch.no_grad():
            self.model = TransformerLM(model_cfg, device=self.device)
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                self.model.init(gen)
            else:
                self.model.load_state_dict(params)
        self.model.eval()

    @torch.inference_mode()
    def new_cache(self, batch: Optional[int] = None):
        batch = self.batch if batch is None else batch
        paged = self.paged if batch == self.batch else None
        return self.model.init_cache(batch, self.max_len, paged=paged,
                                     device=self.device)

    # ------------------------------------------------ the Scheduler's ops
    @torch.inference_mode()
    def prefill_packed(self, tokens, caches, cu_seqlens, rows, past_lens):
        """One packed prefill chunk (``TransformerLM.prefill_packed``):
        tokens (1, C); returns (logits (N, V), caches)."""
        reg = obs.registry()
        if reg.enabled:
            reg.inc("server.prefill_dispatches")
            reg.set("server.prefill_tokens", tokens.shape[-1])
        return self.model.prefill_packed(tokens.to(self.device), caches,
                                         cu_seqlens, rows, past_lens)

    @torch.inference_mode()
    def decode_many(self, tok, caches, generator=None, n: int = 1,
                    temperature: float = 0.0, top_k: int = 0):
        """``n`` decode steps of every row with sampling on the device;
        tok (B, 1).  Returns (tokens (B, n), caches)."""
        reg = obs.registry()
        if reg.enabled:       # dispatch counters only — no device sync
            reg.inc("server.decode_dispatches")
            reg.inc("server.decode_steps", n)
            reg.set("server.decode_batch", tok.shape[0])
        return self.model.decode_many(tok, caches, generator, n, temperature,
                                      top_k)

    @torch.inference_mode()
    def sample(self, logits, generator=None, temperature: float = 0.0,
               top_k: int = 0):
        return sample_logits(logits, generator, temperature, top_k)

    @torch.inference_mode()
    def snapshot_row(self, caches, b: int):
        return row_snapshot(caches, b)

    @torch.inference_mode()
    def restore_row(self, caches, snap, b: int):
        return row_restore(caches, snap, b)

    @torch.inference_mode()
    def grow_tables(self, caches, dense_row, b: int):
        return set_dense_tables(caches, dense_row, b)

    # ------------------------------------------------------ batch serving
    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, gen_len: int,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 top_k: int = 0):
        """prompts: (B, P) integer -> ((B, gen_len) int64, caches).  One
        prefill, then ``gen_len - 1`` decode steps; greedy when
        ``temperature == 0``."""
        B, P = prompts.shape
        if B != self.batch:
            raise ValueError(f"batch {B} != server batch {self.batch}")
        if self.paged is not None and (self.paged.num_blocks
                                       or self.paged.num_window_blocks):
            raise ValueError("generate needs auto-sized paged pools "
                             "(identity block tables); budgeted pools are "
                             "managed by repro_torch.serve.scheduler")
        if P + gen_len - 1 > self.max_len:
            raise ValueError(f"prompt ({P}) + {gen_len - 1} decode steps "
                             f"exceeds max_len {self.max_len}")
        prompts = prompts.to(self.device)
        caches = self.new_cache()
        logits, caches = self.model.prefill(prompts, caches)
        tok0 = sample_logits(logits[:, -1], generator, temperature, top_k)
        toks, caches = self.decode_many(tok0[:, None], caches, generator,
                                        gen_len - 1, temperature, top_k)
        return torch.cat([tok0[:, None], toks], dim=1), caches


# -------------------------------------------------------------------- CLI
def _load_run(cfg, args, device):
    """``--load-rate``: seeded open-loop traffic through the timed paged
    Scheduler; the SLO/goodput summary goes to stdout as JSON."""
    from repro_torch.obs.slo import SLOSpec, evaluate
    from repro_torch.serve.loadgen import (OpenLoopSource, bursty_workload,
                                           poisson_workload)
    from repro_torch.serve.scheduler import Scheduler

    nb = -(-args.max_len // 16)
    server = Server(cfg, batch=args.batch, max_len=args.max_len,
                    paged=PagedConfig(block_size=16,
                                      num_blocks=args.batch * nb),
                    device=device)
    build = bursty_workload if args.bursty else poisson_workload
    wl = build(args.load_rate, args.load_n, args.load_seed, cfg.vocab)
    sched = Scheduler(server, max_queue=args.max_queue or None,
                      metrics_path=args.metrics_path,
                      trace_path=args.trace_path,
                      temperature=args.temperature, top_k=args.top_k)
    t0 = time.perf_counter()
    sched.run(max_steps=100_000, source=OpenLoopSource(wl))
    dt = time.perf_counter() - t0
    spec = SLOSpec(ttft_s=args.ttft_slo, tpot_s=args.tpot_slo or None)
    ev = evaluate(list(sched.records.values()), spec)
    ev["offered_req_s"] = args.load_rate
    ev["duration_s"] = round(dt, 3)
    ev["device"] = str(server.device)
    print(json.dumps(ev, indent=2, sort_keys=True))


def main(argv=None):
    from repro_torch.configs.base import get_config

    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="mosa-paper")
    p.add_argument("--preset", default="smoke")
    p.add_argument("--variant", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; raises "
                        "without one)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--metrics-path", default=None,
                   help="write an obs metrics snapshot here on exit "
                        "(.jsonl appends)")
    p.add_argument("--trace-path", default=None,
                   help="write a Chrome-trace JSON of the run here on exit")
    p.add_argument("--load-rate", type=float, default=0.0,
                   help="instead of one batch generate, drive the timed "
                        "Scheduler with a seeded open-loop arrival stream "
                        "at this rate (req/s) and print the SLO/goodput "
                        "summary")
    p.add_argument("--load-n", type=int, default=32,
                   help="requests in the load run")
    p.add_argument("--load-seed", type=int, default=0)
    p.add_argument("--bursty", action="store_true",
                   help="Gamma (CV=3) interarrivals instead of Poisson")
    p.add_argument("--max-queue", type=int, default=0,
                   help="shed arrivals past this queue depth "
                        "(0 = never shed)")
    p.add_argument("--ttft-slo", type=float, default=0.5,
                   help="TTFT SLO in seconds for the load-run goodput")
    p.add_argument("--tpot-slo", type=float, default=0.0,
                   help="TPOT SLO in seconds (0 = no TPOT obligation)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    akw = {"variant": args.variant} if args.variant else {}
    cfg = get_config(args.arch, preset=args.preset, **akw)
    if args.load_rate > 0:
        return _load_run(cfg, args, device)
    server = Server(cfg, batch=args.batch, max_len=args.max_len,
                    paged=PagedConfig(block_size=16), device=device)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(2, cfg.vocab,
                                            (args.batch, args.prompt_len)))
    gen = torch.Generator(device=device).manual_seed(0)

    def run():
        toks, _ = server.generate(prompts, args.gen, args.temperature, gen,
                                  args.top_k)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return toks

    run()                                    # warm-up outside the timing
    t0 = time.perf_counter()
    toks = run()
    dt = time.perf_counter() - t0
    print(f"generated {tuple(toks.shape)} in {dt:.2f}s on {device} "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print(toks[0].tolist())
    # the paper's KV metric, for a model with MoSA layers
    if cfg.mosa is not None:
        from repro_torch.core.hybrid import HybridAttention
        hy = HybridAttention(cfg.d_model, cfg.mosa, device="meta")
        print(f"KV entries per MoSA layer: {hy.kv_total(args.max_len)} "
              f"(dense equivalent: "
              f"{args.max_len * (cfg.mosa.n_dense_heads + cfg.mosa.n_mosa_heads)})")
    obs.dump(args.metrics_path, args.trace_path, tag="serve-cli")


if __name__ == "__main__":
    main()
