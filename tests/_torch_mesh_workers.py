"""Rank programs of ``test_torch_dist_mesh.py``: each runs in a process of
its own, spawned by ``torch.multiprocessing``, on gloo over a ``FileStore``
in the test's ``tmp_path``.  They import torch and the port only (no JAX);
the test process writes their inputs and reads their outputs as files
under the same ``tmp_path``."""

from __future__ import annotations

import json
import os
import signal

import torch
import torch.distributed as dist


def _start(rank, world, tmp):
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_process_group("cpu", init_method=f"file://{tmp}/store",
                                world_size=world, rank=rank)
    return mesh_lib


def _save(rank, obj, path):
    if rank == 0:
        torch.save(obj, path)


# ------------------------------------------------------------- trainers
def train_cfg(**kw):
    from repro_torch.train.loop import TrainConfig
    base = dict(arch="mosa-paper", preset="smoke",
                arch_kwargs={"variant": "mosa"}, seq_len=64,
                global_batch=8, microbatch=2, lr=2.5e-4, warmup=1,
                clip_norm=0.25, device="cpu", log_every=1, steps=3)
    return TrainConfig(**{**base, **kw})


def _run_trainer(cfg, install_signals=False, on_step=None):
    from repro_torch.train.loop import Trainer
    tr = Trainer(cfg)
    if on_step is not None:
        step_fn, calls = tr.train_step, {"n": 0}

        def wrapped(*args):
            out = step_fn(*args)
            on_step(calls["n"])
            calls["n"] += 1
            return out
        tr.train_step = wrapped
    params, opt, hist = tr.run(install_signals=install_signals)
    full, full_opt = tr.full_state(params, opt)
    return tr, full, full_opt, hist


def train_worker(rank, world, tmp):
    """(2, 2) mesh: one step of each rule set from given weights, then the
    Trainer's resume, checkpoints and preemption under ``fsdp_tp``."""
    _start(rank, world, tmp)
    from repro_torch.train.loop import Trainer
    state = torch.load(f"{tmp}/weights.pt")
    batch = torch.load(f"{tmp}/batch.pt")
    for rs in ("tp", "fsdp_tp"):
        tr = Trainer(train_cfg(mesh_shape=(2, 2), rule_set=rs))
        params = tr.load_full(state)
        opt = tr.optimizer.init(params)
        params, opt, step, metrics = tr.train_step(params, opt, 0, batch)
        full, full_opt = tr.full_state(params, opt)
        _save(rank, {"params": full, "mu": full_opt["mu"], "step": step,
                     "metrics": {k: float(v) for k, v in metrics.items()},
                     "n_local": sum(p.numel() for p in params.values())},
              f"{tmp}/step_{rs}.pt")

    mesh = dict(mesh_shape=(2, 2), rule_set="fsdp_tp")
    _, full_a, _, hist_a = _run_trainer(train_cfg(ckpt_dir=f"{tmp}/A",
                                                  ckpt_every=1, **mesh))
    _run_trainer(train_cfg(ckpt_dir=f"{tmp}/B", steps=2, **mesh))
    _, full_b, _, hist_b = _run_trainer(train_cfg(ckpt_dir=f"{tmp}/B",
                                                  **mesh))
    _save(rank, {"A": (full_a, hist_a), "B": (full_b, hist_b)},
          f"{tmp}/resume.pt")

    def preempt_rank1(n):
        if rank == 1 and n == 1:          # seen by rank 1 alone
            os.kill(os.getpid(), signal.SIGTERM)
    _, _, _, hist_c = _run_trainer(
        train_cfg(ckpt_dir=f"{tmp}/C", steps=6, **mesh),
        install_signals=True, on_step=preempt_rank1)
    with open(f"{tmp}/C_rank{rank}.json", "w") as f:
        json.dump([h["step"] for h in hist_c], f)
    dist.destroy_process_group()


# ---------------------------------------------------------------- layers
def _layer(spec):
    """A hybrid layer (a ``MoSAConfig``'s fields), or with ``"attn"`` a
    ``MultiHeadAttention`` (an ``AttentionConfig``'s), at d_model 64."""
    from repro_torch.configs.base import AttentionConfig, MoSAConfig
    from repro_torch.core.attention import MultiHeadAttention
    from repro_torch.core.hybrid import HybridAttention
    if "attn" in spec:
        return MultiHeadAttention(64, AttentionConfig(**spec["attn"]))
    return HybridAttention(64, MoSAConfig(**spec))


def _sharded_layer(spec, state, mesh, rule_set="tp", dropped=()):
    """A layer with ``state``, cut to this rank's ``model`` shards under
    ``rule_set``'s raw placements, less the ``dropped`` rules (JAX's
    head-count fallback)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.parallel import MeshContext, TrainShards, shard_model
    layer = _layer(spec)
    layer.load_state_dict(state)
    ctx = MeshContext(mesh, rule_set)
    shapes = shd.param_shapes(layer)
    rules = {**shd.mesh_rules(mesh, rule_set), **{r: None for r in dropped}}
    specs = shd.resolve_specs(shapes, layer.specs(), rules, mesh)
    shard_model(layer, ctx.tp, specs, ctx.coords, ctx.sizes)
    return layer, ctx, TrainShards(layer, ctx, specs, shapes)


def _layer_case(rank, mesh_lib, case, tmp):
    """Forward and backward of one hybrid layer on a (data, model) mesh;
    rank 0 saves the output rows gathered over ``data`` and the full
    gradients (summed over ``data``, gathered over ``model``)."""
    inp = torch.load(f"{tmp}/{case}_in.pt")
    mesh = mesh_lib.make_mesh(inp["mesh"], ("data", "model"), "cpu")
    layer, ctx, shards = _sharded_layer(inp["spec"], inp["state"], mesh,
                                        dropped=inp.get("dropped", ()))
    rows = ctx.dp_rows({"x": inp["x"], "dy": inp["dy"]}, 1)
    x = rows["x"].clone().requires_grad_(True)
    y = layer(x)
    params = dict(layer.named_parameters())
    grads = torch.autograd.grad((y * rows["dy"]).sum(),
                                [x] + list(params.values()))
    ys = [torch.empty_like(y) for _ in range(ctx.dp_size)]
    dist.all_gather(ys, y.detach().contiguous(), group=ctx.dp_group)
    full = {}
    for k, g in zip(params, grads[1:]):
        g = ctx.all_reduce(g.contiguous(), ctx.dp_axes)
        full[k] = shards.full(k, g)
    _save(rank, {"y": torch.cat(ys), "grads": full,
                 "local_shapes": {k: tuple(p.shape)
                                  for k, p in params.items()},
                 "sparse_sharded": getattr(layer, "sparse_sharded", None),
                 "q_cols": (layer.q_cols if "attn" in inp["spec"] else
                            None if layer.dense is None
                            else layer.dense.q_cols),
                 "kv_cols": getattr(layer, "kv_cols", None)},
          f"{tmp}/{case}_out.pt")


def _pipeline_case(rank, mesh_lib, tmp):
    """GPipe over 4 stages of a (data 2, pipe 4) mesh: the output, and the
    stacked parameters' gradients summed over the stages."""
    from repro_torch.dist.pipeline import pipeline_forward, stack_stage_params
    inp = torch.load(f"{tmp}/pipe_in.pt")
    mesh = mesh_lib.make_mesh((2, 4), ("data", "pipe"), "cpu")
    sp = stack_stage_params([{"w": w} for w in inp["ws"]])
    sp["w"].requires_grad_(True)

    def stage(p, a):
        return torch.tanh(a @ p["w"]) + a
    y = pipeline_forward(stage, sp, inp["x"], mesh=mesh, n_microbatches=4)
    (y ** 2).sum().backward()
    g = sp["w"].grad.clone()
    dist.all_reduce(g, group=mesh.get_group("pipe"))
    errors = {}
    for bad in ({"mesh": mesh_lib.make_mesh((8,), ("data",), "cpu")},
                {"params": stack_stage_params([{"w": w} for w in
                                               inp["ws"][:3]])},
                {"n_microbatches": 3}):
        kw = dict(mesh=mesh, n_microbatches=4)
        kw.update({k: v for k, v in bad.items() if k != "params"})
        try:
            pipeline_forward(stage, bad.get("params", sp), inp["x"], **kw)
        except ValueError as e:
            errors[next(iter(bad))] = str(e)
    _save(rank, {"y": y.detach(), "grad": g, "errors": errors},
          f"{tmp}/pipe_out.pt")


def _compress_case(rank, mesh_lib, tmp):
    """``compressed_all_reduce`` over ``pod`` of a (pod 2, data 4) mesh: each
    pod rank holds its row of g."""
    from repro_torch.optim import grad_compression as gc
    inp = torch.load(f"{tmp}/compress_in.pt")
    mesh = mesh_lib.make_mesh((2, 4), ("pod", "data"), "cpu")
    pod = mesh.get_local_rank("pod")
    g = {"g": inp["g"][pod]}
    exact, _ = gc.compressed_all_reduce(g, (mesh, "pod"), "none")
    out = {"none": exact["g"]}
    for scheme in ("topk", "int8"):
        red, res = gc.compressed_all_reduce(g, (mesh, "pod"), scheme,
                                            topk_frac=0.5)
        kept = (gc.topk_compress(g["g"], 0.5) if scheme == "topk"
                else gc.int8_compress(g["g"]))[0]
        rsum = res["g"].clone()
        dist.all_reduce(rsum, group=mesh.get_group("pod"))
        # a second call feeds the residual back (error feedback)
        red2, res2 = gc.compressed_all_reduce(g, (mesh, "pod"), scheme,
                                              topk_frac=0.5, residual=res)
        out[scheme] = {"reduced": red["g"], "residual_sum": rsum,
                       "kept_plus_residual_is_g": torch.equal(
                           kept + res["g"], g["g"]),
                       "reduced2": red2["g"], "residual2": res2["g"]}
    _save(rank, out, f"{tmp}/compress_out.pt")


def _hints_case(rank, mesh_lib, tmp):
    """``constrain`` on a (data 2, model 4) mesh: a replicated DTensor is
    redistributed to the resolved placement, values kept; a plain tensor
    comes back unchanged."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.dist import hints
    mesh = mesh_lib.make_mesh((2, 4), ("data", "model"), "cpu")
    x = torch.arange(64.0).reshape(8, 8)
    dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    with hints.sharding_hints(mesh=mesh):
        y = hints.constrain(dx, ("dp", "tp"))
        z = hints.constrain(dx, ("tp", "tp"))     # "model" once only
        plain = hints.constrain(x, ("dp", "tp")) is x
    def kinds(t):
        return [("shard", p.dim) if p.is_shard() else ("replicate",)
                for p in t.placements]
    _save(rank, {"y": kinds(y), "z": kinds(z),
                 "local": tuple(y.to_local().shape),
                 "same": torch.equal(y.full_tensor(), x)
                 and torch.equal(z.full_tensor(), x),
                 "plain": plain}, f"{tmp}/hints_out.pt")


def _serve_case(rank, mesh_lib, tmp):
    """The hybrid's serving on a (1, 8) mesh: its own caches (contiguous
    and paged), one prefill and a few decode steps; rank 0 saves the
    outputs and its caches' shapes."""
    from repro_torch.serve.paged_kv import PagedConfig
    inp = torch.load(f"{tmp}/serve8_in.pt")
    mesh = mesh_lib.make_mesh(inp["mesh"], ("data", "model"), "cpu")
    layer, _, _ = _sharded_layer(inp["spec"], inp["state"], mesh)
    x, T, L = inp["x"], inp["prompt"], inp["max_len"]
    out = {}
    for name, paged in (("dense", None), ("paged", PagedConfig(8))):
        caches = layer.init_cache(x.shape[0], L, torch.float32, paged=paged)
        with torch.inference_mode():
            y, caches = layer.prefill(x[:, :T], caches)
            ys = [y]
            for t in range(T, x.shape[1]):
                y, caches = layer.decode_step(x[:, t:t + 1], caches)
                ys.append(y)
        out[name] = {"ys": ys, "heads": (caches["sparse"].k.shape[1],
                                         caches["dense"].k.shape[-2]),
                     "mode": layer.dense._serve_mode(caches["dense"])}
    _save(rank, out, f"{tmp}/serve8_out.pt")


def layers_worker(rank, world, tmp):
    """8 ranks: MoSA heads over ``model`` = 4 on (data 2, model 4); the
    hybrids over ``model`` = 8 (a dense slice is half a head); GQA
    attention over ``model`` = 8 with its kv heads replicated; the
    hybrid's serving over ``model`` = 8 (276 MoSA heads replicated, half a
    dense head a rank); the pipeline; the compressed all-reduce;
    ``hints.constrain``."""
    mesh_lib = _start(rank, world, tmp)
    for case in ("mosa4", "hybrid8", "gated8", "gqa8"):
        _layer_case(rank, mesh_lib, case, tmp)
    _serve_case(rank, mesh_lib, tmp)
    _pipeline_case(rank, mesh_lib, tmp)
    _compress_case(rank, mesh_lib, tmp)
    _hints_case(rank, mesh_lib, tmp)
    dist.destroy_process_group()


# --------------------------------------------------------------- serving
def _server(inp, name, mesh, **kw):
    """A ``Server`` of the smoke config ``name`` on ``mesh`` (its converted
    weights read once a process)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import Server
    cfg = get_config("mosa-paper", **inp["configs"][name])
    states = inp.setdefault("states", {})
    if name not in states:
        states[name] = torch.load(f"{inp['tmp']}/{name}.pt")
    return Server(cfg, device="cpu", params=states[name], mesh=mesh, **kw)


def _served_logits(srv, prompts, n):
    """Prefill logits and ``n`` decode steps' logits of greedy decoding
    (the whole batch's, gathered over dp by the caller where needed)."""
    with torch.inference_mode():
        rows = srv._local_rows(prompts)
        logits, caches = srv.model.prefill(rows, srv.new_cache())
        tok0 = logits[:, -1].argmax(-1)[:, None]
        _, dec, caches = srv.model.decode_many(tok0, caches, n=n,
                                               return_logits=True)
    return logits[:, -1], dec, caches


def _cache_shapes(caches):
    out = []
    for c in caches:
        out.append({k: {f: tuple(t.shape) for f, t in zip(v._fields, v)}
                    for k, v in c.items()})
    return out


def _all_ranks(obj, world):
    objs = [None] * world
    dist.all_gather_object(objs, obj)
    return objs


def serve_worker(rank, world, tmp):
    """4 ranks: the smoke models served on a (1, 4) mesh under ``tp``
    (``generate`` and its logits, a step-indexed and a timed Scheduler
    run, block choice), on a (2, 2) mesh under ``fsdp_tp`` with rows over
    dp (and the A.7c refusals), and batch 1 with ``seq_sharded`` caches."""
    mesh_lib = _start(rank, world, tmp)
    from repro_torch.launch.serve import RequestPool
    from repro_torch.serve.loadgen import Arrival, OpenLoopSource
    from repro_torch.serve.paged_kv import PagedConfig
    from repro_torch.serve.scheduler import Scheduler
    inp = torch.load(f"{tmp}/serve_in.pt")
    inp["tmp"] = tmp
    prompts, G, L = inp["prompts"], inp["gen"], inp["max_len"]
    out = {}
    tp4 = mesh_lib.make_mesh((1, 4), ("data", "model"), "cpu")
    for name in ("sp32", "sp8", "block"):
        srv = _server(inp, name, tp4, batch=prompts.shape[0], max_len=L,
                      paged=PagedConfig(16))
        toks, caches = srv.generate(prompts, G)
        last, dec, _ = _served_logits(srv, prompts, G - 1)
        res = {"toks": toks, "prefill_logits": last, "decode_logits": dec,
               "caches": _cache_shapes(caches)}
        if name != "block":
            bs, nb = inp["sched_paged"]
            ssrv = _server(inp, name, tp4, batch=2, max_len=L,
                           paged=PagedConfig(bs, num_blocks=nb))
            sched = Scheduler(ssrv, chunk=4)
            for p, m in inp["sched_reqs"]:
                sched.submit(p, m)
            res["sched"] = (sched.run(), dict(sched.stats))
            # the same requests in timed mode, arriving 20 ms apart
            timed = Scheduler(ssrv, chunk=4)
            src = OpenLoopSource([Arrival(0.02 * i, "", p.numpy(), m)
                                  for i, (p, m) in enumerate(
                                      inp["sched_reqs"])])
            got = timed.run(source=src)
            res["timed"] = _all_ranks(
                ({k: v.tolist() for k, v in got.items()},
                 dict(timed.stats)), world)
        out[name] = res

    mesh22 = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    srv = _server(inp, "sp32", mesh22, batch=prompts.shape[0], max_len=L,
                  paged=PagedConfig(16), rule_set="fsdp_tp")
    toks, caches = srv.generate(prompts, G)
    out["fsdp_tp"] = {"toks": toks, "rows": srv.rows,
                      "caches": _cache_shapes(caches)}
    errors = {}
    s = _server(inp, "sp8", mesh22, batch=2, max_len=L, rule_set="fsdp_tp",
                paged=PagedConfig(8, num_blocks=8))
    for what, cls in (("Scheduler", Scheduler), ("RequestPool", RequestPool)):
        try:
            cls(s)
        except ValueError as e:
            errors[what] = str(e)
    out["fsdp_tp"]["errors"] = errors

    srv = _server(inp, "sp32", tp4, batch=1, max_len=L, seq_sharded=True)
    toks, caches = srv.generate(prompts[:1], G)
    last, dec, _ = _served_logits(srv, prompts[:1], G - 1)
    out["seq"] = {"toks": toks, "prefill_logits": last, "decode_logits": dec,
                  "caches": _cache_shapes(caches),
                  "seq_flags": [l.mixer.dense.seq_sharded
                                for l in srv.model.layers]}
    _save(rank, out, f"{tmp}/serve_out.pt")
    dist.destroy_process_group()
