"""The port's distributed substrate in one process, against the JAX
package on the same inputs: ``elastic_plan``, ``StragglerMonitor``,
``Heartbeat`` (each package reads the other's files), the rule sets
(``fit_axes``, ``dp_axes``, ``mesh_rules``, ``resolve_spec``, the unknown
rule set), ``hints.resolve``, the gradient compression's arithmetic, and
the placement of every parameter of every ported model, mesh and rule set
(``resolve_specs`` with ``mesh_rules``, and ``param_shardings`` with its
head-count fallback).  JAX's rule functions read only ``mesh.shape``, so a
``SimpleNamespace`` stands for a mesh (an ``AbstractMesh`` where JAX builds
shardings).  No process group starts here; the collectives run in
``test_torch_dist_mesh.py``."""

from __future__ import annotations

import functools
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.dist import fault_tolerance as jft
from repro.dist import hints as jhints
from repro.dist import sharding as jshd
from repro.nn import module as jmodule
from repro.nn.transformer import TransformerLM as JLM, find_period
from repro.optim import grad_compression as jgc

from repro_torch.dist import fault_tolerance as tft
from repro_torch.dist import hints as thints
from repro_torch.dist import sharding as tshd
from repro_torch.launch import mesh as tmesh
from repro_torch.nn.transformer import TransformerLM
from repro_torch.optim import grad_compression as tgc

from test_torch_parity import torch_config


def spec_tuple(p):
    """A JAX PartitionSpec as the port's placement tuple."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in p)


# ------------------------------------------------------------- elastic_plan
PLAN_CASES = [(248, 16, False), (24, 16, False), (7, 16, False),
              (1, 16, False), (512, 16, False), (17, 4, False),
              (256, 1, False), (4, 16, False), (512, 16, True),
              (17 * 16, 16, True), (8, 1, False), (8, 2, False)]


@pytest.mark.parametrize("n,tp,pods", PLAN_CASES)
def test_elastic_plan_matches_jax(n, tp, pods):
    assert tft.elastic_plan(n, tp=tp, want_pods=pods) == \
        jft.elastic_plan(n, tp=tp, want_pods=pods)


def test_elastic_plan_rejects_zero_devices():
    for mod in (tft, jft):
        with pytest.raises(ValueError):
            mod.elastic_plan(0)


# ------------------------------------------------------- straggler monitor
@pytest.mark.parametrize("seed", range(4))
def test_straggler_monitor_matches_jax(seed):
    rng = np.random.default_rng(seed)
    dts = 0.1 + 0.01 * rng.standard_normal(60)
    dts[rng.choice(60, 6, replace=False)] *= rng.uniform(2, 20, 6)
    kw = dict(z_threshold=float(rng.uniform(2, 4)),
              warmup_steps=int(rng.integers(1, 12)))
    mt, mj = tft.StragglerMonitor(**kw), jft.StragglerMonitor(**kw)
    flags = [(mt.record(i, dt), mj.record(i, dt)) for i, dt in enumerate(dts)]
    assert [a for a, _ in flags] == [b for _, b in flags]
    assert any(a for a, _ in flags)
    assert mt.summary() == mj.summary()


# ---------------------------------------------------------------- heartbeat
def test_heartbeats_read_across_packages(tmp_path):
    d = str(tmp_path)
    tft.Heartbeat(d, rank=0).beat(3)
    tft.Heartbeat(d, rank=2).beat(3)
    jft.Heartbeat(d, rank=5).beat(3)
    for mod in (tft, jft):
        assert mod.Heartbeat.stale_ranks(d, timeout_s=3600) == []
        assert mod.Heartbeat.stale_ranks(d, timeout_s=0) == [0, 2, 5]
    port = json.load(open(os.path.join(d, "heartbeats", "rank_0.json")))
    ref = json.load(open(os.path.join(d, "heartbeats", "rank_5.json")))
    assert set(port) == set(ref) == {"rank", "step", "time"}
    assert port["step"] == ref["step"] == 3
    # an old beat is stale for both readers
    old = os.path.join(d, "heartbeats", "rank_2.json")
    os.utime(old, (1.0, 1.0))
    for mod in (tft, jft):
        assert mod.Heartbeat.stale_ranks(d, timeout_s=60) == [2]


# ---------------------------------------------------------------- the rules
MESHES = [{"data": 2, "model": 4}, {"data": 4, "model": 2},
          {"data": 8, "model": 1}, {"data": 1, "model": 8},
          {"pod": 2, "data": 2, "model": 2}]
RULE_SETS = ("tp", "fsdp_tp")


def _mesh(shape):
    return SimpleNamespace(shape=dict(shape))


@pytest.mark.parametrize("shape", MESHES + [{"pod": 2, "data": 16,
                                             "model": 16}, {"pipe": 4}])
def test_rule_functions_match_jax(shape):
    m = _mesh(shape)
    am = jax.sharding.AbstractMesh(tuple(shape.values()), tuple(shape))
    for rs in RULE_SETS:
        assert tshd.mesh_rules(m, rs) == jshd.mesh_rules(m, rs)
        assert tshd.dp_axes(m, rs) == jshd.dp_axes(m, rs)
        for batch in (1, 2, 8, 16, 24, 256):
            assert tshd.dp_axes(m, rs, batch) == jshd.dp_axes(m, rs, batch)
            assert tshd.batch_spec(m, rs, batch) == spec_tuple(
                jshd.batch_sharding(am, rs, batch).spec)
    assert tshd.tp_axis(m) == jshd.tp_axis(m)
    for dim in (0, 1, 3, 8, 12, 16, 256, 512):
        for axes in (("pod", "data"), ("data",), ("model",),
                     ("pipe", "data"), ("data", "model")):
            assert tshd.fit_axes(dim, axes, m) == jshd.fit_axes(dim, axes, m)


def test_unknown_rule_set_raises_keyerror():
    m = _mesh({"data": 2})
    for fn in (tshd.dp_axes, tshd.mesh_rules, jshd.dp_axes, jshd.mesh_rules):
        with pytest.raises(KeyError):
            fn(m, "nope")


RESOLVE_CASES = [
    ((), ()), ((8, 8), ("embed", "mlp")), ((0, 8), ("mlp", None)),
    ((512, 2048), ("embed", "mlp")), ((2048, 512), ("mlp", "embed")),
    ((276, 512, 64), ("mosa_heads", "embed", None)),
    ((42, 64, 512), ("mosa_heads", None, "embed")),
    ((8000, 512), ("vocab", "embed")), ((512, 256), ("embed", "heads")),
    ((512, 576), ("embed", "kv_heads")), ((3, 5), ("mlp", "mlp")),
    ((16, 16), ("batch", "embed")), ((512, 2), ("embed", None)),
]


@pytest.mark.parametrize("shape", MESHES)
def test_resolve_spec_matches_jax(shape):
    m = _mesh(shape)
    for rs in RULE_SETS:
        rules = tshd.mesh_rules(m, rs)
        for dims, names in RESOLVE_CASES:
            got = tshd.resolve_spec(dims, tshd.logical(*names), rules, m)
            want = jmodule.resolve_spec(dims, jmodule.logical(*names), rules,
                                        m)
            assert got == spec_tuple(want), (dims, names, rs)
        assert tshd.resolve_spec((8, 8), None, rules, m) == ()
        assert tshd.resolve_spec((8, 8), tshd.logical("embed", "mlp"), {},
                                 m) == ()


@pytest.mark.parametrize("shape", [{"pod": 2, "data": 16, "model": 4},
                                   {"data": 2, "model": 4}])
def test_hints_resolve_matches_jax(shape):
    m = _mesh(shape)
    cases = [((8, 64), ("dp", "tp")), ((1, 64), ("dp", "tp")),
             ((1, 3), ("dp", "tp")), ((8, 8), ("tp", "tp")),
             ((8, 8), (None, "model")), ((8, 8), ("pipe", None)),
             ((32, 16, 8), ("dp", None, "tp")), ((64,), (("pod", "data"),))]
    assert thints.resolve((4, 8), ("dp", "tp")) is None
    assert jhints.resolve((4, 8), ("dp", "tp")) is None
    with thints.sharding_hints(mesh=m) as ts, \
            jhints.sharding_hints(mesh=m) as js:
        assert ts == js
        assert thints.current() == jhints.current()
        for dims, roles in cases:
            want = jhints.resolve(dims, roles)
            got = thints.resolve(dims, roles)
            assert got == (None if want is None else spec_tuple(want)), \
                (dims, roles)
    assert thints.current() is None


def test_hints_constrain_leaves_plain_tensors():
    x = torch.arange(12.0).reshape(3, 4)
    with thints.sharding_hints(mesh=_mesh({"data": 2, "model": 2})):
        assert thints.constrain(x, ("dp", "tp")) is x
    assert thints.constrain(x, ("dp", "tp")) is x


def test_production_mesh_shapes_and_refusal():
    assert tmesh.production_shape(False) == ((16, 16), ("data", "model"))
    assert tmesh.production_shape(True) == ((2, 16, 16),
                                            ("pod", "data", "model"))
    with pytest.raises(ValueError, match="256"):
        tmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="512"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")


def test_process_group_refuses_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA"):
        tmesh.init_process_group()
    assert not torch.distributed.is_initialized()


def test_trainer_without_mesh_starts_no_process_group():
    from repro_torch.train.loop import TrainConfig, Trainer
    tr = Trainer(TrainConfig(preset="smoke", device="cpu", seq_len=32,
                             global_batch=2, steps=1))
    assert tr.mesh is None and tr.shards is None and tr.rank == 0
    assert not torch.distributed.is_initialized()


# -------------------------------------------------------- grad compression
def test_topk_mask_keeps_ties_like_jax():
    x = np.array([0.5, -2.0, 1.0, -1.0, 1.0, 0.25, 2.0, -0.5],
                 np.float32).reshape(2, 4)
    for frac in (0.1, 0.25, 0.5, 0.6, 1.0):
        want = np.asarray(jgc.topk_mask(jax.numpy.asarray(x), frac))
        got = tgc.topk_mask(torch.from_numpy(x), frac).numpy()
        np.testing.assert_array_equal(got, want)
    # the 3rd largest |x| is 1.0, which four entries share: all are kept
    assert tgc.topk_mask(torch.from_numpy(x), 3 / 8).sum().item() == 5


@pytest.mark.parametrize("seed", range(3))
def test_compression_arithmetic_matches_jax(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((64, 33)) * 10.0 ** rng.uniform(-3, 1)).astype(
        np.float32)
    res = (0.01 * rng.standard_normal(g.shape)).astype(np.float32)
    jq, js = jgc.int8_quantize(jax.numpy.asarray(g))
    tq, ts = tgc.int8_quantize(torch.from_numpy(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    np.testing.assert_array_equal(
        tgc.int8_dequantize(tq, ts).numpy(),
        np.asarray(jgc.int8_dequantize(jq, js)))
    for name, frac in (("topk", 0.05), ("int8", None)):
        # one error-feedback step: g + residual, then the compression
        gj = jax.numpy.asarray(g) + jax.numpy.asarray(res)
        gt = torch.from_numpy(g) + torch.from_numpy(res)
        if name == "topk":
            jk, jr = jgc.topk_compress(gj, frac)
            tk, tr = tgc.topk_compress(gt, frac)
        else:
            jk, jr = jgc.int8_compress(gj)
            tk, tr = tgc.int8_compress(gt)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        assert torch.equal(tk + tr, gt)


# ------------------------------------------------ placement of parameters
SMOKE_MODELS = {
    "token": dict(variant="mosa"),
    "block": dict(variant="mosa", selection_granularity="block",
                  sel_block_size=16),
    "window": dict(variant="mosa", local_window=32),
    "gated": dict(variant="mosa", selection_granularity="block",
                  sel_block_size=16, local_window=32),
    "fixed": dict(variant="fixed"),
    "routing": dict(variant="routing"),
    "dense": dict(variant="dense"),
}


@functools.lru_cache(maxsize=None)
def _models(name):
    """(JAX config, JAX model, its init shapes, the port's model on
    ``meta``)."""
    if name == "tiny-mosa32":
        jcfg = jget_config("mosa-paper", preset="full", size="tiny",
                           variant="mosa")
    else:
        jcfg = jget_config("mosa-paper", preset="smoke",
                           **SMOKE_MODELS[name])
    jm = JLM(jcfg)
    return jcfg, jm, jmodule.init_shapes(jm), TransformerLM(
        torch_config(jcfg), device="meta")


def _unstacked(jcfg, tree) -> dict:
    """A JAX per-parameter tree (specs) keyed as the port's state_dict:
    scan units unstacked (the stacked leading axis dropped), as
    ``convert.params_from_jax`` does."""
    is_leaf = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    head, p, units, _ = (find_period(jcfg.resolved_pattern())
                         if jcfg.scan_layers else (0, 0, 0, 0))
    out = {}
    for path, spec in flat:
        keys = [k.key for k in path]
        spec = spec_tuple(spec)
        if keys[:2] == ["layers", "scan"]:
            j = int(keys[2][len("pos"):])
            rest = ".".join(keys[3:])
            for u in range(units):
                out[f"layers.{head + u * p + j}.{rest}"] = spec[1:]
        elif keys[:2] == ["layers", "tail"]:
            i = int(keys[2][len("layer"):])
            out[f"layers.{i}." + ".".join(keys[3:])] = spec
        else:
            out[".".join(keys)] = spec
    return out


@pytest.mark.parametrize("rule_set", RULE_SETS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
@pytest.mark.parametrize("name", list(SMOKE_MODELS) + ["tiny-mosa32"])
def test_every_parameter_placed_as_jax(name, shape, rule_set):
    jcfg, jm, shapes, model = _models(name)
    m = _mesh(shape)
    rules = jshd.mesh_rules(m, rule_set)
    want = _unstacked(jcfg, jmodule.resolve_specs(shapes, jm.specs(), rules,
                                                  m))
    got = tshd.resolve_specs(tshd.param_shapes(model), model.specs(),
                             tshd.mesh_rules(m, rule_set), m)
    assert set(got) == set(want) == set(dict(model.named_parameters()))
    assert got == want
    # and with the head-count fallback of JAX's param_shardings
    am = jax.sharding.AbstractMesh(tuple(shape.values()), tuple(shape))
    jsh = jshd.param_shardings(jm, am, rule_set, shapes)
    want_fb = _unstacked(jcfg, jax.tree.map(
        lambda s: s.spec, jsh, is_leaf=lambda x: hasattr(x, "spec")))
    assert tshd.param_specs(model, m, rule_set) == want_fb


def test_dist_modules_import_without_jax():
    """The new modules import in an interpreter where ``jax`` and
    ``repro`` cannot be imported, and start no process group."""
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.dist.sharding, repro_torch.dist.hints, "
            "repro_torch.dist.parallel, repro_torch.dist.pipeline, "
            "repro_torch.dist.fault_tolerance, repro_torch.launch.mesh, "
            "repro_torch.optim.grad_compression, repro_torch.train.loop; "
            "import torch.distributed as d; "
            "print('ok', d.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok False"


@pytest.mark.parametrize("rule_set", RULE_SETS)
def test_train_state_placements_match_jax(rule_set):
    """``train_state_specs`` = JAX's ``train_state_shardings``: the AdamW
    moments placed as their parameters, the step replicated."""
    from repro.optim.optimizer import adamw
    jcfg, jm, shapes, model = _models("token")
    shape = {"data": 2, "model": 4}
    am = jax.sharding.AbstractMesh(tuple(shape.values()), tuple(shape))
    jp, jo, js = jshd.train_state_shardings(jm, am, rule_set, adamw(1e-3),
                                            shapes)
    spec_of = functools.partial(jax.tree.map, lambda s: s.spec,
                                is_leaf=lambda x: hasattr(x, "spec"))
    psp, osp, ssp = tshd.train_state_specs(model, _mesh(shape), rule_set)
    assert psp == _unstacked(jcfg, spec_of(jp))
    assert set(osp) == set(jo) == {"mu", "nu"}
    for m in ("mu", "nu"):
        assert osp[m] == _unstacked(jcfg, spec_of(jo[m]))
    assert ssp == spec_tuple(js.spec) == ()
