"""The IsoFLOP sweep and the Trainer's telemetry in the port, on the CPU.

  * ``isoflop_sweep`` gives JAX's points (name, variant, sparsity,
    analytic FLOPs per token) for smoke and full, every variant, sparsities
    (8, 32); ``budget_match_error`` is equal too (6.05 at full size, from
    routing32's 7.05x the dense budget: the accounting counts
    ``n_mosa_heads`` routing heads where the layer builds ``n_mosa_heads //
    sparsity``; a property of the reference);
  * the Table 4 bridge (``tests/test_train_subsystem.py:204``) and the
    smoke sweep end to end with its resume at the step-4 boundary
    (``:176``), ported;
  * a JAX checkpoint of a fixed and a routing smoke point resumes in the
    port's ``run_isoflop`` and its next step's loss is JAX's within 1e-5
    relative;
  * ``launch.train --isoflop --device cpu`` prints the results JSON;
  * the Trainer's metrics file and trace carry the names the JAX Trainer
    writes, with one ``train_step`` span and one ``train.step_time_s``
    observation per step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import obs as jobs
from repro.checkpoint import checkpoint as jckpt
from repro.core.flops import PAPER_MODELS, TABLE4_GFLOPS
from repro.data import pipeline as jpipe
from repro.nn.transformer import TransformerLM as JLM
from repro.optim import optimizer as jopt
from repro.optim import schedules as jsched
from repro.train import isoflop as jiso
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import Trainer as JTrainer
from repro.train.step import make_train_step as jmake_train_step

from repro_torch import obs
from repro_torch.configs.base import get_config
from repro_torch.launch import train as launch_train
from repro_torch.train import isoflop as tiso
from repro_torch.train.loop import TrainConfig, Trainer

from test_torch_parity import numpy_params, one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

VARIANTS = ("dense", "mosa", "fixed", "routing")


@pytest.mark.parametrize("preset, T", [("smoke", 64), ("full", 1024)])
def test_sweep_points_and_budget_equal_jax(preset, T):
    kw = dict(preset=preset, T=T, sparsities=(8, 32), variants=VARIANTS)
    want, got = jiso.isoflop_sweep(**kw), tiso.isoflop_sweep(**kw)
    assert ([(p.name, p.variant, p.sparsity, p.flops_fwd_per_token)
             for p in got] ==
            [(p.name, p.variant, p.sparsity, p.flops_fwd_per_token)
             for p in want])
    assert len(got) == 7
    assert tiso.budget_match_error(got) == jiso.budget_match_error(want)
    dense_mosa = [p for p in got if p.variant in ("dense", "mosa")]
    assert tiso.budget_match_error(dense_mosa) == jiso.budget_match_error(
        [p for p in want if p.variant in ("dense", "mosa")])
    if preset == "full":
        assert tiso.budget_match_error(dense_mosa) < 0.05
        ref = got[0].flops_fwd_per_token
        ratios = {p.name.rsplit("-", 1)[1]: round(
            p.flops_fwd_per_token / ref, 4) for p in got[1:]}
        assert ratios == {"mosa8": 0.9993, "mosa32": 0.9993,
                          "fixed8": 0.9913, "fixed32": 0.9675,
                          "routing8": 2.4826, "routing32": 7.0518}
        assert round(tiso.budget_match_error(got), 4) == 6.0518


def test_analytic_flops_match_paper_table():
    """Port of ``tests/test_train_subsystem.py:204``: the dense tiny
    per-token FLOPs equal the published Table 4 budget / T."""
    cfg = get_config("mosa-paper", preset="full", size="tiny",
                     variant="dense")
    per_tok = tiso.analytic_flops_per_token(cfg, 1024)
    want = TABLE4_GFLOPS["tiny"] * 1e9 / 1024
    assert abs(per_tok - want) / want < 1e-3
    assert per_tok == PAPER_MODELS["tiny"].dense_flops(1024) // 1024


def test_isoflop_smoke_sweep_end_to_end(tmp_path):
    """Port of ``tests/test_train_subsystem.py:176``: dense vs MoSA at one
    matched budget through the resumable loop; a rerun with more steps
    resumes each point at its step-4 checkpoint."""
    points = tiso.isoflop_sweep(preset="smoke", T=64, sparsities=(8,))
    assert [p.variant for p in points] == ["dense", "mosa"]
    assert tiso.budget_match_error(points) < 0.05
    kw = {"lr": 1e-3, "warmup": 2, "log_every": 1, "ckpt_every": 100,
          "device": "cpu"}
    res = tiso.run_isoflop(points, steps=4, seq_len=64, global_batch=2,
                           ckpt_root=str(tmp_path), train_kw=kw)
    assert set(res) == {p.name for p in points}
    for r in res.values():
        assert len(r["loss_curve"]) == 4
        assert np.isfinite(r["final"]["loss"])
        assert r["flops_total"] == r["flops_train_per_token"] * r["tokens"]
    res2 = tiso.run_isoflop(points, steps=6, seq_len=64, global_batch=2,
                            ckpt_root=str(tmp_path), train_kw=kw)
    for r in res2.values():
        assert [h["step"] for h in r["loss_curve"]] == [4, 5]


@pytest.mark.parametrize("variant", ["fixed", "routing"])
def test_jax_checkpoint_resumes_in_run_isoflop(tmp_path, variant):
    """One JAX step from seeded weights is saved as the point's step-1
    checkpoint; the port's sweep resumes there and its next step's loss is
    JAX's (same data step of the same synthetic corpus)."""
    T, batch = 32, 2
    (jpt,) = jiso.isoflop_sweep(preset="smoke", T=T, sparsities=(8,),
                                variants=(variant,))
    (pt,) = tiso.isoflop_sweep(preset="smoke", T=T, sparsities=(8,),
                               variants=(variant,))
    assert pt.name == jpt.name
    jcfg, tc = jpt.cfg, TrainConfig()
    jmodel = JLM(jcfg)
    params = jax.tree.map(jnp.asarray, numpy_params(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)), 21))
    opt = jopt.adamw(jsched.linear_warmup(tc.lr, tc.warmup),
                     weight_decay=tc.weight_decay, clip_norm=tc.clip_norm)
    jstep = jax.jit(jmake_train_step(jmodel, opt))
    data = jpipe.PackedLMDataset(jpipe.SyntheticCorpus(vocab=jcfg.vocab,
                                                       seed=tc.seed),
                                 seq_len=T, global_batch=batch)

    def jb(s):
        return {k: jnp.asarray(v) for k, v in data.batch_at(s).items()}

    p, o, s, _ = jstep(params, opt.init(params), jnp.zeros((), jnp.int32),
                       jb(0))
    jckpt.save(str(tmp_path / pt.name), 1, {"params": p, "opt": o},
               extra_meta={"step": 1})
    _, _, _, jm = jstep(p, o, s, jb(1))
    res = tiso.run_isoflop([pt], steps=2, seq_len=T, global_batch=batch,
                           ckpt_root=str(tmp_path),
                           train_kw={"device": "cpu", "log_every": 1})
    (curve,) = res[pt.name]["loss_curve"]
    assert curve["step"] == 1
    assert abs(curve["loss"] - float(jm["loss"])) <= 1e-5 * abs(
        float(jm["loss"]))


def test_cli_isoflop_prints_results_json(capsys):
    launch_train.main(["--isoflop", "--preset", "smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "64",
                       "--log-every", "1"])
    out = capsys.readouterr().out
    res = json.loads(out[out.index("\n{") + 1:])
    assert sorted(res) == ["mosa-paper-tiny-mosa8-smoke",
                           "mosa-paper-tiny-smoke"]
    for r in res.values():
        assert [h["step"] for h in r["loss_curve"]] == [0, 1]
        assert np.isfinite(r["final"]["loss"])


def test_cli_isoflop_refuses_cpu_fallback(monkeypatch):
    """Without ``--device`` the sweep runs on the card, and raises without
    one, as the single-config CLI does."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--isoflop", "--preset", "smoke", "--steps", "1",
                           "--batch", "2", "--seq", "32"])


def _metric_names(snap):
    return {kind: sorted(snap[kind]) for kind in ("counters", "gauges",
                                                  "histograms")}


def _train_step_spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("name") == "train_step"]


def test_trainer_telemetry_names_match_jax(tmp_path):
    """Both Trainers write their metrics snapshot and trace at exit: the
    same metric names, one ``train.step_time_s`` observation and one
    ``train_step`` span per step."""
    steps = 3
    common = dict(arch="mosa-paper", preset="smoke", seq_len=32,
                  global_batch=2, steps=steps, log_every=1,
                  arch_kwargs={"variant": "mosa"})
    out = {}
    for name, mod, cfg_cls, trainer_cls, extra in (
            ("jax", jobs, JTrainConfig, JTrainer, {}),
            ("torch", obs, TrainConfig, Trainer, {"device": "cpu"})):
        mod.registry().reset()
        mod.tracer().reset()
        mpath, tpath = tmp_path / f"{name}.jsonl", tmp_path / f"{name}.json"
        trainer_cls(cfg_cls(metrics_path=str(mpath), trace_path=str(tpath),
                            **common, **extra)).run(install_signals=False)
        snap = obs.read_last_snapshot(str(mpath))
        assert snap["tag"] == "trainer"
        assert snap["histograms"]["train.step_time_s"]["count"] == steps
        spans = _train_step_spans(tpath)
        assert [e["args"]["step"] for e in spans] == list(range(steps))
        out[name] = _metric_names(snap)
    assert out["torch"] == out["jax"]
    assert "train.tokens_per_s" in out["torch"]["gauges"]
    assert "train.router.sel_entropy" in out["torch"]["histograms"]
