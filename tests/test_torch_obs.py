"""The port's copies of ``repro.obs`` and ``repro.serve.loadgen`` against
the originals: the same operations on both give the same histogram
quantiles, Chrome trace, Prometheus text, merged snapshots, SLO records
and goodput (exact: pure Python on the same floats), the seeded workloads
are equal, and the port's Scheduler keeps its counters consistent and
writes its artifacts.  Also the serving CLI on the CPU (batch generate and
the ``--load-rate`` Scheduler run)."""

import json

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.serve import loadgen as jload

from repro_torch import obs
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import Server, main
from repro_torch.serve import loadgen
from repro_torch.serve.paged_kv import PagedConfig
from repro_torch.serve.scheduler import Scheduler

from test_torch_parity import one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


@pytest.fixture(autouse=True)
def fresh_obs():
    """Each test starts from an empty, enabled registry and tracer."""
    obs.set_enabled(True)
    obs.registry().reset()
    obs.tracer().reset()
    yield
    obs.set_enabled(True)


def _fill(reg):
    """One trace of registry operations, labeled and not."""
    rng = np.random.default_rng(0)
    for v in rng.exponential(0.05, 200):
        reg.observe("serve.ttft_s", float(v))
    for v in rng.uniform(0, 1, 50):
        reg.observe("serve.chunk_packed_efficiency", float(v),
                    bounds=jobs.UNIT_BOUNDS)
    reg.inc("serve.finished", 3)
    reg.inc("serve.finished", 2, tenant='a"b')
    reg.set("serve.queue_depth", 4)
    reg.set_max("pool.dense.live_high_water", 7)
    reg.set_max("pool.dense.live_high_water", 5)
    reg.observe("serve.ttft_s", 0.3, tenant="gold")


def test_histogram_quantiles_match_jax():
    a, b = jobs.Registry(), obs.Registry()
    _fill(a)
    _fill(b)
    for name in ("serve.ttft_s", "serve.chunk_packed_efficiency"):
        ha, hb = a.histogram(name), b.histogram(name)
        assert hb.percentiles() == ha.percentiles()
        assert hb.summary() == ha.summary()
    h = obs.Histogram("x")
    h.observe(0.123)
    assert h.quantile(0.5) == 0.123           # a single observation exactly


def test_prometheus_and_snapshot_match_jax():
    a, b = jobs.Registry(), obs.Registry()
    _fill(a)
    _fill(b)
    assert obs.prometheus_text(b) == jobs.prometheus_text(a)
    sa, sb = a.snapshot(), b.snapshot()
    for part in ("counters", "gauges", "histograms"):
        assert sb[part] == sa[part]
    assert obs.merge_snapshots([sb, sb])["counters"] == \
        jobs.merge_snapshots([sa, sa])["counters"]


def test_disabled_registry_writes_nothing():
    reg = obs.Registry(enabled=False)
    _fill(reg)
    with reg.timer("t") as tm:
        pass
    assert tm.dt >= 0
    assert reg.snapshot() == {"counters": {}, "gauges": {},
                              "gauges_meta": {}, "histograms": {}}


def _spans(tr):
    t0 = 1.0
    tr.add("queued", t0, t0 + 0.2, track="req5")
    tr.add("prefill", t0 + 0.2, t0 + 0.5, track="req5", prompt=16)
    tr.add("decode", t0 + 0.5, t0 + 1.5, track="req5", tokens=11)
    tr.add("finish", t0 + 1.5, t0 + 1.5, track="req5", tokens=11,
           tenant="a")
    tr.add("shed", t0 + 2, t0 + 2, track="req7", tenant="b")
    tr.add("queued", t0, t0 + 9.9, track="req9")          # never finished
    tr.add("prefill_chunk", t0, t0 + 0.1, track="sched", segs=3)


def test_chrome_trace_and_records_from_spans_match_jax():
    a, b = jobs.Tracer(), obs.Tracer()
    _spans(a)
    _spans(b)
    assert b.chrome_trace() == a.chrome_trace()
    ra = jobs.records_from_spans(a.spans())
    rb = obs.records_from_spans(b.spans())
    assert rb == ra
    recs = {r["rid"]: r for r in rb}
    assert recs[5]["ttft_s"] == pytest.approx(0.5)
    assert recs[5]["tpot_s"] == pytest.approx(0.1)
    assert recs[7]["outcome"] == "shed"
    assert recs[9]["outcome"] == "incomplete"
    spec_a = jobs.SLOSpec(ttft_s=0.6, tpot_s=0.2)
    spec_b = obs.SLOSpec(ttft_s=0.6, tpot_s=0.2)
    assert obs.evaluate(rb, spec_b) == jobs.evaluate(ra, spec_a)


def test_tracer_ring_drops_and_dump(tmp_path):
    tr = obs.Tracer(capacity=4)
    for i in range(7):
        tr.instant(f"e{i}")
    assert len(tr) == 4 and tr.dropped_spans == 3
    reg = obs.Registry()
    reg.inc("x")
    obs.dump(str(tmp_path / "m.jsonl"), str(tmp_path / "t.json"),
             str(tmp_path / "m.prom"), reg=reg, tr=tr, tag="t")
    snap = obs.read_last_snapshot(str(tmp_path / "m.jsonl"))
    assert snap["tag"] == "t" and snap["gauges"]["tracer.dropped_spans"] == 3
    doc = json.loads((tmp_path / "t.json").read_text())
    assert doc["otherData"]["dropped_spans"] == 3
    assert "# TYPE x counter" in (tmp_path / "m.prom").read_text()


def test_profiler_passthrough_writes_a_trace(tmp_path):
    assert obs.start_profiler(str(tmp_path))
    with obs.tracer().span("annotated", track="sched"):
        torch.ones(8).sum()
    assert obs.stop_profiler()
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "annotated" for e in doc["traceEvents"])
    assert not obs.stop_profiler()


@pytest.mark.parametrize("kind", ["poisson", "bursty", "closed"])
def test_workloads_equal_jax(kind):
    tenants = [jload.TenantSpec("gold", 1.0, (4, 12), (2, 4)),
               jload.TenantSpec("free", 2.0, (8, 40), (1, 9))]
    ttenants = [loadgen.TenantSpec(*dataclass_fields(t)) for t in tenants]
    if kind == "closed":
        ja = jload.closed_workload(20, 7, 512, tenants)
        ta = loadgen.closed_workload(20, 7, 512, ttenants)
    else:
        fn = kind + "_workload"
        ja = getattr(jload, fn)(3.0, 20, 7, 512, tenants)
        ta = getattr(loadgen, fn)(3.0, 20, 7, 512, ttenants)
    assert len(ta) == len(ja) == 20
    for x, y in zip(ta, ja):
        assert (x.t, x.tenant, x.max_new) == (y.t, y.tenant, y.max_new)
        np.testing.assert_array_equal(x.prompt, y.prompt)


def dataclass_fields(spec):
    return (spec.name, spec.weight, spec.prompt_len, spec.max_new)


# ---------------------------------------------------- scheduler counters
def _server(num_blocks=14):
    cfg = get_config("mosa-paper", preset="smoke", variant="mosa")
    return Server(cfg, batch=2, max_len=64, device="cpu", seed=0,
                  paged=PagedConfig(block_size=8, num_blocks=num_blocks))


@pytest.mark.parametrize("lens,max_new", [((5, 24, 9), 4),
                                          ((50, 50, 3), 12)])
def test_scheduler_counter_consistency(lens, max_new):
    """Drain invariant: admitted == finished + preempted, submitted ==
    finished, in-flight and queue depth back to zero.  In the second mix
    two 50-token prompts fill the 14-block pool (7 blocks each) and decode
    growth to an 8th block preempts."""
    reg = obs.registry()
    sched = Scheduler(_server(), chunk=4, prefix_cache=False)
    rng = np.random.default_rng(1)
    for L in lens:
        sched.submit(rng.integers(2, 512, (L,)), max_new=max_new)
    out = sched.run()
    assert all(len(v) == max_new for v in out.values())
    snap = reg.snapshot()
    c = snap["counters"]
    assert c["serve.admitted"] == \
        c["serve.finished"] + c.get("serve.preempted", 0)
    assert c["serve.submitted"] == c["serve.finished"] == len(lens)
    assert snap["gauges"]["serve.in_flight"] == 0
    assert snap["gauges"]["serve.queue_depth"] == 0
    assert c["serve.generated_tokens"] == len(lens) * max_new
    assert sched.stats["preemptions"] == c.get("serve.preempted", 0)
    assert c["server.prefill_dispatches"] == sched.stats["prefill_chunks"]
    if len(lens) == 3 and max_new == 12:
        assert sched.stats["preemptions"] >= 1


def test_scheduler_artifacts_and_lifecycle(tmp_path):
    """The Chrome trace holds queued -> prefill -> decode for every
    request; the metrics snapshot carries TTFT/TPOT, packing efficiency,
    pool gauges, prefix counters and the serve-time router health; the
    SLO records equal the ones rebuilt from the spans."""
    mpath, tpath = tmp_path / "metrics.jsonl", tmp_path / "trace.json"
    sched = Scheduler(_server(24), chunk=4, metrics_path=str(mpath),
                      trace_path=str(tpath), router_health_every=1)
    rng = np.random.default_rng(2)
    rids = [sched.submit(rng.integers(2, 512, (L,)), max_new=4)
            for L in (5, 11, 7)]
    sched.run()
    doc = json.loads(tpath.read_text())
    names = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M"}
    by_track = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X":
            by_track.setdefault(names[e["tid"]], set()).add(e["name"])
    for r in rids:
        assert {"queued", "prefill", "decode"} <= by_track[f"req{r}"]
    assert {"prefill_chunk", "decode_chunk"} <= by_track["sched"]
    snap = json.loads(mpath.read_text().splitlines()[-1])
    h, g = snap["histograms"], snap["gauges"]
    assert h["serve.ttft_s"]["count"] == h["serve.tpot_s"]["count"] == 3
    assert 0 < h["serve.chunk_packed_efficiency"]["max"] <= 1.0
    assert 0.0 <= h["serve.router.drop_rate"]["max"] <= 1.0
    assert "serve.router.sel_entropy" in h
    assert g["pool.dense.live_blocks"] == g.get("prefix.nodes", 0)
    assert g["serve.tokens_per_s"] > 0
    from_spans = {r["rid"]: r for r in
                  obs.records_from_spans(obs.tracer().spans())}
    for rid, rec in sched.records.items():
        for k, v in rec.items():
            assert from_spans[rid][k] == pytest.approx(v, rel=1e-9), k


def test_scheduler_sheds_past_max_queue():
    sched = Scheduler(_server(24), chunk=4, max_queue=2)
    rng = np.random.default_rng(3)
    rids = [sched.submit(rng.integers(2, 512, (6,)), max_new=2)
            for _ in range(4)]
    out = sched.run()
    assert [len(out[r]) for r in rids] == [2, 2, 0, 0]
    assert obs.registry().snapshot()["counters"]["serve.shed"] == 2
    assert [sched.records[r]["outcome"] for r in rids] == \
        ["finished", "finished", "shed", "shed"]


# -------------------------------------------------------------------- CLI
SMOKE = ["--device", "cpu", "--preset", "smoke", "--variant", "mosa"]


def test_cli_batch_generate_on_cpu(capsys):
    main(SMOKE + ["--batch", "2", "--prompt-len", "8", "--gen", "4",
                  "--max-len", "32"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "on cpu" in out
    assert "KV entries per MoSA layer" in out


def test_cli_load_rate_prints_slo_json(capsys, tmp_path):
    main(SMOKE + ["--batch", "2", "--max-len", "64", "--load-rate", "100",
                  "--load-n", "4", "--trace-path",
                  str(tmp_path / "t.json")])
    ev = json.loads(capsys.readouterr().out)
    assert ev["total"] == ev["finished"] == 4
    assert ev["device"] == "cpu" and ev["offered_req_s"] == 100.0
    assert 0.0 <= ev["goodput"] <= 1.0
    assert (tmp_path / "t.json").exists()
