"""``repro_torch.obs`` against ``repro.obs``: span nesting and the
disabled / forced fast paths, ``coverage``, the Chrome-trace round
trip, synthetic per-round spans, histogram quantiles (the reference's
registry fed the same observations, and exact numpy percentiles within
one bucket width, the registry's documented resolution), the metrics
switch, the SLO plane, structured logging and the ``REPRO_OBS`` knob.

Everything here is exact except the numpy-percentile check, whose
tolerance is the reference's bucket-width rule (adjacent bounds differ
by 10^(1/20) ~ 1.122 at 20 buckets per decade).
"""

import json
import logging
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import obs as jobs
from repro.obs import device as jdevice
from repro.obs import metrics as jmetrics
from repro.obs import slo as jslo

from repro_torch import obs
from repro_torch.obs import device as tdevice
from repro_torch.obs import metrics, slo
from repro_torch.obs import trace as ttrace


@pytest.fixture(autouse=True)
def obs_sandbox():
    """Both packages' trace and metrics on and clean for each test; the
    process-global switches are restored afterwards."""
    saved = [(o, o.trace_enabled(), o.metrics_enabled(), o.device_enabled()) for o in (obs, jobs)]
    for o in (obs, jobs):
        o.enable(trace=True, metrics_on=True)
        o.clear_trace()
        o.metrics.reset()
    yield
    for o, tr, me, dv in saved:
        o.clear_trace()
        o.metrics.reset()
        o.disable()
        if tr or me:
            o.enable(trace=tr, metrics_on=me)
        (o.enable_device if dv else o.disable_device)()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def test_span_nesting_and_chrome_export_roundtrip(tmp_path):
    with obs.span("outer", a=1):
        with obs.span("inner.one"):
            pass
        with obs.span("inner.two", k="v"):
            pass
    recs = obs.spans()
    outer = next(r for r in recs if r.name == "outer")
    inners = [r for r in recs if r.name.startswith("inner")]
    assert outer.parent_id == 0 and len(inners) == 2
    assert all(r.parent_id == outer.span_id for r in inners)
    assert outer.dur >= max(r.dur for r in inners)

    p = tmp_path / "trace.json"
    doc = obs.export_chrome_trace(str(p))
    loaded = json.loads(p.read_text())
    assert loaded == json.loads(json.dumps(doc, default=float))
    evs = loaded["traceEvents"]
    assert {e["name"] for e in evs} == {"outer", "inner.one", "inner.two"}
    for e in evs:
        assert e["ph"] == "X" and e["dur"] >= 0 and e["ts"] > 0
        assert {"name", "cat", "pid", "tid", "args"} <= set(e)
    by_name = {e["name"]: e for e in evs}
    assert by_name["inner.one"]["args"]["parent_id"] == by_name["outer"]["args"]["span_id"]
    assert by_name["outer"]["args"]["a"] == 1 and by_name["inner.two"]["args"]["k"] == "v"
    assert by_name["inner.one"]["cat"] == "inner"


def test_disabled_span_is_shared_noop():
    obs.disable()
    s1, s2 = obs.span("x"), obs.span("y")
    assert s1 is s2
    with s1:
        pass
    obs.enable(trace=True, metrics_on=True)
    assert obs.spans("x") == []


def test_force_span_measures_without_recording():
    obs.disable()
    sp = obs.span("bench.t", force=True)
    with sp:
        out = torch.arange(10_000).sum()
        sp.sync_on(out)  # a CPU tensor passes through the sync
    assert sp.dur > 0 and sp.dispatch_s is not None and sp.dispatch_s <= sp.dur
    obs.enable(trace=True, metrics_on=True)
    assert obs.spans("bench.t") == []


def test_span_syncs_only_when_asked(monkeypatch):
    """A span without ``sync=`` never touches the device; with ``sync=``
    it waits on an event of the tensors' own devices only."""
    calls = []

    class Event:
        def record(self, stream):
            calls.append(("record", stream))

        def synchronize(self):
            calls.append(("sync",))

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: f"stream:{dev}")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(("device",)))
    with obs.span("no.sync"):
        pass
    with obs.span("host.sync", sync=(np.zeros(3), torch.zeros(2), {"x": [1.0]})):
        pass
    assert calls == []
    fake = torch.empty(0, device="meta")
    monkeypatch.setattr(ttrace, "_cuda_devices", lambda out, found: {torch.device("cuda", 0)})
    with obs.span("card.sync", sync=fake):
        pass
    assert calls == [("record", "stream:cuda:0"), ("sync",)]


def test_error_and_misnested_spans():
    with pytest.raises(ValueError):
        with obs.span("boom"):
            raise ValueError("x")
    (rec,) = obs.spans("boom")
    assert rec.attrs["error"] == "ValueError"
    a = obs.span("a")
    a.__enter__()
    b = obs.span("b")
    b.__enter__()
    a.__exit__(None, None, None)  # out of order: tolerated
    b.__exit__(None, None, None)
    assert ttrace._stack() == []


def test_coverage_is_union_of_child_intervals():
    def records(mod):
        root = mod.SpanRecord("r", t0=0.0, dur=10.0, span_id=1)
        kids = [
            mod.SpanRecord("a", t0=0.0, dur=4.0, span_id=2, parent_id=1),
            mod.SpanRecord("b", t0=3.0, dur=4.0, span_id=3, parent_id=1),
            mod.SpanRecord("c", t0=9.0, dur=5.0, span_id=4, parent_id=1),
            mod.SpanRecord("d", t0=1.0, dur=1.0, span_id=5, parent_id=2),  # grandchild
        ]
        return root, [root] + kids

    got = obs.coverage(*records(obs))
    assert got == jobs.coverage(*records(jobs)) == pytest.approx(0.8)
    assert obs.coverage(obs.SpanRecord("z", t0=0.0, dur=0.0)) == 0.0


def test_profiler_annotations_name_spans():
    obs.enable(trace=True, metrics_on=True, profiler_annotations=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("annotated.phase"):
            torch.ones(4).sum()
    assert "annotated.phase" in {e.name for e in prof.events()}


# ---------------------------------------------------------------------------
# synthetic per-round spans
# ---------------------------------------------------------------------------


def test_synthetic_round_spans_roundtrip_chrome_trace(tmp_path):
    with obs.span("laf.label_prop", rows=8) as sp:
        time.sleep(0.01)
    parent = sp._rec
    per_round = {"frontier": [5, 3, 1], "changed": [6, 3, 0], "hops": [2, 1, 0], "shard_wins": [5, 3, 1]}
    recs = tdevice.emit_round_spans(parent, per_round)
    assert len(recs) == 3 and recs[0].t0 == parent.t0
    assert all(r.dur == pytest.approx(parent.dur / 3) for r in recs)
    assert recs[-1].t0 + recs[-1].dur == pytest.approx(parent.t0 + parent.dur)
    assert obs.coverage(parent) == pytest.approx(1.0)
    p = tmp_path / "trace.json"
    obs.export_chrome_trace(str(p))
    evs = json.loads(p.read_text())["traceEvents"]
    parent_ev = next(e for e in evs if e["name"] == "laf.label_prop")
    rounds = sorted((e for e in evs if e["name"] == "laf.cluster.round"), key=lambda e: e["ts"])
    assert len(rounds) == 3
    for i, e in enumerate(rounds):
        assert e["args"]["parent_id"] == parent_ev["args"]["span_id"]
        assert e["args"]["synthetic"] is True and e["args"]["round"] == i
        assert e["args"]["frontier"] == per_round["frontier"][i]


def test_emit_round_spans_noops_safely():
    before = len(obs.spans())
    assert tdevice.emit_round_spans(None, {"frontier": [1]}) == []
    with obs.span("p") as sp:
        pass
    assert tdevice.emit_round_spans(sp._rec, {"frontier": []}) == []
    assert len(obs.spans()) == before + 1


def test_harvests_match_reference():
    rng = np.random.default_rng(4)
    tele = rng.integers(0, 50, (4, 64)).astype(np.int32)
    slab = rng.integers(0, 10_000, (5, 3)).astype(np.int32)
    assert tdevice.harvest_cluster_telemetry(tele, 7) == jdevice.harvest_cluster_telemetry(tele, 7)
    assert tdevice.harvest_sweep_telemetry(slab) == jdevice.harvest_sweep_telemetry(slab)
    assert tdevice.harvest_sweep_telemetry(None) is None
    np.testing.assert_array_equal(tdevice.last_sweep_stats(), slab)
    assert metrics.snapshot("laf.telemetry.") == jmetrics.snapshot("laf.telemetry.")
    assert metrics.snapshot("sweep.tele.") == jmetrics.snapshot("sweep.tele.")
    t = tdevice.cluster_telemetry_init(8, device="cpu")
    assert t.shape == (4, 8) and t.dtype == torch.int32 and not t.any()
    assert tdevice.sweep_stats_tile_sum(torch.ones((1, 3), dtype=torch.int32)).tolist() == [1, 1, 1]
    assert tdevice.CLUSTER_ROUND_FIELDS == jdevice.CLUSTER_ROUND_FIELDS
    assert tdevice.SWEEP_STAT_FIELDS == jdevice.SWEEP_STAT_FIELDS
    assert tdevice.MAX_ROUNDS == jdevice.MAX_ROUNDS


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["lognormal", "zeros_and_overflow"])
def test_histogram_quantiles_match_reference_and_numpy(kind):
    rng = np.random.default_rng(0)
    if kind == "lognormal":  # latency-like, ~3 decades around a millisecond
        samples = rng.lognormal(mean=-6.5, sigma=1.2, size=5000)
    else:
        samples = np.concatenate([np.zeros(50), rng.uniform(1e-3, 1e-1, 400), [150.0, 300.0]])
    th, jh = metrics.histogram(f"test.{kind}"), jmetrics.histogram(f"test.{kind}")
    for v in samples:
        th.observe(float(v))
        jh.observe(float(v))
    assert th.summary() == jh.summary()
    for q in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
    if kind == "lognormal":
        for q in (0.50, 0.95, 0.99):
            exact = float(np.quantile(samples, q))
            assert abs(th.quantile(q) - exact) / exact < 0.13, q
    s = th.summary()
    assert s["count"] == len(samples) and s["p50"] <= s["p95"] <= s["p99"] <= s["max"]


def test_histogram_clamps_zero_to_first_bound():
    h = metrics.histogram("tele.h", bounds=(1e-4, 1e-3, 1e-2))
    for v in (0.0, -0.0, 1e-9, 1e-4):
        h.observe(v)
    assert h.count == 4 and h._counts[0] == 4 and h._min == 1e-4
    assert h.quantile(0.5) == pytest.approx(1e-4)
    h.observe(5e-3)
    assert h._counts[0] == 4 and h.count == 5 and h._max == 5e-3


def test_metrics_disabled_records_nothing_and_snapshot():
    obs.disable()
    metrics.counter("off.c", "help text").inc(5)
    metrics.gauge("off.g").set(3.0)
    metrics.histogram("off.h").observe(1.0)
    assert metrics.counter("off.c").value == 0 and metrics.histogram("off.h").count == 0
    assert metrics.snapshot("off.") == {"off.c": 0, "off.h": {"count": 0}}
    obs.enable(trace=False, metrics_on=True)
    metrics.counter("off.c").inc(2)
    metrics.gauge("off.g").set(3.0)
    assert metrics.counter("off.c").help == "help text"
    assert json.loads(metrics.to_json("off."))["off.g"] == 3.0
    assert metrics.snapshot("off.c") == {"off.c": 2}
    metrics.reset()
    assert metrics.snapshot("off.") == {"off.c": 0, "off.h": {"count": 0}}
    with pytest.raises(TypeError):
        metrics.gauge("off.c")


def test_phase_clock_publishes_only_with_metrics_on():
    clock = metrics.PhaseClock(torch.device("cpu"))
    clock.mark("start")
    clock.mark("work")
    out = clock.publish("test.phase")
    assert out["work"] >= 0 and metrics.snapshot("test.phase.") == {"test.phase.work_s": out["work"]}
    metrics.reset()
    metrics.disable()
    assert "work" in clock.publish("test.phase") and metrics.snapshot("test.phase.") == {}


# ---------------------------------------------------------------------------
# switches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("val,want", [
    ("1", (True, True, False)), ("trace", (True, False, False)),
    ("metrics", (False, True, False)), ("device", (True, True, True)),
    ("0", (False, False, False)), ("", (False, False, False)),
])
def test_enable_from_env_matches_reference(val, want):
    for o in (obs, jobs):
        o.disable()
        assert o.enable_from_env({"REPRO_OBS": val}) == any(want)
        assert (o.trace_enabled(), o.metrics_enabled(), o.device_enabled()) == want


# ---------------------------------------------------------------------------
# SLO plane and logging
# ---------------------------------------------------------------------------


def test_slo_evaluate_matches_reference():
    # metric names of their own: registrations outlive ``reset()`` in both
    # process-global registries, and the reference's own SLO test
    # (tests/test_device_telemetry.py) expects ``t.lat``/``t.runs`` unregistered
    def rules(mod):
        return [mod.SLO("lat-p99", "port_slo.lat:p99", "<=", 1.0),
                mod.SLO("runs-floor", "port_slo.runs", ">=", 1.0),
                mod.SLO("derived-ari", "run.ari", ">=", 0.99),
                mod.SLO("lat-p50", "port_slo.lat:p50", "<", 1e-3)]

    def view(res):
        return [(r.slo.name, r.value, r.ok, r.violated) for r in res]

    assert view(slo.evaluate(rules(slo))) == view(jslo.evaluate(rules(jslo)))
    assert all(r.ok is None for r in slo.evaluate(rules(slo)))
    for m in (metrics, jmetrics):
        m.counter("port_slo.runs").inc(3)
        h = m.histogram("port_slo.lat")
        for v in (0.01,) * 90 + (2.0,) * 10:
            h.observe(v)
    for vals in ({"run.ari": 0.995}, {"run.ari": 0.5}):
        got = slo.evaluate(rules(slo), values=vals)
        assert view(got) == view(jslo.evaluate(rules(jslo), values=vals))
    assert {r.slo.name: r.violated for r in got} == {
        "lat-p99": True, "runs-floor": False, "derived-ari": True, "lat-p50": True}
    assert slo.resolve_metric("absent.metric") is None


def test_slo_check_and_alert_counts_and_warns(caplog):
    rules = [slo.SLO("always-bad", "x.val", "<=", 0.0)]
    metrics.counter("x.val").inc(5)
    with caplog.at_level(logging.WARNING, logger="repro_torch.obs.slo"):
        res = slo.check_and_alert(rules, interval_s=0.0)
    assert res[0].violated
    snap = metrics.snapshot("slo.")
    assert snap["slo.evaluations"] == 1 and snap["slo.violations"] == 1
    text = "\n".join(r.getMessage() for r in caplog.records)
    assert "slo.violation" in text and "always-bad" in text and "value=5" in text


def test_slo_rule_sets():
    with pytest.raises(ValueError):
        slo.SLO("bad", "m", "!=", 1.0)
    for mine, ref in ((slo.SERVE_SLOS, jslo.SERVE_SLOS), (slo.INGEST_SLOS, jslo.INGEST_SLOS),
                      (slo.CLUSTER_SLOS, jslo.CLUSTER_SLOS), (slo.DEGRADED_SLOS, jslo.DEGRADED_SLOS)):
        assert [(r.name, r.metric, r.op, r.threshold) for r in mine] == [
            (r.name, r.metric, r.op, r.threshold) for r in ref]
    saved = list(slo.CLUSTER_SLOS)
    try:
        slo.set_slos("cluster", [slo.SLO("one", "a", "==", 1.0)])
        assert [r.name for r in slo.CLUSTER_SLOS] == ["one"]
    finally:
        slo.set_slos("cluster", saved)


def test_rate_limited_warn_and_log_event(caplog):
    log = obs.get_logger("test")
    assert log.name == "repro_torch.test" and obs.get_logger("repro_torch.x").name == "repro_torch.x"
    with caplog.at_level(logging.INFO, logger="repro_torch"):
        obs.log_event(log, "evt", a=1, b=0.5)
        assert obs.rate_limited_warn(log, "k-test", "warned", interval_s=60.0, x=1)
        assert not obs.rate_limited_warn(log, "k-test", "warned", interval_s=60.0, x=2)
    msgs = [r.getMessage() for r in caplog.records]
    assert msgs == ["evt a=1 b=0.5", "warned x=1"]
