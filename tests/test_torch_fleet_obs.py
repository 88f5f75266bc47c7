"""The port's observability plane and multi-tenant fleet (verbatim copies of
``obs/{trace,metrics,report}``, ``runtime/fleet`` and ``core/scenarios``)
driving the port's servers, against the JAX package's, on the CPU.

Both packages' ``build_demo_server`` draw the same numpy weights, and the
engines run on a modelled service time, so every field that comes from
numpy is held EXACTLY equal: report rows, trace events (all but the
host-clock fields: the ``serve_batch`` span's ``wall_us`` and the
controller spans' ``wall_s``), critical paths, timelines, metrics and
arrival draws.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import scenarios as JSC  # noqa: E402
from repro.core import simulator as JSIM  # noqa: E402
from repro.obs import metrics as JM  # noqa: E402
from repro.obs import report as JR  # noqa: E402
from repro.obs import trace as JT  # noqa: E402
from repro.runtime import controller as JCTL  # noqa: E402
from repro.runtime import engine as JENG  # noqa: E402
from repro.runtime import failures as JFAIL  # noqa: E402
from repro.runtime import fleet as JFLEET  # noqa: E402
from repro_torch.core import planner as TPL  # noqa: E402
from repro_torch.core import scenarios as TSC  # noqa: E402
from repro_torch.core import simulator as TSIM  # noqa: E402
from repro_torch.core.plan_ir import PlanIR as TPlanIR  # noqa: E402
from repro_torch.obs import (MetricsRegistry as TMetrics,  # noqa: E402
                             Tracer as TTracer)
from repro_torch.obs import report as TR  # noqa: E402
from repro_torch.runtime import controller as TCTL  # noqa: E402
from repro_torch.runtime import engine as TENG  # noqa: E402
from repro_torch.runtime import failures as TFAIL  # noqa: E402
from repro_torch.runtime import fleet as TFLEET  # noqa: E402
from test_engine import _toy_ir  # noqa: E402
from test_fleet import _tenant_ir  # noqa: E402

JAX = dict(eng=JENG, ctl=JCTL, fail=JFAIL, fleet=JFLEET, sc=JSC,
           tracer=JT.Tracer, metrics=JM.MetricsRegistry, report=JR)
PORT = dict(eng=TENG, ctl=TCTL, fail=TFAIL, fleet=TFLEET, sc=TSC,
            tracer=TTracer, metrics=TMetrics, report=TR)


def _port_ir(ir):
    """The JAX package's PlanIR as the port's (every field is numpy, a
    tuple of names or a float)."""
    return TPlanIR(**{f.name: getattr(ir, f.name)
                      for f in dataclasses.fields(ir)})


def _server(pkg, ir):
    if pkg is PORT:
        return TENG.build_demo_server(_port_ir(ir), feat=8, hidden=16,
                                      n_classes=3, seed=0, device="cpu")
    return JENG.build_demo_server(ir, feat=8, hidden=16, n_classes=3, seed=0)


def _chaos_trace(pkg):
    gen = pkg["sc"].MMPPArrivals(rates=(100.0, 1500.0), dwell=(0.05, 0.02),
                                 sizes=(1, 2))
    return gen.generate(np.random.default_rng(3), 0.4)


def _engine(pkg, *, chaos, tracer=None, metrics=None):
    """``tests/test_obs.py``'s chaos engine, in either package."""
    ir = _toy_ir()
    srv = _server(pkg, ir)
    ctl = None
    if chaos:
        events = pkg["fail"].markov_flap_schedule(
            list(ir.device_names), 0.2, 0.5, 60, np.random.default_rng(7))
        ctl = pkg["ctl"].ClusterController(
            srv.ir if pkg is PORT else ir, server=srv,
            injector=pkg["fail"].FailureInjector(events), seed=0)
    cfg = pkg["eng"].EngineConfig(
        max_batch=8, max_wait=0.01, slo=0.2, service_model=(2e-3, 1e-4),
        input_dim=8, seed=0, chaos_every=0.02 if chaos else None,
        pipeline_depth=2)
    return pkg["eng"].ServingEngine(srv, cfg, controller=ctl, tracer=tracer,
                                    metrics=metrics)


def _rows(report):
    """An EngineReport's record, batch and migration rows."""
    return ([dataclasses.astuple(r) for r in report.records],
            [dataclasses.astuple(b) for b in report.batches],
            [(t, o.kind, o.moved_devices) for t, o in report.migrations])


def _assert_rows_equal(a, b):
    """Row by row, NaN equal to NaN (an unserved request's times)."""
    for ra, rb in zip(_rows(a), _rows(b)):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            np.testing.assert_equal(x, y)


WALL = ("wall_us", "wall_s")


def _jsonl(tracer, path):
    """The trace as JSONL records, the host-clock fields (``wall_us``,
    ``wall_s``) dropped."""
    tracer.dump_jsonl(str(path))
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        for k in WALL:
            rec["attrs"].pop(k, None)
        out.append(rec)
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["calm", "chaos"])
def traced(request):
    """The same traced engine run in both packages: (report, tracer,
    metrics) each."""
    chaos = request.param
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        tr, m = pkg["tracer"](), pkg["metrics"]()
        rep = _engine(pkg, chaos=chaos, tracer=tr, metrics=m).run(
            *_chaos_trace(pkg))
        out[name] = (rep, tr, m)
    return chaos, out


def test_traced_engine_trace_jsonl_equals_jax(traced, tmp_path):
    chaos, out = traced
    (jrep, jtr, _), (trep, ttr, _) = out["jax"], out["port"]
    _assert_rows_equal(jrep, trep)
    j = _jsonl(jtr, tmp_path / "j.jsonl")
    t = _jsonl(ttr, tmp_path / "t.jsonl")
    assert len(j) == len(t) > 0
    assert j == t
    names = {r["name"] for r in t}
    assert {"request", "batch_wait", "serve_batch"} <= names
    if chaos:
        assert {"chaos_tick", "migrate"} <= names
    assert all("wall_us" in e.attrs for e in ttr.spans("serve_batch"))


def test_tracing_off_gives_identical_report_rows(traced):
    chaos, out = traced
    trep = out["port"][0]
    plain = _engine(PORT, chaos=chaos).run(*_chaos_trace(PORT))
    _assert_rows_equal(plain, trep)


def test_critical_paths_and_timeline_equal_jax(traced):
    """``obs.report`` over each package's own trace: every request path,
    the p99 and p50 critical paths and the failure/repair timeline equal;
    segments sum to each request's latency."""
    _, out = traced
    jev, tev = out["jax"][1].events, out["port"][1].events
    jp, tp = JR.request_paths(jev), TR.request_paths(tev)
    assert [dataclasses.astuple(p) for p in jp] == \
        [dataclasses.astuple(p) for p in tp]
    for p in tp:
        assert sum(d for _, d in p.segments) == pytest.approx(p.latency,
                                                              abs=1e-9)
    for q in (99.0, 50.0):
        jc, tc = JR.critical_path(jev, q=q), TR.critical_path(tev, q=q)
        assert (tc.n, tc.target_latency, dataclasses.astuple(tc.path)) == \
            (jc.n, jc.target_latency, dataclasses.astuple(jc.path))
    assert JR.failure_timeline(jev) == TR.failure_timeline(tev)


def test_metrics_equal_jax(traced):
    """The registries' collected rows (counters, gauges, P² sketches) are
    equal."""
    _, out = traced
    assert out["jax"][2].collect() == out["port"][2].collect()


def _fleet(pkg, tracer=None, metrics=None):
    """``tests/test_obs.py``'s two-tenant fleet under chaos, in either
    package."""
    def tenant(name, ir, slo_cls):
        srv = _server(pkg, ir)
        ctl = pkg["ctl"].ClusterController(
            srv.ir if pkg is PORT else ir, server=srv, seed=0,
            require_feasible=False)
        cfg = pkg["eng"].EngineConfig(
            max_batch=8, max_wait=0.01, slo=slo_cls.slo,
            service_model=(2e-3, 1e-4), input_dim=8, seed=0,
            pipeline_depth=2)
        return pkg["fleet"].TenantSpec(name, srv, controller=ctl,
                                       slo=slo_cls, config=cfg)

    F = pkg["fleet"]
    tenants = [tenant("gold", _tenant_ir("g"), F.SLOClass("gold", 0.2, 4.0)),
               tenant("bulk", _tenant_ir("b"),
                      F.SLOClass("bronze", 0.2, 1.0))]
    injector = pkg["fail"].FailureInjector(pkg["fail"].markov_flap_schedule(
        [d for t in ("g", "b") for d in
         (f"{t}-a", f"{t}-b", f"{t}-c", f"{t}-d")],
        0.2, 0.5, 30, np.random.default_rng(7)))
    return F.FleetEngine(tenants, router=F.FleetRouter("predicted"),
                         fleet_controller=F.FleetController(tenants, []),
                         injector=injector, chaos_every=0.02, seed=0,
                         tracer=tracer, metrics=metrics)


def test_fleet_report_rows_equal_jax(tmp_path):
    """A two-tenant ``FleetEngine`` over the port's servers: every
    tenant's report rows and the fleet summary equal the JAX fleet's; the
    traced run's JSONL equals too, and tracing changes no row."""
    runs = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        traces = [pkg["sc"].PoissonArrivals(300.0).generate(
            np.random.default_rng(s), 0.3) for s in (2, 5)]
        tr = pkg["tracer"]()
        runs[name] = (_fleet(pkg).run(traces),
                      _fleet(pkg, tracer=tr,
                             metrics=pkg["metrics"]()).run(traces), tr)
    (jplain, jtraced, jtr), (tplain, ttraced, ttr) = runs["jax"], runs["port"]
    assert tplain.tenants == jplain.tenants == ("gold", "bulk")
    for a, b, c in zip(jplain.reports, tplain.reports, ttraced.reports):
        _assert_rows_equal(a, b)
        _assert_rows_equal(b, c)
    np.testing.assert_equal(tplain.summary(), jplain.summary())
    assert sum(len(r.migrations) for r in tplain.reports) > 0
    assert _jsonl(jtr, tmp_path / "j.jsonl") == _jsonl(ttr,
                                                       tmp_path / "t.jsonl")
    assert {p.tenant for p in TR.request_paths(ttr.events)} == \
        {"gold", "bulk"}


@pytest.mark.parametrize("gen", [
    ("PoissonArrivals", dict(rate=400.0, sizes=(1, 2, 4),
                             size_probs=(0.5, 0.3, 0.2))),
    ("PoissonArrivals", dict(rate=50.0)),
    ("MMPPArrivals", dict(rates=(100.0, 1500.0), dwell=(0.05, 0.02),
                          sizes=(1, 2))),
    ("MMPPArrivals", dict(rates=(10.0, 200.0, 900.0),
                          dwell=(0.1, 0.05, 0.01))),
], ids=["poisson-sizes", "poisson", "mmpp", "mmpp3"])
def test_arrival_draws_equal(gen):
    name, kw = gen
    for seed in (0, 3):
        jt, js = getattr(JSC, name)(**kw).generate(
            np.random.default_rng(seed), 0.5)
        tt, ts = getattr(TSC, name)(**kw).generate(
            np.random.default_rng(seed), 0.5)
        np.testing.assert_array_equal(jt, tt)
        np.testing.assert_array_equal(js, ts)
        assert len(tt) > 0


@pytest.mark.parametrize("scenario", [
    ("CorrelatedFailures", dict(domains={"r0": ["a", "b"], "r1": ["c"]},
                                domain_fail_prob=0.3)),
    ("StragglerScenario", dict(dist="lognormal")),
    ("StragglerScenario", dict(dist="exponential", deadline=1.0)),
    ("MarkovLinkScenario", dict(p_fail=0.2))],
    ids=["correlated", "straggler", "straggler-exp", "markov"])
def test_failure_scenarios_draw_equal(scenario):
    """Each failure scenario samples the same aliveness and delays from
    the same generator over the same plan arrays."""
    name, kw = scenario
    ir = _toy_ir()
    ja = JSIM.plan_arrays(ir)
    ta = TSIM.plan_arrays(_port_ir(ir))
    jout = getattr(JSC, name)(**kw).sample(np.random.default_rng(1), ja, 64)
    tout = getattr(TSC, name)(**kw).sample(np.random.default_rng(1), ta, 64)
    for a, b in zip(jout, tout):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)


def test_thin_replicas_takes_a_port_curve():
    """The copied planner consumes the copied ``RobustnessCurve``."""
    from repro_torch.core.failout import RobustnessCurve
    ir = _port_ir(_toy_ir())
    thin = TPL.thin_replicas(ir, RobustnessCurve([0, 1], [0.9, 0.9],
                                                 [0.9, 0.9]))
    assert thin.member.sum() < ir.member.sum()
    weak = TPL.thin_replicas(ir, RobustnessCurve([0, 1], [0.9, 0.5],
                                                 [0.9, 0.4]))
    np.testing.assert_array_equal(weak.member, ir.member)
