"""Parity of the port's output- and compute-coded serving with the JAX
reference, on the CPU.

Each package builds its coded plan with its OWN ``select_redundancy`` from
the same replicate-only plan, and the two plans must be equal field by
field (coding arrays included). The same seed, failure model and inputs
then go to both demo servers: the fields from the shared numpy simulator
(``arrived``, ``latency``, ``degraded``, ``coverage``, ``share_times``,
``failed_devices``, engine records and share futures) must be EQUAL, and
logits agree within ``DEMO_TOL``. The JAX package's own fused and legacy
coded paths differ by about one ulp, so the port's fused and legacy paths
are held to each other within 1e-6, not bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.coding.compute import ComputeRuntime as JComputeRuntime  # noqa: E402
from repro.coding.planner import select_redundancy as jselect  # noqa: E402
from repro.core.assignment import StudentArch  # noqa: E402
from repro.core.grouping import Device  # noqa: E402
from repro.core.plan_ir import (PlanIR, device_matrix, eq1a_latency,  # noqa: E402
                                student_matrix)
from repro.core.simulator import FailureModel as JFailure  # noqa: E402
from repro.runtime import engine as jengine  # noqa: E402
from repro_torch.coding.compute import ComputeRuntime as TComputeRuntime  # noqa: E402
from repro_torch.coding.planner import select_redundancy as tselect  # noqa: E402
from repro_torch.core import plan_ir as tplan_ir  # noqa: E402
from repro_torch.core.simulator import FailureModel as TFailure  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime import engine as tengine  # noqa: E402

# the demo server: two small matmuls, a tanh, a pseudo-inverse decode
DEMO_TOL = dict(rtol=1e-5, atol=1e-5)
# port fused vs port legacy: the same arithmetic, one vmapped product vs
# one product per slot, so their portions differ by float rounding; see
# assert_paths_close for the decode's gain on top of it
PATHS_TOL = 1e-6
# coded recovery vs the clean answer: the JAX package's own bound
RECOVER_TOL = dict(rtol=5e-4, atol=5e-4)


# -- plans ----------------------------------------------------------------------

def _output_rep_ir(pairs=4, spares=2, p_out=0.25, M=8):
    """tests/test_coding.py's fixture: pair-replicated slots + spares."""
    n = 2 * pairs + spares
    devs = [Device(f"d{i}", (1 + i % 3) * 1e7, 2e6, 500, p_out)
            for i in range(n)]
    return _ir(devs, pairs, M, reps=2)


def _compute_rep_ir(pairs=2, spares=6, p_out=0.1, M=8, reps=2):
    """tests/test_coded_compute.py's fixture."""
    n = reps * pairs + spares
    devs = [Device(f"d{i}", 1e7 * (1 + 0.01 * i), 2e6, 500, p_out)
            for i in range(n)]
    return _ir(devs, pairs, M, reps)


def _ir(devs, pairs, M, reps):
    names, dcaps = device_matrix(devs)
    snames, scaps = student_matrix([StudentArch("s", 5e6, 0.6e6, 64, 0.15e6)])
    member = np.zeros((pairs, len(devs)), bool)
    part = np.zeros((pairs, M), bool)
    for k in range(pairs):
        member[k, reps * k:reps * (k + 1)] = True
        part[k, (M // pairs) * k:(M // pairs) * (k + 1)] = True
    return PlanIR(names, dcaps, snames, scaps, member, part,
                  np.zeros(pairs, np.int64), np.arange(pairs, dtype=np.int64),
                  eq1a_latency(scaps, dcaps), np.zeros((M, M)), 1.0, 0.5)


def _port_ir(ir):
    """The same replicate-only plan as the port's PlanIR (field for field).
    A coded plan is never copied: its spec objects belong to one package."""
    assert ir.coding is None and ir.compute_coding is None
    return tplan_ir.PlanIR(**{f.name: getattr(ir, f.name)
                              for f in dataclasses.fields(ir)})


def assert_same(a, b, path="ir"):
    """Two packages' objects are equal: dataclasses field by field, arrays
    exactly (values and dtype), containers element by element."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a == b or (a != a and b != b), (path, a, b)


def coded_twins(rep_ir, **kw):
    """(JAX plan, port plan) from each package's own select_redundancy."""
    j = jselect(rep_ir, **kw)
    t = tselect(_port_ir(rep_ir), **kw)
    assert_same(j, t)
    return j, t


PLANS = {
    "coded(6,4)": lambda: coded_twins(_output_rep_ir(), code_k=4, parity=2),
    "mixed": lambda: coded_twins(_output_rep_ir(pairs=5, spares=2, M=10),
                                 code_k=4, parity=2),
    "adaptive": lambda: coded_twins(_output_rep_ir(), code_k=4),
    "compute(5,3)": lambda: coded_twins(_compute_rep_ir(), code_k=3,
                                        parity=2, mode="compute"),
    "compute-adaptive": lambda: coded_twins(
        _compute_rep_ir(reps=3, spares=4), code_k=3, mode="compute"),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_coded_plans_equal_field_by_field(name):
    jir, tir = PLANS[name]()
    assert (jir.coding is not None) or (jir.compute_coding is not None)
    assert jir.redundancy_modes() == tir.redundancy_modes()
    assert jir.deployed_compute() == tir.deployed_compute()
    assert jir.objective() == tir.objective()
    np.testing.assert_array_equal(jir.group_outage(), tir.group_outage())


def test_compute_runtime_weights_equal_jax_exactly():
    jir, tir = PLANS["compute(5,3)"]()
    jrt, trt = JComputeRuntime(jir), TComputeRuntime(tir)
    share_t = np.random.default_rng(0).exponential(
        1.0, (16, jir.K + sum(e.n for e in jrt.entries)))
    share_t[np.random.default_rng(1).random(share_t.shape) < 0.2] = np.inf
    assert jrt.needs_decode(share_t) == trt.needs_decode(share_t)
    assert_same(jrt.decode_weights(share_t), trt.decode_weights(share_t))


# -- serving twins ----------------------------------------------------------------

def _demo(jir, tir, **kw):
    build = dict(feat=8, hidden=16, n_classes=3, seed=0, **kw)
    return (jengine.build_demo_server(jir, **build),
            tengine.build_demo_server(tir, device="cpu", **build))


def _x(rows=3, feat=8, seed=5):
    return np.random.default_rng(seed).normal(
        size=(rows, feat)).astype(np.float32)


def assert_same_results(jres, tres, tol=DEMO_TOL):
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(a.arrived, b.arrived)
        assert a.latency == b.latency
        assert a.degraded == b.degraded
        assert a.coverage == b.coverage
        assert a.failed_devices == b.failed_devices
        assert (a.share_times is None) == (b.share_times is None)
        if a.share_times is not None:
            np.testing.assert_array_equal(a.share_times, b.share_times)
        np.testing.assert_allclose(b.logits, a.logits, **tol)


def decode_gain(srv, share_times) -> float:
    """The largest row abs-sum of the decode weights a request was served
    with (1 when no decode ran): how much a decode can magnify a
    difference in the portions it reads."""
    if share_times is None:
        return 1.0
    rt = srv._coded_runtime(srv.ir)
    if rt is not None:
        decs = [rt.decode_weights(np.isfinite(share_times)[None])]
    else:
        decs, _ = srv._compute_runtime(srv.ir).decode_weights(
            share_times[None])
    return max([1.0] + [float(np.abs(d).sum(-1).max()) for d in decs])


def assert_paths_close(srv, fused_res, legacy_res):
    """Port fused vs port legacy within PATHS_TOL times the request's
    decode gain (up to 42 for coded(6,4) with two shares erased): the
    JAX package's two paths, by contrast, are held bit for bit."""
    for a, b in zip(fused_res, legacy_res):
        tol = PATHS_TOL * decode_gain(srv, a.share_times)
        np.testing.assert_allclose(a.logits, b.logits, rtol=tol, atol=tol)


@pytest.fixture
def decode_calls(monkeypatch):
    """Counts the port's coded_decode calls (the plain version on the CPU,
    which the launch counter leaves alone)."""
    calls = []
    plain = ops.coded_decode

    def counted(*a, **k):
        calls.append(a[0].shape)
        return plain(*a, **k)
    monkeypatch.setattr(ops, "coded_decode", counted)
    return calls


def _sysdev(ir, slot=0, idx=0):
    return ir.device_names[int(np.flatnonzero(ir.member[slot])[idx])]


def _output_failure(ir, scenario):
    return {
        "clean": lambda: JFailure(outages=False),
        "sys1": lambda: JFailure(forced_failures=[_sysdev(ir)],
                                 outages=False),
        "sys2": lambda: JFailure(forced_failures=[_sysdev(ir, 0),
                                                  _sysdev(ir, 1)],
                                 outages=False),
        "past-distance": lambda: JFailure(
            forced_failures=[_sysdev(ir, k) for k in range(3)],
            outages=False),
        "outages": lambda: JFailure(),
    }[scenario]()


# decode launches per serve_batch in each scenario (None: data-dependent)
OUTPUT_SCENARIOS = {"clean": 0, "sys1": 1, "sys2": 1, "past-distance": 1,
                    "outages": None}


@pytest.mark.parametrize("scenario", list(OUTPUT_SCENARIOS))
def test_output_coded_serving_matches_jax(scenario, decode_calls):
    jir, tir = PLANS["coded(6,4)"]()
    failure = _output_failure(jir, scenario)
    jf, tf = _demo(jir, tir)
    jl, tl = _demo(jir, tir, fastpath=False)
    for srv in (jf, jl):
        srv.failure = failure
    for srv in (tf, tl):
        srv.failure = TFailure(**dataclasses.asdict(failure))
    for seed in range(6 if scenario == "outages" else 1):
        xs = [_x(2, seed=seed), _x(3, seed=seed + 6)]
        n0 = len(decode_calls)
        tres_f = tf.serve_batch(xs, rng=np.random.default_rng(seed))
        n_fused = len(decode_calls) - n0
        tres_l = tl.serve_batch(xs, rng=np.random.default_rng(seed))
        assert len(decode_calls) - n0 == 2 * n_fused   # both paths alike
        if OUTPUT_SCENARIOS[scenario] is not None:
            assert n_fused == OUTPUT_SCENARIOS[scenario]
        assert_same_results(jf.serve_batch(xs, rng=np.random.default_rng(seed)),
                            tres_f)
        assert_same_results(jl.serve_batch(xs, rng=np.random.default_rng(seed)),
                            tres_l)
        assert_paths_close(tf, tres_f, tres_l)
    if scenario in ("sys1", "sys2"):
        assert all(r.arrived.all() and not r.degraded for r in tres_f)
        tf.failure = TFailure(outages=False)
        clean = tf.serve_batch(xs, rng=np.random.default_rng(0))
        for a, b in zip(tres_f, clean):
            np.testing.assert_allclose(a.logits, b.logits, **RECOVER_TOL)
    if scenario == "past-distance":
        assert all(r.degraded and 0.0 < r.coverage < 1.0 for r in tres_f)


def test_output_coded_clean_equals_uncoded_plan():
    """Failure-free coded serving is the systematic passthrough: it serves
    the UNCODED plan's logits (no decode runs)."""
    jir, tir = PLANS["coded(6,4)"]()
    _, tcoded = _demo(jir, tir)
    rep = _output_rep_ir()
    _, tplain = _demo(rep, _port_ir(rep))
    a = tcoded.serve_batch([_x()], rng=np.random.default_rng(0))[0]
    b = tplain.serve_batch([_x()], rng=np.random.default_rng(0))[0]
    np.testing.assert_array_equal(a.logits, b.logits)
    assert not a.degraded and a.coverage == 1.0


def test_mixed_plan_replicate_loss_skips_decode(decode_calls):
    jir, tir = PLANS["mixed"]()
    rep_slot = int(np.flatnonzero(jir.coding.group_of < 0)[0])
    dead = [jir.device_names[n] for n in np.flatnonzero(jir.member[rep_slot])]
    for fastpath in (None, False):
        jsrv, tsrv = _demo(jir, tir, fastpath=fastpath)
        jsrv.failure = JFailure(forced_failures=dead, outages=False)
        tsrv.failure = TFailure(forced_failures=dead, outages=False)
        tsrv._coded_runtime(tsrv.ir).decode_weights = _no_decode
        tres = tsrv.serve_batch([_x()], rng=np.random.default_rng(0))
        assert not tres[0].arrived[rep_slot] and tres[0].degraded
        assert_same_results(
            jsrv.serve_batch([_x()], rng=np.random.default_rng(0)), tres)
    assert decode_calls == []


def _no_decode(*_a, **_k):
    raise AssertionError("decode path engaged for a replicate-only outage")


def test_output_coded_int8_matches_jax_and_fp32():
    jir, tir = PLANS["coded(6,4)"]()
    model = JFailure(forced_failures=[_sysdev(jir)], outages=False)
    j8, t8 = _demo(jir, tir, quantize="int8")
    _, t32 = _demo(jir, tir)
    j8.failure = model
    t8.failure = t32.failure = TFailure(**dataclasses.asdict(model))
    xs = [_x(16)]
    tq = t8.serve_batch(xs, rng=np.random.default_rng(0))
    assert_same_results(j8.serve_batch(xs, rng=np.random.default_rng(0)), tq)
    lf = t32.serve_batch(xs, rng=np.random.default_rng(0))[0].logits
    lq = tq[0].logits
    # the JAX package's int8 bounds (tests/test_coding.py)
    assert np.abs(lf - lq).max() / np.abs(lf).max() < 0.05
    assert (lf.argmax(-1) == lq.argmax(-1)).mean() >= 0.9


def _compute_failure(ir, scenario):
    spec = ir.compute_coding
    return {
        "clean": lambda: JFailure(outages=False),
        "victim": lambda: JFailure(forced_failures=[
            ir.device_names[int(spec.shard_member[0][0])]], outages=False),
        "past-distance": lambda: JFailure(forced_failures=[
            ir.device_names[int(c)] for c in spec.shard_member[0][:3]],
            outages=False),
        "outages": lambda: JFailure(outages=True),
    }[scenario]()


@pytest.mark.parametrize("scenario", ["clean", "victim", "past-distance",
                                      "outages"])
def test_compute_coded_serving_matches_jax(scenario, decode_calls):
    jir, tir = PLANS["compute(5,3)"]()
    failure = _compute_failure(jir, scenario)
    jf, tf = _demo(jir, tir)
    jl, tl = _demo(jir, tir, fastpath=False)
    clean = tf.serve_batch([_x()], rng=np.random.default_rng(0))[0]
    for srv in (jf, jl):
        srv.failure = failure
    for srv in (tf, tl):
        srv.failure = TFailure(**dataclasses.asdict(failure))
    for seed in range(6 if scenario == "outages" else 1):
        xs = [_x(seed=5 + seed), _x(2, seed=5 + seed)]
        n0 = len(decode_calls)
        tres_f = tf.serve_batch(xs, rng=np.random.default_rng(seed))
        tres_l = tl.serve_batch(xs, rng=np.random.default_rng(seed))
        if scenario == "clean":
            assert len(decode_calls) == n0
        elif scenario == "victim":
            # one launch per coded slot, in each path
            assert len(decode_calls) - n0 == 2 * jir.compute_coding.Q
        assert_same_results(jf.serve_batch(xs, rng=np.random.default_rng(seed)),
                            tres_f)
        assert_same_results(jl.serve_batch(xs, rng=np.random.default_rng(seed)),
                            tres_l)
        assert_paths_close(tf, tres_f, tres_l)
    if scenario == "victim":
        for r in tres_f:
            assert r.arrived.all() and not r.degraded
            np.testing.assert_allclose(r.logits,
                                       clean.logits[:r.logits.shape[0]],
                                       **RECOVER_TOL)
    if scenario == "past-distance":
        slot = int(jir.compute_coding.slots[0])
        assert all(not r.arrived[slot] and r.degraded for r in tres_f)
    if scenario == "clean":
        for e in TComputeRuntime(tir).entries:
            assert all(np.isfinite(r.share_times[e.ids]).all()
                       for r in tres_f)


# -- engine twins: share futures ---------------------------------------------------

def _engine_pair(jsrv, tsrv, times, sizes, **cfg):
    reports = []
    for mod, srv in ((jengine, jsrv), (tengine, tsrv)):
        reports.append(mod.ServingEngine(srv, mod.EngineConfig(
            input_dim=8, **cfg)).run(times, sizes))
    jrep, trep = reports
    assert [dataclasses.astuple(r) for r in jrep.records] == \
        [dataclasses.astuple(r) for r in trep.records]
    assert [dataclasses.astuple(b) for b in jrep.batches] == \
        [dataclasses.astuple(b) for b in trep.batches]
    np.testing.assert_equal([dataclasses.astuple(f) for f in jrep.futures],
                            [dataclasses.astuple(f) for f in trep.futures])
    np.testing.assert_equal(jrep.summary(), trep.summary())
    return trep


@pytest.mark.parametrize("crash", [0.0, 0.3])
def test_engine_share_futures_match_jax(crash):
    jir, tir = PLANS["compute(5,3)"]()
    jsrv, tsrv = _demo(jir, tir)
    if crash:
        jsrv.failure = JFailure(crash_prob=crash, outages=True)
        tsrv.failure = TFailure(crash_prob=crash, outages=True)
    n_req = 12
    rep = _engine_pair(jsrv, tsrv, np.linspace(0.0, 0.2, n_req),
                       np.full(n_req, 2), service_model=(1e-3, 1e-4),
                       warmup=False, seed=3)
    if not crash:
        # tests/test_coded_compute.py's own accounting, on the port
        s = rep.summary()
        assert s["share_futures"] == n_req * 2
        assert s["cancelled_shares"] == n_req * 2 * 2
        by_rid = {}
        for f in rep.futures:
            assert f.arrived == f.k == 3 and f.n == 5 and f.cancelled == 2
            by_rid.setdefault(f.rid, []).append(f.recovery_latency)
        for r in rep.records:
            assert max(by_rid[r.rid]) == pytest.approx(r.served_latency)


def test_engine_degraded_rate_row_matches_jax():
    jir, tir = PLANS["coded(6,4)"]()
    jsrv, tsrv = _demo(jir, tir)
    rep = _engine_pair(jsrv, tsrv, np.linspace(0.0, 0.05, 12), None,
                       max_batch=4, max_wait=0.005,
                       service_model=(1e-4, 1e-5), seed=0)
    s = rep.summary()
    assert s["degraded_rate"] == 0.0 and s["quorum_rate"] == 1.0
