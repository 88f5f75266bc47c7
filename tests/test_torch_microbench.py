"""The port's microbench against the JAX package's: the same samples give
the same fitted spec, fleet specs, artifact and measured plan; the port's
own sweep times real forwards on the CPU and counts their FLOPs."""
import dataclasses
import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import planner as JPL  # noqa: E402
from repro.core import simulator as JSIM  # noqa: E402
from repro.launch import microbench as JMB  # noqa: E402
from repro_torch.core import planner as TPL  # noqa: E402
from repro_torch.core import simulator as TSIM  # noqa: E402
from repro_torch.core.hwspec import DeviceSpec  # noqa: E402
from repro_torch.launch import microbench as TMB  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _bench_common():
    spec = importlib.util.spec_from_file_location(
        "_bench_common_mb", ROOT / "benchmarks" / "common.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


common = _bench_common()


def _samples(seed, true=(5e9, 8e8, 1e-4), n=12):
    """Synthetic samples on an exact latency model (tests/test_hwspec.py's
    recipe), built as each package's own BenchSample."""
    rng = np.random.default_rng(seed)
    spec = DeviceSpec("host", *true)
    rows = [(f"op{i}", (i,), float(f), float(b), float(spec.latency(f, b)))
            for i, (f, b) in enumerate(zip(rng.uniform(1e6, 1e9, n),
                                           rng.uniform(1e4, 1e7, n)))]
    return ([TMB.BenchSample(*r) for r in rows],
            [JMB.BenchSample(*r) for r in rows])


def _spec_tuple(s):
    return (s.name, float(s.peak_flops), float(s.peak_bw),
            float(s.latency_floor), s.source)


@pytest.mark.parametrize("seed,true", [(0, (5e9, 8e8, 1e-4)),
                                       (1, (2e12, 3e11, 2e-5)),
                                       (2, (6.7e13, 3.35e12, 8e-6))])
def test_fit_fleet_and_artifact_equal_the_jax_package(seed, true):
    ts, js = _samples(seed, true)
    tspec, jspec = TMB.fit_host_spec(ts), JMB.fit_host_spec(js)
    assert _spec_tuple(tspec) == _spec_tuple(jspec)
    assert tspec.peak_flops == pytest.approx(true[0], rel=1e-6)
    fleet = TSIM.make_fleet(8, seed=1)
    jfleet = JSIM.make_fleet(8, seed=1)
    tf = TMB.fleet_specs_from_microbench(fleet, ts)
    jf = JMB.fleet_specs_from_microbench(jfleet, js)
    assert [_spec_tuple(s) for s in tf] == [_spec_tuple(s) for s in jf]
    assert json.dumps(TMB.samples_to_json(ts, tspec)) == \
        json.dumps(JMB.samples_to_json(js, jspec))


@pytest.mark.parametrize("seed", [0, 1])
def test_measured_plan_equals_the_jax_package(seed):
    """make_plan_ir(device_specs=...) on the paper's 8-device fleet from the
    same samples: every array of the two PlanIRs is equal, and the plan
    is the measured one."""
    ts, js = _samples(seed)
    fleet = TSIM.make_fleet(8, seed=1, mem_range=(1e6, 4e6))
    jfleet = JSIM.make_fleet(8, seed=1, mem_range=(1e6, 4e6))
    A, students = common.affinity_graph(64), common.paper_students()
    tspecs = TMB.fleet_specs_from_microbench(fleet, ts)
    jspecs = JMB.fleet_specs_from_microbench(jfleet, js)
    declared = TPL.tune_d_th_ir(fleet, A, students, p_th=0.25)
    tir = TPL.make_plan_ir(fleet, A, students, d_th=declared.d_th,
                           p_th=0.25, device_specs=tspecs)
    jir = JPL.make_plan_ir(jfleet, A, students, d_th=declared.d_th,
                           p_th=0.25, device_specs=jspecs)
    assert tir.latency_source == jir.latency_source == "measured"
    assert declared.latency_source == "declared"
    for f in dataclasses.fields(jir):
        a, b = getattr(jir, f.name), getattr(tir, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        elif f.name == "device_specs":
            assert [_spec_tuple(s) for s in a] == [_spec_tuple(s) for s in b]
        else:
            assert a == b, f.name
    assert tir.objective() == jir.objective()
    assert np.isfinite(tir.objective()) and np.isfinite(declared.objective())
    re = declared.with_measured_latency(tspecs)
    np.testing.assert_array_equal(re.latency_nd, tir.latency_nd)


@pytest.mark.parametrize("widths,batches", [((8, 32), (16, 128)),
                                            ((128,), (1024,))])
def test_portion_forward_samples_on_the_cpu(widths, batches):
    samples = TMB.portion_forward_samples(widths=widths, batches=batches,
                                          repeats=2, device="cpu")
    assert len(samples) == len(widths) * len(batches)
    feat, hidden = 32, 64
    cells = [(w, b) for w in widths for b in batches]
    for s, (w, b) in zip(samples, cells):
        assert s.name == f"portion_b{b}_w{w}"
        assert s.wall_s > 0
        # FlopCounterMode's count: the two products, no elementwise work
        assert s.flops == 2.0 * b * feat * hidden + 2.0 * b * hidden * w
        assert s.xfer_bytes == 4.0 * (b * feat + feat * hidden + hidden * w
                                      + b * w + 2 * b * hidden)
        assert s.shape == (b, feat, feat, hidden, hidden, w)


def test_op_counts_counts_products_not_elementwise_work():
    x, w = torch.ones((8, 16)), torch.ones((16, 4))
    assert TMB.op_counts(lambda a, b: torch.tanh(a @ b) * 2, x, w) == \
        2.0 * 8 * 16 * 4
    assert TMB.op_counts(lambda a: a * 3 + 1, x) == 0.0


def test_measure_op_takes_the_fallbacks_for_zero_counts():
    x = torch.ones((4, 4))
    s = TMB.measure_op("scale", lambda a: a * 2, (x,), flops=7.0,
                       xfer_bytes=64.0, repeats=1)
    assert (s.flops, s.xfer_bytes, s.shape) == (7.0, 64.0, (4, 4))


def test_measure_op_counts_flops_over_the_fallback_and_bytes_default_0():
    x, w = torch.ones((4, 8)), torch.ones((8, 2))
    s = TMB.measure_op("mm", lambda a, b: a @ b, (x, w), flops=7.0,
                       repeats=1)
    assert (s.flops, s.xfer_bytes) == (2.0 * 4 * 8 * 2, 0.0)


def test_time_callable_is_the_median_after_warmup(monkeypatch):
    """Calls of 0 (warm-up), 2, 10 and 4 ms on a fake clock that each call
    advances by its nap: the median of the three timed calls is exactly the
    4 ms one (no host sleep, so no scheduler can stretch a nap)."""
    clock = [0.0]
    naps = iter([0.0, 0.002, 0.010, 0.004])

    def nap():
        clock[0] += next(naps)

    # microbench's own view of the clock: no other code sees the fake
    monkeypatch.setattr(TMB, "time",
                        types.SimpleNamespace(perf_counter=lambda: clock[0]))
    out = TMB.time_callable(nap, repeats=3, warmup=1)
    assert out == 0.004


def test_entry_points_need_a_device_choice_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMB.portion_forward_samples(widths=(8,), batches=(16,), repeats=1)


def test_main_writes_the_artifact(tmp_path, capsys):
    out = tmp_path / "sub" / "microbench.json"
    assert TMB.main(["--device", "cpu", "--repeats", "1",
                     "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert set(art) == {"spec", "samples"}
    assert art["spec"]["name"] == "host"
    assert art["spec"]["source"] == "measured"
    assert len(art["samples"]) == 12
    assert set(art["samples"][0]) == {"name", "shape", "flops",
                                      "xfer_bytes", "wall_s"}
    assert "fitted host" in capsys.readouterr().out
