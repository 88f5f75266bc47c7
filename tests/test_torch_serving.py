"""Parity of the PyTorch port's quorum serving with the JAX reference, on
the CPU.

The same PlanIR, seed, failure model and inputs go to both packages. The
fields that come from the shared numpy simulator (``arrived``, ``latency``,
``degraded``, ``coverage``, ``failed_devices``, engine records) must be
EQUAL; logits agree within a stated tolerance because the two frameworks
sum convolutions and matmuls in different orders.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.assignment import StudentArch  # noqa: E402
from repro.core.grouping import Device  # noqa: E402
from repro.core.pipeline import Ensemble as JEnsemble  # noqa: E402
from repro.core.plan_ir import (PlanIR, device_matrix, eq1a_latency,  # noqa: E402
                                student_matrix)
from repro.core.simulator import FailureModel as JFailure  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.runtime import engine as jengine  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.convert import fc_from_jax  # noqa: E402
from repro_torch.core import plan_ir as tplan_ir  # noqa: E402
from repro_torch.core.pipeline import Ensemble as TEnsemble  # noqa: E402
from repro_torch.core.simulator import FailureModel as TFailure  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.runtime import engine as tengine  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402

# WRN forwards: 10 conv layers summed in another order by each framework
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# the demo server: two small matmuls and a tanh
DEMO_TOL = dict(rtol=1e-5, atol=1e-5)
# int8 vs fp32 deployment: the JAX package's own bounds
# (tests/test_fastpath.py::test_int8_masks_failures_like_fp32)
INT8_TOL = dict(rtol=0.1, atol=0.05)


def _plan_ir(dims, M=None, members=2):
    """A replicate-only plan: slot k holds ``dims[k]`` filters and
    ``members`` devices."""
    K = len(dims)
    M = M or sum(dims)
    devs = [Device(f"d{j}", 1e7 * (1 + j % 3), 2e6, 500 + 50 * j,
                   0.1 + 0.05 * (j % 4)) for j in range(K * members)]
    names, dcaps = device_matrix(devs)
    snames, scaps = student_matrix([StudentArch("s", 5e6, 0.6e6, 64, 0.15e6)])
    member = np.zeros((K, K * members), bool)
    part = np.zeros((K, M), bool)
    off = 0
    for k, d in enumerate(dims):
        member[k, k * members:(k + 1) * members] = True
        part[k, off:off + d] = True
        off += d
    return PlanIR(names, dcaps, snames, scaps, member, part,
                  np.zeros(K, np.int64), np.arange(K, dtype=np.int64),
                  eq1a_latency(scaps, dcaps), np.zeros((M, M)), 1.0, 0.5)


def _port_ir(ir):
    """The same replicate-only plan as the port's PlanIR (a field-for-field
    copy). A coded plan is never copied — its spec objects belong to one
    package; tests/test_torch_coded_serving.py builds each package's coded
    plan with its own ``select_redundancy``."""
    assert ir.coding is None and ir.compute_coding is None
    return tplan_ir.PlanIR(**{f.name: getattr(ir, f.name)
                              for f in dataclasses.fields(ir)})


def _port_failure(fm):
    return TFailure(**dataclasses.asdict(fm))


def _to_jax(tree):
    """A port parameter tree as the JAX package's (numpy leaves, HWIO)."""
    if isinstance(tree, dict):
        return {k: (np.transpose(v.numpy(), (2, 3, 1, 0))
                    if k == "kernel" and v.dim() == 4 else _to_jax(v))
                for k, v in tree.items()}
    return tree.numpy()


def _ensembles(dims, n_classes=10):
    """(JAX ensemble, port ensemble) of wrn-10-1 students with the same
    random weights — drawn by the port, whose tensors the JAX side reads
    as numpy (``params_from_jax`` is held to the JAX initialiser in
    test_torch_models)."""
    ir = _plan_ir(dims)
    gen = torch.Generator().manual_seed(0)
    tstudents = [tcnn.make_student(gen, "wrn-10-1", n_classes, d)
                 for d in dims]
    jstudents = [(jcnn.WRNConfig(**dataclasses.asdict(cfg)), _to_jax(p),
                  jcnn.wrn_forward) for cfg, p, _ in tstudents]
    rng = np.random.default_rng(9)
    fc = {"kernel": (rng.standard_normal((sum(dims), n_classes))
                     / np.sqrt(sum(dims))).astype(np.float32),
          "bias": (0.1 * rng.standard_normal(n_classes)).astype(np.float32)}
    jens = JEnsemble(ir.to_plan(), jstudents, fc, list(dims), 0.0, ir=ir)
    tir = _port_ir(ir)
    tens = TEnsemble(tir.to_plan(), tstudents, fc_from_jax(fc), list(dims),
                     0.0, ir=tir)
    return jens, tens


@pytest.fixture(scope="module")
def ensembles():
    return {dims: _ensembles(dims) for dims in ((8, 8), (5, 5, 6))}


def _images(rows, seed):
    return np.random.default_rng(seed).standard_normal(
        (rows, 32, 32, 3)).astype(np.float32)


def _assert_same_results(jres, tres, tol):
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(a.arrived, b.arrived)
        assert a.latency == b.latency
        assert a.degraded == b.degraded
        assert a.coverage == b.coverage
        assert a.failed_devices == b.failed_devices
        np.testing.assert_allclose(b.logits, a.logits, **tol)


FAILURES = [
    JFailure(outages=False),                                 # clean
    JFailure(forced_failures=["d0", "d1"], outages=False),   # slot 0 dead
    JFailure(crash_prob=0.3, outages=True),                  # stochastic
]


@pytest.mark.parametrize("failure", FAILURES, ids=["clean", "forced", "crash"])
@pytest.mark.parametrize("dims,fused", [((8, 8), True), ((5, 5, 6), False)],
                         ids=["fused", "legacy"])
def test_ensemble_server_matches_jax(ensembles, dims, fused, failure):
    jens, tens = ensembles[dims]
    jsrv = jserving.server_from_ensemble(jens, failure=failure, seed=3)
    tsrv = tserving.server_from_ensemble(tens, failure=_port_failure(failure),
                                         seed=3, device="cpu")
    assert tsrv.fastpath_active is fused and jsrv.fastpath_active is fused
    xs = [_images(3, 1), _images(1, 2), _images(4, 3)]
    for _ in range(2):             # the servers' own generators advance alike
        _assert_same_results(jsrv.serve_batch(xs), tsrv.serve_batch(xs),
                             LOGIT_TOL)


def test_int8_ensemble_server_matches_jax(ensembles):
    jens, tens = ensembles[(8, 8)]
    failure = JFailure(forced_failures=["d0"], crash_prob=0.2, outages=True)
    jsrv = jserving.server_from_ensemble(jens, failure=failure, seed=4,
                                         quantize="int8")
    tsrv = tserving.server_from_ensemble(tens, failure=_port_failure(failure),
                                         seed=4, quantize="int8",
                                         device="cpu")
    t32 = tserving.server_from_ensemble(tens, failure=_port_failure(failure),
                                        seed=4, device="cpu")
    xs = [_images(4, 5), _images(4, 6)]
    # int8 quantization is exact on both sides, so the two int8 servers
    # differ only by summation order
    tres = tsrv.serve_batch(xs)
    _assert_same_results(jsrv.serve_batch(xs), tres, LOGIT_TOL)
    ref = t32.serve_batch(xs)
    for a, b in zip(ref, tres):
        np.testing.assert_allclose(b.logits, a.logits, **INT8_TOL)
    q = np.concatenate([r.logits for r in tres]).argmax(-1)
    f = np.concatenate([r.logits for r in ref]).argmax(-1)
    assert (q == f).mean() >= 0.95


def test_int8_stacked_weights_equal_jax_exactly(ensembles):
    jens, tens = ensembles[(8, 8)]
    jsrv = jserving.server_from_ensemble(jens, quantize="int8",
                                         failure=JFailure(outages=False))
    tsrv = tserving.server_from_ensemble(tens, quantize="int8", device="cpu",
                                         failure=TFailure(outages=False))
    jstacked, _ = jsrv._ensure_fused()
    tstacked = tsrv._ensure_fused()
    jw = jstacked["g0b0"]["conv1"]["kernel"]          # (K, kh, kw, I, O)
    tw = tstacked["g0b0"]["conv1"]["kernel"]          # (K, O, I, kh, kw)
    np.testing.assert_array_equal(
        tw.q.numpy(), np.transpose(np.asarray(jw.q), (0, 4, 3, 1, 2)))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    np.testing.assert_array_equal(tsrv._fc_q.q.numpy(),
                                  np.asarray(jsrv._fc_q.q))
    np.testing.assert_array_equal(tsrv._fc_q.scale.numpy(),
                                  np.asarray(jsrv._fc_q.scale))


# -- the demo server twins ----------------------------------------------------

def _demo_pair(ir, **kw):
    build = dict(feat=8, hidden=16, n_classes=3, seed=0, **kw)
    return (jengine.build_demo_server(ir, **build),
            tengine.build_demo_server(_port_ir(ir), device="cpu", **build))


def _x(rows, seed):
    return np.random.default_rng(seed).normal(size=(rows, 8)).astype(
        np.float32)


@pytest.mark.parametrize("fastpath", [None, False], ids=["fused", "legacy"])
@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_demo_server_twins_match(fastpath, quantize):
    ir = _plan_ir((3, 5, 4))
    jsrv, tsrv = _demo_pair(ir, fastpath=fastpath, quantize=quantize)
    assert jsrv.fastpath_active == tsrv.fastpath_active
    xs = [_x(3, 1), _x(5, 2), _x(1, 3)]
    for failure in FAILURES:
        jsrv.failure, tsrv.failure = failure, _port_failure(failure)
        _assert_same_results(
            jsrv.serve_batch(xs, rng=np.random.default_rng(11)),
            tsrv.serve_batch(xs, rng=np.random.default_rng(11)), DEMO_TOL)


def test_engine_reports_identical_rows():
    ir = _plan_ir((4, 4))
    jsrv, tsrv = _demo_pair(ir)
    failure = JFailure(crash_prob=0.2, outages=True)
    jsrv.failure, tsrv.failure = failure, _port_failure(failure)
    rng = np.random.default_rng(0)
    times = np.cumsum(rng.exponential(0.004, 40))
    sizes = rng.integers(1, 5, 40)
    reports = []
    for eng_mod, srv in ((jengine, jsrv), (tengine, tsrv)):
        cfg = eng_mod.EngineConfig(max_batch=4, max_wait=0.01, slo=0.05,
                                   input_dim=8, service_model=(1e-3, 2e-4),
                                   seed=5)
        reports.append(eng_mod.ServingEngine(srv, cfg).run(times, sizes))
    jrep, trep = reports
    assert [dataclasses.astuple(r) for r in jrep.records] == \
        [dataclasses.astuple(r) for r in trep.records]
    assert [dataclasses.astuple(b) for b in jrep.batches] == \
        [dataclasses.astuple(b) for b in trep.batches]
    assert jrep.summary() == trep.summary()


def test_engine_measured_wall_counts_one_merge_per_call():
    """Measured-wall mode: warmup plus every dispatched batch each call
    serve_batch once, and each call merges once (on the CPU through the
    plain version, so the kernel's launch count must not move)."""
    tsrv = tengine.build_demo_server(_port_ir(_plan_ir((4, 4))),
                                     feat=8, hidden=16, device="cpu")
    calls = []
    serve = tsrv.serve_batch
    tsrv.serve_batch = lambda xs, rng=None: calls.append(len(xs)) or serve(
        xs, rng=rng)
    before = ops.quorum_aggregate.launches
    cfg = tengine.EngineConfig(max_batch=4, max_wait=0.01, input_dim=8)
    rep = tengine.ServingEngine(tsrv, cfg).run(np.linspace(0, 0.02, 9),
                                               np.full(9, 2))
    warm = 2 * len([1, 2, 4, 8])        # clean + one-slot-down passes
    assert len(calls) == len(rep.batches) + warm
    assert ops.quorum_aggregate.launches == before


# -- the device rule and the slice's boundary -----------------------------------

def test_entry_points_refuse_to_run_on_the_cpu_unasked(ensembles,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ir = _plan_ir((4, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.build_demo_server(_port_ir(ir))
    _, tens = ensembles[(8, 8)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserving.server_from_ensemble(tens)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserving.QuorumServer(plan=tens.ir, portion_fns=[],
                              fc_weights=np.zeros((2, 4, 3), np.float32),
                              fc_bias=np.zeros(3, np.float32))


def test_migrate_without_store_zeroes_refit_slot():
    """A server with no weight store (``redeploy_fn=None``) cannot refit a
    slot whose partition changed: its FC slice is zeroed, its portion
    forward kept, and the answer reported degraded."""
    tsrv = tengine.build_demo_server(_port_ir(_plan_ir((4, 4))), feat=8,
                                     hidden=16, device="cpu")
    tsrv.redeploy_fn = None
    fns = list(tsrv.portion_fns)
    part = np.array(tsrv.ir.partition)
    part[0] = ~part[0]
    stats = tsrv.migrate(tsrv.ir.with_(partition=part))
    assert stats["zeroed_slots"] == (0,) and stats["refit_slots"] == ()
    assert tsrv.zeroed_slots == {0} and tsrv.portion_fns[0] is fns[0]
    assert not tsrv.fc_weights[0].any()
    r = tsrv.serve(_x(2, 1), rng=np.random.default_rng(0))
    assert r.arrived.all() and r.degraded
