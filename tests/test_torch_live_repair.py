"""Parity of the port's live repair (``migrate``, ``deploy_slot``,
``remove_device`` under the copied ``ClusterController``) with the JAX
reference, on the CPU.

Each scenario runs the same remove → repair → migrate (or re-encode) cycle
on a JAX server and its port twin. The controller's ``RepairOutcome``
(all fields but the wall time) and the server's ``last_migration``,
``zeroed_slots`` and ``part_dims`` must be EQUAL, served quorum fields
equal, and logits within ``DEMO_TOL``. Where the JAX tests hold a migrated
server bit for bit to one built fresh on the repaired plan, the port's
migrated server is held bit for bit to the port's fresh one.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import planner as JPL  # noqa: E402
from repro.core.assignment import StudentArch  # noqa: E402
from repro.core.grouping import Device  # noqa: E402
from repro.core.plan_ir import (PlanIR, device_matrix, eq1a_latency,  # noqa: E402
                                student_matrix)
from repro.core.simulator import FailureModel as JFailure  # noqa: E402
from repro.core.simulator import make_fleet  # noqa: E402
from repro.runtime import controller as jcontroller  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.core import planner as TPL  # noqa: E402
from repro_torch.core.assignment import StudentArch as TStudentArch  # noqa: E402
from repro_torch.core.grouping import Device as TDevice  # noqa: E402
from repro_torch.core.simulator import FailureModel as TFailure  # noqa: E402
from repro_torch.runtime import controller as tcontroller  # noqa: E402
from repro_torch.runtime import engine as tengine  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402
from test_torch_coded_serving import (DEMO_TOL, _compute_rep_ir,  # noqa: E402
                                      _demo, _output_rep_ir, _port_ir,
                                      _sysdev, _x, assert_paths_close,
                                      assert_same, assert_same_results,
                                      coded_twins)

# int8 vs fp32 after a migration: the JAX package's bound
# (tests/test_fastpath.py::test_int8_tolerance_survives_migration)
INT8_REL = 0.05


def _toy_ir(M=8):
    """tests/test_serving_fixes.py's two-slot, four-device plan."""
    devs = [Device("a", 1e7, 2e6, 500, 0.3), Device("b", 2e7, 2e6, 500, 0.3),
            Device("c", 1e7, 2e6, 500, 0.3), Device("d", 3e7, 2e6, 500, 0.3)]
    names, dcaps = device_matrix(devs)
    snames, scaps = student_matrix([StudentArch("s", 5e6, 0.6e6, 64, 0.15e6)])
    member = np.array([[1, 1, 0, 0], [0, 0, 1, 1]], bool)
    part = np.zeros((2, M), bool)
    part[0, :M // 2] = True
    part[1, M // 2:] = True
    return PlanIR(names, dcaps, snames, scaps, member, part,
                  np.zeros(2, np.int64), np.arange(2, dtype=np.int64),
                  eq1a_latency(scaps, dcaps), np.zeros((M, M)), 1.0, 0.5)


def _pair(jir=None, **kw):
    jir = jir if jir is not None else _toy_ir()
    return _demo(jir, _port_ir(jir), **kw)


def _fresh(tir, **kw):
    return tengine.build_demo_server(tir, feat=8, hidden=16, n_classes=3,
                                     seed=0, device="cpu", **kw)


def assert_same_outcome(jout, tout):
    """A RepairOutcome of each package: every field but the wall time."""
    assert (jout is None) == (tout is None)
    if jout is None:
        return
    for f in dataclasses.fields(jout):
        if f.name != "wall_s":
            assert_same(getattr(jout, f.name), getattr(tout, f.name),
                        f"outcome.{f.name}")


def assert_same_server_state(jsrv, tsrv):
    assert jsrv.last_migration == tsrv.last_migration
    assert jsrv.zeroed_slots == tsrv.zeroed_slots
    assert jsrv.part_dims == tsrv.part_dims
    assert jsrv.fastpath_active == tsrv.fastpath_active
    assert_same(jsrv.ir, tsrv.ir)


def serve_both(jsrv, tsrv, xs, seed):
    tres = tsrv.serve_batch(xs, rng=np.random.default_rng(seed))
    assert_same_results(jsrv.serve_batch(xs, rng=np.random.default_rng(seed)),
                        tres)
    return tres


def both(jsrv, tsrv, call):
    """Run ``call(server, package_tag)`` on each twin; return both results."""
    return call(jsrv, "jax"), call(tsrv, "torch")


def _swapped(ir):
    part = np.array(ir.partition)
    part[[0, 1]] = part[[1, 0]]
    return part


# -- tests/test_serving_fixes.py twins ----------------------------------------------

def test_migration_matches_fresh_server_after_remove_device():
    jsrv, tsrv = _pair()
    x = _x()
    for name, kind in (("a", "noop"), ("b", "repair")):
        jout, tout = both(jsrv, tsrv, lambda s, _: s.remove_device(name))
        assert tout.kind == kind
        assert_same_outcome(jout, tout)
        assert_same_server_state(jsrv, tsrv)
    r_mig = serve_both(jsrv, tsrv, [x], 7)[0]
    r_new = _fresh(tsrv.ir).serve_batch([x], rng=np.random.default_rng(7))[0]
    assert r_mig.arrived.all() and r_mig.latency == r_new.latency
    np.testing.assert_array_equal(r_mig.logits, r_new.logits)

    # full-replan-style reshape with the identity mapping: both masks change
    new_part = np.zeros((2, tsrv.ir.M), bool)
    new_part[0, :5] = True
    new_part[1, 5:] = True
    jstats, tstats = both(jsrv, tsrv, lambda s, _: s.migrate(
        s.ir.with_(partition=new_part), {0: 0, 1: 1}))
    assert jstats == tstats
    assert tstats["rejitted_slots"] == (0, 1) == tstats["refit_slots"]
    r_mig = serve_both(jsrv, tsrv, [x], 7)[0]
    r_new = _fresh(tsrv.ir).serve_batch([x], rng=np.random.default_rng(7))[0]
    np.testing.assert_array_equal(r_mig.logits, r_new.logits)


def test_migrate_zeroes_fc_when_store_has_no_weights():
    jsrv, tsrv = _pair()
    jsrv.redeploy_fn = tsrv.redeploy_fn = None
    x = _x()
    before = tsrv.serve_batch([x], rng=np.random.default_rng(7))[0]
    jstats, tstats = both(jsrv, tsrv, lambda s, _: s.migrate(
        s.ir.with_(partition=_swapped(s.ir)), {0: 0, 1: 1}))
    assert jstats == tstats and tstats["zeroed_slots"] == (0, 1)
    assert_same_server_state(jsrv, tsrv)
    r = serve_both(jsrv, tsrv, [x], 7)[0]
    # bias-only logits, reported degraded though every replica arrived
    np.testing.assert_allclose(
        r.logits, np.broadcast_to(tsrv.fc_bias.numpy(), r.logits.shape),
        atol=1e-6)
    assert not np.allclose(r.logits, before.logits)
    assert r.degraded and r.arrived.all()


def test_knowledge_gap_survives_placement_only_migration():
    jsrv, tsrv = _pair()
    jsrv.redeploy_fn = tsrv.redeploy_fn = None
    both(jsrv, tsrv, lambda s, _: s.migrate(
        s.ir.with_(partition=_swapped(s.ir)), {0: 0, 1: 1}))
    jstats, tstats = both(jsrv, tsrv, lambda s, _: s.migrate(
        s.ir.with_(member=np.array(s.ir.member)[::-1])))
    assert jstats == tstats and tstats["zeroed_slots"] == (0, 1)
    assert tsrv.zeroed_slots == {0, 1}
    r = serve_both(jsrv, tsrv, [_x()], 7)[0]
    assert r.degraded and r.arrived.all()


def test_deploy_slot_restores_zeroed_slot():
    jsrv, tsrv = _pair()
    stores = (jsrv.redeploy_fn, tsrv.redeploy_fn)
    jsrv.redeploy_fn = tsrv.redeploy_fn = None
    new_irs = both(jsrv, tsrv,
                   lambda s, _: s.ir.with_(partition=_swapped(s.ir)))
    for srv, ir in zip((jsrv, tsrv), new_irs):
        srv.migrate(ir, {0: 0, 1: 1})
    for srv, store, ir in zip((jsrv, tsrv), stores, new_irs):
        for k in (0, 1):
            srv.deploy_slot(k, *store(ir, k))
    assert tsrv.zeroed_slots == frozenset() == jsrv.zeroed_slots
    r = serve_both(jsrv, tsrv, [_x()], 7)[0]
    r_new = _fresh(new_irs[1]).serve_batch([_x()],
                                           rng=np.random.default_rng(7))[0]
    np.testing.assert_array_equal(r.logits, r_new.logits)
    assert not r.degraded


def test_migrate_rejects_out_of_range_mapping():
    _, tsrv = _pair()
    with pytest.raises(ValueError, match="source slot 9"):
        tsrv.migrate(tsrv.ir, {0: 9})
    with pytest.raises(ValueError, match="source slot -1"):
        tsrv.migrate(tsrv.ir, {1: -1})


# -- tests/test_controller.py twins -------------------------------------------------

def _toy_servers():
    """tests/test_controller.py's planner.Plan server, in both packages."""
    import jax.numpy as jnp
    W = np.random.default_rng(0).normal(size=(2, 4, 3)).astype(np.float32)
    b = np.arange(3, dtype=np.float32)
    out = []
    for PL, Dev, SA, Srv, FM, ones in (
            (JPL, Device, StudentArch, jserving.QuorumServer, JFailure,
             lambda n: jnp.ones((n, 4), jnp.float32)),
            (TPL, TDevice, TStudentArch, tserving.QuorumServer, TFailure,
             lambda n: torch.ones((n, 4)))):
        st = SA("s", 5e6, 0.6e6, 64, 0.15e6)
        groups = [
            PL.GroupPlan(0, [Dev("a", 1e7, 2e6, 500, 0.3),
                             Dev("b", 2e7, 2e6, 500, 0.3)], 0,
                         np.arange(4), st),
            PL.GroupPlan(1, [Dev("c", 1e7, 2e6, 500, 0.3),
                             Dev("d", 3e7, 2e6, 500, 0.3)], 1,
                         np.arange(4, 8), st)]
        plan = PL.Plan(groups, np.zeros((8, 8)), 1.0, 0.5)
        fns = [lambda x, o=ones: x @ o(x.shape[-1]),
               lambda x, o=ones: x @ (2 * o(x.shape[-1]))]
        kw = {} if Srv is jserving.QuorumServer else {"device": "cpu"}
        out.append(Srv(plan, fns, W, b, failure=FM(outages=False), **kw))
    return out


def test_remove_device_repairs_instead_of_dead_group():
    jsrv, tsrv = _toy_servers()
    x = np.ones((2, 5), np.float32)
    both(jsrv, tsrv, lambda s, _: s.remove_device("a"))
    jout, tout = both(jsrv, tsrv, lambda s, _: s.remove_device("b"))
    assert tout.kind == "repair"
    assert_same_outcome(jout, tout)
    assert_same_server_state(jsrv, tsrv)
    assert tsrv.ir.quorum().all()
    res = serve_both(jsrv, tsrv, [x], 0)[0]
    assert res.arrived.all() and not res.degraded
    assert set(tsrv.ir.device_names) == {"c", "d"}
    assert [d.name for d in tsrv.live_devices()] == \
        [d.name for d in jsrv.live_devices()]


def test_remove_device_legacy_flag_preserves_old_behaviour():
    jsrv, tsrv = _toy_servers()
    for name in ("a", "b"):
        assert both(jsrv, tsrv, lambda s, _: s.remove_device(
            name, repair=False)) == (None, None)
    res = serve_both(jsrv, tsrv, [np.ones((2, 5), np.float32)], 0)[0]
    assert res.degraded and not res.arrived[0]


def test_remove_device_noop_when_quorum_survives():
    jsrv, tsrv = _toy_servers()
    jout, tout = both(jsrv, tsrv, lambda s, _: s.remove_device("a"))
    assert tout.kind == "noop"
    assert_same_outcome(jout, tout)
    assert "a" not in tsrv.ir.device_names


def test_migrate_keeps_portion_wrappers_of_untouched_slots():
    """The port compiles nothing: "re-jitted" means the slot's portion
    wrapper was replaced, and an untouched slot keeps its wrapper object."""
    jsrv, tsrv = _toy_servers()
    before = list(tsrv.portion_fns)
    jstats, tstats = both(jsrv, tsrv, lambda s, _: s.migrate(
        s.ir.with_(member=np.array(s.ir.member)[::-1])))
    assert jstats == tstats and tstats["rejitted_slots"] == ()
    new_part = np.array(tsrv.ir.partition)
    new_part[0] = ~new_part[0]
    jstats, tstats = both(jsrv, tsrv, lambda s, _: s.migrate(
        s.ir.with_(partition=new_part)))
    assert jstats == tstats
    assert tstats["rejitted_slots"] == () and tstats["zeroed_slots"] == (0,)
    assert all(a is b for a, b in zip(tsrv.portion_fns, before))


# -- tests/test_fastpath.py twins ---------------------------------------------------

def test_fused_survives_remove_repair_migrate():
    jsrv, tsrv = _pair()
    x = _x()
    serve_both(jsrv, tsrv, [x], 0)                     # stacks built
    both(jsrv, tsrv, lambda s, _: s.remove_device("a"))
    jout, tout = both(jsrv, tsrv, lambda s, _: s.remove_device("b"))
    assert tout.kind == "repair" and tsrv.fastpath_active
    assert_same_outcome(jout, tout)
    assert_same_server_state(jsrv, tsrv)
    r_mig = serve_both(jsrv, tsrv, [x], 7)[0]
    r_new = _fresh(tsrv.ir).serve_batch([x], rng=np.random.default_rng(7))[0]
    r_ora = _fresh(tsrv.ir, fastpath=False).serve_batch(
        [x], rng=np.random.default_rng(7))[0]
    assert r_mig.arrived.all() and r_mig.latency == r_new.latency
    np.testing.assert_array_equal(r_mig.logits, r_new.logits)
    np.testing.assert_allclose(r_mig.logits, r_ora.logits, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("prebuild", [True, False])
def test_partition_reshape_rebuilds_only_touched_rows(prebuild):
    jsrv, tsrv = _pair()
    x = _x()
    if prebuild:
        serve_both(jsrv, tsrv, [x], 0)
    live = tsrv._fused_stacked
    saved = None if live is None else live.clone()
    new_part = np.zeros((2, tsrv.ir.M), bool)
    new_part[0, :5] = True
    new_part[1, 5:] = True
    jstats, tstats = both(jsrv, tsrv, lambda s, _: s.migrate(
        s.ir.with_(partition=new_part), {0: 0, 1: 1}))
    assert jstats == tstats and tstats["fused_rows_rebuilt"] == (0, 1)
    assert tsrv.fastpath_active
    if prebuild:
        # a migration installs fresh tensors; the live stack is not written
        assert tsrv._fused_stacked is not live
        assert torch.equal(live, saved)
    r = serve_both(jsrv, tsrv, [x], 7)[0]
    np.testing.assert_array_equal(
        r.logits, _fresh(tsrv.ir).serve_batch(
            [x], rng=np.random.default_rng(7))[0].logits)


def test_partial_reshape_keeps_untouched_row():
    jsrv, tsrv = _pair()
    x = _x()
    serve_both(jsrv, tsrv, [x], 0)
    old_row1 = tsrv._fused_stacked[1].clone()
    new_part = np.array(tsrv.ir.partition)
    new_part[0] = False
    new_part[0, :3] = True
    jstats, tstats = both(jsrv, tsrv, lambda s, _: s.migrate(
        s.ir.with_(partition=new_part), {0: 0, 1: 1}))
    assert jstats == tstats
    assert tstats["fused_rows_rebuilt"] == (0,) and tstats["reused_slots"] == 1
    assert torch.equal(tsrv._fused_stacked[1], old_row1)
    r = serve_both(jsrv, tsrv, [x], 7)[0]
    np.testing.assert_array_equal(
        r.logits, _fresh(tsrv.ir).serve_batch(
            [x], rng=np.random.default_rng(7))[0].logits)


def test_migration_without_store_params_falls_back_to_legacy():
    jsrv, tsrv = _pair()
    for srv in (jsrv, tsrv):
        srv.redeploy_fn = (lambda store: lambda ir, k: store(ir, k)[:2])(
            srv.redeploy_fn)
    jstats, tstats = both(jsrv, tsrv, lambda s, _: s.migrate(
        s.ir.with_(partition=_swapped(s.ir)), {0: 0, 1: 1}))
    assert jstats == tstats and tstats["fused_rows_rebuilt"] == ()
    assert tsrv.fused is None and not tsrv.fastpath_active
    r = serve_both(jsrv, tsrv, [_x()], 7)[0]
    np.testing.assert_allclose(
        r.logits, _fresh(tsrv.ir).serve_batch(
            [_x()], rng=np.random.default_rng(7))[0].logits,
        rtol=1e-6, atol=1e-6)


def test_deploy_slot_updates_fused_row():
    jsrv, tsrv = _pair()
    stores = (jsrv.redeploy_fn, tsrv.redeploy_fn)
    serve_both(jsrv, tsrv, [_x()], 0)
    new_irs = both(jsrv, tsrv,
                   lambda s, _: s.ir.with_(partition=_swapped(s.ir)))
    for srv, ir in zip((jsrv, tsrv), new_irs):
        srv.redeploy_fn = None
        srv.migrate(ir, {0: 0, 1: 1})
    live = tsrv._fused_stacked
    for srv, store, ir in zip((jsrv, tsrv), stores, new_irs):
        for k in (0, 1):
            srv.deploy_slot(k, *store(ir, k))
    assert tsrv.fastpath_active and tsrv._fused_stacked is not live
    r = serve_both(jsrv, tsrv, [_x()], 7)[0]
    np.testing.assert_array_equal(
        r.logits, _fresh(new_irs[1]).serve_batch(
            [_x()], rng=np.random.default_rng(7))[0].logits)


def _fig3_fleet_ir():
    """tests/test_fastpath.py's fig-3 fleet plan."""
    rng = np.random.default_rng(0)
    a = np.abs(rng.normal(size=(128, 64)))
    A = (a.T @ a) * np.abs(a.mean(0)[:, None] - a.mean(0)[None, :])
    np.fill_diagonal(A, 0)
    A = 0.5 * (A + A.T)
    students = [StudentArch("small", 5e6, 0.6e6, 64, 0.15e6),
                StudentArch("mid", 2e7, 1.5e6, 64, 0.4e6)]
    return JPL.tune_d_th_ir(make_fleet(8, seed=2, success_prob=0.8), A,
                            students, p_th=0.25)


def test_int8_tolerance_survives_migration():
    jir = _fig3_fleet_ir()
    tir = _port_ir(jir)
    build = dict(feat=32, hidden=64, n_classes=10, seed=0, device="cpu")
    fp32 = tengine.build_demo_server(tir, **build)
    int8 = tengine.build_demo_server(tir, quantize="int8", **build)
    from repro.runtime.engine import build_demo_server as jbuild
    jint8 = jbuild(jir, feat=32, hidden=64, n_classes=10, seed=0,
                   quantize="int8")
    x = np.random.default_rng(5).standard_normal((64, 32)).astype(np.float32)
    serve_both(jint8, int8, [x], 0)                    # stacks built
    name = jir.device_names[int(np.flatnonzero(jir.member.any(0))[0])]
    jout = jint8.remove_device(name)
    tout = int8.remove_device(name)
    fp32.remove_device(name)
    assert_same_outcome(jout, tout)
    assert_same_server_state(jint8, int8)
    assert int8.fastpath_active
    lq = serve_both(jint8, int8, [x], 1)[0].logits
    lf = fp32.serve_batch([x], rng=np.random.default_rng(1))[0].logits
    assert np.abs(lf - lq).max() / max(np.abs(lf).max(), 1e-12) < INT8_REL


# -- re-encode cycles: tests/test_coding.py and tests/test_coded_compute.py ----------

def test_remove_device_reencodes_systematic_share():
    jir, tir = coded_twins(_output_rep_ir(), code_k=4, parity=2)
    jsrv, tsrv = _demo(jir, tir)
    x = _x()
    before = serve_both(jsrv, tsrv, [x], 0)[0].logits
    jout, tout = both(jsrv, tsrv, lambda s, _: s.remove_device(_sysdev(jir)))
    assert tout.kind == "reencode" and tout.reencoded_shares == (0,)
    assert len(tout.moved_devices) == 1 and tsrv.ir.member[0].sum() == 1
    assert_same_outcome(jout, tout)
    assert_same_server_state(jsrv, tsrv)
    after = serve_both(jsrv, tsrv, [x], 0)[0]
    np.testing.assert_array_equal(after.logits, before)
    assert not after.degraded


def test_remove_device_reencodes_parity_share():
    jir, tir = coded_twins(_output_rep_ir(), code_k=4, parity=2)
    jsrv, tsrv = _demo(jir, tir)
    x = _x()
    before = serve_both(jsrv, tsrv, [x], 0)[0].logits
    pcol = int(np.flatnonzero(jir.coding.parity_member[1])[0])
    jout, tout = both(jsrv, tsrv, lambda s, _: s.remove_device(
        jir.device_names[pcol]))
    assert tout.kind == "reencode" and tout.reencoded_shares == (jir.K + 1,)
    assert_same_outcome(jout, tout)
    assert_same_server_state(jsrv, tsrv)
    np.testing.assert_array_equal(serve_both(jsrv, tsrv, [x], 0)[0].logits,
                                  before)


def test_reencode_cycle_then_decode_matches_jax():
    jir, tir = coded_twins(_output_rep_ir(), code_k=4, parity=2)
    jf, tf = _demo(jir, tir)
    jl, tl = _demo(jir, tir, fastpath=False)
    victim = _sysdev(jir)
    for jsrv, tsrv in ((jf, tf), (jl, tl)):
        jout, tout = both(jsrv, tsrv, lambda s, _: s.remove_device(victim))
        assert tout.reencoded_shares
        assert_same_outcome(jout, tout)
        dead = _sysdev(tsrv.ir, slot=1)
        jsrv.failure = JFailure(forced_failures=[dead], outages=False)
        tsrv.failure = TFailure(forced_failures=[dead], outages=False)
    rf = serve_both(jf, tf, [_x()], 2)
    rl = serve_both(jl, tl, [_x()], 2)
    assert rf[0].arrived.all()
    assert_paths_close(tf, rf, rl)


def test_controller_reencodes_lost_shard_onto_spare():
    jir, tir = coded_twins(_compute_rep_ir(spares=8), code_k=3, parity=2,
                           mode="compute")
    jsrv, tsrv = _demo(jir, tir)
    clean = serve_both(jsrv, tsrv, [_x()], 0)[0]
    victim = jir.device_names[int(jir.compute_coding.shard_member[0][0])]
    jout = jcontroller.ClusterController(jir, server=jsrv).permanent_loss(
        victim)
    ctl = tcontroller.ClusterController(tir, server=tsrv)
    tout = ctl.permanent_loss(victim)
    assert tout.kind == "reencode" and tout.feasible
    assert len(tout.reencoded_shares) == 1 and len(tout.moved_devices) == 1
    assert_same_outcome(jout, tout)
    assert_same_server_state(jsrv, tsrv)
    ctl.ir.validate()
    r = serve_both(jsrv, tsrv, [_x()], 0)[0]
    assert r.arrived.all() and not r.degraded
    np.testing.assert_allclose(r.logits, clean.logits, atol=5e-4, rtol=5e-4)


def test_controller_full_replans_undecodable_compute_slot():
    jir, tir = coded_twins(_compute_rep_ir(spares=8), code_k=3, parity=2,
                           mode="compute")
    jsrv, tsrv = _demo(jir, tir)
    kill = [jir.device_names[int(c)]
            for c in jir.compute_coding.shard_member[0][:3]]
    jout = jcontroller.ClusterController(jir, server=jsrv).observe(kill)
    ctl = tcontroller.ClusterController(tir, server=tsrv)
    tout = ctl.observe(kill)
    assert tout.kind == "full_replan" and ctl.ir.compute_coding is None
    assert_same_outcome(jout, tout)
    assert_same_server_state(jsrv, tsrv)
    assert not serve_both(jsrv, tsrv, [_x()], 0)[0].degraded
