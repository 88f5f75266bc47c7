"""Data parallelism and ZeRO-1 on a ``DeviceMesh``
(``repro_torch.launch.steps.mesh_step``), and restoring a checkpoint onto a
mesh, on CPU process groups.

Two gloo processes on a ``FileStore`` under ``tmp_path`` run each
multi-process case (:func:`run_ranks`): joined with a time limit of their
own (60 s), killed on expiry, and the test then fails. Tiny fp32 configs.
"""
import multiprocessing as mp
import queue
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.ckpt.checkpoint import (CheckpointManager,
                                         flatten_with_keys, from_snapshot,
                                         snapshot)
from repro_torch.compat import DTensor, abstract_mesh, init_device_mesh
from repro_torch.configs.archs import tiny_version
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as ST
from repro_torch.models import api
from repro_torch.optim import adamw

RANK_TIMEOUT = 60.0
# the clip acts (0.05 under these grads' norm); eps above the clipped
# gradients' size (~1e-5), so that AdamW's normalised step is smooth in
# the gradient: with eps 1e-8 an element whose two gradients nearly cancel
# in the first moment turns the summation order's last bits into ~1e-3 of
# its step, and no leaf-wise bound of 1e-6 could hold for any reordering
OPT = adamw.AdamWConfig(warmup_steps=1, grad_clip=0.05, eps=1e-4)
BATCH, SEQ, STEPS = 4, 32, 2


# -- the multi-process harness -----------------------------------------------

def _entry(fn, rank, world, store, out, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out.put((rank, True, fn(rank, world, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world, tmp_path, *args, timeout=RANK_TIMEOUT):
    """``fn(rank, world, *args)`` in ``world`` spawned processes of one
    gloo group; their results by rank. Processes still running after
    ``timeout`` seconds are killed and the test fails."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = str(tmp_path / f"store_{time.monotonic_ns()}")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, store, out, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results = {}
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                pytest.fail(f"ranks did not finish within {timeout} s")
            try:
                rank, ok, payload = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    pytest.fail("a rank died: exit codes "
                                f"{[p.exitcode for p in procs]}")
                continue
            if not ok:
                pytest.fail(f"rank {rank} failed:\n{payload}")
            results[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


@pytest.fixture
def solo_group():
    """A one-process gloo group (``launch.mesh.init_group``) for the
    test, destroyed after it."""
    assert not dist.is_initialized()
    M.init_group("cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


# -- the cases ------------------------------------------------------------------

def _cfg(arch):
    return tiny_version(get_config(arch))


def _state(cfg):
    params = api.init(torch.Generator().manual_seed(0), cfg)
    return ST.TrainState(params, adamw.init(OPT, params))


def _batches(cfg):
    g = torch.Generator().manual_seed(1)
    return [{"tokens": torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=g),
             "labels": torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=g)}
            for _ in range(STEPS)]


def _numpy(tree):
    return [(k, (v.full_tensor() if isinstance(v, DTensor) else v)
             .detach().numpy().copy()) for k, v in flatten_with_keys(tree)]


def _dp_worker(rank, world, arch, zero1):
    cfg = _cfg(arch)
    mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data",
                                                                "model"))
    plan = ST.mesh_plan(cfg, mesh, zero1=zero1)
    state = ST.mesh_state(_state(cfg), plan)
    step = ST.mesh_step(cfg, ShapeConfig("t", SEQ, BATCH, "train"), mesh,
                        OPT, zero1=zero1)
    losses, norms = [], []
    for b in _batches(cfg):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    blocks = {k: (tuple(v.to_local().shape), tuple(v.shape))
              for k, v in flatten_with_keys(state.opt.master)}
    return dict(losses=losses, norms=norms, state=_numpy(state),
                blocks=blocks)


def _rel(a, b) -> float:
    """‖a − b‖ / ‖b‖ over a leaf (‖a‖ where b is zero)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den else float(
        np.linalg.norm(a))


def _reference(arch):
    cfg = _cfg(arch)
    state, step = _state(cfg), ST.make_train_step(cfg, OPT)
    losses, norms = [], []
    for b in _batches(cfg):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(losses=losses, norms=norms, state=_numpy(state))


@pytest.mark.parametrize("zero1", [True, False])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m"])
def test_data_parallel_steps_equal_one_process(arch, zero1, tmp_path):
    """data = 2: two steps of the global batch split over two ranks equal
    one process on the whole batch (loss within 1e-6, each leaf of the
    params and the master copy within 1e-6 of its norm, of the moments
    within 1e-5); with
    ZeRO-1 each rank holds only its block of the master copy and moments,
    and the gathered state (and the clip's norm) is the unsharded one."""
    got = run_ranks(_dp_worker, 2, tmp_path, arch, zero1)
    ref = _reference(arch)
    for r in got:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(r["norms"], ref["norms"], rtol=1e-6)
        for (k, a), (k2, b) in zip(r["state"], ref["state"]):
            assert k == k2
            # the moments hold the gradients themselves: their sums in
            # another order differ by ~5e-7 of a leaf (2e-6 for mamba2's
            # A_log, whose gradient sums every position's cancelling terms)
            tol = 1e-5 if k.startswith((".opt.m", ".opt.v")) else 1e-6
            assert _rel(a, b) <= tol, (k, _rel(a, b))
    assert ref["norms"][0] > OPT.grad_clip        # the clip acted
    sharded = [k for k, (loc, full) in got[0]["blocks"].items()
               if loc != full]
    if zero1:
        assert sharded, "ZeRO-1 sharded no leaf"
        for k, (loc, full) in got[0]["blocks"].items():
            assert loc == full or sum(a != b for a, b in zip(loc, full)) == 1
            assert all(a * (2 if a != b else 1) == b
                       for a, b in zip(loc, full)), k
    else:
        assert not sharded


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m"])
def test_one_rank_mesh_step_is_bit_equal(arch, solo_group):
    """A (1, 1) mesh in one process: the mesh train step (ZeRO-1 on)
    equals ``make_train_step`` bit for bit, loss and every leaf."""
    cfg = _cfg(arch)
    mesh = M.make_mesh((1, 1), ("data", "model"), device="cpu")
    state = ST.mesh_state(_state(cfg), ST.mesh_plan(cfg, mesh))
    step = ST.mesh_step(cfg, ShapeConfig("t", SEQ, BATCH, "train"), mesh,
                        OPT)
    ref, rstep = _state(cfg), ST.make_train_step(cfg, OPT)
    for b in _batches(cfg):
        state, m = step(state, b)
        ref, rm = rstep(ref, b)
        assert torch.equal(m["loss"], rm["loss"])
        assert torch.equal(m["grad_norm"], rm["grad_norm"])
    for (k, a), (_, b) in zip(_numpy(state), _numpy(ref)):
        assert np.array_equal(a, b), k


def test_mesh_prefill_and_serve_equal_the_plain_steps(solo_group):
    cfg = _cfg("llama3.2-1b")
    mesh = M.make_mesh((1, 1), ("data", "model"), device="cpu")
    params = api.init(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(2))
    prefill = ST.mesh_step(cfg, ShapeConfig("p", 16, 2, "prefill"), mesh)
    serve = ST.mesh_step(cfg, ShapeConfig("d", 24, 2, "decode"), mesh)
    logits, pcache = prefill(params, {"tokens": tokens})
    rlogits, rcache = ST.make_prefill_step(cfg)(params, {"tokens": tokens})
    assert torch.equal(logits.to_local(), rlogits)
    cache = ST.mesh_cache(api.init_cache(cfg, 2, 24, device="cpu"), mesh)
    ref = api.init_cache(cfg, 2, 24, device="cpu")
    for name in ref:
        for dst in (cache[name].to_local(), ref[name]):
            dst[tuple(slice(0, n) for n in rcache[name].shape)] = \
                rcache[name]
    cur = rlogits[:, -1:].argmax(-1)
    for t in range(4):
        out, cache = serve(params, cache, {"tokens": cur}, 16 + t)
        rout, ref = ST.make_serve_step(cfg)(params, ref, {"tokens": cur},
                                            16 + t)
        assert torch.equal(out.to_local(), rout)
        cur = rout[:, -1:].argmax(-1)
    with pytest.raises(NotImplementedError, match="dryrun"):
        ST.mesh_step(_cfg("mamba2-130m"), ShapeConfig("t", 8, 2, "train"),
                     abstract_mesh((1, 2), ("data", "model")))


# -- restoring onto a mesh -------------------------------------------------------

def _save_worker(rank, world, arch, directory):
    """One mesh step at data = ``world`` (ZeRO-1 on), then a checkpoint;
    the state (gathered) as numpy."""
    cfg = _cfg(arch)
    mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data",
                                                                "model"))
    state = ST.mesh_state(_state(cfg), ST.mesh_plan(cfg, mesh))
    step = ST.mesh_step(cfg, ShapeConfig("t", SEQ, BATCH, "train"), mesh,
                        OPT)
    state, _ = step(state, _batches(cfg)[0])
    CheckpointManager(directory).save(1, state)
    dist.barrier()
    return _numpy(state)


def _restore_worker(rank, world, arch, directory):
    """The checkpoint restored onto a data = ``world`` mesh by
    ``state_shardings``, then one more mesh step: the restored state, each
    master leaf's local block shape, the state after the step."""
    cfg = _cfg(arch)
    mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data",
                                                                "model"))
    state = CheckpointManager(directory).restore(
        1, _state(cfg), ST.state_shardings(cfg, OPT, mesh))
    blocks = {k: tuple(v.to_local().shape)
              for k, v in flatten_with_keys(state.opt.master)}
    before = _numpy(state)
    step = ST.mesh_step(cfg, ShapeConfig("t", SEQ, BATCH, "train"), mesh,
                        OPT)
    state, _ = step(state, _batches(cfg)[1])
    return dict(state=before, blocks=blocks, after=_numpy(state))


def _same(got, saved):
    for (k, a), (k2, b) in zip(got, saved):
        assert k == k2 and np.array_equal(a, b), k


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m"])
def test_checkpoint_saved_at_data_2_restores_at_data_1(arch, tmp_path,
                                                       solo_group):
    """The elastic restart: a state saved from a data = 2 mesh restores
    leaf for leaf onto a data = 1 mesh (whole blocks), and steps on."""
    saved = run_ranks(_save_worker, 2, tmp_path, arch, str(tmp_path / "c"))
    assert all(np.array_equal(a, b) for (_, a), (_, b) in
               zip(saved[0], saved[1]))
    got = _restore_worker(0, 1, arch, str(tmp_path / "c"))
    _same(got["state"], saved[0])
    full = dict(saved[0])
    assert all(loc == full[".opt.master" + k].shape
               for k, loc in got["blocks"].items())


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m"])
def test_checkpoint_saved_at_data_1_restores_at_data_2(arch, tmp_path,
                                                       solo_group):
    """The reverse: saved from a data = 1 mesh, restored onto data = 2
    with each rank holding its ZeRO-1 blocks; both ranks step on to the
    same state, which one process stepping the restored state equals."""
    saved = _save_worker(0, 1, arch, str(tmp_path / "c"))
    got = run_ranks(_restore_worker, 2, tmp_path, arch, str(tmp_path / "c"))
    full = dict(saved)
    for r in got:
        _same(r["state"], saved)
        assert any(loc != full[".opt.master" + k].shape
                   for k, loc in r["blocks"].items())
    _same(got[0]["after"], got[1]["after"])
    one = _restore_worker(0, 1, arch, str(tmp_path / "c"))
    for (k, a), (_, b) in zip(got[0]["after"], one["after"]):
        tol = 1e-5 if k.startswith((".opt.m", ".opt.v")) else 1e-6
        assert _rel(a, b) <= tol, (k, _rel(a, b))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m"])
def test_snapshot_restores_onto_a_mesh_as_the_checkpoint_does(
        arch, tmp_path, solo_group):
    """A mesh state's host snapshot (what ``save`` writes) placed onto the
    mesh by ``from_snapshot`` equals the written checkpoint's ``restore``,
    leaf for leaf and placement for placement."""
    saved = _save_worker(0, 1, arch, str(tmp_path / "c"))
    cfg = _cfg(arch)
    mesh = M.make_mesh((1, 1), ("data", "model"), device="cpu")
    state = ST.mesh_state(_state(cfg), ST.mesh_plan(cfg, mesh))
    host = snapshot(state)
    shardings = ST.state_shardings(cfg, OPT, mesh)
    for key, arr in snapshot(_state(cfg)).items():
        assert np.array_equal(host[key], arr), key
    disk = CheckpointManager(str(tmp_path / "c")).restore(1, _state(cfg),
                                                          shardings)
    mem = from_snapshot(snapshot(disk), _state(cfg), shardings)
    _same(_numpy(mem), saved)
    for (k, a), (_, b) in zip(flatten_with_keys(mem),
                              flatten_with_keys(disk)):
        assert a.placements == b.placements, k


def test_jax_fp32_checkpoint_restores_onto_a_port_mesh(tmp_path, solo_group):
    import jax
    from repro.ckpt.checkpoint import CheckpointManager as JCM
    from repro.configs.archs import tiny_version as j_tiny
    from repro.configs.base import get_config as j_get
    from repro.launch.steps import TrainState as JTS
    from repro.models import api as japi
    from repro.optim import adamw as jadamw
    jcfg = j_tiny(j_get("llama3.2-1b"))
    jparams = japi.init(jax.random.key(3), jcfg)
    jstate = JTS(jparams, jadamw.init(jadamw.AdamWConfig(), jparams))
    JCM(str(tmp_path / "j")).save(5, jstate)
    cfg = _cfg("llama3.2-1b")
    mesh = M.make_mesh((1, 1), ("data", "model"), device="cpu")
    state = CheckpointManager(str(tmp_path / "j")).restore(
        5, _state(cfg), ST.state_shardings(cfg, OPT, mesh))
    jflat = dict((jax.tree_util.keystr(p), np.asarray(v)) for p, v in
                 jax.tree_util.tree_leaves_with_path(jstate))
    for k, v in flatten_with_keys(state):
        assert isinstance(v, DTensor)
        assert np.array_equal(v.to_local().numpy(), jflat[k]), k
