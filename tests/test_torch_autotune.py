"""The port's block-size autotuner held to the JAX package's, case by case
after ``tests/test_autotune.py``: table keys, JSON format, precedence, the
environment variable, the candidate order and the hysteresis rule, and a
table entry that changes what a wrapper resolves but not its result."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import autotune as JAT  # noqa: E402
from repro_torch.kernels import autotune as AT  # noqa: E402
from repro_torch.kernels import coded_decode as CD  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quorum_aggregate as QA  # noqa: E402
from repro_torch.launch import microbench  # noqa: E402


@pytest.fixture(autouse=True)
def _isolated_table(monkeypatch):
    """Never let a test read or write a persisted table."""
    monkeypatch.delenv("REPRO_TORCH_TUNING_TABLE", raising=False)
    monkeypatch.delenv("REPRO_TUNING_TABLE", raising=False)
    saved = AT.active_table()
    AT.set_table(AT.TuningTable())
    yield
    AT.set_table(saved)


@pytest.mark.parametrize("kernel,shape,tdt,jdt", [
    ("dequant_matmul", (64, 128, 256), torch.int8, jnp.int8),
    ("quorum_aggregate", (4, 1024, 16, 10), torch.float32, np.float32),
    ("quorum_aggregate", (8, 256, 32, 10), torch.int8, np.int8),
    ("coded_decode", (256, 6, 4, 64), torch.float32, jnp.float32),
])
def test_table_key_equals_the_jax_key(kernel, shape, tdt, jdt):
    assert AT.table_key(kernel, shape, tdt) == \
        JAT.table_key(kernel, shape, jdt)
    assert AT.table_key(kernel, shape, jdt) == \
        JAT.table_key(kernel, shape, jdt)


def test_key_helpers_equal_the_jax_helpers():
    rng = np.random.default_rng(0)
    p = rng.standard_normal((4, 33, 16)).astype(np.float32)
    w = rng.integers(-127, 128, (4, 16, 10)).astype(np.int8)
    sh = rng.standard_normal((33, 6, 64)).astype(np.float32)
    dec = rng.standard_normal((33, 4, 6)).astype(np.float32)
    x = rng.standard_normal((33, 64)).astype(np.float32)
    q = rng.integers(-127, 128, (64, 256)).astype(np.int8)
    pairs = [("quorum_aggregate", AT.key_quorum_aggregate,
              JAT.key_quorum_aggregate, (p, w)),
             ("coded_decode", AT.key_coded_decode, JAT.key_coded_decode,
              (sh, dec)),
             ("dequant_matmul", AT.key_dequant_matmul,
              JAT.key_dequant_matmul, (x, q))]
    for kernel, tkey, jkey, args in pairs:
        tshape, tdt = tkey(*(torch.from_numpy(a) for a in args))
        jshape, jdt = jkey(*(jnp.asarray(a) for a in args))
        assert tshape == jshape
        assert AT.table_key(kernel, tshape, tdt) == \
            JAT.table_key(kernel, jshape, jdt)


def test_put_get_and_miss():
    t = AT.TuningTable()
    t.put("dequant_matmul", (64, 128, 256), torch.int8,
          {"block_batch": 32, "block_n": 64})
    assert t.get("dequant_matmul", (64, 128, 256), torch.int8) == \
        {"block_batch": 32, "block_n": 64}
    assert t.get("dequant_matmul", (64, 128, 512), torch.int8) is None
    assert len(t) == 1


def test_save_load_round_trip_reads_as_the_jax_format(tmp_path):
    t = AT.TuningTable()
    t.put("quorum_aggregate", (4, 64, 16, 10), torch.float32,
          {"block_batch": 64})
    t.put("coded_decode", (64, 6, 4, 16), torch.float32, {"block_batch": 4})
    path = tmp_path / "table.json"
    t.save(path)
    assert AT.TuningTable.load(path).entries == t.entries
    raw = json.loads(path.read_text())
    assert raw["quorum_aggregate|4x64x16x10|float32"] == {"block_batch": 64}
    # the JAX package reads the same file to the same entries
    assert JAT.TuningTable.load(path).entries == t.entries


def test_active_table_survives_garbage(tmp_path, monkeypatch):
    path = tmp_path / "bad.json"
    path.write_text("{not json")
    monkeypatch.setenv("REPRO_TORCH_TUNING_TABLE", str(path))
    AT.reset()
    assert len(AT.active_table()) == 0


def test_resolve_precedence():
    shape, dtype = (4, 64, 16, 10), torch.float32
    assert AT.resolve("quorum_aggregate", shape, dtype, {}) == \
        AT.DEFAULTS["quorum_aggregate"]
    AT.active_table().put("quorum_aggregate", shape, dtype,
                          {"block_batch": 64})
    assert AT.resolve("quorum_aggregate", shape, dtype, {}) == \
        {"block_batch": 64}
    assert AT.resolve("quorum_aggregate", shape, dtype,
                      {"block_batch": 32}) == {"block_batch": 32}
    assert AT.resolve("quorum_aggregate", shape, dtype,
                      {"block_batch": None}) == {"block_batch": 64}


def test_env_table_is_read_and_the_tpu_variable_is_not(tmp_path,
                                                       monkeypatch):
    t = AT.TuningTable()
    t.put("coded_decode", (64, 6, 4, 16), torch.float32, {"block_batch": 8})
    path = tmp_path / "env_table.json"
    t.save(path)
    monkeypatch.setenv("REPRO_TUNING_TABLE", str(path))
    AT.reset()
    assert AT.active_table().get("coded_decode", (64, 6, 4, 16),
                                 torch.float32) is None
    monkeypatch.setenv("REPRO_TORCH_TUNING_TABLE", str(path))
    AT.reset()
    assert AT.active_table().get("coded_decode", (64, 6, 4, 16),
                                 torch.float32) == {"block_batch": 8}


def test_no_table_ships_with_the_port():
    assert not AT._DEFAULT_PATH.exists()


@pytest.mark.parametrize("kernel", sorted(AT.DEFAULTS))
def test_configs_default_first_and_in_its_grid(kernel):
    configs = AT._configs(kernel)
    assert configs[0] == AT.DEFAULTS[kernel]
    assert len(configs) == len({tuple(sorted(c.items())) for c in configs})
    for name, v in AT.DEFAULTS[kernel].items():
        assert v in AT.CANDIDATES[kernel][name]
    assert sorted(AT.DEFAULTS) == sorted(JAT.DEFAULTS)


def _fake_tuning(monkeypatch, times):
    """Register a synthetic kernel with fixed timings in both packages."""
    for mod in (AT, JAT):
        monkeypatch.setitem(mod.DEFAULTS, "fake", {"block_batch": 32})
        monkeypatch.setitem(mod.CANDIDATES, "fake",
                            {"block_batch": tuple(sorted(times))})
    monkeypatch.setattr(microbench, "time_callable",
                        lambda fn, repeats=5, warmup=1: times[fn()])
    from repro.launch import microbench as jmb
    monkeypatch.setattr(jmb, "time_callable",
                        lambda fn, repeats=5, warmup=1: times[fn()])
    return lambda blocks: (lambda: blocks["block_batch"])


@pytest.mark.parametrize("times,want", [
    ({32: 1.00, 64: 0.98}, 32),     # ~2% faster: the default keeps its seat
    ({32: 1.00, 64: 0.50}, 64),     # a clear winner
    ({16: 0.90, 32: 1.00, 64: 0.96}, 16),
    ({32: 1.00, 64: 0.96, 128: 0.97}, 32),
    ({32: 1.00, 64: 0.952, 128: 0.96}, 64),
])
def test_tune_call_hysteresis_equals_jax(monkeypatch, times, want):
    make_call = _fake_tuning(monkeypatch, times)
    blocks, timings = AT.tune_call("fake", make_call)
    jblocks, jtimings = JAT.tune_call("fake", make_call)
    assert blocks == jblocks == {"block_batch": want}
    assert timings == jtimings
    assert set(timings) == {f"block_batch={b}" for b in times}


def _qa(B=48, K=3, Dk=8, C=5, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a) for a in (
        rng.standard_normal((K, B, Dk)).astype(np.float32),
        rng.standard_normal((K, Dk, C)).astype(np.float32),
        rng.standard_normal(C).astype(np.float32),
        np.ones(K, np.int32))]


def test_tuners_record_entries_wrappers_consult_them():
    p, w, b, m = _qa()
    table = AT.active_table()
    timings = AT.tune_quorum_aggregate(table, p, w, b, m, repeats=1)
    assert len(timings) == len(AT._configs("quorum_aggregate"))
    shape, dtype = AT.key_quorum_aggregate(p, w)
    blocks = table.get("quorum_aggregate", shape, dtype)
    assert blocks is not None and "block_batch" in blocks
    got = ops.quorum_aggregate(p, w, b, m)
    np.testing.assert_allclose(got, ops.quorum_aggregate_ref(p, w, b, m),
                               rtol=1e-5, atol=1e-5)
    explicit = ops.quorum_aggregate(p, w, b, m,
                                    block_batch=blocks["block_batch"])
    np.testing.assert_array_equal(got, explicit)


def test_all_three_tuners_fill_the_table():
    rng = np.random.default_rng(2)
    table = AT.TuningTable()
    p, w, b, m = _qa()
    AT.tune_quorum_aggregate(table, p, w, b, m, repeats=1)
    sh = torch.from_numpy(rng.standard_normal((9, 6, 16)).astype(np.float32))
    dec = torch.from_numpy(rng.standard_normal((9, 4, 6)).astype(np.float32))
    AT.tune_coded_decode(table, sh, dec, torch.ones((9, 6), dtype=torch.int32),
                         repeats=1)
    x = torch.from_numpy(rng.standard_normal((9, 16)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (16, 24)).astype(np.int8))
    AT.tune_dequant_matmul(table, x, q, torch.tensor(0.05), repeats=1)
    assert sorted(k.split("|")[0] for k in table.entries) == \
        ["coded_decode", "dequant_matmul", "quorum_aggregate"]
    for key, blocks in table.entries.items():
        grid = AT.CANDIDATES[key.split("|")[0]]
        assert all(v in grid[n] for n, v in blocks.items())


def test_table_entry_changes_resolution_not_result(monkeypatch):
    """A table entry is what the wrapper resolves (seen through a spy on
    ``autotune.resolve``), and the result stays the plain version's."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((33, 16)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (16, 24)).astype(np.int8))
    sc = torch.from_numpy(rng.uniform(0.01, 0.1, 24).astype(np.float32))
    want = ops.dequant_matmul_ref(x, q, sc)
    seen = []
    resolve = AT.resolve
    monkeypatch.setattr(AT, "resolve",
                        lambda *a, **k: seen.append(resolve(*a, **k))
                        or seen[-1])
    baseline = ops.dequant_matmul(x, q, sc)
    shape, dtype = AT.key_dequant_matmul(x, q)
    AT.active_table().put("dequant_matmul", shape, dtype,
                          {"block_batch": 16, "block_n": 32})
    tuned = ops.dequant_matmul(x, q, sc)
    assert seen == [AT.DEFAULTS["dequant_matmul"],
                    {"block_batch": 16, "block_n": 32}]
    np.testing.assert_array_equal(baseline, want)
    np.testing.assert_array_equal(tuned, want)


@pytest.mark.parametrize("C", [1, 10, 16, 17, 100])
def test_quorum_default_is_the_256_thread_launch(C):
    """With an empty table the merge's tiles route (the wide shapes)
    launches as before it took a tile: 256 threads a block, 16 rows of 16
    classes or 8 rows of 32. The rows route (the serving shapes) takes one
    output row a block, so a batch spreads over the SMs."""
    wide, narrow = (4, 64, 640, C), (4, 64, 16, C)
    bm = AT.resolve("quorum_aggregate", wide, torch.float32)["block_batch"]
    p = QA.merge_plan(4, 64, 640, C, bm)
    assert p.route == "tiles" and p.threads == 256
    assert p.lanes == (16 if C <= 16 else 32)
    bm = AT.resolve("quorum_aggregate", narrow, torch.float32)["block_batch"]
    p = QA.merge_plan(4, 64, 16, C, bm)
    assert (p.route, p.rows, p.grid[0]) == (
        ("rows", 1, 64) if C <= 32 else ("tiles", 16 if C <= 16 else 8,
                                         -(-64 // (16 if C <= 16 else 8))))
    for shape in (wide, narrow):
        configs = AT._configs("quorum_aggregate",
                              AT.defaults("quorum_aggregate", shape))
        assert configs[0] == AT.defaults("quorum_aggregate", shape)
        assert len(configs) == len(AT.CANDIDATES["quorum_aggregate"]
                                   ["block_batch"])


def test_tune_call_holds_a_given_default(monkeypatch):
    """The hysteresis protects the default it is given: a 2% faster
    challenger loses to it, the grid's own default included."""
    make_call = _fake_tuning(monkeypatch, {16: 0.98, 32: 1.00, 64: 1.00})
    blocks, _ = AT.tune_call("fake", make_call, default={"block_batch": 64})
    assert blocks == {"block_batch": 64}
    blocks, _ = AT.tune_call("fake", make_call)
    assert blocks == {"block_batch": 32}


@pytest.mark.parametrize("block_batch,C,want", [
    (16, 10, 16), (16, 100, 16), (64, 100, 32), (0, 10, 1), (-3, 100, 1),
    (4096, 10, 32)])
def test_quorum_rows_per_block_clamp(block_batch, C, want):
    """A table's ``block_batch`` is clamped to a legal launch: the rows
    route (C 10 here) serves 1 to 32 rows a block, the tiles route (C 100)
    1 to 1024 / 32 rows of 32 classes."""
    assert QA.merge_plan(8, 256, 32, C, block_batch).rows == want


@pytest.mark.parametrize("B,R,K,F,block_batch,vec,want", [
    (256, 6, 4, 64, 1, 4, (1, 1)),     # one row per block
    (256, 6, 4, 64, 2, 4, (2, 2)),     # the default: a warp, 16 threads a row
    (256, 6, 4, 64, 16, 1, (16, 4)),   # scalar route: 64 threads a row
    (256, 6, 4, 64, 16, 4, (16, 16)),
    (256, 6, 4, 200, 16, 1, (16, 2)),  # 128 threads a row, 256 in all
    (256, 6, 4, 64, 0, 4, (1, 1)),
    (7, 6, 4, 64, 2 ** 40, 1, (7, 4)),  # a stale entry larger than B
    (256, 64, 64, 16, 16, 4, (16, 16)),  # R and K take no shared memory
])
def test_coded_decode_block_rows_clamp(B, R, K, F, block_batch, vec, want):
    assert CD.block_rows(B, F, block_batch, vec) == want
