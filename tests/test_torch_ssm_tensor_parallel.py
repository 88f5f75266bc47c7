"""Tensor-parallel SSM and hybrid serving on a mesh's ``model`` axis (a
mamba mixer under a ``parallel.tensor`` layout's :class:`SSM`, through
``launch.steps.mesh_step`` and ``greedy_decode`` with a mesh) against the
JAX package's single-device ``api.prefill`` / ``api.decode_step``.

Tiny fp32 configs, prompt 16 and 4 decode steps:

- ``mamba``: tiny mamba2-130m (2 layers, d 128, 8 SSM heads of P 32, N
  16): the heads split at ``model`` 2 and 4;
- ``jamba``: tiny jamba-v0.1-52b (one 8-layer period: attention with 4
  query heads over 2 kv heads at sub-layer 4, 4 experts at the odd
  sub-layers, 8 SSM heads): the heads split, beside the attention's kv
  heads at ``model`` 2 and its MQA fallbacks at 4;
- ``headdim``: d 96, SSM head dim 64, so 3 heads, which no axis divides:
  each head's channels split (``head_dim_shard``); its ``in_proj`` (419
  columns) splits over no axis, so a rank holds it whole and takes its
  channels from the product;
- ``whole``: d 36, expand 1, head dim 18 (2 heads of 18): the heads
  split at ``model`` 2, and at 4 neither divides, so the mixer runs
  whole on every rank.

The ranks are spawned gloo processes (``test_torch_mesh_train.run_ranks``),
one set per mesh for every config, that import no JAX; this module imports
JAX only inside the functions that need it. Sharding changes the sums'
order only: logits within rtol/atol 1e-4 of the single-device steps (the
bound of the one-process SSM parity, ``tests/test_torch_lm_serving.py``;
~1e-5 measured).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compat import DTensor, abstract_mesh, local  # noqa: E402
from repro_torch.compat import init_device_mesh  # noqa: E402
from repro_torch.configs.archs import tiny_version  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.serve import greedy_decode, splice  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.parallel import tensor as TP  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

from test_torch_mesh_train import run_ranks  # noqa: E402
from test_torch_tensor_parallel import _Rank  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_torch_lm_serving.py's
B, P, GEN = 2, 16, 5                 # prompt P, then GEN - 1 = 4 decode steps
CACHE_LEN = P + GEN - 1              # 20: splits over 2 and 4
NAMES = ("data", "model")
RANK_TIMEOUT = 240.0                 # four ranks on one core, every config

CONFIGS = {"mamba": ("mamba2-130m", {}),
           "jamba": ("jamba-v0.1-52b", {}),
           "headdim": ("mamba2-130m", dict(d_model=96, ssm_head_dim=64)),
           "whole": ("mamba2-130m", dict(d_model=36, ssm_expand=1,
                                         ssm_head_dim=18))}
MESHES = [(1, 2), (1, 4), (2, 2)]
CASES = [(c, m) for c in CONFIGS for m in MESHES]
IDS = [f"{c}-{a}x{b}" for c, (a, b) in CASES]


def _cfg(name):
    arch, kw = CONFIGS[name]
    return tiny_version(get_config(arch)).with_(**kw)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **TOL,
                               err_msg=what)


# -- the ranks (no JAX) ------------------------------------------------------

def _full(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).numpy().copy()


def _counting(mesh, calls: list):
    """Wraps ``TP.all_reduce``/``TP.all_gather`` to record (collective,
    axis, shape, dtype) in ``calls``. Returns the undo."""
    saved = {k: getattr(TP, k) for k in ("all_reduce", "all_gather")}
    model = mesh.get_group("model")

    def wrap(name, fn):
        def call(t, group, *args, **kw):
            calls.append((name, "model" if group is model else "other",
                          tuple(t.shape), str(t.dtype)))
            return fn(t, group, *args, **kw)
        return call
    for k, fn in saved.items():
        setattr(TP, k, wrap(k, fn))

    def undo():
        for k, fn in saved.items():
            setattr(TP, k, fn)
    return undo


def _mixer(tree):
    """Layer 0's (a hybrid's sub-layer 0's) mamba mixer and its decode
    cache leaves' index."""
    if "layers" in tree:
        return tree_map(lambda t: t[0], tree["layers"]["mixer"]), (0,)
    return tree_map(lambda t: t[0], tree["periods"]["sub0"]["mixer"]), (0, 0)


def _ssm_worker(rank, world, shape, cases):
    """:func:`_ssm_case` of each config on this rank of a ``shape`` mesh."""
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=NAMES)
    return {case[0]: _ssm_case(mesh, shape, *case) for case in cases}


def _ssm_case(mesh, shape, name, params, toks, jtoks, x):
    """The mesh's greedy run (tokens); its prefill's logits and cache
    (each leaf's local block, whether it is a DTensor, and the whole where
    it is one) and its teacher-forced serve steps' logits (gathered); the
    collectives of layer 0's mixer in a prefill of ``x`` (this rank's data
    rows) and a decode step from its cache; the rank's :class:`SSM`."""
    cfg = _cfg(name)
    dec = TP.shard_params(params, cfg, mesh, "decode")
    tokens = torch.from_numpy(toks)
    out = dict(greedy=greedy_decode(dec, cfg, tokens, GEN,
                                    mesh=mesh).tokens)
    prefill = ST.mesh_step(cfg, ShapeConfig("p", P, B, "prefill"), mesh,
                           cache_len=CACHE_LEN)
    serve = ST.mesh_step(cfg, ShapeConfig("d", CACHE_LEN, B, "decode"),
                         mesh)
    logits, cache = prefill(dec, {"tokens": tokens})
    out["blocks"] = {k: (isinstance(v, DTensor), local(v).numpy().copy())
                     for k, v in cache.items()}
    out["whole"] = {k: _full(v) for k, v in cache.items()
                    if isinstance(v, DTensor)}
    out["logits"] = [_full(logits)]
    for t in range(GEN - 1):
        feed = {"tokens": torch.from_numpy(jtoks[:, t:t + 1])}
        logits, cache = serve(dec, cache, feed, P + t)
        out["logits"].append(_full(logits))
    lay = TP.layout(cfg, mesh, ST.specs_of(ST.param_specs(
        cfg, mesh, kind="decode")))
    out["ssm"] = lay.ssm
    mixer, at = _mixer(dec)
    rows = B // shape[0]
    r0 = mesh.get_local_rank("data") * rows
    part = torch.from_numpy(x[r0:r0 + rows])
    calls = {}
    for kind in ("prefill", "decode"):
        got: list = []
        undo = _counting(mesh, got)
        try:
            with TP.installed(lay), torch.no_grad():
                if kind == "prefill":
                    _, h, conv = S.mamba_apply(mixer, cfg, part,
                                               return_state=True)
                else:
                    S.mamba_decode(mixer, cfg, part[:, :1], conv, h)
        finally:
            undo()
        calls[kind] = got
    out["calls"] = calls
    return out


# -- the JAX reference and the one-process port ------------------------------

_CACHE = {}


def _reference(name):
    """(port params, prompt, JAX tokens, JAX logits per step, the
    one-process port's prefill cache spliced into a CACHE_LEN cache, a
    mixer input (B, P, d))."""
    if name in _CACHE:
        return _CACHE[name]
    import jax
    import jax.numpy as jnp
    from repro.configs.archs import tiny_version as j_tiny
    from repro.configs.base import get_config as j_get_config
    from repro.models import api as japi
    from repro_torch.convert import lm_params_from_jax
    arch, kw = CONFIGS[name]
    jcfg = j_tiny(j_get_config(arch)).with_(**kw)
    jparams = japi.init(jax.random.key(3), jcfg)
    params = lm_params_from_jax(jax.device_get(jparams))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab, (B, P)).astype(np.int32)
    prefill = jax.jit(lambda p, b: japi.prefill(p, jcfg, b))
    decode = jax.jit(lambda p, b, c, i: japi.decode_step(p, jcfg, b, c, i))
    logits, pcache = prefill(jparams, {"tokens": jnp.asarray(toks)})
    cache = jax.tree.map(
        lambda d, s: jnp.pad(s, [(0, a - b) for a, b in zip(d.shape,
                                                             s.shape)]),
        japi.init_cache(jcfg, B, CACHE_LEN), pcache)
    cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out, steps = [np.asarray(cur)], [np.asarray(logits)]
    for t in range(GEN - 1):
        logits, cache = decode(jparams, {"tokens": cur}, cache,
                               jnp.int32(P + t))
        cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out.append(np.asarray(cur))
        steps.append(np.asarray(logits))
    cfg = _cfg(name)
    _, one = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)})
    spliced = api.init_cache(cfg, B, CACHE_LEN, device="cpu")
    for k, c in spliced.items():
        splice(c, one[k])
    x = rng.standard_normal((B, P, jcfg.d_model)).astype(np.float32)
    _CACHE[name] = (params, toks, np.concatenate(out, 1), steps,
                    {k: v.numpy() for k, v in spliced.items()}, x)
    return _CACHE[name]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each (config, mesh) case's rank results: one set of ranks per mesh
    runs every config (a rank's start, ~6 s of one core, is most of its
    cost), once for the module."""
    done = {}

    def get(name, shape):
        if shape not in done:
            cases = []
            for c in CONFIGS:
                params, toks, jtoks, _, _, x = _reference(c)
                cases.append((c, params, toks, jtoks, x))
            done[shape] = run_ranks(
                _ssm_worker, shape[0] * shape[1],
                tmp_path_factory.mktemp("ssm"), shape, cases,
                timeout=RANK_TIMEOUT)
        return [r[name] for r in done[shape]]
    return get


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_prefill_and_decode_logits_equal_jax_single_device(name, shape,
                                                            runs):
    """Every rank's gathered logits, the prefill's and each (teacher-
    forced) decode step's, within rtol/atol 1e-4 of the JAX package's
    single-device steps on the same weights."""
    _, _, _, jsteps, _, _ = _reference(name)
    for r in runs(name, shape):
        assert len(r["logits"]) == GEN
        for t, (got, want) in enumerate(zip(r["logits"], jsteps)):
            _close(got, want, f"step {t}")


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_greedy_tokens_equal_the_one_process_port(name, shape, runs):
    params, toks, jtoks, *_ = _reference(name)
    one = greedy_decode(params, _cfg(name), torch.from_numpy(toks), GEN)
    np.testing.assert_array_equal(one.tokens, jtoks)
    for r in runs(name, shape):
        np.testing.assert_array_equal(r["greedy"], one.tokens)


def _conv_whole(ranks, shape, cfg):
    """The whole conv window (…, B, k − 1, conv_ch) from the ranks'
    blocks: each rank's [x_r | B | C] at its :class:`SSM`'s columns, its
    data rows; B and C held alike by the ranks of one data shard."""
    first = ranks[0]["blocks"]["conv"][1]
    d_in = cfg.d_inner
    lead = first.shape[:-3]
    rows = first.shape[-3]
    whole = np.full((*lead, rows * shape[0], *first.shape[-2:-1],
                     d_in + 2 * cfg.ssm_state), np.nan, np.float32)
    for i, r in enumerate(ranks):
        d = i // shape[1]
        blk = r["blocks"]["conv"][1]
        cols = r["ssm"].conv_cols().numpy()
        sl = (..., slice(d * rows, (d + 1) * rows), slice(None),
              slice(None))
        mine = whole[sl]
        seen = ~np.isnan(mine[..., cols])
        assert np.array_equal(mine[..., cols][seen], blk[seen])
        mine[..., cols] = blk
        whole[sl] = mine
    assert not np.isnan(whole).any()
    return whole


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_prefill_cache_reassembles_to_the_one_process_cache(name, shape,
                                                            runs):
    """The prefill's serving cache, reassembled from the ranks' blocks,
    equals the one-process port's prefill cache spliced into CACHE_LEN
    positions within 1e-4: the SSM ``state`` (a DTensor of the rank's
    heads or head channels) and the ``conv`` window, a plain tensor of the
    rank's [x_r | B | C] where the mixer is split (no DTensor placement
    describes it), a DTensor replicated on ``model`` where it is whole;
    the hybrid's ``k``/``v`` too (DTensors)."""
    cfg = _cfg(name)
    _, _, _, _, spliced, _ = _reference(name)
    ranks = runs(name, shape)
    for r in ranks:
        split = r["ssm"].split
        assert r["blocks"]["conv"][0] == (not split)
        assert r["blocks"]["state"][0]
        assert sorted(r["blocks"]) == sorted(spliced)
        blk = r["blocks"]["conv"][1]
        assert blk.shape[-1] == len(r["ssm"].conv_cols())
        assert blk.shape[-1] < cfg.d_inner + 2 * cfg.ssm_state or not split
        for k in ("state", "k", "v"):
            if k in spliced:
                _close(r["whole"][k], spliced[k], k)
        if not split:
            _close(r["whole"]["conv"], spliced["conv"], "conv")
    _close(_conv_whole(ranks, shape, cfg), spliced["conv"], "conv")


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_gated_norm_and_out_proj_are_the_mixers_collectives(name, shape,
                                                            runs):
    """A split mixer calls two collectives, both sums over ``model``: the
    gated norm's fp32 sums of squares (B_r, S, 1) and ``out_proj``'s
    partial products (B_r, S, d), in a prefill and a decode step alike; a
    whole mixer calls none."""
    cfg = _cfg(name)
    rows = B // shape[0]
    for r in runs(name, shape):
        for kind, S_ in (("prefill", P), ("decode", 1)):
            want = [("all_reduce", "model", (rows, S_, 1), "torch.float32"),
                    ("all_reduce", "model", (rows, S_, cfg.d_model),
                     "torch.float32")] if r["ssm"].split else []
            assert r["calls"][kind] == want, kind


# -- bf16: the reference's own distance from fp32 ----------------------------

BF16_DEPTHS = (4, 24)                # a cut mamba2, and its published depth
BF16_ROW_TOL = 3e-2                  # chip_smoke's bf16 bound, row-relative


def _row_rel(a, b) -> float:
    """The largest |a − b| of a row over that row's largest |b|, the
    largest over the rows."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b).max(-1) / np.abs(b).max(-1)).max())


def _bf16_runs(depth):
    """Tiny mamba2 at ``depth`` layers with bf16 weights (JAX's init,
    converted): the JAX package's and the one-process port's logits, the
    prefill's last position then GEN - 1 decode steps teacher-forced with
    the port's bf16 tokens, in bf16 and on the same weights upcast to
    fp32. Returns {(impl, dtype): (GEN, B, V)}."""
    import jax
    import jax.numpy as jnp
    from repro.configs.archs import tiny_version as j_tiny
    from repro.configs.base import get_config as j_get_config
    from repro.models import api as japi
    from repro_torch.convert import lm_params_from_jax
    kw = dict(n_layers=depth, ssm_chunk=P)
    jcfg = {jnp.bfloat16: j_tiny(j_get_config("mamba2-130m")).with_(
        param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16, **kw)}
    jcfg[jnp.float32] = jcfg[jnp.bfloat16].with_(param_dtype=jnp.float32,
                                                 compute_dtype=jnp.float32)
    jp = {jnp.bfloat16: japi.init(jax.random.key(3), jcfg[jnp.bfloat16])}
    jp[jnp.float32] = jax.tree.map(lambda t: t.astype(jnp.float32),
                                   jp[jnp.bfloat16])
    cfg = {torch.bfloat16: tiny_version(get_config("mamba2-130m")).with_(
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, **kw)}
    cfg[torch.float32] = cfg[torch.bfloat16].with_(
        param_dtype=torch.float32, compute_dtype=torch.float32)
    params = {torch.bfloat16: lm_params_from_jax(jax.device_get(
        jp[jnp.bfloat16]))}
    params[torch.float32] = tree_map(lambda t: t.float(),
                                     params[torch.bfloat16])
    toks = np.random.default_rng(7).integers(0, jcfg[jnp.float32].vocab,
                                             (B, P)).astype(np.int32)
    tokens = torch.from_numpy(toks)
    forced = greedy_decode(params[torch.bfloat16], cfg[torch.bfloat16],
                           tokens, GEN).tokens
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        res = greedy_decode(params[dt], cfg[dt], tokens, GEN,
                            keep_logits=True, forced=torch.from_numpy(forced))
        out["port", dt] = np.stack([l.float().numpy().reshape(B, -1)
                                    for l in res.logits])
    for jdt, dt in ((jnp.bfloat16, torch.bfloat16),
                    (jnp.float32, torch.float32)):
        c = jcfg[jdt]
        prefill = jax.jit(lambda p, b: japi.prefill(p, c, b))
        decode = jax.jit(lambda p, b, cc, i: japi.decode_step(p, c, b, cc,
                                                              i))
        logits, pc = prefill(jp[jdt], {"tokens": jnp.asarray(toks)})
        cache = jax.tree.map(lambda d, s: jnp.pad(s, [
            (0, a - b) for a, b in zip(d.shape, s.shape)]),
            japi.init_cache(c, B, CACHE_LEN), pc)
        steps = [logits[:, -1]]
        for t in range(GEN - 1):
            logits, cache = decode(jp[jdt], {"tokens": jnp.asarray(
                forced[:, t:t + 1])}, cache, jnp.int32(P + t))
            steps.append(logits[:, -1])
        out["jax", dt] = np.stack([np.asarray(x.astype(jnp.float32))
                                   for x in steps])
    return out


@pytest.mark.parametrize("depth", BF16_DEPTHS)
def test_bf16_lies_from_fp32_as_far_as_the_references_own(depth):
    """The JAX package's bf16 logits and the port's, each against its own
    fp32 run of the same bf16 weights (row-relative, as ``chip_smoke``'s
    bf16 bound): the port's bf16 lies no further than 1.5 times the
    reference's (a rounding the reference does not make, a norm's sums in
    bf16 say, would show here). The fp32 runs agree within 1e-4. At
    mamba2's published depth of 24 random layers the reference's own bf16
    lies further than 3e-2 from fp32 (each layer adds its rounding to the
    residual's), so two correct bf16 runs that round in another order, a
    split over ranks and one process, need not agree within 3e-2 there:
    ``chip_smoke`` holds the split to 3e-2 at a cut depth."""
    out = _bf16_runs(depth)
    f32 = torch.float32
    _close(out["port", f32], out["jax", f32], "fp32 logits")
    ref = _row_rel(out["jax", torch.bfloat16], out["jax", f32])
    port = _row_rel(out["port", torch.bfloat16], out["port", f32])
    both = _row_rel(out["port", torch.bfloat16], out["jax", torch.bfloat16])
    print(f"depth {depth}: bf16 vs fp32, row-relative: JAX {ref:.4e}, the "
          f"port {port:.4e}; the two bf16 runs {both:.4e}")
    assert port <= 1.5 * ref
    if depth == 24:
        assert ref > BF16_ROW_TOL


# -- the rank layout, in one process ------------------------------------------

def _params(cfg, seed=0):
    return api.init(torch.Generator().manual_seed(seed), cfg)


def _layer0(tree):
    return _mixer(tree)[0]


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_ssm_blocks_follow_the_state_spec(name, shape):
    """Each rank's :class:`SSM` and mixer blocks as the decode state's
    spec places them: its heads where they divide the axis, else every
    head's block of channels where P divides it, else the whole mixer.
    ``in_proj`` holds [z_r | x_r | B | C | dt_r] (B and C whole on every
    rank), or is whole where its spec is; the conv [x_r | B | C];
    ``out_proj``'s rows, ``out_norm``'s scale, ``A_log``, ``D`` and
    ``dt_bias`` the rank's channels and heads; the ranks' channels
    partition d_inner."""
    cfg = _cfg(name)
    params = _params(cfg)
    whole = _layer0(params)
    amesh = abstract_mesh(shape, NAMES)
    H, Pd, N, m = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, shape[1]
    spec, nd = TP.state_spec(H, Pd, N, amesh)
    d_in = H * Pd
    mode = "heads" if H % m == 0 else "headdim" if Pd % m == 0 else "whole"
    at = [spec[i] if i < len(spec) else None for i in range(nd)]
    assert (at[nd - 3], at[nd - 2]) == {
        "heads": ("model", None), "headdim": (None, "model"),
        "whole": (None, None)}[mode]
    in_split = (2 * d_in + 2 * N + H) % m == 0
    seen = []
    for r in range(m):
        mesh = _Rank(shape, NAMES, (0, r))
        ssm = TP.layout(cfg, mesh, ST.specs_of(ST.param_specs(
            cfg, amesh, kind="decode"))).ssm
        if mode == "heads":
            assert ssm.heads == (r * H // m, (r + 1) * H // m)
            assert ssm.head_dim == (0, Pd)
        elif mode == "headdim":
            assert ssm.heads == (0, H)
            assert ssm.head_dim == (r * Pd // m, (r + 1) * Pd // m)
        else:
            assert ssm == TP.SSM((0, H), (0, Pd), H, Pd, N)
        assert ssm.split == (mode != "whole")
        ch = ssm.channels()
        seen.append(ch)
        h0, h1 = ssm.heads
        got = _layer0(TP.shard_params(params, cfg, mesh, "decode"))
        w = whole["in_proj"]["kernel"]
        if in_split or not ssm.split:
            z, x, bc, dt = got["in_proj"]["kernel"].split(
                [len(ch), len(ch), 2 * N, h1 - h0], -1)
            assert torch.equal(z, w[:, ch])
            assert torch.equal(x, w[:, d_in + ch])
            assert torch.equal(bc, w[:, 2 * d_in:2 * d_in + 2 * N])
            assert torch.equal(dt, w[:, 2 * d_in + 2 * N + h0:
                                     2 * d_in + 2 * N + h1])
        else:
            assert torch.equal(got["in_proj"]["kernel"], w)
        conv = torch.cat([ch, torch.arange(d_in, d_in + 2 * N)])
        assert torch.equal(got["conv_w"], whole["conv_w"][:, conv])
        assert torch.equal(got["conv_b"], whole["conv_b"][conv])
        assert torch.equal(got["out_proj"]["kernel"],
                           whole["out_proj"]["kernel"][ch])
        assert torch.equal(got["out_norm"]["scale"],
                           whole["out_norm"]["scale"][ch])
        for k in ("A_log", "D", "dt_bias"):
            assert torch.equal(got[k], whole[k][h0:h1])
    assert sorted(torch.cat(seen).tolist()) == (
        list(range(d_in)) if mode != "whole" else sorted(list(range(d_in))
                                                        * m))


def test_whole_in_proj_gives_the_blocks_columns_from_the_product():
    """Where ``in_proj``'s spec splits over no axis (the head-dim config's
    419 columns), a rank holds it whole: z_r, [x_r | B | C] and dt_r taken
    from the whole product equal the product of its columns."""
    cfg = _cfg("headdim")
    whole = _layer0(_params(cfg))["in_proj"]["kernel"]
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    for r in range(2):
        mesh = _Rank((1, 2), NAMES, (0, r))
        ssm = TP.ssm_of(cfg, mesh)
        assert ssm.split and ssm.head_dim == (32 * r, 32 * (r + 1))
        from_whole = S._split_proj(cfg, x @ whole, ssm)
        from_cols = S._split_proj(cfg, x @ whole[:, ssm.in_cols()], ssm)
        for a, b in zip(from_whole, from_cols):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fit_keeps_blocks_and_cuts_whole_params(name):
    """``fit`` keeps ``shard_params``' blocks as they are and cuts whole
    params to the same values (the mixer's channels are a copy); a serve
    step's whole ``conv`` cache is refused where its block would be a copy
    its in-place writes miss, and taken as a view where it is whole."""
    cfg = _cfg(name)
    params = _params(cfg)
    amesh = abstract_mesh((1, 4), NAMES)
    placed = ST.param_specs(cfg, amesh, kind="prefill")
    shapes, specs = ST.tensors_of(placed), ST.specs_of(placed)
    cplaced = ST.cache_specs(cfg, ShapeConfig("d", CACHE_LEN, B, "decode"),
                             amesh)
    cshapes, cspecs = ST.tensors_of(cplaced), ST.specs_of(cplaced)
    cspecs["conv"] = ST._conv_spec(cspecs["state"], cshapes["state"].dim(),
                                   cshapes["conv"].dim())
    cache = api.init_cache(cfg, B, CACHE_LEN, device="cpu")
    for r in range(4):
        mesh = _Rank((1, 4), NAMES, (0, r))
        dec = TP.shard_params(params, cfg, mesh, "decode")
        kept = TP.fit(dec, shapes, specs, cfg, mesh)
        cut = TP.fit(params, shapes, specs, cfg, mesh)
        for a, b in zip(torch.utils._pytree.tree_leaves(_layer0(kept)),
                        torch.utils._pytree.tree_leaves(_layer0(dec))):
            assert a.data_ptr() == b.data_ptr() and a.shape == b.shape
        for a, b in zip(torch.utils._pytree.tree_leaves(cut),
                        torch.utils._pytree.tree_leaves(kept)):
            assert torch.equal(a, b)
        if TP.ssm_of(cfg, mesh).split:
            with pytest.raises(ValueError, match="mesh_cache"):
                TP.fit(cache, cshapes, cspecs, cfg, mesh, in_place=True)
        else:
            got = TP.fit(cache, cshapes, cspecs, cfg, mesh, in_place=True)
            assert got["conv"] is cache["conv"]


def test_cache_specs_give_conv_the_kv_rule_which_the_serving_cache_skips():
    """The reference's ``cache_specs`` tests ``name.endswith(("k", "v",
    ...))`` before its ``conv`` rule, and "conv" ends in "v": the port's
    copy places the window (L, B, k − 1, CH) by the KV rule, its layers on
    ``data`` and its batch on ``model``. The serving cache lays it out by
    ``_conv_spec`` instead: its batch rows as the state's, its channels
    the rank's SSM ones."""
    cfg = _cfg("mamba")
    amesh = abstract_mesh((2, 2), NAMES)
    placed = ST.cache_specs(cfg, ShapeConfig("d", CACHE_LEN, 4, "decode"),
                            amesh)
    assert tuple(placed["conv"].spec) == ("data", "model")
    assert tuple(placed["state"].spec) == (None, "data", "model")
    conv = ST._conv_spec(placed["state"].spec, placed["state"].tensor.dim(),
                         placed["conv"].tensor.dim())
    assert tuple(conv) == (None, "data")


@pytest.mark.parametrize("name", ["mamba", "jamba"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_ssm_and_hybrid_steps_run_at_model_above_1(name, kind):
    """``mesh_plan`` lets the SSM's and the hybrid's prefill and decode
    through at ``model`` > 1."""
    plan = ST.mesh_plan(_cfg(name), _Rank((1, 2), NAMES, (0, 1)),
                        zero1=False, kind=kind)
    assert (plan.index, plan.count, plan.groups) == (0, 1, ())
