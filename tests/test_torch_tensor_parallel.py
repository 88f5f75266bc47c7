"""Tensor-parallel serving on a mesh's ``model`` axis
(``repro_torch.parallel.tensor``, ``launch.steps.mesh_step`` and
``launch.serve.greedy_decode`` with a mesh) against the JAX package's
single-device ``api.prefill`` / ``api.decode_step``, and the plain
``decode_attention``'s log-sum-exp.

Tiny fp32 configs (2 layers, d 128, 4 query heads over 2 kv heads; 1 for
granite-20b, the MQA), prompt 16 and 4 decode steps. The JAX package runs
in the test's own process; the ranks are spawned gloo processes
(``test_torch_mesh_train.run_ranks``, 60 s each) that import no JAX: this
module imports JAX only inside the functions that need it. The reference
is JAX's single-device step on the same carried weights, which GSPMD
promises its sharded step equals (the reference's own sharded step does
not execute under the installed JAX). Sharding changes the sums' order
only: logits agree within 2e-5 (the largest difference measured over
the four meshes is 3.1e-6).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch.compat import (AbstractMesh, DTensor,  # noqa: E402
                                abstract_mesh, init_device_mesh)
from repro_torch.configs.archs import tiny_version  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.serve import greedy_decode  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.parallel import tensor as TP  # noqa: E402

from test_torch_mesh_train import run_ranks  # noqa: E402

TOL = 2e-5
B, P, GEN = 2, 16, 5                 # prompt P, then GEN - 1 = 4 decode steps
CACHE_LEN = P + GEN - 1              # greedy_decode's cache: 20 splits 2, 4
ODD_LEN = P + GEN                    # 21 splits over no model axis
ZERO_LEN = 8                         # the index-0 step's cache


def _cfg(arch):
    return tiny_version(get_config(arch))


# -- the ranks (no JAX) ------------------------------------------------------

def _full(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).numpy().copy()


def _argmax_cases():
    """(logits (5, 512), the whole rows' argmax): ties across the two
    vocabulary shards, within one, at their boundary, a max in the second
    shard only, and a row of equal values."""
    x = torch.linspace(-1, 1, 5 * 512).reshape(5, 512).flip(1).contiguous()
    x = x * 0.5
    for row, cols in ((0, (10, 300)), (1, (300, 400)), (2, (511,)),
                      (4, (255, 256))):
        x[row, list(cols)] = 7.0
    x[3] = 1.0
    return x, x.argmax(-1)


def _embed_case(cfg):
    """A table with -0.0 entries and ids at the shards' edges."""
    g = torch.Generator().manual_seed(11)
    table = torch.randn((cfg.vocab, cfg.d_model), generator=g)
    table[::7, ::3] = -0.0
    table[1::5, 1::4] = 0.0
    ids = torch.randint(0, cfg.vocab, (3, 9), generator=g)
    ids[0, :4] = torch.tensor([0, 255, 256, cfg.vocab - 1])
    return table, ids


def _tp_worker(rank, world, arch, params, toks, jtoks, shape):
    """The mesh's greedy run (tokens), its prefill and teacher-forced
    serve steps' logits (gathered) over caches of CACHE_LEN and of
    ODD_LEN positions (replicated: the length splits over no model axis),
    the prefill cache's local blocks and whole, a serve step at index 0
    on a zero cache (int and tensor index), and, on a (1, 2) mesh, the
    embedding rows and sharded argmax cases."""
    cfg = _cfg(arch)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    dec = TP.shard_params(params, cfg, mesh, "decode")
    tokens = torch.from_numpy(toks)
    out = dict(greedy=greedy_decode(dec, cfg, tokens, GEN,
                                    mesh=mesh).tokens)
    for n in (CACHE_LEN, ODD_LEN):
        prefill = ST.mesh_step(cfg, ShapeConfig("p", P, B, "prefill"), mesh,
                               cache_len=n)
        serve = ST.mesh_step(cfg, ShapeConfig("d", n, B, "decode"), mesh)
        logits, cache = prefill(dec, {"tokens": tokens})
        out[n] = dict(blocks={k: tuple(v.to_local().shape)
                              for k, v in cache.items()},
                      cache={k: _full(v) for k, v in cache.items()},
                      logits=[_full(logits)])
        for t in range(GEN - 1):
            feed = {"tokens": torch.from_numpy(jtoks[:, t:t + 1])}
            logits, cache = serve(dec, cache, feed, P + t)
            out[n]["logits"].append(_full(logits))
    zero = ST.mesh_step(cfg, ShapeConfig("z", ZERO_LEN, B, "decode"), mesh)
    first = tokens[:, :1]
    out["zero"] = []
    for index in (0, torch.tensor(0, dtype=torch.int32)):
        c = ST.mesh_cache(api.init_cache(cfg, B // shape[0], ZERO_LEN,
                                         device="cpu"), mesh)
        logits, c = zero(dec, c, {"tokens": first}, index)
        out["zero"].append(_full(logits))
    out["zero_block"] = tuple(c["k"].to_local().shape)
    if shape == (1, 2):
        lay = TP.layout(cfg, mesh, ST.specs_of(ST.param_specs(
            cfg, mesh, kind="prefill")))
        table, ids = _embed_case(cfg)
        v0, v1 = lay.vocab
        out["rows"] = TP.embed_lookup(table[v0:v1], ids, lay).numpy()
        x, _ = _argmax_cases()
        out["argmax"] = TP.argmax(x[:, v0:v1], lay.group, lay.size,
                                  v0).numpy()
    return out


# -- the JAX reference and the one-process port ------------------------------

_CACHE = {}


def _reference(arch):
    """(port params, prompt, JAX tokens, JAX logits per step, JAX prefill
    cache padded to CACHE_LEN, JAX logits of the index-0 step)."""
    if arch in _CACHE:
        return _CACHE[arch]
    import jax
    import jax.numpy as jnp
    from repro.configs.archs import tiny_version as j_tiny
    from repro.configs.base import get_config as j_get_config
    from repro.models import api as japi
    from repro_torch.convert import lm_params_from_jax
    jcfg = j_tiny(j_get_config(arch))
    jparams = japi.init(jax.random.key(3), jcfg)
    params = lm_params_from_jax(jax.device_get(jparams))
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (B, P)
                                             ).astype(np.int32)
    prefill = jax.jit(lambda p, b: japi.prefill(p, jcfg, b))
    decode = jax.jit(lambda p, b, c, i: japi.decode_step(p, jcfg, b, c, i))
    logits, pcache = prefill(jparams, {"tokens": jnp.asarray(toks)})
    cache = jax.tree.map(
        lambda d, s: jnp.pad(s, [(0, a - b) for a, b in zip(d.shape,
                                                             s.shape)]),
        japi.init_cache(jcfg, B, CACHE_LEN), pcache)
    padded = {k: np.asarray(v) for k, v in cache.items()}
    cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out, steps = [np.asarray(cur)], [np.asarray(logits)]
    for t in range(GEN - 1):
        logits, cache = decode(jparams, {"tokens": cur}, cache,
                               jnp.int32(P + t))
        cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out.append(np.asarray(cur))
        steps.append(np.asarray(logits))
    zero, _ = decode(jparams, {"tokens": jnp.asarray(toks[:, :1])},
                     japi.init_cache(jcfg, B, ZERO_LEN), jnp.int32(0))
    _CACHE[arch] = (params, toks, np.concatenate(out, 1), steps, padded,
                    np.asarray(zero))
    return _CACHE[arch]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each (arch, mesh) case's rank results, run once for the module."""
    done = {}

    def get(arch, shape):
        if (arch, shape) not in done:
            params, toks, jtoks, *_ = _reference(arch)
            world = shape[0] * shape[1]
            done[(arch, shape)] = run_ranks(
                _tp_worker, world, tmp_path_factory.mktemp("tp"), arch,
                params, toks, jtoks, shape)
        return done[(arch, shape)]
    return get


CASES = [("llama3.2-1b", (1, 2)), ("granite-20b", (1, 2)),
         ("llama3.2-1b", (1, 4)), ("llama3.2-1b", (2, 2))]
IDS = ["llama-1x2", "granite-1x2", "llama-1x4", "llama-2x2"]


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)))


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_prefill_and_decode_logits_equal_jax_single_device(arch, shape, runs):
    """Every rank's gathered logits, the prefill's and each (teacher-
    forced) decode step's, within 2e-5 of the JAX package's single-device
    steps on the same weights, over a cache that splits over the model
    axis and over one that does not."""
    _, _, _, jsteps, _, _ = _reference(arch)
    for r in runs(arch, shape):
        for n in (CACHE_LEN, ODD_LEN):
            errs = [_err(a, b) for a, b in zip(r[n]["logits"], jsteps)]
            assert len(errs) == GEN and max(errs) <= TOL, (n, errs)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_greedy_tokens_equal_the_one_process_port(arch, shape, runs):
    params, toks, jtoks, *_ = _reference(arch)
    one = greedy_decode(params, _cfg(arch), torch.from_numpy(toks), GEN)
    np.testing.assert_array_equal(one.tokens, jtoks)
    for r in runs(arch, shape):
        np.testing.assert_array_equal(r["greedy"], one.tokens)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_prefill_cache_is_the_decode_layout(arch, shape, runs):
    """The prefill's cache is the serving cache of its ``cache_len``
    positions holding the prompt: whole, it equals JAX's prefill cache
    spliced into zeros; each rank holds its kv heads (llama at model 2)
    or its block of positions (granite at model 2, llama at model 4,
    whose 2 kv heads do not divide 4), as ``cache_specs`` of the decode
    shape place it, and all positions where their number (21) does not
    split over the axis."""
    cfg = _cfg(arch)
    _, _, _, _, padded, _ = _reference(arch)
    m = shape[1]
    kv_split = cfg.n_kv_heads % m == 0
    kv = cfg.n_kv_heads // m if kv_split else cfg.n_kv_heads
    lead = (cfg.n_layers, B // shape[0])
    for r in runs(arch, shape):
        split = CACHE_LEN if kv_split else CACHE_LEN // m
        for n, block in ((CACHE_LEN, split), (ODD_LEN, ODD_LEN)):
            for name in ("k", "v"):
                assert r[n]["blocks"][name] == (*lead, block, kv,
                                                cfg.head_dim)
                whole = r[n]["cache"][name]
                assert _err(whole[:, :, :CACHE_LEN], padded[name]) <= TOL
                assert not whole[:, :, CACHE_LEN:].any()


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_decode_at_index_0_with_empty_blocks(arch, shape, runs):
    """A serve step at index 0 on a zero cache of 8 positions: on a
    sequence-sharded cache every block but the first holds no valid
    position (lse −inf, weight 0). Finite, within 2e-5 of JAX's step, for
    an int index and an int32 tensor index alike."""
    _, _, _, _, _, jzero = _reference(arch)
    cfg, m = _cfg(arch), shape[1]
    seq = cfg.n_kv_heads % m != 0
    for r in runs(arch, shape):
        assert r["zero_block"][2:4] == (
            (ZERO_LEN // m, cfg.n_kv_heads) if seq
            else (ZERO_LEN, cfg.n_kv_heads // m))
        for got in r["zero"]:
            assert np.isfinite(got).all()
            assert _err(got, jzero) <= TOL


def test_embedding_rows_equal_the_whole_gather_bit_for_bit(runs):
    cfg = _cfg("llama3.2-1b")
    table, ids = _embed_case(cfg)
    want = F.embedding(ids, table).numpy()
    assert (np.signbit(want) & (want == 0)).any()          # -0.0 rows
    for r in runs("llama3.2-1b", (1, 2)):
        assert np.array_equal(r["rows"].view(np.int32), want.view(np.int32))


def test_argmax_ties_across_shards_take_the_lower_index(runs):
    _, want = _argmax_cases()
    assert want.tolist() == [10, 300, 511, 0, 255]
    for r in runs("llama3.2-1b", (1, 2)):
        assert r["argmax"].tolist() == want.tolist()


# -- the rank layout, in one process ------------------------------------------

class _Rank(AbstractMesh):
    """An abstract mesh seen from one rank: ``get_local_rank`` by axis."""

    def __init__(self, shape, names, coords):
        super().__init__(shape, names)
        self.coords = dict(zip(names, coords))

    def get_local_rank(self, axis):
        return self.coords[axis]

    def get_group(self, axis):
        return None                     # no process group: layouts only


def _params(cfg, seed=0):
    return api.init(torch.Generator().manual_seed(seed), cfg)


def test_shard_params_pairs_gate_and_up_columns():
    """``param_specs`` shards SwiGLU's ``wi`` = [gate | up] in contiguous
    halves: at model 2 rank 0's block is all of gate and rank 1's all of
    up, so its FFN would pair gate columns with gate columns, and the sum
    over the ranks is not the FFN. ``shard_params`` gives each rank
    gate_r ‖ up_r, and the ranks' partial FFNs sum to the whole one."""
    from repro_torch.models import layers as LY
    cfg = _cfg("llama3.2-1b")
    params = _params(cfg)
    wi = params["layers"]["ffn"]["wi"]["kernel"][0]          # (d, 2·ff)
    wo = params["layers"]["ffn"]["wo"]["kernel"][0]          # (ff, d)
    ff = cfg.d_ff
    spec = ST.specs_of(ST.param_specs(cfg, abstract_mesh(
        (1, 2), ("data", "model")), kind="decode"))
    assert spec["layers"]["ffn"]["wi"]["kernel"] == (None, None, "model")
    x = torch.randn((3, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))

    def ffn(w_in, w_out):
        gate, up = (x @ w_in).chunk(2, -1)
        return LY.swiglu(gate, up) @ w_out

    whole = ffn(wi, wo)
    cut, contiguous = 0, 0
    for r in range(2):
        mesh = _Rank((1, 2), ("data", "model"), (0, r))
        got = TP.shard_params(params, cfg, mesh, "decode")["layers"]["ffn"]
        cols = slice(r * ff // 2, (r + 1) * ff // 2)
        local = got["wi"]["kernel"][0]
        assert torch.equal(local, torch.cat([wi[:, :ff][:, cols],
                                             wi[:, ff:][:, cols]], -1))
        assert torch.equal(got["wo"]["kernel"][0], wo[cols])
        cut = cut + ffn(local, wo[cols])
        contiguous = contiguous + ffn(wi[:, r * ff:(r + 1) * ff], wo[cols])
    torch.testing.assert_close(cut, whole, rtol=1e-5, atol=1e-6)
    assert not torch.allclose(contiguous, whole, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("arch,m,kind,kv,seq", [
    ("llama3.2-1b", 2, "prefill", "heads", None),
    ("llama3.2-1b", 2, "decode", "heads", None),
    ("granite-20b", 2, "prefill", "input", None),
    ("granite-20b", 2, "decode", "whole", 10),
    ("llama3.2-1b", 4, "prefill", "input", None),
    ("llama3.2-1b", 4, "decode", "whole", 5)])
def test_layout_reads_each_placement_the_specs_give(arch, m, kind, kv, seq):
    """The layout follows the sanitized specs: kv heads on ``model``
    where they divide it, else ``wk``/``wv`` cut on their input dimension
    at prefill and whole at decode with the cache's positions in blocks
    (20 of them here); a cache length that does not divide ``model``
    leaves the cache whole (replicated)."""
    cfg = _cfg(arch)
    amesh = abstract_mesh((1, m), ("data", "model"))
    pspecs = ST.specs_of(ST.param_specs(cfg, amesh, kind=kind))
    for r in range(m):
        mesh = _Rank((1, m), ("data", "model"), (0, r))
        shape = ShapeConfig("s", 20, B, kind)
        cspec = ST.specs_of(ST.cache_specs(cfg, shape, amesh))["k"] \
            if kind == "decode" else None
        lay = TP.layout(cfg, mesh, pspecs, cspec, 20)
        n = cfg.n_heads // m
        assert lay.heads == (r * n, (r + 1) * n) and lay.split_heads
        assert lay.kv == kv and lay.split_ffn and lay.split_vocab
        assert lay.vocab == (r * cfg.vocab // m, (r + 1) * cfg.vocab // m)
        G = cfg.n_heads // cfg.n_kv_heads
        if kv == "heads":
            assert lay.kv_read == (0, cfg.n_kv_heads // m)
        else:
            assert lay.kv_read[0] == r * n // G
            assert lay.kv_read[1] - lay.kv_read[0] == max(1, n // G)
        if kv == "input":
            d = cfg.d_model // m
            assert lay.embed == (r * d, (r + 1) * d)
        assert lay.seq == (None if seq is None else (r * seq, (r + 1) * seq))
        if kind == "decode" and kv == "whole":
            odd = ST.specs_of(ST.cache_specs(cfg, ShapeConfig(
                "s", 21, B, kind), amesh))["k"]
            assert TP.layout(cfg, mesh, pspecs, odd, 21).seq is None


def test_prefill_takes_its_mqa_block_as_a_view_of_the_decode_layout():
    """A server holds the decode layout (an MQA's whole ``wk``/``wv``);
    the prefill step's ``fit`` cuts their input-dim block as a view, keeps
    the leaves already in their block, and refuses another layout."""
    cfg = _cfg("granite-20b")
    amesh = abstract_mesh((1, 2), ("data", "model"))
    params = _params(cfg)
    placed = ST.param_specs(cfg, amesh, kind="prefill")
    shapes, specs = ST.tensors_of(placed), ST.specs_of(placed)
    for r in range(2):
        mesh = _Rank((1, 2), ("data", "model"), (0, r))
        dec = TP.shard_params(params, cfg, mesh, "decode")
        wk = dec["layers"]["attn"]["wk"]
        assert wk.shape == params["layers"]["attn"]["wk"].shape
        got = TP.fit(dec, shapes, specs, cfg, mesh)
        d = cfg.d_model // 2
        blk = got["layers"]["attn"]["wk"]
        assert blk.shape[1] == d and blk.data_ptr() == wk[:, r * d].data_ptr()
        assert got["layers"]["attn"]["wq"] is dec["layers"]["attn"]["wq"]
        pre = TP.shard_params(params, cfg, mesh, "prefill")
        assert torch.equal(pre["layers"]["attn"]["wk"], blk)
        bad = dict(dec, embed={"embedding": dec["embed"]["embedding"][:3]})
        with pytest.raises(ValueError, match="embedding"):
            TP.fit(bad, shapes, specs, cfg, mesh)


@pytest.mark.parametrize("arch,kind", [
    ("mamba2-130m", "train"), ("jamba-v0.1-52b", "train"),
    ("qwen2-vl-7b", "train"), ("whisper-medium", "train")])
def test_what_model_above_1_does_not_execute_raises(arch, kind):
    """Training at ``model`` > 1 raises ``NotImplementedError`` naming the
    dry run that models it, for every family but the dense and MoE ones
    (each family's prefill and decode serve: this file,
    ``test_torch_moe_tensor_parallel.py``,
    ``test_torch_ssm_tensor_parallel.py`` and
    ``test_torch_vlm_encdec_tensor_parallel.py``; the dense family trains:
    ``test_torch_tensor_parallel_train.py``, the MoE family:
    ``test_torch_moe_tensor_parallel_train.py``)."""
    with pytest.raises(NotImplementedError, match="dryrun"):
        ST.mesh_step(_cfg(arch), ShapeConfig("s", 16, 2, kind),
                     abstract_mesh((1, 2), ("data", "model")))


# -- decode_attention's log-sum-exp (the plain version) ----------------------

def _old_ref(q, k, v, length):
    """The plain version before it returned a log-sum-exp."""
    S, D = k.shape[2], q.shape[-1]
    s = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) * (
        1.0 / math.sqrt(D))
    mask = torch.arange(S) < length
    p = torch.softmax(torch.where(mask, s, DA.NEG_INF), dim=-1)
    return torch.einsum("bhgs,bhsd->bhgd", p, v.float()).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("length", [0, 1, 37, 64])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
def test_plain_decode_lse_against_fp64(dtype, length, as_tensor):
    """(o, lse) against fp64 at lengths 0, 1, 37 and the full 64: o = 0
    and lse = −inf over no position; o without ``return_lse`` is the
    same tensor, and bit-equal to the plain version before the lse at
    every length above 0."""
    g = torch.Generator().manual_seed(length)
    q, k, v = (torch.randn(s, generator=g).to(dtype) for s in
               ((2, 2, 3, 32), (2, 2, 64, 32), (2, 2, 64, 32)))
    n = torch.tensor([length], dtype=torch.int32) if as_tensor else length
    o, lse = DA.decode_attention(q, k, v, n, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, 3)
    alone = DA.decode_attention(q, k, v, n)
    assert torch.equal(alone, o)
    if length == 0:
        assert torch.equal(o, torch.zeros_like(o))
        assert torch.isneginf(lse).all()
        return
    assert torch.equal(alone, _old_ref(q, k, v, length))
    s = torch.einsum("bhgd,bhsd->bhgs", q.double(),
                     k.double())[..., :length] / math.sqrt(32)
    want = torch.logsumexp(s, -1)
    o64 = torch.einsum("bhgs,bhsd->bhgd", torch.softmax(s, -1),
                       v.double()[:, :, :length])
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert float((lse.double() - want).abs().max()) <= 1e-5
    assert float((o.double() - o64).abs().max()) <= tol


def test_block_merge_by_lse_equals_the_whole_cache():
    """Cutting a cache into blocks, attending over each and merging by
    the blocks' lse (the formula of ``tensor.merge_blocks``) gives the
    whole cache's attention; blocks past the length weigh 0, with no NaN."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn((2, 1, 4, 32), generator=g)
    k, v = (torch.randn((2, 1, 24, 32), generator=g) for _ in range(2))
    for length in (1, 5, 13, 24):
        want = DA.decode_attention(q, k, v, length)
        outs = [DA.decode_attention(q, k[:, :, s:s + 6], v[:, :, s:s + 6],
                                    max(0, min(length - s, 6)),
                                    return_lse=True) for s in range(0, 24, 6)]
        lse = torch.stack([b for _, b in outs])
        w = torch.exp(lse - lse.max(0).values)[..., None]
        got = (torch.stack([a for a, _ in outs]) * w).sum(0) / w.sum(0)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
