"""Tensor-parallel serving of the VLM and the enc-dec on a mesh's ``model``
axis (``launch.steps.mesh_step``, ``launch.serve.greedy_decode`` with a
mesh, ``parallel.tensor``) against the JAX package's single-device
``api.prefill`` / ``api.decode_step``.

Three tiny fp32 models, weights drawn by the JAX package and carried by
``lm_params_from_jax``:

- ``vlm``: qwen2-vl-7b's tiny config, 4 heads padded to 32 over 2 kv
  heads (G 16): at ``model`` 4 every rank past the first holds only
  inert heads;
- ``padded``: a VLM whose padding is shaped like the published one
  (28 heads padded to 32 over 4 kv heads), 7 heads padded to 8 over 2 kv
  heads, d 112, M-RoPE sections (2, 3, 3), built by ``with_`` in both
  packages: the last rank's block holds the inert head beside real ones;
- ``encdec``: whisper-medium's tiny config (2 encoder and 2 decoder
  layers, 4 heads over 2 kv heads, LayerNorm, GELU with biases): at
  ``model`` 4 its 2 kv heads divide no axis, so the prefill takes
  ``wk``/``wv`` cut on their input dimension and the decode step's self
  and cross caches are sequence-sharded, merged by log-sum-exp.

The VLM's prompt is 16 patch embeddings with three distinct M-RoPE
streams; the enc-dec reads 20 encoder frames beside a 12-token decoder
prompt (22 frames in a run whose cross cache splits over no ``model``
axis of 4). Meshes (1, 2), (1, 4) and (2, 2): one spawn of ranks per
mesh carries every model (``test_torch_mesh_train.run_ranks``; the
ranks import no JAX, and this module imports it only inside the
functions that need it). Prefill and teacher-forced decode logits within
2e-5 of JAX's single-device steps; the enc-dec against JAX's decode step
given a cross cache of exactly the encoder's rows, as
``tests/test_torch_encdec.py`` does (the reference's own ``generate``
zero-pads that cache to the decode length and attends to the padding).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compat import (AbstractMesh, DTensor,  # noqa: E402
                                abstract_mesh, init_device_mesh)
from repro_torch.configs.archs import tiny_version  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.serve import greedy_decode, splice  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.parallel import tensor as TP  # noqa: E402
from repro_torch.parallel.sharding import PartitionSpec  # noqa: E402

from test_torch_mesh_train import run_ranks  # noqa: E402

TOL = 2e-5
B, P, GEN = 2, 16, 5               # the VLM's prompt P, GEN - 1 decode steps
S_ENC, S_DEC, ODD_ENC = 20, 12, 22  # the enc-dec's frames and decoder prompt
MODELS = ("vlm", "padded", "encdec")
MESHES = ((1, 2), (1, 4), (2, 2))
MESH_IDS = ["1x2", "1x4", "2x2"]
RANK_TIMEOUT = 150.0                # three models a rank, six test workers
PADDED = dict(n_heads=7, n_kv_heads=2, d_model=112, pad_heads_to=8,
              mrope_sections=(2, 3, 3))


def _cfg(model, tiny=tiny_version, get=get_config):
    """The model's tiny config, from either package's ``tiny_version`` and
    ``get_config``."""
    if model == "encdec":
        return tiny(get("whisper-medium"))
    cfg = tiny(get("qwen2-vl-7b"))
    return cfg.with_(**PADDED) if model == "padded" else cfg


def _prompt_len(model) -> int:
    return S_DEC if model == "encdec" else P


def _cache_len(model) -> int:
    """The serving cache's positions: prompt + GEN - 1 (16 and 20 split
    over 2 and 4)."""
    return _prompt_len(model) + GEN - 1


def grid_positions(batch, seq, width=4, t=3):
    """(3, batch, seq) int32 streams: temporal ``t``, height and width over
    a grid ``width`` patches wide (row ``b`` offset by ``b`` rows)."""
    i = np.arange(seq)[None] + width * np.arange(batch)[:, None]
    return np.stack([np.full((batch, seq), t), i // width, i % width]
                    ).astype(np.int32)


def _prompt(model, cfg, frames=S_ENC) -> dict:
    """The model's prompt as numpy arrays: VLM patch embeddings and
    distinct M-RoPE streams, or the enc-dec's frames and decoder tokens."""
    rng = np.random.default_rng(7 + MODELS.index(model))
    if model == "encdec":
        return {"tokens": rng.integers(0, cfg.vocab, (B, S_DEC)).astype(
                    np.int32),
                "embeds": rng.standard_normal((B, frames, cfg.d_model)
                                              ).astype(np.float32)}
    return {"embeds": rng.standard_normal((B, P, cfg.d_model)).astype(
                np.float32),
            "positions": grid_positions(B, P)}


def _torch(prompt: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in prompt.items()}


# -- the ranks (no JAX) ------------------------------------------------------

def _full(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).numpy().copy()


def _steps(cfg, mesh, dec, prompt, forced, n, enc_len, cache=None):
    """The mesh's prefill (unless a serving ``cache`` is given) and GEN - 1
    serve steps fed ``forced``: (gathered logits per step, the prefill
    cache's local block shapes and whole leaves)."""
    L = _prompt_len_of(prompt)
    out = dict(logits=[])
    if cache is None:
        prefill = ST.mesh_step(cfg, ShapeConfig("p", L, B, "prefill"), mesh,
                               cache_len=n)
        logits, cache = prefill(dec, prompt)
        out["logits"].append(_full(logits))
        out["blocks"] = {k: tuple(v.to_local().shape)
                         for k, v in cache.items()}
        out["cache"] = {k: _full(v) for k, v in cache.items()}
    serve = ST.mesh_step(cfg, ShapeConfig("d", n, B, "decode"), mesh,
                         enc_len=enc_len)
    for t in range(GEN - 1):
        feed = {"tokens": torch.from_numpy(forced[:, t:t + 1])}
        logits, cache = serve(dec, cache, feed, L + t)
        out["logits"].append(_full(logits))
    return out


def _prompt_len_of(prompt) -> int:
    return (prompt["tokens"] if "tokens" in prompt else
            prompt["embeds"]).shape[1]


def _rows(t, mesh, shape, axis=0):
    n = t.shape[axis] // shape[0]
    return t.narrow(axis, mesh.get_local_rank("data") * n, n)


def _mesh_cache_run(cfg, mesh, shape, params, dec, prompt, forced):
    """A cache built outside the prefill: the one-process prefill of this
    rank's rows spliced into a zero cache of the serving length and the
    encoder's rows, laid out by ``mesh_cache``; then the serve steps."""
    mine = {k: _rows(v, mesh, shape) for k, v in prompt.items()}
    _, pcache = api.prefill(params, cfg, mine)
    cache = api.init_cache(cfg, B // shape[0], _cache_len("encdec"),
                           enc_len=S_ENC, device="cpu")
    for name, c in cache.items():
        splice(c, pcache[name])
    cache = ST.mesh_cache(cache, mesh)
    out = _steps(cfg, mesh, dec, prompt, forced, _cache_len("encdec"),
                 S_ENC, cache)
    out["blocks"] = {k: tuple(v.to_local().shape) for k, v in cache.items()}
    return out


def _tp_worker(rank, world, shape, weights, prompts, forced, odd):
    """Every model on this rank's mesh: the greedy run's tokens, the
    teacher-forced prefill and serve steps (logits gathered, the prefill
    cache's blocks and whole); for the enc-dec also a cache laid out by
    ``mesh_cache`` and a run over ``ODD_ENC`` frames."""
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    out = {}
    for model in MODELS:
        cfg = _cfg(model)
        dec = TP.shard_params(weights[model], cfg, mesh, "decode")
        prompt = _torch(prompts[model])
        enc_len = S_ENC if model == "encdec" else None
        res = _steps(cfg, mesh, dec, prompt, forced[model],
                     _cache_len(model), enc_len)
        res["greedy"] = greedy_decode(
            dec, cfg, prompt.get("tokens"), GEN, embeds=prompt["embeds"],
            positions=prompt.get("positions"), mesh=mesh).tokens
        out[model] = res
    cfg, params = _cfg("encdec"), weights["encdec"]
    dec = TP.shard_params(params, cfg, mesh, "decode")
    out["mesh_cache"] = _mesh_cache_run(cfg, mesh, shape, params, dec,
                                        _torch(prompts["encdec"]),
                                        forced["encdec"])
    oprompt, otoks = odd
    out["odd"] = _steps(cfg, mesh, dec, _torch(oprompt), otoks,
                        _cache_len("encdec"), ODD_ENC)
    return out


# -- the JAX reference and the one-process port ------------------------------

_CACHE = {}


def _jax_model(model):
    """(JAX cfg, JAX params, port params) of the model, drawn once."""
    key = ("model", model)
    if key not in _CACHE:
        import jax
        from repro.configs.archs import tiny_version as j_tiny
        from repro.configs.base import get_config as j_get
        from repro.models import api as japi
        from repro_torch.convert import lm_params_from_jax
        jcfg = _cfg(model, j_tiny, j_get)
        jparams = japi.init(jax.random.key(3 + MODELS.index(model)), jcfg)
        _CACHE[key] = (jcfg, jparams,
                       lm_params_from_jax(jax.device_get(jparams)))
    return _CACHE[key]


def _reference(model):
    """(port params, prompt, JAX tokens (B, GEN), JAX logits per step, JAX
    prefill cache): JAX's prefill, its cache zero-padded to the serving
    length (the enc-dec's cross cache kept at the encoder's rows), then
    GEN - 1 greedy decode steps."""
    if model in _CACHE:
        return _CACHE[model]
    import jax
    import jax.numpy as jnp
    from repro.models import api as japi
    jcfg, jparams, params = _jax_model(model)
    prompt = _prompt(model, jcfg)
    logits, pcache = jax.jit(lambda p, b: japi.prefill(p, jcfg, b))(
        jparams, {k: jnp.asarray(v) for k, v in prompt.items()})
    n = _cache_len(model)

    def pad(x, rows):
        return jnp.pad(x, [(0, 0), (0, 0), (0, rows - x.shape[2]), (0, 0),
                           (0, 0)])
    cache = {k: pad(v, n if k in ("k", "v") else v.shape[2])
             for k, v in pcache.items()}
    decode = jax.jit(lambda p, b, c, i: japi.decode_step(p, jcfg, b, c, i))
    cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    toks, steps = [np.asarray(cur)], [np.asarray(logits)]
    L = _prompt_len(model)
    for t in range(GEN - 1):
        logits, cache = decode(jparams, {"tokens": cur}, cache,
                               jnp.int32(L + t))
        cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(cur))
        steps.append(np.asarray(logits))
    _CACHE[model] = (params, prompt, np.concatenate(toks, 1), steps,
                     {k: np.asarray(v) for k, v in pcache.items()})
    return _CACHE[model]


def _one_process(model, prompt=None):
    """The one-process port's greedy run (tokens, each step's logits)."""
    key = ("one", model, None if prompt is None else "odd")
    if key not in _CACHE:
        params, ref_prompt, *_ = _reference(model)
        p = _torch(ref_prompt if prompt is None else prompt)
        _CACHE[key] = greedy_decode(
            params, _cfg(model), p.get("tokens"), GEN, embeds=p["embeds"],
            positions=p.get("positions"), keep_logits=True)
    return _CACHE[key]


def _odd_prompt():
    return _prompt("encdec", _cfg("encdec"), ODD_ENC)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's rank results, one spawn per mesh, run once for the
    module."""
    done = {}

    def get(shape):
        if shape not in done:
            weights, prompts, forced = {}, {}, {}
            for model in MODELS:
                params, prompt, jtoks, *_ = _reference(model)
                weights[model], prompts[model] = params, prompt
                forced[model] = jtoks
            odd = (_odd_prompt(), _one_process("encdec",
                                               _odd_prompt()).tokens)
            done[shape] = run_ranks(
                _tp_worker, shape[0] * shape[1],
                tmp_path_factory.mktemp("vlm_encdec_tp"), shape, weights,
                prompts, forced, odd, timeout=RANK_TIMEOUT)
        return done[shape]
    return get


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)))


CASES = [(m, s) for s in MESHES for m in MODELS]
CASE_IDS = [f"{m}-{i}" for i in MESH_IDS for m in MODELS]


@pytest.mark.parametrize("model,shape", CASES, ids=CASE_IDS)
def test_prefill_and_decode_logits_equal_jax_single_device(model, shape,
                                                           runs):
    """Every rank's gathered logits, the prefill's and each teacher-forced
    decode step's, within 2e-5 of the JAX package's single-device steps
    on the same weights."""
    _, _, _, jsteps, _ = _reference(model)
    for r in runs(shape):
        errs = [_err(a, b) for a, b in zip(r[model]["logits"], jsteps)]
        assert len(errs) == GEN and max(errs) <= TOL, errs


@pytest.mark.parametrize("model,shape", CASES, ids=CASE_IDS)
def test_greedy_tokens_equal_the_one_process_port(model, shape, runs):
    _, _, jtoks, _, _ = _reference(model)
    one = _one_process(model)
    np.testing.assert_array_equal(one.tokens, jtoks)
    for r in runs(shape):
        np.testing.assert_array_equal(r[model]["greedy"], one.tokens)


def _kv_block(cfg, shape, rows):
    """A KV cache leaf's local (positions, kv heads) on a rank: its kv
    heads where they divide ``model``, else its block of ``rows``
    positions where they divide it, else every row and head."""
    m, KV = shape[1], cfg.n_kv_heads
    if KV % m == 0:
        return rows, KV // m
    return (rows // m if rows % m == 0 else rows), KV


@pytest.mark.parametrize("model,shape", CASES, ids=CASE_IDS)
def test_prefill_cache_is_the_decode_layout(model, shape, runs):
    """The prefill's cache is the serving cache: whole, the self cache is
    JAX's prefill cache spliced into zeros of the serving length, and an
    enc-dec's cross cache holds exactly the encoder's rows, on every mesh
    (never padded or cut to the decode length); each rank holds its kv
    heads, or its block of positions (of the encoder's rows for the
    cross cache), as ``cache_specs`` of the decode shape place them."""
    cfg = _cfg(model)
    _, _, _, _, jcache = _reference(model)
    n = _cache_len(model)
    lead = (cfg.n_dec_layers if model == "encdec" else cfg.n_layers,
            B // shape[0])
    for r in runs(shape):
        res = r[model]
        assert sorted(res["cache"]) == sorted(jcache)
        for name, want in jcache.items():
            rows = n if name in ("k", "v") else S_ENC
            assert res["blocks"][name] == (
                *lead, *_kv_block(cfg, shape, rows), cfg.head_dim), name
            whole = res["cache"][name]
            assert whole.shape[2] == rows
            assert _err(whole[:, :, :want.shape[2]], want) <= TOL
            assert not whole[:, :, want.shape[2]:].any()


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_cache_laid_out_by_mesh_cache_serves_the_same(shape, runs):
    """A cache built outside the prefill (the one-process prefill spliced
    into a zero cache of the encoder's rows) and laid out by
    ``mesh_cache`` holds the same blocks, and its serve steps give JAX's
    decode logits."""
    cfg = _cfg("encdec")
    _, _, _, jsteps, _ = _reference("encdec")
    for r in runs(shape):
        got = r["mesh_cache"]
        assert got["blocks"] == r["encdec"]["blocks"]
        assert got["blocks"]["ck"][2:4] == _kv_block(cfg, shape, S_ENC)
        errs = [_err(a, b) for a, b in zip(got["logits"], jsteps[1:])]
        assert len(errs) == GEN - 1 and max(errs) <= TOL, errs


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_cross_cache_of_rows_that_split_over_no_axis(shape, runs):
    """22 encoder frames split over no ``model`` axis of 4: the cross cache
    stays whole on every rank (its query heads read the kv heads they
    need) while the self cache is sequence-sharded; the logits equal the
    one-process port's."""
    cfg = _cfg("encdec")
    one = _one_process("encdec", _odd_prompt())
    for r in runs(shape):
        got = r["odd"]
        assert got["blocks"]["ck"][2:4] == _kv_block(cfg, shape, ODD_ENC)
        assert got["cache"]["ck"].shape[2] == ODD_ENC
        errs = [_err(a, b[:, None].numpy())
                for a, b in zip(got["logits"], one.logits)]
        assert len(errs) == GEN and max(errs) <= TOL, errs


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


def _layouts(model, m, kind, n=20, enc_len=S_ENC):
    """Each rank's layout on a (1, m) mesh for a step of ``kind``."""
    cfg = _cfg(model)
    amesh = abstract_mesh((1, m), ("data", "model"))
    pspecs = ST.specs_of(ST.param_specs(cfg, amesh, kind=kind))
    cspecs = {}
    if kind == "decode":
        cspecs = ST.specs_of(ST.cache_specs(
            cfg, ShapeConfig("s", n, B, kind), amesh,
            enc_len=enc_len if model == "encdec" else None))
    return [TP.layout(cfg, _Rank((1, m), ("data", "model"), (0, r)), pspecs,
                      cspecs.get("k"), n, cspecs.get("ck"), enc_len)
            for r in range(m)]


@pytest.mark.parametrize("m,kind,kv,seq,cross", [
    (2, "prefill", "heads", None, None), (2, "decode", "heads", None, None),
    (4, "prefill", "input", None, None), (4, "decode", "whole", 5, 5)])
def test_layout_reads_the_encdec_stacks(m, kind, kv, seq, cross):
    """The enc-dec's layout comes from ``dec_layers`` (the encoder's
    stack placed the same): heads, FFN and vocabulary split; its 2 kv
    heads on ``model`` 2, else ``wk``/``wv`` cut on their input dimension
    at prefill and whole at decode, the self cache's 20 positions and the
    cross cache's 20 encoder rows each in blocks of its own."""
    cfg = _cfg("encdec")
    for r, lay in enumerate(_layouts("encdec", m, kind)):
        n = cfg.heads_padded // m
        assert lay.heads == (r * n, (r + 1) * n) and lay.split_heads
        assert lay.kv == kv and lay.split_ffn and lay.split_vocab
        assert lay.seq == (None if seq is None else (r * seq, (r + 1) * seq))
        assert lay.cross_seq == (None if cross is None
                                 else (r * cross, (r + 1) * cross))
    # a cross cache of another length than the self cache's is its own
    odd = _layouts("encdec", 4, "decode", n=20, enc_len=24)
    assert [lay.cross_seq for lay in odd] == [(0, 6), (6, 12), (12, 18),
                                               (18, 24)]
    assert [lay.seq for lay in odd] == [(0, 5), (5, 10), (10, 15), (15, 20)]
    whole = _layouts("encdec", 4, "decode", enc_len=ODD_ENC)
    assert all(lay.cross_seq is None for lay in whole)


@pytest.mark.parametrize("where", ["enc_layers/attn/wq",
                                   "dec_layers/cross_attn/wk",
                                   "enc_layers/ffn/wi/kernel"])
def test_layout_raises_where_the_encdec_stacks_disagree(where):
    """One rank layout serves the encoder's, the decoder's self- and its
    cross-attention (and both FFNs) only where the specs place them
    alike: a spec tree that places one apart raises rather than
    guesses."""
    cfg = _cfg("encdec")
    amesh = abstract_mesh((1, 2), ("data", "model"))
    pspecs = ST.specs_of(ST.param_specs(cfg, amesh, kind="prefill"))
    node = pspecs
    *path, leaf = where.split("/")
    for k in path:
        node = node[k]
    node[leaf] = PartitionSpec()
    mesh = _Rank((1, 2), ("data", "model"), (0, 0))
    with pytest.raises(ValueError, match="apart"):
        TP.layout(cfg, mesh, pspecs)


@pytest.mark.parametrize("model,m,heads,kv,real", [
    ("vlm", 2, [(0, 16), (16, 32)], "heads", [4, 0]),
    ("vlm", 4, [(0, 8), (8, 16), (16, 24), (24, 32)], "whole", [4, 0, 0, 0]),
    ("padded", 2, [(0, 4), (4, 8)], "heads", [4, 3]),
    ("padded", 4, [(0, 2), (2, 4), (4, 6), (6, 8)], "whole", [2, 2, 2, 1])])
def test_padded_heads_split_as_the_reference_lays_them_out(model, m, heads,
                                                           kv, real):
    """The padded query heads split in whole blocks in the reference's
    grouped-major order (head h reads kv head h // G; the inert heads,
    zero ``wo`` rows, are the last ``Hp - n_heads``): the tiny VLM's
    ranks past the first hold only inert heads; the padding shaped like
    the published one (7 of 8) leaves the last rank its inert head beside
    real ones. Each rank's ``wq`` and ``wo`` blocks are those heads', and
    its ``wo`` rows are zero exactly at the inert ones."""
    cfg = _cfg(model)
    params = api.init(torch.Generator().manual_seed(0), cfg)
    G = cfg.heads_padded // cfg.n_kv_heads
    for r, lay in enumerate(_layouts(model, m, "decode")):
        h0, h1 = lay.heads
        assert (h0, h1) == heads[r] and lay.kv == kv
        k0, k1 = lay.kv_read
        if kv == "heads":
            assert (k0, k1) == (0, cfg.n_kv_heads // m)
        else:
            assert (k0, k1) == (h0 // G, (h1 - 1) // G + 1)
        mesh = _Rank((1, m), ("data", "model"), (0, r))
        attn = TP.shard_params(params, cfg, mesh, "decode")["layers"]["attn"]
        whole = params["layers"]["attn"]
        assert torch.equal(attn["wq"], whole["wq"][:, :, h0:h1])
        assert torch.equal(attn["wo"], whole["wo"][:, h0:h1])
        live = attn["wo"].abs().flatten(2).amax(-1).amax(0) > 0
        assert live.tolist() == [h < cfg.n_heads for h in range(h0, h1)]
        assert int(live.sum()) == real[r]


def test_shard_params_cuts_the_encdec_leaves_by_their_paths():
    """The enc-dec's leaves are cut by their paths' specs at ``model`` 2:
    every attention's heads (encoder, decoder self and cross), the GELU
    FFN's ``wi`` kernel and bias on ``mlp``, ``wo``'s bias whole, the
    embedding's rows and ``lm_head``'s columns on the vocabulary (512
    divides; whisper-medium's 51865 divides neither 2 nor 4, so its
    sanitized specs keep both whole)."""
    cfg = _cfg("encdec")
    params = api.init(torch.Generator().manual_seed(1), cfg)
    H, ff, V = cfg.heads_padded // 2, cfg.d_ff // 2, cfg.vocab // 2
    for r in range(2):
        mesh = _Rank((1, 2), ("data", "model"), (0, r))
        got = TP.shard_params(params, cfg, mesh, "decode")
        for stack, name in (("enc_layers", "attn"),
                            ("dec_layers", "self_attn"),
                            ("dec_layers", "cross_attn")):
            a, w = got[stack][name], params[stack][name]
            assert torch.equal(a["wq"], w["wq"][:, :, r * H:(r + 1) * H])
            assert torch.equal(a["wk"], w["wk"][:, :, r:r + 1])
            assert torch.equal(a["wo"], w["wo"][:, r * H:(r + 1) * H])
        for stack in ("enc_layers", "dec_layers"):
            f, w = got[stack]["ffn"], params[stack]["ffn"]
            cols = slice(r * ff, (r + 1) * ff)
            assert torch.equal(f["wi"]["kernel"], w["wi"]["kernel"][..., cols])
            assert torch.equal(f["wi"]["bias"], w["wi"]["bias"][..., cols])
            assert torch.equal(f["wo"]["kernel"], w["wo"]["kernel"][:, cols])
            assert torch.equal(f["wo"]["bias"], w["wo"]["bias"])
        assert torch.equal(got["embed"]["embedding"],
                           params["embed"]["embedding"][r * V:(r + 1) * V])
        assert torch.equal(got["lm_head"]["kernel"],
                           params["lm_head"]["kernel"][:, r * V:(r + 1) * V])
    full = get_config("whisper-medium")
    for m in (2, 4):
        specs = ST.specs_of(ST.param_specs(full, abstract_mesh(
            (1, m), ("data", "model")), kind="decode"))
        assert tuple(specs["embed"]["embedding"]) == ()
        assert tuple(specs["lm_head"]["kernel"]) == ()


def test_ffn_adds_wo_bias_once_after_the_sum(monkeypatch):
    """Rank 0's FFN with rank 1's share of ``wo``'s product added where the
    ranks' shares are summed: the whole FFN, ``wo``'s bias once. A bias
    added on each rank before the sum would count twice."""
    cfg = _cfg("encdec")
    p = api.init(torch.Generator().manual_seed(2), cfg)["dec_layers"]["ffn"]
    g = torch.Generator().manual_seed(3)
    p = {k: {n: t[0] for n, t in v.items()} for k, v in p.items()}
    for k in ("wi", "wo"):                      # drawn as zeros: make them
        p[k]["bias"] = torch.randn(p[k]["bias"].shape, generator=g)
    x = torch.randn((2, 3, cfg.d_model), generator=g)
    whole = T.ffn_apply(p, cfg, x)
    shares = []

    def blocks(r):
        cols = slice(r * cfg.d_ff // 2, (r + 1) * cfg.d_ff // 2)
        return {"wi": {"kernel": p["wi"]["kernel"][:, cols],
                       "bias": p["wi"]["bias"][cols]},
                "wo": {"kernel": p["wo"]["kernel"][cols],
                       "bias": p["wo"]["bias"]}}
    def keep(t, group, dtype):          # rank 1: its share, kept
        shares.append(t)
        return torch.zeros_like(t, dtype=dtype)

    def add(t, group, dtype):           # rank 0: the two shares summed
        return (t + shares[0]).to(dtype)
    with TP.installed(_layouts("encdec", 2, "prefill")[0]):
        monkeypatch.setattr(TP, "sum_partials", keep)
        T.ffn_apply(blocks(1), cfg, x)
        monkeypatch.setattr(TP, "sum_partials", add)
        got = T.ffn_apply(blocks(0), cfg, x)
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-6)


def test_cache_specs_size_the_cross_cache_by_the_encoder():
    """``cache_specs(..., enc_len=)`` gives ``ck``/``cv`` the encoder's rows
    (the decode length without it, the reference's layout) and places
    them by the KV rule: the kv heads on ``model`` where they divide it,
    else the rows."""
    cfg = _cfg("encdec")
    shape = ShapeConfig("s", 16, B, "decode")
    for m, spec in ((2, (None, "data", None, "model")),
                    (4, (None, "data", "model"))):
        amesh = abstract_mesh((1, m), ("data", "model"))
        placed = ST.cache_specs(cfg, shape, amesh, enc_len=S_ENC)
        assert placed["ck"].tensor.shape[2] == S_ENC
        assert placed["k"].tensor.shape[2] == 16
        assert tuple(placed["ck"].spec) == spec
        assert ST.cache_specs(cfg, shape, amesh)["ck"].tensor.shape[2] == 16
