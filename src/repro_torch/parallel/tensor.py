"""Tensor parallelism on a mesh's ``model`` axis: the prefill and serve
steps of all six LM families (dense, MoE, SSM, hybrid, VLM, enc-dec), and
the dense and MoE families' train steps, split over the ranks of that
axis.

The JAX package runs any step on any mesh through ``jit`` with the
``in_shardings`` of ``param_specs`` / ``cache_specs``; GSPMD splits the
work as the logical rules say (``heads``, ``kv_heads``, ``mlp``,
``vocab`` and ``ssm_inner`` on ``model``, ``parallel/sharding.py``). The
port executes the same split by hand (the MoE FFN as the reference's own
``_moe_apply_shard_map`` splits it; a mamba mixer by its SSM heads or
head channels, :class:`SSM`), in three parts:

- the rank layout: :func:`shard_params` cuts whole params into this
  rank's blocks as the sanitized specs of ``param_specs(cfg, mesh, kind)``
  place them (a mamba mixer's by its channel set, which no contiguous
  block of the specs gives), and :class:`Layout` (:func:`layout`) says
  what the rank computes, read from those specs and, for a decode step,
  from the cache's (the SSM channels from the decode cache's ``state``
  spec; an enc-dec's cross cache from ``ck``'s spec and the encoder's
  length). :func:`installed` makes a layout current for the model code
  (``models/transformer.py``, ``models/ssm.py``, ``models/hybrid.py``,
  ``models/encdec.py``), which reads it with :func:`current`.
  :func:`local_block` and :func:`gather_block` cut one leaf and join it
  again (a SwiGLU ``wi``'s gate_r ‖ up_r included);
- the collectives: :func:`all_reduce` (a sum, or a max where the
  log-sum-exp merge needs one; :func:`sum_partials`, the sum of the ranks'
  shares of a product, kept in fp32 until it is whole) and
  :func:`all_gather`, over the group of
  the ``model`` axis (and of ``data`` for an MoE whose expert matrices
  are cut on d over it), and nothing else;
- the masks: :func:`embed_lookup`, the vocabulary-sharded embedding
  gather, whose rows equal the whole gather bit for bit, and
  :func:`merge_blocks`, the cross-rank merge of a sequence-sharded decode
  cache's blocks (or an enc-dec's cross cache's) by their log-sum-exp.

Under grad (a train step) the sums are ones autograd sees, two
``autograd.Function``s over the ``model`` group (Megatron's f and g):
:func:`reduce_from_model` sums the ranks' shares (the forward of
:func:`sum_partials`, which takes it under grad) and passes the gradient
through; :func:`copy_to_model` is the identity where a tensor every rank
holds whole enters the rank's own part of the work (the normed input of
a split attention or FFN, the final norm's output before a
vocabulary-split ``lm_head``, a whole k/v before a rank reads its kv
heads of it, an MoE's input and its router's kernel), and sums the
ranks' gradients of it in fp32, rounded once to the gradient's dtype.
The rule: a leaf replicated on ``model`` (the norm scales, the FFN's
``wo`` bias, a whole ``wk``/``wv``) gets the same full gradient, bit for
bit, on every ``model`` rank (every rank computes it from the same
summed gradients), and no collective is added for it; the MoE's router,
which each rank reaches through its own share of the combine, gets it
from its ``copy_to_model``. :func:`all_gather` under grad (an MoE's
expert matrices cut on d over ``data``, gathered for the product)
reduce-scatters the gradient back: each rank's block summed over the
group in fp32.
The serving path runs under ``no_grad`` and keeps its in-place sums.

Where a rank's group is gloo and its tensors lie on the card (two ranks
sharing one card, where NCCL refuses two ranks of one group on one
device), gloo copies each tensor through host memory itself: with torch
2.11 + CUDA 12.8 it carries the collectives used here (a sum, a max, a
gather) and the ZeRO-1 reduce-scatter of ``launch.steps`` on CUDA
tensors in fp32 and bf16 (``tools/gloo_cuda_probe.py`` on an H100), so
nothing is staged here.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.compat import (all_gather_single, mesh_shape,
                                reduce_scatter_single)
from repro_torch.parallel import specs as SP
from repro_torch.parallel.sharding import axes_of
from repro_torch.tree import tree_map_with_path


# ---------------------------------------------------------------------------
# the collectives, over the model axis's group
# ---------------------------------------------------------------------------

def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` summed (``op="sum"``) or maxed (``"max"``) over the group's
    ranks, in place; returns ``t``. Every rank gets the same bits."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(t, op=red, group=group)
    return t


def sum_partials(t: torch.Tensor, group, dtype) -> torch.Tensor:
    """A rank's share ``t`` of a sum split over the group (a row-parallel
    product's partial result), summed in fp32 and rounded to ``dtype``
    once: one process rounds the whole product once, and a bf16 share
    rounded before the sum would add a rounding for each rank, which a
    deep bf16 model carries to its logits. The caller takes the share's
    product in fp32 (``x.float() @ w.float()``: a bf16 operand's products
    exact, their sums in fp32). Under grad, :func:`reduce_from_model`."""
    if _grad(t):
        return reduce_from_model(t, group, dtype)
    return all_reduce(t.float().contiguous(), group).to(dtype)


def _grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _fp32_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t``'s sum over the group in fp32, in a buffer of its own."""
    buf = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    return all_reduce(buf.copy_(t), group)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dtype):
        ctx.dtype = t.dtype
        return _fp32_sum(t, group).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _fp32_sum(g, ctx.group).to(g.dtype), None


def reduce_from_model(t: torch.Tensor, group, dtype) -> torch.Tensor:
    """The ranks' shares ``t`` summed over the group in fp32 and rounded
    to ``dtype`` once (:func:`sum_partials`' arithmetic, into a new
    tensor); the gradient passes through unchanged: every rank's share
    gets the whole sum's gradient."""
    return _ReduceFromModel.apply(t, group, dtype)


def copy_to_model(t: torch.Tensor, group) -> torch.Tensor:
    """``t``, which every rank of the group holds whole, where it enters
    this rank's own part of the work: the identity, whose gradient is the
    sum of the ranks' gradients, in fp32 and rounded once to the
    gradient's dtype (each rank's is the part its own work gives). ``t``
    itself where no gradient is taken."""
    return _CopyToModel.apply(t, group) if _grad(t) else t


def _gather(t: torch.Tensor, group, size: int) -> torch.Tensor:
    src = t.reshape(-1)
    out = src.new_empty(size * src.numel())
    all_gather_single(out, src, group=group)
    return out.view(size, *t.shape)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, size):
        ctx.group, ctx.size = group, size
        return _gather(t, group, size)

    @staticmethod
    def backward(ctx, g):
        src = g.float().contiguous().reshape(-1)
        out = src.new_empty(src.numel() // ctx.size)
        reduce_scatter_single(out, src, group=ctx.group)
        return out.view(g.shape[1:]).to(g.dtype), None, None


def all_gather(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order: (size, *t.shape). Under
    grad its backward is the reduce-scatter: each rank's ``t`` gets the
    sum over the group of the gradients of its own block, in fp32 and
    rounded once to the gradient's dtype (an expert matrix's d block, cut
    over ``data`` and gathered for the product: the sum of every data
    rank's rows' gradient)."""
    if _grad(t):
        return _AllGather.apply(t, group, size)
    return _gather(t, group, size)


# ---------------------------------------------------------------------------
# the rank layout
# ---------------------------------------------------------------------------

class Experts(NamedTuple):
    """What one rank computes of an MoE FFN, the reference's
    ``_moe_apply_shard_map``. Every ``model`` rank routes all of its data
    shard's rows (they are replicated over ``model``) and its partial
    output is summed over the ``model`` ranks.

    - ``experts``: its experts [e0, e1); ``split_experts``: a block of
      E/model of them (expert-parallel, ``E % model == 0``): it dispatches
      only the slots routed to them;
    - ``ff``: its block of every expert's ff columns/rows, a part of them
      where the experts do not divide the axis (``E % model != 0``, each
      rank holding every expert): it dispatches every slot;
    - ``embed``: its block [d0, d1) of the expert matrices' d, cut over
      ``data`` (the whole d where they are not): a prefill gathers the
      weights over ``data``, a one-token step takes the 2-D path;
      ``data_group``, ``data_size``, ``data_index``: that axis's group,
      size and this rank's index on it.
    """
    experts: Tuple[int, int]
    split_experts: bool
    ff: Tuple[int, int]
    embed: Tuple[int, int]
    data_group: Any
    data_size: int
    data_index: int


class SSM(NamedTuple):
    """What one rank computes of a mamba mixer of ``n_heads`` SSM heads of
    ``P`` channels over a state of ``N`` (d_inner = n_heads·P), as the
    reference's ``xh`` constrained to ``("batch", "seq", "ssm_inner",
    None)`` (``models/ssm.py:141``) and the decode cache's ``state`` spec
    place it:

    - ``heads`` [h0, h1) of the heads (``ssm_inner`` on H: the heads
      divide the axis), every channel of each;
    - ``head_dim`` [p0, p1) of each head's channels (``head_dim_shard`` on
      P: H does not divide the axis and P does), every head;
    - neither (whole): every channel, and the mixer runs replicated.

    The rank's d_inner channels are h·P + p over its heads and head
    channels, head-major (:meth:`channels`): those of z, x and the scan's
    output y, of ``out_norm``'s scale and of ``out_proj``'s rows. B and C
    (one group of N channels each) are whole on every rank: every head
    reads them. ``in_proj``'s columns are [z | x | B | C | dt] and the
    conv's channels [x | B | C] (``models/ssm.py``), so the rank's columns
    of each (:meth:`in_cols`, :meth:`conv_cols`) are no contiguous block.
    Where it holds less than the whole (:attr:`split`), the gated norm's
    sums of squares and ``out_proj``'s products are summed over
    ``model``."""
    heads: Tuple[int, int]
    head_dim: Tuple[int, int]
    n_heads: int
    P: int
    N: int

    @property
    def split(self) -> bool:
        return (self.heads, self.head_dim) != ((0, self.n_heads), (0, self.P))

    def channels(self) -> torch.Tensor:
        """The rank's d_inner channels, head-major."""
        (h0, h1), (p0, p1) = self.heads, self.head_dim
        return (torch.arange(h0, h1)[:, None] * self.P
                + torch.arange(p0, p1)).flatten()

    def conv_cols(self) -> torch.Tensor:
        """The rank's conv channels [x_r | B | C]."""
        d_in = self.n_heads * self.P
        return torch.cat([self.channels(),
                          torch.arange(d_in, d_in + 2 * self.N)])

    def in_cols(self) -> torch.Tensor:
        """The rank's ``in_proj`` columns [z_r | x_r | B | C | dt_r]."""
        d_in, ch = self.n_heads * self.P, self.channels()
        return torch.cat([ch, d_in + ch, torch.arange(2 * d_in, 2 * d_in
                                                      + 2 * self.N),
                          2 * d_in + 2 * self.N + torch.arange(*self.heads)])


class Layout(NamedTuple):
    """What one rank of the ``model`` axis computes in a prefill or decode
    step of any LM family (dense, MoE, SSM, hybrid, VLM, enc-dec). Ranges
    are [start, stop) in the whole tensor's indices.

    - ``heads``: its query heads (every head where ``wq`` is not split);
      ``split_heads``: ``wq``/``wo`` hold only those, so the output
      projection is summed over the ranks;
    - ``kv``: ``"heads"`` (its own kv heads, which divide the axis),
      ``"input"`` (``wk``/``wv`` cut on their input dimension, block
      ``embed`` of d: k and v are summed over the ranks and whole) or
      ``"whole"`` (``wk``/``wv`` replicated: k and v whole);
      ``kv_read``: the kv heads, of the k/v (or cache) the rank holds,
      that its query heads read;
    - ``split_ffn``: ``wi``/``wo`` hold its FFN columns/rows (summed after);
    - ``moe``: an MoE layer's :class:`Experts` (None for a dense FFN);
    - ``vocab``: its rows of the embedding and columns of the logits
      (``split_vocab`` when that is not the whole vocabulary);
    - ``seq``: a decode step's cache positions on this rank where the
      cache is sequence-sharded, else None (the rank holds them all);
    - ``ssm``: a mamba mixer's :class:`SSM` (None without one);
    - ``cross_seq``: an enc-dec decode step's rows of the cross cache
      ``ck``/``cv`` on this rank where they are sharded (a block of the
      encoder's length, which is not the self cache's), else None.

    A family without attention (the SSM) has no heads: (0, 0), ``kv``
    "whole"; one without a dense FFN, ``split_ffn`` False. The enc-dec's
    encoder self-attention and its decoder's self- and cross-attention
    share one head layout, as they share one FFN layout.
    """
    group: Any
    size: int
    heads: Tuple[int, int]
    split_heads: bool
    kv: str
    kv_read: Tuple[int, int]
    embed: Tuple[int, int]
    split_ffn: bool
    vocab: Tuple[int, int]
    split_vocab: bool
    seq: Optional[Tuple[int, int]]
    moe: Optional[Experts] = None
    ssm: Optional[SSM] = None
    cross_seq: Optional[Tuple[int, int]] = None


def block(length: int, entry, mesh) -> Tuple[int, int]:
    """This rank's block [lo, hi) of a dimension of ``length`` placed by
    the spec entry ``entry`` (None: the whole), split by its mesh axes in
    order, major first."""
    idx, n = 0, 1
    sizes = mesh_shape(mesh)
    for a in axes_of(entry):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    if length % n:
        raise ValueError(f"{length} does not split over {n} ranks")
    step = length // n
    return idx * step, (idx + 1) * step


def _entry(spec, dim: int):
    return spec[dim] if dim < len(spec) else None


def _model_only(entry, what: str):
    """``entry`` where it is ``"model"`` or None; another axis there is a
    placement this slice does not execute."""
    if entry is None or entry == "model":
        return entry
    raise NotImplementedError(
        f"{what} placed on {entry}: the tensor-parallel steps split it on "
        f"the model axis alone")


def _experts(cfg, mesh, ffn: Any) -> Experts:
    """The :class:`Experts` of an MoE FFN whose stacked ``wi`` (L, E, 2,
    d, ff) and ``wo`` (L, E, ff, d) are placed by the sanitized specs
    ``ffn["wi"]``, ``ffn["wo"]``: the experts or the ff columns on
    ``model``, d on ``data`` or whole."""
    wi, wo = ffn["wi"], ffn["wo"]
    e_e, d_e, ff_e = _entry(wi, 1), _entry(wi, 3), _entry(wi, 4)
    if (e_e, ff_e, d_e) != (_entry(wo, 1), _entry(wo, 2), _entry(wo, 3)):
        raise ValueError(f"the experts' wi placed {wi} and wo placed {wo} "
                         f"cut different blocks")
    e_e = _model_only(e_e, "the experts")
    ff_e = _model_only(ff_e, "the experts' ff columns")
    if (e_e is None) == (ff_e is None):
        raise NotImplementedError(
            f"experts placed {wi}: the tensor-parallel MoE splits either "
            f"the experts or their ff columns over the model axis")
    if d_e not in (None, "data"):
        raise NotImplementedError(
            f"the experts' d placed on {d_e}: the tensor-parallel MoE cuts "
            f"it over the data axis alone")
    sizes = mesh_shape(mesh)
    split_d = d_e is not None and sizes["data"] > 1
    return Experts(block(cfg.n_experts, e_e, mesh), e_e is not None,
                   block(cfg.d_ff, ff_e, mesh),
                   block(cfg.d_model, d_e, mesh),
                   mesh.get_group("data") if split_d else None,
                   sizes["data"] if split_d else 1,
                   mesh.get_local_rank("data") if split_d else 0)


def state_spec(H: int, P: int, N: int, mesh) -> Tuple[Any, int]:
    """The decode cache's ``state`` spec for H SSM heads of P channels over
    a state of N on ``mesh``, and the leaf's rank:
    ``parallel.specs.cache_specs`` of a ``meta`` state (L, B, H, P, N),
    whose H and P entries say which channels a rank holds (they depend on
    H, P and the ``model`` axis alone; a hybrid's state has one more
    leading axis, which no entry reads)."""
    n = 1
    for s in mesh_shape(mesh).values():
        n *= s
    t = torch.empty((1, n, H, P, N), device="meta")
    return SP.cache_specs({"state": t}, mesh)["state"], t.dim()


def ssm_for(H: int, P: int, N: int, mesh) -> SSM:
    """The :class:`SSM` of this rank for a mixer of H heads of P channels
    over a state of N, read from its decode state's spec
    (:func:`state_spec`): ``ssm_inner`` (the heads) or ``head_dim_shard``
    (each head's channels) on ``model``, or whole. The one rule of a
    rank's SSM channels: params, caches and the layout all take it from
    here."""
    spec, ndim = state_spec(H, P, N, mesh)
    h_e = _model_only(_entry(spec, ndim - 3), "the SSM state's heads")
    p_e = _model_only(_entry(spec, ndim - 2), "the SSM state's head dim")
    if h_e is not None and p_e is not None:
        raise ValueError(f"a state placed {spec} splits both its heads and "
                         f"their channels over the model axis")
    return SSM(block(H, h_e, mesh), block(P, p_e, mesh), H, P, N)


def ssm_of(cfg, mesh) -> Optional[SSM]:
    """The :class:`SSM` of ``cfg``'s mamba mixers on this rank
    (:func:`ssm_for`); None for a family without them."""
    if cfg.family not in ("ssm", "hybrid"):
        return None
    return ssm_for(cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, mesh)


def _find(tree: Any, pred) -> Any:
    """The first dict of a spec tree (in layer and sub-layer order) for
    which ``pred`` holds, else None."""
    if not isinstance(tree, dict):
        return None
    if pred(tree):
        return tree
    for v in tree.values():
        got = _find(v, pred)
        if got is not None:
            return got
    return None


def _stack(param_spec_tree: Any) -> Any:
    """The stack of layers a layout is read from: ``layers``, a hybrid's
    ``periods`` or an enc-dec's ``dec_layers``. An enc-dec's encoder
    attention and FFN must be placed as the decoder's self- and
    cross-attention and FFN are (all three attentions come from
    ``attn_init``, so one head layout serves them); where the specs
    disagree this raises rather than guesses."""
    if "dec_layers" not in param_spec_tree:
        return param_spec_tree.get("layers", param_spec_tree.get("periods"))
    dec, enc = param_spec_tree["dec_layers"], param_spec_tree["enc_layers"]
    for group in ({"enc_layers/attn": enc.get("attn"),
                   "dec_layers/self_attn": dec.get("self_attn"),
                   "dec_layers/cross_attn": dec.get("cross_attn")},
                  {"enc_layers/ffn": enc.get("ffn"),
                   "dec_layers/ffn": dec.get("ffn")}):
        if any(v != next(iter(group.values())) for v in group.values()):
            raise ValueError(f"the enc-dec's stacks place their sub-layers "
                             f"apart, {group}: one rank layout serves them "
                             f"only where they agree")
    return dec


def _cache_block(spec, length: int, mesh, kv: str, wk, what: str):
    """This rank's positions [s0, s1) of a KV cache leaf (L, B, S, KV, hd)
    of ``length`` positions placed by ``spec`` where ``model`` shards
    them, else None. The leaf must hold the kv heads that ``wk`` (placed
    ``wk``) gives the rank: its own where ``kv`` is ``"heads"``."""
    if (kv == "heads") != (_entry(spec, 3) == "model"):
        raise ValueError(f"{what} placed {spec} does not hold the kv heads "
                         f"that wk/wv placed {wk} give")
    entry = _entry(spec, 2)
    if entry is None or "model" not in axes_of(entry):
        return None
    return block(length, _model_only(entry, f"{what}'s sequence"), mesh)


def layout(cfg, mesh, param_spec_tree: Any, cache_spec: Any = None,
           cache_len: int = 0, cross_spec: Any = None,
           cross_len: int = 0) -> Layout:
    """The layout of this rank of ``mesh``'s ``model`` axis for a config's
    params placed by ``param_spec_tree`` (sanitized ``param_specs`` of the
    step's kind) and, for a decode step, its KV cache of ``cache_len``
    positions placed by ``cache_spec`` (the spec of the (L, B, S, KV, hd)
    ``k`` leaf) and an enc-dec's cross cache of ``cross_len`` rows (the
    encoder's length) placed by ``cross_spec`` (``ck``'s). Each kind of
    sub-layer (attention, dense FFN, MoE FFN, mamba mixer) is read from
    the first (sub-)layer of ``layers``, a hybrid's ``periods`` or an
    enc-dec's ``dec_layers`` (:func:`_stack`) that holds it; a mamba
    mixer's :class:`SSM` is :func:`ssm_of`'s."""
    stack = _stack(param_spec_tree)
    attn = _find(stack, lambda t: "wq" in t)
    d, V = cfg.d_model, cfg.vocab
    heads_e = input_e = None
    h0 = h1 = 0
    kv, kv_read = "whole", (0, 0)
    if attn is not None:
        Hp, KV = cfg.heads_padded, cfg.n_kv_heads
        heads_e = _model_only(_entry(attn["wq"], 2), "wq's heads")
        h0, h1 = block(Hp, heads_e, mesh)
        kv_heads_e = _model_only(_entry(attn["wk"], 2), "wk's kv heads")
        input_e = _model_only(_entry(attn["wk"], 1), "wk's input dimension")
        kv = "heads" if kv_heads_e else "input" if input_e else "whole"
        G = Hp // KV
        if kv == "heads":
            k0, k1 = block(KV, kv_heads_e, mesh)
            kv_read = (0, k1 - k0)
        elif (h1 - h0) % G == 0:
            kv_read = (h0 // G, h1 // G)
        elif G % (h1 - h0) == 0:
            kv_read = (h0 // G, h0 // G + 1)
        else:
            raise NotImplementedError(
                f"query heads [{h0}, {h1}) straddle groups of {G}: no kv "
                f"head range serves them")
    moe_ffn = _find(stack, lambda t: "router" in t)
    moe = _experts(cfg, mesh, moe_ffn) if moe_ffn is not None else None
    dense = _find(stack, lambda t: isinstance(t.get("wi"), dict))
    wi_e = None if dense is None else _model_only(
        _entry(dense["wi"]["kernel"], 2), "the FFN's columns")
    vocab_e = _model_only(_entry(param_spec_tree["embed"]["embedding"], 0),
                          "the vocabulary")
    seq = cross = None
    if attn is not None and cache_spec is not None:
        seq = _cache_block(cache_spec, cache_len, mesh, kv, attn["wk"],
                           "the cache")
    if attn is not None and cross_spec is not None:
        cross = _cache_block(cross_spec, cross_len, mesh, kv, attn["wk"],
                             "the cross cache")
    return Layout(mesh.get_group("model"), mesh_shape(mesh)["model"],
                  (h0, h1), heads_e is not None, kv, kv_read,
                  block(d, input_e, mesh), wi_e is not None,
                  block(V, vocab_e, mesh), vocab_e is not None, seq, moe,
                  ssm_of(cfg, mesh), cross)


_local = threading.local()


def current() -> Optional[Layout]:
    """The layout :func:`installed` made current, else None (off a mesh
    with ``model`` > 1: the model code runs whole)."""
    return getattr(_local, "layout", None)


@contextlib.contextmanager
def installed(lay: Optional[Layout]):
    """Make ``lay`` current for the enclosed model code."""
    prev = current()
    _local.layout = lay
    try:
        yield
    finally:
        _local.layout = prev


# ---------------------------------------------------------------------------
# cutting whole params into this rank's blocks
# ---------------------------------------------------------------------------

def _path(path) -> str:
    return "/".join(str(p) for p in path)


# a mamba mixer's leaves (and the decode cache's conv window): the
# dimension, counted from the last, that a rank holds by its SSM channel
# set, and which of the set's index kinds it takes there
_SSM_LEAVES = {"mixer/in_proj/kernel": (1, "in"), "mixer/conv_w": (1, "conv"),
               "mixer/conv_b": (1, "conv"), "mixer/out_proj/kernel": (2, "ch"),
               "mixer/out_norm/scale": (1, "ch"), "mixer/A_log": (1, "heads"),
               "mixer/D": (1, "heads"), "mixer/dt_bias": (1, "heads")}


def _ssm_leaf(name: str) -> Optional[Tuple[int, str]]:
    """``_SSM_LEAVES``' entry of a params path (or of the cache's
    ``conv``), else None."""
    if name == "conv":
        return 1, "conv"
    return next((v for k, v in _SSM_LEAVES.items() if name.endswith(k)),
                None)


def _ssm_cut(t: torch.Tensor, dim: int, kind: str, entry,
             ssm: SSM) -> torch.Tensor:
    """The rank's part of dimension ``dim`` of a mixer leaf or ``conv``
    window (a copy): ``in_proj``'s [z_r | x_r | B | C | dt_r] columns
    where the spec ``entry`` splits them (whole where the sanitizer
    dropped the split: the mixer takes its channels from the product), the
    conv's [x_r | B | C], ``out_proj``'s rows and ``out_norm``'s scale
    over its channels, ``A_log``/``D``/``dt_bias`` over its heads. A whole
    mixer (nothing split) keeps every leaf whole."""
    if not ssm.split or (kind == "in" and entry is None):
        return t
    if kind == "heads":
        return t.narrow(dim, ssm.heads[0], ssm.heads[1] - ssm.heads[0])
    idx = {"in": ssm.in_cols, "conv": ssm.conv_cols,
           "ch": ssm.channels}[kind]()
    return t.index_select(dim, idx.to(t.device))


def halves(name: str, swiglu: bool) -> bool:
    """Whether the leaf at path ``name`` is a SwiGLU ``wi`` (…, d, 2·ff)
    = [gate | up], which a rank holds as gate_r ‖ up_r."""
    return swiglu and name.endswith("ffn/wi/kernel")


def local_block(t: torch.Tensor, spec, mesh, paired: bool = False,
                skip: Optional[int] = None) -> torch.Tensor:
    """This rank's block of the whole ``t`` placed by ``spec`` (dimension
    ``skip`` left whole), a view where one range gives it. ``paired``: the
    last dimension holds two halves [a | b], each cut by its entry, giving
    a_r ‖ b_r (a copy): ``param_specs`` shards a SwiGLU ``wi``'s last
    dimension in two contiguous halves, which at ``model`` 2 would give one
    rank all of gate and the other all of up."""
    for dim, entry in enumerate(spec):
        if entry is None or dim == skip:
            continue
        if paired and dim == t.dim() - 1:
            half = t.shape[dim] // 2
            lo, hi = block(half, entry, mesh)
            t = torch.cat([t.narrow(dim, lo, hi - lo),
                           t.narrow(dim, half + lo, hi - lo)], dim)
        else:
            lo, hi = block(t.shape[dim], entry, mesh)
            t = t.narrow(dim, lo, hi - lo)
    return t


def gather_block(t: torch.Tensor, spec, mesh, paired: bool = False
                 ) -> torch.Tensor:
    """The whole tensor, on every rank, from each rank's block ``t``
    placed by ``spec`` (:func:`local_block`'s inverse, ``paired`` halves
    included): gathered over each splitting axis, the minor one first."""
    sizes = mesh_shape(mesh)
    for dim, entry in enumerate(spec):
        for a in reversed(axes_of(entry)):
            if sizes[a] == 1:
                continue
            parts = all_gather(t.contiguous(), mesh.get_group(a), sizes[a])
            if paired and dim == t.dim() - 1:
                t = torch.cat([p.movedim(0, dim).flatten(dim, dim + 1)
                               for p in parts.chunk(2, dim + 1)], dim)
            else:
                t = parts.movedim(0, dim).flatten(dim, dim + 1)
    return t


def _cut(path, t: torch.Tensor, spec, mesh, swiglu: bool,
         ssm: Optional[SSM] = None) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` placed by ``spec``, as a
    view where one range gives it (:func:`local_block`; a SwiGLU ``wi`` as
    gate_r ‖ up_r, a copy). A mamba mixer's leaves (and the decode cache's
    ``conv`` window) are cut on their channel dimension by the rank's
    :class:`SSM` channel set (:func:`_ssm_cut`), for the same reason as
    the SwiGLU halves: ``in_proj``'s contiguous block at ``model`` 2 would
    be all of z and part of x."""
    name = _path(path)
    leaf = _ssm_leaf(name) if ssm is not None else None
    sdim = None if leaf is None else t.dim() - leaf[0]
    t = local_block(t, spec, mesh, halves(name, swiglu), sdim)
    if leaf is not None:
        t = _ssm_cut(t, sdim, leaf[1], _entry(spec, sdim), ssm)
    return t


def param_spec_tree(params: Any, cfg, mesh, kind: str) -> Any:
    """The sanitized ``param_specs`` of ``kind`` for a params tree."""
    return SP.sanitize_tree(SP.param_specs(params, mesh, cfg=cfg, kind=kind),
                            params, mesh)


def shard_params(params: Any, cfg, mesh, kind: str) -> Any:
    """Whole params (from ``api.init`` or ``convert.lm_params_from_jax``,
    the same on every rank) cut into this rank's blocks, as the sanitized
    ``param_specs(cfg, mesh, kind=kind)`` place them: compact copies, so
    that the whole tree can be freed. Every leaf is cut by its path's
    spec: an enc-dec's ``enc_layers/attn/*`` and ``dec_layers/{self_attn,
    cross_attn}/*`` as any attention's, its GELU FFN's ``wi`` kernel and
    bias on ``mlp`` (``wo``'s bias whole: ``ffn_apply`` adds it once,
    after the sum), ``lm_head/kernel`` on ``vocab`` where the vocabulary
    divides the axis. ``wi`` of a SwiGLU FFN is cut per
    half (:func:`_cut`); an MoE's ``wi`` (E, 2, d, ff) holds gate and up
    on an axis of their own, which no spec cuts. ``kind`` "decode" keeps an MQA's ``wk``/``wv``
    whole (1.5 MB a layer at granite-20b's width); a prefill step takes
    its input-dim block as a view of them (:func:`fit`). A mamba mixer's
    leaves hold the rank's :class:`SSM` channels (:func:`_ssm_cut`,
    :func:`ssm_of`)."""
    specs = param_spec_tree(params, cfg, mesh, kind)
    swiglu, ssm = cfg.act == "swiglu", ssm_of(cfg, mesh)
    return tree_map_with_path(
        lambda p, t, s: _cut(p, t, s, mesh, swiglu, ssm).clone(
            memory_format=torch.contiguous_format), params, specs)


def fit(params: Any, shapes: Any, specs: Any, cfg, mesh, *,
        in_place: bool = False) -> Any:
    """Local params (or a cache) for a step whose kind places them by
    ``specs`` (the whole leaves' shapes ``shapes``): a leaf already of its
    local block's shape is kept, a whole leaf is cut to its block (a view
    where one range gives it: the decode layout's whole MQA ``wk``/``wv``
    at prefill; a copy of a mamba mixer's channels). Any other shape was
    laid out for another mesh or kind. With ``in_place`` (a cache the step
    updates) a whole leaf whose block is no view raises: the step's writes
    would miss it."""
    swiglu, ssm = cfg.act == "swiglu", ssm_of(cfg, mesh)

    def one(path, t, whole, spec):
        want = tuple(_cut(path, whole, spec, mesh, swiglu, ssm).shape)
        if tuple(t.shape) == want:
            return t
        if tuple(t.shape) == tuple(whole.shape):
            got = _cut(path, t, spec, mesh, swiglu, ssm)
            if in_place and got.untyped_storage().data_ptr() != \
                    t.untyped_storage().data_ptr():
                raise ValueError(
                    f"{_path(path)}: this rank's block of a whole cache leaf "
                    f"is a copy, which the step's in-place writes would "
                    f"miss; lay the cache out with launch.steps.mesh_cache")
            return got
        raise ValueError(f"{_path(path)} of shape {tuple(t.shape)}: the step "
                         f"takes this rank's block {want} (placed {spec}) or "
                         f"the whole {tuple(whole.shape)}")
    return tree_map_with_path(one, params, shapes, specs)


# ---------------------------------------------------------------------------
# the masks
# ---------------------------------------------------------------------------

def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 lay: Layout) -> torch.Tensor:
    """Rows of a vocabulary-sharded embedding: each rank looks up the ids
    in its ``[v0, v1)``, fills the others' rows with -0.0 and the ranks'
    rows are summed. Every row is one rank's row plus -0.0s, which is
    that row bit for bit (-0.0 is the identity of an IEEE sum, signed
    zeros included), so the rows equal the whole table's gather. Under
    grad the sum is :func:`reduce_from_model`'s (exact all the same): each
    rank's table gets the whole gather's gradient in its rows alone."""
    v0, v1 = lay.vocab
    local = ids - v0
    inside = (local >= 0) & (local < v1 - v0)
    rows = F.embedding(local.clamp(0, v1 - v0 - 1), table)
    rows = torch.where(inside[..., None], rows, -0.0)
    if _grad(rows):         # the masked rows' gradient is 0: the rank's
        return reduce_from_model(rows, lay.group, rows.dtype)   # rows only
    return all_reduce(rows, lay.group)


def merge_blocks(o: torch.Tensor, lse: torch.Tensor, lay: Layout
                 ) -> torch.Tensor:
    """The attention output over the whole sequence from each rank's
    output ``o`` (..., D) and log-sum-exp ``lse`` (...) over its block of
    it: ``Σ_r exp(lse_r − M) o_r / Σ_r exp(lse_r − M)``, M the ranks' max,
    in fp32, in o's dtype. A block over no position (lse −inf) weighs 0; so
    does every block where all are empty (o = 0), with no NaN."""
    m = all_reduce(lse.clone(), lay.group, "max")
    m = torch.where(torch.isfinite(m), m, 0.0)
    w = torch.exp(lse - m)[..., None]
    both = all_reduce(torch.cat([o.float() * w, w], -1), lay.group)
    num, den = both[..., :-1], both[..., -1:]
    return (num / den.clamp_min(math.ldexp(1.0, -126))).to(o.dtype)


def argmax(logits: torch.Tensor, group=None, size: int = 1,
           v0: int = 0) -> torch.Tensor:
    """The index of the max over the last axis of logits (..., V/size)
    whose vocabulary is sharded over ``group`` (this rank's block starting
    at ``v0``), as ``torch.argmax`` of the whole row gives it: the first
    index of the max. Each rank finds its max and first index (+ ``v0``);
    the ranks' pairs are gathered and the larger value wins, the lower
    rank (so the lower index) on a tie. Values compare exactly (fp32 holds
    bf16 and fp32 logits, and indices below 2^24, as they are)."""
    if size == 1:
        return logits.argmax(-1)
    idx = logits.argmax(-1)
    val = logits.gather(-1, idx[..., None])[..., 0].float()
    pairs = all_gather(torch.stack([val, (idx + v0).float()], -1), group,
                       size)                                # (m, ..., 2)
    best = pairs[..., 0].argmax(0, keepdim=True)    # the first max: low rank
    return pairs[..., 1].gather(0, best)[0].long()
