"""The port's roofline (``repro_torch.launch.roofline``) against the JAX
package's.

At the four tiny cells (llama3.2-1b and mamba2-130m, ``prefill_32k`` and
``train_4k`` at the dry run's tiny shapes) the port counts its step on
``meta`` tensors. Its FLOPs must equal the analytic count of what the step
runs exactly: the products (projections, the head, the SSM's depthwise
conv) and each hand-written kernel by its bound's formula. The JAX
package's ``RL.analyze`` of the same step jitted without a mesh is
computed live; the products both run (every HLO dot and convolution
outside attention, the SSD scan and the conv's weight gradient) must agree
within 1% (the port's conv computes S + K - 1 positions where XLA's
computes S: 0.6% of the conv, at most 1e-3 of a cell). The gap left is
attention and the scan: the reference's HLO counts the full S x S blocks
(and, in training, remat's recomputed forward), the port the kernels'
causal pairs (``PERF.md`` explains each cell's gap op by op).
"""
import functools
import math
import re

import jax
import pytest

from repro.configs.archs import tiny_version as j_tiny
from repro.configs.base import get_config as j_get_config
from repro.core.hwspec import HardwareSpec as JHardwareSpec
from repro.launch import dryrun as JDR
from repro.launch import roofline as JRL
from repro.launch import steps as JST
from repro_torch.configs.archs import tiny_version
from repro_torch.configs.base import get_config
from repro_torch.core.hwspec import HardwareSpec
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as ST

CELLS = [(a, s) for a in ("llama3.2-1b", "mamba2-130m")
         for s in ("prefill_32k", "train_4k")]
PRODUCTS = ("mm", "bmm", "addmm", "baddbmm", "convolution",
            "convolution_backward")
# the HLO dots the port runs as kernels (attention, the SSD scan) or not at
# all (the weight gradient of the depthwise conv, a dense conv in XLA)
KERNEL_DOTS = re.compile(r"bqkgd,bskd|bkgqs,bskd|bqsh,bshp|bqn,bhpn|"
                         r"bsn,bshp|bqn,bsn")


def _port(arch, shape_name):
    cfg = tiny_version(get_config(arch))
    shape = DR.TINY_SHAPES[shape_name]
    args = ST.tensors_of(ST.input_specs(cfg, shape, None))
    counts = []
    roof = RL.analyze(ST.step_fn_for(cfg, shape), *args, counts=counts)
    return cfg, shape, roof, counts[0]


@functools.cache
def _jax(arch, shape_name):
    """(HLO FLOPs, FLOPs of the dots and convolutions both packages run as
    products) of the reference's step jitted with no mesh."""
    cfg = j_tiny(j_get_config(arch))
    shape = JDR.TINY_SHAPES[shape_name]
    compiled = jax.jit(JST.step_fn_for(cfg, shape)).lower(
        *JST.input_specs(cfg, shape, None)).compile()
    total = JRL.analyze(compiled, 1).flops
    mod = JRL.HloModule(compiled.as_text())
    shared = [0.0]

    def walk(comp, mult, stack):
        if comp in stack or comp not in mod.comp_order:
            return
        stack = stack + (comp,)
        for inst in mod.comp_order[comp]:
            if inst.opcode == "while":
                body = re.search(r"body=%?([\w\.\-]+)", inst.line)
                cond = re.search(r"condition=%?([\w\.\-]+)", inst.line)
                trips = mod.trip_count(cond.group(1)) if cond else 1
                walk(body.group(1), mult * max(trips, 1), stack)
            elif inst.opcode in ("call", "fusion"):
                sub = re.search(r"(?:to_apply|calls)=%?([\w\.\-]+)",
                                inst.line)
                if sub:
                    walk(sub.group(1), mult, stack)
            elif inst.opcode in ("dot", "convolution"):
                name = re.search(r'op_name="([^"]+)"', inst.line)
                name = name.group(1) if name else ""
                if KERNEL_DOTS.search(name) or (
                        inst.opcode == "convolution"
                        and "conv_general_dilated" not in name):
                    continue
                f = (mod.dot_flops if inst.opcode == "dot"
                     else mod.conv_flops)(comp, inst)
                shared[0] += f * mult
    walk(mod.entry, 1.0, ())
    return total, shared[0]


def _pairs(S):
    return S * (S + 1) // 2


def _analytic(cfg, shape):
    """(products, kernels) FLOPs of the port's step, from the config."""
    B, S, kind = shape.global_batch, shape.seq_len, shape.kind
    T, d, L, V = B * S, cfg.d_model, cfg.n_layers, cfg.vocab
    train = kind == "train"
    if cfg.family == "dense":
        hd, H, KV, ff = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
        layer = 2 * T * d * (2 * H * hd + 2 * KV * hd) + 3 * 2 * T * d * ff
        head = 2 * (T if train else B) * d * V
        flash = 4 * hd * B * H * _pairs(S)
        norms = (2 * L + 1) * 4 * T * d
        if train:
            return (3 * (L * layer + head),
                    L * flash * (1 + 10 / 4) + norms * (1 + 10 / 4))
        return L * layer + head, L * flash + norms
    # ssm (mamba2): in_proj, the depthwise conv over S + K - 1 positions,
    # the chunked scan, the gated norm, out_proj
    d_in = cfg.ssm_expand * d
    H, P, N, K = d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_conv
    conv_ch = d_in + 2 * N
    d_proj = 2 * d_in + 2 * N + H
    conv = 2 * B * (S + K - 1) * conv_ch * K
    layer = 2 * T * d * d_proj + 2 * T * d_in * d
    Q = min(cfg.ssm_chunk, S)
    nc, pq = S // Q, _pairs(Q)
    scan = nc * (B * pq * 2 * N + B * H * (pq * 2 * P + 4 * Q * P * N))
    scan_bwd = nc * (B * N * pq * 6 + B * H * (pq * 4 * P + 10 * Q * P * N))
    head = 2 * (T if train else B) * d * V
    if train:
        norms = L * 4 * T * (d + d_in) + 4 * T * d
        return (3 * (L * layer + head) + 3 * L * conv,
                L * (scan + scan_bwd) + norms * (1 + 10 / 4))
    norms = L * 4 * T * (d + d_in) + 4 * B * d
    return L * (layer + conv) + head, L * scan + norms


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_count_equals_the_analytic_flops(arch, shape_name):
    cfg, shape, roof, counts = _port(arch, shape_name)
    products, kernels = _analytic(cfg, shape)
    got = sum(v[1] for k, v in counts.by_op.items() if k in PRODUCTS)
    assert got == products
    assert roof.flops == products + kernels
    assert set(counts.by_op) & {"flash_attention", "ssd_scan"}
    # the kernels are single ops: their plain versions' products unseen
    assert counts.by_op.get("bmm", [0])[0] <= 1


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_products_match_the_jax_hlo_dots(arch, shape_name):
    cfg, shape, roof, counts = _port(arch, shape_name)
    jax_total, jax_shared = _jax(arch, shape_name)
    got = sum(v[1] for k, v in counts.by_op.items() if k in PRODUCTS)
    assert math.isclose(got, jax_shared, rel_tol=1e-2), (got, jax_shared)
    assert jax_total > 0 and roof.flops > 0
    print(f"{arch} {shape_name}: port {roof.flops:.4e} (products "
          f"{got:.4e}), JAX HLO {jax_total:.4e} (products {jax_shared:.4e})")


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_active_params_and_model_flops_match_jax(arch, shape_name):
    cfg = tiny_version(get_config(arch))
    jcfg = j_tiny(j_get_config(arch))
    assert DR.active_param_fraction_tree(cfg) == \
        JDR.active_param_fraction_tree(jcfg)
    total, active = DR.active_param_fraction_tree(cfg)
    shape = DR.TINY_SHAPES[shape_name]
    tokens = shape.global_batch * shape.seq_len
    for kind in ("train", "fwd"):
        assert RL.model_flops(total, int(active), tokens, kind) == \
            JRL.model_flops(total, int(active), tokens, kind)


@pytest.mark.parametrize("terms", [(1e12, 5e9, 0.0), (1e9, 5e12, 1e9),
                                   (1e10, 1e9, 9e12)])
def test_roofline_properties_match_jax(terms):
    flops, nbytes, wire = terms
    spec = dict(name="card", peak_flops=989e12, hbm_bw=3.35e12,
                link_bw=450e9, latency_floor=2e-6)
    port = RL.Roofline(flops, nbytes, wire, {"all-reduce": 2}, 4, 1.0, 2.0,
                       3.0, HardwareSpec(**spec))
    ref = JRL.Roofline(flops, nbytes, wire, {"all-reduce": 2}, 4, 1.0, 2.0,
                       3.0, JHardwareSpec(**spec))
    for prop in ("compute_s", "memory_s", "memory_bf16_s", "collective_s",
                 "dominant", "bound_s"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.to_dict() == ref.to_dict()
    other = HardwareSpec(name="other", peak_flops=1e12)
    assert port.with_spec(other).compute_s == ref.with_spec(
        JHardwareSpec(name="other", peak_flops=1e12)).compute_s


def test_h100_spec_is_the_datasheet_peaks():
    assert (RL.H100_SXM.peak_flops, RL.H100_SXM.hbm_bw, RL.H100_SXM.link_bw,
            RL.H100_SXM.latency_floor) == (989e12, 3.35e12, 450e9, 0.0)
    assert RL.H100_SXM_FP32_FLOPS == 67e12
    assert RL.Roofline(1, 1, 0, {}, 1).spec is RL.H100_SXM


@pytest.mark.parametrize("kind,group", [("all-reduce", 4), ("all-gather", 8),
                                        ("reduce-scatter", 16),
                                        ("all-to-all", 2),
                                        ("collective-permute", 4)])
def test_wire_bytes_use_the_reference_ring_factors(kind, group):
    """One collective in an HLO module: the reference's parser's wire bytes
    equal :func:`wire_bytes` of its result size."""
    ids = ",".join(str(i) for i in range(group))
    hlo = ("ENTRY %main (p: f32[1024]) -> f32[1024] {\n"
           "  %p = f32[1024]{0} parameter(0)\n"
           f"  %c = f32[1024]{{0}} {kind}(f32[1024]{{0}} %p), "
           f"replica_groups={{{{{ids}}}}}\n"
           "}\n")
    tot = JRL.analyze_hlo(hlo, group)
    assert tot.wire_bytes == pytest.approx(RL.wire_bytes(kind, 4096, group))


def test_a_kernel_counts_as_one_op_by_its_bound():
    import torch
    q = torch.empty((2, 2, 3, 16, 8), device="meta")
    k = torch.empty((2, 2, 16, 8), device="meta")
    with RL.count() as c:
        o = ops.flash_attention(q, k, k, causal=True)
    assert o.device.type == "meta"
    assert list(c.by_op) == ["flash_attention"]
    assert c.flops == 4 * 8 * 2 * 2 * 3 * _pairs(16)
    assert c.bytes == (2 * q.numel() + 2 * k.numel()) * 4
    x = torch.empty((5, 64), device="meta")
    with RL.count() as c:
        ops.rmsnorm(x, torch.empty(64, device="meta"))
    assert c.by_op == {"rmsnorm": [1, 4.0 * 5 * 64, (2 * 5 * 64 + 64) * 4]}


def _rotate_bytes(T, N, hd):
    """``layers.rotate`` of (T, N, hd) bf16 by an fp32 table of T rows:
    the fp32 cast, four products with cos/sin (each reads its table),
    the sub, the add, the cat and the cast back."""
    Q = T * N * hd // 2                       # elements of one half
    return (6 * 2 * Q + 4 * (8 * Q + 4 * T * hd // 2) + 12 * Q + 12 * Q
            + 16 * Q + 12 * Q)


def test_one_dense_layer_forward_moves_its_hand_count_of_bytes():
    """llama3.2-1b's block at full width (bf16, 2 x 16 tokens): every op's
    inputs read once and outputs written once, views free, each kernel one
    op; summed by hand from the block's code."""
    import torch
    from repro_torch.models import api
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cfg = get_config("llama3.2-1b")
    lay = tree_map(lambda t: t[0], api.init_meta(cfg)["layers"])
    B, S = 2, 16
    x = torch.empty((B, S, cfg.d_model), dtype=cfg.compute_dtype,
                    device="meta")
    rope = T.rope_table(cfg, torch.empty((B, S), dtype=torch.int32,
                                         device="meta"))
    with RL.count() as c:
        T.block_apply(lay, cfg, x, rope)
    d, H, KV, hd, ff = (cfg.d_model, cfg.heads_padded, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    n = B * S
    norm = 2 * n * d + d
    attn = (norm + (n * d + d * H * hd + n * H * hd)          # q
            + 2 * (n * d + d * KV * hd + n * KV * hd)         # k, v
            + (2 * n * H * hd + 2 * n * KV * hd)              # flash
            + 2 * n * H * hd                                  # o's copy
            + (n * H * hd + H * hd * d + n * d)               # out proj
            + 3 * n * d) * 2 + _rotate_bytes(n, H, hd) + _rotate_bytes(
                n, KV, hd)
    ffn = (norm + (n * d + 2 * d * ff + 2 * n * ff)           # gate|up
           + 2 * n * ff + 3 * n * ff                          # silu, mul
           + (n * ff + ff * d + n * d) + 3 * n * d) * 2       # down, add
    assert c.bytes == attn + ffn


def test_adamw_moves_174_bytes_per_element_of_a_leaf():
    """One leaf's update (bf16 param, fp32 gradient, master and moments):
    its norm (square 8, sum 4), the clip's scale 8, the moments 52, the
    step 82, the copy into the param 6 — the scalar schedule's ops aside,
    which do not grow with the leaf."""
    import torch
    from repro_torch.optim import adamw

    def bytes_for(n):
        p = {"w": torch.empty(n, dtype=torch.bfloat16, device="meta")}
        g = {"w": torch.empty(n, dtype=torch.float32, device="meta")}
        cfg = adamw.AdamWConfig()
        state = adamw.init(cfg, p)
        with RL.count() as c:
            adamw.apply_updates(cfg, p, g, state)
        return c.bytes

    small, large = bytes_for(1024), bytes_for(4096)
    assert (large - small) == 174 * (4096 - 1024)
    assert small - 174 * 1024 < 1024


def test_model_sharding_divides_products_reading_a_sharded_weight():
    """With ``model`` = 4: the product reading the sharded weight, and the
    weight's cast, count a quarter; the product reading only activations
    (a weight gradient's) and the elementwise op count whole."""
    import torch
    w = torch.empty((64, 32), dtype=torch.float32, device="meta")
    x = torch.empty((8, 64), dtype=torch.bfloat16, device="meta")
    with RL.count(sharded=[w], model=4) as c:
        y = x @ w.to(torch.bfloat16)
        (x.t() @ y).relu()
    assert c.by_op["_to_copy"] == [1, 0.0, 64 * 32 * 6 / 4]
    assert c.by_op["mm"][1] == 2 * 8 * 64 * 32 / 4 + 2 * 64 * 8 * 32
    assert c.by_op["relu"] == [1, 0.0, 2 * 64 * 32 * 2]
