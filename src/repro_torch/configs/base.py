"""Model/run configuration dataclasses and the --arch registry.

The JAX package's ``configs/base.py`` with PyTorch dtypes: ``param_dtype``
and ``compute_dtype`` are ``torch`` dtypes. ``attn_block_q`` and
``attn_block_kv`` are the TPU kernels' block sizes; they stay as fields so
that the two registries compare field by field, but the port's kernels
choose their own tiles.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture. Families: dense | moe | ssm | hybrid | vlm | encdec."""
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / jamba mamba layers)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (jamba): one attention layer per `attn_period` layers
    attn_period: int = 0
    moe_period: int = 0          # MoE FFN every `moe_period` layers (0 = per family)
    # enc-dec
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # positional scheme: rope | mrope | sincos | none
    pos: str = "rope"
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # norm: rmsnorm | layernorm
    norm: str = "rmsnorm"
    act: str = "swiglu"          # swiglu | gelu
    tie_embeddings: bool = False
    # modality frontend stub: inputs are precomputed embeddings, not token ids
    embed_inputs: bool = False
    # dtypes
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    # attention impl: auto | full | blocked (both exact; one kernel serves both)
    attn_impl: str = "auto"
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    # head padding: param layout rounds n_heads up to this (extra heads are
    # inert — their wo slice is zero). 0 = no padding. Grouped-major layout.
    pad_heads_to: int = 0
    # remat policy for train: none | dots | full
    remat: str = "dots"
    # long-context capable (sub-quadratic decode memory traffic per token)
    subquadratic: bool = False

    @property
    def head_dim(self) -> int:
        """Width of one attention head."""
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def heads_padded(self) -> int:
        """Query heads in the parameter layout (``pad_heads_to`` applied)."""
        return max(self.n_heads, self.pad_heads_to)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        """SSM heads."""
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    def with_(self, **kw) -> "ModelConfig":
        """A copy with the given fields replaced."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    """Add ``cfg`` to the registry under its name."""
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    """The registered config named ``name``."""
    import repro_torch.configs.archs  # noqa: F401  (populates registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> Dict[str, ModelConfig]:
    """Every registered config, by name."""
    import repro_torch.configs.archs  # noqa: F401
    return dict(_REGISTRY)


def applicable_shapes(cfg: ModelConfig) -> Dict[str, ShapeConfig]:
    """The assignment's skip rules: long_500k only for sub-quadratic archs."""
    out = {}
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.subquadratic:
            continue  # full-attention arch: skip
        out[s.name] = s
    return out
