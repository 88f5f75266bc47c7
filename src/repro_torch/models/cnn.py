"""The paper's teacher/student CNN zoo: WideResNet-depth-width and
MobileNetV2 (CIFAR variant), functional PyTorch over parameter dicts with
explicit BN state.

Teachers: WRN-16-4 (CIFAR-10), WRN-28-10 (CIFAR-100).
Students: WRN-22-1 / WRN-16-1 / MobileNetV2 (CIFAR-10);
          WRN-16-3 / WRN-16-2 / WRN-22-1 (CIFAR-100).

Each student's final conv is sized to its knowledge partition, so its
pooled final features are its "portion" of the teacher's final conv.
``forward(p, cfg, x, train=False)`` takes NHWC images and returns
``(logits, final_features, new_params)`` like the JAX package's forward:
at eval the third element is ``p`` itself; with ``train=True`` batch norm
uses the batch's statistics and the third element is ``p`` with every BN
``mean``/``var`` moved (the same tree as the JAX package's). The parameter
dicts mirror the JAX package's, with OIHW conv kernels and no ``expand``
entry in an inverted-residual block that has no expansion.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.tree import tree_leaves

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# WideResNet
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WRNConfig:
    """WideResNet-depth-widen; ``final_channels`` resizes the last group."""
    name: str
    depth: int            # 6n+4
    widen: int
    n_classes: int
    final_channels: Optional[int] = None  # override last-group width (students)
    in_channels: int = 3

    @property
    def n_blocks(self) -> int:
        """Basic blocks per group."""
        if (self.depth - 4) % 6:
            raise ValueError(f"WRN depth must be 6n+4, got {self.depth}")
        return (self.depth - 4) // 6

    @property
    def widths(self) -> Tuple[int, int, int]:
        """Channel width of each of the three groups."""
        w = self.widen
        out = [16 * w, 32 * w, 64 * w]
        if self.final_channels:
            out[2] = self.final_channels
        return tuple(out)


def _basic_init(gen, cin, cout):
    p = {
        "bn1": L.batchnorm_init(cin),
        "conv1": L.conv2d_init(gen, cin, cout, 3),
        "bn2": L.batchnorm_init(cout),
        "conv2": L.conv2d_init(gen, cout, cout, 3),
    }
    if cin != cout:
        p["shortcut"] = L.conv2d_init(gen, cin, cout, 1)
    return p


def _bn(p, x, train):
    """Batch norm and its new state (``p`` itself at eval)."""
    if train:
        return L.batchnorm_train(p, x)
    return L.batchnorm_apply(p, x), p


def _basic_apply(p, x, *, stride, train=False):
    h, bn1 = _bn(p["bn1"], x, train)
    h = torch.relu(h)
    sc = x
    if "shortcut" in p:
        sc = L.conv2d_apply(p["shortcut"], h, stride=stride)
    elif stride != 1:
        sc = x[:, ::stride, ::stride, :]
    h = L.conv2d_apply(p["conv1"], h, stride=stride)
    h2, bn2 = _bn(p["bn2"], h, train)
    h = L.conv2d_apply(p["conv2"], torch.relu(h2))
    return h + sc, {**p, "bn1": bn1, "bn2": bn2}


def wrn_init(gen: torch.Generator, cfg: WRNConfig) -> Params:
    """Random WRN parameters drawn from ``gen``."""
    w1, w2, w3 = cfg.widths
    p: Params = {"conv0": L.conv2d_init(gen, cfg.in_channels, 16, 3)}
    cin = 16
    for gi, w in enumerate((w1, w2, w3)):
        for bi in range(cfg.n_blocks):
            p[f"g{gi}b{bi}"] = _basic_init(gen, cin, w)
            cin = w
    p["bn_out"] = L.batchnorm_init(cin)
    p["fc"] = L.dense_init(gen, cin, cfg.n_classes, use_bias=True)
    return p


def wrn_forward(p: Params, cfg: WRNConfig, x: torch.Tensor, *,
                train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """x: (B,32,32,3) → (logits, final_feats (B, C_final), new_params)."""
    newp = dict(p)
    h = L.conv2d_apply(p["conv0"], x)
    for gi in range(3):
        stride = 1 if gi == 0 else 2
        for bi in range(cfg.n_blocks):
            h, newp[f"g{gi}b{bi}"] = _basic_apply(
                p[f"g{gi}b{bi}"], h, stride=(stride if bi == 0 else 1),
                train=train)
    h, newp["bn_out"] = _bn(p["bn_out"], h, train)
    h = torch.relu(h)                # (B,8,8,C) final conv activations
    feats = h.mean(dim=(1, 2))       # average activity per filter
    logits = L.dense_apply(p["fc"], feats)
    return logits, feats, (newp if train else p)


# ---------------------------------------------------------------------------
# MobileNetV2 (CIFAR)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MBV2Config:
    """MobileNetV2 (CIFAR); ``final_channels`` sizes the last 1x1 conv."""
    name: str
    n_classes: int
    width_mult: float = 1.0
    final_channels: int = 320
    in_channels: int = 3


_MBV2_BLOCKS = [  # (expansion, out_ch, n, stride) — CIFAR variant
    (1, 16, 1, 1), (6, 24, 2, 1), (6, 32, 3, 2), (6, 64, 2, 2), (6, 96, 1, 1),
]


def _inv_res_init(gen, cin, cout, exp):
    mid = cin * exp
    p = {}
    if exp != 1:
        p["expand"] = L.conv2d_init(gen, cin, mid, 1)
    p.update({
        "bn0": L.batchnorm_init(mid),
        "dw": L.conv2d_init(gen, mid, mid, 3, groups=mid),
        "bn1": L.batchnorm_init(mid),
        "project": L.conv2d_init(gen, mid, cout, 1),
        "bn2": L.batchnorm_init(cout),
    })
    return p


def _inv_res_apply(p, x, *, stride, train=False):
    h = x
    newp = dict(p)
    if "expand" in p:
        h = L.conv2d_apply(p["expand"], h)
    h, newp["bn0"] = _bn(p["bn0"], h, train)
    h = torch.clamp(h, 0, 6)
    h = L.conv2d_apply(p["dw"], h, stride=stride, groups=h.shape[-1])
    h, newp["bn1"] = _bn(p["bn1"], h, train)
    h = torch.clamp(h, 0, 6)
    h = L.conv2d_apply(p["project"], h)
    h, newp["bn2"] = _bn(p["bn2"], h, train)
    if stride == 1 and x.shape[-1] == h.shape[-1]:
        h = h + x
    return h, newp


def mbv2_init(gen: torch.Generator, cfg: MBV2Config) -> Params:
    """Random MobileNetV2 parameters drawn from ``gen``."""
    p: Params = {"conv0": L.conv2d_init(gen, cfg.in_channels, 32, 3),
                 "bn0": L.batchnorm_init(32)}
    cin = 32
    idx = 0
    for exp, cout, n, _ in _MBV2_BLOCKS:
        cout = int(cout * cfg.width_mult)
        for _ in range(n):
            p[f"b{idx}"] = _inv_res_init(gen, cin, cout, exp)
            cin = cout
            idx += 1
    p["conv_last"] = L.conv2d_init(gen, cin, cfg.final_channels, 1)
    p["bn_last"] = L.batchnorm_init(cfg.final_channels)
    p["fc"] = L.dense_init(gen, cfg.final_channels, cfg.n_classes,
                           use_bias=True)
    return p


def mbv2_forward(p: Params, cfg: MBV2Config, x: torch.Tensor, *,
                 train: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """x: (B,32,32,3) → (logits, final_feats (B, final_channels),
    new_params)."""
    newp = dict(p)
    h = L.conv2d_apply(p["conv0"], x)
    h, newp["bn0"] = _bn(p["bn0"], h, train)
    h = torch.clamp(h, 0, 6)
    idx = 0
    for _, _, n, stride in _MBV2_BLOCKS:
        for i in range(n):
            h, newp[f"b{idx}"] = _inv_res_apply(
                p[f"b{idx}"], h, stride=(stride if i == 0 else 1),
                train=train)
            idx += 1
    h = L.conv2d_apply(p["conv_last"], h)
    h, newp["bn_last"] = _bn(p["bn_last"], h, train)
    h = torch.clamp(h, 0, 6)
    feats = h.mean(dim=(1, 2))
    logits = L.dense_apply(p["fc"], feats)
    return logits, feats, (newp if train else p)


# ---------------------------------------------------------------------------
# model zoo registry (paper §V-A)
# ---------------------------------------------------------------------------

def count_params(p: Params) -> int:
    """Number of scalars in a parameter tree."""
    return sum(t.numel() for t in tree_leaves(p))


def make_student(gen: torch.Generator, name: str, n_classes: int,
                 final_channels: int):
    """Instantiate a zoo student with its final conv sized to the partition.
    Returns ``(cfg, params, forward)``; params lie on the CPU."""
    if name.startswith("wrn"):
        _, d, w = name.split("-")
        cfg = WRNConfig(name, int(d), int(w), n_classes,
                        final_channels=final_channels)
        return cfg, wrn_init(gen, cfg), wrn_forward
    if name == "mobilenetv2":
        cfg = MBV2Config(name, n_classes, final_channels=final_channels)
        return cfg, mbv2_init(gen, cfg), mbv2_forward
    raise KeyError(name)


STUDENT_ZOO_C10 = ["wrn-22-1", "wrn-16-1", "mobilenetv2"]
STUDENT_ZOO_C100 = ["wrn-16-3", "wrn-16-2", "wrn-22-1"]
