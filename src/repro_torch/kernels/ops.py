"""Public kernel entry points of the port.

Each name launches a hand-written Hopper kernel on CUDA tensors and runs
its plain PyTorch version on CPU tensors (the tests' path). There is no
fallback from the card to the plain version: a kernel that cannot build or
launch raises.

Ported so far: :func:`quorum_aggregate` (``csrc/quorum_aggregate.cu``),
:func:`coded_decode` (``csrc/coded_decode.cu``), and the dense LM's
:func:`rmsnorm` (``csrc/rmsnorm.cu``), :func:`flash_attention`
(``csrc/flash_attention.cu``) and :func:`decode_attention`
(``csrc/decode_attention.cu``), the SSM's :func:`ssd_scan`
(``csrc/ssd_scan.cu``) and the MoE router's :func:`topk_gating`
(``csrc/topk_gating.cu``). The other Pallas kernels of
:mod:`repro.kernels` are queued in ROADMAP.md.
"""
from repro_torch.kernels.coded_decode import coded_decode, coded_decode_ref
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.quorum_aggregate import (quorum_aggregate,
                                                  quorum_aggregate_ref)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
from repro_torch.kernels.topk_gating import topk_gating, topk_gating_ref

__all__ = ["coded_decode", "coded_decode_ref", "decode_attention",
           "decode_attention_ref", "flash_attention", "flash_attention_ref",
           "quorum_aggregate", "quorum_aggregate_ref", "rmsnorm",
           "rmsnorm_ref", "ssd_scan", "ssd_scan_ref", "topk_gating",
           "topk_gating_ref"]
