"""Public kernel entry points of the port.

Each name launches a hand-written Hopper kernel on CUDA tensors and runs
its plain PyTorch version on CPU tensors (the tests' path). There is no
fallback from the card to the plain version: a kernel that cannot build or
launch raises.

All nine Pallas kernels of :mod:`repro.kernels` are ported: the CNN
serving path's :func:`quorum_aggregate` (``csrc/quorum_aggregate.cu``) and
:func:`coded_decode` (``csrc/coded_decode.cu``), the dense LM's
:func:`rmsnorm` (``csrc/rmsnorm.cu``), :func:`flash_attention`
(``csrc/flash_attention.cu``) and :func:`decode_attention`
(``csrc/decode_attention.cu``), the SSM's :func:`ssd_scan`
(``csrc/ssd_scan.cu``), the MoE router's :func:`topk_gating`
(``csrc/topk_gating.cu``), the weight-only int8 :func:`dequant_matmul`
(``csrc/dequant_matmul.cu``) and compute coding's :func:`coded_matmul`
(``csrc/coded_matmul.cu``).

``quorum_aggregate``, ``coded_decode`` and ``dequant_matmul`` take
``block_batch=None`` (and ``block_n=None``): an unpinned tile resolves
through the shape-keyed tuning table of :mod:`repro_torch.kernels.autotune`,
falling back to the defaults on a miss.

Training differentiates four of them: ``rmsnorm`` and ``flash_attention``
(every LM family), ``ssd_scan`` (the ssm and hybrid families) and
``topk_gating`` (the moe and hybrid families' routers) are
``torch.autograd.Function``s where a gradient is needed, whose backwards
:func:`rmsnorm_bwd` (``csrc/rmsnorm_bwd.cu``), :func:`flash_attention_bwd`
(``csrc/flash_attention_bwd.cu``), :func:`ssd_scan_bwd`
(``csrc/ssd_scan_bwd.cu``) and :func:`topk_gating_bwd`
(``csrc/topk_gating_bwd.cu``) are hand-written too; they replace no TPU
kernel (the JAX package trains through autodiff of plain ``jnp``). The five
others only serve: they have no backward and raise on the card when grad
mode is on and an operand needs a gradient.
"""
from repro_torch.kernels.coded_decode import coded_decode, coded_decode_ref
from repro_torch.kernels.coded_matmul import coded_matmul, coded_matmul_ref
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.dequant_matmul import (dequant_matmul,
                                                dequant_matmul_ref)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.quorum_aggregate import (quorum_aggregate,
                                                  quorum_aggregate_ref)
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd,
                                         rmsnorm_bwd_ref, rmsnorm_ref)
from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_bwd,
                                          ssd_scan_bwd_ref, ssd_scan_ref)
from repro_torch.kernels.topk_gating import (topk_gating, topk_gating_bwd,
                                             topk_gating_bwd_ref,
                                             topk_gating_ref)

__all__ = ["coded_decode", "coded_decode_ref", "coded_matmul",
           "coded_matmul_ref", "decode_attention", "decode_attention_ref",
           "dequant_matmul", "dequant_matmul_ref", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_ref",
           "flash_attention_ref", "quorum_aggregate", "quorum_aggregate_ref",
           "rmsnorm", "rmsnorm_bwd", "rmsnorm_bwd_ref", "rmsnorm_ref",
           "ssd_scan", "ssd_scan_bwd", "ssd_scan_bwd_ref", "ssd_scan_ref",
           "topk_gating", "topk_gating_bwd", "topk_gating_bwd_ref",
           "topk_gating_ref"]
