"""Operand layouts for the kernels that read 16 bytes at a time, and the
card's size for their launch plans.

:func:`strides` gives a tensor's element strides as the kernels take them,
:func:`aligned` passes a view on unchanged when the kernel can address it
and otherwise makes a contiguous copy (a layout copy, not another kernel),
:func:`num_sms` gives the SMs a plan spreads its blocks over.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch


def strides(t: torch.Tensor) -> Tuple[int, ...]:
    """``t``'s element strides, 0 on axes of size 1 (whose stride is
    never used and may be anything)."""
    return tuple(0 if n == 1 else s for n, s in zip(t.shape, t.stride()))


def aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``t`` itself when its base and the byte stride of every axis but
    the last (axes of size 1 aside) are multiples of ``nbytes``, a power
    of two; else a contiguous copy (fresh allocations are aligned)."""
    e, bits = t.element_size(), t.data_ptr()
    for n, s in zip(t.shape[:-1], t.stride()[:-1]):
        if n != 1:
            bits |= s * e
    if bits % nbytes == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


@functools.cache
def num_sms(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
