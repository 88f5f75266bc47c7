"""Operand layouts for the kernels that read 16 bytes at a time, the
card's size for their launch plans, and the launch's device and stream.

:func:`strides` gives a tensor's element strides as the kernels take them,
:func:`aligned` passes a view on unchanged when the kernel can address it
and otherwise makes a contiguous copy (a layout copy, not another kernel),
:func:`num_sms` gives the SMs a plan spreads its blocks over,
:func:`on_device` and :func:`stream_handle` give a launch its device and
stream with as little host work as a call allows, and :func:`no_backward`
stops a serving-only kernel, which has no backward, from handing autograd
a result it cannot differentiate. :func:`plain_route` and :func:`plain`
run a kernel's plain version, on CPU tensors and on ``meta`` tensors (which
compute nothing: ``repro_torch.launch.roofline`` counts a step on them),
and let a counting mode see each kernel as the one op it is on the card.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional, Tuple

import torch


# Set by a counting mode (``repro_torch.launch.roofline.count``) while it
# counts a step: called as ``COUNTER(name, fn, args, kwargs)`` in place of
# a kernel's plain version ``fn``, so that the kernel counts as one op.
COUNTER: Optional[Callable] = None


def plain_route(device: torch.device) -> bool:
    """Whether a wrapper takes its kernel's plain version on ``device``:
    on the CPU (the tests' path) and on ``meta`` (a count, nothing
    computed); a CUDA tensor launches the kernel."""
    return device.type in ("cpu", "meta")


def plain(name: str, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``, the plain version of kernel ``name``; under
    a counting mode the mode's :data:`COUNTER` runs it instead."""
    if COUNTER is None:
        return fn(*args, **kwargs)
    return COUNTER(name, fn, args, kwargs)


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


def no_backward(name: str, *tensors) -> None:
    """Raise where grad mode is on and an operand needs a gradient: the
    kernel ``name`` is one of the five that only serve (``quorum_aggregate``,
    ``coded_decode``, ``dequant_matmul``, ``coded_matmul``,
    ``decode_attention``), which no training path differentiates, and its
    output, filled through ctypes, would carry no ``grad_fn`` — a silent
    cut of the autograd graph. Serving runs under ``torch.no_grad()`` or
    on leaves that need no gradient, and is untouched."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward kernel: it only serves, and on the "
            f"card its output would carry no gradient. Call it under "
            f"torch.no_grad() or on tensors that need none")


@functools.cache
def num_sms(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def on_device(device: torch.device):
    """A context that makes ``device`` current for a launch: a null one when
    it already is (the usual case), since entering ``torch.cuda.device``
    costs host work on every call even when it changes nothing."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_handle(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream, without building a
    ``torch.cuda.Stream`` object per call."""
    return torch._C._cuda_getCurrentRawStream(device.index)
