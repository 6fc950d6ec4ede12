"""The host side of a `ctypes` kernel launch, shared by every CUDA wrapper.

A wrapper calls its C entry point inside ``device_scope(index)`` with
``raw_stream(index)``.  Both avoid the costs of the obvious forms, which
are several µs each and matter where a kernel's device time is a few µs
(RMSNorm's 113 launches a forward, flash decode): entering
`torch.cuda.device` when the card is already current, and building a
`torch.cuda.Stream` object to read its handle.  During CUDA-graph
capture the current stream is the capture stream, so a launch on
``raw_stream`` is captured.
"""
from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()


def device_scope(index: int):
    """`torch.cuda.device(index)` unless card ``index`` is already current,
    else a null context."""
    if index == torch.cuda.current_device():
        return _NULL
    return torch.cuda.device(index)


def raw_stream(index: int) -> int:
    """The current CUDA stream of card ``index`` as an int (the raw
    ``cudaStream_t`` handle)."""
    return torch._C._cuda_getCurrentRawStream(index)
