"""What every kernel wrapper checks around a launch: the ``out`` tensor it
was handed, and the error code the C entry point returns."""

from __future__ import annotations

import torch


def _span(t: torch.Tensor):
    """The byte addresses [start, end) that ``t``'s elements can touch."""
    extent = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    start = t.data_ptr()
    return start, start + (extent if t.numel() else 0) * t.element_size()


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    (a0, a1), (b0, b1) = _span(a), _span(b)
    return a0 < b1 and b0 < a1


def check_out(out: torch.Tensor, x: torch.Tensor, kernel: str) -> None:
    """``out`` must be a contiguous tensor of ``x``'s shape, dtype and
    device that does not overlap it: no kernel here runs in place, because
    neighbouring blocks read each other's rows."""
    if (out.shape != x.shape or out.dtype != x.dtype
            or out.device != x.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor of the input's "
                         "shape, dtype and device")
    if overlaps(out, x):
        raise ValueError(f"out must not overlap the input: {kernel} cannot "
                         f"run in place")


def check_cuda(x: torch.Tensor, kernel: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors, got device "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("the grid must be contiguous")


def raise_on_error(lib, err: int, kernel: str) -> None:
    if err:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} "
                           f"({lib.gol_error_string(err).decode()})")
