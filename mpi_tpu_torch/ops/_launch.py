"""What every kernel wrapper checks around a launch: the grid's board axis,
a padded grid's real width, the ``out`` tensor it was handed, and the error
code the C entry point returns."""

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


MAX_BOARDS = 65535  # gridDim.z: boards one launch steps


def boards(x: torch.Tensor) -> tuple:
    """(B, H, N) of a (H, N) grid (B = 1) or a (B, H, N) batch of boards."""
    if x.dim() == 2:
        return (1, *x.shape)
    if x.dim() == 3 and 1 <= x.shape[0] <= MAX_BOARDS:
        return tuple(x.shape)
    raise ValueError(f"the grid must be (H, N) or (B, H, N) with 1 <= B <= "
                     f"{MAX_BOARDS}, got {tuple(x.shape)}")


def check_col_limit(col_limit, nw: int) -> None:
    """A padded grid's real width must end inside its last word:
    32 (NW - 1) < col_limit <= 32 NW (None: no pad)."""
    if col_limit is None:
        return
    if not 32 * (nw - 1) < col_limit <= 32 * nw:
        raise ValueError(f"col_limit must lie in ({32 * (nw - 1)}, "
                         f"{32 * nw}] for {nw} words a row, got {col_limit}")


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
