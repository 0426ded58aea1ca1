"""What every kernel wrapper checks around a launch: the grid's board axis,
a padded grid's real width, the ``out`` tensor it was handed, and the error
code the C entry point returns; and the recorder of the launch-level
verifier (``mpi_tpu_torch/analysis/ir``), which every wrapper reports its
calls to while it is armed, and the halo exchange its ppermutes
(``record_exchange``)."""

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


class _Disarmed:
    """What :func:`recording` gives while no recorder is armed: nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def done(self, out: torch.Tensor) -> None:
        pass


_DISARMED = _Disarmed()
_recorder = None


def arm(recorder):
    """Arm ``recorder`` (None disarms); returns the one it replaces.  An
    armed recorder's ``launch(kernel, x, meta)`` is entered around every
    wrapper call, on the CPU's plain version as on the card's kernel, and
    told the call's ``out`` (``done``) once it has been written."""
    global _recorder
    previous, _recorder = _recorder, recorder
    return previous


def recording(kernel: str, x: torch.Tensor, **meta):
    """The context a wrapper runs its call in: the armed recorder's record
    of the call of ``kernel`` on ``x`` with ``meta`` (rule, boundary, gens,
    col_limit), or a no-op when none is armed."""
    rec = _recorder
    return _DISARMED if rec is None else rec.launch(kernel, x, meta)


def record_exchange(axis_name: str, pairs, slab_shape) -> None:
    """Tell the armed recorder of one ppermute of a halo exchange
    (``parallel/halo.py``): the mesh axis, its (src, dst) pairs of axis
    positions and the shape of the slab each source sends.  A no-op when
    none is armed."""
    rec = _recorder
    if rec is not None:
        rec.exchange(axis_name, tuple(pairs), tuple(slab_shape))
