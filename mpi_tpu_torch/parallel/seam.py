"""Periodic wrap-seam stitching for padded packed grids: the port's copy of
``mpi_tpu.parallel.seam``.

A periodic grid whose width C is not a whole number of 32-cell words runs
on the packed kernels at the padded width, its pad zeroed after every
generation (``col_limit``).  The kernel's column wrap then reads the pad,
which is zero, so only the cells whose dependence cone crosses the seam
are wrong: the ``d = k·r`` real columns on either side of it after a pass
of k generations.  Those are recomputed exactly on a thin dense band: the
4d real columns centred on the seam (``extract_band``), taken from the
pass's input before the kernel writes its output, stepped k generations
with the true periodic row wrap, whose middle 2d columns are then exact
(``evolve_band``, the trapezoid argument), and written over the kernel's
output by word masking (``stitch_band``).

On the device the band is stepped by kernel K2 in one launch
(:func:`step_band`): the (H, 4d) strip with a periodic boundary, whose
middle 2d columns after k generations depend only on the strip's own
columns, so the column wrap never reaches them and they equal
``evolve_band``'s.  Every piece takes a leading board axis, so a batch of
padded boards stitches in the same few launches as one board.
"""

from __future__ import annotations

import functools

import torch

from mpi_tpu_torch.config import WORD
from mpi_tpu_torch.models.rules import Rule
from mpi_tpu_torch.ops.cuda_stencil import cuda_dense_step
from mpi_tpu_torch.ops.stencil import apply_rule, counts_from_padded
from mpi_tpu_torch.utils.hashinit import i32_bits
from mpi_tpu_torch.utils.segmenting import segmented_evolve


def seam_serves(C: int, d: int) -> bool:
    """Whether the seam band can serve a pass of depth d = k·r on a real
    width C: the one routing predicate (``backends/cuda.py:plan_pad_width``)
    and construction check (``band_cols``).  d must fit the word mask
    (<= 31) and the 4d strip must not wrap onto itself (C >= 4d)."""
    return 1 <= d <= 31 and C >= 4 * d


def band_cols(C: int, d: int) -> int:
    """The band's width, 4d: the strip is real columns [C-2d, C) ++ [0, 2d),
    contiguous in periodic space; after k generations its middle 2d
    columns, real columns [C-d, C) ++ [0, d), are exact."""
    if not 1 <= d <= 31:
        raise ValueError(f"seam band depth must be in 1..31, got {d}")
    if not seam_serves(C, d):
        raise ValueError(
            f"seam stitching needs width >= {4 * d} (got {C}); tiny "
            f"grids keep the dense engine"
        )
    return 4 * d


@functools.lru_cache(maxsize=None)
def _columns(cols: tuple, device: str):
    """For the cell columns ``cols`` of a packed row: each one's word and
    bit as index tensors on ``device``, the distinct words, each column's
    slot among them, and each word's mask of the other columns (int32)."""
    words = sorted({c // WORD for c in cols})
    masks = [0] * len(words)
    for c in cols:
        masks[words.index(c // WORD)] |= 1 << (c % WORD)
    tensor = functools.partial(torch.tensor, dtype=torch.int64, device=device)
    return (tensor([c // WORD for c in cols]),
            tensor([c % WORD for c in cols]).to(torch.int32),
            tensor(words),
            tensor([words.index(c // WORD) for c in cols]),
            ~i32_bits(tensor(masks)))


def _strip(C: int, d: int) -> tuple:
    return tuple(range(C - 2 * d, C)) + tuple(range(2 * d))


def extract_band(packed: torch.Tensor, C: int, d: int) -> torch.Tensor:
    """(..., H, 4d) uint8 strip of real columns [C-2d, C) ++ [0, 2d) of
    the padded packed grid (..., H, NW): the real columns are padded
    columns [0, C), the pad is all trailing."""
    band_cols(C, d)
    word, bit, *_ = _columns(_strip(C, d), str(packed.device))
    return ((packed.index_select(-1, word) >> bit) & 1).to(torch.uint8)


def evolve_band(band: torch.Tensor, rule: Rule, k: int) -> torch.Tensor:
    """k generations of the dense strip (..., H, 4d): the exact periodic row
    wrap each generation and zero column fill, so the corruption from the
    column edges creeps r cells a generation inward and the middle 2d
    columns are exact after k generations.  The plain version of
    :func:`step_band`."""
    if band.dim() == 3:
        return torch.stack([evolve_band(b, rule, k) for b in band])
    r = rule.radius
    for _ in range(k):
        x = torch.cat([band[-r:], band, band[:r]], dim=0)
        x = torch.nn.functional.pad(x, (r, r))
        counts = counts_from_padded(x, r)
        band = apply_rule(x[r:-r, r:-r], counts, rule)
    return band


def step_band(band: torch.Tensor, rule: Rule, k: int) -> torch.Tensor:
    """k generations of the strip (..., H, 4d) by kernel K2 with a periodic
    boundary, one launch for every board: its middle 2d columns equal
    :func:`evolve_band`'s (the rest differ and are never read).  A strip
    narrower than K2's 256-column tile runs K2's narrow instance, which
    loads and steps only the columns it needs."""
    return cuda_dense_step(band, rule, "periodic", gens=k)


def _blend_cols(packed: torch.Tensor, dense: torch.Tensor, cols) -> None:
    """Overwrite the cell columns ``cols`` of the packed grid (..., H, NW),
    in place, with the columns of the (..., H, len(cols)) uint8 ``dense``
    block, by word masking: the words the columns touch are read, their
    bits at ``cols`` replaced, and written back."""
    _, bit, words, slot, keep = _columns(tuple(cols), str(packed.device))
    vals = torch.zeros(packed.shape[:-1] + (len(words),), dtype=torch.int32,
                       device=packed.device)
    # distinct bits of one word: the sum is their OR (int32 wraps at bit 31)
    vals.index_add_(-1, slot, dense.to(torch.int32) << bit)
    cur = packed.index_select(-1, words)
    packed.index_copy_(-1, words, (cur & keep) | vals)


def stitch_band(packed: torch.Tensor, band: torch.Tensor, C: int,
                d: int) -> torch.Tensor:
    """Write the band's exact middle over the seam of ``packed``, in place:
    strip columns [d, 2d) to real columns [C-d, C) and [2d, 3d) to
    [0, d).  Returns ``packed``."""
    _blend_cols(packed, band[..., d:3 * d],
                tuple(range(C - d, C)) + tuple(range(d)))
    return packed


def make_seam_stepper(inner, rule: Rule, C: int, K: int, band=step_band):
    """evolve(grid, steps, spare) -> (grid, spare) around the padded
    periodic pass ``inner(src, k, dst)`` (a packed kernel with
    ``col_limit = C``), as ``utils/segmenting.py:segmented_evolve`` drives
    it: each pass extracts the band from its input, launches the kernel
    into the spare buffer, steps the band and stitches its exact columns
    over the kernel's output.  The band is read before the kernel is
    launched: under the ping-pong the next pass overwrites this pass's
    input.  ``C`` is the real width, ``K`` the generations per pass;
    ``band(strip, rule, k)`` steps the strip (:func:`evolve_band` for the
    plain version of the whole pass)."""
    r = rule.radius
    band_cols(C, K * r)  # validate up front at the deepest pass

    def local(src, k, dst):
        d = k * r
        strip = extract_band(src, C, d)
        out = inner(src, k, dst)
        return stitch_band(out, band(strip, rule, k), C, d)

    return segmented_evolve(local, K)

