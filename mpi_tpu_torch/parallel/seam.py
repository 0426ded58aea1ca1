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

On a mesh (:func:`make_mesh_seam_stepper`) the strip's words lie in the
shards that hold them, the last and the first shard column when the tiles
are wider than the band: each pass gathers those word columns from every
row of shards into one thin packed block on the first shard's device,
extracts the strip from it, steps it by K2 and stitches the exact columns
back into the same shards.
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


@functools.lru_cache(maxsize=None)
def seam_plan(C: int, d: int, device: str):
    """The mesh seam's index plan for depth d: the global words the strip
    reads and the pass writes, the (word, bit) index tensors of the strip's
    columns in the block of those words, and the block columns the exact
    middle is stitched into."""
    words = sorted({c // WORD for c in _strip(C, d)})
    slot = {w: i for i, w in enumerate(words)}

    def cols(cells):
        return tuple(slot[c // WORD] * WORD + c % WORD for c in cells)

    word, bit, *_ = _columns(cols(_strip(C, d)), device)
    stitch = cols(tuple(range(C - d, C)) + tuple(range(d)))
    _columns(stitch, device)  # _blend_cols' index tensors, made now
    return tuple(words), word, bit, stitch


def _gather_words(shards, words, tile_words: int) -> torch.Tensor:
    """(H, len(words)) packed block of the global word columns ``words``,
    every row of shards stacked, on the first shard's device."""
    dev = shards[0][0].device
    return torch.cat([
        torch.cat([row[w // tile_words][:, w % tile_words:w % tile_words + 1]
                   .to(dev, non_blocking=True) for w in words], dim=1)
        for row in shards], dim=0)


def _scatter_words(shards, block: torch.Tensor, words,
                   tile_words: int) -> None:
    """Write the packed ``block`` of :func:`_gather_words` back into the
    shards' word columns, in place."""
    r0 = 0
    for row in shards:
        h = row[0].shape[0]
        for i, w in enumerate(words):
            dst = row[w // tile_words]
            dst[:, w % tile_words] = block[r0:r0 + h, i].to(
                dst.device, non_blocking=True)
        r0 += h


def make_mesh_seam_stepper(inner, rule: Rule, C: int, K: int,
                           band=step_band):
    """evolve(shards, steps) -> shards around the padded periodic mesh
    pass ``inner(shards, k)`` (``parallel/step.py``, built with
    ``seam_pad``): each pass gathers the strip's words from the shards
    before the pass, steps the strip by ``band`` (K2) and stitches its
    exact middle columns over the pass's output shards.  ``C`` is the real
    width, ``K`` the generations per pass."""
    from mpi_tpu_torch.parallel.step import mesh_evolve

    r = rule.radius
    band_cols(C, K * r)  # validate up front at the deepest pass

    def local(shards, k):
        d = k * r
        tw = shards[0][0].shape[1]
        words, word, bit, stitch = seam_plan(C, d,
                                              str(shards[0][0].device))
        src = _gather_words(shards, words, tw)
        strip = ((src.index_select(-1, word) >> bit) & 1).to(torch.uint8)
        out = inner(shards, k)
        block = _gather_words(out, words, tw)
        _blend_cols(block, band(strip, rule, k)[..., d:3 * d], stitch)
        _scatter_words(out, block, words, tw)
        return out

    return mesh_evolve(local, K)
