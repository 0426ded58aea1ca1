"""Periodic wrap-seam stitching for padded packed grids: the port's copy of
``mpi_tpu.parallel.seam``.

A periodic grid whose width C is not a whole number of 32-cell words runs
on the packed kernels at the padded width, its pad zeroed after every
generation (``col_limit``).  The kernel's column wrap then reads the pad,
which is zero, so only the cells whose dependence cone crosses the seam
are wrong: the ``d = k·r`` real columns on either side of it after a pass
of k generations.  Those are recomputed exactly from a thin strip: the
4d real columns centred on the seam (``extract_band``), taken from the
pass's input, stepped k generations with the true periodic row wrap,
whose middle 2d columns are then exact (``evolve_band``, the trapezoid
argument), and written over the kernel's output by word masking
(``stitch_band``).

Every padded periodic pass does this in one call of :func:`fused_band`
after its kernel: on a CUDA tensor one launch of ``seam_band_kernel``
(``csrc/stencil.cu``) on the same stream, which reads the strip from the
pass's packed input (the pass does not write it), steps it on chip (as
bits at radius 1, as K2's byte cells beyond) with the zero column fill of
``evolve_band``, and writes the exact columns into the pass's output; on
the CPU the three pieces above, its plain version.  A leading board axis
rides along, so a batch of padded boards stitches in the same launch as
one board.

On a mesh (:func:`make_mesh_seam_stepper`) the strip's words lie in the
shards that hold them, the last and the first shard column when the tiles
are wider than the band: each pass gathers those word columns from every
row of shards into one thin packed block on the first shard's device,
before the pass and again after it, calls :func:`fused_band` on the two
blocks at the block's own real width (:func:`seam_block`), and scatters
the stitched words back into the same shards.  Under a process group
those shards may sit on several ranks: the strip's words travel to one
rank, the owner of shard (0, mj-1), which runs the band and sends the
stitched words back to their owners (:func:`_gather_words_group`,
:func:`_scatter_words_group`).
"""

from __future__ import annotations

import contextlib
import functools

import torch

from mpi_tpu_torch.config import WORD
from mpi_tpu_torch.models.rules import Rule
from mpi_tpu_torch.ops._launch import (
    boards, check_cuda, check_out, raise_on_error, recording,
)
from mpi_tpu_torch.ops.cuda_stencil import rule_table
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
    wrap each generation (any H >= 1: rows wrap modulo H) and zero column
    fill, so the corruption from the column edges creeps r cells a
    generation inward and the middle 2d columns are exact after k
    generations.  The plain version of :func:`fused_band`'s strip."""
    if band.dim() == 3:
        return torch.stack([evolve_band(b, rule, k) for b in band])
    r = rule.radius
    H = band.shape[0]
    wrapped = torch.arange(-r, H + r, device=band.device) % H
    for _ in range(k):
        x = torch.nn.functional.pad(band.index_select(0, wrapped), (r, r))
        counts = counts_from_padded(x, r)
        band = apply_rule(x[r:-r, r:-r], counts, rule)
    return band


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


# the context a span site enters while obs is off
_OFF = contextlib.nullcontext()


def fused_band(src: torch.Tensor, out: torch.Tensor, rule: Rule, C: int,
               k: int, handle=None) -> torch.Tensor:
    """The seam band of a pass of ``k`` generations in one launch of
    ``seam_band_kernel``: ``src`` is the pass's packed input (H, NW), or a
    (B, H, NW) batch, with real width ``C`` (on a mesh the block of the
    strip's words at its own width, :func:`seam_block`); ``out`` its
    output, which the pass has written.  Real columns [C-d, C) and [0, d),
    d = k·r, of ``out`` are rewritten, in place, with the strip of ``src``
    stepped k generations; no other bit of ``out`` changes.  Returns
    ``out``.

    On a CUDA tensor it launches the kernel on the current stream after
    the pass (``src`` must not be written in between); on the CPU it runs
    the plain version, :func:`stitch_band` of :func:`evolve_band` of
    :func:`extract_band`, its extraction and its stitch in the spans
    ``seam.extract`` and ``seam.stitch`` of the obs ``handle`` when one is
    given.  ``fused_band.launches`` counts kernel launches."""
    d = k * rule.radius
    band_cols(C, d)
    if src.dtype != torch.int32:
        raise TypeError(f"packed grid must be int32 words, got {src.dtype}")
    B, H, NW = boards(src)
    if C > NW * WORD:
        raise ValueError(f"real width {C} exceeds the {NW * WORD} cells of "
                         f"{NW} words")
    check_out(out, src, "the seam band")
    with recording("seam", src, rule=rule, boundary="periodic", gens=k,
                   col_limit=C) as rec:
        if src.device.type == "cpu":
            with _OFF if handle is None else handle.span("seam.extract"):
                strip = extract_band(src, C, d)
            strip = evolve_band(strip, rule, k)
            with _OFF if handle is None else handle.span("seam.stitch"):
                stitch_band(out, strip, C, d)
        else:
            check_cuda(src, "the seam band")
            from mpi_tpu_torch.ops import _build

            lib = _build.load_library()
            with torch.cuda.device(src.device):
                stream = torch.cuda.current_stream(src.device).cuda_stream
                err = lib.gol_seam_band(src.data_ptr(), out.data_ptr(), B, H,
                                        NW, C, rule.radius, k,
                                        rule_table(rule), stream)
            raise_on_error(lib, err, "the seam band")
            fused_band.launches += 1
        rec.done(out)
    return out


fused_band.launches = 0


def make_seam_stepper(inner, rule: Rule, C: int, K: int, obs=None):
    """evolve(grid, steps, spare) -> (grid, spare) around the padded
    periodic pass ``inner(src, k, dst)`` (a packed kernel with
    ``col_limit = C``), as ``utils/segmenting.py:segmented_evolve`` drives
    it.  ``C`` is the real width, ``K`` the generations per pass.  Each
    pass launches the kernel into the spare buffer and then
    :func:`fused_band`, which reads the strip from the pass's input and
    stitches its exact columns into the kernel's output.

    ``obs``: the getter of an engine's obs handle (``segmented_evolve``'s);
    while it gives one, the band runs in the span ``seam.band`` of the
    pass's ``engine.pass``, and on the CPU its plain version's extraction
    and stitch in ``seam.extract`` and ``seam.stitch`` inside it."""
    band_cols(C, K * rule.radius)  # validate up front at the deepest pass

    def local(src, k, dst):
        handle = None if obs is None else obs()
        out = inner(src, k, dst)
        with _OFF if handle is None else handle.span("seam.band"):
            fused_band(src, out, rule, C, k, handle)
        return out

    return segmented_evolve(local, K, obs)


def strip_words(C: int, d: int) -> tuple:
    """The global words the strip of depth d reads and the pass writes."""
    return tuple(sorted({c // WORD for c in _strip(C, d)}))


@functools.lru_cache(maxsize=None)
def seam_block(C: int, d: int) -> tuple:
    """(words, width): the mesh seam's block for depth d, the packed block
    of the global words :func:`strip_words` side by side, and the real
    width at which :func:`fused_band` finds the strip in it.  The low run
    of words, which holds real columns [0, 2d), keeps its columns; the
    high run, which holds [C-2d, C) and ends at the last word, follows it,
    every column moved down by 32 x (its word - its slot), the same for
    the whole run: so the block is a grid of real width C less that shift,
    with 4d <= width <= 32 x len(words).  Where the two runs touch or
    overlap the block is the grid's first words and the width is C."""
    words = strip_words(C, d)
    return words, C - WORD * (words[-1] - (len(words) - 1))


def _gather_words(shards, words, tile_words: int) -> torch.Tensor:
    """(H, len(words)) packed block of the global word columns ``words``,
    every row of shards stacked, on the first shard's device; (B, H,
    len(words)) for shards that carry a board axis."""
    dev = shards[0][0].device
    return torch.cat([
        torch.cat([row[w // tile_words][..., w % tile_words:
                                        w % tile_words + 1]
                   .to(dev, non_blocking=True) for w in words], dim=-1)
        for row in shards], dim=-2)


def _scatter_words(shards, block: torch.Tensor, words,
                   tile_words: int) -> None:
    """Write the packed ``block`` of :func:`_gather_words` back into the
    shards' word columns, in place."""
    r0 = 0
    for row in shards:
        h = row[0].shape[-2]
        for i, w in enumerate(words):
            dst = row[w // tile_words]
            dst[..., w % tile_words] = block[..., r0:r0 + h, i].to(
                dst.device, non_blocking=True)
        r0 += h


# the seam's messages: tags past every halo block's
# (``parallel/halo.py:_remote_blocks``), one range a step of the pass
SEAM_TAG = 1 << 24


def _word_pieces(words, tile_words: int):
    """{shard column: (its local word columns, the block columns they
    fill)} of the global word columns ``words``, each a tuple."""
    pieces = {}
    for slot, w in enumerate(words):
        cols, slots = pieces.setdefault(w // tile_words, ([], []))
        cols.append(w % tile_words)
        slots.append(slot)
    return {jj: (tuple(c), tuple(s)) for jj, (c, s) in pieces.items()}


@functools.lru_cache(maxsize=None)
def _index(columns: tuple, device: str) -> torch.Tensor:
    """``columns`` as an index tensor on ``device``, made once (a step
    then makes no host-to-device copy)."""
    return torch.tensor(columns, dtype=torch.int64, device=device)


def _gather_words_group(shards, mesh, words, tile_words: int, root: int,
                        tag0: int):
    """:func:`_gather_words` across ranks: every rank sends its shards'
    pieces of the word columns to ``root``, which returns the (H,
    len(words)) block on its device; other ranks return None."""
    from mpi_tpu_torch.parallel import dist

    mi, mj = mesh.dims
    pieces = _word_pieces(words, tile_words)
    sends, recvs, keys, mine = [], [], [], {}
    for i in range(mi):
        for jj, (cols, _) in pieces.items():
            owner, tag = mesh.owner(i, jj), tag0 + i * mj + jj
            if owner == mesh.rank:
                x = shards[i][jj]
                piece = x.index_select(-1, _index(cols, str(x.device)))
                if mesh.rank == root:
                    mine[i, jj] = piece
                else:
                    sends.append((root, tag, piece))
            elif mesh.rank == root:
                h = shards[0][mj - 1].shape[0]
                recvs.append((owner, tag, (h, len(cols)), torch.int32))
                keys.append((i, jj))
    got = dict(zip(keys, dist.exchange(sends, recvs)))
    if mesh.rank != root:
        return None
    dev = shards[0][mj - 1].device
    rows = []
    for i in range(mi):
        row = torch.empty((shards[0][mj - 1].shape[0], len(words)),
                          dtype=torch.int32, device=dev)
        for jj, (_, slots) in pieces.items():
            piece = mine[i, jj] if (i, jj) in mine else got[i, jj]
            row.index_copy_(-1, _index(slots, str(dev)),
                            piece.to(dev, non_blocking=True))
        rows.append(row)
    return torch.cat(rows, dim=0)


def _scatter_words_group(shards, mesh, block, words, tile_words: int,
                         root: int, tag0: int) -> None:
    """:func:`_scatter_words` across ranks: ``root`` sends each shard's
    piece of its ``block`` to the shard's owner, which writes it into the
    shard's word columns, in place."""
    from mpi_tpu_torch.parallel import dist
    from mpi_tpu_torch.parallel.step import first_shard

    mi, mj = mesh.dims
    pieces = _word_pieces(words, tile_words)
    h = first_shard(shards).shape[0]
    sends, recvs, keys = [], [], []
    for i in range(mi):
        for jj, (cols, slots) in pieces.items():
            owner, tag = mesh.owner(i, jj), tag0 + i * mj + jj
            if mesh.rank == root:
                piece = block[i * h:(i + 1) * h].index_select(
                    -1, _index(slots, str(block.device)))
                if owner == root:
                    x = shards[i][jj]
                    x.index_copy_(-1, _index(cols, str(x.device)), piece)
                else:
                    sends.append((owner, tag, piece))
            elif owner == mesh.rank:
                recvs.append((root, tag, (h, len(cols)), torch.int32))
                keys.append((i, jj))
    for (i, jj), piece in zip(keys, dist.exchange(sends, recvs)):
        x = shards[i][jj]
        x.index_copy_(-1, _index(pieces[jj][0], str(x.device)),
                      piece.to(x.device, non_blocking=True))


def make_mesh_seam_stepper(inner, rule: Rule, C: int, K: int, mesh=None):
    """evolve(shards, steps) -> shards around the padded periodic mesh
    pass ``inner(shards, k)`` (``parallel/step.py``, built with
    ``seam_pad``): each pass gathers the strip's words from the shards
    before the pass and from its output shards after it, runs
    :func:`fused_band` on the two blocks and scatters the stitched words
    back into the output shards.  ``C`` is the real width, ``K`` the
    generations per pass.  ``mesh``: a mesh on several ranks
    (``Mesh.multiprocess``), whose strip the owner of shard (0, mj-1)
    gathers, steps and sends back."""
    from mpi_tpu_torch.parallel.step import mesh_evolve

    band_cols(C, K * rule.radius)  # validate up front at the deepest pass
    if mesh is not None and mesh.multiprocess:
        return mesh_evolve(_group_pass(inner, rule, C, mesh), K)

    def local(shards, k):
        tw = shards[0][0].shape[-1]
        words, width = seam_block(C, k * rule.radius)
        src = _gather_words(shards, words, tw)
        out = inner(shards, k)
        block = _gather_words(out, words, tw)
        fused_band(src, block, rule, width, k)
        _scatter_words(out, block, words, tw)
        return out

    return mesh_evolve(local, K)


def _group_pass(inner, rule: Rule, C: int, mesh):
    """The seam pass of :func:`make_mesh_seam_stepper` on a mesh whose
    shards sit on several ranks: the strip's words before and after the
    pass are gathered onto the root, the owner of shard (0, mj-1), which
    runs the band on them; the stitched words go back to their shards'
    owners."""
    from mpi_tpu_torch.parallel.step import first_shard

    mi, mj = mesh.dims
    root = mesh.owner(0, mj - 1)
    n = mi * mj

    def local(shards, k):
        tw = first_shard(shards).shape[1]
        words, width = seam_block(C, k * rule.radius)
        src = _gather_words_group(shards, mesh, words, tw, root, SEAM_TAG)
        out = inner(shards, k)
        block = _gather_words_group(out, mesh, words, tw, root,
                                    SEAM_TAG + n)
        if block is not None:   # the root
            fused_band(src, block, rule, width, k)
        _scatter_words_group(out, mesh, block, words, tw, root,
                             SEAM_TAG + 2 * n)
        return out

    return local
