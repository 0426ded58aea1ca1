"""The ``.gol`` snapshot format, the port's own copy of ``mpi_tpu.golio``.

* master file ``<name>.gol``: one line ``rows cols iteration_gap
  iterations processes``;
* per-tile files ``<name>_<iteration>_<pid>.gol``: two lines ``firstRow
  lastRow`` / ``firstCol lastCol`` (inclusive global coordinates), then the
  tile as tab-separated 0/1 rows, each with a trailing tab;
* packed tiles ``<name>_<iteration>_<pid>.golp``: the magic line
  ``GOLP1``, the same two coordinate lines, then ``np.packbits`` rows
  (1 bit per cell, each row padded to whole bytes).  ``fmt="auto"`` writes
  text up to ``GOLP_THRESHOLD`` cells per tile and packed above.

Every file lands by temp file + ``os.replace``, so a reader never sees a
torn file.  Readers sniff the format of each file by its magic.
"""

from __future__ import annotations

import os
import re
from typing import List, Tuple

import numpy as np

GOLP_MAGIC = b"GOLP1\n"
GOLP_THRESHOLD = 1 << 24


def master_path(out_dir: str, name: str) -> str:
    return os.path.join(out_dir, f"{name}.gol")


def tile_path(out_dir: str, name: str, iteration: int, pid: int) -> str:
    return os.path.join(out_dir, f"{name}_{iteration}_{pid}.gol")


def tile_path_packed(out_dir: str, name: str, iteration: int, pid: int) -> str:
    return os.path.join(out_dir, f"{name}_{iteration}_{pid}.golp")


def find_tile_path(out_dir: str, name: str, iteration: int, pid: int) -> str:
    """The tile file for (iteration, pid) in whichever format exists; if
    both do, the newer one (tiles land complete, so mtime is write order;
    equal times resolve to the text file)."""
    packed = tile_path_packed(out_dir, name, iteration, pid)
    text = tile_path(out_dir, name, iteration, pid)
    try:
        pt = os.stat(packed).st_mtime_ns
    except FileNotFoundError:
        return text
    try:
        tt = os.stat(text).st_mtime_ns
    except FileNotFoundError:
        return packed
    return text if tt >= pt else packed


def _atomic_write(path: str, data, mode: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, mode) as f:
        f.write(data)
    os.replace(tmp, path)


def write_master(
    out_dir: str, name: str, rows: int, cols: int,
    iteration_gap: int, iterations: int, processes: int,
) -> str:
    path = master_path(out_dir, name)
    _atomic_write(path, f"{rows} {cols} {iteration_gap} {iterations} {processes}\n", "w")
    return path


def read_master(path: str) -> Tuple[int, int, int, int, int]:
    with open(path) as f:
        parts = f.readline().split()
    if len(parts) != 5:
        raise ValueError(f"malformed master .gol header in {path!r}: {parts}")
    rows, cols, gap, iters, procs = map(int, parts)
    return rows, cols, gap, iters, procs


def write_tile(
    out_dir: str, name: str, iteration: int, pid: int,
    tile: np.ndarray, first_row: int, first_col: int,
) -> str:
    rows, cols = tile.shape
    path = tile_path(out_dir, name, iteration, pid)
    lines = [f"{first_row} {first_row + rows - 1}\n",
             f"{first_col} {first_col + cols - 1}\n"]
    lines += ["\t".join("1" if v else "0" for v in r) + "\t\n" for r in tile]
    _atomic_write(path, "".join(lines), "w")
    return path


def write_tile_packed(
    out_dir: str, name: str, iteration: int, pid: int,
    tile: np.ndarray, first_row: int, first_col: int,
) -> str:
    rows, cols = tile.shape
    path = tile_path_packed(out_dir, name, iteration, pid)
    body = np.packbits(np.asarray(tile, dtype=np.uint8), axis=1)
    head = (GOLP_MAGIC
            + f"{first_row} {first_row + rows - 1}\n".encode()
            + f"{first_col} {first_col + cols - 1}\n".encode())
    _atomic_write(path, head + body.tobytes(), "wb")
    return path


def read_tile_header(path: str) -> Tuple[int, int, int, int]:
    """Just the ``(firstRow, lastRow, firstCol, lastCol)`` metadata of a
    tile of either format, without reading its body."""
    with open(path, "rb") as f:
        first = f.readline()
        if first == GOLP_MAGIC:
            first = f.readline()
        r0, r1 = map(int, first.split())
        c0, c1 = map(int, f.readline().split())
    return r0, r1, c0, c1


def read_tile(path: str) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """Either tile format, sniffed by its magic."""
    with open(path, "rb") as f:
        if f.readline() == GOLP_MAGIC:
            r0, r1 = map(int, f.readline().split())
            c0, c1 = map(int, f.readline().split())
            body = f.read()
            rows, cols = r1 - r0 + 1, c1 - c0 + 1
            row_bytes = (cols + 7) // 8
            if len(body) != rows * row_bytes:
                raise ValueError(
                    f"{path!r}: body is {len(body)} bytes, metadata implies "
                    f"{rows}x{row_bytes}"
                )
            packed = np.frombuffer(body, dtype=np.uint8).reshape(rows, row_bytes)
            return np.unpackbits(packed, axis=1)[:, :cols], (r0, r1, c0, c1)
    with open(path) as f:
        r0, r1 = map(int, f.readline().split())
        c0, c1 = map(int, f.readline().split())
        data = [line.split() for line in f if line.strip()]
    tile = np.array(data, dtype=np.uint8)
    expect = (r1 - r0 + 1, c1 - c0 + 1)
    if tile.shape != expect:
        raise ValueError(f"{path!r}: tile shape {tile.shape} != metadata {expect}")
    return tile, (r0, r1, c0, c1)


def list_snapshot_iterations(out_dir: str, name: str) -> List[int]:
    """The iterations of run ``name`` that have tile files (pid 0's)."""
    pat = re.compile(re.escape(name) + r"_(\d+)_0\.golp?$")
    return sorted({
        int(m.group(1))
        for fn in os.listdir(out_dir or ".")
        if (m := pat.match(fn))
    })


def iteration_tile_pids(out_dir: str, name: str, iteration: int) -> List[int]:
    """The pids of the tile files present for one iteration."""
    pat = re.compile(re.escape(name) + "_" + str(iteration) + r"_(\d+)\.golp?$")
    return sorted({
        int(m.group(1))
        for fn in os.listdir(out_dir or ".")
        if (m := pat.match(fn))
    })


def assemble(out_dir: str, name: str, iteration: int) -> np.ndarray:
    """The global grid saved at ``iteration``, stitched from the tile files
    present (a resumed run may have written another tile count than the
    master header records); raises if they do not cover the grid."""
    rows, cols, _, _, _ = read_master(master_path(out_dir, name))
    return assemble_region(out_dir, name, iteration, 0, rows, 0, cols)


def load_snapshot(out_dir: str, name: str, iteration: int) -> np.ndarray:
    """The checkpoint-restart entry: :func:`assemble`."""
    return assemble(out_dir, name, iteration)


def assemble_region(out_dir: str, name: str, iteration: int,
                    r0: int, r1: int, c0: int, c1: int) -> np.ndarray:
    """Rows ``[r0, r1)`` and columns ``[c0, c1)`` of a saved iteration,
    reading the body of only the tiles that intersect them (their headers
    say which); raises if the tiles do not cover the region."""
    pids = iteration_tile_pids(out_dir, name, iteration)
    if not pids:
        raise ValueError(f"snapshot {name}@{iteration}: no tile files found")
    region = np.zeros((r1 - r0, c1 - c0), dtype=np.uint8)
    seen = np.zeros(region.shape, dtype=bool)
    for pid in pids:
        path = find_tile_path(out_dir, name, iteration, pid)
        tr0, tr1, tc0, tc1 = read_tile_header(path)
        ir0, ir1 = max(r0, tr0), min(r1, tr1 + 1)
        ic0, ic1 = max(c0, tc0), min(c1, tc1 + 1)
        if ir0 >= ir1 or ic0 >= ic1:
            continue
        tile, _ = read_tile(path)
        region[ir0 - r0:ir1 - r0, ic0 - c0:ic1 - c0] = tile[
            ir0 - tr0:ir1 - tr0, ic0 - tc0:ic1 - tc0]
        seen[ir0 - r0:ir1 - r0, ic0 - c0:ic1 - c0] = True
    if not seen.all():
        raise ValueError(
            f"snapshot {name}@{iteration}: tiles cover only "
            f"{int(seen.sum())}/{seen.size} cells of region "
            f"[{r0}:{r1}, {c0}:{c1}]"
        )
    return region


def remove_stale_tiles(out_dir: str, name: str, iteration: int, keep_pids) -> None:
    """Remove tiles of pids outside ``keep_pids`` at this iteration, so a
    rerun with fewer writers leaves no old tiles to be stitched in."""
    keep = set(keep_pids)
    for pid in iteration_tile_pids(out_dir, name, iteration):
        if pid not in keep:
            for path in (tile_path(out_dir, name, iteration, pid),
                         tile_path_packed(out_dir, name, iteration, pid)):
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass


def write_tile_fmt(
    out_dir: str, name: str, iteration: int, pid: int,
    tile: np.ndarray, first_row: int, first_col: int, fmt: str = "auto",
) -> str:
    """One tile in ``fmt`` ("gol", "golp" or "auto"), then removal of the
    other format's file for the same pid."""
    if fmt not in ("auto", "gol", "golp"):
        raise ValueError(f"unknown snapshot format {fmt!r}")
    packed = fmt == "golp" or (fmt == "auto" and tile.size > GOLP_THRESHOLD)
    writer, other = ((write_tile_packed, tile_path) if packed
                     else (write_tile, tile_path_packed))
    path = writer(out_dir, name, iteration, pid, tile, first_row, first_col)
    try:
        os.remove(other(out_dir, name, iteration, pid))
    except FileNotFoundError:
        pass
    return path


def write_snapshot_tiles(
    out_dir: str, name: str, iteration: int,
    tiles: List[Tuple[np.ndarray, int, int]],
    fmt: str = "auto",
) -> None:
    """One iteration's snapshot; tiles are (tile, first_row, first_col) and
    the pid is the list index."""
    for pid, (tile, r0, c0) in enumerate(tiles):
        write_tile_fmt(out_dir, name, iteration, pid, tile, r0, c0, fmt)
    remove_stale_tiles(out_dir, name, iteration, range(len(tiles)))
