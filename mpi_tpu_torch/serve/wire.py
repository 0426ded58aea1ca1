"""Binary wire protocol for grid payloads — the serving stack's ONE codec.

The JSON front ships a 4096x4096 board as ~16.8 MB of '0'/'1' row
strings (snapshot) or, on the persistence path, as base64 of
``np.packbits`` (+33% inflation plus a decode copy).  This module is the
single packbits core both paths share, plus a self-describing binary
*frame* the HTTP fronts negotiate via ``Accept``/``Content-Type:
application/x-gol-grid``: a fixed little-endian header followed by the
raw packed payload — 1 bit per cell on the wire, no base64, no JSON
framing, decodable with one ``struct.unpack_from`` and one
``np.frombuffer`` (no copy until ``unpackbits``).

Frame layout (32-byte header, little-endian, then the payload)::

    offset  size  field
    0       4     magic            b"GOLW"
    4       1     version          1 (classic) or 2 (windowed)
    5       1     flags            bit 0: generation field is meaningful
                                   bit 1: window extension present (v2)
                                   bit 2: payload is a dirty-tile delta
    6       2     boundary id      0 unknown, 1 periodic, 2 dead
    8       4     rule id          crc32 of str(rule); 0 unknown
    12      4     rows             window height for v2
    16      4     cols             window width for v2
    20      8     generation
    28      4     payload length   must equal ceil(rows*cols/8)
                                   (v1 and non-delta v2)

Version-2 frames (the viewport serving plane) extend the header by 16
bytes::

    32      4     x0               window origin row on the board
    36      4     y0               window origin column on the board
    40      4     board rows       full-board height
    44      4     board cols       full-board width

so a consumer knows both what slice it received and how big the world
it came from is.  A v2 frame whose :data:`FLAG_DELTA` bit is set
carries dirty tiles instead of a packed window: the payload is a
``<I`` tile count followed by, per tile, a 16-byte ``r0,c0,rows,cols``
head (window-relative) and ``ceil(rows*cols/8)`` packed bits —
:func:`apply_delta` folds them into the previous window.  v1 frames
are byte-identical to every prior release and remain the default
encoding (:func:`encode_frame`).

The rule/boundary ids are *tags*, not negotiation: the payload's meaning
is fixed by rows x cols packed row-major bits; the ids let a consumer
sanity-check which world a frame came from without a side channel.
Every malformed input — short buffer, wrong magic/version, a header
whose dimensions exceed :data:`MAX_CELLS` or disagree with the payload
length, trailing garbage — raises :class:`WireError` (a ``ValueError``,
so the HTTP layer maps it to a structured 400).

``serve/recovery.py``'s ``encode_grid``/``decode_grid`` are thin JSON
wrappers over :func:`pack_grid`/:func:`unpack_grid`, so checkpoint
records and wire frames can never disagree about packing
(``tests/test_wire.py`` pins old-record compatibility).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"GOLW"
VERSION = 1
VERSION_WINDOW = 2
FLAG_GENERATION = 0x01
FLAG_WINDOW = 0x02
FLAG_DELTA = 0x04

# magic, version, flags, boundary id, rule id, rows, cols, generation,
# payload length — 32 bytes, no padding ("<" disables alignment)
HEADER = struct.Struct("<4sBBHIIIQI")
HEADER_LEN = HEADER.size
assert HEADER_LEN == 32

# v2 window extension: x0, y0, board rows, board cols
WINDOW_EXT = struct.Struct("<IIII")
HEADER_V2_LEN = HEADER_LEN + WINDOW_EXT.size
assert HEADER_V2_LEN == 48

# delta payload framing: tile count, then per tile r0, c0, rows, cols
# (window-relative) followed by the tile's flat-packed bits
_TILE_COUNT = struct.Struct("<I")
_TILE_HEAD = struct.Struct("<IIII")

# A frame header may promise at most this many cells (a 65536^2 board is
# 2^32; one binade of headroom).  Anything larger is an oversized-header
# attack or corruption, rejected before any allocation is sized off it.
MAX_CELLS = 1 << 34

GRID_MEDIA_TYPE = "application/x-gol-grid"
STREAM_MEDIA_TYPE = "application/x-gol-grid-stream"

_BOUNDARY_IDS = {"periodic": 1, "dead": 2}
_BOUNDARY_NAMES = {v: k for k, v in _BOUNDARY_IDS.items()}


class WireError(ValueError):
    """A malformed binary frame (bad magic/version/geometry/length).
    Maps to HTTP 400 — the client sent garbage, the session is fine."""


# -- the shared packbits core (recovery's JSON wrappers sit on these) ----


def pack_grid(grid: np.ndarray) -> bytes:
    """Row-major 1-bit packing of a 0/1 grid: ceil(rows*cols/8) bytes."""
    arr = np.asarray(grid, dtype=np.uint8)
    if arr.ndim != 2:
        raise WireError(f"grid must be 2-D, got shape {arr.shape}")
    return np.packbits(arr, axis=None).tobytes()


def unpack_grid(raw: bytes, rows: int, cols: int) -> np.ndarray:
    """Inverse of :func:`pack_grid` for a known geometry."""
    rows, cols = int(rows), int(cols)
    need = payload_len(rows, cols)
    if len(raw) != need:
        raise WireError(
            f"packed payload is {len(raw)} bytes, {rows}x{cols} needs {need}")
    bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8),
                         count=rows * cols)
    return bits.reshape(rows, cols)


def payload_len(rows: int, cols: int) -> int:
    return (rows * cols + 7) // 8


# -- header tags ---------------------------------------------------------


def boundary_id(boundary: Optional[str]) -> int:
    return _BOUNDARY_IDS.get(boundary, 0) if boundary else 0


def boundary_name(bid: int) -> Optional[str]:
    return _BOUNDARY_NAMES.get(int(bid))


def rule_id(rule) -> int:
    """A stable 32-bit tag for a rule: crc32 of its canonical string
    (``str(Rule)`` round-trips through ``rule_from_name``).  0 = none."""
    if rule is None:
        return 0
    tag = zlib.crc32(str(rule).encode("utf-8")) & 0xFFFFFFFF
    return tag or 1                     # 0 is reserved for "unspecified"


# -- frames --------------------------------------------------------------


def encode_frame(grid: np.ndarray, *, generation: Optional[int] = None,
                 rule=None, boundary: Optional[str] = None) -> bytes:
    """One self-describing binary frame for ``grid``.  ``generation=None``
    leaves the field 0 with :data:`FLAG_GENERATION` clear (a consumer
    must not trust it); board writes use the flag to mean "set the
    session's generation to this"."""
    arr = np.asarray(grid, dtype=np.uint8)
    if arr.ndim != 2:
        raise WireError(f"grid must be 2-D, got shape {arr.shape}")
    rows, cols = arr.shape
    flags = 0 if generation is None else FLAG_GENERATION
    payload = pack_grid(arr)
    header = HEADER.pack(MAGIC, VERSION, flags, boundary_id(boundary),
                         rule_id(rule), rows, cols,
                         0 if generation is None else int(generation),
                         len(payload))
    return header + payload


def encode_window_frame(grid: np.ndarray, *, x0: int, y0: int,
                        board_shape: Tuple[int, int],
                        generation: Optional[int] = None,
                        rule=None, boundary: Optional[str] = None) -> bytes:
    """A v2 frame carrying one packed window of a larger board.  The
    payload is the window's cells only — O(viewport) bytes no matter
    how big the board is."""
    arr = np.asarray(grid, dtype=np.uint8)
    if arr.ndim != 2:
        raise WireError(f"grid must be 2-D, got shape {arr.shape}")
    rows, cols = arr.shape
    brows, bcols = int(board_shape[0]), int(board_shape[1])
    flags = FLAG_WINDOW | (0 if generation is None else FLAG_GENERATION)
    payload = pack_grid(arr)
    header = HEADER.pack(MAGIC, VERSION_WINDOW, flags, boundary_id(boundary),
                         rule_id(rule), rows, cols,
                         0 if generation is None else int(generation),
                         len(payload))
    ext = WINDOW_EXT.pack(int(x0), int(y0), brows, bcols)
    return header + ext + payload


def encode_delta_frame(tiles, *, window: Tuple[int, int, int, int],
                       board_shape: Tuple[int, int],
                       generation: Optional[int] = None,
                       rule=None, boundary: Optional[str] = None) -> bytes:
    """A v2 dirty-tile delta frame: ``tiles`` is a list of
    ``(r0, c0, tile)`` with window-relative origins; only those cells
    ride the wire.  An empty list is legal — a quiescent generation is
    a 53-byte heartbeat, which is the whole point."""
    x0, y0, h, w = (int(v) for v in window)
    brows, bcols = int(board_shape[0]), int(board_shape[1])
    flags = (FLAG_WINDOW | FLAG_DELTA
             | (0 if generation is None else FLAG_GENERATION))
    parts = [_TILE_COUNT.pack(len(tiles))]
    for r0, c0, tile in tiles:
        arr = np.asarray(tile, dtype=np.uint8)
        tr, tc = arr.shape
        if r0 < 0 or c0 < 0 or r0 + tr > h or c0 + tc > w:
            raise WireError(
                f"delta tile {tr}x{tc}@({r0},{c0}) escapes the "
                f"{h}x{w} window")
        parts.append(_TILE_HEAD.pack(int(r0), int(c0), tr, tc))
        parts.append(pack_grid(arr))
    payload = b"".join(parts)
    header = HEADER.pack(MAGIC, VERSION_WINDOW, flags, boundary_id(boundary),
                         rule_id(rule), h, w,
                         0 if generation is None else int(generation),
                         len(payload))
    ext = WINDOW_EXT.pack(x0, y0, brows, bcols)
    return header + ext + payload


def _decode_tiles(payload, rows: int, cols: int):
    """Parse a delta payload into ``[(r0, c0, tile), ...]``; every byte
    must be accounted for."""
    view = memoryview(payload)
    if len(view) < _TILE_COUNT.size:
        raise WireError("truncated delta payload (no tile count)")
    (count,) = _TILE_COUNT.unpack_from(view, 0)
    pos = _TILE_COUNT.size
    tiles = []
    for _ in range(count):
        if len(view) - pos < _TILE_HEAD.size:
            raise WireError("truncated delta tile head")
        r0, c0, tr, tc = _TILE_HEAD.unpack_from(view, pos)
        pos += _TILE_HEAD.size
        if tr < 1 or tc < 1 or r0 + tr > rows or c0 + tc > cols:
            raise WireError(
                f"delta tile {tr}x{tc}@({r0},{c0}) escapes the "
                f"{rows}x{cols} window")
        nbytes = payload_len(tr, tc)
        if len(view) - pos < nbytes:
            raise WireError("truncated delta tile payload")
        tiles.append((r0, c0,
                      unpack_grid(view[pos:pos + nbytes].tobytes(), tr, tc)))
        pos += nbytes
    if pos != len(view):
        raise WireError(
            f"trailing garbage after delta tiles: {len(view) - pos} bytes")
    return tiles


def apply_delta(window_grid: np.ndarray, tiles) -> np.ndarray:
    """Fold a delta frame's tiles into the previous window state — the
    client half of delta-stream reconstruction.  Returns a new array;
    the input is not mutated."""
    out = np.array(window_grid, dtype=np.uint8, copy=True)
    for r0, c0, tile in tiles:
        out[r0:r0 + tile.shape[0], c0:c0 + tile.shape[1]] = tile
    return out


DELTA_TILE = 64


def diff_tiles(prev: np.ndarray, cur: np.ndarray,
               tile: int = DELTA_TILE):
    """The dirty-tile set between two equal-shape window grids —
    ``[(r0, c0, subgrid), ...]`` with window-relative origins, one
    entry per ``tile``-sized block whose cells changed.  The producer
    half of the delta stream (:func:`apply_delta` is the consumer)."""
    a = np.asarray(prev, dtype=np.uint8)
    b = np.asarray(cur, dtype=np.uint8)
    if a.shape != b.shape:
        raise WireError(
            f"delta base shape {a.shape} does not match {b.shape}")
    changed = a != b
    rows, cols = b.shape
    out = []
    for r0 in range(0, rows, tile):
        r1 = min(r0 + tile, rows)
        for c0 in range(0, cols, tile):
            c1 = min(c0 + tile, cols)
            if changed[r0:r1, c0:c1].any():
                out.append((r0, c0, b[r0:r1, c0:c1]))
    return out


def header_len_of(buf) -> Optional[int]:
    """The full header length of the frame starting at ``buf``, from
    its magic+version prefix alone — or None when fewer than 5 bytes
    are available (wait for more).  A bad magic or unknown version
    raises: the stream is corrupt, not merely short."""
    view = memoryview(buf)
    if len(view) < 5:
        return None
    magic = bytes(view[:4])
    if magic != MAGIC:
        raise WireError(f"bad frame magic {magic!r} (expected {MAGIC!r})")
    version = view[4]
    if version == VERSION:
        return HEADER_LEN
    if version == VERSION_WINDOW:
        return HEADER_V2_LEN
    raise WireError(f"unsupported frame version {version} "
                    f"(expected {VERSION} or {VERSION_WINDOW})")


def parse_header(buf) -> Dict:
    """Validate and decode the header at the start of ``buf`` (32 bytes
    for v1, 48 for v2).

    Returns the meta dict (rows/cols/generation/flags/ids plus
    ``payload_len`` and ``frame_len``) without touching the payload —
    the streaming reassembly entry point: peek the header, wait for
    ``frame_len`` bytes, then :func:`decode_frame` the exact slice."""
    view = memoryview(buf)
    if len(view) < HEADER_LEN:
        raise WireError(
            f"truncated frame header: {len(view)} of {HEADER_LEN} bytes")
    (magic, version, flags, bid, rid, rows, cols, generation,
     plen) = HEADER.unpack_from(view, 0)
    if magic != MAGIC:
        raise WireError(f"bad frame magic {bytes(magic)!r} "
                        f"(expected {MAGIC!r})")
    if version not in (VERSION, VERSION_WINDOW):
        raise WireError(f"unsupported frame version {version} "
                        f"(expected {VERSION} or {VERSION_WINDOW})")
    header_len = HEADER_LEN if version == VERSION else HEADER_V2_LEN
    if rows < 1 or cols < 1:
        raise WireError(f"frame geometry must be positive, got {rows}x{cols}")
    if rows * cols > MAX_CELLS:
        raise WireError(
            f"oversized frame header: {rows}x{cols} exceeds the "
            f"{MAX_CELLS}-cell bound")
    is_delta = bool(flags & FLAG_DELTA)
    window = None
    board_rows, board_cols = rows, cols
    if version == VERSION_WINDOW:
        if len(view) < HEADER_V2_LEN:
            raise WireError(
                f"truncated v2 frame header: {len(view)} of "
                f"{HEADER_V2_LEN} bytes")
        x0, y0, board_rows, board_cols = WINDOW_EXT.unpack_from(
            view, HEADER_LEN)
        if board_rows < 1 or board_cols < 1:
            raise WireError(
                f"board geometry must be positive, got "
                f"{board_rows}x{board_cols}")
        if board_rows * board_cols > MAX_CELLS:
            raise WireError(
                f"oversized board header: {board_rows}x{board_cols} "
                f"exceeds the {MAX_CELLS}-cell bound")
        if x0 >= board_rows or y0 >= board_cols:
            raise WireError(
                f"window origin ({x0},{y0}) is off the "
                f"{board_rows}x{board_cols} board")
        window = (x0, y0, rows, cols)
    elif is_delta:
        raise WireError("delta flag on a v1 frame")
    if is_delta:
        if plen < _TILE_COUNT.size or plen > payload_len(rows, cols) \
                + _TILE_COUNT.size + rows * cols * _TILE_HEAD.size:
            raise WireError(
                f"implausible delta payload length {plen} for a "
                f"{rows}x{cols} window")
    else:
        need = payload_len(rows, cols)
        if plen != need:
            raise WireError(
                f"frame payload length {plen} disagrees with geometry "
                f"{rows}x{cols} (expected {need})")
    return {
        "version": version,
        "flags": flags,
        "boundary_id": bid,
        "boundary": boundary_name(bid),
        "rule_id": rid,
        "rows": rows,
        "cols": cols,
        "generation": generation,
        "has_generation": bool(flags & FLAG_GENERATION),
        "is_delta": is_delta,
        "window": window,
        "board_rows": board_rows,
        "board_cols": board_cols,
        "payload_len": plen,
        "header_len": header_len,
        "frame_len": header_len + plen,
    }


def decode_frame(buf) -> Tuple[Optional[np.ndarray], Dict]:
    """(grid, meta) from exactly one frame.  The buffer must hold the
    frame and nothing else — trailing bytes are rejected (an HTTP body
    is one frame; streams carve exact slices via :func:`parse_header`).
    A delta frame decodes to ``(None, meta)`` with the parsed tiles in
    ``meta["tiles"]`` — fold them with :func:`apply_delta`."""
    meta = parse_header(buf)
    view = memoryview(buf)
    if len(view) < meta["frame_len"]:
        raise WireError(
            f"truncated frame: {len(view)} of {meta['frame_len']} bytes")
    if len(view) > meta["frame_len"]:
        raise WireError(
            f"trailing garbage after frame: {len(view) - meta['frame_len']} "
            f"extra bytes")
    payload = view[meta["header_len"]:meta["frame_len"]]
    if meta["is_delta"]:
        meta["tiles"] = _decode_tiles(payload, meta["rows"], meta["cols"])
        return None, meta
    grid = unpack_grid(payload.tobytes(), meta["rows"], meta["cols"])
    return grid, meta


def split_frames(buf: bytes) -> Tuple[List[Tuple[np.ndarray, Dict]], bytes]:
    """Carve every complete frame off the front of ``buf`` — the client
    half of stream reassembly (chunked transfer does not promise that
    chunk boundaries align with frames, or even that a whole header
    arrives in one read).  Returns (frames, remainder); a malformed
    header raises, a merely-incomplete tail — including a header split
    across reads — does not."""
    out: List[Tuple[np.ndarray, Dict]] = []
    pos = 0
    while True:
        hlen = header_len_of(buf[pos:pos + 5])
        if hlen is None or len(buf) - pos < hlen:
            break                       # header incomplete: wait for bytes
        meta = parse_header(buf[pos:pos + hlen])
        if len(buf) - pos < meta["frame_len"]:
            break
        out.append(decode_frame(buf[pos:pos + meta["frame_len"]]))
        pos += meta["frame_len"]
    return out, buf[pos:]
