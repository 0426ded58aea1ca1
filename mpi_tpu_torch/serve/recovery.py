"""Crash-safe session persistence — the serve layer's durable state plane.

A ``kill -9`` of a serving process must not lose live boards, and a torn
write, a flipped bit, or a full disk must not lose them either.  The
paper's design makes the recovery half cheap: stepping is deterministic
from ``(spec, seed)`` and every engine is bit-identical to the
``serial_np`` oracle (PARITY.md), so a session is fully described by its
*spec*, its *generation*, and (as an optimization bounding replay
length) an occasional packed grid snapshot.  This module persists
exactly that, in three durability layers:

**Checksummed record envelopes (v2).**  Each session's full record
lives in ``<sid>.json`` as a binary envelope — a fixed header (magic
``GOLS``, version, payload length) plus a CRC-framed UTF-8 JSON payload,
the same frame discipline as the GOLW wire format (``serve/wire.py``).
A record that fails its CRC (bit rot, a torn ``os.replace``) is
*detected*, never silently decoded.  v1 records (plain JSON, the first
format) are recognized by their leading ``{`` and still load; the first
save after a restore rewrites them as v2 — the auto-upgrade path
MIGRATION.md documents.

**Append-only journals.**  Between full record writes, every committed
step appends one CRC-framed entry to ``<sid>.journal``: a ``mark``
(generation advance only — replay is deterministic), or a content entry
(``rows`` = the whole packed board, ``delta`` = only the packed rows
that changed since the last content entry).  A crash mid-append loses
at most the torn tail entry; the reader stops at the first frame that
fails its CRC.  The journal compacts (one full record write, journal
truncated) when it exceeds ``journal_max_bytes`` or
``journal_max_age_s``.

**A last-good chain.**  Every full record write rotates the previous
head to ``<sid>.json.1`` (→ ``.json.2``, up to ``keep`` ancestors) with
its journal alongside (``<sid>.journal.1`` …).  Restore walks the chain
head-first: a corrupt candidate is quarantined to ``<sid>.corrupt-<n>``
(with a structured stderr warning) and the walk falls back to the newest verifiable ancestor, then
replays every journal from that depth up to the live one — content
``delta`` entries chain across journal generations because a compaction
record's snapshot is by construction the previous journal's last
content state.

**IO fault choke point.**  Every byte this module writes goes through
:meth:`StateStore._io` — one method covering ``write``/``fsync``/
``replace`` — where the fault DSL's ``io-write``/``io-fsync``/
``io-replace`` sites (``serve/faults.py``) can make the write raise,
tear at a fraction, report ``ENOSPC``, or stall.  Every durability
claim above is asserted under those injected faults.

**Graceful degradation.**  An IO failure moves the store's persistence
state machine ``closed → degraded``: while degraded (and the bounded
exponential backoff has not elapsed) writes fast-fail without touching
the disk and the affected sessions are queued as *pending*.  When the
backoff elapses the next write is the probe; success moves to
``recovering`` while the pending backlog is flushed (full snapshots),
then back to ``closed``.  The serve layer surfaces the state in
``/healthz`` and ``/stats``, sizes ``Retry-After`` from
:meth:`StateStore.retry_in_s`, and — in cluster mode — gossips the
degraded bit so failover never adopts from a node whose recent
checkpoints are known-unwritten.

What does NOT persist (by design): built engines (rebuilt on the first
touch; a kernel library already built in ``build/`` is reused), breaker state
and counters (a restart is the escape hatch a breaker exists to
approximate), and any in-flight step (the client saw an error or a dead
connection, never a commit).  Async tickets keep the same commit
discipline: the dispatch loop persists only AFTER a unit-round chain's
wait for the device (``Engine.block_until_ready``) returns, so a ``kill -9`` with tickets in flight
restores to the last completed dispatch.
"""

from __future__ import annotations

import base64
import errno
import json
import os
import re
import struct
import sys
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from mpi_tpu_torch.serve import wire

RECORD_VERSION = 2
JOURNAL_VERSION = 1

# record envelope: magic, version, flags, reserved, payload_len, crc32
_REC_MAGIC = b"GOLS"
_REC_HEADER = struct.Struct("<4sBBHII")
# journal entry: magic, version, kind, reserved, generation, payload_len, crc
_JRN_MAGIC = b"GOLJ"
_JRN_HEADER = struct.Struct("<4sBBHQII")
_J_MARK, _J_ROWS, _J_DELTA, _J_SHARD = 0, 1, 2, 3
_J_KINDS = {_J_MARK: "mark", _J_ROWS: "rows", _J_DELTA: "delta",
            _J_SHARD: "shard"}
_ROWS_HEAD = struct.Struct("<II")       # rows, cols
_DELTA_HEAD = struct.Struct("<III")     # rows, cols, changed-row count
# shard content entry: board rows/cols, shard origin r0/c0, shard
# rows/cols, then the shard's flat-packed bits (the same packing as a
# record snapshot's "packed" field, so shard journal entries and shard
# snapshot records can never pack differently)
_SHARD_HEAD = struct.Struct("<IIIIII")
_MAX_PAYLOAD = 1 << 30                  # sanity bound on declared lengths

# persistence state machine backoff: 0.5 s doubling, capped
_BACKOFF_BASE_S = 0.5
_BACKOFF_CAP_S = 30.0


class RecordCorrupt(ValueError):
    """A persisted record or journal frame failed validation (bad magic,
    torn payload, CRC mismatch, malformed JSON) — the restore path
    quarantines and falls back; it never decodes a corrupt frame."""


class StorageDegradedError(OSError):
    """Raised by the store's fast-fail path while persistence is
    degraded (the disk failed and the retry backoff has not elapsed)
    and by the serve layer's ``--state-degrade readonly|shed`` gate.
    The transport maps it to a structured 503 with ``Retry-After``
    sized by ``retry_after_s``."""

    def __init__(self, msg: str, retry_after_s: float = _BACKOFF_BASE_S):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


def encode_grid(grid: np.ndarray) -> dict:
    """A JSON-safe packed snapshot of a 0/1 uint8 grid — a base64
    wrapper over the one packbits core (``serve/wire.py``), so records
    and binary wire frames can never pack differently.  The bytes are
    the reference's: its ``--state-dir`` records decode bit-identically
    here and the reverse (``tests/test_torch_serve_recovery.py``)."""
    arr = np.asarray(grid, dtype=np.uint8)
    rows, cols = arr.shape
    return {
        "rows": int(rows),
        "cols": int(cols),
        "packed": base64.b64encode(wire.pack_grid(arr)).decode("ascii"),
    }


def encode_grid_shards(tiles, rows: int, cols: int) -> dict:
    """A shard-dimension snapshot: each device shard's tile packed
    independently, so checkpoint and restore stream shard-by-shard and
    never hold one (rows, cols) ndarray.  ``tiles`` is
    ``[(r0, c0, tile_ndarray), ...]`` in board coordinates."""
    return {
        "rows": int(rows),
        "cols": int(cols),
        "shards": [
            {
                "r0": int(r0),
                "c0": int(c0),
                "rows": int(t.shape[0]),
                "cols": int(t.shape[1]),
                "packed": base64.b64encode(wire.pack_grid(t)).decode("ascii"),
            }
            for r0, c0, t in tiles
        ],
    }


def decode_grid(snap: dict) -> np.ndarray:
    rows, cols = int(snap["rows"]), int(snap["cols"])
    if "shards" in snap:
        grid = np.zeros((rows, cols), dtype=np.uint8)
        for sh in snap["shards"]:
            r0, c0 = int(sh["r0"]), int(sh["c0"])
            tr, tc = int(sh["rows"]), int(sh["cols"])
            grid[r0:r0 + tr, c0:c0 + tc] = wire.unpack_grid(
                base64.b64decode(sh["packed"]), tr, tc)
        return grid
    return wire.unpack_grid(base64.b64decode(snap["packed"]), rows, cols)


def snapshot_loader(snap: dict):
    """A region loader ``f(r0, r1, c0, c1) -> uint8`` over a snapshot
    dict — the restore-side half of per-shard checkpointing: a sharded
    engine's ``init_grid`` pulls each device shard's region through
    this, decoding only the stored shards that intersect it, so restore
    never materializes the full board on one host.  Legacy full-grid
    snapshots decode once, lazily."""
    if "shards" in snap:
        shards = [
            (int(sh["r0"]), int(sh["c0"]), int(sh["rows"]), int(sh["cols"]),
             sh["packed"])
            for sh in snap["shards"]
        ]

        def load(r0: int, r1: int, c0: int, c1: int) -> np.ndarray:
            out = np.zeros((r1 - r0, c1 - c0), dtype=np.uint8)
            for sr0, sc0, srows, scols, packed in shards:
                ir0, ir1 = max(r0, sr0), min(r1, sr0 + srows)
                ic0, ic1 = max(c0, sc0), min(c1, sc0 + scols)
                if ir0 >= ir1 or ic0 >= ic1:
                    continue
                tile = wire.unpack_grid(base64.b64decode(packed),
                                        srows, scols)
                out[ir0 - r0:ir1 - r0, ic0 - c0:ic1 - c0] = \
                    tile[ir0 - sr0:ir1 - sr0, ic0 - sc0:ic1 - sc0]
            return out

        return load
    cache = {}

    def load_full(r0: int, r1: int, c0: int, c1: int) -> np.ndarray:
        if "grid" not in cache:
            cache["grid"] = decode_grid(snap)
        return cache["grid"][r0:r1, c0:c1]

    return load_full


# -- envelope / journal frame codecs ---------------------------------------


def _rec_encode(rec: dict) -> bytes:
    payload = json.dumps(rec).encode("utf-8")
    h0 = _REC_HEADER.pack(_REC_MAGIC, RECORD_VERSION, 0, 0, len(payload), 0)
    crc = zlib.crc32(h0 + payload) & 0xFFFFFFFF
    return _REC_HEADER.pack(_REC_MAGIC, RECORD_VERSION, 0, 0,
                            len(payload), crc) + payload


def _rec_validate(rec, want_v) -> dict:
    if (not isinstance(rec, dict)
            or rec.get("v") != want_v
            or not isinstance(rec.get("id"), str)
            or not isinstance(rec.get("spec"), dict)
            or not isinstance(rec.get("generation"), int)):
        raise RecordCorrupt("malformed session record")
    return rec


def _rec_decode(raw: bytes) -> dict:
    """Decode one record file's bytes — v2 envelope or legacy v1 JSON
    (detected by the leading ``{``).  Raises :class:`RecordCorrupt` on
    any validation failure."""
    if not raw:
        raise RecordCorrupt("empty record file")
    if raw[:1] == b"{":                 # v1: plain JSON, no envelope
        try:
            rec = json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise RecordCorrupt(f"unparseable v1 record: {e}") from e
        return _rec_validate(rec, 1)
    if len(raw) < _REC_HEADER.size:
        raise RecordCorrupt(f"truncated record header ({len(raw)} bytes)")
    magic, ver, flags, _res, plen, crc = _REC_HEADER.unpack_from(raw)
    if magic != _REC_MAGIC:
        raise RecordCorrupt(f"bad record magic {magic!r}")
    if ver != RECORD_VERSION:
        raise RecordCorrupt(f"unknown record version {ver}")
    if plen > _MAX_PAYLOAD:
        raise RecordCorrupt(f"implausible record payload length {plen}")
    payload = raw[_REC_HEADER.size:]
    if len(payload) != plen:
        raise RecordCorrupt(
            f"torn record ({len(payload)} of {plen} payload bytes)")
    h0 = _REC_HEADER.pack(magic, ver, flags, _res, plen, 0)
    if zlib.crc32(h0 + payload) & 0xFFFFFFFF != crc:
        raise RecordCorrupt("record CRC mismatch")
    try:
        rec = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise RecordCorrupt(f"unparseable record payload: {e}") from e
    return _rec_validate(rec, RECORD_VERSION)


def _jrn_encode(kind: int, generation: int, payload: bytes) -> bytes:
    h0 = _JRN_HEADER.pack(_JRN_MAGIC, JOURNAL_VERSION, kind, 0,
                          generation, len(payload), 0)
    crc = zlib.crc32(h0 + payload) & 0xFFFFFFFF
    return _JRN_HEADER.pack(_JRN_MAGIC, JOURNAL_VERSION, kind, 0,
                            generation, len(payload), crc) + payload


def _jrn_scan(raw: bytes) -> Tuple[List[Tuple[int, int, bytes]], int, bool]:
    """Parse a journal's bytes into ``(entries, good_bytes, torn)``:
    every leading CRC-verified frame, the byte offset they end at, and
    whether trailing bytes were abandoned (a torn tail — the expected
    shape after a crash mid-append)."""
    entries: List[Tuple[int, int, bytes]] = []
    off = 0
    n = len(raw)
    while off + _JRN_HEADER.size <= n:
        magic, ver, kind, _res, gen, plen, crc = _JRN_HEADER.unpack_from(
            raw, off)
        if magic != _JRN_MAGIC or ver != JOURNAL_VERSION \
                or plen > _MAX_PAYLOAD:
            break
        end = off + _JRN_HEADER.size + plen
        if end > n:
            break                       # torn payload
        payload = raw[off + _JRN_HEADER.size:end]
        h0 = _JRN_HEADER.pack(magic, ver, kind, _res, gen, plen, 0)
        if zlib.crc32(h0 + payload) & 0xFFFFFFFF != crc:
            break
        entries.append((kind, gen, payload))
        off = end
    return entries, off, off != n


def _pack_rows(arr: np.ndarray) -> np.ndarray:
    """Per-row packbits (rows x ceil(cols/8)) — the journal's content
    domain, so a delta can address whole packed rows."""
    return np.packbits(np.asarray(arr, dtype=np.uint8), axis=1)


def _unpack_rows(packed: np.ndarray, cols: int) -> np.ndarray:
    return np.unpackbits(packed, axis=1)[:, :cols].astype(np.uint8)


class _ChainState:
    """The working content state of a journal replay: a per-row packed
    matrix (full-board entries) and/or a per-shard tile map (shard
    entries) plus the generations they describe."""

    __slots__ = ("packed", "rows", "cols", "gen", "content_gen", "touched",
                 "shards")

    def __init__(self, packed, rows, cols, gen, content_gen, shards=None):
        self.packed = packed            # (rows, ceil(cols/8)) u8 or None
        self.rows = rows
        self.cols = cols
        self.gen = gen
        self.content_gen = content_gen
        self.touched = False            # any content entry applied?
        # {(r0, c0): (srows, scols, flat_packed_bytes)} — shard-mode
        # content; coexists with ``packed`` only across a mode switch
        # (old full record + new shard commits), where assembly overlays
        # the tiles on the unpacked base
        self.shards = shards

    def apply(self, kind: int, gen: int, payload: bytes) -> bool:
        """Fold one journal entry; False means the chain is broken at
        this entry (stop the replay, keep what was recovered)."""
        if gen < self.gen:
            return True                 # superseded by a newer record
        if kind == _J_MARK:
            self.gen = gen
            return True
        if kind == _J_ROWS:
            if len(payload) < _ROWS_HEAD.size:
                return False
            rows, cols = _ROWS_HEAD.unpack_from(payload)
            nbytes = rows * ((cols + 7) // 8)
            if rows < 1 or cols < 1 or len(payload) != _ROWS_HEAD.size + nbytes:
                return False
            self.packed = np.frombuffer(
                payload, dtype=np.uint8, offset=_ROWS_HEAD.size,
            ).reshape(rows, (cols + 7) // 8).copy()
            self.rows, self.cols = rows, cols
            self.shards = None          # a full-board entry supersedes tiles
            self.gen = self.content_gen = gen
            self.touched = True
            return True
        if kind == _J_DELTA:
            if self.packed is None or len(payload) < _DELTA_HEAD.size:
                return False
            rows, cols, count = _DELTA_HEAD.unpack_from(payload)
            if rows != self.rows or cols != self.cols:
                return False
            rb = (cols + 7) // 8
            want = _DELTA_HEAD.size + count * (4 + rb)
            if count > rows or len(payload) != want:
                return False
            if count:
                idx = np.frombuffer(payload, dtype="<u4",
                                    offset=_DELTA_HEAD.size, count=count)
                if int(idx.max()) >= rows:
                    return False
                data = np.frombuffer(
                    payload, dtype=np.uint8,
                    offset=_DELTA_HEAD.size + 4 * count,
                ).reshape(count, rb)
                self.packed[idx.astype(np.int64)] = data
            self.gen = self.content_gen = gen
            self.touched = True
            return True
        if kind == _J_SHARD:
            if len(payload) < _SHARD_HEAD.size:
                return False
            brows, bcols, r0, c0, srows, scols = _SHARD_HEAD.unpack_from(
                payload)
            nbytes = (srows * scols + 7) // 8
            if (srows < 1 or scols < 1 or brows < 1 or bcols < 1
                    or r0 + srows > brows or c0 + scols > bcols
                    or len(payload) != _SHARD_HEAD.size + nbytes):
                return False
            if self.rows and (brows != self.rows or bcols != self.cols):
                return False
            if self.shards is None:
                self.shards = {}
            self.shards[(r0, c0)] = (srows, scols,
                                     payload[_SHARD_HEAD.size:])
            self.rows, self.cols = brows, bcols
            self.gen = self.content_gen = gen
            self.touched = True
            return True
        return False                    # unknown kind: future version

    def snapshot(self) -> dict:
        """The replay result as a record snapshot dict (no generation
        key — the caller stamps ``content_gen``).  Pure shard mode
        emits a shard-form snapshot; a mode mix (full base overlaid
        with shard tiles) assembles and re-encodes full."""
        if self.shards and self.packed is None:
            return {
                "rows": int(self.rows),
                "cols": int(self.cols),
                "shards": [
                    {"r0": int(r0), "c0": int(c0), "rows": int(sr),
                     "cols": int(sc),
                     "packed": base64.b64encode(pk).decode("ascii")}
                    for (r0, c0), (sr, sc, pk) in sorted(self.shards.items())
                ],
            }
        if self.shards:
            grid = _unpack_rows(self.packed, self.cols)
            for (r0, c0), (sr, sc, pk) in sorted(self.shards.items()):
                grid[r0:r0 + sr, c0:c0 + sc] = wire.unpack_grid(
                    bytes(pk), sr, sc)
            return encode_grid(grid)
        return encode_grid(_unpack_rows(self.packed, self.cols))


class _JournalTrack:
    """Per-sid append-side state: the last journaled content (packed
    per-row) deltas diff against, and the live journal's durable size/
    age for compaction triggers.  Guarded by the owning session's lock
    (the same discipline as ``save``)."""

    __slots__ = ("prev", "gen", "size", "entries", "opened", "prev_shards")

    def __init__(self, prev, gen, prev_shards=None):
        self.prev = prev                # packed per-row content or None
        self.gen = gen
        self.size = 0                   # durable (fsynced) journal bytes
        self.entries = 0
        self.opened = time.monotonic()
        # {(r0, c0): flat_packed_bytes} — the last journaled per-shard
        # content, so a shard commit appends only the tiles that changed
        self.prev_shards = prev_shards


class StateStore:
    """One durable record chain per session under ``state_dir``.

    Record payload shape (v2 envelope; v1 was the same dict as bare
    JSON)::

        {"v": 2, "id": "s3", "spec": {...create body...},
         "generation": 41,
         "snapshot": {"generation": 32, "rows": ..., "cols": ...,
                      "packed": "<base64 np.packbits>"} | null}

    ``save``/``commit_step`` are called with the owning session's lock
    held (generation and snapshot must leave the lock together — the
    same torn-read discipline as the live snapshot verb), so the store's
    own lock only guards counters, the persistence state machine, and
    the shared tmp-name sequence.
    """

    def __init__(self, state_dir: str, checkpoint_every: int = 64, *,
                 journal: bool = True,
                 journal_max_bytes: int = 1 << 20,
                 journal_max_age_s: float = 300.0,
                 keep: int = 2):
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}")
        if journal_max_bytes < 1:
            raise ValueError("journal_max_bytes must be >= 1")
        if journal_max_age_s <= 0:
            raise ValueError("journal_max_age_s must be > 0")
        if keep < 0:
            raise ValueError("keep must be >= 0")
        self.state_dir = state_dir
        self.checkpoint_every = int(checkpoint_every)
        self.journal = bool(journal)
        self.journal_max_bytes = int(journal_max_bytes)
        self.journal_max_age_s = float(journal_max_age_s)
        self.keep = int(keep)
        os.makedirs(state_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._tmp_seq = 0
        self.writes = 0
        self.write_s = 0.0              # accumulated save wall (obs reads it)
        self.snapshot_writes = 0
        self.deletes = 0
        self.load_errors = 0
        # durable-state-plane counters
        self.bytes_full = 0             # record-envelope bytes written
        self.bytes_delta = 0            # journal-entry bytes appended
        self.journal_appends = 0
        self.compactions = 0
        self.corrupt_records = 0        # records quarantined at load
        self.torn_journals = 0          # journals with an abandoned tail
        self.persist_skipped = 0        # writes fast-failed while degraded
        # io fault hook (``FaultInjector.io_hook``) and obs handle; both
        # installed by the SessionManager when armed, both optional
        self.fault_hook = None
        self.obs = None
        self._jrn: Dict[str, _JournalTrack] = {}
        # persistence state machine: closed -> degraded -> recovering
        self._state = "closed"
        self._failures = 0
        self._retry_at = 0.0
        self._pending: set = set()
        self._pending_deletes: set = set()

    # -- paths -------------------------------------------------------------

    def _path(self, sid: str) -> str:
        # session ids are manager-generated ("s<N>") — no traversal risk,
        # but keep the guard so a hand-edited state dir cannot escape
        safe = "".join(ch for ch in sid if ch.isalnum() or ch in "-_")
        return os.path.join(self.state_dir, f"{safe}.json")

    def _jpath(self, sid: str) -> str:
        return f"{self._path(sid)[:-5]}.journal"

    # -- fault choke point --------------------------------------------------

    def _io(self, op: str, a, b=None) -> None:
        """Every byte this store persists flows through here: ``op`` is
        ``write`` (file object, bytes), ``fsync`` (file object), or
        ``replace`` (src, dst).  The fault hook may raise (``raise``/
        ``enospc`` modes), stall (``delay``), or return a tear fraction
        (``torn`` — the write stops at that fraction, flushes the torn
        prefix so it is really on disk, then fails like the kernel
        would)."""
        hook = self.fault_hook
        frac = hook(f"io-{op}") if hook is not None else None
        if op == "write":
            if frac is not None:
                a.write(b[:max(0, int(len(b) * min(1.0, frac)))])
                a.flush()
                raise OSError(errno.EIO,
                              f"injected torn write ({frac:g} of "
                              f"{len(b)} bytes)")
            a.write(b)
        elif op == "fsync":
            if frac is not None:
                raise OSError(errno.EIO, "injected torn fsync")
            a.flush()
            os.fsync(a.fileno())
        else:                           # replace
            if frac is not None:
                raise OSError(errno.EIO, "injected torn replace")
            os.replace(a, b)

    # -- persistence state machine ------------------------------------------

    def _gate(self, sid: str) -> None:
        """Fast-fail while degraded and the backoff has not elapsed: the
        session is queued as pending and the disk is not touched.  The
        first write after the backoff elapses is the recovery probe."""
        with self._lock:
            if self._state != "degraded":
                return
            wait = self._retry_at - time.monotonic()
            if wait <= 0:
                return                  # backoff elapsed: probe the disk
            self._pending.add(sid)
            self.persist_skipped += 1
        raise StorageDegradedError(
            f"persistence degraded; retry in {wait:.2f}s", wait)

    def _io_fail(self, sid: Optional[str]) -> None:
        with self._lock:
            self._failures += 1
            newly = self._state != "degraded"
            self._state = "degraded"
            backoff = min(_BACKOFF_CAP_S,
                          _BACKOFF_BASE_S * (2 ** min(self._failures - 1, 10)))
            self._retry_at = time.monotonic() + backoff
            if sid is not None:
                self._pending.add(sid)
        if newly:
            print(f"warning: persistence DEGRADED under {self.state_dir} "
                  f"(write failed); retrying in {backoff:.1f}s, sessions "
                  f"keep serving", file=sys.stderr)

    def _io_ok(self, sid: Optional[str]) -> None:
        with self._lock:
            if self._state == "closed":
                return
            if sid is not None:
                self._pending.discard(sid)
            if self._pending or self._pending_deletes:
                self._state = "recovering"
            else:
                self._state = "closed"
                self._failures = 0
                self._retry_at = 0.0

    def is_degraded(self) -> bool:
        with self._lock:
            return self._state == "degraded"

    def retry_ready(self) -> bool:
        """True when :meth:`SessionManager.persistence_retry` has work:
        the backoff elapsed on a degraded store, or a recovering store
        still has a pending backlog to flush."""
        with self._lock:
            if self._state == "recovering":
                return bool(self._pending or self._pending_deletes)
            return (self._state == "degraded"
                    and time.monotonic() >= self._retry_at)

    def retry_in_s(self) -> float:
        """Seconds until the next recovery probe — what the transport
        sizes ``Retry-After`` from."""
        with self._lock:
            if self._state != "degraded":
                return 0.0
            return max(0.0, self._retry_at - time.monotonic())

    def take_pending(self) -> List[str]:
        with self._lock:
            return sorted(self._pending)

    def take_pending_deletes(self) -> List[str]:
        with self._lock:
            return sorted(self._pending_deletes)

    def discard_pending(self, sid: str) -> None:
        with self._lock:
            self._pending.discard(sid)
            if self._state != "closed" \
                    and not (self._pending or self._pending_deletes) \
                    and self._state == "recovering":
                self._state = "closed"
                self._failures = 0

    def persistence_state(self) -> dict:
        with self._lock:
            retry = (max(0.0, self._retry_at - time.monotonic())
                     if self._state == "degraded" else 0.0)
            return {
                "state": self._state,
                "pending": len(self._pending) + len(self._pending_deletes),
                "failures": self._failures,
                "retry_in_s": round(retry, 3),
            }

    # -- write path --------------------------------------------------------

    def save(self, sid: str, spec: dict, generation: int,
             snapshot: Optional[dict], *, compaction: bool = False) -> None:
        """Atomically (re)write the full record for ``sid`` inside a v2
        CRC envelope, rotating the previous head (and its journal) one
        step down the last-good chain.  ``snapshot`` is the encoded grid
        dict plus its ``generation`` key, or None (replay will start
        from the seed).  Raises ``OSError`` on IO failure — the caller
        decides whether durability is best-effort (step path) or
        mandatory (drain)."""
        rec = {
            "v": RECORD_VERSION,
            "id": sid,
            "spec": spec,
            "generation": int(generation),
            "snapshot": snapshot,
        }
        blob = _rec_encode(rec)
        path = self._path(sid)
        self._gate(sid)
        t0 = time.perf_counter()
        with self._lock:
            self._tmp_seq += 1
            tmp = f"{path}.tmp{self._tmp_seq}"
        try:
            with open(tmp, "wb") as f:
                self._io("write", f, blob)
                self._io("fsync", f)
            if self.keep:
                self._rotate(sid)
            self._io("replace", tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            self._io_fail(sid)
            raise
        self._io_ok(sid)
        with self._lock:
            self.writes += 1
            self.write_s += time.perf_counter() - t0
            self.bytes_full += len(blob)
            if snapshot is not None:
                self.snapshot_writes += 1
            if compaction:
                self.compactions += 1
        if self.journal:
            prev, prev_shards = None, None
            if snapshot is not None and "shards" in snapshot:
                prev_shards = {
                    (int(sh["r0"]), int(sh["c0"])):
                        base64.b64decode(sh["packed"])
                    for sh in snapshot["shards"]
                }
            elif snapshot is not None:
                prev = _pack_rows(decode_grid(snapshot))
            with self._lock:
                self._jrn[sid] = _JournalTrack(prev, int(generation),
                                               prev_shards)

    def _rotate(self, sid: str) -> None:
        """Shift the head record and its journal one step down the
        ancestor chain (``.json``→``.json.1``→…), deepest first.  A
        missing source removes its destination so record/journal pairs
        never mismatch across depths."""
        path, jpath = self._path(sid), self._jpath(sid)
        for d in range(self.keep, 0, -1):
            src_r = path if d == 1 else f"{path}.{d - 1}"
            src_j = jpath if d == 1 else f"{jpath}.{d - 1}"
            self._shift(src_r, f"{path}.{d}")
            self._shift(src_j, f"{jpath}.{d}")

    @staticmethod
    def _shift(src: str, dst: str) -> None:
        try:
            os.replace(src, dst)
        except FileNotFoundError:
            try:
                os.remove(dst)
            except FileNotFoundError:
                pass

    def commit_step(self, sid: str, spec: dict, generation: int,
                    snapshot: Optional[dict], grid=None,
                    shards=None) -> dict:
        """The step-commit persistence verb: append journal entries
        when journaling (a content ``rows``/``delta`` entry when
        ``grid`` rode along, one ``shard`` entry per *changed* device
        shard when ``shards=(brows, bcols, tiles)`` rode along, a
        ``mark`` otherwise), or rewrite the full record (journaling
        off, no chain base yet, or compaction due).  Returns
        ``{"form": "record"|"journal", "kind", "bytes", "compacted"}``
        for the caller's observability.  Raises ``OSError`` like
        :meth:`save`."""
        if not self.journal:
            self.save(sid, spec, generation, snapshot)
            return {"form": "record", "kind": None, "bytes": 0,
                    "compacted": False}
        with self._lock:
            st = self._jrn.get(sid)
        if st is None:                  # no chain base yet: full record
            self.save(sid, spec, generation, snapshot)
            return {"form": "record", "kind": None, "bytes": 0,
                    "compacted": False}
        if st.entries and (st.size >= self.journal_max_bytes
                           or time.monotonic() - st.opened
                           >= self.journal_max_age_s):
            self.save(sid, spec, generation, snapshot, compaction=True)
            return {"form": "record", "kind": None, "bytes": 0,
                    "compacted": True}
        new_shards = None
        if shards is not None:
            kind, blob, new_shards = self._encode_step_shards(
                st, int(generation), shards)
        else:
            kind, payload = self._encode_step(st, grid)
            blob = _jrn_encode(kind, int(generation), payload)
        self._gate(sid)
        jpath = self._jpath(sid)
        try:
            exists = os.path.exists(jpath)
            with open(jpath, "r+b" if exists else "wb") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() != st.size:
                    # a previously torn append left a bad tail: truncate
                    # back to the last durable entry boundary before
                    # appending, so the reader never loses good entries
                    # behind a torn one
                    f.seek(st.size)
                    f.truncate()
                self._io("write", f, blob)
                self._io("fsync", f)
        except OSError:
            self._io_fail(sid)
            raise
        self._io_ok(sid)
        st.size += len(blob)
        st.entries += 1
        st.gen = int(generation)
        if kind != _J_MARK and grid is not None:
            st.prev = _pack_rows(grid)
        if new_shards is not None:
            st.prev_shards = new_shards
        with self._lock:
            self.journal_appends += 1
            self.bytes_delta += len(blob)
        return {"form": "journal", "kind": _J_KINDS[kind],
                "bytes": len(blob), "compacted": False}

    @staticmethod
    def _encode_step_shards(st: _JournalTrack, generation: int,
                            shards) -> Tuple[int, bytes, Optional[dict]]:
        """Encode a shard-dimension commit: one ``shard`` journal frame
        per tile whose packed content changed since the last journaled
        state (all of them when there is no shard baseline), CRC-framed
        independently so a torn multi-shard append loses only its tail.
        A quiescent commit degenerates to a ``mark``."""
        brows, bcols, tiles = shards
        prev = st.prev_shards
        frames = []
        new_prev = {} if prev is None else dict(prev)
        for r0, c0, tile in tiles:
            arr = np.asarray(tile, dtype=np.uint8)
            packed = wire.pack_grid(arr)
            key = (int(r0), int(c0))
            if prev is not None and prev.get(key) == packed:
                continue
            new_prev[key] = packed
            head = _SHARD_HEAD.pack(int(brows), int(bcols), key[0], key[1],
                                    arr.shape[0], arr.shape[1])
            frames.append(_jrn_encode(_J_SHARD, generation, head + packed))
        if not frames:
            return _J_MARK, _jrn_encode(_J_MARK, generation, b""), new_prev
        return _J_SHARD, b"".join(frames), new_prev

    @staticmethod
    def _encode_step(st: _JournalTrack, grid) -> Tuple[int, bytes]:
        if grid is None:
            return _J_MARK, b""
        arr = np.asarray(grid, dtype=np.uint8)
        rows, cols = arr.shape
        packed = _pack_rows(arr)
        if st.prev is None or st.prev.shape != packed.shape:
            return _J_ROWS, _ROWS_HEAD.pack(rows, cols) + packed.tobytes()
        changed = np.nonzero(np.any(packed != st.prev, axis=1))[0]
        # past half the board a full-rows entry is smaller than the
        # delta's index overhead — and it re-anchors the chain
        if len(changed) * (4 + packed.shape[1]) >= packed.nbytes:
            return _J_ROWS, _ROWS_HEAD.pack(rows, cols) + packed.tobytes()
        head = _DELTA_HEAD.pack(rows, cols, len(changed))
        return _J_DELTA, head + changed.astype("<u4").tobytes() \
            + packed[changed].tobytes()

    def delete(self, sid: str) -> None:
        path, jpath = self._path(sid), self._jpath(sid)
        targets = [path, jpath]
        targets += [f"{path}.{d}" for d in range(1, self.keep + 1)]
        targets += [f"{jpath}.{d}" for d in range(1, self.keep + 1)]
        failed = False
        for p in targets:
            try:
                os.remove(p)
            except FileNotFoundError:
                pass
            except OSError:
                failed = True
        with self._lock:
            self.deletes += 1
            self._jrn.pop(sid, None)
            self._pending.discard(sid)
            if failed:
                self._pending_deletes.add(sid)
            else:
                self._pending_deletes.discard(sid)
        if failed:
            self._io_fail(None)

    def retry_deletes(self) -> None:
        """Re-attempt deletes that failed while the disk was sick (part
        of the recovery flush)."""
        for sid in self.take_pending_deletes():
            with self._lock:
                self._pending_deletes.discard(sid)
            self.delete(sid)
            self._io_ok(None)

    # -- read path ---------------------------------------------------------

    def _quarantine(self, path: str, sid: str, reason: str) -> None:
        base = self._path(sid)[:-5]
        n = 1
        while os.path.exists(f"{base}.corrupt-{n}"):
            n += 1
        qpath = f"{base}.corrupt-{n}"
        try:
            os.replace(path, qpath)
        except OSError:
            qpath = None
        with self._lock:
            self.corrupt_records += 1
        print(f"warning: quarantined corrupt state record {path}"
              f"{' -> ' + qpath if qpath else ''} ({reason}); "
              f"falling back to last-good ancestor", file=sys.stderr)
        obs = self.obs
        if obs is not None:
            obs.event("state_quarantine", sid=sid,
                      path=os.path.basename(path), reason=reason)

    def _load_chain(self, sid: str) -> Optional[dict]:
        """Walk ``sid``'s last-good chain: quarantine corrupt records
        head-first, anchor on the newest verifiable one, then fold in
        every journal from that depth up to the live one.  Returns a
        v1-shaped record dict (``generation`` advanced to the last
        journaled one, ``snapshot`` replaced by the last journaled
        content) or None when nothing was verifiable."""
        path = self._path(sid)
        base, depth = None, 0
        for d in range(0, self.keep + 1):
            p = path if d == 0 else f"{path}.{d}"
            try:
                with open(p, "rb") as f:
                    raw = f.read()
            except FileNotFoundError:
                continue
            except OSError:
                continue
            try:
                rec = _rec_decode(raw)
                if rec["id"] != sid:
                    raise RecordCorrupt(
                        f"record names {rec['id']!r}, expected {sid!r}")
            except RecordCorrupt as e:
                self._quarantine(p, sid, str(e))
                continue
            base, depth = rec, d
            break
        if base is None:
            return None
        snap = base.get("snapshot")
        if snap is not None:
            try:
                if "shards" in snap:
                    shards = {
                        (int(sh["r0"]), int(sh["c0"])):
                            (int(sh["rows"]), int(sh["cols"]),
                             base64.b64decode(sh["packed"]))
                        for sh in snap["shards"]
                    }
                    chain = _ChainState(None,
                                        int(snap["rows"]), int(snap["cols"]),
                                        int(base["generation"]),
                                        int(snap["generation"]),
                                        shards=shards)
                else:
                    chain = _ChainState(_pack_rows(decode_grid(snap)),
                                        int(snap["rows"]), int(snap["cols"]),
                                        int(base["generation"]),
                                        int(snap["generation"]))
            except (KeyError, TypeError, ValueError):
                return None             # snapshot dict itself is malformed
        else:
            chain = _ChainState(None, 0, 0, int(base["generation"]), 0)
        jpath = self._jpath(sid)
        stop = False
        for k in range(depth, -1, -1):
            if stop:
                break
            jp = jpath if k == 0 else f"{jpath}.{k}"
            try:
                with open(jp, "rb") as f:
                    jraw = f.read()
            except (FileNotFoundError, OSError):
                continue
            entries, _good, torn = _jrn_scan(jraw)
            if torn:
                with self._lock:
                    self.torn_journals += 1
            for kind, gen, payload in entries:
                if not chain.apply(kind, gen, payload):
                    stop = True
                    break
        out = dict(base)
        out["v"] = RECORD_VERSION
        out["generation"] = chain.gen
        if chain.touched:
            ns = chain.snapshot()
            ns["generation"] = chain.content_gen
            out["snapshot"] = ns
        return out

    def _sid_set(self) -> List[str]:
        try:
            names = os.listdir(self.state_dir)
        except FileNotFoundError:
            return []
        sids = set()
        for name in names:
            # session records only: the "s"-prefix discipline of
            # list_ids().  The dir is shared with per-node routing
            # tables (routing-<tag>.json) — those are the cluster
            # layer's files, not session records, and must never be
            # "restored" (or quarantined as corrupt records) here.
            if not name.startswith("s"):
                continue
            if name.endswith(".json"):
                sids.add(name[:-5])
            else:
                m = re.match(r"(.+)\.json\.\d+$", name)
                if m:
                    sids.add(m.group(1))
        return sorted(sids)

    def load_records(self) -> List[Dict]:
        """Every recoverable record, ordered by numeric session id (so
        restored ids and the id counter line up deterministically).
        Corrupt heads fall back down their last-good chain; sessions
        with nothing verifiable are skipped and counted
        (``load_errors``) — a recovery pass must salvage what it can,
        not die on the one record a crash mangled."""
        out = []
        for sid in self._sid_set():
            rec = self._load_chain(sid)
            if rec is None:
                with self._lock:
                    self.load_errors += 1
                continue
            out.append(rec)
        out.sort(key=lambda r: _sid_ordinal(r["id"]))
        return out

    def load_record(self, sid: str) -> Optional[Dict]:
        """The one recoverable record for ``sid``, or None (missing —
        closed or never checkpointed — or corrupt with no verifiable
        ancestor, which also counts a load error).  The failover
        adoption path reads exactly one session, verifying every byte
        before adopting; scanning the whole dir per adoption would be
        O(n²) across a dead node's sessions."""
        path = self._path(sid)
        exists = any(os.path.exists(p) for p in
                     [path] + [f"{path}.{d}" for d in range(1, self.keep + 1)])
        if not exists:
            return None
        rec = self._load_chain(sid)
        if rec is None:
            with self._lock:
                self.load_errors += 1
        return rec

    def list_ids(self) -> List[str]:
        """Session ids with a record on disk — filename-derived, no
        parsing (failover scans this for the dead node's tag suffix)."""
        try:
            names = sorted(os.listdir(self.state_dir))
        except FileNotFoundError:
            return []
        return [name[:-5] for name in names
                if name.endswith(".json") and name.startswith("s")]

    def stats(self) -> dict:
        with self._lock:
            return {
                "state_dir": self.state_dir,
                "checkpoint_every": self.checkpoint_every,
                "journal": self.journal,
                "writes": self.writes,
                "write_s": round(self.write_s, 6),
                "snapshot_writes": self.snapshot_writes,
                "deletes": self.deletes,
                "load_errors": self.load_errors,
                "bytes_full": self.bytes_full,
                "bytes_delta": self.bytes_delta,
                "journal_appends": self.journal_appends,
                "compactions": self.compactions,
                "corrupt_records": self.corrupt_records,
                "torn_journals": self.torn_journals,
                "persist_skipped": self.persist_skipped,
                "persistence": self._state,
            }


def _sid_ordinal(sid: str) -> int:
    # the leading digit run only: cluster-format ids ("s5-ab12cd")
    # must sort by ordinal like plain ones, not saturate the counter
    m = re.match(r"s(\d+)", sid)
    return int(m.group(1)) if m else 1 << 30

