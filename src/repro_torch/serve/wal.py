"""Write-ahead log for the serve ingest path (DESIGN.md §11).

Durability contract: every insert/delete micro-batch is serialized as one
WAL record and **group-committed — fsync'd — before any of its tickets
resolve**.  A crash can lose un-acknowledged work (clients retry), but an
acknowledged write is always recoverable as

    restore latest checkpoint  +  replay WAL records with LSN > covering

where "covering" is the LSN the checkpoint manifest records
(`VectorBackend.save(lsn=...)`).  Replay re-dispatches each record
through the engine's normal batch path, so the recovered backend state is
bit-exact with the pre-crash state for the same record sequence.

Record format (little-endian), one record per micro-batch::

    [crc u32][len u32][lsn u64][kind u8][payload len-9 bytes]

`len` counts lsn+kind+payload; `crc` is zlib.crc32 over everything after
the crc field.  LSNs are assigned monotonically from 1 (0 = "none").
Payloads:

- ``KIND_INSERT``: ``n u32 | dim u32 | ext_ids int64[n] | vectors f32[n*dim]``
  — the engine-assigned external ids plus the raw vectors, exactly the
  batch that was dispatched (replay reproduces the identical internal-id
  allocation and graph edges);
- ``KIND_DELETE``: ``n u32 | ext_ids int64[n]`` — the batch **as
  submitted**, before host-side dedup: replay reruns the dedup against
  the restored deleted-set, so duplicated records are absorbed as
  counted no-ops (the existing delete-noop contract).

Segments: records append to ``wal_<first_lsn:016d>.log`` files under the
WAL directory; a segment exceeding ``segment_bytes`` is closed (fsync'd)
and a new one opened.  On open, segments are scanned in LSN order with
CRC verification; a torn tail (partial or corrupt record — the crash
landed mid-write) truncates the file at the last valid record, and any
segments after a truncation point are dropped.  ``truncate_through``
unlinks segments wholly covered by a checkpoint's LSN.

Group commit: ``append_*`` only buffers (OS page cache); ``sync()``
fsyncs everything appended so far.  The engine batches syncs across
micro-batches (``group_commit_n`` records / ``group_commit_ms`` oldest
pending age) and defers ticket resolution until the covering sync — see
``ServeEngine._commit_wal``.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

KIND_INSERT = 1
KIND_DELETE = 2

_HDR = struct.Struct("<IIQB")        # crc, len, lsn, kind
_CRC_OFF = 4                         # crc covers bytes [4:] of the record

NO_LSN = 0                           # "no records" / "nothing covered"


@dataclass(frozen=True)
class WalConfig:
    """Knobs for the serve-path write-ahead log.

    ``group_commit_n``/``group_commit_ms`` shape the engine's commit
    policy: fsync once ``n`` batch records are pending, or once the
    oldest pending record has waited ``ms`` milliseconds — whichever
    comes first.  The defaults (1 / 0.0) commit every micro-batch.
    ``sync=False`` skips fsync entirely (flush-only): the benchmark's
    "how much of the overhead is the fsync" probe, never a durability
    mode.
    """

    dir: str
    segment_bytes: int = 4 << 20
    group_commit_n: int = 1
    group_commit_ms: float = 0.0
    sync: bool = True


@dataclass(frozen=True)
class WalRecord:
    lsn: int
    kind: int
    ext_ids: np.ndarray                 # int64[n]
    vectors: Optional[np.ndarray] = None  # f32[n, dim] (inserts only)


def _encode_insert(ext_ids: np.ndarray, vectors: np.ndarray) -> bytes:
    n, dim = vectors.shape
    return (struct.pack("<II", n, dim)
            + np.ascontiguousarray(ext_ids, np.int64).tobytes()
            + np.ascontiguousarray(vectors, np.float32).tobytes())


def _encode_delete(ext_ids: np.ndarray) -> bytes:
    return (struct.pack("<II", len(ext_ids), 0)
            + np.ascontiguousarray(ext_ids, np.int64).tobytes())


def _decode(lsn: int, kind: int, payload: bytes) -> WalRecord:
    n, dim = struct.unpack_from("<II", payload)
    off = 8
    ext = np.frombuffer(payload, np.int64, count=n, offset=off).copy()
    off += 8 * n
    if kind == KIND_INSERT:
        vec = np.frombuffer(payload, np.float32, count=n * dim,
                            offset=off).reshape(n, dim).copy()
        return WalRecord(lsn, kind, ext, vec)
    return WalRecord(lsn, kind, ext)


class WriteAheadLog:
    """Segmented, CRC-checked, group-committed WAL (see module doc).

    Opening scans every segment, truncates any torn tail, and leaves the
    log positioned to append at ``last_lsn + 1``.  Records recovered by
    the scan are available through :meth:`records` until the log is
    closed (recovery replays them; appends go to the active segment).
    """

    def __init__(self, cfg: WalConfig):
        self.cfg = cfg
        os.makedirs(cfg.dir, exist_ok=True)
        self._recovered: List[WalRecord] = []
        #: per segment: [path, first_lsn, last_lsn]
        self._segments: List[list] = []
        self._file = None
        self.last_lsn = NO_LSN       # last appended (not necessarily synced)
        self.synced_lsn = NO_LSN
        self.n_unsynced = 0
        self.n_syncs = 0
        self.n_records = 0
        self.bytes_appended = 0
        self._open_scan()

    # -- open/recovery --------------------------------------------------------

    def _seg_path(self, first_lsn: int) -> str:
        return os.path.join(self.cfg.dir, f"wal_{first_lsn:016d}.log")

    def _scan_segment(self, path: str,
                      expect_lsn: int) -> Tuple[List[WalRecord], bool]:
        """Parse one segment; returns (records, clean).

        Records must extend the LSN chain exactly (first record carries
        `expect_lsn`, each next +1).  A torn/corrupt/discontinuous tail
        is truncated in place and reported as clean=False.
        """
        out: List[WalRecord] = []
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off + _HDR.size <= len(data):
            crc, length, lsn, kind = _HDR.unpack_from(data, off)
            end = off + 8 + length           # crc(4)+len(4) then `length`
            if length < 9 or end > len(data):
                break                        # torn tail (partial write)
            if zlib.crc32(data[off + _CRC_OFF:end]) != crc:
                break                        # corrupt record
            if lsn != expect_lsn:
                break                        # chain discontinuity
            out.append(_decode(lsn, kind, data[off + _HDR.size:end]))
            expect_lsn += 1
            off = end
        clean = off == len(data)
        if not clean:
            with open(path, "r+b") as f:
                f.truncate(off)
        return out, clean

    def _open_scan(self) -> None:
        names = sorted(n for n in os.listdir(self.cfg.dir)
                       if n.startswith("wal_") and n.endswith(".log"))
        if names:
            # the log need not start at LSN 1: checkpoint truncation
            # unlinks covered segments, so the earliest surviving
            # segment's filename carries the first expected LSN
            self.last_lsn = int(names[0][4:-4]) - 1
        truncated = False
        for name in names:
            path = os.path.join(self.cfg.dir, name)
            if truncated:
                # a torn segment ends the log: later segments are an
                # unreachable suffix and must not resurrect mid-stream
                os.unlink(path)
                continue
            recs, clean = self._scan_segment(path, self.last_lsn + 1)
            if not recs and clean:
                if name == names[-1]:
                    # empty clean TAIL segment: keep it as the active
                    # segment.  Its filename is the only durable copy of
                    # the LSN high-water mark once a checkpoint has
                    # truncated every earlier segment — unlinking it
                    # would reset LSN allocation to 1 on the restart
                    # after next, making new records invisible to a
                    # recovery that replays past the covering LSN
                    self._segments.append(
                        [path, self.last_lsn + 1, self.last_lsn])
                else:
                    # empty non-tail segment (can only arise from an
                    # interrupted create): nothing durable to preserve
                    os.unlink(path)
                continue
            self._recovered.extend(recs)
            first = recs[0].lsn if recs else self.last_lsn + 1
            if recs:
                self.last_lsn = recs[-1].lsn
            self._segments.append([path, first, self.last_lsn])
            if not clean:
                truncated = True
        self.synced_lsn = self.last_lsn
        # position the active segment for appends
        if self._segments:
            self._file = open(self._segments[-1][0], "ab")
        self._fsync_dir()

    def _fsync_dir(self) -> None:
        fd = os.open(self.cfg.dir, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    # -- append path ----------------------------------------------------------

    def _rotate(self) -> None:
        if self._file is not None:
            self._file.flush()
            if self.cfg.sync:
                os.fsync(self._file.fileno())
            self._file.close()
        first = self.last_lsn + 1
        path = self._seg_path(first)
        self._file = open(path, "ab")
        self._segments.append([path, first, self.last_lsn])
        self._fsync_dir()

    def _append(self, kind: int, payload: bytes) -> int:
        if self._file is None or self._file.tell() >= self.cfg.segment_bytes:
            self._rotate()
        lsn = self.last_lsn + 1
        body = struct.pack("<IQB", len(payload) + 9, lsn, kind) + payload
        rec = struct.pack("<I", zlib.crc32(body)) + body
        self._file.write(rec)
        self.last_lsn = lsn
        self._segments[-1][2] = lsn
        self.n_unsynced += 1
        self.n_records += 1
        self.bytes_appended += len(rec)
        return lsn

    def append_insert(self, ext_ids: np.ndarray, vectors: np.ndarray) -> int:
        """Log one insert micro-batch; returns its LSN (not yet durable)."""
        return self._append(KIND_INSERT, _encode_insert(
            np.asarray(ext_ids, np.int64),
            np.atleast_2d(np.asarray(vectors, np.float32))))

    def append_delete(self, ext_ids: np.ndarray) -> int:
        """Log one delete micro-batch (as submitted, pre-dedup)."""
        return self._append(KIND_DELETE, _encode_delete(
            np.atleast_1d(np.asarray(ext_ids, np.int64))))

    def sync(self) -> int:
        """Make everything appended so far durable; returns the covered
        LSN.  The group-commit point: tickets staged behind this sync
        may resolve once it returns."""
        if self._file is not None and self.n_unsynced:
            self._file.flush()
            if self.cfg.sync:
                os.fsync(self._file.fileno())
            self.n_syncs += 1
        self.synced_lsn = self.last_lsn
        self.n_unsynced = 0
        return self.synced_lsn

    # -- recovery / retention -------------------------------------------------

    def records(self, after: int = NO_LSN) -> List[WalRecord]:
        """Recovered records with LSN > `after`, in LSN order.  Only
        records present at open time are returned (recovery reads the
        log before new appends)."""
        return [r for r in self._recovered if r.lsn > after]

    def truncate_through(self, lsn: int) -> int:
        """Drop whole segments whose records are all <= `lsn` (covered
        by a checkpoint).  The active segment is rotated out first if it
        is fully covered, so the file holding the next append is never
        unlinked.  Returns the number of segments removed."""
        if not self._segments or lsn < self._segments[0][2]:
            return 0
        last = self._segments[-1]
        if last[2] <= lsn and last[1] <= last[2] and self.n_unsynced == 0:
            # rotate only a non-empty active segment: an empty one
            # (first > last) is already the post-truncation state, and
            # re-rotating would re-open the same filename as a
            # duplicate segment entry
            self._rotate()
        removed = 0
        keep = []
        for seg in self._segments[:-1]:
            if seg[2] <= lsn and seg[1] <= seg[2]:
                os.unlink(seg[0])
                removed += 1
            else:
                keep.append(seg)
        self._segments = keep + self._segments[-1:]
        self._recovered = [r for r in self._recovered if r.lsn > lsn]
        if removed:
            self._fsync_dir()
        return removed

    def close(self) -> None:
        if self._file is not None:
            self.sync()
            self._file.close()
            self._file = None

    def abandon(self) -> None:
        """Simulate process death: release the active segment's fd
        WITHOUT flushing the userspace buffer.  A killed process never
        flushes; if the abandoned BufferedWriter were left to flush on
        close/GC it could interleave a stale (possibly duplicate-LSN,
        possibly partial) record into the very segment a recovered
        engine is now appending to, corrupting the chain so a later
        scan truncates at the stale record.  Closing the raw FileIO
        marks the buffered wrapper closed, so its pending bytes are
        dropped and never reach a (potentially recycled) fd."""
        f, self._file = self._file, None
        if f is None:
            return
        try:
            f.raw.close()
        except (OSError, ValueError):
            pass
