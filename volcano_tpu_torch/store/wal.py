"""Segment write-ahead log: crash-consistent durability for the store server.

The port's copy of ``volcano_tpu/store/wal.py`` (the group commit's
condition is a plain ``threading.Condition``: the lock sanitizer is
ROADMAP item 13).  Its records and segment files are the JAX package's
byte for byte, so either package's server recovers the other's directory.

The reference treats etcd as the durable bus — every ACKed write survives
an apiserver crash because etcd fsyncs its raft log before replying
(SURVEY.md §1).  The StoreServer's interval snapshots explicitly did not:
with ``save_interval > 0`` a mutation was ACKed before persistence and up
to one interval of acknowledged writes died with the process.  This module
closes that gap with the same mechanism etcd uses, shaped for this store's
wire: an append-only log of CRC-framed records whose payloads ARE the
existing wire forms (per-op patches, whole ``DecisionSegment`` dicts from
store/segment.py — a 102k-bind cycle is ONE record, not 102k), fsynced in
group-commit batches before any 2xx leaves the server.

Layout: a directory of numbered segment files (``00000001.wal``, ...).
Each record is ``<u32 payload length><u32 crc32(payload)><payload json>``.
Appends go to the newest segment; a checkpoint (StoreServer.flush_state)
``rotate()``\\ s to a fresh segment under the server lock, snapshots the
store with the new segment index as its ``wal_floor``, and then
``drop_below(floor)`` unlinks the covered segments.  Recovery = load the
snapshot, replay every record in segments >= floor, torn-tail tolerant: a
truncated or CRC-failing record ends replay (the bytes after it are
discarded — they were never ACKed), never raises.

Group commit: appends are cheap buffered-at-the-OS writes (the file is
opened unbuffered, so a SIGKILLed process cannot lose a completed append
to a userspace buffer); ``commit(ticket)`` blocks until the record is
fsynced, with one leader thread fsyncing on behalf of every waiter that
arrived while the previous fsync was in flight — N concurrent mutations
pay ~1 fsync, and a decision segment amortizes one fsync over a whole
cycle's binds.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

#: per-record frame header: payload byte length + crc32(payload)
_HEADER = struct.Struct("<II")

#: segment file name shape (index order == replay order)
_SEG_FMT = "{:08d}.wal"


def _seg_path(dir_path: str, index: int) -> str:
    return os.path.join(dir_path, _SEG_FMT.format(index))


def list_segment_indices(dir_path: str):
    """Sorted indices of the segment files in ``dir_path`` (module-level:
    also used by WAL-off recovery to absorb a leftover tail)."""
    try:
        names = os.listdir(dir_path)
    except OSError:
        return []
    return sorted(i for i in (_seg_index(n) for n in names) if i is not None)


def fsync_dir(dir_path: str) -> None:
    """Make directory-entry changes (segment create, unlink, snapshot
    rename) durable: record-level fsyncs protect file DATA, but a power
    loss can still drop a freshly created name from an un-synced
    directory — taking every acked record in that segment with it."""
    try:
        fd = os.open(dir_path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds: best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _seg_index(name: str) -> Optional[int]:
    if not name.endswith(".wal"):
        return None
    stem = name[:-4]
    return int(stem) if stem.isdigit() else None


def frame_record(record: Dict[str, Any]) -> bytes:
    """One wire frame for ``record``: length + crc32 header, json payload."""
    payload = json.dumps(record, separators=(",", ":")).encode()
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def read_records(path: str) -> Tuple[List[Dict[str, Any]], bool]:
    """Every intact record in one segment file, in append order, plus
    whether the file ended torn (a truncated or CRC-failing record —
    discarded, never an error: bytes after the last intact frame were
    never fsync-ACKed, so dropping them IS the durability contract)."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return out, True
    off, n = 0, len(data)
    while off + _HEADER.size <= n:
        length, crc = _HEADER.unpack_from(data, off)
        start = off + _HEADER.size
        end = start + length
        if end > n:
            return out, True  # torn tail: record advertised more bytes
        payload = data[start:end]
        if zlib.crc32(payload) != crc:
            return out, True  # torn/corrupt record: discard it and the rest
        try:
            out.append(json.loads(payload))
        except ValueError:
            return out, True
        off = end
    return out, off != n  # trailing partial header counts as torn


class WriteAheadLog:
    """Appendable segment WAL over a directory (see module docstring).

    Thread contract: ``append`` may run under the StoreServer lock (it
    only takes the WAL's own condition, never the reverse), ``commit``
    must run OUTSIDE the server lock — the fsync is the slow half and
    group commit exists so concurrent requests share it.
    """

    def __init__(self, dir_path: str):
        os.makedirs(dir_path, exist_ok=True)
        self.dir = dir_path
        self._cv = threading.Condition()
        self._appended = 0  # append tickets issued
        self._synced = 0  # highest ticket covered by an fsync
        self._syncing = False  # a leader fsync is in flight
        self._killed = False
        # observability (mirrored into volcano_store_wal_* by the server)
        self.appended_records = 0
        self.fsync_total = 0
        self.fsync_s = 0.0
        self.replayed_records = 0
        self.torn_tails = 0
        existing = self.segment_indices()
        self._index = (existing[-1] + 1) if existing else 1
        # a fresh segment per process: never append to a file whose tail
        # may be torn from the previous life
        self._f = open(_seg_path(self.dir, self._index), "ab", buffering=0)
        fsync_dir(self.dir)  # the new segment's NAME must survive too

    # -- append / group-commit fsync --------------------------------------

    def append(self, record: Dict[str, Any]) -> int:
        """Write one framed record (unbuffered; survives SIGKILL once the
        write returns) and return its commit ticket.  The record is NOT
        yet durable against power loss — ``commit(ticket)`` is the
        ACK barrier."""
        frame = frame_record(record)
        with self._cv:
            if self._killed:
                raise OSError("WAL killed")
            self._f.write(frame)
            self._appended += 1
            self.appended_records += 1
            return self._appended

    def commit(self, ticket: Optional[int] = None) -> None:
        """Block until every record up to ``ticket`` (default: all
        appended so far) is fsynced.  Leader-based group commit: the
        first waiter fsyncs everything appended so far; waiters that
        arrive mid-fsync are covered by the NEXT leader's single fsync."""
        import time as _time

        with self._cv:
            if ticket is None:
                ticket = self._appended
            while True:
                if self._synced >= ticket or self._killed:
                    return
                if not self._syncing:
                    break  # become the leader
                self._cv.wait()
            self._syncing = True
            target = self._appended
            fd = self._f.fileno()
        t0 = _time.perf_counter()
        ok = False
        try:
            os.fsync(fd)
            ok = True
        finally:
            dur = _time.perf_counter() - t0
            with self._cv:
                self._syncing = False
                if ok:
                    # advance ONLY on success: a failed fsync must leave
                    # the range un-synced so a follower retakes leadership
                    # and retries — marking it synced would 2xx mutations
                    # that were never made durable
                    self._synced = max(self._synced, target)
                    self.fsync_total += 1
                self.fsync_s += dur
                self._cv.notify_all()
        if ok:
            from volcano_tpu_torch.scheduler import metrics

            metrics.register_wal_fsync()
            # group-commit fsync tail latency: the histogram behind
            # volcano_store_wal_fsync_seconds on /metrics and vtctl top
            metrics.observe_wal_fsync(dur)

    def append_commit(self, record: Dict[str, Any]) -> None:
        self.commit(self.append(record))

    def synced_ticket(self) -> int:
        """Highest append ticket covered by a successful fsync (the
        watermark replication ships below, ROADMAP item 11b)."""
        with self._cv:
            return self._synced

    # -- checkpoint protocol ----------------------------------------------

    def rotate(self) -> int:
        """Close the live segment and open the next one; returns the new
        segment index — the ``wal_floor`` for a snapshot taken in the
        same critical section (every record already appended lives in a
        segment below the floor; every later record lands at/above it)."""
        with self._cv:
            # a group-commit leader may be fsyncing this descriptor
            # outside the lock: closing it under them would turn an
            # applied, durable mutation into an EBADF 500 (or fsync a
            # reused fd); wait the in-flight sync out first
            while self._syncing:
                self._cv.wait()
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            self._synced = self._appended
            self._index += 1
            self._f = open(_seg_path(self.dir, self._index), "ab", buffering=0)
            fsync_dir(self.dir)
            return self._index

    def drop_below(self, floor: int) -> None:
        """Unlink segments the snapshot now covers (index < floor).
        Called AFTER the snapshot's atomic rename — a crash in between
        leaves stale segments that the next recovery skips (and reaps)
        via the snapshot's recorded floor."""
        dropped = False
        for idx in self.segment_indices():
            # never the live segment: a restored-from-backup snapshot can
            # carry a floor ABOVE this life's rebuilt index — unlinking
            # the open file would turn every future acked append into an
            # anonymous-inode write the next recovery cannot see
            if idx < floor and idx < self._index:
                try:
                    os.unlink(_seg_path(self.dir, idx))
                    dropped = True
                except OSError:
                    pass
        if dropped:
            fsync_dir(self.dir)

    def drop_all(self) -> None:
        """Discard every non-live segment — stale lineage (the newest
        snapshot was written by a WAL-off life; see StoreServer._recover)."""
        self.drop_below(self._index)

    def segment_indices(self) -> List[int]:
        return list_segment_indices(self.dir)

    # -- recovery ----------------------------------------------------------

    def replay(self, floor: int = 0) -> Iterator[Dict[str, Any]]:
        """Yield every intact record from segments >= ``floor`` in append
        order; stale segments below the floor are reaped.  A torn/CRC-
        failing record ends replay of ITS segment only — torn bytes are
        by construction un-ACKed (the frame never finished, so no fsync
        covered it and no 2xx left the server), while records in LATER
        segments were appended by a later process life on top of exactly
        this repaired prefix, so replay continues through them."""
        self.drop_below(floor)
        for idx in self.segment_indices():
            if idx < floor or idx >= self._index:
                continue  # own live segment is empty by construction
            records, torn = read_records(_seg_path(self.dir, idx))
            for rec in records:
                self.replayed_records += 1
                yield rec
            if torn:
                self.torn_tails += 1

    # -- lifecycle ----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            return {
                "records": self.appended_records,
                "fsync_total": self.fsync_total,
                "fsync_s": round(self.fsync_s, 4),
                "replayed_records": self.replayed_records,
                "torn_tails": self.torn_tails,
                "segment": self._index,
            }

    def sync_close(self) -> None:
        """Graceful shutdown: fsync the tail, close the segment."""
        with self._cv:
            if self._killed:
                return
            while self._syncing:  # same descriptor-close race as rotate()
                self._cv.wait()
            self._killed = True
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            finally:
                self._f.close()
            self._synced = self._appended
            self._cv.notify_all()

    def kill(self) -> None:
        """Crash-harness hook: die like SIGKILL — close the descriptor
        with NO fsync and refuse further appends.  (Unbuffered appends
        already issued are in the page cache, exactly as they would be
        after a real process kill.)"""
        with self._cv:
            if self._killed:
                return
            self._killed = True
            try:
                self._f.close()
            except OSError:
                pass
            self._cv.notify_all()
