"""The partitioned store bus: the decision stream sharded by namespace hash.

The port's copy of ``volcano_tpu/store/partition.py``.  The columnar wire
made a cycle's output ONE ``DecisionSegment`` and the WAL made it ONE
durable record, but both still pass through one server lock, one WAL
file, one fsync leader and one watch log.  This module partitions that
pipe.  The shard key is the namespace hash (``shard_of``): every decision
row, WAL record and watch-log entry of a namespace lands on the same
shard, so each shard's stream is complete and ordered for the objects it
covers.

* ``split_segment``, the client half: a cycle's segment splits into one
  sub-segment a shard (row order kept within a shard, node tables
  re-interned a shard, one reserved Event uid block a sub-segment).  The
  async applier ships them concurrently; the server applies each under
  its shard's apply lock.
* ``ShardedWAL``: one ``WriteAheadLog`` directory a shard (``<wal>/s00``,
  ``s01``, ...) with an fsync leader each, so a segment for shard 2 never
  waits behind shard 0's fsync.  Records keep their global ``seq`` stamps,
  and recovery merges the shards' tails into one ordered replay.
* ``shard_of`` / ``shard_of_key`` / ``wal_shard``: the one hash the client
  split, the server's routing, the WAL placement and the watch tags agree
  on.  Cluster-scoped objects (namespace ``""``) hash like any other.

``StoreServer(shards=N)`` (``store/server.py``) carries the rest:
shard-tagged watch-log entries, ``/watch?shard=i``, the apply locks and
the sharded WAL in the checkpoint and recovery protocol (a floor a shard
in the state file's ``wal_floor``).  ``shards=1`` is the unpartitioned
server byte for byte.
"""

from __future__ import annotations

import os
import threading
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

#: the name of one shard's WAL subdirectory
_SHARD_DIR_FMT = "s{:02d}"


def shard_wal_dir(wal_dir: str, shard: int) -> str:
    """The WAL directory of shard ``shard`` under a partitioned bus's root
    (``<wal>/s00`` ...): the layout either package's server recovers."""
    return os.path.join(wal_dir, _SHARD_DIR_FMT.format(int(shard)))


def shard_of(namespace: str, nshards: int) -> int:
    """The shard a namespace's stream lands on: crc32 of the namespace
    modulo the shard count, stable across processes and runs (never
    Python's salted ``hash``)."""
    if nshards <= 1:
        return 0
    return zlib.crc32(namespace.encode()) % nshards


def shard_of_key(key: str, nshards: int) -> int:
    """The shard of an object key (``namespace/name``; a cluster-scoped key
    has an empty namespace and hashes like any other)."""
    if nshards <= 1:
        return 0
    ns, _, _ = key.partition("/")
    return shard_of(ns, nshards)


def wal_shard(rec: Dict[str, Any], nshards: int) -> int:
    """The WAL shard of one wire record.  A segment carries its shard (the
    client split decided it); a per-object record follows its object's
    namespace, so one namespace's history stays on one shard."""
    if nshards <= 1:
        return 0
    if rec.get("op") == "segment":
        return int(rec.get("shard", 0)) % nshards
    key = rec.get("key")
    if isinstance(key, str):
        return shard_of_key(key, nshards)
    keys = rec.get("keys")
    if isinstance(keys, list) and keys and isinstance(keys[0], str):
        # a columnar patch run: its first key decides (deterministic)
        return shard_of_key(keys[0], nshards)
    obj = rec.get("object")
    if isinstance(obj, dict):
        meta = obj.get("meta") or {}
        return shard_of(str(meta.get("namespace") or ""), nshards)
    return 0


def split_segment(seg, nshards: int) -> List[Tuple[int, Any]]:
    """Split one cycle's ``DecisionSegment`` into a sub-segment a shard.

    Rows keep their order within a shard; a node table holds only the
    nodes its shard references, in first-reference order; every non-empty
    sub-segment reserves its own Event uid block (``DecisionSegment.build``),
    so that the server names its Events with no cross-shard coordination.
    Returns ``[(shard, sub-segment)]`` for the non-empty shards; callers
    ship each with the ``shard`` tag on the wire op."""
    from volcano_tpu_torch.store.segment import DecisionSegment

    if nshards <= 1:
        return [(0, seg)]
    binds: List[List[Tuple[str, str]]] = [[] for _ in range(nshards)]
    evicts: List[List[Tuple[str, str]]] = [[] for _ in range(nshards)]
    table = seg.node_table
    # the hash runs once a distinct namespace (dozens), not a row (100k+)
    ns_shard: Dict[str, int] = {}

    def _shard(key: str) -> int:
        ns, _, _ = key.partition("/")
        s = ns_shard.get(ns)
        if s is None:
            s = ns_shard[ns] = shard_of(ns, nshards)
        return s

    for i, key in enumerate(seg.bind_keys):
        binds[_shard(key)].append((key, table[seg.bind_nodes[i]]))
    reasons = seg.evict_reason_strs
    for j, key in enumerate(seg.evict_keys):
        evicts[_shard(key)].append((key, reasons[j]))
    out: List[Tuple[int, Any]] = []
    for s in range(nshards):
        if not binds[s] and not evicts[s]:
            continue
        interned: Dict[str, int] = {}
        node_table: List[str] = []
        bind_keys: List[str] = []
        bind_nodes: List[int] = []
        for key, host in binds[s]:
            idx = interned.get(host)
            if idx is None:
                idx = interned[host] = len(node_table)
                node_table.append(host)
            bind_keys.append(key)
            bind_nodes.append(idx)
        out.append((s, DecisionSegment.build(bind_keys, bind_nodes, node_table,
                                             evicts[s] or None)))
    return out


class ShardedWAL:
    """N independent ``WriteAheadLog``\\ s under one directory, one a shard
    (``s00/``, ``s01/``, ...), with the single WAL's surface except that
    ``rotate`` / ``replay`` / ``drop_below`` take a floor list (one a
    shard) and ``append`` may name the shard.

    Each shard has its own fsync leader, so group commit batches a shard
    and concurrent sub-segment ships never share a barrier.  Replay
    recovers the global order from the records' ``seq`` stamps (assigned
    under the server lock), merged across the shards."""

    def __init__(self, dir_path: str, nshards: int):
        from volcano_tpu_torch.store.wal import WriteAheadLog

        if nshards < 2:
            raise ValueError("ShardedWAL needs >= 2 shards; use WriteAheadLog for one")
        os.makedirs(dir_path, exist_ok=True)
        self.dir = dir_path
        self.nshards = nshards
        self.wals: List[WriteAheadLog] = [WriteAheadLog(shard_wal_dir(dir_path, s))
                                          for s in range(nshards)]
        # serializes the floor bookkeeping of rotate / drop (a shard's own
        # appends and fsyncs stay under its WAL's condition)
        self._mu = threading.Lock()

    # -- append / group commit -------------------------------------------------

    def append(self, rec: Dict[str, Any], shard: Optional[int] = None) -> int:
        s = wal_shard(rec, self.nshards) if shard is None else shard
        return self.wals[s % self.nshards].append(rec)

    def commit(self, ticket: Optional[int] = None) -> None:
        """Fsync every shard with appends not yet synced.  A shard whose tail
        is durable returns at once, so a request that touched one shard
        pays one fsync, and two requests on two shards pay two concurrent
        ones."""
        for w in self.wals:
            w.commit()

    def synced_tickets(self) -> List[int]:
        """The fsync watermark of each shard (``WriteAheadLog.synced_ticket``)."""
        return [w.synced_ticket() for w in self.wals]

    # -- checkpoint protocol -----------------------------------------------------

    def rotate(self) -> List[int]:
        """Rotate every shard; the floor list is the snapshot's ``wal_floor``."""
        with self._mu:
            return [w.rotate() for w in self.wals]

    def drop_below(self, floors) -> None:
        with self._mu:
            for w, f in zip(self.wals, self._floor_list(floors)):
                w.drop_below(f)

    def drop_all(self) -> None:
        with self._mu:
            for w in self.wals:
                w.drop_all()

    def _floor_list(self, floors) -> List[int]:
        if isinstance(floors, int):
            # a floor a one-shard life stamped: meaningful only as "all
            # covered" (recovery absorbs the rest through the seq merge)
            return [floors] * self.nshards
        out = [int(f) for f in floors]
        if len(out) < self.nshards:
            out += [0] * (self.nshards - len(out))
        return out[: self.nshards]

    # -- recovery ------------------------------------------------------------------

    def replay(self, floors=0) -> Iterator[Dict[str, Any]]:
        """Every intact record of every shard's segments at or above its
        floor, merged into the global order by ``seq`` (the stable sort
        keeps a shard's append order; ties are records of one shard under
        one seq, which the server never writes)."""
        records: List[Tuple[int, int, Dict[str, Any]]] = []
        for w, f in zip(self.wals, self._floor_list(floors)):
            for i, rec in enumerate(w.replay(f)):
                records.append((int(rec.get("seq", 0)), i, rec))
        records.sort(key=lambda t: (t[0], t[1]))
        for _, _, rec in records:
            yield rec

    @property
    def torn_tails(self) -> int:
        return sum(w.torn_tails for w in self.wals)

    # -- lifecycle -------------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        per = [w.stats() for w in self.wals]
        return {
            "shards": self.nshards,
            "records": sum(p["records"] for p in per),
            "fsync_total": sum(p["fsync_total"] for p in per),
            "fsync_s": round(sum(p["fsync_s"] for p in per), 4),
            "replayed_records": sum(p["replayed_records"] for p in per),
            "torn_tails": sum(p["torn_tails"] for p in per),
            "per_shard": per,
        }

    def sync_close(self) -> None:
        for w in self.wals:
            w.sync_close()

    def kill(self) -> None:
        for w in self.wals:
            w.kill()


def leftover_shard_dirs(wal_dir: str) -> List[str]:
    """The shard subdirectories (``<wal>/s00`` ...) a partitioned WAL-on
    life left: the WAL-off absorb scans them too, so that dropping from a
    partitioned bus to interval persistence loses no acknowledged tail."""
    try:
        names = os.listdir(wal_dir)
    except OSError:
        return []
    out = []
    for n in sorted(names):
        p = os.path.join(wal_dir, n)
        if len(n) == 3 and n.startswith("s") and n[1:].isdigit() and os.path.isdir(p):
            out.append(p)
    return out
