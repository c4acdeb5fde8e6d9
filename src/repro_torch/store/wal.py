"""Checksummed append-only write-ahead log (DESIGN.md §9).

The WAL is the durability boundary of the mutable store: a triple (or
dictionary entry) is ACKNOWLEDGED exactly when the record holding it has
been written AND fsynced. A process killed at ANY byte boundary leaves a
durable prefix of complete records, possibly followed by one torn tail;
recovery replays the prefix and truncates the tail, so the recovered
store is bit-identical to a fresh build over the acknowledged data and
never contains an un-acked triple.

Record framing (little-endian)::

    MAGIC   u32   0x57414C31 ("WAL1") — resync sentinel / version tag
    seq     u64   monotonically increasing record sequence number
    type    u8    1 = triples batch, 2 = dictionary append
    length  u32   payload byte length
    payload bytes
    crc32   u32   zlib.crc32 over header + payload

The reader stops at the first record that is truncated, fails its CRC,
has the wrong magic, or regresses the sequence number — everything at or
past that point was never acknowledged. The writer, on reopen, truncates
the file back to the end of the valid prefix (torn-tail repair) before
appending, so one crash can never poison later appends.

Payloads:
  * ``REC_TRIPLES`` — N packed ``<u32 s, u32 p, u32 o>`` id triples.
  * ``REC_DICT``    — ``<u32 idx, u32 len>`` + utf-8 term bytes per entry;
    ``idx`` is the id the entry was minted with, so replay is idempotent
    (``Dictionary.replay_term``).

Fault injection: a
:class:`~repro_torch.serve.faults.DurabilityFaultPlan` hooks
``append``/``sync`` to simulate torn writes, lost un-synced bytes, and
process crashes at exact byte boundaries — the chaos harness for the
recovery path.

This module is numpy and ``struct`` only, and its byte format is the JAX
package's (``repro.store.wal``): a log written by either package reads
back in the other to the same records.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, Optional

import numpy as np

MAGIC = 0x57414C31  # "WAL1"
_HEADER = struct.Struct("<IQBI")   # magic, seq, type, length
_CRC = struct.Struct("<I")
HEADER_SIZE = _HEADER.size         # 17
CRC_SIZE = _CRC.size               # 4

REC_TRIPLES = 1
REC_DICT = 2

_TRIPLE = struct.Struct("<III")
_DICT_ENT = struct.Struct("<II")


def encode_record(seq: int, rec_type: int, payload: bytes) -> bytes:
    head = _HEADER.pack(MAGIC, seq, rec_type, len(payload))
    crc = zlib.crc32(head + payload) & 0xFFFFFFFF
    return head + payload + _CRC.pack(crc)


def encode_triples_payload(triples: np.ndarray) -> bytes:
    """(N, 3) int array -> payload bytes."""
    t = np.ascontiguousarray(np.asarray(triples, np.uint32))
    return t.tobytes()


def decode_triples_payload(payload: bytes) -> np.ndarray:
    if len(payload) % _TRIPLE.size:
        raise ValueError("triples payload length not a multiple of 12")
    return np.frombuffer(payload, np.uint32).reshape(-1, 3).astype(np.int32)


def encode_dict_payload(entries: list[tuple[int, str]]) -> bytes:
    parts = []
    for idx, term in entries:
        raw = term.encode("utf-8")
        parts.append(_DICT_ENT.pack(idx, len(raw)))
        parts.append(raw)
    return b"".join(parts)


def decode_dict_payload(payload: bytes) -> list[tuple[int, str]]:
    out, off = [], 0
    while off < len(payload):
        if off + _DICT_ENT.size > len(payload):
            raise ValueError("dict payload truncated mid-entry header")
        idx, ln = _DICT_ENT.unpack_from(payload, off)
        off += _DICT_ENT.size
        if off + ln > len(payload):
            raise ValueError("dict payload truncated mid-term")
        out.append((idx, payload[off:off + ln].decode("utf-8")))
        off += ln
    return out


def scan_records(data: bytes, start_seq: int = 0
                 ) -> Iterator[tuple[int, int, int, bytes]]:
    """Yield ``(offset, seq, type, payload)`` for every valid record in
    the durable prefix of `data`; stop (silently) at the first torn,
    corrupt, or sequence-regressing record. ``offset`` is the byte
    offset where the record starts — the offset AFTER the last yielded
    record is the repair-truncation point."""
    off, expect = 0, start_seq
    n = len(data)
    while off + HEADER_SIZE + CRC_SIZE <= n:
        magic, seq, rec_type, length = _HEADER.unpack_from(data, off)
        if magic != MAGIC:
            return
        end = off + HEADER_SIZE + length + CRC_SIZE
        if end > n:
            return  # torn tail: payload/crc never fully hit the disk
        body = data[off:off + HEADER_SIZE + length]
        (crc,) = _CRC.unpack_from(data, off + HEADER_SIZE + length)
        if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
            return
        if seq < expect:
            return  # sequence regression: stale bytes past a truncation
        yield off, seq, rec_type, bytes(data[off + HEADER_SIZE:
                                             off + HEADER_SIZE + length])
        expect = seq + 1
        off = end


def read_wal(path: str, start_seq: int = 0
             ) -> tuple[list[tuple[int, int, bytes]], int, int]:
    """Read the durable prefix of the WAL at `path`.

    Returns ``(records, valid_end, last_seq)`` where `records` is a list
    of ``(seq, type, payload)``, `valid_end` is the byte offset the file
    should be truncated to on repair, and `last_seq` is the highest valid
    sequence number (``start_seq - 1`` if the log is empty)."""
    if not os.path.exists(path):
        return [], 0, start_seq - 1
    with open(path, "rb") as f:
        data = f.read()
    records, valid_end, last_seq = [], 0, start_seq - 1
    for off, seq, rec_type, payload in scan_records(data, start_seq):
        records.append((seq, rec_type, payload))
        valid_end = off + HEADER_SIZE + len(payload) + CRC_SIZE
        last_seq = seq
    return records, valid_end, last_seq


class WalWriter:
    """Appender with torn-tail repair and optional fault injection.

    ``append`` frames + writes a record (buffered in the OS page cache);
    ``sync`` flushes + fsyncs — only then is the record acknowledged.
    A :class:`DurabilityFaultPlan` (serve/faults.py) may tear the bytes
    of a specific record, drop everything un-synced at a crash point, or
    raise ``SimulatedCrash`` — all BEFORE the ack, so chaos runs exercise
    exactly the window real crashes occupy.
    """

    def __init__(self, path: str, start_seq: int = 0, fault_plan=None):
        self.path = path
        self.fault_plan = fault_plan
        records, valid_end, last_seq = read_wal(path, start_seq)
        self._seq = last_seq + 1
        # torn-tail repair: drop bytes past the valid prefix before
        # appending, so a pre-crash partial record can't shadow new data
        if os.path.exists(path):
            size = os.path.getsize(path)
            if size != valid_end:
                with open(path, "r+b") as f:
                    f.truncate(valid_end)
        self._f = open(path, "ab")
        self._synced_size = valid_end
        self._unsynced = 0

    @property
    def next_seq(self) -> int:
        return self._seq

    @property
    def synced_bytes(self) -> int:
        return self._synced_size

    def append(self, rec_type: int, payload: bytes) -> int:
        """Frame and write one record; returns its seq. NOT yet durable —
        call ``sync()`` before acknowledging."""
        seq = self._seq
        rec = encode_record(seq, rec_type, payload)
        if self.fault_plan is not None:
            rec = self.fault_plan.on_append(seq, rec, self)
        self._f.write(rec)
        self._seq += 1
        self._unsynced += len(rec)
        return seq

    def sync(self) -> None:
        """Flush + fsync: everything appended so far becomes acknowledged."""
        if self.fault_plan is not None:
            self.fault_plan.on_sync(self)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._synced_size += self._unsynced
        self._unsynced = 0

    def drop_unsynced(self) -> None:
        """Fault-injection hook: discard buffered-but-unsynced bytes, as a
        power loss would. Truncates the file to the last synced size."""
        self._f.flush()
        self._f.close()
        with open(self.path, "r+b") as f:
            f.truncate(self._synced_size)
        self._f = open(self.path, "ab")
        self._unsynced = 0

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
