"""Deterministic durability fault injection for the mutable store's WAL
(DESIGN.md §9).

A :class:`DurabilityFaultPlan` is a static, seedable schedule of WAL
faults: ``store.wal.WalWriter`` consults it on every record it appends
and every fsync, and the first fault that fires tears the record, drops
unsynced bytes and raises :class:`SimulatedCrash` before the ack. A
chaos run is exactly reproducible from the plan (or, via
``DurabilityFaultPlan.sample``, from a seed: the same draw as the JAX
package's plan for the same seed).

The a2a answer-leg faults of the sharded serving path (``Fault``,
``FaultPlan``) belong to that path and are not part of the port yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class SimulatedCrash(Exception):
    """Raised by durability fault injection at the exact byte boundary a
    real crash would occupy. The store object that raised it must be
    abandoned (as a dead process's heap would be) and re-opened from
    disk — recovery is the code under test."""


@dataclasses.dataclass(frozen=True)
class WalFault:
    """One injected durability fault, fired when WAL record `record` is
    appended (absolute sequence number — numbering continues across WAL
    rotations, so a fault can target a post-compaction record).

    Effect, in order:
      1. ``lose_unsynced`` — previously appended-but-unsynced bytes are
         discarded (a power loss before the page cache hit disk: the
         partial-fsync scenario);
      2. the first ``torn_bytes`` bytes of the new record's frame are
         written and made durable (a torn write — 0 means the record
         never reached disk at all);
      3. :class:`SimulatedCrash` is raised BEFORE the ack, so the
         injected record (and anything lost in step 1) was never
         acknowledged and recovery must not surface it.
    """
    record: int
    torn_bytes: int = 0
    lose_unsynced: bool = False


@dataclasses.dataclass(frozen=True)
class DurabilityFaultPlan:
    """Static, seedable schedule of WAL faults. Hooked by
    ``store.wal.WalWriter``: ``on_append`` is consulted per record,
    ``on_sync`` per fsync. The first firing fault raises
    :class:`SimulatedCrash` (a crashed process injects at most one
    crash), so a plan normally carries one fault."""
    faults: tuple[WalFault, ...] = ()

    def _find(self, seq: int) -> WalFault | None:
        for f in self.faults:
            if f.record == seq:
                return f
        return None

    def on_append(self, seq: int, rec: bytes, writer) -> bytes:
        """Called by WalWriter.append with the framed record bytes before
        they are written; returns them unchanged when no fault fires."""
        f = self._find(seq)
        if f is None:
            return rec
        if f.lose_unsynced:
            writer.drop_unsynced()
        torn = rec[:max(0, min(f.torn_bytes, len(rec)))]
        if torn:
            # the prefix that made it to disk before the lights went out
            writer._f.write(torn)
            writer._f.flush()
        writer._f.close()
        raise SimulatedCrash(
            f"crash at WAL record {seq} (torn_bytes={len(torn)}, "
            f"lose_unsynced={f.lose_unsynced})")

    def on_sync(self, writer) -> None:
        """Sync-time hook (a pass-through; crash points are expressed
        per-record via ``on_append``)."""

    def any_fault(self) -> bool:
        return bool(self.faults)

    @classmethod
    def sample(cls, seed: int, horizon: int = 16,
               max_torn: int = 64) -> "DurabilityFaultPlan":
        """One seeded crash somewhere in the next `horizon` records:
        uniformly chosen record, torn prefix length in [0, max_torn],
        fair-coin unsynced-byte loss. Deterministic from the seed."""
        rng = np.random.RandomState(seed)
        return cls((WalFault(record=int(rng.randint(horizon)),
                             torn_bytes=int(rng.randint(max_torn + 1)),
                             lose_unsynced=bool(rng.randint(2))),))
